// Single-token GQA attention over one layer of the paged KV pool, in both
// orderings of the decode step.
//
// Replaces the Pallas kernel paged_decode_attention_pallas of
// xllm_service_tpu/ops/pallas/paged_attention.py (bodies _kernel and
// _kernel_layered) in its two forms:
// - entry paged_decode_attention, the write-then-attend form: the current
//   token is already in the pool, so the context includes it and there is
//   no k_cur/v_cur operand;
// - entry paged_decode_attention_current, the attend-then-write form
//   (has_current): the pool holds the cache_len tokens before the current
//   one, whose K/V rows come as k_cur/v_cur and join the walk as its last
//   key (the Pallas kernel folds them in _finalize).
//
// What bounds it on an H100, and what the design does about it: see
// decode_row.cuh, whose device code both forms run with one block per
// (row, kv head). The current row adds 2 x D x 2 bytes per block to the
// bytes K3 reads and takes the place of the pool slot it would have read.
//
// Layout: q [B, Hq, D] bf16 with Hq = Hkv * G (head h*G+g belongs to kv
// head h); pools [P, ps, Hkv, D] bf16 (the caller passes k_pages[layer]);
// page table [B, MP] int32; lens [B] int32 (context lengths, or cache
// lengths with CUR); k_cur/v_cur [B, Hkv, D] bf16 (CUR only); sinks [Hq]
// float32 or null; out [B, Hq, D] bf16.

#include <stdint.h>

#include "decode_row.cuh"

namespace {

template <int D>
__host__ __device__ constexpr int threads_for() {
  return D > 128 ? D : 128;
}

// D: head dim; KG: the group width G rounded up to a power of two; CUR:
// the attend-then-write form.
template <int D, int KG, bool CUR>
__global__ void __launch_bounds__(threads_for<D>())
paged_decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool,
    const int* __restrict__ page_table, const int* __restrict__ lens,
    const __nv_bfloat16* __restrict__ k_cur,
    const __nv_bfloat16* __restrict__ v_cur,
    const float* __restrict__ sinks, __nv_bfloat16* __restrict__ out,
    int Hkv, int G, int MP, int page_size, int window, float scale,
    float cap) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const long long head0 = ((long long)b * Hkv * G + (long long)h * G) * D;
  const long long cur0 = ((long long)b * Hkv + h) * D;
  decode::attend_row<D, KG, threads_for<D>(), CUR>(
      smem, q + head0, k_pool, v_pool, page_table + (long long)b * MP, sinks,
      out + head0, lens[b], h, Hkv, G, MP, page_size, window, scale, cap,
      CUR ? k_cur + cur0 : nullptr, CUR ? v_cur + cur0 : nullptr);
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* page_table;
  const int* lens;
  const void* k_cur;
  const void* v_cur;
  const float* sinks;
  void* out;
  int B, Hkv, G, MP, page_size, window;
  float scale, cap;
  cudaStream_t stream;
};

template <int D, int KG, bool CUR>
int launch(const Args& a) {
  constexpr int threads = threads_for<D>();
  const size_t smem = decode::smem_bytes(D, KG, a.G, threads);
  static size_t granted = 0;
  const int err =
      allow_smem(paged_decode_attention_kernel<D, KG, CUR>, smem, &granted);
  if (err) return err;
  paged_decode_attention_kernel<D, KG, CUR>
      <<<a.B * a.Hkv, threads, smem, a.stream>>>(
          (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k_pool,
          (const __nv_bfloat16*)a.v_pool, a.page_table, a.lens,
          (const __nv_bfloat16*)a.k_cur, (const __nv_bfloat16*)a.v_cur,
          a.sinks, (__nv_bfloat16*)a.out, a.Hkv, a.G, a.MP, a.page_size,
          a.window, a.scale, a.cap);
  return (int)cudaGetLastError();
}

template <int D, bool CUR>
int launch_d(const Args& a) {
  if (a.G <= 1) return launch<D, 1, CUR>(a);
  if (a.G <= 2) return launch<D, 2, CUR>(a);
  if (a.G <= 4) return launch<D, 4, CUR>(a);
  if (a.G <= 8) return launch<D, 8, CUR>(a);
  return launch<D, 16, CUR>(a);
}

template <bool CUR>
int dispatch(int D, const Args& a) {
  if (a.B <= 0) return 0;
  switch (D) {
    case 64:
      return launch_d<64, CUR>(a);
    case 128:
      return launch_d<128, CUR>(a);
    case 256:
      return launch_d<256, CUR>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a CUDA error code (0 = launched). D must be 64, 128 or 256 and
// G at most 16; the wrapper checks both.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* page_table, const int* context_lens, const float* sinks,
    void* out, int B, int Hkv, int G, int D, int MP, int page_size,
    int window, float scale, float cap, void* stream) {
  const Args a{q, k_pool, v_pool, page_table, context_lens, nullptr,
               nullptr, sinks, out, B, Hkv, G, MP, page_size, window,
               scale, cap, (cudaStream_t)stream};
  return dispatch<false>(D, a);
}

// The attend-then-write form: cache_lens exclude the current token, whose
// K/V rows are k_cur/v_cur [B, Hkv, D]. Same return and limits.
extern "C" int paged_decode_attention_current(
    const void* q, const void* k_pool, const void* v_pool,
    const int* page_table, const int* cache_lens, const void* k_cur,
    const void* v_cur, const float* sinks, void* out, int B, int Hkv, int G,
    int D, int MP, int page_size, int window, float scale, float cap,
    void* stream) {
  const Args a{q, k_pool, v_pool, page_table, cache_lens, k_cur, v_cur,
               sinks, out, B, Hkv, G, MP, page_size, window, scale, cap,
               (cudaStream_t)stream};
  return dispatch<true>(D, a);
}
