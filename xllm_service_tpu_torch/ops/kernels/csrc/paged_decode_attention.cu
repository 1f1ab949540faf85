// Single-token GQA attention over one layer of the paged KV pool.
//
// Replaces the Pallas kernel paged_decode_attention_pallas of
// xllm_service_tpu/ops/pallas/paged_attention.py (bodies _kernel and
// _kernel_layered) in its write-then-attend form: the current token is
// already in the pool, so the context includes it and there is no
// k_cur/v_cur operand.
//
// What bounds it on an H100, and what the design does about it: see
// decode_row.cuh, whose device code this kernel runs with one block per
// (row, kv head).
//
// Layout: q [B, Hq, D] bf16 with Hq = Hkv * G (head h*G+g belongs to kv
// head h); pools [P, ps, Hkv, D] bf16 (the caller passes k_pages[layer]);
// page table [B, MP] int32; context_lens [B] int32; sinks [Hq] float32 or
// null; out [B, Hq, D] bf16.

#include <stdint.h>

#include "decode_row.cuh"

namespace {

template <int D>
__host__ __device__ constexpr int threads_for() {
  return D > 128 ? D : 128;
}

// D: head dim; KG: the group width G rounded up to a power of two.
template <int D, int KG>
__global__ void __launch_bounds__(threads_for<D>())
paged_decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool,
    const int* __restrict__ page_table, const int* __restrict__ context_lens,
    const float* __restrict__ sinks, __nv_bfloat16* __restrict__ out,
    int Hkv, int G, int MP, int page_size, int window, float scale,
    float cap) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const long long head0 = ((long long)b * Hkv * G + (long long)h * G) * D;
  decode::attend_row<D, KG, threads_for<D>()>(
      smem, q + head0, k_pool, v_pool, page_table + (long long)b * MP, sinks,
      out + head0, context_lens[b], h, Hkv, G, MP, page_size, window, scale,
      cap);
}

template <int D, int KG>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* page_table, const int* context_lens, const float* sinks,
           void* out, int B, int Hkv, int G, int MP, int page_size,
           int window, float scale, float cap, cudaStream_t stream) {
  constexpr int threads = threads_for<D>();
  const size_t smem = decode::smem_bytes(D, KG, G, threads);
  static size_t granted = 0;
  const int err =
      allow_smem(paged_decode_attention_kernel<D, KG>, smem, &granted);
  if (err) return err;
  paged_decode_attention_kernel<D, KG><<<B * Hkv, threads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
      (const __nv_bfloat16*)v_pool, page_table, context_lens, sinks,
      (__nv_bfloat16*)out, Hkv, G, MP, page_size, window, scale, cap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int G, const void* q, const void* k_pool, const void* v_pool,
             const int* page_table, const int* context_lens,
             const float* sinks, void* out, int B, int Hkv, int MP,
             int page_size, int window, float scale, float cap,
             cudaStream_t stream) {
#define XLLM_DECODE_LAUNCH(KG)                                              \
  return launch<D, KG>(q, k_pool, v_pool, page_table, context_lens, sinks, \
                       out, B, Hkv, G, MP, page_size, window, scale, cap,  \
                       stream)
  if (G <= 1) XLLM_DECODE_LAUNCH(1);
  if (G <= 2) XLLM_DECODE_LAUNCH(2);
  if (G <= 4) XLLM_DECODE_LAUNCH(4);
  if (G <= 8) XLLM_DECODE_LAUNCH(8);
  XLLM_DECODE_LAUNCH(16);
#undef XLLM_DECODE_LAUNCH
}

}  // namespace

// Returns a CUDA error code (0 = launched). D must be 64, 128 or 256 and
// G at most 16; the wrapper checks both.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* page_table, const int* context_lens, const float* sinks,
    void* out, int B, int Hkv, int G, int D, int MP, int page_size,
    int window, float scale, float cap, void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return launch_d<64>(G, q, k_pool, v_pool, page_table, context_lens,
                          sinks, out, B, Hkv, MP, page_size, window, scale,
                          cap, st);
    case 128:
      return launch_d<128>(G, q, k_pool, v_pool, page_table, context_lens,
                           sinks, out, B, Hkv, MP, page_size, window, scale,
                           cap, st);
    case 256:
      return launch_d<256>(G, q, k_pool, v_pool, page_table, context_lens,
                           sinks, out, B, Hkv, MP, page_size, window, scale,
                           cap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
