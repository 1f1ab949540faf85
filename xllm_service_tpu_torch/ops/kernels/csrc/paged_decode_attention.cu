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
// decode_row.cuh, whose split walk (attend_split) both forms run. The
// grid is B x Hkv x S: S splits of each (row, kv head)'s attended range,
// S picked by the caller from host-known sizes (B, Hkv, the page table's
// width and the window) so that a small batch fills the card. With S > 1
// each block writes its split's state to scratch and takes a ticket on
// the (row, kv head)'s counter (__threadfence + atomicAdd); only the
// splits that hold keys run, a (row, kv head) held by one of them is
// finished by it directly, and otherwise the block that takes the last
// ticket folds the states in split order
// (combine_splits: the result does not depend on which block finished
// last, and the sinks join the denominator there, once), writes the
// output and resets the counter to 0, so one launch does the whole call
// and CUDA-graph replays stay right. The current row adds 2 x D x 2
// bytes to the bytes K3 reads and takes the place of the pool slot it
// would have read.
//
// Layout: q [B, Hq, D] bf16 with Hq = Hkv * G (head h*G+g belongs to kv
// head h); pools [P, ps, Hkv, D] bf16 (the caller passes k_pages[layer]);
// page table [B, MP] int32; lens [B] int32 (context lengths, or cache
// lengths with CUR); k_cur/v_cur [B, Hkv, D] bf16 (CUR only); sinks [Hq]
// float32 or null; out [B, Hq, D] bf16; with S > 1, scratch part_o
// [B, Hkv, S, G, D] and part_ml [B, Hkv, S, 2, G] float32 and tickets
// [>= B * Hkv] int32, zero between calls.

#include <stdint.h>

#include "decode_row.cuh"

namespace {

// D: head dim; CUR: the attend-then-write form. One block of 128 threads
// per split of each (row, kv head): grid (S, B * Hkv).
template <int D, bool CUR>
__global__ void __launch_bounds__(decode::kSplitThreads)
paged_decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool,
    const int* __restrict__ page_table, const int* __restrict__ lens,
    const __nv_bfloat16* __restrict__ k_cur,
    const __nv_bfloat16* __restrict__ v_cur,
    const float* __restrict__ sinks, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_o, float* __restrict__ part_ml,
    int* __restrict__ tickets, int Hkv, int G, int MP, int page_size,
    int window, float scale, float cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last_split;
  const int split = blockIdx.x, S = gridDim.x;
  const int bh = blockIdx.y;                   // b * Hkv + h
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const long long head0 = (long long)bh * G * D;
  uint4 qv[decode::SplitPlan<D>::kQVecs];
  decode::load_q<D>(q + head0, G, qv, threadIdx.x);
  const decode::SplitRange sr = decode::split_range<CUR>(
      lens[b], MP, page_size, window, split, S);
  if (split >= max(sr.live, 1)) return;        // no keys in this split
  const long long cur0 = (long long)bh * D;
  float* po = part_o + ((long long)bh * S + split) * G * D;
  float* pml = part_ml + ((long long)bh * S + split) * 2 * G;
  decode::attend_split<D, CUR>(
      smem, qv, k_pool, v_pool, page_table + (long long)b * MP, sinks,
      out + head0, po, pml, sr, sr.live <= 1, h, Hkv, G, page_size, scale,
      cap, CUR ? k_cur + cur0 : nullptr, CUR ? v_cur + cur0 : nullptr,
      threadIdx.x, 0);
  if (sr.live <= 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_split = atomicAdd(tickets + bh, 1) == sr.live - 1;
  __syncthreads();
  if (!last_split) return;
  __threadfence();
  decode::combine_splits(part_o + (long long)bh * S * G * D,
                         part_ml + (long long)bh * S * 2 * G, sinks,
                         out + head0, h, G, D, sr.live, threadIdx.x);
  if (threadIdx.x == 0) tickets[bh] = 0;
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
  void* part_o;
  void* part_ml;
  int* tickets;
  int B, Hkv, G, MP, page_size, window, splits;
  float scale, cap;
  cudaStream_t stream;
};

template <int D, bool CUR>
int launch(const Args& a) {
  using Plan = decode::SplitPlan<D>;
  static size_t granted = 0;
  const int err = allow_smem(paged_decode_attention_kernel<D, CUR>,
                             Plan::kTotal, &granted);
  if (err) return err;
  paged_decode_attention_kernel<D, CUR>
      <<<dim3(a.splits, a.B * a.Hkv), decode::kSplitThreads, Plan::kTotal,
         a.stream>>>(
          (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k_pool,
          (const __nv_bfloat16*)a.v_pool, a.page_table, a.lens,
          (const __nv_bfloat16*)a.k_cur, (const __nv_bfloat16*)a.v_cur,
          a.sinks, (__nv_bfloat16*)a.out, (float*)a.part_o,
          (float*)a.part_ml, a.tickets, a.Hkv, a.G, a.MP, a.page_size,
          a.window, a.scale, a.cap);
  return (int)cudaGetLastError();
}

template <bool CUR>
int dispatch(int D, const Args& a) {
  if (a.splits < 1 || (a.splits > 1 && (a.part_o == nullptr ||
                                        a.part_ml == nullptr ||
                                        a.tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (a.B <= 0) return 0;
  if (a.G < 1 || a.G > decode::kSplitRows) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<64, CUR>(a);
    case 128:
      return launch<128, CUR>(a);
    case 256:
      return launch<256, CUR>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a CUDA error code (0 = launched). D must be 64, 128 or 256, G
// at most 16 and splits >= 1 (the wrapper checks all three); with splits
// > 1 the scratch and the tickets (B * Hkv ints, zero) are required.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* page_table, const int* context_lens, const float* sinks,
    void* out, void* part_o, void* part_ml, int* tickets, int B, int Hkv,
    int G, int D, int MP, int page_size, int window, int splits, float scale,
    float cap, void* stream) {
  const Args a{q, k_pool, v_pool, page_table, context_lens, nullptr,
               nullptr, sinks, out, part_o, part_ml, tickets, B, Hkv, G, MP,
               page_size, window, splits, scale, cap, (cudaStream_t)stream};
  return dispatch<false>(D, a);
}

// The attend-then-write form: cache_lens exclude the current token, whose
// K/V rows are k_cur/v_cur [B, Hkv, D]. Same return and limits.
extern "C" int paged_decode_attention_current(
    const void* q, const void* k_pool, const void* v_pool,
    const int* page_table, const int* cache_lens, const void* k_cur,
    const void* v_cur, const float* sinks, void* out, void* part_o,
    void* part_ml, int* tickets, int B, int Hkv, int G, int D, int MP,
    int page_size, int window, int splits, float scale, float cap,
    void* stream) {
  const Args a{q, k_pool, v_pool, page_table, cache_lens, k_cur, v_cur,
               sinks, out, part_o, part_ml, tickets, B, Hkv, G, MP,
               page_size, window, splits, scale, cap, (cudaStream_t)stream};
  return dispatch<true>(D, a);
}
