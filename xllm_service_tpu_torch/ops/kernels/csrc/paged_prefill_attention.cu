// Causal GQA prefill attention over one layer of the paged KV pool, in
// both orderings of the prefill step.
//
// Replaces the Pallas kernel paged_prefill_attention_pallas of
// xllm_service_tpu/ops/pallas/prefill_attention.py in its two layered
// forms:
// - entry paged_prefill_attention, write-then-attend (from_pool=True,
//   body _kernel_layered_pool): the window's K/V was written into the
//   pool first, so every key, cached prefix and window alike, is read
//   through the page table;
// - entry paged_prefill_attention_fresh, attend-then-write (two sources,
//   body _kernel_layered): the cached prefix, positions < q_start, comes
//   through the page table and the window's keys from the k_fresh/v_fresh
//   operands; the window is written to the pool for all layers after
//   the layer loop. The Pallas form needs T % page_size == 0, because its
//   fresh operand streams in page-sized blocks; here a key is staged one
//   16-byte vector at a time from either source, so any T is accepted.
//
// What bounds it on an H100: at the serving shapes this slice runs
// (windows of a few hundred tokens) neither bytes nor operations, but
// the serial chain of key chunks that the longest tile walks; at a long
// prompt (thousands of tokens) the tensor cores' operations. One block
// per (row, kv head, query tile) runs the tile code of flash_tile.cuh:
// 128 (position, head) rows, S and O in registers on the tensor cores,
// keys in 64-key chunks through a `cp.async` ring with the next chunk's
// copies in flight during this one's math. Key chunks outside
// [max(0, q_lo - W + 1), q_hi] (causal limit and sliding window of the
// tile) are never read. The two forms read the same bytes; only their
// source differs. Blocks start heaviest first: the first B x Hkv blocks
// take each (row, kv head)'s last live query tile, which has the most
// keys, the next ones the tile before it, and the dead tiles (no valid
// query) come last.
//
// Semantics and layout: those of flash_tile.cuh; query rows
// t >= lengths[b] (and rows of length 0) output zeros.

#include <stdint.h>

#include "flash_tile.cuh"

namespace {

using flash::kThreads;
using flash::Plan;

// D: head dim; FRESH: the attend-then-write form.
template <int D, bool FRESH>
__global__ void __launch_bounds__(kThreads, Plan<D>::kMinBlocks)
paged_prefill_attention_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_fresh,
    const __nv_bfloat16* __restrict__ v_fresh,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool,
    const int* __restrict__ page_table, const int* __restrict__ q_start,
    const int* __restrict__ lengths, const float* __restrict__ sinks,
    __nv_bfloat16* __restrict__ out, int T, int Hkv, int G, int MP,
    int page_size, int QB, int window, float scale, float cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nqt = (T + QB - 1) / QB;
  const int rows = gridDim.x / nqt;                   // B x Hkv
  const int h = blockIdx.x % rows % Hkv;
  const int b = blockIdx.x % rows / Hkv;
  const int k = blockIdx.x / rows;                     // rank, heaviest first
  const int live = min(nqt, (max(lengths[b], 0) + QB - 1) / QB);
  const int qt = k < live ? live - 1 - k : k;
  const int t0 = qt * QB;
  const int nt = max(0, min(QB, lengths[b] - t0));   // valid tile rows
  const int q_lo = q_start[b] + t0;
  // Key chunks outside the tile's causal limit and window are not read;
  // the pool-only form also stops at the table (the fresh form reads
  // the window from its operands, and its prefix lies inside the table).
  const int kv_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kv_hi = FRESH ? q_lo + nt - 1
                          : min(q_lo + nt - 1, MP * page_size - 1);
  flash::attend_tile<D, FRESH>(smem, q, k_pool, v_pool, page_table, sinks,
                               out, b, h, t0, nt, q_lo, kv_lo, kv_hi, T, Hkv,
                               G, MP, page_size, QB, window, scale, cap,
                               k_fresh, v_fresh, q_start[b]);
}

struct Args {
  const void* q;
  const void* k_fresh;
  const void* v_fresh;
  const void* k_pool;
  const void* v_pool;
  const int* page_table;
  const int* q_start;
  const int* lengths;
  const float* sinks;
  void* out;
  int B, T, Hkv, G, MP, page_size, QB, window;
  float scale, cap;
  cudaStream_t stream;
};

template <int D, bool FRESH>
int launch(const Args& a) {
  const size_t smem = Plan<D>::kTotal;
  static size_t granted = 0;
  const int err =
      allow_smem(paged_prefill_attention_kernel<D, FRESH>, smem, &granted);
  if (err) return err;
  const int nqt = (a.T + a.QB - 1) / a.QB;
  paged_prefill_attention_kernel<D, FRESH>
      <<<a.B * a.Hkv * nqt, kThreads, smem, a.stream>>>(
          (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k_fresh,
          (const __nv_bfloat16*)a.v_fresh, (const __nv_bfloat16*)a.k_pool,
          (const __nv_bfloat16*)a.v_pool, a.page_table, a.q_start, a.lengths,
          a.sinks, (__nv_bfloat16*)a.out, a.T, a.Hkv, a.G, a.MP, a.page_size,
          a.QB, a.window, a.scale, a.cap);
  return (int)cudaGetLastError();
}

template <bool FRESH>
int dispatch(int D, const Args& a) {
  if (a.B <= 0 || a.T <= 0) return 0;
  switch (D) {
    case 64:
      return launch<64, FRESH>(a);
    case 128:
      return launch<128, FRESH>(a);
    case 256:
      return launch<256, FRESH>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a CUDA error code (0 = launched). D must be 64, 128 or 256; the
// wrapper checks it, G <= 128, and picks QB = max(1, 128 / G) query
// positions per tile.
extern "C" int paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* page_table, const int* q_start, const int* lengths,
    const float* sinks, void* out, int B, int T, int Hkv, int G, int D,
    int MP, int page_size, int QB, int window, float scale, float cap,
    void* stream) {
  const Args a{q, nullptr, nullptr, k_pool, v_pool, page_table, q_start,
               lengths, sinks, out, B, T, Hkv, G, MP, page_size, QB,
               window, scale, cap, (cudaStream_t)stream};
  return dispatch<false>(D, a);
}

// The attend-then-write form: the window's K/V rows are k_fresh/v_fresh
// [B, T, Hkv, D], the pool holds positions < q_start. Same return and
// limits.
extern "C" int paged_prefill_attention_fresh(
    const void* q, const void* k_fresh, const void* v_fresh,
    const void* k_pool, const void* v_pool, const int* page_table,
    const int* q_start, const int* lengths, const float* sinks, void* out,
    int B, int T, int Hkv, int G, int D, int MP, int page_size, int QB,
    int window, float scale, float cap, void* stream) {
  const Args a{q, k_fresh, v_fresh, k_pool, v_pool, page_table, q_start,
               lengths, sinks, out, B, T, Hkv, G, MP, page_size, QB,
               window, scale, cap, (cudaStream_t)stream};
  return dispatch<true>(D, a);
}
