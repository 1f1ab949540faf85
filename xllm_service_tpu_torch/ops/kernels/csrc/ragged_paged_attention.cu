// Ragged paged attention over one layer of the paged KV pool: one launch
// for a mix of prefill windows and length-1 decode rows.
//
// Replaces the Pallas kernel ragged_paged_attention_pallas of
// xllm_service_tpu/ops/pallas/ragged_attention.py in its layered form
// (body _kernel_layered): every row's new K/V was written into the pool
// first, so every key is read through the page table. A decode row is a
// window of length 1 at q_start = context - 1, mid-page as often as not;
// rows of length 0 are padding.
//
// What bounds it on an H100: bytes. At a serving mix (7 decode rows of a
// few hundred keys beside one 256-token window, in a T = 256 bucket)
// the live keys' K and V and the live rows' q and out are a few MB, about
// 2 us at 3.35 TB/s, against well under 1 us of tensor-core work. What
// costs time beyond that is work on rows that do not exist: a decode row
// fills 1 of the bucket's T positions, so most (row, query tile) pairs of
// the grid hold no valid query.
//
// The design: one block per (row, kv head, query tile), and each block
// serves its tile by the code suited to it:
// - a window tile runs the prefill kernel's tile code (flash_tile.cuh:
//   128 (position, head) rows, S and O in registers on the tensor cores,
//   keys in 64-key chunks through a `cp.async` ring), reading only the
//   key chunks of [max(0, q_lo - W + 1), min(q_hi, q_start + length - 1)];
// - a decode row (length 1) runs the decode kernel's row code
//   (decode_row.cuh: chunks of 128 keys, one key per thread, the G heads'
//   scores on the CUDA cores). In a 128-row tile it would fill 1
//   position of 128 / G and leave all but G of the tile's rows idle on
//   the tensor cores; the row code reads the same bytes with every
//   thread on a key;
// - a dead tile, with no valid query row, writes its padding rows as
//   zeros with 16-byte stores and returns before it reads a key.
// The grid still holds a block for every (row, kv head, query tile) of
// the B x T bucket, most of them dead at a serving mix. So that those do
// not crowd the SMs while the window tiles run, each block finds its
// tile from the row lengths in start order: window tiles first (their
// last tiles, with the most keys, foremost), one per SM as far as they
// go, then the decode rows, then the dead tiles. A host-built list of
// live tiles (no dead blocks launched at all) is later work.
//
// Semantics and layout: those of flash_tile.cuh, with q_start and
// lengths [B] int32. Query rows t >= lengths[b] (and rows of length 0)
// output zeros.

#include <stdint.h>

#include "decode_row.cuh"
#include "flash_tile.cuh"

namespace {

using flash::kThreads;
using flash::Plan;

// Zeroes query positions [t_lo, t_hi) of row b for the G heads of kv
// head h (G * D contiguous values per position), with 16-byte stores.
template <int D>
__device__ __forceinline__ void zero_rows(__nv_bfloat16* __restrict__ out,
                                          int b, int h, int T, int Hkv,
                                          int G, int t_lo, int t_hi) {
  const int vpp = G * D / 8;                         // vectors per position
  for (int i = threadIdx.x; i < (t_hi - t_lo) * vpp; i += kThreads) {
    const int t = t_lo + i / vpp, c = i % vpp;
    *reinterpret_cast<uint4*>(
        out + (((long long)b * T + t) * Hkv + h) * G * D + c * 8) =
        make_uint4(0, 0, 0, 0);
  }
}

// Shared memory of one block: the larger of the two paths' plans.
template <int D, int KG>
constexpr size_t smem_bytes() {
  return Plan<D>::kTotal > decode::smem_bytes(D, KG, KG, kThreads)
             ? Plan<D>::kTotal
             : decode::smem_bytes(D, KG, KG, kThreads);
}

// The tile of block `i` (counted over (row, query tile) pairs; the kv
// head is the block index's fastest part). Tiles come in the order the
// blocks should start: the window tiles (rows of length > 1, their last
// tiles first: those have the most keys), then the decode rows, then the
// dead tiles. Every block walks the B row lengths to find its own.
struct Tile {
  int b, qt;
};

__device__ __forceinline__ Tile tile_of(int i, const int* __restrict__ lengths,
                                        int B, int QB, int nqt) {
  for (int r = 0; r < B; ++r) {                      // window tiles
    const int len = lengths[r];
    if (len > 1) {
      const int n = min(nqt, (len + QB - 1) / QB);
      if (i < n) return {r, n - 1 - i};
      i -= n;
    }
  }
  for (int r = 0; r < B; ++r) {                      // decode rows
    if (lengths[r] == 1) {
      if (i == 0) return {r, 0};
      i -= 1;
    }
  }
  for (int r = 0; r < B; ++r) {                      // dead tiles
    const int live = min(nqt, (lengths[r] + QB - 1) / QB);
    if (i < nqt - live) return {r, live + i};
    i -= nqt - live;
  }
  return {0, nqt};                                   // not reached
}

// D: head dim; KG: the group width G rounded up to a power of two. One
// block per SM, unlike the prefill kernel at D = 64: at 128 registers a
// thread its decode rows spill, and K5 measured 15% slower.
template <int D, int KG>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool,
    const int* __restrict__ page_table, const int* __restrict__ q_start,
    const int* __restrict__ lengths, const float* __restrict__ sinks,
    __nv_bfloat16* __restrict__ out, int B, int T, int Hkv, int G, int MP,
    int page_size, int QB, int window, float scale, float cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nqt = (T + QB - 1) / QB;
  const int h = blockIdx.x % Hkv;
  const Tile tile = tile_of(blockIdx.x / Hkv, lengths, B, QB, nqt);
  const int b = tile.b;
  const int t0 = tile.qt * QB;
  const int t_end = min(T, t0 + QB);
  const int length = lengths[b];
  const int nt = max(0, min(QB, length - t0));       // valid tile rows
  if (nt == 0) {                                     // dead tile
    if (t0 < T) zero_rows<D>(out, b, h, T, Hkv, G, t0, t_end);
    return;
  }
  if (length == 1) {                                 // decode row
    const long long head0 = ((long long)b * T * Hkv + h) * G * D;
    decode::attend_row<D, KG, kThreads>(
        reinterpret_cast<float*>(smem), q + head0, k_pool, v_pool,
        page_table + (long long)b * MP, sinks, out + head0, q_start[b] + 1,
        h, Hkv, G, MP, page_size, window, scale, cap);
    zero_rows<D>(out, b, h, T, Hkv, G, 1, t_end);
    return;
  }
  const int q_lo = q_start[b] + t0;
  const int kv_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kv_hi = min(min(q_lo + nt - 1, q_start[b] + length - 1),
                        MP * page_size - 1);          // inclusive
  flash::attend_tile<D>(smem, q, k_pool, v_pool, page_table, sinks, out, b,
                        h, t0, nt, q_lo, kv_lo, kv_hi, T, Hkv, G, MP,
                        page_size, QB, window, scale, cap);
}

template <int D, int KG>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* page_table, const int* q_start, const int* lengths,
           const float* sinks, void* out, int B, int T, int Hkv, int G,
           int MP, int page_size, int QB, int window, float scale, float cap,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D, KG>();
  static size_t granted = 0;
  const int err =
      allow_smem(ragged_paged_attention_kernel<D, KG>, smem, &granted);
  if (err) return err;
  const int nqt = (T + QB - 1) / QB;
  ragged_paged_attention_kernel<D, KG><<<nqt * B * Hkv, kThreads, smem,
                                         stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
      (const __nv_bfloat16*)v_pool, page_table, q_start, lengths, sinks,
      (__nv_bfloat16*)out, B, T, Hkv, G, MP, page_size, QB, window, scale,
      cap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k_pool, const void* v_pool,
             const int* page_table, const int* q_start, const int* lengths,
             const float* sinks, void* out, int B, int T, int Hkv, int G,
             int MP, int page_size, int QB, int window, float scale,
             float cap, cudaStream_t stream) {
#define XLLM_RAGGED_LAUNCH(KG)                                              \
  return launch<D, KG>(q, k_pool, v_pool, page_table, q_start, lengths,    \
                       sinks, out, B, T, Hkv, G, MP, page_size, QB, window, \
                       scale, cap, stream)
  if (G <= 1) XLLM_RAGGED_LAUNCH(1);
  if (G <= 2) XLLM_RAGGED_LAUNCH(2);
  if (G <= 4) XLLM_RAGGED_LAUNCH(4);
  if (G <= 8) XLLM_RAGGED_LAUNCH(8);
  XLLM_RAGGED_LAUNCH(16);
#undef XLLM_RAGGED_LAUNCH
}

}  // namespace

// Returns a CUDA error code (0 = launched). D must be 64, 128 or 256 and
// G at most 16; the wrapper checks both and picks QB = max(1, 128 / G)
// query positions per tile.
extern "C" int ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* page_table, const int* q_start, const int* lengths,
    const float* sinks, void* out, int B, int T, int Hkv, int G, int D,
    int MP, int page_size, int QB, int window, float scale, float cap,
    void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return launch_d<64>(q, k_pool, v_pool, page_table, q_start, lengths,
                          sinks, out, B, T, Hkv, G, MP, page_size, QB,
                          window, scale, cap, st);
    case 128:
      return launch_d<128>(q, k_pool, v_pool, page_table, q_start, lengths,
                           sinks, out, B, T, Hkv, G, MP, page_size, QB,
                           window, scale, cap, st);
    case 256:
      return launch_d<256>(q, k_pool, v_pool, page_table, q_start, lengths,
                           sinks, out, B, T, Hkv, G, MP, page_size, QB,
                           window, scale, cap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
