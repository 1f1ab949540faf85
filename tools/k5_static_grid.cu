// The static-grid alternative to csrc/ragged_paged_attention.cu, for
// tools/k5_grid_ab.py only (the port does not build or call it): the same
// C entry and the same items (window tiles by flash_tile.cuh, decode
// splits by decode_row.cuh folded by ticket, padding zeros), but no work
// list: a grid of Hkv x B x (nqt + SP) blocks from host-known sizes, in
// which each block reads its row's length and takes one item. Blocks in
// launch order, the kv head fastest: every row's rank 0 (a window row's
// last query tile, else its tile 0), then SP = ceil(S / 2) blocks of two
// decode splits a (row, kv head) (one at D = 256), which return at once
// for a row that does not decode, then ranks 1 .. nqt - 1 (a window row's
// k-th tile from its last, else one tile's zeros). K5_MIN_BLOCKS sets the
// blocks per SM the registers are planned for (default: the prefill
// tile's, two at D = 64).

#include <stdint.h>

#include "decode_row.cuh"
#include "flash_tile.cuh"

#ifndef K5_MIN_BLOCKS
#define K5_MIN_BLOCKS Plan<D>::kMinBlocks
#endif

namespace {

using decode::kSplitThreads;
using decode::SplitPlan;
using flash::kThreads;
using flash::Plan;

constexpr int kGroups = kThreads / kSplitThreads;   // split groups a block
constexpr size_t kSmemLimit = 232448;               // a block's, sm_90

// Splits a block runs side by side: one per group, but one at D = 256,
// where two groups' shared memory does not fit.
template <int D>
__host__ __device__ constexpr int split_groups() {
  return D <= 128 ? kGroups : 1;
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  static_assert(split_groups<D>() * SplitPlan<D>::kTotal <= kSmemLimit,
                "the split groups' shared memory does not fit");
  return Plan<D>::kTotal > split_groups<D>() * SplitPlan<D>::kTotal
             ? Plan<D>::kTotal
             : split_groups<D>() * SplitPlan<D>::kTotal;
}

// Zeros for positions [t_lo, t_hi) of row b, the G heads of kv head h.
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

// D: head dim.
template <int D>
__global__ void __launch_bounds__(kThreads, K5_MIN_BLOCKS)
ragged_paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool,
    const int* __restrict__ page_table, const int* __restrict__ q_start,
    const int* __restrict__ lengths, const float* __restrict__ sinks,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
    float* __restrict__ part_ml, int* __restrict__ tickets, int B, int T,
    int Hkv, int G, int MP, int page_size, int QB, int S, int window,
    float scale, float cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last_split[kGroups];
  constexpr int kSG = split_groups<D>();
  const int SP = (S + kSG - 1) / kSG;                // split blocks a head
  const int h = blockIdx.x % Hkv;
  int j = blockIdx.x / Hkv;

  if (j >= B && j < B + B * SP) {                    // a decode row's splits
    const int b = (j - B) / SP;
    const int grp = threadIdx.x / kSplitThreads;
    const int s = (j - B) % SP * kSG + grp;
    if (lengths[b] != 1 || grp >= kSG) return;
    const int ctx = q_start[b] + 1;
    const int live =
        decode::split_range<false>(ctx, MP, page_size, window, 0, S).live;
    if (s >= max(1, live)) return;
    const int gtid = threadIdx.x % kSplitThreads, bar = 1 + grp;
    const long long bh = (long long)b * Hkv + h;
    const long long head0 = ((long long)b * T * Hkv + h) * G * D;
    uint4 qv[SplitPlan<D>::kQVecs];
    decode::load_q<D>(q + head0, G, qv, gtid);
    decode::attend_split<D, false>(
        smem + grp * SplitPlan<D>::kTotal, qv, k_pool, v_pool,
        page_table + (long long)b * MP, sinks, out + head0,
        part_o + (bh * S + s) * G * D, part_ml + (bh * S + s) * 2 * G,
        decode::split_range<false>(ctx, MP, page_size, window, s, S),
        live <= 1, h, Hkv, G, page_size, scale, cap, nullptr, nullptr, gtid,
        bar);
    if (live <= 1) return;
    __threadfence();
    decode::group_sync(bar);
    if (gtid == 0) last_split[grp] = atomicAdd(tickets + bh, 1) == live - 1;
    decode::group_sync(bar);
    if (!last_split[grp]) return;
    __threadfence();
    decode::combine_splits(part_o + bh * S * G * D, part_ml + bh * S * 2 * G,
                           sinks, out + head0, h, G, D, live, gtid);
    if (gtid == 0) tickets[bh] = 0;
    return;
  }

  // Rank k of row b: its k-th window tile from its last, else the tile
  // past its window (or its length) that no rank before k took.
  if (j >= B) j -= B * SP;
  const int b = j % B, k = j / B;
  const int len = min(max(lengths[b], 0), T);
  const int tiles = len > 1 ? (len + QB - 1) / QB : 0;
  if (k >= tiles) {
    zero_rows<D>(out, b, h, T, Hkv, G, max(k * QB, len == 1 ? 1 : 0),
                 min(T, (k + 1) * QB));
    return;
  }
  const int t0 = (tiles - 1 - k) * QB;
  const int nt = min(QB, len - t0);                  // valid tile rows
  const int q_lo = q_start[b] + t0;
  const int kv_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kv_hi = min(q_lo + nt - 1, MP * page_size - 1);   // inclusive
  flash::attend_tile<D>(smem, q, k_pool, v_pool, page_table, sinks, out, b,
                        h, t0, nt, q_lo, kv_lo, kv_hi, T, Hkv, G, MP,
                        page_size, QB, window, scale, cap);
}

// The grid: Hkv x B x (nqt + SP) blocks, from host-known sizes only.
template <int D>
long long grid_blocks(int B, int T, int Hkv, int QB, int S) {
  constexpr int kSG = split_groups<D>();
  return (long long)Hkv * B * ((T + QB - 1) / QB + (S + kSG - 1) / kSG);
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* page_table;
  const int* q_start;
  const int* lengths;
  const float* sinks;
  void* out;
  void* part_o;
  void* part_ml;
  int* tickets;
  int B, T, Hkv, G, MP, page_size, QB, S, window;
  float scale, cap;
  cudaStream_t stream;
};

template <int D>
int launch(const Args& a) {
  static size_t granted = 0;
  const int err = allow_smem(ragged_paged_attention_kernel<D>,
                             smem_bytes<D>(), &granted);
  if (err) return err;
  const long long blocks = grid_blocks<D>(a.B, a.T, a.Hkv, a.QB, a.S);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ragged_paged_attention_kernel<D><<<(unsigned)blocks, kThreads,
                                     smem_bytes<D>(), a.stream>>>(
      (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k_pool,
      (const __nv_bfloat16*)a.v_pool, a.page_table, a.q_start, a.lengths,
      a.sinks, (__nv_bfloat16*)a.out, (float*)a.part_o, (float*)a.part_ml,
      a.tickets, a.B, a.T, a.Hkv, a.G, a.MP, a.page_size, a.QB, a.S,
      a.window, a.scale, a.cap);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a CUDA error code (0 = launched). D must be 64, 128 or 256 and
// G at most 16 (the wrapper checks both and picks QB = max(1, 128 / G)
// query positions per tile); S >= 1 splits of a decode row, with S > 1
// the scratch and the tickets (B * Hkv ints, zero) required.
extern "C" int ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* page_table, const int* q_start, const int* lengths,
    const float* sinks, void* out, void* part_o, void* part_ml, int* tickets,
    int B, int T, int Hkv, int G, int D, int MP, int page_size, int QB,
    int S, int window, float scale, float cap, void* stream) {
  const Args a{q, k_pool, v_pool, page_table, q_start, lengths, sinks, out,
               part_o, part_ml, tickets, B, T, Hkv, G, MP, page_size, QB,
               S, window, scale, cap, (cudaStream_t)stream};
  if (B <= 0 || T <= 0) return 0;
  if (G < 1 || G > decode::kSplitRows || S < 1 ||
      (S > 1 && (part_o == nullptr || part_ml == nullptr ||
                 tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<64>(a);
    case 128:
      return launch<128>(a);
    case 256:
      return launch<256>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
