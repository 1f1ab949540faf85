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
// What bounds it on an H100: bytes by count (the live keys' K and V, q,
// and the whole [B, T, Hq, D] output, padding rows included, written
// once: ~14 MB, ~4 us at 3.35 TB/s at the serving mix of 7 decode rows of
// a few hundred keys beside one 256-token window in a T = 256 bucket),
// and in time the chains: a window tile walks its key chunks one after
// another, a decode row its context. The design spends launches only on
// work that exists and shortens the longest chains:
// - A fixed grid of persistent blocks (as many as fit on the card at
//   once, fewer for a small bucket), sized from host-known sizes only, so
//   the launch never waits on the lengths and can be captured in a CUDA
//   graph. Each block builds the work list from the B row lengths in
//   shared memory and walks it with a stride of the grid; no block is
//   spent on a tile without a valid query.
// - The work list, in order: the window tiles (rows of length > 1) with
//   the kv head fastest, every row's last tile (the most keys) first, then
//   every row's second to last, and so on; then the decode rows' splits;
//   then the padding, as ranges of 16 KB of zeros. The window items go
//   to the first blocks; the rest to the blocks without one (to all when
//   every block has one), two groups of 128 threads a block, so nothing
//   waits behind a tile while a block idles. A window tile is the
//   prefill kernel's tile code (flash_tile.cuh: 128 (position, head) rows,
//   S and O in registers on the tensor cores, keys in 64-key chunks
//   through a `cp.async` ring) over the key chunks of
//   [max(0, q_lo - W + 1), min(q_hi, q_start + length - 1)], and writes
//   its own tile's rows past the length as zeros.
// - A decode row runs the decode kernel's split walk (decode_row.cuh):
//   its context in S splits of whole 128-key units, S picked by the
//   caller from host-known sizes as for the decode kernel, only the
//   splits that hold keys in the list. A block's two halves (128 threads
//   each) run two splits side by side, each in its own shared memory
//   (one at D = 256, where two do not fit). The splits fold in the same
//   launch: the last split of a (row, kv head) to finish, by a ticket
//   (__threadfence + atomicAdd), folds the partial states in split order,
//   lets the sinks join the denominator once and resets the ticket, so a
//   graph replay finds it at 0. A window row never takes a ticket.
// - The padding zeros (positions past a window's last tile, a decode
//   row's positions 1.., length-0 rows) come last, written with 16-byte
//   stores by whichever halves are done with their live items, so they
//   fill the time the chains leave idle.
//
// Semantics and layout: those of flash_tile.cuh, with q_start and
// lengths [B] int32. Query rows t >= lengths[b] (and rows of length 0)
// output zeros. Scratch for S > 1: part_o [B, Hkv, S, G, D] and part_ml
// [B, Hkv, S, 2, G] float32, tickets [>= B * Hkv] int32, zero between
// calls.

#include <stdint.h>

#include "decode_row.cuh"
#include "flash_tile.cuh"

namespace {

using decode::kSplitThreads;
using decode::SplitPlan;
using flash::kThreads;
using flash::Plan;

constexpr int kGroups = kThreads / kSplitThreads;   // split groups a block
constexpr int kMaxRows = 256;                       // B
constexpr int kMaxRanks = 512;                      // query tiles a row
constexpr int kZeroVecs = 8 * kSplitThreads;        // 16-byte stores an item
constexpr size_t kSmemLimit = 232448;               // a block's, sm_90

// The work list's sizes, built by every block from the row lengths: per
// row its length, q_start and window tiles, and inclusive prefix sums of
// the decode items and zero items over the rows and of the window tiles
// over the ranks (rank k: every row's k-th tile from its last).
struct Rows {
  int len[kMaxRows], qs[kMaxRows], tiles[kMaxRows];
  int dec_end[kMaxRows], zero_end[kMaxRows];
  int rank_end[kMaxRanks];
};

// Splits a block runs side by side: one per group, but one at D = 256,
// where two groups' shared memory does not fit.
template <int D>
__host__ __device__ constexpr int split_groups() {
  return D <= 128 ? kGroups : 1;
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  static_assert(split_groups<D>() * SplitPlan<D>::kTotal + sizeof(Rows) <=
                    kSmemLimit,
                "the split groups' shared memory does not fit");
  return Plan<D>::kTotal > split_groups<D>() * SplitPlan<D>::kTotal
             ? Plan<D>::kTotal
             : split_groups<D>() * SplitPlan<D>::kTotal;
}

// Inclusive prefix sum of a[0, n), in place, by one warp.
__device__ __forceinline__ void warp_scan(int* a, int n) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for (int c = 0; c < n; c += 32) {
    int v = c + lane < n ? a[c + lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (c + lane < n) a[c + lane] = v + carry;
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
}

// The first r in [0, n) with end[r] > u, end non-decreasing.
__device__ __forceinline__ int find_end(const int* end, int n, int u) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (end[mid] > u)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// D: head dim. Two blocks per SM at D = 64 (128 registers a thread), as
// the prefill kernel.
template <int D>
__global__ void __launch_bounds__(kThreads, Plan<D>::kMinBlocks)
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
  __shared__ Rows rows;
  __shared__ int last_split[kGroups];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int nqt = (T + QB - 1) / QB;
  const int pos_vecs = Hkv * G * D / 8;     // 16-byte vectors a position

  // 1. The work list's sizes.
  for (int r = tid; r < B; r += kThreads) {
    const int len = min(max(lengths[r], 0), T);
    const int qs = q_start[r];
    const int tiles = len > 1 ? (len + QB - 1) / QB : 0;
    const int covered = len > 1 ? min(tiles * QB, T) : len;
    rows.len[r] = len;
    rows.qs[r] = qs;
    rows.tiles[r] = tiles;
    rows.dec_end[r] =
        len == 1 ? Hkv * max(1, decode::split_range<false>(
                                    qs + 1, MP, page_size, window, 0, S)
                                    .live)
                 : 0;
    rows.zero_end[r] =
        ((T - covered) * pos_vecs + kZeroVecs - 1) / kZeroVecs;
  }
  __syncthreads();
  if (warp == 0) {
    warp_scan(rows.dec_end, B);
  } else if (warp == 1) {
    warp_scan(rows.zero_end, B);
  } else {
    for (int k = tid - 64; k < nqt; k += kThreads - 64) {
      int n = 0;
      for (int r = 0; r < B; ++r) n += rows.tiles[r] > k;
      rows.rank_end[k] = n;
    }
  }
  __syncthreads();
  if (warp == 0) warp_scan(rows.rank_end, nqt);
  __syncthreads();
  // Units of work: a window item takes a whole block (kGroups units), a
  // split kSW units (one group, or the block where one fits), a zero
  // range one group.
  constexpr int kSG = split_groups<D>();
  constexpr int kSW = kGroups / kSG;
  const int n_win = rows.rank_end[nqt - 1] * Hkv;
  const int split0 = kGroups * n_win;
  const int zero0 = split0 + kSW * rows.dec_end[B - 1];
  const int units = zero0 + rows.zero_end[B - 1];

  // 2. Window tiles, the whole block each.
  for (int p = blockIdx.x; p < n_win; p += gridDim.x) {
    const int j = p / Hkv, h = p % Hkv;
    const int k = find_end(rows.rank_end, nqt, j);
    int idx = j - (k > 0 ? rows.rank_end[k - 1] : 0);
    int b = 0;
    while (rows.tiles[b] <= k || idx-- > 0) ++b;
    const int t0 = (rows.tiles[b] - 1 - k) * QB;
    const int nt = min(QB, rows.len[b] - t0);           // valid tile rows
    const int q_lo = rows.qs[b] + t0;
    const int kv_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
    const int kv_hi = min(q_lo + nt - 1, MP * page_size - 1);  // inclusive
    __syncthreads();          // the previous tile is done with shared memory
    flash::attend_tile<D>(smem, q, k_pool, v_pool, page_table, sinks, out,
                          b, h, t0, nt, q_lo, kv_lo, kv_hi, T, Hkv, G, MP,
                          page_size, QB, window, scale, cap);
  }
  __syncthreads();            // the tiles are done with shared memory

  // 3. Decode splits and zero ranges, each group on its own: pair i of
  // the units after the window items goes to block rest0 + i % rest,
  // the blocks without a window item when there are any, so that no
  // work queues behind a tile while another block idles.
  const int rest0 = n_win < (int)gridDim.x ? n_win : 0;
  const int rest = gridDim.x - rest0;
  if ((int)blockIdx.x < rest0) return;
  const int grp = tid / kSplitThreads, gtid = tid % kSplitThreads;
  const int bar = 1 + grp;
  unsigned char* gsmem = smem + grp * SplitPlan<D>::kTotal;
  for (int pair = blockIdx.x - rest0; split0 + kGroups * pair < units;
       pair += rest) {
    const int u = split0 + kGroups * pair + grp;
    if (u >= units) break;
    if (u < zero0) {
      if ((u - split0) % kSW) continue;     // the block's other half
      const int i = (u - split0) / kSW;
      const int b = find_end(rows.dec_end, B, i);
      const int first = b > 0 ? rows.dec_end[b - 1] : 0;
      const int live = (rows.dec_end[b] - first) / Hkv;
      const int h = (i - first) / live, s = (i - first) % live;
      const long long bh = (long long)b * Hkv + h;
      const long long head0 = ((long long)b * T * Hkv + h) * G * D;
      uint4 qv[SplitPlan<D>::kQVecs];
      decode::load_q<D>(q + head0, G, qv, gtid);
      const decode::SplitRange sr = decode::split_range<false>(
          rows.qs[b] + 1, MP, page_size, window, s, S);
      decode::group_sync(bar);  // its last split is done with shared memory
      decode::attend_split<D, false>(
          gsmem, qv, k_pool, v_pool, page_table + (long long)b * MP, sinks,
          out + head0, part_o + (bh * S + s) * G * D,
          part_ml + (bh * S + s) * 2 * G, sr, live <= 1, h, Hkv, G,
          page_size, scale, cap, nullptr, nullptr, gtid, bar);
      if (live <= 1) continue;
      __threadfence();
      decode::group_sync(bar);
      if (gtid == 0)
        last_split[grp] = atomicAdd(tickets + bh, 1) == live - 1;
      decode::group_sync(bar);
      if (!last_split[grp]) continue;
      __threadfence();
      decode::combine_splits(part_o + bh * S * G * D,
                             part_ml + bh * S * 2 * G, sinks, out + head0, h,
                             G, D, live, gtid);
      if (gtid == 0) tickets[bh] = 0;
    } else {
      const int z = u - zero0;
      const int b = find_end(rows.zero_end, B, z);
      const int lo = (z - (b > 0 ? rows.zero_end[b - 1] : 0)) * kZeroVecs;
      const int len = rows.len[b];
      const int covered = len > 1 ? min(rows.tiles[b] * QB, T) : len;
      const int hi = min(lo + kZeroVecs, (T - covered) * pos_vecs);
      uint4* dst = reinterpret_cast<uint4*>(out) +
                   ((long long)b * T + covered) * pos_vecs;
#pragma unroll
      for (int c = 0; c < kZeroVecs / kSplitThreads; ++c) {
        const int v = lo + c * kSplitThreads + gtid;
        if (v < hi) dst[v] = make_uint4(0, 0, 0, 0);
      }
    }
  }
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

// The grid: the blocks the card holds at once, no more than the largest
// work list of these sizes can use. From host-known sizes only.
template <int D>
int grid_blocks(int B, int T, int Hkv, int G, int QB, int S, int* blocks) {
  static size_t granted = 0;
  static int resident[64] = {0};
  const size_t smem = smem_bytes<D>();
  int err = allow_smem(ragged_paged_attention_kernel<D>, smem, &granted);
  if (err) return err;
  int dev = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = (int)cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)))
      return err;
    if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, ragged_paged_attention_kernel<D>, kThreads, smem)))
      return err;
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long nqt = (T + QB - 1) / QB;
  const long long zero = ((long long)T * Hkv * G * D / 8 + kZeroVecs - 1) /
                         kZeroVecs;
  const long long units = kGroups * B * nqt * Hkv +
                          kGroups / split_groups<D>() * (long long)B * Hkv * S +
                          B * zero;
  const long long want = (units + kGroups - 1) / kGroups;
  *blocks = (int)(want < resident[dev] ? want : resident[dev]);
  if (*blocks < 1) *blocks = 1;
  return 0;
}

template <int D>
int launch(const Args& a) {
  int blocks = 0;
  const int err = grid_blocks<D>(a.B, a.T, a.Hkv, a.G, a.QB, a.S, &blocks);
  if (err) return err;
  ragged_paged_attention_kernel<D><<<blocks, kThreads, smem_bytes<D>(),
                                     a.stream>>>(
      (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k_pool,
      (const __nv_bfloat16*)a.v_pool, a.page_table, a.q_start, a.lengths,
      a.sinks, (__nv_bfloat16*)a.out, (float*)a.part_o, (float*)a.part_ml,
      a.tickets, a.B, a.T, a.Hkv, a.G, a.MP, a.page_size, a.QB, a.S,
      a.window, a.scale, a.cap);
  return (int)cudaGetLastError();
}

int check(int D, const Args& a) {
  if (a.B > kMaxRows || (a.T + a.QB - 1) / a.QB > kMaxRanks || a.G < 1 ||
      a.G > decode::kSplitRows || a.S < 1 ||
      (a.S > 1 && (a.part_o == nullptr || a.part_ml == nullptr ||
                   a.tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  return D == 64 || D == 128 || D == 256 ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns a CUDA error code (0 = launched). D must be 64, 128 or 256, G
// at most 16, B at most 256 and T / QB at most 512 (the wrapper checks
// them and picks QB = max(1, 128 / G) query positions per tile); S >= 1
// splits of a decode row, with S > 1 the scratch and the tickets (B * Hkv
// ints, zero) required.
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
  if (const int err = check(D, a)) return err;
  switch (D) {
    case 64:
      return launch<64>(a);
    case 128:
      return launch<128>(a);
    default:
      return launch<256>(a);
  }
}

// The grid blocks a launch at these sizes takes, into *blocks (for the
// record; the launch computes the same). Returns a CUDA error code.
extern "C" int ragged_paged_attention_blocks(int B, int T, int Hkv, int G,
                                             int D, int QB, int S,
                                             int* blocks) {
  switch (D) {
    case 64:
      return grid_blocks<64>(B, T, Hkv, G, QB, S, blocks);
    case 128:
      return grid_blocks<128>(B, T, Hkv, G, QB, S, blocks);
    case 256:
      return grid_blocks<256>(B, T, Hkv, G, QB, S, blocks);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
