// Single-token attention of multi-head latent attention (MLA) over one
// layer of the paged latent pool, in both orderings of the decode step.
//
// Replaces the Pallas kernel paged_decode_attention_pallas of
// xllm_service_tpu/ops/pallas/paged_attention.py at the MLA geometry the
// DeepSeek path launches it with: one KV "head" per token whose row is the
// latent [c_hat | rope(k_pe)] (D = kv_lora_rank + qk_rope_head_dim = 576),
// passed as both K and V, and the absorbed queries of all heads attending
// to it. Two forms:
// - entry paged_decode_attention_mla, write-then-attend: the current
//   token's row is already in the pool, the context includes it;
// - entry paged_decode_attention_mla_current, attend-then-write: the pool
//   holds the cache_len rows before the current one, which comes as
//   latent_cur and is the last key. The pool slot at cache_len is never
//   read (it is stale in this ordering); a row with cache length 0
//   attends to its current row alone.
//
// What bounds it on an H100: bytes. Per key the row is 1,152 bytes and the
// two products take 16 heads x 576 x 4 = 36,864 flops, about 32 flops per
// byte: below the ~295 at which the tensor cores would be the limit, but
// above the ~20 that float32 FMAs on the CUDA cores sustain. So the design
// reads each latent row from device memory once, uses the staged copy for
// both Q K^T and P V, runs both products on the tensor cores, and spreads
// the rows' bytes over the whole card:
// - Split-KV. The grid is B x S: split s of row b walks an equal share of
//   whole 64-key chunks of [0, ctx) (with CUR the current row, the last
//   key, falls in the last non-empty split). The caller picks S from
//   host-known sizes (B and the page table's width), so a batch of 8 rows
//   fills the 132 SMs instead of 8 of them. Each split writes its float32
//   partial O [16, 576] and its softmax state (m, l) to scratch, then
//   takes a ticket on the row's counter (__threadfence + atomicAdd); the
//   split that takes the last ticket combines all partials in split order
//   (so the result does not depend on which block finished last), writes
//   the bf16 output and resets the counter to 0, so one launch does the
//   whole call and CUDA-graph replays stay right. Only the splits that
//   hold keys run (a short row leaves the trailing ones empty), and a row
//   held by one split, or none (context 0: zeros), is written by that
//   split directly, without the scratch.
// - The 16 query heads are one 16-row tile, so a split reads each latent
//   row once for all heads. Both products are `mma.sync` m16n8k16 (bf16
//   in, float32 out): `wgmma`'s 64-row minimum would waste three quarters
//   of it at 16 heads. Operands come through `ldmatrix` from shared
//   memory: Q and K row-major, V (the same rows) through `.trans`.
// - S = Q K^T: warp w computes keys [8w, 8w + 8) of the 64-key chunk over
//   all 576 columns, and stores its 16 x 8 block in shared memory: the
//   only exchange across warps. Every warp then reads the whole 16 x 64
//   S, takes the row max (a thread's own values, then two quad shuffles)
//   and builds P = exp(S - m), rounded to bf16, directly as the A operand
//   of O += P V in registers. The row sum stays per thread until the end.
// - O stays in registers for the whole walk: warp w owns columns [72w,
//   72w + 72) of O, 9 n8 tiles, 36 floats a thread; the rescale by the
//   chunk's correction is done there.
// - The chunks stream through two shared buffers with `cp.async`: the next
//   chunk's rows load while this one computes. Two barriers a chunk.
//
// Layout: q and out [B, Hq, D] bf16 (Hq <= 16); the pool [P, ps, 1, D]
// bf16 (the caller passes latent_pages[layer]); page table [B, MP] int32;
// lens [B] int32 (context lengths, or cache lengths with CUR); latent_cur
// [B, 1, D] bf16 (CUR only); with S > 1, scratch part_o [B, S, 16, D] and
// part_ml [B, S, 2, 16] float32 and tickets [>= B] int32, zero between
// calls.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_sync.cuh"

namespace {

using namespace msync;

constexpr int kD = 576;                 // latent row: 512 + 64
constexpr int kKeys = 64;               // keys per chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;               // query heads: one m16 tile
constexpr int kPad = 8;                 // bf16 padding per shared row
constexpr int kVpr = kD / 8;            // 16-byte vectors per row: 72
constexpr int kVecs = kKeys * kVpr / kThreads;   // per thread per chunk: 18
constexpr int LQ = kD + kPad;           // bf16 row stride: Q, latent
constexpr int LS = kKeys + 8;           // float row stride: S
constexpr int kCols = kD / kWarps;      // O columns per warp: 72
constexpr int kNt = kCols / 8;          // n8 tiles per warp: 9
static_assert(kKeys * kVpr % kThreads == 0, "chunk must split evenly");
static_assert(kKeys == 8 * kWarps, "one n8 block of S per warp");

__host__ __device__ constexpr size_t align128(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

constexpr size_t kQBytes = align128(kRows * LQ * 2);
constexpr size_t kLatBytes = align128(kKeys * LQ * 2);   // one buffer
constexpr size_t kSBytes = align128(kRows * LS * 4);
constexpr size_t kSmem = kQBytes + 2 * kLatBytes + kSBytes;

// Stage keys [c0, c0 + n) into `buf` (rows >= n zero). With CUR the key at
// position pool_end is the current row.
template <bool CUR>
__device__ __forceinline__ void stage_chunk(
    __nv_bfloat16* buf, const __nv_bfloat16* __restrict__ pool,
    const int* __restrict__ table_row, const __nv_bfloat16* __restrict__ cur,
    int c0, int n, int pool_end, int page_size) {
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int j = i / kVpr, c = i % kVpr;
    const int pos = c0 + j;
    const __nv_bfloat16* src = pool;      // any valid address when unused
    if (j < n) {
      if (CUR && pos >= pool_end) {
        src = cur + c * 8;
      } else {
        const int page = table_row[pos / page_size];
        src = pool + ((long long)page * page_size + pos % page_size) * kD +
              c * 8;
      }
    }
    cp_async16(buf + j * LQ + c * 8, src, j < n);
  }
}

// The last live split of row b: fold the `live` partial states in split
// order into the bf16 output. `w` is shared scratch of (live + 1) x 16
// floats; live <= kMaxSplits.
constexpr int kMaxSplits = 160;
static_assert((kMaxSplits + 1) * kRows * 4 <= kLatBytes,
              "the combine's weights fit a latent buffer");
__device__ __forceinline__ void combine(float* w,
                                        const float* __restrict__ part_o,
                                        const float* __restrict__ part_ml,
                                        __nv_bfloat16* __restrict__ out,
                                        int b, int S, int live, int Hq) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* inv = w + live * kRows;
  const float* ml = part_ml + (long long)b * S * 2 * kRows;
  // Per head: the combined max M, the weights 2^(m_s - M) and
  // 1 / sum_s l_s 2^(m_s - M); each lane reads its splits' states once.
  constexpr int kPerLane = kMaxSplits / 32;
  for (int r = warp; r < kRows; r += kWarps) {
    float mv[kPerLane], lv[kPerLane];
    float mx = XLLM_NEG_INF;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int s = lane + 32 * j;
      mv[j] = s < live ? __ldcg(ml + s * 2 * kRows + r) : XLLM_NEG_INF;
      lv[j] = s < live ? __ldcg(ml + (s * 2 + 1) * kRows + r) : 0.f;
      mx = fmaxf(mx, mv[j]);
    }
    mx = warp_max(mx);
    float den = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int s = lane + 32 * j;
      if (s < live) {
        const float e = ex2(mv[j] - mx);
        w[s * kRows + r] = e;
        den += lv[j] * e;
      }
    }
    den = warp_sum(den);
    if (lane == 0) inv[r] = den > 0.f ? 1.f / den : 0.f;
  }
  __syncthreads();
  // O: each thread owns 9 float4 of the 16 x 576 output and reads them
  // from 4 splits at a time, all 36 loads in flight.
  constexpr int kV4 = kD / 4;                       // float4 per row
  constexpr int kItems = kRows * kV4 / kThreads;    // per thread: 9
  constexpr int kUnroll = 4;
  const float4* po = reinterpret_cast<const float4*>(part_o) +
                     (long long)b * S * kRows * kV4;
  float4 acc[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < live; s0 += kUnroll) {
    float4 v[kUnroll][kItems];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
#pragma unroll
      for (int u = 0; u < kItems; ++u)
        if (s0 + k < live)
          v[k][u] = __ldcg(po + (long long)(s0 + k) * kRows * kV4 + tid +
                           u * kThreads);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
#pragma unroll
      for (int u = 0; u < kItems; ++u)
        if (s0 + k < live) {
          const float e = w[(s0 + k) * kRows + (tid + u * kThreads) / kV4];
          acc[u].x += e * v[k][u].x;
          acc[u].y += e * v[k][u].y;
          acc[u].z += e * v[k][u].z;
          acc[u].w += e * v[k][u].w;
        }
  }
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int i = tid + u * kThreads;
    const int r = i / kV4;
    if (r < Hq) {
      const float f = inv[r];
      uint2 v;
      v.x = pack_bf16(acc[u].x * f, acc[u].y * f);
      v.y = pack_bf16(acc[u].z * f, acc[u].w * f);
      *reinterpret_cast<uint2*>(out + ((long long)b * Hq + r) * kD +
                                (i % kV4) * 4) = v;
    }
  }
}

template <bool CUR>
__global__ void __launch_bounds__(kThreads, 1)
paged_decode_attention_mla_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ pool,
    const int* __restrict__ page_table, const int* __restrict__ lens,
    const __nv_bfloat16* __restrict__ latent_cur,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
    float* __restrict__ part_ml, int* __restrict__ tickets, int Hq, int MP,
    int page_size, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = (__nv_bfloat16*)smem;                    // [16][LQ]
  __nv_bfloat16* lat_s[2] = {(__nv_bfloat16*)(smem + kQBytes),  // [64][LQ]
                             (__nv_bfloat16*)(smem + kQBytes + kLatBytes)};
  float* s_s = (float*)(smem + kQBytes + 2 * kLatBytes);        // [16][LS]
  __shared__ int last_split;

  const int split = blockIdx.x, S = gridDim.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int* table_row = page_table + (long long)b * MP;
  const __nv_bfloat16* cur = CUR ? latent_cur + (long long)b * kD : nullptr;

  // Q rows (heads >= Hq zero) into registers first: nothing they wait on
  // depends on the context length.
  constexpr int kQv = (kRows * kVpr + kThreads - 1) / kThreads;   // 5
  uint4 qv[kQv];
#pragma unroll
  for (int u = 0; u < kQv; ++u) {
    const int i = tid + u * kThreads;
    const int r = i / kVpr, c = i % kVpr;
    qv[u] = make_uint4(0, 0, 0, 0);
    if (i < kRows * kVpr && r < Hq)
      qv[u] = *reinterpret_cast<const uint4*>(
          q + ((long long)b * Hq + r) * kD + c * 8);
  }

  // Keys [0, ctx); with CUR the last of them, position pool_end, is the
  // current row. This split's chunks: [c_lo, c_hi). Only the first
  // `live` splits hold keys; the others have nothing to do. A row
  // without keys (context 0) is written, as zeros, by split 0.
  const int pool_end = min(lens[b], MP * page_size);
  const int ctx = CUR ? pool_end + 1 : pool_end;
  const int chunks = (ctx + kKeys - 1) / kKeys;
  const int per = (chunks + S - 1) / S;
  const int live = per > 0 ? (chunks + per - 1) / per : 0;
  if (split >= max(live, 1)) return;
  const int c_lo = split * per;
  const int c_hi = min(c_lo + per, chunks);
  if (c_lo < c_hi) {
    stage_chunk<CUR>(lat_s[0], pool, table_row, cur, c_lo * kKeys,
                     min(kKeys, ctx - c_lo * kKeys), pool_end, page_size);
    cp_async_commit();
  }
#pragma unroll
  for (int u = 0; u < kQv; ++u) {
    const int i = tid + u * kThreads;
    if (i < kRows * kVpr)
      *reinterpret_cast<uint4*>(q_s + (i / kVpr) * LQ + (i % kVpr) * 8) =
          qv[u];
  }

  float o[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m_r[2] = {XLLM_NEG_INF, XLLM_NEG_INF};   // rows g, g + 8 (log2)
  float l_r[2] = {0.f, 0.f};                     // this thread's columns
  const float sl2 = scale * kLog2e;
  // ldmatrix row addresses: Q (A operand) rows lane % 16 at column
  // 8 (lane / 16); K (B operand) key 8w + lane % 8 at column 8 (lane / 8);
  // V (B operand, .trans) key lane at this warp's first column.
  const uint32_t qa = smem_u32(q_s + (lane & 15) * LQ + (lane >> 4) * 8);
  const uint32_t koff = ((8 * warp + (lane & 7)) * LQ + (lane >> 3) * 8) * 2;
  const uint32_t voff = (lane * LQ + warp * kCols) * 2;

  for (int ci = c_lo; ci < c_hi; ++ci) {
    const int n = min(kKeys, ctx - ci * kKeys);
    const __nv_bfloat16* lat = lat_s[(ci - c_lo) & 1];
    // 1. This chunk's rows have landed, and every warp is done with the
    //    previous chunk (its S block and the other buffer); the next
    //    chunk's rows start loading into that buffer.
    cp_async_wait_all();
    __syncthreads();
    if (ci + 1 < c_hi) {
      stage_chunk<CUR>(lat_s[(ci + 1 - c_lo) & 1], pool, table_row, cur,
                       (ci + 1) * kKeys, min(kKeys, ctx - (ci + 1) * kKeys),
                       pool_end, page_size);
      cp_async_commit();
    }
    // 2. S = Q K^T for keys [8w, 8w + 8), two accumulators for two
    //    independent chains; the block goes to shared memory.
    {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const uint32_t kb = smem_u32(lat) + koff;
#pragma unroll
      for (int k0 = 0; k0 < kD; k0 += 32) {
        uint32_t a0[4], a1[4], bk[4];
        ldsm_x4(qa + k0 * 2, a0);
        ldsm_x4(qa + (k0 + 16) * 2, a1);
        ldsm_x4(kb + k0 * 2, bk);
        mma_bf16(acc[0], a0, bk[0], bk[1]);
        mma_bf16(acc[1], a1, bk[2], bk[3]);
      }
      const int col = 8 * warp + 2 * t;
      *reinterpret_cast<float2*>(s_s + g * LS + col) =
          make_float2(acc[0][0] + acc[1][0], acc[0][1] + acc[1][1]);
      *reinterpret_cast<float2*>(s_s + (g + 8) * LS + col) =
          make_float2(acc[0][2] + acc[1][2], acc[0][3] + acc[1][3]);
    }
    __syncthreads();
    // 3. Online softmax on rows g and g + 8, in log2 units: the thread
    //    reads the 16 scores of each row that its P fragments hold
    //    (columns 16kk + 2t + {0, 1, 8, 9}); keys >= n are masked.
    float sv[2][16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 16 * kk + 2 * t + 8 * h;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float2 v =
              *reinterpret_cast<const float2*>(s_s + (g + 8 * rr) * LS + j);
          sv[rr][4 * kk + 2 * h] = j < n ? v.x * sl2 : -INFINITY;
          sv[rr][4 * kk + 2 * h + 1] = j + 1 < n ? v.y * sl2 : -INFINITY;
        }
      }
    float corr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = sv[rr][0];
#pragma unroll
      for (int e = 1; e < 16; ++e) mx = fmaxf(mx, sv[rr][e]);
      const float m_new = fmaxf(m_r[rr], quad_max(mx));
      corr[rr] = ex2(m_r[rr] - m_new);
      m_r[rr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        sv[rr][e] = ex2(sv[rr][e] - m_new);
        sum += sv[rr][e];
      }
      l_r[rr] = l_r[rr] * corr[rr] + sum;
    }
    // 4. Rescale O, then O += P V: P (bf16) from registers, V through
    //    ldmatrix.trans, 32 keys per load; key steps past n are skipped.
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      o[nt][0] *= corr[0];
      o[nt][1] *= corr[0];
      o[nt][2] *= corr[1];
      o[nt][3] *= corr[1];
    }
    const uint32_t vb = smem_u32(lat) + voff;
#pragma unroll
    for (int kp = 0; kp < 2; ++kp) {
      if (32 * kp >= n) break;
      uint32_t pa[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = 2 * kp + h;
        pa[h][0] = pack_bf16(sv[0][4 * kk], sv[0][4 * kk + 1]);
        pa[h][1] = pack_bf16(sv[1][4 * kk], sv[1][4 * kk + 1]);
        pa[h][2] = pack_bf16(sv[0][4 * kk + 2], sv[0][4 * kk + 3]);
        pa[h][3] = pack_bf16(sv[1][4 * kk + 2], sv[1][4 * kk + 3]);
      }
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        uint32_t bv[4];
        ldsm_x4_trans(vb + (32 * kp * LQ + 8 * nt) * 2, bv);
        mma_bf16(o[nt], pa[0], bv[0], bv[1]);
        mma_bf16(o[nt], pa[1], bv[2], bv[3]);
      }
    }
  }
  l_r[0] = quad_sum(l_r[0]);
  l_r[1] = quad_sum(l_r[1]);

  // 5. Out. A row held by one split (or none: context 0, zeros) is
  //    written, normalised, by that split. Otherwise each split writes
  //    its state and the last of the row's live splits to take a ticket
  //    folds them.
  const int col0 = warp * kCols + 2 * t;
  if (live <= 1) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = g + 8 * rr;
      if (r >= Hq) continue;
      const float f = l_r[rr] > 0.f ? 1.f / l_r[rr] : 0.f;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
        *reinterpret_cast<uint32_t*>(out + ((long long)b * Hq + r) * kD +
                                     col0 + 8 * nt) =
            pack_bf16(o[nt][2 * rr] * f, o[nt][2 * rr + 1] * f);
    }
    return;
  }
  const long long part = (long long)b * S + split;
  float* po = part_o + part * kRows * kD;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
      *reinterpret_cast<float2*>(po + (g + 8 * rr) * kD + col0 + 8 * nt) =
          make_float2(o[nt][2 * rr], o[nt][2 * rr + 1]);
  if (warp == 0 && t == 0) {
    float* ml = part_ml + part * 2 * kRows;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      ml[g + 8 * rr] = m_r[rr];
      ml[kRows + g + 8 * rr] = l_r[rr];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_split = atomicAdd(tickets + b, 1) == live - 1;
  __syncthreads();
  if (!last_split) return;
  __threadfence();
  combine(reinterpret_cast<float*>(lat_s[0]), part_o, part_ml, out, b, S,
          live, Hq);
  if (tid == 0) tickets[b] = 0;
}

template <bool CUR>
int launch(const void* q, const void* pool, const int* page_table,
           const int* lens, const void* latent_cur, void* out, void* part_o,
           void* part_ml, int* tickets, int B, int Hq, int D, int MP,
           int page_size, int splits, float scale, void* stream) {
  if (D != kD || Hq < 1 || Hq > kRows || splits < 1 ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr ||
                      tickets == nullptr)) ||
      splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  static size_t granted = 0;
  const int err =
      allow_smem(paged_decode_attention_mla_kernel<CUR>, kSmem, &granted);
  if (err) return err;
  paged_decode_attention_mla_kernel<CUR>
      <<<dim3(splits, B), kThreads, kSmem, (cudaStream_t)stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)pool, page_table,
          lens, (const __nv_bfloat16*)latent_cur, (__nv_bfloat16*)out,
          (float*)part_o, (float*)part_ml, tickets, Hq, MP, page_size, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a CUDA error code (0 = launched). D must be 576, Hq in [1, 16]
// and splits >= 1 (the wrapper checks all three); with splits > 1 the
// scratch and the tickets (B ints, zero) are required.
extern "C" int paged_decode_attention_mla(
    const void* q, const void* pool, const int* page_table,
    const int* context_lens, void* out, void* part_o, void* part_ml,
    int* tickets, int B, int Hq, int D, int MP, int page_size, int splits,
    float scale, void* stream) {
  return launch<false>(q, pool, page_table, context_lens, nullptr, out,
                       part_o, part_ml, tickets, B, Hq, D, MP, page_size,
                       splits, scale, stream);
}

// The attend-then-write form: cache_lens exclude the current token, whose
// latent row is latent_cur [B, 1, D]. Same return and limits.
extern "C" int paged_decode_attention_mla_current(
    const void* q, const void* pool, const int* page_table,
    const int* cache_lens, const void* latent_cur, void* out, void* part_o,
    void* part_ml, int* tickets, int B, int Hq, int D, int MP, int page_size,
    int splits, float scale, void* stream) {
  return launch<true>(q, pool, page_table, cache_lens, latent_cur, out,
                      part_o, part_ml, tickets, B, Hq, D, MP, page_size,
                      splits, scale, stream);
}
