// Single-query GQA attention of one (row, kv head) over one layer of the
// paged KV pool: the device code shared by the decode kernels
// (paged_decode_attention.cu, both orderings) and the ragged kernel's
// decode rows (ragged_paged_attention.cu).
//
// It is bound by bytes: the row reads its context's K and V once
// (2 x ctx x Hkv x D x 2 bytes) for 4 x G flops per byte, far below the
// ~295 flops per byte where the tensor cores would become the limit. So
// it reads every K/V row of the context exactly once and keeps as many of
// those reads in flight as it can: one block serves all G query heads of
// the group. For each chunk of 128 keys, each thread takes one key: it
// looks up the key's page once, then issues all the 16-byte loads of that
// key's K and V head rows before it stores any of them to shared memory,
// so a chunk costs about one memory latency, not one per load. Then one
// thread per key computes the G scores from shared memory and the online
// float32 softmax folds the chunk; nothing but the output is written
// back. Keys outside [ctx - W, ctx) are never read. The head dim D and
// the group width are template parameters, so the per-key dot products
// and the P @ V loop unroll into independent loads and FMAs instead of
// one dependent chain per element: with one block per (row, kv head)
// there are few warps to hide latency, so each warp needs the
// instruction-level parallelism.
//
// Semantics (those of the Pallas decode kernel): the query sits at
// position ctx - 1; positions >= ctx and, with a sliding window W > 0,
// positions <= ctx - 1 - W are masked; logits are scaled by `scale`,
// then soft-capped; sinks join the denominator only; ctx = 0 outputs
// zeros.
//
// With CUR (the Pallas kernel's has_current form, attend-then-write
// decode), `ctx_raw` is the cache length, the current token EXcluded: the
// query sits at position cache_len, the pool holds [0, cache_len) and
// the current token's K/V row comes from k_cur/v_cur. The key walk is the
// same; only the staging step picks where a key's bytes come from: the
// key at position cache_len from the current row, the others through the
// page table. The pool slot at cache_len is never read (it is stale in
// this ordering). The current key is always valid, so a row with
// cache_len 0 attends to it alone and is not zeros.
//
// Layout: the caller passes the row's G query head rows (qb, [G][D] bf16)
// and output rows (ob), its page-table row, the pools [P, ps, Hkv, D]
// bf16 of one layer and, with CUR, the current token's K and V head rows
// ([D] bf16 each).
//
// Split-KV (split_range, attend_split and combine_splits: the decode
// kernels' walk; the ragged kernel's decode rows keep attend_row). With
// one block per (row, kv head) a batch of 8 llama3-1b rows is 64 blocks on
// 132 SMs, each walking its chunks one after another, and each chunk of
// attend_row is a chain of shared-memory loads and FMAs on the CUDA cores
// (one thread per key, then one per column). attend_split takes split s
// of S: an equal share, in whole 128-key units, of the attended range
// [lo, ctx) (so a sliding window cuts across splits, and with CUR the
// current key falls in the last non-empty split). Only the first `live`
// splits hold keys; the others have nothing to do. It walks its share in
// 64-key steps on the tensor cores, as the MLA kernel does: the G query
// heads of the kv head padded to one 16-row `mma.sync` m16n8k16 tile, Q's
// fragments in registers for the whole walk, K and V staged by `cp.async`
// into two buffers (the next step's rows load while this one computes),
// S = Q K^T by 4 warps of 16 keys each through shared memory, the online
// softmax on every warp's copy of the rows (log2 units, P rounded to bf16
// as the plain version rounds it), and O += P V with O in registers, each
// warp owning D / 4 columns. Two barriers a step. A row held by one live
// split (or none: context 0) is finished by that split, as attend_row
// finishes it. Otherwise each live split writes its unnormalised float32
// O [G][D] and its softmax state (m, l) instead of the output, and
// combine_splits folds the live states in split order and only then lets
// the sinks join the denominator, once. Soft-cap applies per logit inside
// the split.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_sync.cuh"

namespace decode {

constexpr int kChunk = 128;   // keys per step of attend_row; a split's unit
constexpr int kBatch = 8;     // 16-byte loads in flight per row and tensor

// Shared memory of one block (bytes): D head dim, KG the group width G
// rounded up to a power of two, G the group width, THREADS the block.
__host__ __device__ constexpr size_t smem_bytes(int D, int KG, int G,
                                                int THREADS) {
  return sizeof(float) *
             (size_t)(KG * D + KG * kChunk + 3 * G + (THREADS / D) * G * D) +
         sizeof(uint32_t) * (size_t)kChunk * 2 * (D / 2 + 1);
}

// KG: the group width G rounded up to a power of two (rows g >= G of the
// group are skipped). THREADS: the block size, a multiple of D. CUR: the
// current token's K/V row is a separate operand (see above).
template <int D, int KG, int THREADS, bool CUR = false>
__device__ __forceinline__ void attend_row(
    float* smem, const __nv_bfloat16* __restrict__ qb,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool,
    const int* __restrict__ table_row, const float* __restrict__ sinks,
    __nv_bfloat16* __restrict__ ob, int ctx_raw, int h, int Hkv, int G,
    int MP, int page_size, int window, float scale, float cap,
    const __nv_bfloat16* __restrict__ k_cur = nullptr,
    const __nv_bfloat16* __restrict__ v_cur = nullptr) {
  constexpr int nsplit = THREADS / D;
  constexpr int KW = D / 2 + 1;         // K/V row stride, bf16 pairs (padded)
  constexpr int vpr = D / 8;            // 16-byte vectors per head row
  // Unroll the dot products fully while the body stays small; cap it for
  // wide heads x wide groups, whose full unroll only costs build time.
  constexpr int kDotUnroll = (D / 2) * KG <= 256 ? D / 2 : 8;
  float* q_s = smem;                    // [KG][D], rows >= G zero
  float* p_s = q_s + KG * D;            // [KG][kChunk] scores, then probs
  float* m_s = p_s + KG * kChunk;       // [G] running max
  float* l_s = m_s + G;                 // [G] running denominator
  float* c_s = l_s + G;                 // [G] this chunk's rescale
  float* red = c_s + G;                 // [nsplit][G][D]
  uint32_t* k_s = (uint32_t*)(red + nsplit * G * D);  // [kChunk][KW]
  uint32_t* v_s = k_s + kChunk * KW;                  // [kChunk][KW]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int nwarps = THREADS / 32;
  const long long row_stride = (long long)Hkv * D;

  // Keys [lo, ctx). With CUR the last of them, position pool_end, is
  // the current token.
  const int pool_end = min(ctx_raw, MP * page_size);
  const int ctx = CUR ? pool_end + 1 : pool_end;
  const int q_pos = CUR ? ctx_raw : ctx_raw - 1;
  int lo = window > 0 ? max(0, q_pos - window + 1) : 0;
  if constexpr (CUR) lo = min(lo, pool_end);

  for (int i = tid; i < KG * D; i += THREADS)
    q_s[i] = i < G * D ? __bfloat162float(qb[i]) : 0.f;
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = XLLM_NEG_INF;
    l_s[g] = 0.f;
  }
  // PV mapping: thread owns column d of every head of the group, over
  // the keys t = split, split + nsplit, ...
  const int d = tid % D;
  const int split = tid / D;
  float acc[KG];
#pragma unroll
  for (int g = 0; g < KG; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int c0 = lo; c0 < ctx; c0 += kChunk) {
    const int n = min(kChunk, ctx - c0);
    // 1. Stage the chunk's K and V head rows, one key row per thread:
    //    every load of a batch is issued before its stores.
    for (int t = tid; t < n; t += THREADS) {
      const int pos = c0 + t;
      const uint4* ksrc;
      const uint4* vsrc;
      if (CUR && pos >= pool_end) {
        ksrc = reinterpret_cast<const uint4*>(k_cur);
        vsrc = reinterpret_cast<const uint4*>(v_cur);
      } else {
        const int page = table_row[pos / page_size];
        const long long off =
            ((long long)page * page_size + pos % page_size) * row_stride +
            (long long)h * D;
        ksrc = reinterpret_cast<const uint4*>(k_pool + off);
        vsrc = reinterpret_cast<const uint4*>(v_pool + off);
      }
#pragma unroll
      for (int c0v = 0; c0v < vpr; c0v += kBatch) {
        uint4 kr[kBatch], vr[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (c0v + u < vpr) {
            kr[u] = ksrc[c0v + u];
            vr[u] = vsrc[c0v + u];
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (c0v + u < vpr) {
            uint32_t* kd = k_s + t * KW + (c0v + u) * 4;
            kd[0] = kr[u].x; kd[1] = kr[u].y; kd[2] = kr[u].z; kd[3] = kr[u].w;
            uint32_t* vd = v_s + t * KW + (c0v + u) * 4;
            vd[0] = vr[u].x; vd[1] = vr[u].y; vd[2] = vr[u].z; vd[3] = vr[u].w;
          }
        }
      }
    }
    __syncthreads();
    // 2. Scores: one thread per key (the padded K rows spread the banks).
    for (int t = tid; t < n; t += THREADS) {
      const __nv_bfloat162* kr =
          reinterpret_cast<const __nv_bfloat162*>(k_s + t * KW);
      float part[KG];
#pragma unroll
      for (int g = 0; g < KG; ++g) part[g] = 0.f;
#pragma unroll kDotUnroll
      for (int e2 = 0; e2 < D / 2; ++e2) {
        const float2 kf = __bfloat1622float2(kr[e2]);
#pragma unroll
        for (int g = 0; g < KG; ++g)
          part[g] += q_s[g * D + 2 * e2] * kf.x +
                     q_s[g * D + 2 * e2 + 1] * kf.y;
      }
#pragma unroll
      for (int g = 0; g < KG; ++g)
        if (g < G) p_s[g * kChunk + t] = soft_cap(part[g] * scale, cap);
    }
    __syncthreads();
    // 3. Online softmax: one warp per query head.
    for (int g = warp; g < G; g += nwarps) {
      float mx = XLLM_NEG_INF;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, p_s[g * kChunk + t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(p_s[g * kChunk + t] - m_new);
        p_s[g * kChunk + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // 4. P @ V from shared memory into the per-thread accumulators.
#pragma unroll
    for (int g = 0; g < KG; ++g)
      if (g < G) acc[g] *= c_s[g];
    const __nv_bfloat16* vcol =
        reinterpret_cast<const __nv_bfloat16*>(v_s) + d;
#pragma unroll 8
    for (int t = split; t < n; t += nsplit) {
      const float v = __bfloat162float(vcol[t * 2 * KW]);
#pragma unroll
      for (int g = 0; g < KG; ++g)
        acc[g] += p_s[g * kChunk + t] * v;
    }
    __syncthreads();
  }

  // 5. Sum the key splits and normalise.
#pragma unroll
  for (int g = 0; g < KG; ++g)
    if (g < G) red[(split * G + g) * D + d] = acc[g];
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    const int dd = i % D;
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s) a += red[(s * G + g) * D + dd];
    ob[i] = __float2bfloat16(finish_row(a, m_s[g], l_s[g], sinks, h * G + g));
  }
}

// Split `split` of `num_splits` of a row's attended keys: its share
// [k_lo, k_hi) of whole kChunk-key chunks of [lo, ctx), the number of
// splits that hold keys (`live`), and pool_end (keys at or past it come
// from the current row with CUR).
struct SplitRange {
  int pool_end, k_lo, k_hi, live;
};

template <bool CUR>
__device__ __forceinline__ SplitRange split_range(int ctx_raw, int MP,
                                                  int page_size, int window,
                                                  int split, int num_splits) {
  const int pool_end = min(ctx_raw, MP * page_size);
  const int ctx = CUR ? pool_end + 1 : pool_end;
  const int q_pos = CUR ? ctx_raw : ctx_raw - 1;
  int lo = window > 0 ? max(0, q_pos - window + 1) : 0;
  if constexpr (CUR) lo = min(lo, pool_end);
  lo = min(lo, ctx);
  const int chunks = (ctx - lo + kChunk - 1) / kChunk;
  const int per = (chunks + num_splits - 1) / num_splits;
  const int k_lo = lo + min(split * per, chunks) * kChunk;
  return {pool_end, k_lo, min(ctx, k_lo + per * kChunk),
          per > 0 ? (chunks + per - 1) / per : 0};
}

// The split walk's tile: 16 query rows (the kv head's G heads, padded),
// 64 keys a step, 4 warps; shared memory holds Q, two stages of K and V
// (rows of D bf16 padded by 16 bytes, so that `ldmatrix` rows fall in
// distinct banks) and S.
constexpr int kSplitRows = 16;
constexpr int kSplitKeys = 64;
constexpr int kSplitThreads = 128;

template <int D>
struct SplitPlan {
  static constexpr int LK = D + 8;                   // bf16 row stride
  static constexpr int LS = kSplitKeys + 8;          // float row stride of S
  static constexpr size_t kQ = (size_t)kSplitRows * LK * 2;
  static constexpr size_t kKV = (size_t)kSplitKeys * LK * 2;  // per tensor
  static constexpr size_t kS = (size_t)kSplitRows * LS * 4;
  static constexpr size_t kTotal = kQ + 4 * kKV + kS;
  // 16-byte vectors of the Q tile each thread loads.
  static constexpr int kQVecs = (kSplitRows * D / 8 + kSplitThreads - 1) /
                                kSplitThreads;
};

// The first loads of a split, issued before anything that waits on the
// context length: this thread's vectors of the Q tile (rows >= G zero).
template <int D>
__device__ __forceinline__ void load_q(const __nv_bfloat16* __restrict__ qb,
                                       int G,
                                       uint4 (&qv)[SplitPlan<D>::kQVecs]) {
#pragma unroll
  for (int u = 0; u < SplitPlan<D>::kQVecs; ++u) {
    const int i = threadIdx.x + u * kSplitThreads;
    const int r = i / (D / 8);
    qv[u] = make_uint4(0, 0, 0, 0);
    if (i < kSplitRows * D / 8 && r < G)
      qv[u] = reinterpret_cast<const uint4*>(qb)[i];
  }
}

// The walk over the keys [sr.k_lo, sr.k_hi) of one (row, kv head h), Q
// from `qv` (load_q). With `finish` it writes the normalised output rows
// ob [G][D] (zeros for an empty range); otherwise the split's state:
// part_o [G][D] (O before normalisation) and part_ml [2][G] (m, then l,
// natural units). `smem` holds SplitPlan<D>::kTotal bytes.
template <int D, bool CUR>
__device__ __forceinline__ void attend_split(
    unsigned char* smem, const uint4 (&qv)[SplitPlan<D>::kQVecs],
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool,
    const int* __restrict__ table_row, const float* __restrict__ sinks,
    __nv_bfloat16* __restrict__ ob, float* __restrict__ part_o,
    float* __restrict__ part_ml, const SplitRange& sr, bool finish, int h,
    int Hkv, int G, int page_size, float scale, float cap,
    const __nv_bfloat16* __restrict__ k_cur = nullptr,
    const __nv_bfloat16* __restrict__ v_cur = nullptr) {
  using namespace msync;
  using Plan = SplitPlan<D>;
  constexpr int LK = Plan::LK, LS = Plan::LS;
  constexpr int vpr = D / 8;                // 16-byte vectors per row
  constexpr int KT = D / 16;                // k-steps of S = Q K^T
  constexpr int kCols = D / 4;              // O columns per warp
  constexpr int NT = kCols / 8;             // n8 tiles of O per warp
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_s = reinterpret_cast<float*>(smem + Plan::kQ + 4 * Plan::kKV);
  auto kv_s = [&](int stage, int x) {       // x: 0 = K, 1 = V
    return reinterpret_cast<__nv_bfloat16*>(smem + Plan::kQ +
                                            (2 * stage + x) * Plan::kKV);
  };
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k_lo = sr.k_lo, k_hi = sr.k_hi;
  if (k_lo >= k_hi) {                       // context 0: zeros
    for (int i = tid; i < G * D; i += kSplitThreads)
      ob[i] = __float2bfloat16(0.f);
    return;
  }
  const long long row_stride = (long long)Hkv * D;
  // Stage keys [c0, c0 + n) of K and V into `buf` (rows >= n zero).
  auto stage = [&](int buf, int c0, int n) {
    __nv_bfloat16* kd = kv_s(buf, 0);
    __nv_bfloat16* vd = kv_s(buf, 1);
    for (int i = tid; i < kSplitKeys * vpr; i += kSplitThreads) {
      const int j = i / vpr, c = i % vpr;
      const int pos = c0 + j;
      const __nv_bfloat16* ks = k_pool;     // any valid address when unused
      const __nv_bfloat16* vs = v_pool;
      if (j < n) {
        if (CUR && pos >= sr.pool_end) {
          ks = k_cur + c * 8;
          vs = v_cur + c * 8;
        } else {
          const int page = table_row[pos / page_size];
          const long long off =
              ((long long)page * page_size + pos % page_size) * row_stride +
              (long long)h * D + c * 8;
          ks = k_pool + off;
          vs = v_pool + off;
        }
      }
      cp_async16(kd + j * LK + c * 8, ks, j < n);
      cp_async16(vd + j * LK + c * 8, vs, j < n);
    }
  };
  stage(0, k_lo, min(kSplitKeys, k_hi - k_lo));
  cp_async_commit();
#pragma unroll
  for (int u = 0; u < Plan::kQVecs; ++u) {
    const int i = tid + u * kSplitThreads;
    if (i < kSplitRows * vpr)
      *reinterpret_cast<uint4*>(q_s + (i / vpr) * LK + (i % vpr) * 8) =
          qv[u];
  }

  uint32_t qa[KT][4];
  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m_r[2] = {XLLM_NEG_INF, XLLM_NEG_INF};   // rows g, g + 8 (log2)
  float l_r[2] = {0.f, 0.f};                     // this thread's columns
  // ldmatrix row addresses: Q rows lane % 16 at column 8 (lane / 16); K
  // key 16w + 8 (lane / 16) + lane % 8 at column 8 ((lane / 8) % 2) (the
  // warp's two n8 tiles); V key lane at the warp's first column.
  const uint32_t qa_addr = smem_u32(q_s + (lane & 15) * LK + (lane >> 4) * 8);
  const uint32_t k_off =
      ((16 * warp + 8 * (lane >> 4) + (lane & 7)) * LK +
       ((lane >> 3) & 1) * 8) * 2;
  const uint32_t v_off = (lane * LK + warp * kCols) * 2;

  int it = 0;
  for (int c0 = k_lo; c0 < k_hi; c0 += kSplitKeys, ++it) {
    const int n = min(kSplitKeys, k_hi - c0);
    const int buf = it & 1;
    // 1. This step's rows have landed and every warp is done with the
    //    previous step; the next step's rows start loading.
    cp_async_wait_all();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) ldsm_x4(qa_addr + kk * 32, qa[kk]);
    }
    if (c0 + kSplitKeys < k_hi) {
      stage(buf ^ 1, c0 + kSplitKeys, min(kSplitKeys, k_hi - c0 - kSplitKeys));
      cp_async_commit();
    }
    // 2. S = Q K^T for keys [16w, 16w + 16) to shared memory.
    {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const uint32_t kb = smem_u32(kv_s(buf, 0)) + k_off;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t bk[4];
        ldsm_x4(kb + kk * 32, bk);
        mma_bf16(acc[0], qa[kk], bk[0], bk[1]);
        mma_bf16(acc[1], qa[kk], bk[2], bk[3]);
      }
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        const int col = 16 * warp + 8 * tt + 2 * t;
        *reinterpret_cast<float2*>(s_s + g * LS + col) =
            make_float2(acc[tt][0], acc[tt][1]);
        *reinterpret_cast<float2*>(s_s + (g + 8) * LS + col) =
            make_float2(acc[tt][2], acc[tt][3]);
      }
    }
    __syncthreads();
    // 3. Online softmax on rows g and g + 8: the scores this thread's P
    //    fragments hold (columns 16kk + 2t + {0, 1, 8, 9}), scaled,
    //    soft-capped, in log2 units; keys >= n masked.
    float sv[2][16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = 16 * kk + 2 * t + 8 * hh;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float2 v =
              *reinterpret_cast<const float2*>(s_s + (g + 8 * rr) * LS + j);
          sv[rr][4 * kk + 2 * hh] =
              j < n ? soft_cap(v.x * scale, cap) * kLog2e : -INFINITY;
          sv[rr][4 * kk + 2 * hh + 1] =
              j + 1 < n ? soft_cap(v.y * scale, cap) * kLog2e : -INFINITY;
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
    //    ldmatrix.trans, 32 keys per load.
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][0] *= corr[0];
      o[nt][1] *= corr[0];
      o[nt][2] *= corr[1];
      o[nt][3] *= corr[1];
    }
    const uint32_t vb = smem_u32(kv_s(buf, 1)) + v_off;
#pragma unroll
    for (int kp = 0; kp < 2; ++kp) {
      if (32 * kp >= n) break;
      uint32_t pa[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int kk = 2 * kp + hh;
        pa[hh][0] = pack_bf16(sv[0][4 * kk], sv[0][4 * kk + 1]);
        pa[hh][1] = pack_bf16(sv[1][4 * kk], sv[1][4 * kk + 1]);
        pa[hh][2] = pack_bf16(sv[0][4 * kk + 2], sv[0][4 * kk + 3]);
        pa[hh][3] = pack_bf16(sv[1][4 * kk + 2], sv[1][4 * kk + 3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bv[4];
        ldsm_x4_trans(vb + (32 * kp * LK + 8 * nt) * 2, bv);
        mma_bf16(o[nt], pa[0], bv[0], bv[1]);
        mma_bf16(o[nt], pa[1], bv[2], bv[3]);
      }
    }
  }

  // 5. Normalise (`finish`, the sinks joining the denominator) or write
  //    the split's state, rows < G.
  const int col0 = warp * kCols + 2 * t;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = g + 8 * rr;
    const float l = quad_sum(l_r[rr]);
    if (r >= G) continue;
    if (finish) {
      float f = 1.f, den = l;
      if (sinks != nullptr) {
        const float sk = sinks[h * G + r] * kLog2e;
        const float m2 = fmaxf(m_r[rr], sk);
        f = ex2(m_r[rr] - m2);
        den = l * f + ex2(sk - m2);
      }
      f /= fmaxf(den, 1e-30f);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<uint32_t*>(ob + r * D + col0 + 8 * nt) =
            pack_bf16(o[nt][2 * rr] * f, o[nt][2 * rr + 1] * f);
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(part_o + r * D + col0 + 8 * nt) =
            make_float2(o[nt][2 * rr], o[nt][2 * rr + 1]);
      if (warp == 0 && t == 0) {
        part_ml[r] = m_r[rr] / kLog2e;
        part_ml[G + r] = l;
      }
    }
  }
}

// The output rows of one (row, kv head) from its `live` split states
// (part_o [live][G][D], part_ml [live][2][G], written by attend_split),
// folded in split order, each element by one thread: the running state
// (M, l, O) takes split s as M' = max(M, m_s), O = O e^(M - M') + O_s
// e^(m_s - M'), l likewise; then the sinks join the denominator once
// (finish_row). A thread issues the loads of 4 splits before it folds
// them, so a fold of up to 4 splits is one round trip to memory.
__device__ __forceinline__ void combine_splits(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    const float* __restrict__ sinks, __nv_bfloat16* __restrict__ ob, int h,
    int G, int D, int live) {
  constexpr int kU = 4;
  for (int i = threadIdx.x; i < G * D; i += kSplitThreads) {
    const int g = i / D;
    float M = XLLM_NEG_INF, l = 0.f, o = 0.f;
    for (int s0 = 0; s0 < live; s0 += kU) {
      float ms[kU], ls[kU], os[kU];
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        const int s = s0 + k;
        const bool in = s < live;
        ms[k] = in ? __ldcg(part_ml + s * 2 * G + g) : XLLM_NEG_INF;
        ls[k] = in ? __ldcg(part_ml + (s * 2 + 1) * G + g) : 0.f;
        os[k] = in ? __ldcg(part_o + (long long)s * G * D + i) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        const float M2 = fmaxf(M, ms[k]);
        const float a = expf(M - M2), e = expf(ms[k] - M2);
        o = o * a + os[k] * e;
        l = l * a + ls[k] * e;
        M = M2;
      }
    }
    ob[i] = __float2bfloat16(finish_row(o, M, l, sinks, h * G + g));
  }
}

}  // namespace decode
