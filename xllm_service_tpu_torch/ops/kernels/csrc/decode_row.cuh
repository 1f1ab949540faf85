// Single-query GQA attention of one (row, kv head) over one layer of the
// paged KV pool, split over its keys (split-KV): the device code shared by
// the decode kernels (paged_decode_attention.cu, both orderings) and the
// ragged kernel's decode rows (ragged_paged_attention.cu).
//
// It is bound by bytes: a row reads its context's K and V once
// (2 x ctx x Hkv x D x 2 bytes) for 4 x G flops per byte, far below the
// ~295 flops per byte where the tensor cores would become the limit. With
// one block per (row, kv head) a batch of 8 llama3-1b rows is 64 blocks on
// 132 SMs, each walking its keys one chunk after another, so the time is
// the chain of dependent steps, not the bytes. So each row's attended
// range is split over S blocks (or thread groups), and the splits' softmax
// states fold at the end.
//
// split_range gives split s of S: an equal share, in whole kChunk-key
// units, of the attended range [lo, ctx) (so a sliding window cuts across
// splits, and with CUR the current key falls in the last non-empty
// split). Only the first `live` splits hold keys. attend_split walks its
// share in 64-key steps on the tensor cores: the G query heads of the kv
// head padded to one 16-row `mma.sync` m16n8k16 tile, Q's fragments in
// registers for the whole walk, K and V staged by `cp.async` into two
// buffers (the next step's rows load while this one computes), S = Q K^T
// by 4 warps of 16 keys each through shared memory, the online softmax on
// every warp's copy of the rows (log2 units, P rounded to bf16 as the
// plain version rounds it), and O += P V with O in registers, each warp
// owning D / 4 columns. Two barriers a step. A row held by one live split
// (or none: context 0) is finished by that split. Otherwise each live
// split writes its unnormalised float32 O [G][D] and its softmax state
// (m, l) instead of the output, and combine_splits folds the live states
// in split order and only then lets the sinks join the denominator, once.
// Soft-cap applies per logit inside the split.
//
// A split runs on one group of kSplitThreads (128) threads: the whole
// block of the decode kernels, or either half of the ragged kernel's
// 256-thread block, which runs two splits side by side. `gtid` is the
// thread's index in its group and `bar` the group's barrier: 0 is the
// block's own (__syncthreads), 1 and up a named barrier of the group's
// 128 threads.
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
// this ordering, or already holds the current row where the last
// layer's writer wrote every layer first). The current key is always
// valid, so a row with cache_len 0 attends to it alone and is not zeros.
//
// Layout: the caller passes the row's G query head rows (qb, [G][D] bf16)
// and output rows (ob), its page-table row, the pools [P, ps, Hkv, D] bf16
// of one layer and, with CUR, the current token's K and V head rows
// ([D] bf16 each).
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_sync.cuh"

namespace decode {

constexpr int kChunk = 128;   // keys of a split's unit

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

// The barrier of a thread group (see above): 0 the block's, else named
// barrier `bar` over kSplitThreads threads.
__device__ __forceinline__ void group_sync(int bar) {
  if (bar == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(kSplitThreads)
                 : "memory");
}

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
// `gtid`: the thread's index in its group.
template <int D>
__device__ __forceinline__ void load_q(const __nv_bfloat16* __restrict__ qb,
                                       int G,
                                       uint4 (&qv)[SplitPlan<D>::kQVecs],
                                       int gtid) {
#pragma unroll
  for (int u = 0; u < SplitPlan<D>::kQVecs; ++u) {
    const int i = gtid + u * kSplitThreads;
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
// natural units). `smem` holds SplitPlan<D>::kTotal bytes; `gtid` and
// `bar` name the thread group (see the top of this file).
template <int D, bool CUR>
__device__ __forceinline__ void attend_split(
    unsigned char* smem, const uint4 (&qv)[SplitPlan<D>::kQVecs],
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool,
    const int* __restrict__ table_row, const float* __restrict__ sinks,
    __nv_bfloat16* __restrict__ ob, float* __restrict__ part_o,
    float* __restrict__ part_ml, const SplitRange& sr, bool finish, int h,
    int Hkv, int G, int page_size, float scale, float cap,
    const __nv_bfloat16* __restrict__ k_cur,
    const __nv_bfloat16* __restrict__ v_cur, int gtid, int bar) {
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
  const int tid = gtid;
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
    group_sync(bar);
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
    group_sync(bar);
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
// them, so a fold of up to 4 splits is one round trip to memory. `gtid`:
// the thread's index in its group.
__device__ __forceinline__ void combine_splits(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    const float* __restrict__ sinks, __nv_bfloat16* __restrict__ ob, int h,
    int G, int D, int live, int gtid) {
  constexpr int kU = 4;
  for (int i = gtid; i < G * D; i += kSplitThreads) {
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
