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
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace decode {

constexpr int kChunk = 128;   // keys per online-softmax step
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

}  // namespace decode
