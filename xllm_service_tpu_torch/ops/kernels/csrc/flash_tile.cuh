// One query tile of causal GQA flash attention over one layer of the
// paged KV pool: the device code shared by the prefill kernel
// (paged_prefill_attention.cu) and the ragged kernel
// (ragged_paged_attention.cu). Each kernel maps its blocks to tiles and
// picks the tile's key range; this header does the tile's work.
//
// A tile is QB query positions x the G heads of one kv head (64 rows),
// kept in shared memory as bf16. The tile's keys stream through shared
// memory in chunks of 32, once, and both products run on the tensor
// cores with warp-level `wmma` 16x16x16 bf16 tiles and float32
// accumulators: S = Q K^T for the chunk, then O += P V. The online
// softmax (max, exp, sum, rescale of O) stays in float32; P is rounded to
// bf16 for P V, as the plain versions do. Scores never reach device
// memory.
//
// Semantics (those of the Pallas kernels): query t of row b sits at
// position q_start[b] + t and attends to keys k with k <= its position,
// k < q_start[b] + lengths[b] and, with W > 0, k > its position - W;
// scale, soft-cap and sinks as in the decode kernel. Query rows
// t >= lengths[b] output zeros.
//
// With FRESH (the Pallas kernel's two-source form, attend-then-write
// prefill) the window's own K/V is not in the pool yet: it comes as the
// operands k_fresh/v_fresh, key t of row b at position q_start[b] + t.
// The key range and the masks stay the same; only the staging step picks
// where a key's bytes come from: a key at position >= fresh_start (the
// row's q_start) from the fresh operand, one below it through the page
// table. The window's pool slots (stale in this ordering) are never
// read, nor are pool positions past the table.
//
// Layout: q and out [B, T, Hq, D] bf16; pools [P, ps, Hkv, D] bf16 (the
// caller passes k_pages[layer]); page table [B, MP] int32; sinks [Hq]
// float32 or null; with FRESH, k_fresh/v_fresh [B, T, Hkv, D] bf16.
#pragma once

#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace flash {

using namespace nvcuda;

constexpr int kKeys = 32;      // keys per step
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;      // tile rows (position, head)
constexpr int kPad = 8;        // bf16 padding per shared row (16 bytes)

__host__ __device__ constexpr size_t align128(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

// Shared-memory plan of one block (bytes, each part 128-byte aligned).
template <int D>
struct Plan {
  static constexpr int LQ = D + kPad;        // bf16 row stride: Q, K, V
  static constexpr int LS = kKeys + 4;       // float row stride: S
  static constexpr int LP = kKeys + kPad;    // bf16 row stride: P
  static constexpr int LO = D + 4;           // float row stride: O
  static constexpr size_t kQ = align128(kRows * LQ * 2);
  static constexpr size_t kK = align128(kKeys * LQ * 2);
  static constexpr size_t kS = align128(kRows * LS * 4);
  static constexpr size_t kP = align128(kRows * LP * 2);
  static constexpr size_t kO = align128(kRows * LO * 4);
  static constexpr size_t kTotal = kQ + 2 * kK + kS + kP + kO + 3 * kRows * 4;
};

__device__ __forceinline__ bool key_ok(int j, int n, int tl, int nt,
                                       int kpos, int qpos, int window) {
  return j < n && tl < nt && kpos <= qpos &&
         (window <= 0 || kpos > qpos - window);
}

// The tile of row b, kv head h, whose first query is t0 (position q_lo);
// its first nt query positions are valid (nt may be 0). Keys
// [kv_lo, kv_hi] (inclusive, clamped by the caller to the causal limit,
// the window and, unless FRESH, the table) are read; the mask drops the
// rest.
template <int D, bool FRESH = false>
__device__ __forceinline__ void attend_tile(
    unsigned char* smem, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool,
    const int* __restrict__ page_table, const float* __restrict__ sinks,
    __nv_bfloat16* __restrict__ out, int b, int h, int t0, int nt, int q_lo,
    int kv_lo, int kv_hi, int T, int Hkv, int G, int MP, int page_size,
    int QB, int window, float scale, float cap,
    const __nv_bfloat16* __restrict__ k_fresh = nullptr,
    const __nv_bfloat16* __restrict__ v_fresh = nullptr,
    int fresh_start = 0) {
  using PL = Plan<D>;
  constexpr int LQ = PL::LQ, LS = PL::LS, LP = PL::LP, LO = PL::LO;
  constexpr int vpr = D / 8;                   // 16-byte vectors per row
  __nv_bfloat16* q_s = (__nv_bfloat16*)smem;                  // [64][LQ]
  __nv_bfloat16* k_s = (__nv_bfloat16*)(smem + PL::kQ);       // [32][LQ]
  __nv_bfloat16* v_s = (__nv_bfloat16*)(smem + PL::kQ + PL::kK);
  float* s_s = (float*)(smem + PL::kQ + 2 * PL::kK);          // [64][LS]
  __nv_bfloat16* p_s =
      (__nv_bfloat16*)(smem + PL::kQ + 2 * PL::kK + PL::kS);  // [64][LP]
  float* o_s = (float*)(smem + PL::kQ + 2 * PL::kK + PL::kS + PL::kP);
  float* m_s = o_s + kRows * LO;                              // [64]
  float* l_s = m_s + kRows;                                   // [64]
  float* c_s = l_s + kRows;                                   // [64]

  const int R = QB * G;                        // tile rows, <= kRows
  const int Hq = Hkv * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row_stride = (long long)Hkv * D;

  // Q tile rows (position tl, head g) as bf16; padding rows zero.
  for (int i = tid; i < kRows * vpr; i += kThreads) {
    const int r = i / vpr, c = i % vpr;
    const int tl = r / G, g = r % G;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < R && tl < nt)
      v = *reinterpret_cast<const uint4*>(
          q + (((long long)b * T + t0 + tl) * Hq + h * G + g) * D + c * 8);
    *reinterpret_cast<uint4*>(q_s + r * LQ + c * 8) = v;
  }
  for (int i = tid; i < kRows * LO; i += kThreads) o_s[i] = 0.f;
  for (int r = tid; r < kRows; r += kThreads) {
    m_s[r] = XLLM_NEG_INF;
    l_s[r] = 0.f;
  }
  __syncthreads();

  if (nt > 0) {
    for (int c0 = kv_lo; c0 <= kv_hi; c0 += kKeys) {
      const int n = min(kKeys, kv_hi - c0 + 1);
      // 1. Stage the chunk's K and V head rows (bf16, 16-byte copies);
      //    rows past n are zero so they add nothing to P V.
      for (int i = tid; i < kKeys * vpr; i += kThreads) {
        const int j = i / vpr, c = i % vpr;
        uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        const int pos = c0 + j;
        if (FRESH && j < n && pos >= fresh_start) {
          const long long off =
              ((long long)b * T + (pos - fresh_start)) * row_stride +
              (long long)h * D + c * 8;
          kk = *reinterpret_cast<const uint4*>(k_fresh + off);
          vv = *reinterpret_cast<const uint4*>(v_fresh + off);
        } else if (j < n && (!FRESH || pos < MP * page_size)) {
          const int page = page_table[(long long)b * MP + pos / page_size];
          const long long off =
              ((long long)page * page_size + pos % page_size) * row_stride +
              (long long)h * D + c * 8;
          kk = *reinterpret_cast<const uint4*>(k_pool + off);
          vv = *reinterpret_cast<const uint4*>(v_pool + off);
        }
        *reinterpret_cast<uint4*>(k_s + j * LQ + c * 8) = kk;
        *reinterpret_cast<uint4*>(v_s + j * LQ + c * 8) = vv;
      }
      __syncthreads();
      // 2. S = Q K^T: 4 x 2 tiles of 16 x 16, one per warp.
      {
        const int tm = warp >> 1, tn = warp & 1;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
        wmma::fill_fragment(sf, 0.f);
#pragma unroll
        for (int k0 = 0; k0 < D; k0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> af;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> bf;
          wmma::load_matrix_sync(af, q_s + tm * 16 * LQ + k0, LQ);
          wmma::load_matrix_sync(bf, k_s + tn * 16 * LQ + k0, LQ);
          wmma::mma_sync(sf, af, bf, sf);
        }
        wmma::store_matrix_sync(s_s + tm * 16 * LS + tn * 16, sf, LS,
                                wmma::mem_row_major);
      }
      __syncthreads();
      // 3. Online softmax in float32: one warp per tile row, one key per
      //    lane; P is stored as bf16 for the second product.
      for (int r = warp; r < kRows; r += kWarps) {
        const int tl = r / G;
        const bool ok = r < R &&
            key_ok(lane, n, tl, nt, c0 + lane, q_lo + tl, window);
        const float s =
            ok ? soft_cap(s_s[r * LS + lane] * scale, cap) : XLLM_NEG_INF;
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        p_s[r * LP + lane] = __float2bfloat16(p);
        const float sum = warp_sum(p);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          c_s[r] = corr;
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();
      // 4. Rescale O by this chunk's correction.
      for (int i = tid; i < kRows * D; i += kThreads) {
        const int r = i / D, e = i % D;
        o_s[r * LO + e] *= c_s[r];
      }
      __syncthreads();
      // 5. O += P V: 4 x (D / 16) tiles of 16 x 16 over the warps.
      for (int tile = warp; tile < 4 * (D / 16); tile += kWarps) {
        const int tm = tile / (D / 16), tn = tile % (D / 16);
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
        float* o_tile = o_s + tm * 16 * LO + tn * 16;
        wmma::load_matrix_sync(of, o_tile, LO, wmma::mem_row_major);
#pragma unroll
        for (int k0 = 0; k0 < kKeys; k0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> pf;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> vf;
          wmma::load_matrix_sync(pf, p_s + tm * 16 * LP + k0, LP);
          wmma::load_matrix_sync(vf, v_s + k0 * LQ + tn * 16, LQ);
          wmma::mma_sync(of, pf, vf, of);
        }
        wmma::store_matrix_sync(o_tile, of, LO, wmma::mem_row_major);
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, e = i % D;
    if (r >= R) continue;
    const int tl = r / G, g = r % G;
    if (t0 + tl >= T) continue;
    const float v = tl < nt ? finish_row(o_s[r * LO + e], m_s[r], l_s[r],
                                         sinks, h * G + g)
                            : 0.f;
    out[(((long long)b * T + t0 + tl) * Hq + h * G + g) * D + e] =
        __float2bfloat16(v);
  }
}

}  // namespace flash
