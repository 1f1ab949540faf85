// Causal GQA prefill attention over one layer of the paged KV pool.
//
// Replaces the Pallas kernel paged_prefill_attention_pallas of
// xllm_service_tpu/ops/pallas/prefill_attention.py in its
// write-then-attend form (from_pool=True, body _kernel_layered_pool):
// the window's K/V was written into the pool first, so every key,
// cached prefix and window alike, is read through the page table.
//
// What bounds it on an H100: bytes at the serving shapes this slice
// runs (windows of a few hundred tokens; see chip_smoke.py's bound).
// Each key row is read once per query tile, and a tile's work is
// (QB x G) x D x 4 flops per key. The design keeps a tile of QB query
// positions x G heads (64 rows) of one kv head in shared memory as bf16,
// streams the tile's keys in chunks of 32 through shared memory once,
// and runs the two products on the tensor cores with warp-level `wmma`
// 16x16x16 bf16 tiles and float32 accumulators: S = Q K^T for the chunk,
// then O += P V. The online softmax (max, exp, sum, rescale of O) stays
// in float32; P is rounded to bf16 for P V, as the plain version does.
// Scores never reach device memory. Key chunks outside
// [max(0, q_lo - W + 1), q_hi] (causal limit and sliding window of the
// tile) are never read. On the CUDA cores the products would issue about
// one shared-memory load per FMA; the tensor cores take a 16x16x16 tile
// per instruction. `wgmma`/TMA pipelining is later work.
//
// Semantics (those of the Pallas kernel): query t of row b sits at
// position q_start[b] + t and attends to keys k with
// k <= q_start[b] + t, k < q_start[b] + lengths[b] and, with W > 0,
// k > q_start[b] + t - W; scale, soft-cap and sinks as in the decode
// kernel. Query rows t >= lengths[b] (and rows of length 0) output
// zeros.
//
// Layout: q and out [B, T, Hq, D] bf16; pools [P, ps, Hkv, D] bf16 (the
// caller passes k_pages[layer]); page table [B, MP] int32; q_start and
// lengths [B] int32; sinks [Hq] float32 or null.

#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

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

template <int D>
__global__ void __launch_bounds__(kThreads) paged_prefill_attention_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool,
    const int* __restrict__ page_table, const int* __restrict__ q_start,
    const int* __restrict__ lengths, const float* __restrict__ sinks,
    __nv_bfloat16* __restrict__ out, int T, int Hkv, int G, int MP,
    int page_size, int QB, int window, float scale, float cap) {
  using PL = Plan<D>;
  constexpr int LQ = PL::LQ, LS = PL::LS, LP = PL::LP, LO = PL::LO;
  constexpr int vpr = D / 8;                   // 16-byte vectors per row
  extern __shared__ __align__(128) unsigned char smem[];
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
  const int nqt = (T + QB - 1) / QB;
  const int qt = blockIdx.x % nqt;
  const int h = (blockIdx.x / nqt) % Hkv;
  const int b = blockIdx.x / (nqt * Hkv);
  const int Hq = Hkv * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row_stride = (long long)Hkv * D;

  const int t0 = qt * QB;
  const int nt = max(0, min(QB, lengths[b] - t0));   // valid tile rows
  const int q_lo = q_start[b] + t0;

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
    const int q_hi = q_lo + nt - 1;
    const int kv_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
    const int kv_hi = min(q_hi, MP * page_size - 1);   // inclusive
    for (int c0 = kv_lo; c0 <= kv_hi; c0 += kKeys) {
      const int n = min(kKeys, kv_hi - c0 + 1);
      // 1. Stage the chunk's K and V head rows (bf16, 16-byte copies);
      //    rows past n are zero so they add nothing to P V.
      for (int i = tid; i < kKeys * vpr; i += kThreads) {
        const int j = i / vpr, c = i % vpr;
        uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (j < n) {
          const int pos = c0 + j;
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

template <int D>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* page_table, const int* q_start, const int* lengths,
           const float* sinks, void* out, int B, int T, int Hkv, int G,
           int MP, int page_size, int QB, int window, float scale, float cap,
           cudaStream_t stream) {
  const size_t smem = Plan<D>::kTotal;
  static size_t granted = 0;
  const int err =
      allow_smem(paged_prefill_attention_kernel<D>, smem, &granted);
  if (err) return err;
  const int nqt = (T + QB - 1) / QB;
  paged_prefill_attention_kernel<D><<<B * Hkv * nqt, kThreads, smem,
                                      stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
      (const __nv_bfloat16*)v_pool, page_table, q_start, lengths, sinks,
      (__nv_bfloat16*)out, T, Hkv, G, MP, page_size, QB, window, scale, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a CUDA error code (0 = launched). D must be 64, 128 or 256; the
// wrapper checks it, G <= 64, and picks QB = max(1, 64 / G) query
// positions per tile.
extern "C" int paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* page_table, const int* q_start, const int* lengths,
    const float* sinks, void* out, int B, int T, int Hkv, int G, int D,
    int MP, int page_size, int QB, int window, float scale, float cap,
    void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return launch<64>(q, k_pool, v_pool, page_table, q_start, lengths,
                        sinks, out, B, T, Hkv, G, MP, page_size, QB, window,
                        scale, cap, st);
    case 128:
      return launch<128>(q, k_pool, v_pool, page_table, q_start, lengths,
                         sinks, out, B, T, Hkv, G, MP, page_size, QB, window,
                         scale, cap, st);
    case 256:
      return launch<256>(q, k_pool, v_pool, page_table, q_start, lengths,
                         sinks, out, B, T, Hkv, G, MP, page_size, QB, window,
                         scale, cap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
