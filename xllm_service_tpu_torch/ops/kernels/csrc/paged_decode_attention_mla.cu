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
// (1) reads each latent row from device memory once and uses the staged
// copy for both Q K^T and P V (K3 reads K and V rows apart, twice the
// bytes for the same context), and (2) runs both products on the tensor
// cores: the (up to) 16 query heads are exactly one 16-row `wmma` tile, so
// S = Q K^T is 16 x 64 per chunk of 64 keys and O += P V is 16 x 576, with
// float32 accumulators; P is rounded to bf16 for P V, as the plain
// version rounds its probabilities. The chunks stream through two shared
// buffers with `cp.async`, so the next chunk's rows load while this one
// computes. The online softmax stays in float32; scores never reach device
// memory. One block serves one row (all heads), so a batch of B rows runs
// B blocks: splitting the heads or the context over more blocks is left
// for a later version.
//
// Layout: q and out [B, Hq, D] bf16 (Hq <= 16); the pool [P, ps, 1, D]
// bf16 (the caller passes latent_pages[layer]); page table [B, MP] int32;
// lens [B] int32 (context lengths, or cache lengths with CUR); latent_cur
// [B, 1, D] bf16 (CUR only).

#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kD = 576;                 // latent row: 512 + 64
constexpr int kKeys = 64;               // keys per chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;               // query heads: one wmma M tile
constexpr int kPad = 8;                 // bf16 padding per shared row
constexpr int kVpr = kD / 8;            // 16-byte vectors per row: 72
constexpr int kVecs = kKeys * kVpr / kThreads;   // per thread per chunk: 18
constexpr int LQ = kD + kPad;           // bf16 row stride: Q, latent
constexpr int LS = kKeys + 4;           // float row stride: S
constexpr int LP = kKeys + kPad;        // bf16 row stride: P
constexpr int LO = kD + 4;              // float row stride: O
static_assert(kKeys * kVpr % kThreads == 0, "chunk must split evenly");

__host__ __device__ constexpr size_t align128(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

constexpr size_t kQBytes = align128(kRows * LQ * 2);
constexpr size_t kLatBytes = align128(kKeys * LQ * 2);   // one buffer
constexpr size_t kSBytes = align128(2 * kRows * LS * 4);  // two k halves
constexpr size_t kPBytes = align128(kRows * LP * 2);
constexpr size_t kOBytes = align128(kRows * LO * 4);
constexpr size_t kSmem =
    kQBytes + 2 * kLatBytes + kSBytes + kPBytes + kOBytes + 3 * kRows * 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int src_bytes = valid ? 16 : 0;   // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

template <bool CUR>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_mla_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ pool,
    const int* __restrict__ page_table, const int* __restrict__ lens,
    const __nv_bfloat16* __restrict__ latent_cur,
    __nv_bfloat16* __restrict__ out, int Hq, int MP, int page_size,
    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = (__nv_bfloat16*)smem;                    // [16][LQ]
  __nv_bfloat16* lat_s[2] = {(__nv_bfloat16*)(smem + kQBytes),  // [64][LQ]
                             (__nv_bfloat16*)(smem + kQBytes + kLatBytes)};
  float* s_s = (float*)(smem + kQBytes + 2 * kLatBytes);        // [2][16][LS]
  __nv_bfloat16* p_s =
      (__nv_bfloat16*)(smem + kQBytes + 2 * kLatBytes + kSBytes);  // [16][LP]
  float* o_s =
      (float*)(smem + kQBytes + 2 * kLatBytes + kSBytes + kPBytes);  // [16][LO]
  float* m_s = o_s + kRows * LO;
  float* l_s = m_s + kRows;
  float* c_s = l_s + kRows;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* table_row = page_table + (long long)b * MP;
  const __nv_bfloat16* cur = CUR ? latent_cur + (long long)b * kD : nullptr;

  // Keys [0, ctx); with CUR the last of them, position pool_end, is the
  // current row.
  const int pool_end = min(lens[b], MP * page_size);
  const int ctx = CUR ? pool_end + 1 : pool_end;
  const int chunks = (ctx + kKeys - 1) / kKeys;
  if (chunks > 0) {
    stage_chunk<CUR>(lat_s[0], pool, table_row, cur, 0, min(kKeys, ctx),
                     pool_end, page_size);
    cp_async_commit();
  }

  // Q rows (heads >= Hq zero), O, the softmax state.
  for (int i = tid; i < kRows * kVpr; i += kThreads) {
    const int r = i / kVpr, c = i % kVpr;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < Hq)
      v = *reinterpret_cast<const uint4*>(q + ((long long)b * Hq + r) * kD +
                                          c * 8);
    *reinterpret_cast<uint4*>(q_s + r * LQ + c * 8) = v;
  }
  for (int i = tid; i < kRows * LO; i += kThreads) o_s[i] = 0.f;
  if (tid < kRows) {
    m_s[tid] = XLLM_NEG_INF;
    l_s[tid] = 0.f;
  }

  for (int ci = 0; ci < chunks; ++ci) {
    const int c0 = ci * kKeys;
    const int n = min(kKeys, ctx - c0);
    // 1. The next chunk's rows start loading into the other buffer (it
    //    was last read in chunk ci - 1, before that chunk's final
    //    barrier); this chunk's rows must have landed.
    if (ci + 1 < chunks) {
      const int c1 = c0 + kKeys;
      stage_chunk<CUR>(lat_s[(ci + 1) & 1], pool, table_row, cur, c1,
                       min(kKeys, ctx - c1), pool_end, page_size);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* lat = lat_s[ci & 1];
    // 2. S = Q K^T: 4 key tiles x 2 halves of the 576 columns, one
    //    (tile, half) per warp; tiles past n are skipped (never read).
    {
      const int tn = warp & 3, kh = warp >> 2;
      if (tn * 16 < n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
        wmma::fill_fragment(sf, 0.f);
#pragma unroll 6
        for (int k0 = kh * (kD / 2); k0 < (kh + 1) * (kD / 2); k0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> af;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> bf;
          wmma::load_matrix_sync(af, q_s + k0, LQ);
          wmma::load_matrix_sync(bf, lat + tn * 16 * LQ + k0, LQ);
          wmma::mma_sync(sf, af, bf, sf);
        }
        wmma::store_matrix_sync(s_s + kh * kRows * LS + tn * 16, sf, LS,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();
    // 3. Online softmax in float32: one warp per head, two keys per lane;
    //    P as bf16 for the second product (zero past n).
    for (int r = warp; r < kRows; r += kWarps) {
      float s[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int j = lane + 32 * h2;
        s[h2] = j < n ? (s_s[r * LS + j] + s_s[(kRows + r) * LS + j]) * scale
                      : XLLM_NEG_INF;
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s[0], s[1])));
      float sum = 0.f;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int j = lane + 32 * h2;
        const float p = j < n ? expf(s[h2] - m_new) : 0.f;
        p_s[r * LP + j] = __float2bfloat16(p);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // 4. Rescale O by this chunk's correction.
    for (int i = tid; i < kRows * kD; i += kThreads) {
      const int r = i / kD, e = i % kD;
      o_s[r * LO + e] *= c_s[r];
    }
    __syncthreads();
    // 5. O += P V, V being the same staged latent rows: 36 column tiles
    //    over the warps; key steps past n are skipped.
    for (int tn = warp; tn < kD / 16; tn += kWarps) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      float* o_tile = o_s + tn * 16;
      wmma::load_matrix_sync(of, o_tile, LO, wmma::mem_row_major);
#pragma unroll
      for (int k0 = 0; k0 < kKeys; k0 += 16) {
        if (k0 < n) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> pf;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> vf;
          wmma::load_matrix_sync(pf, p_s + k0, LP);
          wmma::load_matrix_sync(vf, lat + k0 * LQ + tn * 16, LQ);
          wmma::mma_sync(of, pf, vf, of);
        }
      }
      wmma::store_matrix_sync(o_tile, of, LO, wmma::mem_row_major);
    }
    __syncthreads();
  }
  __syncthreads();

  // 6. Normalise; a row without keys (context 0) has O = 0 and l = 0 and
  //    writes zeros.
  for (int i = tid; i < Hq * kD; i += kThreads) {
    const int r = i / kD, e = i % kD;
    out[((long long)b * Hq + r) * kD + e] = __float2bfloat16(
        finish_row(o_s[r * LO + e], m_s[r], l_s[r], nullptr, r));
  }
}

template <bool CUR>
int launch(const void* q, const void* pool, const int* page_table,
           const int* lens, const void* latent_cur, void* out, int B, int Hq,
           int D, int MP, int page_size, float scale, void* stream) {
  if (D != kD || Hq < 1 || Hq > kRows) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  static size_t granted = 0;
  const int err =
      allow_smem(paged_decode_attention_mla_kernel<CUR>, kSmem, &granted);
  if (err) return err;
  paged_decode_attention_mla_kernel<CUR>
      <<<B, kThreads, kSmem, (cudaStream_t)stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)pool, page_table,
          lens, (const __nv_bfloat16*)latent_cur, (__nv_bfloat16*)out, Hq, MP,
          page_size, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a CUDA error code (0 = launched). D must be 576 and Hq in
// [1, 16]; the wrapper checks both.
extern "C" int paged_decode_attention_mla(const void* q, const void* pool,
                                          const int* page_table,
                                          const int* context_lens, void* out,
                                          int B, int Hq, int D, int MP,
                                          int page_size, float scale,
                                          void* stream) {
  return launch<false>(q, pool, page_table, context_lens, nullptr, out, B, Hq,
                       D, MP, page_size, scale, stream);
}

// The attend-then-write form: cache_lens exclude the current token, whose
// latent row is latent_cur [B, 1, D]. Same return and limits.
extern "C" int paged_decode_attention_mla_current(
    const void* q, const void* pool, const int* page_table,
    const int* cache_lens, const void* latent_cur, void* out, int B, int Hq,
    int D, int MP, int page_size, float scale, void* stream) {
  return launch<true>(q, pool, page_table, cache_lens, latent_cur, out, B, Hq,
                      D, MP, page_size, scale, stream);
}
