// In-place paged KV writers: one layer (a decode row or a prefill window)
// or all layers at once.
//
// Replaces the Pallas kernels of xllm_service_tpu/ops/pallas/kv_update.py:
// - paged_kv_update_layer (body _kernel_layer) and
//   paged_prefill_kv_update_layer (body _prefill_kernel_layer), the
//   write-then-attend layer body's writers: entry kv_write;
// - paged_kv_update (body _kernel) and paged_prefill_kv_update (body
//   _prefill_kernel), the attend-then-write path's writers, which run
//   once after the layer loop with every layer's fresh rows: entry
//   kv_write_all_layers. A grid dimension runs over the layers, so one
//   call is one launch.
// A decode row is a window of length 1 whose length is its `active`
// flag, so one kernel serves all four.
//
// What bounds it on an H100: bytes. Each written token row reads its
// fresh K and V rows once and writes them once into the pool
// (2 x 2 x Hkv x D x 2 bytes per layer for bf16); there is no
// arithmetic. The TPU kernels read-modify-wrote 8-slot tiles (or whole
// pages, for a window) because their DMA unit moves tiles, which is also
// why they needed page-aligned window starts and T % page_size == 0;
// here every token row is a scatter of 16-byte vectors, neighbouring
// threads on neighbouring addresses, so the pool is touched only where
// it changes, any start and any T are accepted, and the copy runs at the
// memory rate. At a decode step the all-layer form moves well under a
// megabyte, so what it saves is launches: one instead of one per layer.
//
// Drop rules are those of _flat_kv_index (xllm_service_tpu/ops/
// attention.py:58): tokens past the row's length, positions past the
// page table, the NULL page 0 (and any page id outside the pool) write
// nothing. Any row of 16-byte multiples works, the MLA latent row
// (Hkv = 1, D = 576, 1,152 bytes in bf16) included.
//
// Layout: pools [L, P, ps, Hkv, D] (kv_write is given one layer's view
// k_pages[layer], i.e. L = 1); fresh rows [L, B, T, Hkv, D]; page table
// [B, MP] int32.
//
// The layer body's writers fused with their neighbours (rope_kv_write,
// latent_kv_write, at the end of this file) are what the serving path
// runs in place of kv_write; kv_write stays as their unfused yardstick.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// The pool slot (page * page_size + position % page_size) that token t
// of row b is written to, or -1 where _flat_kv_index drops it: past the
// row's length (its `active` flag for a decode row), a position past the
// page table, the NULL page 0 or a page id outside the pool.
__device__ __forceinline__ long long kv_slot(
    int b, int t, const int* __restrict__ page_table,
    const int* __restrict__ start_pos, const int* __restrict__ lengths,
    const unsigned char* __restrict__ active, int MP, int page_size,
    int num_pages) {
  const int len = active != nullptr ? (active[b] ? 1 : 0) : lengths[b];
  if (t >= len) return -1;
  const long long pos = (long long)start_pos[b] + t;
  if (pos < 0) return -1;
  const long long pidx = pos / page_size;
  if (pidx >= MP) return -1;
  const int page = page_table[(long long)b * MP + pidx];
  if (page <= 0 || page >= num_pages) return -1;
  return (long long)page * page_size + pos % page_size;
}

// Grid (ceil(T / blockDim.y), B, L): block (x, y) copies token
// t = blockIdx.x * blockDim.y + threadIdx.y of row blockIdx.y in layer
// blockIdx.z, threadIdx.x striding over the row's 16-byte vectors.
// Strides are in vectors.
__global__ void kv_write_kernel(uint4* __restrict__ k_pool,
                                uint4* __restrict__ v_pool,
                                const uint4* __restrict__ k_new,
                                const uint4* __restrict__ v_new,
                                const int* __restrict__ page_table,
                                const int* __restrict__ start_pos,
                                const int* __restrict__ lengths,
                                const unsigned char* __restrict__ active,
                                int T, int MP, int page_size, int num_pages,
                                int row_vecs, long long pool_layer_vecs,
                                long long new_layer_vecs) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * blockDim.y + threadIdx.y;
  if (t >= T) return;
  const long long slot = kv_slot(b, t, page_table, start_pos, lengths,
                                 active, MP, page_size, num_pages);
  if (slot < 0) return;
  const long long dst = blockIdx.z * pool_layer_vecs + slot * row_vecs;
  const long long src = blockIdx.z * new_layer_vecs +
      ((long long)b * T + t) * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) {
    k_pool[dst + i] = k_new[src + i];
    v_pool[dst + i] = v_new[src + i];
  }
}

static int launch(void* k_pool, void* v_pool, const void* k_new,
                  const void* v_new, const int* page_table,
                  const int* start_pos, const int* lengths,
                  const unsigned char* active, int L, int B, int T, int MP,
                  int page_size, int num_pages, int row_bytes,
                  cudaStream_t stream) {
  if (L <= 0 || B <= 0 || T <= 0) return 0;
  const int row_vecs = row_bytes / 16;
  const int bx = row_vecs < 128 ? row_vecs : 128;
  int by = 256 / bx;
  if (by < 1) by = 1;
  if (by > T) by = T;
  const dim3 block(bx, by);
  const dim3 grid((T + by - 1) / by, B, L);
  kv_write_kernel<<<grid, block, 0, stream>>>(
      (uint4*)k_pool, (uint4*)v_pool, (const uint4*)k_new,
      (const uint4*)v_new, page_table, start_pos, lengths, active, T, MP,
      page_size, num_pages, row_vecs,
      (long long)num_pages * page_size * row_vecs,
      (long long)B * T * row_vecs);
  return (int)cudaGetLastError();
}

// One layer. Returns cudaGetLastError() after the launch (0 = launched).
// `active` is null for a prefill window and non-null (bool [B]) for a
// decode row. `row_bytes` = Hkv * D * element size, a multiple of 16.
extern "C" int kv_write(void* k_pool, void* v_pool, const void* k_new,
                        const void* v_new, const int* page_table,
                        const int* start_pos, const int* lengths,
                        const unsigned char* active, int B, int T, int MP,
                        int page_size, int num_pages, int row_bytes,
                        void* stream) {
  return launch(k_pool, v_pool, k_new, v_new, page_table, start_pos,
                lengths, active, 1, B, T, MP, page_size, num_pages,
                row_bytes, (cudaStream_t)stream);
}

// All L layers of the pools in one launch; arguments as for kv_write,
// with the full pools and fresh rows [L, B, T, Hkv, D] (T = 1 and
// `active` non-null for a decode step).
extern "C" int kv_write_all_layers(void* k_pool, void* v_pool,
                                   const void* k_new, const void* v_new,
                                   const int* page_table,
                                   const int* start_pos, const int* lengths,
                                   const unsigned char* active, int L, int B,
                                   int T, int MP, int page_size,
                                   int num_pages, int row_bytes,
                                   void* stream) {
  return launch(k_pool, v_pool, k_new, v_new, page_table, start_pos,
                lengths, active, L, B, T, MP, page_size, num_pages,
                row_bytes, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// rope_kv_write: K1 and K2 redesigned, fused with the rotary embedding.
//
// In the layer body the writer follows the rope of q and k. Unfused,
// that is rotate(q), rotate(k) (ops/rope.py: ~10 PyTorch kernels each,
// two float copies of the halves, four multiplies, a subtract, an add, a
// cat and a cast) and then kv_write: ~21 launches a layer, and a decode
// step's writer alone is a launch floor (~2 us over a ~10 ns bytes
// bound). This kernel does all of it in one launch: it rotates q
// [B, T, Hq, D] and k [B, T, Hkv, D] (bf16) in place for every token,
// padding and inactive rows included, as the plain rotate does, and
// writes the rotated k and v [B, T, Hkv, D] to the slot of each token
// that kv_slot keeps. Without pools (k_pool null) it only rotates: the
// attend-then-write layer body, whose writer runs after the layer loop.
//
// Exactness: element j pairs with j + D/2 and
//   out_j       = x_j * cos_j - x_{j+D/2} * sin_j
//   out_{j+D/2} = x_{j+D/2} * cos_j + x_j * sin_j
// in float32, each product and sum rounded on its own (__fmul_rn,
// __fsub_rn, __fadd_rn: no FMA contraction), then rounded to bf16 to
// nearest even: bit-identical to the plain version's separate PyTorch
// kernels. cos/sin [B, T, D/2] float32 are the forward's one table
// (ops/rope.py rope_cos_sin), so llama3, linear and yarn scaling stay in
// Python and reach the kernel as the same bits.
//
// Bound on an H100: bytes (q and k read and written once; v, cos and sin
// read once; the kept tokens' k and v rows written once to the pool); at
// a decode step, the launch. Layout: one thread per pair of 16-byte
// vectors of a q or k head (8 elements of the first half and the 8 they
// pair with) with cos/sin as two float4s each, then one thread per
// 16-byte vector of v. threadIdx.x goes over those items of one token,
// threadIdx.y and the grid over tokens (B * T); every thread issues all
// its loads before its stores. It allocates nothing and never syncs with
// the host, so it can be captured in a CUDA graph as it is.

__device__ __forceinline__ void rotate8(const uint4& lo, const uint4& hi,
                                        const float4& c0, const float4& c1,
                                        const float4& s0, const float4& s1,
                                        uint4& out_lo, uint4& out_hi) {
  const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&lo);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&hi);
  __nv_bfloat162* oa = reinterpret_cast<__nv_bfloat162*>(&out_lo);
  __nv_bfloat162* ob = reinterpret_cast<__nv_bfloat162*>(&out_hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x1 = __bfloat1622float2(a[i]);
    const float2 x2 = __bfloat1622float2(b[i]);
    const float ca = c[2 * i], cb = c[2 * i + 1];
    const float sa = s[2 * i], sb = s[2 * i + 1];
    oa[i] = __floats2bfloat162_rn(
        __fsub_rn(__fmul_rn(x1.x, ca), __fmul_rn(x2.x, sa)),
        __fsub_rn(__fmul_rn(x1.y, cb), __fmul_rn(x2.y, sb)));
    ob[i] = __floats2bfloat162_rn(
        __fadd_rn(__fmul_rn(x2.x, ca), __fmul_rn(x1.x, sa)),
        __fadd_rn(__fmul_rn(x2.y, cb), __fmul_rn(x1.y, sb)));
  }
}

__global__ void rope_kv_write_kernel(
    uint4* __restrict__ q, uint4* __restrict__ k,
    const uint4* __restrict__ v, const float4* __restrict__ cos_tab,
    const float4* __restrict__ sin_tab, uint4* __restrict__ k_pool,
    uint4* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ start_pos, const int* __restrict__ lengths,
    const unsigned char* __restrict__ active, int num_tokens, int T, int Hq,
    int Hkv, int D, int MP, int page_size, int num_pages) {
  const int token = blockIdx.x * blockDim.y + threadIdx.y;    // b * T + t
  if (token >= num_tokens) return;
  const int b = token / T;
  const long long slot =
      k_pool == nullptr ? -1
                        : kv_slot(b, token - b * T, page_table, start_pos,
                                  lengths, active, MP, page_size, num_pages);
  const int hv = D / 16;                  // vector pairs of a head
  const int dv = D / 8;                   // 16-byte vectors of a head
  const int nq = Hq * hv, nqk = nq + Hkv * hv;
  const int n = nqk + (slot >= 0 ? Hkv * dv : 0);
  const float4* cs = cos_tab + (long long)token * dv;     // D/2 floats
  const float4* sn = sin_tab + (long long)token * dv;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (i < nqk) {
      const bool is_q = i < nq;
      const int j = is_q ? i : i - nq;
      const int h = j / hv, c = j - h * hv;
      uint4* row = is_q ? q + ((long long)token * Hq + h) * dv
                        : k + ((long long)token * Hkv + h) * dv;
      const uint4 lo = row[c], hi = row[c + hv];
      const float4 c0 = cs[2 * c], c1 = cs[2 * c + 1];
      const float4 s0 = sn[2 * c], s1 = sn[2 * c + 1];
      uint4 out_lo, out_hi;
      rotate8(lo, hi, c0, c1, s0, s1, out_lo, out_hi);
      row[c] = out_lo;
      row[c + hv] = out_hi;
      if (!is_q && slot >= 0) {
        uint4* dst = k_pool + (slot * Hkv + h) * dv;
        dst[c] = out_lo;
        dst[c + hv] = out_hi;
      }
    } else {
      const int j = i - nqk;
      const int h = j / dv, c = j - h * dv;
      v_pool[(slot * Hkv + h) * dv + c] =
          v[((long long)token * Hkv + h) * dv + c];
    }
  }
}

// q [B, T, Hq, D], k/v [B, T, Hkv, D] bf16 with D % 16 == 0; cos/sin
// [B, T, D/2] float32; pools one layer's view [P, ps, Hkv, D] or null
// (rotation only; then page_table, start_pos, lengths and active are not
// read). A decode step passes T = 1 and `active`, a prefill or ragged
// window `lengths` (active null). Returns cudaGetLastError().
extern "C" int rope_kv_write(void* q, void* k, const void* v,
                             const float* cos_tab, const float* sin_tab,
                             void* k_pool, void* v_pool,
                             const int* page_table, const int* start_pos,
                             const int* lengths, const unsigned char* active,
                             int B, int T, int Hq, int Hkv, int D, int MP,
                             int page_size, int num_pages, void* stream) {
  const int num_tokens = B * T;
  if (num_tokens <= 0) return 0;
  const int items = (Hq + Hkv) * (D / 16) +
                    (k_pool != nullptr ? Hkv * (D / 8) : 0);
  int bx = (items + 31) / 32 * 32;
  if (bx > 256) bx = 256;
  int by = 256 / bx;
  if (by > num_tokens) by = num_tokens;
  const dim3 block(bx, by);
  const dim3 grid((num_tokens + by - 1) / by);
  rope_kv_write_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (uint4*)q, (uint4*)k, (const uint4*)v, (const float4*)cos_tab,
      (const float4*)sin_tab, (uint4*)k_pool, (uint4*)v_pool, page_table,
      start_pos, lengths, active, num_tokens, T, Hq, Hkv, D, MP, page_size,
      num_pages);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// latent_kv_write: the MLA layer body's latent row fused with its writer.
//
// Unfused, the latent [rms_norm(c) * kv_a_norm | rope(k_pe)] of ckv =
// h @ kv_a [B, T, r + dr] takes rms_norm (~9 PyTorch kernels), the rope
// of k_pe (~10) and a cat, then kv_write (the plain version in
// ops/kernels/kv_update.py): ~21 launches a layer. Here one warp per
// token builds the row into `latent` [B, T, r + dr] and, with pools,
// into both pools' slot (both carry the latent, as in the JAX package);
// without pools (attend-then-write) it only builds it.
//
// The norm: a float32 sum of squares of the r values over the warp,
// rsqrt(sum / r + eps), times the weight, each product rounded on its
// own, then to bf16. The sum runs in another order than PyTorch's mean,
// so this form is held to a tolerance, not bit for bit. The rope: one
// pair per lane, adjacent pairs (interleave: DeepSeek's convention) or
// j with j + dr/2, with rope_kv_write's arithmetic.
//
// Bound on an H100: bytes (ckv, cos and sin read once, the weight once,
// the latent written once and once to each pool for the kept tokens).

__global__ void latent_kv_write_kernel(
    const __nv_bfloat16* __restrict__ ckv,
    const __nv_bfloat16* __restrict__ weight,
    const float* __restrict__ cos_tab, const float* __restrict__ sin_tab,
    float eps, int interleave,
    __nv_bfloat16* __restrict__ latent, __nv_bfloat16* __restrict__ k_pool,
    __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ start_pos, const int* __restrict__ lengths,
    const unsigned char* __restrict__ active, int num_tokens, int T, int r,
    int dr, int MP, int page_size, int num_pages) {
  const int lane = threadIdx.x & 31;
  const int token = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (token >= num_tokens) return;                 // the whole warp
  const int b = token / T;
  const long long slot =
      k_pool == nullptr ? -1
                        : kv_slot(b, token - b * T, page_table, start_pos,
                                  lengths, active, MP, page_size, num_pages);
  const int width = r + dr;
  const __nv_bfloat16* x = ckv + (long long)token * width;
  __nv_bfloat16* out = latent + (long long)token * width;
  __nv_bfloat16* kd = slot >= 0 ? k_pool + slot * width : nullptr;
  __nv_bfloat16* vd = slot >= 0 ? v_pool + slot * width : nullptr;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* wv = reinterpret_cast<const uint4*>(weight);
  const int nv = r / 8;
  float ss = 0.f;
  for (int c = lane; c < nv; c += 32) {
    const uint4 u = xv[c];
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      ss += f.x * f.x + f.y * f.y;
    }
  }
  const float inv = rsqrtf(warp_sum(ss) / (float)r + eps);
  for (int c = lane; c < nv; c += 32) {
    const uint4 u = xv[c], w = wv[c];
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
    const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(&w);
    uint4 o;
    __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      const float2 gw = __bfloat1622float2(g[i]);
      op[i] = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(f.x, inv), gw.x),
                                    __fmul_rn(__fmul_rn(f.y, inv), gw.y));
    }
    reinterpret_cast<uint4*>(out)[c] = o;
    if (kd != nullptr) {
      reinterpret_cast<uint4*>(kd)[c] = o;
      reinterpret_cast<uint4*>(vd)[c] = o;
    }
  }
  const int half = dr / 2;
  for (int j = lane; j < half; j += 32) {
    const int i1 = r + (interleave ? 2 * j : j);
    const int i2 = i1 + (interleave ? 1 : half);
    const float c = cos_tab[(long long)token * half + j];
    const float s = sin_tab[(long long)token * half + j];
    const float x1 = __bfloat162float(x[i1]), x2 = __bfloat162float(x[i2]);
    const __nv_bfloat16 o1 =
        __float2bfloat16_rn(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
    const __nv_bfloat16 o2 =
        __float2bfloat16_rn(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
    out[i1] = o1;
    out[i2] = o2;
    if (kd != nullptr) {
      kd[i1] = o1;
      kd[i2] = o2;
      vd[i1] = o1;
      vd[i2] = o2;
    }
  }
}

// ckv [B, T, r + dr] bf16 (r % 8 == 0, dr even), weight [r] bf16, cos/sin
// [B, T, dr/2] float32, latent [B, T, r + dr] bf16 (written); pools one
// layer's view [P, ps, 1, r + dr] or null; the rest as rope_kv_write.
extern "C" int latent_kv_write(const void* ckv, const void* weight,
                               const float* cos_tab, const float* sin_tab,
                               float eps, int interleave, void* latent,
                               void* k_pool, void* v_pool,
                               const int* page_table,
                               const int* start_pos, const int* lengths,
                               const unsigned char* active, int B, int T,
                               int r, int dr, int MP, int page_size,
                               int num_pages, void* stream) {
  const int num_tokens = B * T;
  if (num_tokens <= 0) return 0;
  const int warps = 8;                                 // tokens a block
  const dim3 grid((num_tokens + warps - 1) / warps);
  latent_kv_write_kernel<<<grid, warps * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)ckv, (const __nv_bfloat16*)weight, cos_tab,
      sin_tab, eps, interleave, (__nv_bfloat16*)latent,
      (__nv_bfloat16*)k_pool, (__nv_bfloat16*)v_pool, page_table, start_pos,
      lengths, active, num_tokens, T, r, dr, MP, page_size, num_pages);
  return (int)cudaGetLastError();
}
