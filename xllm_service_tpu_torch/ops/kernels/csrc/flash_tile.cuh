// One query tile of causal GQA flash attention over one layer of the
// paged KV pool: the device code shared by the prefill kernel
// (paged_prefill_attention.cu) and the ragged kernel
// (ragged_paged_attention.cu). Each kernel maps its blocks to tiles and
// picks the tile's key range; this header does the tile's work.
//
// What bounds it on an H100: at serving windows (a few hundred tokens)
// neither bytes nor operations but the serial chain of key chunks that
// the longest tile walks; at long prompts (thousands of tokens) the
// operations: the tensor cores' products and, at D = 64, as much again
// of the exp unit's work (one exp per score against 256 flops of the
// products). The design shortens each link of the chain and keeps the
// tensor cores fed:
// - A tile is 128 (query position, head) rows: QB = 128 / G positions
//   times the G heads of one kv head, so a kv head's keys are read once
//   per 128 rows. 256 threads: two warpgroups of 64 rows each. At
//   D = 64 the prefill kernel keeps a thread to 128 registers so that
//   two blocks share an SM and one's softmax runs beside the other's
//   products.
// - Keys stream through a two-stage ring of 64-key chunks in shared
//   memory, staged by `cp.async` 16 bytes at a time: chunk i + 1's copies
//   are issued before chunk i's math and the page-table entries of chunk
//   i + 2 are loaded before it too, so no global-memory latency sits on
//   the chain. Staging goes key row by key row, so the fresh form can
//   take each key from its own source, and any page size and any q_start
//   work.
// - Both products are Hopper's warpgroup products (`wgmma`, bf16 with
//   float32 accumulators), and S and O stay in registers for the whole
//   key walk: S = Q K^T (m64n64k16, Q and K from shared memory) lands in
//   the layout in which P = softmax(S), rounded to bf16, is the register
//   A operand of O += P V (m64nDk16, V from shared memory through the
//   transpose bit), so P never touches shared memory.
// - The online softmax runs on the accumulators: a thread's own values,
//   then two shuffles inside its quad for the row max; the row sum stays
//   per thread until the end. One `__syncthreads()` per chunk.
// - Only a chunk that reaches past the tile's first causal limit, its
//   window edge or the end of its keys tests each element.
// - D = 256 keeps 64 keys per step: 193 KB of shared memory, 255
//   registers with a few bytes spilled.
// Shared memory holds Q and the ring, every operand in 64-column blocks
// of 128-byte rows with the 128-byte XOR swizzle (16-byte vector v of row
// r at v ^ (r % 8)): the layout `wgmma`'s descriptors read without bank
// conflicts. (An `mma.sync` m16n8k16 version of the same tile, operands
// through `ldmatrix`, measured 13-40% slower on an H100; PERF.md.)
//
// Semantics (those of the Pallas kernels): query t of row b sits at
// position q_start[b] + t and attends to keys k with k <= its position,
// k < q_start[b] + lengths[b] and, with W > 0, k > its position - W;
// scale, soft-cap and sinks as in the decode kernel; P is rounded to
// bf16 for P V, as the plain versions do. Query rows t >= lengths[b]
// output zeros.
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

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace flash {

constexpr int kRows = 128;     // tile rows (position, head)
constexpr int kKeys = 64;      // keys per step
constexpr int kThreads = 256;  // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;     // K/V ring depth
static_assert(kRows == 16 * kWarps, "one 16-row slice per warp");

// Shared-memory plan of one block (bytes): Q, then the ring's K and V
// stages, each a multiple of the 1024-byte swizzle atom; plus slack to
// align the base to it.
template <int D>
struct Plan {
  static_assert(D % 64 == 0, "head dim in 64-column blocks");
  static constexpr size_t kQ = (size_t)kRows * D * 2;
  static constexpr size_t kKV = (size_t)kKeys * D * 2;   // one stage
  static constexpr size_t kTotal = 1024 + kQ + 2 * kStages * kKV;
  // Blocks per SM the prefill kernel asks registers for: two at D = 64
  // (128 registers a thread), where one block's 8 warps leave the tensor
  // cores idle during their softmax.
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;
};

// Byte offset of the 16 bytes holding columns [c, c + 8) of row r in an
// operand of `rows` rows (c a multiple of 8).
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  return (uint32_t)((c >> 6) * rows * 128 + r * 128 +
                    ((((c >> 3) ^ r) & 7) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));   // 0 bytes: zero-fill
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x (one MUFU instruction; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Warpgroup w / 4 (w the warp) owns tile rows [64 (w / 4), 64 (w / 4) +
// 64), warp w rows [16w, 16w + 16). Accumulator layout (S and O alike):
// for the 8-column block j of its warp's 16 rows, thread (g = lane / 4,
// t = lane % 4) holds element 4j + e at row g + 8 (e / 2), column
// 8j + 2t + e % 2; the A operand from registers has the same layout, 16
// columns (two blocks) per four registers. Shared operands are read
// through descriptors of the 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

#define XLLM_ACC8(i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A B for one warpgroup (accumulate = 0 overwrites d): 64 x 64 x
// 16, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(
    float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : XLLM_ACC8(0),
        XLLM_ACC8(8),
        XLLM_ACC8(16),
        XLLM_ACC8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B for one warpgroup: 64 x 64 x 16 and 64 x 128 x 16, A from
// registers (four a thread), B from shared memory, N-major (transposed).
__device__ __forceinline__ void wgmma_m64n64k16_rs(
    float* d, const uint32_t* a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : XLLM_ACC8(0),
        XLLM_ACC8(8),
        XLLM_ACC8(16),
        XLLM_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(
    float* d, const uint32_t* a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : XLLM_ACC8(0),
        XLLM_ACC8(8),
        XLLM_ACC8(16),
        XLLM_ACC8(24),
        XLLM_ACC8(32),
        XLLM_ACC8(40),
        XLLM_ACC8(48),
        XLLM_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef XLLM_ACC8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous product uses across the product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// s = Q K^T for the warpgroup's 64 rows and the chunk's 64 keys: Q and K
// from shared memory, both K-major (m64n64k16 per 16 columns of D).
template <int D>
__device__ __forceinline__ void s_product(float (&s)[kKeys / 2],
                                          uint32_t q_s, uint32_t k_s,
                                          int warp) {
  const uint32_t q_wg = q_s + (uint32_t)(warp >> 2) * 64 * 128;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;      // 16 columns of a 128 B row
    wgmma_m64n64k16_ss(
        s, smem_desc(q_wg + (kk >> 2) * kRows * 128 + off, 16, 1024),
        smem_desc(k_s + (kk >> 2) * kKeys * 128 + off, 16, 1024), kk > 0);
  }
  wgmma_commit_and_wait();
  fence_regs(s);
}

// o += P V for the warpgroup's 64 rows: P from registers (the A operand
// layout), V from shared memory [keys][D], read N-major through the
// transpose bit (m64nDk16 per 16 keys; D = 256 as two n128 halves).
template <int D>
__device__ __forceinline__ void o_product(float (&o)[D / 2],
                                          uint32_t (&p)[kKeys / 4],
                                          uint32_t v_s) {
  constexpr uint32_t kLbo = kKeys * 128;    // between 64-column blocks
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint32_t vk = v_s + kk * 16 * 128;
    if constexpr (D == 64) {
      wgmma_m64n64k16_rs(o, &p[4 * kk], smem_desc(vk, kLbo, 1024), 1);
    } else {
#pragma unroll
      for (int half = 0; half < D / 128; ++half)
        wgmma_m64n128k16_rs(&o[64 * half], &p[4 * kk],
                            smem_desc(vk + half * 2 * kLbo, kLbo, 1024), 1);
    }
  }
  wgmma_commit_and_wait();
  fence_regs(o);
  fence_regs(p);
}

// Where key p of this thread in a chunk comes from: a page id (>= 0), the
// fresh operand, or nowhere (zero-filled).
constexpr int kFresh = -1;
constexpr int kNone = -2;

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
  constexpr int kVpr = D / 8;                  // 16-byte vectors per row
  constexpr int kStride = kThreads / kVpr;     // key rows staged per pass
  constexpr int kPasses = kKeys / kStride;
  const uint32_t q_s =
      ((uint32_t)__cvta_generic_to_shared(smem) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + (uint32_t)PL::kQ;
  const uint32_t v_s = k_s + (uint32_t)(kStages * PL::kKV);

  const int R = QB * G;                        // tile rows, <= kRows
  const int Hq = Hkv * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row_stride = (long long)Hkv * D;
  const int nchunks =
      nt > 0 && kv_hi >= kv_lo ? (kv_hi - kv_lo) / kKeys + 1 : 0;

  // This thread stages 16-byte vector `vc` of key rows j0 + p * kStride.
  const int vc = tid % kVpr, j0 = tid / kVpr;
  int src[kPasses];
  auto lookup = [&](int c0) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int pos = c0 + j0 + p * kStride;
      src[p] = pos > kv_hi                       ? kNone
               : FRESH && pos >= fresh_start     ? kFresh
               : FRESH && pos >= MP * page_size  ? kNone
               : page_table[(long long)b * MP + pos / page_size];
    }
  };
  auto issue = [&](int c0, int stage) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int j = j0 + p * kStride, pos = c0 + j;
      const __nv_bfloat16 *ks = k_pool, *vs = v_pool;
      long long e = (long long)h * D + vc * 8;
      if (src[p] >= 0) {
        e += ((long long)src[p] * page_size + pos % page_size) * row_stride;
      } else if (FRESH && src[p] == kFresh) {
        ks = k_fresh;
        vs = v_fresh;
        e += ((long long)b * T + (pos - fresh_start)) * row_stride;
      }
      const uint32_t off = stage * (uint32_t)PL::kKV + swz(kKeys, j, vc * 8);
      cp_async16(k_s + off, ks + e, src[p] != kNone);
      cp_async16(v_s + off, vs + e, src[p] != kNone);
    }
  };

  if (nchunks > 0) {
    // Q tile rows (position tl, head g) as bf16; padding rows zero.
    for (int i = tid; i < kRows * kVpr; i += kThreads) {
      const int r = i / kVpr, c = i % kVpr;
      const int tl = r / G, g = r % G;
      const bool ok = r < R && tl < nt;
      cp_async16(q_s + swz(kRows, r, c * 8),
                 ok ? q + (((long long)b * T + t0 + tl) * Hq + h * G + g) * D +
                          c * 8
                    : q,
                 ok);
    }
    lookup(kv_lo);
    issue(kv_lo, 0);
    if (nchunks > 1) lookup(kv_lo + kKeys);
  }
  cp_async_commit();

  // This thread's two rows of the tile, r0 and r0 + 8.
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp + g8;
  const int qpos[2] = {q_lo + r0 / G, q_lo + (r0 + 8) / G};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m in log2
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale_log2 = scale * kLog2e;
  const float cap_log2 = cap * kLog2e, scale_over_cap = scale / cap;

  for (int i = 0; i < nchunks; ++i) {
    const int c0 = kv_lo + i * kKeys;
    const int n = min(kKeys, kv_hi - c0 + 1);
    const int stage = i & 1;
    cp_async_wait_all();
    // The copies (generic proxy) become visible to wgmma (async proxy).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (i + 1 < nchunks) {
      issue(c0 + kKeys, stage ^ 1);
      cp_async_commit();
      if (i + 2 < nchunks) lookup(c0 + 2 * kKeys);
    }

    float s[kKeys / 2];
    s_product<D>(s, q_s, k_s + stage * (uint32_t)PL::kKV, warp);

    // Online softmax on the accumulators, in units of log2 (exp2 is one
    // instruction). Every key of the chunk is valid for every row when
    // the chunk is full, ends at or before the tile's first position and
    // starts inside its last position's window.
    const bool full = n == kKeys && c0 + kKeys - 1 <= q_lo &&
                      (window <= 0 || c0 > q_lo + nt - 1 - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < kKeys / 2; ++e) {
      const int j = (e >> 2) * 8 + 2 * t4 + (e & 1), rr = (e >> 1) & 1;
      float v = cap > 0.f ? cap_log2 * tanhf(s[e] * scale_over_cap)
                          : s[e] * scale_log2;
      if (!full) {
        const int kpos = c0 + j;
        if (!(j < n && kpos <= qpos[rr] &&
              (window <= 0 || kpos > qpos[rr] - window)))
          v = -INFINITY;
      }
      s[e] = v;
      mx[rr] = fmaxf(mx[rr], v);
    }
    float base[2], corr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      base[rr] = m_new == -INFINITY ? 0.f : m_new;   // no key yet
      corr[rr] = ex2(m[rr] - base[rr]);
      m[rr] = m_new;
      l[rr] *= corr[rr];
    }
    uint32_t p[kKeys / 4];
#pragma unroll
    for (int e = 0; e < kKeys / 2; e += 2) {
      const int rr = (e >> 1) & 1;
      const float p0 = ex2(s[e] - base[rr]);
      const float p1 = ex2(s[e + 1] - base[rr]);
      l[rr] += p0 + p1;
      p[e / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e >> 1) & 1];

    o_product<D>(o, p, v_s + stage * (uint32_t)PL::kKV);
  }

  // Row sums across the quad, then each row's normalisation.
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    const int r = r0 + 8 * rr;
    const int tl = r / G, g = r % G;
    if (r >= R || t0 + tl >= T) continue;
    const float f =
        tl < nt ? finish_row(1.f, m[rr] / kLog2e, l[rr], sinks, h * G + g)
                : 0.f;
    __nv_bfloat16* dst =
        out + (((long long)b * T + t0 + tl) * Hq + h * G + g) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(o[4 * j + 2 * rr] * f, o[4 * j + 2 * rr + 1] * f);
  }
}

}  // namespace flash
