// Warp-level tensor-core building blocks of the decode kernels: `mma.sync`
// m16n8k16 (bf16 in, float32 out), `ldmatrix` operand loads from shared
// memory, `cp.async` staging and the softmax's small helpers. (The prefill
// tile code, flash_tile.cuh, runs warpgroup `wgmma` and has its own.)
//
// Fragment layouts of m16n8k16, thread (g = lane / 4, t = lane % 4):
// - A (16 x 16, row-major), 4 registers of 2 bf16: (row g, cols 2t..2t+1),
//   (row g + 8, cols 2t..), (row g, cols 2t + 8..), (row g + 8, cols
//   2t + 8..). `ldsm_x4` of rows lane % 16 at column 8 (lane / 16) loads it.
// - B (16 x 8, "col": element (k, n) from row n of an n-major array), 2
//   registers: (k 2t..2t+1, n g), (k 2t + 8.., n g). `ldsm_x4` of rows n at
//   columns k0, k0 + 8, k0 + 16, k0 + 24 loads two k-steps; `ldsm_x4_trans`
//   of rows k (a k-major array, such as V) loads two k-steps of one n8.
// - C/D (16 x 8 float32), 4 registers: (row g, cols 2t, 2t + 1), (row g + 8,
//   cols 2t, 2t + 1).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace msync {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronous; !valid zero-fills and reads
// nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Max and sum over the 4 threads of a quad (one accumulator row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

constexpr float kLog2e = 1.4426950408889634f;

}  // namespace msync
