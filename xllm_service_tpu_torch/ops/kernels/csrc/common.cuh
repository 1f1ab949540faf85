// Helpers shared by the attention kernels of this directory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define XLLM_NEG_INF (-1e30f)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Gemma-2 logit soft-cap cap * tanh(x / cap); cap <= 0 disables it.
__device__ __forceinline__ float soft_cap(float x, float cap) {
  return cap > 0.f ? cap * tanhf(x / cap) : x;
}

// Two neighbouring bf16 values as floats (4-byte aligned load).
__device__ __forceinline__ float2 load_bf16x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Final normalisation of one output row element, with the GPT-OSS sink
// logit (never scaled, never capped) joining the denominator only.
__device__ __forceinline__ float finish_row(float acc, float m, float l,
                                            const float* sinks, int head) {
  if (sinks != nullptr) {
    const float sk = sinks[head];
    const float m2 = fmaxf(m, sk);
    const float corr = expf(m - m2);
    l = l * corr + expf(sk - m2);
    acc *= corr;
  }
  return acc / fmaxf(l, 1e-30f);
}

// Raises the dynamic shared-memory limit of `kernel` to `bytes` when it
// needs more than the default 48 KB. `granted` is the caller's record of
// the limit already set, so the attribute is set once per new maximum
// and not on every launch. Returns a CUDA error code.
template <typename K>
inline int allow_smem(K kernel, size_t bytes, size_t* granted) {
  if (bytes <= 48 * 1024 || bytes <= *granted) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == 0) *granted = bytes;
  return err;
}
