// Single-token GQA attention over one layer of the paged KV pool.
//
// Replaces the Pallas kernel paged_decode_attention_pallas of
// xllm_service_tpu/ops/pallas/paged_attention.py (bodies _kernel and
// _kernel_layered) in its write-then-attend form: the current token is
// already in the pool, so the context includes it and there is no
// k_cur/v_cur operand.
//
// What bounds it on an H100: bytes. Each row reads its context's K and V
// once (2 x ctx x Hkv x D x 2 bytes) for 4 x G flops per byte, far below
// the ~295 flops per byte where the tensor cores would become the limit.
// So the design reads every K/V row of the context exactly once and keeps
// as many of those reads in flight as it can: one block per (row, kv
// head) serves all G query heads of the group. For each chunk of 128
// keys, each thread takes one key: it looks up the key's page once, then
// issues all the 16-byte loads of that key's K and V head rows before it
// stores any of them to shared memory, so a chunk costs about one memory
// latency, not one per load. Then one thread per key computes the G
// scores from shared memory and the online float32 softmax folds the
// chunk; nothing but the output is written back. Keys outside
// [ctx - W, ctx) are never read. The head dim D and the group width are
// template parameters, so the per-key dot products and the P @ V loop
// unroll into independent loads and FMAs instead of one dependent chain
// per element: with one block per (row, kv head) there are few warps to
// hide latency, so each warp needs the instruction-level parallelism.
//
// Semantics (those of the Pallas kernel): positions >= ctx and, with a
// sliding window W > 0, positions <= ctx - 1 - W are masked; logits are
// scaled by `scale`, then soft-capped; sinks join the denominator only;
// a row with ctx = 0 outputs zeros.
//
// Layout: q [B, Hq, D] bf16 with Hq = Hkv * G (head h*G+g belongs to kv
// head h); pools [P, ps, Hkv, D] bf16 (the caller passes k_pages[layer]);
// page table [B, MP] int32; context_lens [B] int32; sinks [Hq] float32 or
// null; out [B, Hq, D] bf16.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kChunk = 128;   // keys per online-softmax step
constexpr int kBatch = 8;     // 16-byte loads in flight per row and tensor

template <int D>
__host__ __device__ constexpr int threads_for() {
  return D > 128 ? D : 128;
}

// D: head dim; KG: the group width G rounded up to a power of two (rows
// g >= G of the group are skipped).
template <int D, int KG>
__global__ void __launch_bounds__(threads_for<D>())
paged_decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool,
    const int* __restrict__ page_table, const int* __restrict__ context_lens,
    const float* __restrict__ sinks, __nv_bfloat16* __restrict__ out,
    int Hkv, int G, int MP, int page_size, int window, float scale,
    float cap) {
  extern __shared__ float smem[];
  constexpr int nsplit = threads_for<D>() / D;
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

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int Hq = Hkv * G;
  const long long row_stride = (long long)Hkv * D;

  const int ctx_raw = context_lens[b];
  const int ctx = min(ctx_raw, MP * page_size);
  const int lo = window > 0 ? max(0, ctx_raw - window) : 0;

  const __nv_bfloat16* qb = q + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < KG * D; i += blockDim.x)
    q_s[i] = i < G * D ? __bfloat162float(qb[i]) : 0.f;
  for (int g = tid; g < G; g += blockDim.x) {
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
    for (int t = tid; t < n; t += blockDim.x) {
      const int pos = c0 + t;
      const int page = page_table[(long long)b * MP + pos / page_size];
      const long long off =
          ((long long)page * page_size + pos % page_size) * row_stride +
          (long long)h * D;
      const uint4* ksrc = reinterpret_cast<const uint4*>(k_pool + off);
      const uint4* vsrc = reinterpret_cast<const uint4*>(v_pool + off);
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
    for (int t = tid; t < n; t += blockDim.x) {
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
  __nv_bfloat16* ob = out + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D;
    const int dd = i % D;
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s) a += red[(s * G + g) * D + dd];
    ob[i] = __float2bfloat16(finish_row(a, m_s[g], l_s[g], sinks, h * G + g));
  }
}

template <int D, int KG>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* page_table, const int* context_lens, const float* sinks,
           void* out, int B, int Hkv, int G, int MP, int page_size,
           int window, float scale, float cap, cudaStream_t stream) {
  constexpr int threads = threads_for<D>();
  constexpr int nsplit = threads / D;
  const size_t smem =
      sizeof(float) * (size_t)(KG * D + KG * kChunk + 3 * G + nsplit * G * D) +
      sizeof(uint32_t) * (size_t)kChunk * 2 * (D / 2 + 1);
  static size_t granted = 0;
  const int err =
      allow_smem(paged_decode_attention_kernel<D, KG>, smem, &granted);
  if (err) return err;
  paged_decode_attention_kernel<D, KG><<<B * Hkv, threads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
      (const __nv_bfloat16*)v_pool, page_table, context_lens, sinks,
      (__nv_bfloat16*)out, Hkv, G, MP, page_size, window, scale, cap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int G, const void* q, const void* k_pool, const void* v_pool,
             const int* page_table, const int* context_lens,
             const float* sinks, void* out, int B, int Hkv, int MP,
             int page_size, int window, float scale, float cap,
             cudaStream_t stream) {
#define XLLM_DECODE_LAUNCH(KG)                                              \
  return launch<D, KG>(q, k_pool, v_pool, page_table, context_lens, sinks, \
                       out, B, Hkv, G, MP, page_size, window, scale, cap,  \
                       stream)
  if (G <= 1) XLLM_DECODE_LAUNCH(1);
  if (G <= 2) XLLM_DECODE_LAUNCH(2);
  if (G <= 4) XLLM_DECODE_LAUNCH(4);
  if (G <= 8) XLLM_DECODE_LAUNCH(8);
  XLLM_DECODE_LAUNCH(16);
#undef XLLM_DECODE_LAUNCH
}

}  // namespace

// Returns a CUDA error code (0 = launched). D must be 64, 128 or 256 and
// G at most 16; the wrapper checks both.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* page_table, const int* context_lens, const float* sinks,
    void* out, int B, int Hkv, int G, int D, int MP, int page_size,
    int window, float scale, float cap, void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return launch_d<64>(G, q, k_pool, v_pool, page_table, context_lens,
                          sinks, out, B, Hkv, MP, page_size, window, scale,
                          cap, st);
    case 128:
      return launch_d<128>(G, q, k_pool, v_pool, page_table, context_lens,
                           sinks, out, B, Hkv, MP, page_size, window, scale,
                           cap, st);
    case 256:
      return launch_d<256>(G, q, k_pool, v_pool, page_table, context_lens,
                           sinks, out, B, Hkv, MP, page_size, window, scale,
                           cap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
