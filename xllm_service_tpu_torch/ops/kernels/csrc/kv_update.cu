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

#include <cuda_runtime.h>
#include <stdint.h>

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
  const int len = active != nullptr ? (active[b] ? 1 : 0) : lengths[b];
  if (t >= len) return;
  const long long pos = (long long)start_pos[b] + t;
  if (pos < 0) return;
  const long long pidx = pos / page_size;
  if (pidx >= MP) return;
  const int page = page_table[(long long)b * MP + pidx];
  if (page <= 0 || page >= num_pages) return;
  const long long dst = blockIdx.z * pool_layer_vecs +
      ((long long)page * page_size + pos % page_size) * row_vecs;
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
