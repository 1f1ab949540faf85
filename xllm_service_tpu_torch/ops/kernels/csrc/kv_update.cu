// In-place paged KV writer for one layer: a decode row or a prefill window.
//
// Replaces the Pallas kernels paged_kv_update_layer (body _kernel_layer)
// and paged_prefill_kv_update_layer (body _prefill_kernel_layer) of
// xllm_service_tpu/ops/pallas/kv_update.py. A decode row is a window of
// length 1 whose length is its `active` flag, so one kernel serves both.
//
// What bounds it on an H100: bytes. Each written token row reads its
// fresh K and V rows once and writes them once into the pool
// (2 x 2 x Hkv x D x 2 bytes for bf16); there is no arithmetic. The TPU
// kernel read-modify-wrote 8-slot tiles because its DMA unit moves tiles;
// here every token row is a scatter of 16-byte vectors, neighbouring
// threads on neighbouring addresses, so the pool is touched only where
// it changes and the copy runs at the memory rate.
//
// Drop rules are those of _flat_kv_index (xllm_service_tpu/ops/
// attention.py:58): tokens past the row's length, positions past the
// page table, the NULL page 0 (and any page id outside the pool) write
// nothing. Unlike the Pallas kernel, any window start and any T are
// accepted: the slot is computed per token.
//
// Layout: pools [P, ps, Hkv, D] of one layer (the caller passes the view
// k_pages[layer]); fresh rows [B, T, Hkv, D]; page table [B, MP] int32.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void kv_write_kernel(uint4* __restrict__ k_pool,
                                uint4* __restrict__ v_pool,
                                const uint4* __restrict__ k_new,
                                const uint4* __restrict__ v_new,
                                const int* __restrict__ page_table,
                                const int* __restrict__ start_pos,
                                const int* __restrict__ lengths,
                                const unsigned char* __restrict__ active,
                                int T, int MP, int page_size, int num_pages,
                                int row_vecs) {
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
  const long long dst =
      ((long long)page * page_size + pos % page_size) * row_vecs;
  const long long src = ((long long)b * T + t) * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) {
    k_pool[dst + i] = k_new[src + i];
    v_pool[dst + i] = v_new[src + i];
  }
}

// Returns cudaGetLastError() after the launch (0 = launched). `active`
// is null for a prefill window and non-null (bool [B]) for a decode row.
// `row_bytes` = Hkv * D * element size, a multiple of 16.
extern "C" int kv_write(void* k_pool, void* v_pool, const void* k_new,
                        const void* v_new, const int* page_table,
                        const int* start_pos, const int* lengths,
                        const unsigned char* active, int B, int T, int MP,
                        int page_size, int num_pages, int row_bytes,
                        void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const int row_vecs = row_bytes / 16;
  const int bx = row_vecs < 128 ? row_vecs : 128;
  int by = 256 / bx;
  if (by < 1) by = 1;
  if (by > T) by = T;
  const dim3 block(bx, by);
  const dim3 grid((T + by - 1) / by, B);
  kv_write_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (uint4*)k_pool, (uint4*)v_pool, (const uint4*)k_new,
      (const uint4*)v_new, page_table, start_pos, lengths, active, T, MP,
      page_size, num_pages, row_vecs);
  return (int)cudaGetLastError();
}
