// CUDA IPC for the PD handoff's device wire (runtime/kv_wire.py): no
// kernel, only the runtime calls that stage a KV block in a buffer
// another process can map, and map it there.
//
// The producer allocates its staging segments with cudaMalloc (the
// caching allocator's sub-blocks and expandable segments cannot be
// exported), exports each once with its interprocess event, copies a
// block in and records the event. The consumer opens the segment and
// the event once per segment, makes its stream wait on the event and
// copies the block out. Segments and mappings live as long as the
// process. Every entry returns the cudaError_t of its last call (0 on
// success).

#include <cuda_runtime.h>

#include <cstring>

extern "C" int kv_ipc_handle_bytes() {
  return (int)sizeof(cudaIpcMemHandle_t);
}

// A staging segment of nbytes on device dev, its memory handle, an
// interprocess event and the event's handle.
extern "C" int kv_ipc_alloc(int dev, size_t nbytes, void** ptr,
                            void* mem_handle, void** event,
                            void* event_handle) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  e = cudaMalloc(ptr, nbytes);
  if (e != cudaSuccess) return e;
  cudaIpcMemHandle_t mh;
  e = cudaIpcGetMemHandle(&mh, *ptr);
  if (e != cudaSuccess) return e;
  std::memcpy(mem_handle, &mh, sizeof(mh));
  cudaEvent_t ev;
  e = cudaEventCreateWithFlags(
      &ev, cudaEventInterprocess | cudaEventDisableTiming);
  if (e != cudaSuccess) return e;
  *event = (void*)ev;
  cudaIpcEventHandle_t eh;
  e = cudaIpcGetEventHandle(&eh, ev);
  if (e != cudaSuccess) return e;
  std::memcpy(event_handle, &eh, sizeof(eh));
  return cudaSuccess;
}

// Device-to-device copy on the stream (staging in, or a mapped segment
// out into a fresh tensor).
extern "C" int kv_ipc_copy(void* dst, const void* src, size_t nbytes,
                           void* stream) {
  return cudaMemcpyAsync(dst, src, nbytes, cudaMemcpyDeviceToDevice,
                         (cudaStream_t)stream);
}

extern "C" int kv_ipc_record(void* event, void* stream) {
  return cudaEventRecord((cudaEvent_t)event, (cudaStream_t)stream);
}

// The consumer's mapping of a producer's segment and event.
extern "C" int kv_ipc_open(int dev, const void* mem_handle, void** ptr) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  cudaIpcMemHandle_t mh;
  std::memcpy(&mh, mem_handle, sizeof(mh));
  return cudaIpcOpenMemHandle(ptr, mh, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int kv_ipc_open_event(const void* event_handle, void** event) {
  cudaIpcEventHandle_t eh;
  std::memcpy(&eh, event_handle, sizeof(eh));
  cudaEvent_t ev;
  cudaError_t e = cudaIpcOpenEventHandle(&ev, eh);
  if (e == cudaSuccess) *event = (void*)ev;
  return e;
}

extern "C" int kv_ipc_close(void* ptr, void* event) {
  cudaError_t e = cudaSuccess;
  if (event) e = cudaEventDestroy((cudaEvent_t)event);
  if (ptr) {
    cudaError_t f = cudaIpcCloseMemHandle(ptr);
    if (e == cudaSuccess) e = f;
  }
  return e;
}

extern "C" int kv_ipc_wait(void* event, void* stream) {
  return cudaStreamWaitEvent((cudaStream_t)stream, (cudaEvent_t)event, 0);
}
