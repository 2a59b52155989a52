// Copy-on-write page copy for Hopper (sm_90a): in place, the full rows of
// pages src[i] are written over the rows of pages dst[i], i < n, in one
// (P, page, ...) pool of any element type, as bytes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py:420
// (page_copy, pallas_call :451; oracle ref.py:170 copy_pages_ref).  On the
// TPU each grid step DMAs one page through VMEM; here a page is
// page_bytes contiguous bytes (P, page, ... row-major), so the copy is a
// gather of n contiguous byte ranges.  The engine calls it once per pool
// leaf for one page at a time (a COW of the divergence page): K and V of
// block 0 and the stacked (L-1) * P view of the other layers, plus the
// (P, page) fp32 scale pools of quantized caches.
//
// What bounds it on this card: bytes, 2 * n * page_bytes (read once,
// written once) at 3.35 TB/s.  At one llama3.2-3b page (32 KiB per bf16
// leaf, 27 of them in the stacked view) that is 1.8 MB, under a
// microsecond of bandwidth, so a launch is latency: the grid is (n pairs,
// chunks of a page) with enough blocks to cover a page at once, each
// thread moving 16-byte vectors when the page size and the pool's address
// allow it and single bytes otherwise (the 64-byte scale pages of page 16
// take the vector path too).
//
// The caller guarantees that the dst pages are distinct and that no dst is
// also a src (the Python wrapper checks the host index lists and raises):
// blocks run in no order, so an overlap would race.  src may repeat.
// Nothing is allocated and nothing synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunks = 64;  // blocks per page pair, at most

template <typename T>
__global__ void __launch_bounds__(kThreads)
page_copy_kernel(T* __restrict__ pool, const int* __restrict__ src,
                 const int* __restrict__ dst, size_t page_elems) {
  const size_t s = (size_t)src[blockIdx.x] * page_elems;
  const size_t d = (size_t)dst[blockIdx.x] * page_elems;
  for (size_t j = (size_t)blockIdx.y * kThreads + threadIdx.x; j < page_elems;
       j += (size_t)gridDim.y * kThreads)
    pool[d + j] = pool[s + j];
}

template <typename T>
int launch(void* pool, const int* src, const int* dst, int n,
           size_t page_elems, cudaStream_t stream) {
  size_t chunks = (page_elems + kThreads - 1) / kThreads;
  if (chunks > kMaxChunks) chunks = kMaxChunks;
  const dim3 grid(n, (unsigned)chunks);
  page_copy_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(pool), src, dst, page_elems);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// pool: the pool's first byte; page_bytes: bytes per page row; src, dst:
// (n,) int32 page ids on the card.  Returns 0 on success, -1 for an
// argument the kernel does not take, else the cudaError_t of the launch.
int page_copy(void* pool, const int* src, const int* dst, int n,
              long long page_bytes, int device, void* stream) {
  if (n == 0 || page_bytes == 0) return 0;
  if (n < 0 || page_bytes < 0) return -1;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (page_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(pool) % 16 == 0)
    return launch<uint4>(pool, src, dst, n, (size_t)page_bytes / 16, s);
  return launch<uint8_t>(pool, src, dst, n, (size_t)page_bytes, s);
}

const char* page_copy_error_string(int code) {
  if (code == -1) return "argument not supported by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
