// Copy-on-write page copy for Hopper (sm_90a): in place, the full rows of
// pages src[i] are written over the rows of pages dst[i], i < n, in every
// layer of every pool leaf of a paged cache, as bytes, in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py:420
// (page_copy, pallas_call :451; oracle ref.py:170 copy_pages_ref), which
// the reference calls once per pool leaf (repro/models/model.py:1054,
// copy_paged_pages).  On the TPU each grid step DMAs one page through
// VMEM; here a page is page_bytes contiguous bytes (P, page, ...
// row-major), so a COW is a gather of contiguous byte ranges: for each
// leaf (K and V of block 0, the stacked (L-1, P, ...) K and V of the other
// layers, and the (P, page) fp32 scale pools of one-byte pages) and each
// of its layers, page layer * P + src[i] over layer * P + dst[i].
//
// What bounds it on this card: bytes, 2 x the bytes copied (read once,
// written once) at 3.35 TB/s.  One llama3.2-3b page is 1.8 MB over its 56
// bf16 (layer, K or V) pages, under a microsecond of bandwidth, so a COW
// is latency: the launch and one round trip to memory.  The design:
//
//  * one launch for the whole cache: the leaf table (base, page bytes,
//    pages a layer, layers) and the pairs ride in the kernel's parameter
//    block (a __grid_constant__ struct of under 3 KB), so nothing is
//    uploaded per COW; a COW of more than kMaxPairs pairs is split into
//    launches by the caller (a cache has at most 8 leaves: more than
//    kMaxLeaves are refused);
//  * block b takes a fixed task (leaf, layer, pair, chunk of the page):
//    the leaves' tasks lie one after the other, layer-major, then pair,
//    then chunk; the offsets layer * P are computed here;
//  * each thread issues kInFlight 16-byte loads before its stores (a
//    chunk is kThreads * kInFlight * 16 = 16 KB); a leaf whose page size
//    or base is not a multiple of 16 bytes moves single bytes instead.
//
// The caller guarantees that the dst pages are distinct and that no dst is
// also a src (the Python wrapper checks the host index lists and raises):
// blocks run in no order, so an overlap would race.  src may repeat.
// Nothing is allocated and nothing synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;     // loads a thread issues before its stores
constexpr int kMaxLeaves = 16;   // pool leaves of a launch, at most
constexpr int kMaxPairs = 256;   // page pairs of a launch, at most

struct Leaf {
  unsigned char* base;     // the pool's first byte
  long long page_bytes;    // bytes of one page
  long long chunk_bytes;   // bytes of one task: kThreads * kInFlight units
  int pages;               // pages of a layer (P)
  int layers;              // 1, or L - 1 for a stacked pool
  int chunks;              // tasks of one page
  int unit;                // bytes a thread moves at once: 16 or 1
  long long first_task;    // the leaf's first block
};

struct CopyParams {
  Leaf leaf[kMaxLeaves];
  int n_leaves, n;
  int src[kMaxPairs], dst[kMaxPairs];
};
static_assert(sizeof(CopyParams) < 4096, "the parameter block is < 4 KB");

template <typename U>
__device__ __forceinline__ void move(const unsigned char* s,
                                     unsigned char* d, long long units) {
  const U* su = reinterpret_cast<const U*>(s);
  U* du = reinterpret_cast<U*>(d);
  U v[kInFlight];
#pragma unroll
  for (int k = 0; k < kInFlight; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j < units) v[k] = su[j];
  }
#pragma unroll
  for (int k = 0; k < kInFlight; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j < units) du[j] = v[k];
  }
}

__global__ void __launch_bounds__(kThreads)
page_copy_kernel(const __grid_constant__ CopyParams p) {
  long long task = blockIdx.x;
  int l = 0;
  while (l + 1 < p.n_leaves && task >= p.leaf[l + 1].first_task) ++l;
  const Leaf& lf = p.leaf[l];
  task -= lf.first_task;
  const int chunk = (int)(task % lf.chunks);
  task /= lf.chunks;
  const int pair = (int)(task % p.n);
  const long long layer = task / p.n;
  const long long off = chunk * lf.chunk_bytes;
  const long long first = layer * lf.pages;
  const unsigned char* s =
      lf.base + (first + p.src[pair]) * lf.page_bytes + off;
  unsigned char* d = lf.base + (first + p.dst[pair]) * lf.page_bytes + off;
  const long long left = lf.page_bytes - off;
  const long long bytes = left < lf.chunk_bytes ? left : lf.chunk_bytes;
  if (lf.unit == 16)
    move<uint4>(s, d, bytes / 16);
  else
    move<unsigned char>(s, d, bytes);
}

}  // namespace

extern "C" {

// One launch: for each of the n_leaves leaves (bases[i]: the pool's first
// byte on the card; page_bytes[i]: bytes of a page; pages[i]: pages a
// layer; layers[i]: layers, the pool being (layers, pages, ...)) and each
// of its layers, the rows of pages src[j] written over pages dst[j], j <
// n (host arrays, page ids within a layer).  n <= kMaxPairs, n_leaves <=
// kMaxLeaves.  Returns 0 on success, -1 for an argument the kernel does
// not take, else the cudaError_t of the launch.
int page_copy(const unsigned long long* bases, const long long* page_bytes,
              const int* pages, const int* layers, int n_leaves,
              const int* src, const int* dst, int n, int device,
              void* stream) {
  if (n < 0 || n > kMaxPairs || n_leaves < 0 || n_leaves > kMaxLeaves)
    return -1;
  CopyParams p;
  p.n = n;
  p.n_leaves = 0;
  long long tasks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    if (page_bytes[i] < 0 || pages[i] <= 0 || layers[i] <= 0) return -1;
    if (page_bytes[i] == 0) continue;
    for (int j = 0; j < n; ++j)
      if (src[j] < 0 || src[j] >= pages[i] || dst[j] < 0 ||
          dst[j] >= pages[i])
        return -1;
    Leaf& lf = p.leaf[p.n_leaves++];
    lf.base = reinterpret_cast<unsigned char*>(bases[i]);
    lf.page_bytes = page_bytes[i];
    lf.pages = pages[i];
    lf.layers = layers[i];
    lf.unit = page_bytes[i] % 16 == 0 && bases[i] % 16 == 0 ? 16 : 1;
    lf.chunk_bytes = (long long)kThreads * kInFlight * lf.unit;
    lf.chunks = (int)((lf.page_bytes + lf.chunk_bytes - 1) / lf.chunk_bytes);
    lf.first_task = tasks;
    tasks += (long long)lf.layers * n * lf.chunks;
  }
  if (tasks == 0) return 0;
  if (tasks > 0x7fffffffLL) return -1;
  for (int j = 0; j < n; ++j) {
    p.src[j] = src[j];
    p.dst[j] = dst[j];
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  page_copy_kernel<<<(unsigned)tasks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* page_copy_error_string(int code) {
  if (code == -1) return "argument not supported by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
