// FAL's MLP-input fusion for Hopper (sm_90a): y = LN(x) * scale (+ bias)
// + a1n in one pass, and its backward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_ln_add.py:37
// (fused_ln_add, pallas_call :55, body _ln_add_kernel :24; oracle
// ref.py:178 ln_add_ref).  The TPU kernel tiles 256 rows with the whole
// feature dimension in VMEM; here one thread block owns a row at a time.
//
// Layouts: x, a1n, y, dy, dx (rows, d) in one dtype (fp32 or bf16),
// row-major; scale, bias, dscale, dbias (d,) fp32; mean, rstd (rows,)
// fp32.  kind 0 is rmsnorm (x * rstd * scale), kind 1 layernorm
// ((x - mean) * rstd * scale + bias), both in fp32 with eps inside the
// root, as the reference computes them; y is rounded once to x's dtype.
//
// Forward: one block per row.  The row is read with 16-byte vectors where
// d allows (8 bf16 or 4 fp32 values), reduced in fp32 (layernorm: mean,
// then the mean square about it, as the reference does), and written once.
// The block also writes the row's rstd and mean for the backward.
//
// Backward: dx per row from dy, x, scale and the saved statistics,
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat)),  g = dy * scale
// (rmsnorm drops the mean(g) term), by a grid of at most kBwdBlocks blocks
// that stride over the rows; each block sums dy * xhat (and dy) for its
// rows into per-column fp32 partials in shared memory and writes them out;
// a second small kernel sums the partials column by column in block order.
// No atomics: the same bits on every run.  d(a1n) is dy itself (no
// launch; the wrapper returns it).
//
// What bounds it on this card: bytes.  The forward reads x and a1n and
// writes y (6 bytes a value in bf16, 12 in fp32); at (2048, 3072) bf16
// that is 37.7 MB, 0.011 ms at 3.35 TB/s.  Nothing is allocated (the
// wrapper passes the partials' scratch) and nothing synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kBwdBlocks = 256;   // at most this many partial rows

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC consecutive values, one load or store of sizeof(T) * VEC bytes.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&out)[VEC]) {
  const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f(pk.v[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&in)[VEC]) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int i = 0; i < VEC; ++i) pk.v[i] = from_f<T>(in[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

// Sum over the block (blockDim.x a multiple of 32); every thread gets it.
__device__ float block_sum(float v) {
  __shared__ float red[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();                 // red is free from the last call
  if (lane == 0) red[w] = v;
  __syncthreads();
  float t = lane < (int)(blockDim.x / 32) ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

template <typename T, int VEC, bool LN>
__global__ void __launch_bounds__(kMaxThreads)
ln_add_fwd_kernel(const T* __restrict__ x, const T* __restrict__ a1,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  int d, float eps) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  const int nv = d / VEC;
  float acc = 0.f;
  for (int j = threadIdx.x; j < nv; j += blockDim.x) {
    float xv[VEC];
    load<T, VEC>(xr + j * VEC, xv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc += LN ? xv[i] : xv[i] * xv[i];
  }
  float mu = 0.f, var;
  if (LN) {
    mu = block_sum(acc) / d;
    float sq = 0.f;
    for (int j = threadIdx.x; j < nv; j += blockDim.x) {
      float xv[VEC];
      load<T, VEC>(xr + j * VEC, xv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) sq += (xv[i] - mu) * (xv[i] - mu);
    }
    var = block_sum(sq) / d;
  } else {
    var = block_sum(acc) / d;
  }
  const float rstd = rsqrtf(var + eps);
  const T* ar = a1 + row * d;
  T* yr = y + row * d;
  for (int j = threadIdx.x; j < nv; j += blockDim.x) {
    float xv[VEC], av[VEC], out[VEC];
    load<T, VEC>(xr + j * VEC, xv);
    load<T, VEC>(ar + j * VEC, av);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = j * VEC + i;
      const float n = LN ? (xv[i] - mu) * rstd * scale[c] + bias[c]
                         : xv[i] * rstd * scale[c];
      out[i] = n + av[i];
    }
    store<T, VEC>(yr + j * VEC, out);
  }
  if (threadIdx.x == 0) {
    rstd_out[row] = rstd;
    mean_out[row] = mu;
  }
}

// Partial sums of dy * xhat (and dy) over the rows of this block, then dx.
// Thread t owns the columns of vectors t, t + blockDim.x, ... in every row,
// so its shared-memory partials need no synchronisation.
template <typename T, int VEC, bool LN>
__global__ void __launch_bounds__(kMaxThreads)
ln_add_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                  const float* __restrict__ scale,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, T* __restrict__ dx,
                  float* __restrict__ part_scale,
                  float* __restrict__ part_bias, int rows, int d) {
  extern __shared__ float acc[];   // d for dscale, then d for dbias (LN)
  const int nv = d / VEC;
  for (int j = threadIdx.x; j < nv; j += blockDim.x)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      acc[j * VEC + i] = 0.f;
      if (LN) acc[d + j * VEC + i] = 0.f;
    }
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + (size_t)row * d;
    const T* gr = dy + (size_t)row * d;
    const float mu = LN ? mean[row] : 0.f, rs = rstd[row];
    float s_gx = 0.f, s_g = 0.f;
    for (int j = threadIdx.x; j < nv; j += blockDim.x) {
      float xv[VEC], gv[VEC];
      load<T, VEC>(xr + j * VEC, xv);
      load<T, VEC>(gr + j * VEC, gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int c = j * VEC + i;
        const float xh = (xv[i] - mu) * rs;
        const float g = gv[i] * scale[c];
        s_gx += g * xh;
        s_g += g;
        acc[c] += gv[i] * xh;
        if (LN) acc[d + c] += gv[i];
      }
    }
    const float m_gx = block_sum(s_gx) / d;
    const float m_g = LN ? block_sum(s_g) / d : 0.f;
    T* dr = dx + (size_t)row * d;
    for (int j = threadIdx.x; j < nv; j += blockDim.x) {
      float xv[VEC], gv[VEC], out[VEC];
      load<T, VEC>(xr + j * VEC, xv);
      load<T, VEC>(gr + j * VEC, gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int c = j * VEC + i;
        const float xh = (xv[i] - mu) * rs;
        out[i] = rs * (gv[i] * scale[c] - m_g - xh * m_gx);
      }
      store<T, VEC>(dr + j * VEC, out);
    }
  }
  for (int j = threadIdx.x; j < nv; j += blockDim.x)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = j * VEC + i;
      part_scale[(size_t)blockIdx.x * d + c] = acc[c];
      if (LN) part_bias[(size_t)blockIdx.x * d + c] = acc[d + c];
    }
}

// out[c] = sum over p < n of part[p, c], in order of p.
__global__ void column_sum_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int n, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int p = 0; p < n; ++p) s += part[(size_t)p * d + c];
  out[c] = s;
}

int threads_for(int nv) {
  const int t = (nv + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

template <typename T, int VEC>
int fwd(const void* x, const void* a1, const float* scale, const float* bias,
        void* y, float* mean, float* rstd, int rows, int d, int ln,
        float eps, cudaStream_t st) {
  const int threads = threads_for(d / VEC);
  const T* xt = static_cast<const T*>(x);
  const T* at = static_cast<const T*>(a1);
  if (ln)
    ln_add_fwd_kernel<T, VEC, true><<<rows, threads, 0, st>>>(
        xt, at, scale, bias, static_cast<T*>(y), mean, rstd, d, eps);
  else
    ln_add_fwd_kernel<T, VEC, false><<<rows, threads, 0, st>>>(
        xt, at, scale, bias, static_cast<T*>(y), mean, rstd, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int bwd(const void* dy, const void* x, const float* scale, const float* mean,
        const float* rstd, void* dx, float* dscale, float* dbias,
        float* part, int rows, int d, int ln, cudaStream_t st) {
  const int threads = threads_for(d / VEC);
  const int blocks = rows < kBwdBlocks ? rows : kBwdBlocks;
  const size_t smem = sizeof(float) * d * (ln ? 2 : 1);
  float* part_bias = part + (size_t)blocks * d;
  const T* gt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  cudaError_t err;
  if (ln) {
    err = cudaFuncSetAttribute(ln_add_bwd_kernel<T, VEC, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ln_add_bwd_kernel<T, VEC, true><<<blocks, threads, smem, st>>>(
        gt, xt, scale, mean, rstd, static_cast<T*>(dx), part, part_bias,
        rows, d);
  } else {
    err = cudaFuncSetAttribute(ln_add_bwd_kernel<T, VEC, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ln_add_bwd_kernel<T, VEC, false><<<blocks, threads, smem, st>>>(
        gt, xt, scale, mean, rstd, static_cast<T*>(dx), part, nullptr, rows,
        d);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cb = (d + 255) / 256;
  column_sum_kernel<<<cb, 256, 0, st>>>(part, dscale, blocks, d);
  if (ln) column_sum_kernel<<<cb, 256, 0, st>>>(part_bias, dbias, blocks, d);
  return static_cast<int>(cudaGetLastError());
}

// The widest vector (16 bytes) that d and every row pointer allow.
template <typename T>
int vec_for(int d, const void* const* ptrs, int n) {
  int vec = 16 / (int)sizeof(T);
  while (vec > 1) {
    bool ok = d % vec == 0;
    for (int i = 0; i < n && ok; ++i)
      ok = reinterpret_cast<uintptr_t>(ptrs[i]) % (vec * sizeof(T)) == 0;
    if (ok) break;
    vec /= 2;
  }
  return vec;
}

int check(int rows, int d, int device) {
  if (rows < 0 || d <= 0 || d > 8192) return -1;
  return static_cast<int>(cudaSetDevice(device));
}

}  // namespace

extern "C" {

// x, a1n (rows, d) -> y (rows, d) in the same dtype (bf16 when is_bf16,
// else fp32), mean and rstd (rows,) fp32.  kind 0 rmsnorm, 1 layernorm
// (bias (d,) fp32 then required).  Returns 0 on success, -1 for an
// argument the kernel does not take, else the cudaError_t of the launch.
int fused_ln_add_fwd(const void* x, const void* a1, const float* scale,
                     const float* bias, void* y, float* mean, float* rstd,
                     int rows, int d, int kind, float eps, int is_bf16,
                     int device, void* stream) {
  if (rows == 0) return 0;
  const int err = check(rows, d, device);
  if (err) return err;
  if (kind == 1 && bias == nullptr) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* ptrs[3] = {x, a1, y};
  if (is_bf16) {
    using T = __nv_bfloat16;
    switch (vec_for<T>(d, ptrs, 3)) {
      case 8: return fwd<T, 8>(x, a1, scale, bias, y, mean, rstd, rows, d, kind, eps, st);
      case 4: return fwd<T, 4>(x, a1, scale, bias, y, mean, rstd, rows, d, kind, eps, st);
      case 2: return fwd<T, 2>(x, a1, scale, bias, y, mean, rstd, rows, d, kind, eps, st);
      default: return fwd<T, 1>(x, a1, scale, bias, y, mean, rstd, rows, d, kind, eps, st);
    }
  }
  switch (vec_for<float>(d, ptrs, 3)) {
    case 4: return fwd<float, 4>(x, a1, scale, bias, y, mean, rstd, rows, d, kind, eps, st);
    case 2: return fwd<float, 2>(x, a1, scale, bias, y, mean, rstd, rows, d, kind, eps, st);
    default: return fwd<float, 1>(x, a1, scale, bias, y, mean, rstd, rows, d, kind, eps, st);
  }
}

// Rows of partial sums the backward's scratch needs: min(rows, 256); the
// scratch is that many (d,) fp32 rows, twice for layernorm.
int fused_ln_add_bwd_blocks(int rows) {
  return rows < kBwdBlocks ? rows : kBwdBlocks;
}

// dy, x (rows, d), scale (d,), mean and rstd from the forward -> dx (rows,
// d) in x's dtype, dscale (and, for layernorm, dbias) (d,) fp32.  part is
// the partials' scratch.  Two or three launches; no atomics.
int fused_ln_add_bwd(const void* dy, const void* x, const float* scale,
                     const float* mean, const float* rstd, void* dx,
                     float* dscale, float* dbias, float* part, int rows,
                     int d, int kind, int is_bf16, int device,
                     void* stream) {
  if (rows == 0) return 0;
  const int err = check(rows, d, device);
  if (err) return err;
  if (kind == 1 && dbias == nullptr) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* ptrs[3] = {dy, x, dx};
  if (is_bf16) {
    using T = __nv_bfloat16;
    switch (vec_for<T>(d, ptrs, 3)) {
      case 8: return bwd<T, 8>(dy, x, scale, mean, rstd, dx, dscale, dbias, part, rows, d, kind, st);
      case 4: return bwd<T, 4>(dy, x, scale, mean, rstd, dx, dscale, dbias, part, rows, d, kind, st);
      case 2: return bwd<T, 2>(dy, x, scale, mean, rstd, dx, dscale, dbias, part, rows, d, kind, st);
      default: return bwd<T, 1>(dy, x, scale, mean, rstd, dx, dscale, dbias, part, rows, d, kind, st);
    }
  }
  switch (vec_for<float>(d, ptrs, 3)) {
    case 4: return bwd<float, 4>(dy, x, scale, mean, rstd, dx, dscale, dbias, part, rows, d, kind, st);
    case 2: return bwd<float, 2>(dy, x, scale, mean, rstd, dx, dscale, dbias, part, rows, d, kind, st);
    default: return bwd<float, 1>(dy, x, scale, mean, rstd, dx, dscale, dbias, part, rows, d, kind, st);
  }
}

const char* fused_ln_add_error_string(int code) {
  if (code == -1) return "argument not supported by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
