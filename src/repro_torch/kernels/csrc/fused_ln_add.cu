// FAL's MLP-input fusion for Hopper (sm_90a): y = LN(x) * scale (+ bias)
// + a1n in one pass, and its backward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_ln_add.py:37
// (fused_ln_add, pallas_call :55, body _ln_add_kernel :24; oracle
// ref.py:178 ln_add_ref).  The TPU kernel tiles 256 rows with the whole
// feature dimension in VMEM; here a fixed group of threads owns a row.
//
// Layouts: x, a1n, y, dy, dx (rows, d) in one dtype (fp32 or bf16),
// row-major; scale, bias, dscale, dbias (d,) fp32; mean, rstd (rows,)
// fp32.  kind 0 is rmsnorm (x * rstd * scale), kind 1 layernorm
// ((x - mean) * rstd * scale + bias), both in fp32 with eps inside the
// root, as the reference computes them; y is rounded once to x's dtype.
//
// Forward: a row of nv 16-byte vectors (8 bf16 or 4 fp32 values where d
// and the pointers allow) belongs to a group of T threads, one warp while
// nv <= 32 kFwdWarpVecs, else 32 ceil(nv / (32 kFwdVecs)) (at most 512),
// thread t holding vectors t, t + T, ... (NV = ceil(nv / T) of them) in
// registers from the statistic to the output: the row is read from
// memory once.  Each thread first issues
// all its loads, x, a1n and the fp32 scale (and bias) as vectors, then
// sums its values in vector order, the warp adds its lanes in an xor
// butterfly, and the group adds its warps' sums in warp order after a
// named barrier of the group alone (no barrier at all when a row is one
// warp).  Layernorm takes the mean that way, then the mean square about
// it from the same registers, as the reference does.  A row's order
// depends only on nv (d, the dtype and the vector width), never on the
// row count: a block holds R rows (R groups, R a power of two, at most
// kFwdBlockThreads threads) only while that still leaves a block for
// every SM, and R does not touch a row's arithmetic.  mean and rstd are
// written only when the caller passes them (the autograd forward); the
// serving path passes none and y's bits are the same.
//
// Backward: dx per row from dy, x, scale and the saved statistics,
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat)),  g = dy * scale
// (rmsnorm drops the mean(g) term), then dscale = sum over rows of
// dy * xhat (and dbias = sum of dy).  A grid of two blocks an SM (fewer
// when the rows are fewer) takes rows in a fixed order, block i rows i, i +
// grid, ...; a block's threads own fixed 16-byte vectors of a row (NV
// each, a template parameter: at d = 3072 bf16 a row is 384 vectors, two a
// thread of 192), so a row's x and dy stay in registers from the
// statistic's pass to the dx pass; a block takes two rows a step (one
// block-wide sum for both) where a thread holds at most 16 values of a row,
// and loads the next step's rows while it reduces this one's; the
// scale is loaded once as vectors, and the dscale / dbias sums of a
// thread's columns stay in registers over all its rows, in row order.
// Each block writes them once, as one (d,) fp32 partial row.  A second
// kernel (a programmatic dependent of the first) sums the partial rows
// column by column over at least as many blocks as the card has SMs where
// d allows (16-byte column units of a few columns a block), in a fixed
// two-level order: each thread sums a strided set of partial rows in row
// order, then the block adds those sums in a fixed tree.  No atomics: the
// same bits on every run.  d(a1n) is dy itself (no launch; the wrapper
// returns it).
//
// What bounds it on this card: bytes.  The forward reads x and a1n and
// writes y (6 bytes a value in bf16, 12 in fp32); at (2048, 3072) bf16
// that is 37.7 MB, 0.011 ms at 3.35 TB/s, and at the serving tick's 263
// rows 4.8 MB, 0.0015 ms, where one round trip to memory a row and the
// launch are what is left; the backward reads x and dy and
// writes dx, the same bytes, plus its fp32 partial rows (3.2 MB at
// (2048, 3072) on 132 SMs), read back once.  Nothing is allocated (the
// wrapper passes the partials' scratch) and nothing synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kFwdWarpVecs = 3;      // vectors a thread of a one-warp row
constexpr int kFwdVecs = 2;          // vectors a thread of a wider row, aim
constexpr int kFwdMaxWarps = 16;     // warps of a forward row, at most
constexpr int kFwdBlockThreads = 256;  // threads of a many-row block, most
constexpr int kBwdPerSM = 2;       // backward blocks an SM, at most
constexpr int kRowsAStep = 2;      // rows a backward block reduces at once
constexpr int kSumThreads = 256;   // threads of a column-sum block

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

// Threads of the group that owns a row of nv vectors: one warp while it
// holds the row in kFwdWarpVecs vectors a thread (no barrier), else
// enough warps for kFwdVecs a thread, at most kFwdMaxWarps.
__host__ __device__ constexpr int fwd_row_threads(int nv) {
  if (nv <= 32 * kFwdWarpVecs) return 32;
  const int w = (nv + 32 * kFwdVecs - 1) / (32 * kFwdVecs);
  return 32 * (w < kFwdMaxWarps ? w : kFwdMaxWarps);
}

// Threads of a forward block, at most: R groups within kFwdBlockThreads,
// or one group of kFwdMaxWarps warps.
constexpr int kFwdBound = 32 * kFwdMaxWarps > kFwdBlockThreads
                              ? 32 * kFwdMaxWarps : kFwdBlockThreads;

// The sum of v over a group of W warps (every thread of the group gets
// the same bits): an xor butterfly in each warp, then the warps' sums in
// warp order from red[0..W) after the group's named barrier `bar`.
__device__ __forceinline__ float group_sum(float v, float* red, int t, int W,
                                           int bar) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (W == 1) return v;
  if ((t & 31) == 0) red[t >> 5] = v;
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(32 * W) : "memory");
  float s = red[0];
  for (int w = 1; w < W; ++w) s += red[w];
  return s;
}

template <typename T, int VEC, int NV, bool LN>
__global__ void __launch_bounds__(kFwdBound)
ln_add_fwd_kernel(const T* __restrict__ x, const T* __restrict__ a1,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  int rows, int d, float eps) {
  // one slot a warp of the block for each of the two sums
  __shared__ float red[2][32];
  const int nv = d / VEC;
  const int RT = fwd_row_threads(nv), W = RT / 32;
  const int g = threadIdx.x / RT, t = threadIdx.x - g * RT;
  const int row = blockIdx.x * (blockDim.x / RT) + g;
  if (row >= rows) return;                 // the whole group leaves
  using PT = Pack<T, VEC>;
  using PF = Pack<float, VEC>;
  const PT* xr = reinterpret_cast<const PT*>(x + (size_t)row * d);
  const PT* ar = reinterpret_cast<const PT*>(a1 + (size_t)row * d);
  PT xv[NV], av[NV];
  PF sv[NV], bv[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = t + k * RT;
    if (j < nv) {
      xv[k] = xr[j];
      av[k] = ar[j];
      sv[k] = reinterpret_cast<const PF*>(scale)[j];
      if (LN) bv[k] = reinterpret_cast<const PF*>(bias)[j];
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (t + k * RT < nv)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float v = to_f(xv[k].v[i]);
        acc = LN ? acc + v : fmaf(v, v, acc);
      }
  const int bar = 1 + g;                   // 0 is __syncthreads'
  const float s = group_sum(acc, red[0] + g * W, t, W, bar);
  float mu = 0.f, var;
  if (LN) {
    mu = s / d;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (t + k * RT < nv)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float c = to_f(xv[k].v[i]) - mu;
          sq = fmaf(c, c, sq);
        }
    var = group_sum(sq, red[1] + g * W, t, W, bar) / d;
  } else {
    var = s / d;
  }
  const float rstd = rsqrtf(var + eps);
  PT* yr = reinterpret_cast<PT*>(y + (size_t)row * d);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = t + k * RT;
    if (j < nv) {
      PT o;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float v = to_f(xv[k].v[i]);
        const float n = LN ? fmaf((v - mu) * rstd, sv[k].v[i], bv[k].v[i])
                           : v * rstd * sv[k].v[i];
        o.v[i] = from_f<T>(n + to_f(av[k].v[i]));
      }
      yr[j] = o;
    }
  }
  if (mean_out != nullptr && t == 0) {
    mean_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// Sums over the block of each of v[0..N) (blockDim.x a multiple of 32),
// in a fixed order; every thread gets them.
template <int N>
__device__ __forceinline__ void block_sums(float (&v)[N]) {
  __shared__ float red[N][32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  const int wp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();                 // red is free from the last call
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) red[i][wp] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = lane < (int)(blockDim.x / 32) ? red[i][lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
}

// Threads of a backward block, at most: 256, or, with NV = 8 vectors a
// thread (rows of more than 2048 vectors: d > 2048 at one element a
// vector, > 4096 at two), the d <= 8192 of the widest row.
template <int VEC, int NV>
constexpr int bwd_bound() {
  return NV < 8 ? kMaxThreads : 8192 / (VEC * NV);
}

// A thread's NV vectors of one row (vector j = threadIdx.x + k blockDim.x,
// k < NV; those at or past nv are not read), and the row's statistics.
template <typename T, int VEC, int NV>
struct RowRegs {
  Pack<T, VEC> x[NV], g[NV];
  float mu, rs;
};

template <typename T, int VEC, int NV, bool LN>
__device__ __forceinline__ void load_row(RowRegs<T, VEC, NV>& r,
                                         const T* __restrict__ x,
                                         const T* __restrict__ dy,
                                         const float* __restrict__ mean,
                                         const float* __restrict__ rstd,
                                         int row, int rows, int nv, int d) {
  if (row >= rows) return;
  const T* xr = x + (size_t)row * d;
  const T* gr = dy + (size_t)row * d;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < nv) {
      r.x[k] = reinterpret_cast<const Pack<T, VEC>*>(xr)[j];
      r.g[k] = reinterpret_cast<const Pack<T, VEC>*>(gr)[j];
    }
  }
  r.mu = LN ? mean[row] : 0.f;
  r.rs = rstd[row];
}

// Rows of a backward step: R of the block's rows are reduced together (one
// block-wide sum for all of them) where a thread holds at most 16 values of
// a row in fewer than 8 vectors; wider shares take one row at a time.
template <int VEC, int NV>
__host__ __device__ constexpr int rows_a_step() {
  return NV < 8 && NV * VEC <= 16 ? kRowsAStep : 1;
}

// dx of rows blockIdx.x, blockIdx.x + gridDim.x, ..., and this block's
// partial row of dscale (and dbias) over them, summed in that row order.
// A step takes R of those rows; the next step's are loaded while this one
// is reduced, except at 8 vectors a thread (rows wider than 2048
// vectors), whose registers would spill.
template <typename T, int VEC, int NV, bool LN>
__global__ void __launch_bounds__(bwd_bound<VEC, NV>())
ln_add_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                  const float* __restrict__ scale,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, T* __restrict__ dx,
                  float* __restrict__ part_scale,
                  float* __restrict__ part_bias, int rows, int d) {
  constexpr int R = rows_a_step<VEC, NV>();
  constexpr bool kAhead = NV < 8;
  constexpr int S = LN ? 2 : 1;        // sums a row: g xhat (and g)
  sm90::launch_dependents();           // the column sums may start now
  const int nv = d / VEC;
  const int G = gridDim.x;
  float sc[NV][VEC], ds[NV][VEC], db[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    Pack<float, VEC> s{};
    if (j < nv) s = reinterpret_cast<const Pack<float, VEC>*>(scale)[j];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sc[k][i] = s.v[i];
      ds[k][i] = 0.f;
      db[k][i] = 0.f;
    }
  }
  RowRegs<T, VEC, NV> cur[R];
#pragma unroll
  for (int t = 0; t < R; ++t)
    load_row<T, VEC, NV, LN>(cur[t], x, dy, mean, rstd, blockIdx.x + t * G,
                             rows, nv, d);
  for (int base = blockIdx.x; base < rows; base += R * G) {
    RowRegs<T, VEC, NV> nxt[R];
    if (kAhead)
#pragma unroll
      for (int t = 0; t < R; ++t)
        load_row<T, VEC, NV, LN>(nxt[t], x, dy, mean, rstd,
                                 base + (R + t) * G, rows, nv, d);
    float sums[R * S];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      float s_gx = 0.f, s_g = 0.f;
      if (base + t * G < rows) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          if (threadIdx.x + k * blockDim.x < nv) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              const float gv = to_f(cur[t].g[k].v[i]);
              const float xh =
                  (to_f(cur[t].x[k].v[i]) - cur[t].mu) * cur[t].rs;
              const float g = gv * sc[k][i];
              s_gx += g * xh;
              s_g += g;
              ds[k][i] += gv * xh;
              if (LN) db[k][i] += gv;
            }
          }
        }
      }
      sums[S * t] = s_gx;
      if (LN) sums[S * t + S - 1] = s_g;
    }
    block_sums<R * S>(sums);
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int row = base + t * G;
      const float m_gx = sums[S * t] / d;
      const float m_g = LN ? sums[S * t + S - 1] / d : 0.f;
      T* dr = dx + (size_t)row * d;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int j = threadIdx.x + k * blockDim.x;
        if (row < rows && j < nv) {
          Pack<T, VEC> o;
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float xh =
                (to_f(cur[t].x[k].v[i]) - cur[t].mu) * cur[t].rs;
            o.v[i] = from_f<T>(cur[t].rs *
                               (to_f(cur[t].g[k].v[i]) * sc[k][i] - m_g -
                                xh * m_gx));
          }
          reinterpret_cast<Pack<T, VEC>*>(dr)[j] = o;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < R; ++t) {
      if (kAhead)
        cur[t] = nxt[t];
      else
        load_row<T, VEC, NV, LN>(cur[t], x, dy, mean, rstd,
                                 base + (R + t) * G, rows, nv, d);
    }
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < nv) {
      Pack<float, VEC> a, c;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        a.v[i] = ds[k][i];
        c.v[i] = db[k][i];
      }
      reinterpret_cast<Pack<float, VEC>*>(part_scale +
                                          (size_t)blockIdx.x * d)[j] = a;
      if (LN)
        reinterpret_cast<Pack<float, VEC>*>(part_bias +
                                            (size_t)blockIdx.x * d)[j] = c;
    }
  }
}

// out[c] = the sum over p < n of part[p, c] for the CU column units (U
// columns each) of block x; blockIdx.y picks (part, out) or (part2, out2).
// Thread t = rg * CU + cu sums rows rg, rg + RG, ... (RG = kSumThreads /
// CU) of unit cu in row order; the block then adds the RG sums in a fixed
// tree (RG a power of two).
template <int U>
__global__ void __launch_bounds__(kSumThreads)
column_sum_kernel(const float* __restrict__ part,
                  const float* __restrict__ part2, float* __restrict__ out,
                  float* __restrict__ out2, int n, int d, int CU) {
  using V = Pack<float, U>;
  __shared__ V red[kSumThreads];
  sm90::grid_dependency_wait();        // the backward's partial rows
  const float* src = blockIdx.y ? part2 : part;
  float* dst = blockIdx.y ? out2 : out;
  const int RG = kSumThreads / CU;
  const int cu = threadIdx.x % CU, rg = threadIdx.x / CU;
  const int c = (blockIdx.x * CU + cu) * U;     // first column of the unit
  V s{};
  if (c < d)
#pragma unroll 4
    for (int p = rg; p < n; p += RG) {
      const V v = *reinterpret_cast<const V*>(src + (size_t)p * d + c);
#pragma unroll
      for (int i = 0; i < U; ++i) s.v[i] += v.v[i];
    }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = RG / 2; h > 0; h >>= 1) {
    if (rg < h) {
      const V v = red[threadIdx.x + h * CU];
#pragma unroll
      for (int i = 0; i < U; ++i) s.v[i] += v.v[i];
      red[threadIdx.x] = s;
    }
    __syncthreads();
  }
  if (rg == 0 && c < d) *reinterpret_cast<V*>(dst + c) = s;
}

template <typename T, int VEC, bool LN, int NV>
int fwd_rows(const T* x, const T* a1, const float* scale, const float* bias,
             T* y, float* mean, float* rstd, int rows, int d, float eps,
             int blocks, int threads, cudaStream_t st) {
  ln_add_fwd_kernel<T, VEC, NV, LN><<<blocks, threads, 0, st>>>(
      x, a1, scale, bias, y, mean, rstd, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

// R rows a block (a power of two) while R groups fit kFwdBlockThreads and
// the blocks still number at least the SMs; then NV from the row's width.
template <typename T, int VEC, bool LN>
int fwd(const void* x, const void* a1, const float* scale, const float* bias,
        void* y, float* mean, float* rstd, int rows, int d, float eps,
        int sms, cudaStream_t st) {
  const int nv = d / VEC, rt = fwd_row_threads(nv);
  int R = 1;
  while (2 * R * rt <= kFwdBlockThreads && (rows + 2 * R - 1) / (2 * R) >= sms)
    R *= 2;
  const int blocks = (rows + R - 1) / R, threads = R * rt;
  const T* xt = static_cast<const T*>(x);
  const T* at = static_cast<const T*>(a1);
  T* yt = static_cast<T*>(y);
  const int per = (nv + rt - 1) / rt;
  if (per == 1) return fwd_rows<T, VEC, LN, 1>(xt, at, scale, bias, yt, mean, rstd, rows, d, eps, blocks, threads, st);
  if (per == 2) return fwd_rows<T, VEC, LN, 2>(xt, at, scale, bias, yt, mean, rstd, rows, d, eps, blocks, threads, st);
  if (per == 3) return fwd_rows<T, VEC, LN, 3>(xt, at, scale, bias, yt, mean, rstd, rows, d, eps, blocks, threads, st);
  // more than 3 vectors a thread only in rows of more than 1024 vectors
  // (kFwdMaxWarps warps of kFwdVecs): up to 4 in four-value vectors (d <=
  // 8192), 8 in two-value ones, 16 in one-value ones
  if constexpr (VEC <= 4)
    if (per <= 4) return fwd_rows<T, VEC, LN, 4>(xt, at, scale, bias, yt, mean, rstd, rows, d, eps, blocks, threads, st);
  if constexpr (VEC <= 2)
    if (per <= 8) return fwd_rows<T, VEC, LN, 8>(xt, at, scale, bias, yt, mean, rstd, rows, d, eps, blocks, threads, st);
  if constexpr (VEC == 1)
    return fwd_rows<T, VEC, LN, 16>(xt, at, scale, bias, yt, mean, rstd, rows, d, eps, blocks, threads, st);
  return -1;
}

template <typename T, int VEC>
int fwd_kind(const void* x, const void* a1, const float* scale,
             const float* bias, void* y, float* mean, float* rstd, int rows,
             int d, int ln, float eps, int sms, cudaStream_t st) {
  return ln ? fwd<T, VEC, true>(x, a1, scale, bias, y, mean, rstd, rows, d,
                                eps, sms, st)
            : fwd<T, VEC, false>(x, a1, scale, bias, y, mean, rstd, rows, d,
                                 eps, sms, st);
}

inline bool misaligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

// Backward blocks for `rows` rows: kBwdPerSM an SM of `sms`, at most one a
// row.
int bwd_blocks(int rows, int sms) {
  const int cap = kBwdPerSM * sms;
  return rows < cap ? rows : cap;
}

int sm_count(int device, int* sms) {
  return static_cast<int>(cudaDeviceGetAttribute(
      sms, cudaDevAttrMultiProcessorCount, device));
}

// Vectors a thread: the fewest of 1, 2, 4 and 8 that keep a row of nv
// vectors within kMaxThreads threads, else 8.
int vectors_per_thread(int nv) {
  int k = 1;
  while (k < 8 && (nv + k - 1) / k > kMaxThreads) k *= 2;
  return k;
}

template <typename T, int VEC, int NV>
void bwd_rows(const T* dy, const T* x, const float* scale, const float* mean,
              const float* rstd, T* dx, float* part, float* part_bias,
              int rows, int d, int ln, int blocks, int threads,
              cudaStream_t st) {
  if (ln)
    ln_add_bwd_kernel<T, VEC, NV, true><<<blocks, threads, 0, st>>>(
        dy, x, scale, mean, rstd, dx, part, part_bias, rows, d);
  else
    ln_add_bwd_kernel<T, VEC, NV, false><<<blocks, threads, 0, st>>>(
        dy, x, scale, mean, rstd, dx, part, nullptr, rows, d);
}

template <typename T, int VEC>
int bwd(const void* dy, const void* x, const float* scale, const float* mean,
        const float* rstd, void* dx, float* dscale, float* dbias,
        float* part, int rows, int d, int ln, int sms, cudaStream_t st) {
  const int blocks = bwd_blocks(rows, sms);
  const int nv = d / VEC, nvt = vectors_per_thread(nv);
  const int threads = ((nv + nvt - 1) / nvt + 31) / 32 * 32;
  float* part_bias = ln ? part + (size_t)blocks * d : nullptr;
  const T* gt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  T* dt = static_cast<T*>(dx);
  switch (nvt) {
    case 1:
      bwd_rows<T, VEC, 1>(gt, xt, scale, mean, rstd, dt, part, part_bias,
                          rows, d, ln, blocks, threads, st);
      break;
    case 2:
      bwd_rows<T, VEC, 2>(gt, xt, scale, mean, rstd, dt, part, part_bias,
                          rows, d, ln, blocks, threads, st);
      break;
    case 4:
      bwd_rows<T, VEC, 4>(gt, xt, scale, mean, rstd, dt, part, part_bias,
                          rows, d, ln, blocks, threads, st);
      break;
    default:
      // 8 vectors a thread only for rows of more than 2048 vectors, which
      // 16-byte vectors of d <= 8192 bf16 values never make
      if constexpr (VEC < 8)
        bwd_rows<T, VEC, 8>(gt, xt, scale, mean, rstd, dt, part, part_bias,
                            rows, d, ln, blocks, threads, st);
      else
        return -1;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the column sums: 16-byte units where d and the buffers allow; CU units
  // a block, the most (up to 32) that still give at least `sms` blocks
  const bool wide = d % 4 == 0 && !misaligned(part, 16) &&
                    !misaligned(dscale, 16) &&
                    (!ln || !misaligned(dbias, 16));
  const int U = wide ? 4 : 1;
  int CU = 1;
  while (CU < 32 && (d + 2 * U * CU - 1) / (2 * U * CU) >= sms) CU *= 2;
  const dim3 grid((d + U * CU - 1) / (U * CU), ln ? 2 : 1);
  const float* pb = part_bias;
  err = wide ? sm90::launch_dependent(column_sum_kernel<4>, grid,
                                      dim3(kSumThreads), 0, st,
                                      static_cast<const float*>(part), pb,
                                      dscale, dbias, blocks, d, CU)
             : sm90::launch_dependent(column_sum_kernel<1>, grid,
                                      dim3(kSumThreads), 0, st,
                                      static_cast<const float*>(part), pb,
                                      dscale, dbias, blocks, d, CU);
  return static_cast<int>(err);
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

// The widest of vec and its halves at which the fp32 (d,) vectors at p and
// (when given) q are read as vectors of that width.
int fp32_vec(int vec, const void* p, const void* q) {
  while (vec > 1 && (misaligned(p, 4 * vec) || (q && misaligned(q, 4 * vec))))
    vec /= 2;
  return vec;
}

int check(int rows, int d, int device) {
  if (rows < 0 || d <= 0 || d > 8192) return -1;
  return static_cast<int>(cudaSetDevice(device));
}

}  // namespace

extern "C" {

// x, a1n (rows, d) -> y (rows, d) in the same dtype (bf16 when is_bf16,
// else fp32) and, when mean and rstd are given, the rows' statistics
// (rows,) fp32 (both or neither).  kind 0 rmsnorm, 1 layernorm (bias (d,)
// fp32 then required).  Returns 0 on success, -1 for an argument the
// kernel does not take, else the cudaError_t of the launch.
int fused_ln_add_fwd(const void* x, const void* a1, const float* scale,
                     const float* bias, void* y, float* mean, float* rstd,
                     int rows, int d, int kind, float eps, int is_bf16,
                     int device, void* stream) {
  if (rows == 0) return 0;
  int err = check(rows, d, device);
  if (err) return err;
  if ((kind == 1 && bias == nullptr) || (mean == nullptr) != (rstd == nullptr))
    return -1;
  int sms = 0;
  err = sm_count(device, &sms);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* ptrs[3] = {x, a1, y};
  const float* b = kind == 1 ? bias : nullptr;
  if (is_bf16) {
    using T = __nv_bfloat16;
    switch (fp32_vec(vec_for<T>(d, ptrs, 3), scale, b)) {
      case 8: return fwd_kind<T, 8>(x, a1, scale, b, y, mean, rstd, rows, d, kind, eps, sms, st);
      case 4: return fwd_kind<T, 4>(x, a1, scale, b, y, mean, rstd, rows, d, kind, eps, sms, st);
      case 2: return fwd_kind<T, 2>(x, a1, scale, b, y, mean, rstd, rows, d, kind, eps, sms, st);
      default: return fwd_kind<T, 1>(x, a1, scale, b, y, mean, rstd, rows, d, kind, eps, sms, st);
    }
  }
  switch (fp32_vec(vec_for<float>(d, ptrs, 3), scale, b)) {
    case 4: return fwd_kind<float, 4>(x, a1, scale, b, y, mean, rstd, rows, d, kind, eps, sms, st);
    case 2: return fwd_kind<float, 2>(x, a1, scale, b, y, mean, rstd, rows, d, kind, eps, sms, st);
    default: return fwd_kind<float, 1>(x, a1, scale, b, y, mean, rstd, rows, d, kind, eps, sms, st);
  }
}

// Rows of partial sums the backward's scratch needs on `device`: its grid,
// two blocks an SM, at most one a row (min(rows, 2 SMs)); the scratch is
// that many (d,) fp32 rows, twice for layernorm.  -1 if the device cannot
// be queried.
int fused_ln_add_bwd_blocks(int rows, int device) {
  int sms = 0;
  if (sm_count(device, &sms) != 0 || sms <= 0) return -1;
  return bwd_blocks(rows, sms);
}

// dy, x (rows, d), scale (d,), mean and rstd from the forward -> dx (rows,
// d) in x's dtype, dscale (and, for layernorm, dbias) (d,) fp32.  part is
// the partials' scratch (fused_ln_add_bwd_blocks rows, twice for
// layernorm).  Two launches; no atomics.
int fused_ln_add_bwd(const void* dy, const void* x, const float* scale,
                     const float* mean, const float* rstd, void* dx,
                     float* dscale, float* dbias, float* part, int rows,
                     int d, int kind, int is_bf16, int device,
                     void* stream) {
  if (rows == 0) return 0;
  int err = check(rows, d, device);
  if (err) return err;
  if (kind == 1 && dbias == nullptr) return -1;
  int sms = 0;
  err = sm_count(device, &sms);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* ptrs[3] = {dy, x, dx};
  // the scale and the partial rows are read and written as fp32 vectors of
  // the rows' vector width
  auto vec_of = [&](int vec) { return fp32_vec(vec, scale, part); };
  if (is_bf16) {
    using T = __nv_bfloat16;
    switch (vec_of(vec_for<T>(d, ptrs, 3))) {
      case 8: return bwd<T, 8>(dy, x, scale, mean, rstd, dx, dscale, dbias, part, rows, d, kind, sms, st);
      case 4: return bwd<T, 4>(dy, x, scale, mean, rstd, dx, dscale, dbias, part, rows, d, kind, sms, st);
      case 2: return bwd<T, 2>(dy, x, scale, mean, rstd, dx, dscale, dbias, part, rows, d, kind, sms, st);
      default: return bwd<T, 1>(dy, x, scale, mean, rstd, dx, dscale, dbias, part, rows, d, kind, sms, st);
    }
  }
  switch (vec_of(vec_for<float>(d, ptrs, 3))) {
    case 4: return bwd<float, 4>(dy, x, scale, mean, rstd, dx, dscale, dbias, part, rows, d, kind, sms, st);
    case 2: return bwd<float, 2>(dy, x, scale, mean, rstd, dx, dscale, dbias, part, rows, d, kind, sms, st);
    default: return bwd<float, 1>(dy, x, scale, mean, rstd, dx, dscale, dbias, part, rows, d, kind, sms, st);
  }
}

const char* fused_ln_add_error_string(int code) {
  if (code == -1) return "argument not supported by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
