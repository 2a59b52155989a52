// Causal GQA flash attention for Hopper (sm_90a): the forward (with the row
// log-sum-exp) and a deterministic backward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:76
// (flash_attention, pallas_call :108, body _flash_kernel :24).  The TPU
// kernel walks the KV blocks as the sequential minor grid axis with the
// running max / sum / accumulator in VMEM scratch; here the walk is a loop
// inside one thread block, and nothing carries over between blocks.  The
// plain version is src/repro_torch/models/attention.py blockwise_attention
// (the reference's src/repro/models/attention.py:21).
//
// Layouts: q (B, Sq, H, D); k, v (B, Sk, Hkv, D); o and the gradients in
// the inputs' layouts and dtype (fp32 or bf16); lse and delta (B, H, Sq)
// fp32.  Query head h reads KV head h / (H / Hkv); K and V are never
// repeated.  Causal alignment is at the start, as blockwise_attention's
// (key j is visible to query row i when j <= q_offset + i), not at the end
// as ref.attention_ref's.  Any Sq and Sk (the tails are masked), D in
// {32, 64, 128}.
//
// gemma2's options, which the TPU kernel does not take (the reference runs
// them in blockwise_attention, src/repro/models/attention.py:21-66): a
// sliding window (window > 0: row i also sees only keys > q_offset + i -
// window) and a logit softcap (cap > 0: the scaled score s becomes
// tanhf(s / cap) * cap in fp32 before the mask and the running max; lse is
// over the capped scores).  Under a window a query block loads no key tile
// wholly below its first row's window, and a dK/dV block walks the query
// tiles only up to the last row that sees its last key; only edge tiles are
// masked.  The backward recomputes t = tanhf(s / cap) and scales dS by
// 1 - t^2 before dS is rounded for the dQ and dK products.  The softcap is
// a template parameter (kCap): without it the kernels are the same code as
// before it existed, and window <= 0 leaves every tile range as it was.
// The cap costs one accurate tanhf (not tanh.approx, ~2^-11 relative) for
// each visible pair, in both passes.
//
// Two sets of kernels, chosen by dtype (not a fallback: each dtype has one):
//
// bf16 (namespace tc): the products on the tensor cores.  Every kernel is
// one block of three warpgroups: warpgroups 0 and 1 run wgmma (m64nNk16,
// fp32 accumulators in registers, setmaxnreg 232); warpgroup 2 is the
// producer, whose first warp brings the tiles in by TMA (128B-swizzled
// bf16, 64B for D = 32) into a ring of three shared-memory stages with
// full / empty mbarriers, on 40 registers.  The block's own tile is loaded
// once.  P and dS are rounded to bf16 in registers, where they are the A
// operands of the next products.
//   forward: one block per (128-row query tile, head, batch), 64 rows a
//     consumer warpgroup, the heaviest causal tiles launched first.  K/V
//     tiles of 64 keys; S = Q K^T with A and B from shared memory; the
//     online softmax in registers (a row of the accumulator lies in the 4
//     threads of a quad: quad shuffles), in exp2 with the scale folded in;
//     O += P V with V from shared memory, MN-major.  Key tiles past the
//     causal diagonal are never loaded; only edge tiles are masked.  O is
//     written in bf16 and lse in fp32.
//   backward, three launches, no atomics (the same bits on every run):
//     delta = rowsum(dO * O); dK/dV: one block per (64-key tile, KV head,
//     batch) walking the G query heads and the 64-row query tiles from the
//     causal start (Q, dO by TMA, lse and delta by the producer warp's
//     lanes); warpgroup 0 forms S^T = K Q^T, P^T = exp(scale S^T - lse) and
//     dV += P^T dO, and hands the bf16 P^T to warpgroup 1 through shared
//     memory, which forms dP^T = V dO^T, dS^T = P^T (dP^T - delta) and
//     dK += dS^T Q (one 64 x D accumulator a warpgroup: no spills at
//     D = 128); dQ: one block per (128-row query tile, head, batch) walking
//     64-key K/V tiles up to the causal end, S, P, dP, dS, dQ += dS K.
//     That is 7 products where the bound counts 5: the price of
//     determinism (S and dP are formed in both backward kernels).
//
// fp32 (the CUDA-core kernels): one block per 64-row tile, the
// products on the CUDA cores in fp32 out of fp32 shared-memory copies.
// The fp32 train-step check against the CPU needs fp32 products; TF32
// would keep only about three decimal digits.
//
// What bounds it on this card: operations.  A causal forward at
// llama3.2-3b (S = 2048, H = 24, D = 128) is 25.8 GFLOP; at the tensor
// cores' 989 TFLOP/s that is 0.026 ms; the backward 2.5x that.  The bf16
// kernels wait for each product before using it (no overlap of softmax and
// products within a warpgroup; the two consumer warpgroups interleave on
// the SM).  Nothing is allocated (the wrapper passes delta's scratch) and
// nothing synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kB = 64;           // query rows per block and keys per tile
constexpr int kLdP = kB + 1;     // padded row of a 64 x 64 score tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// Rows [r0, r0 + kB) of one head of a (.., S, heads, D) tensor into a
// kB x (D + 1) fp32 tile; rows at or past S are zero.  ``base`` points at
// sequence row 0 of the head; rows are ``stride`` elements apart.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int r0,
                                          int S, size_t stride) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int s = r0 + r;
    dst[r * LD + d] = s < S ? to_f(base[(size_t)s * stride + d]) : 0.f;
  }
}

// Rows of a (B, H, Sq) fp32 vector for one query block; 0 past Sq.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int q0, int Sq) {
  if (threadIdx.x < kB) {
    const int r = q0 + threadIdx.x;
    dst[threadIdx.x] = r < Sq ? src[r] : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Last key (exclusive) that any row of the query block [q0, q0 + kB) sees.
__device__ __forceinline__ int key_end(int q0, int Sq, int Sk, int causal,
                                       int q_offset) {
  if (!causal) return Sk;
  return min(Sk, q_offset + min(q0 + kB, Sq));
}

// First key that any row of a query block starting at row q0 sees: under a
// sliding window (window > 0) row r sees keys > q_offset + r - window, so
// the block's first row bounds it; 0 without a window.
__device__ __forceinline__ int key_begin(int q0, int window, int q_offset) {
  return window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
}

// Last query row (exclusive) that sees any key of a key block whose last
// key is k_last: row r sees key j only while q_offset + r < j + window;
// Sq without a window.
__device__ __forceinline__ int query_end(int k_last, int Sq, int window,
                                         int q_offset) {
  return window > 0 ? min(Sq, max(0, k_last + window - q_offset)) : Sq;
}

// Whether key j lies inside the window of the query at position qpos.
__device__ __forceinline__ bool in_window(int key, int qpos, int window) {
  return window <= 0 || key > qpos - window;
}

// Thread layout of a 64 x 64 tile: ty = tid / 16 owns rows ty + 16 i,
// tx = tid % 16 owns columns tx + 16 j (i, j < 4).  The 16 threads of one
// ty share a half warp, so a row's reductions are half-warp shuffles.
//
// Under a softcap (kCap) the scaled score s becomes tanhf(s / cap) * cap
// before the mask and the softmax (tanhf, not tanh.approx: the fp32 gate is
// 1e-4).
template <typename T, int D, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                 float scale, int causal, int q_offset, int window,
                 float cap) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kB * LD;
  float* Vs = Ks + kB * LD;
  float* Ps = Vs + kB * LD;
  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qb = q + ((size_t)b * Sq * H + h) * D;
  const T* kb = k + ((size_t)b * Sk * Hkv + hk) * D;
  const T* vb = v + ((size_t)b * Sk * Hkv + hk) * D;

  load_tile<T, D>(Qs, qb, q0, Sq, (size_t)H * D);
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const int n_tiles = (key_end(q0, Sq, Sk, causal, q_offset) + kB - 1) / kB;
  for (int t = key_begin(q0, window, q_offset) / kB; t < n_tiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();                 // the last tile's reads are done
    load_tile<T, D>(Ks, kb, k0, Sk, (size_t)Hkv * D);
    load_tile<T, D>(Vs, vb, k0, Sk, (size_t)Hkv * D);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                        in_window(kpos, qpos, window);
        float x = s[i][j] * scale;
        if constexpr (kCap) x = tanhf(x / cap) * cap;
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == kNegInf ? 0.f : expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                 // the P tile is complete
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float vv[NC];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) vv[cc] = Vs[c * LD + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * kLdP + c];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) acc[i][cc] += p * vv[cc];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] * inv);
    if (tx == 0) lse[((size_t)b * H + h) * Sq + row] = m[i] + logf(l[i]);
  }
}

// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d]; one warp a row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ delta, int B, int Sq, int H) {
  const size_t row = (size_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (size_t)B * Sq * H) return;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc += to_f(dout[row * D + d]) * to_f(o[row * D + d]);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const size_t bs = row / H;
    const int s = (int)(bs % Sq), b = (int)(bs / Sq);
    delta[((size_t)b * H + h) * Sq + s] = acc;
  }
}

// dK, dV of one 64-key block of one KV head: ty owns keys ty + 16 i, tx
// owns query rows tx + 16 j of each query tile.
// Under a softcap dS is scaled by 1 - t^2, t = tanhf(s / cap) (tanh's
// derivative at the capped score).
template <typename T, int D, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
                  float scale, int causal, int q_offset, int window,
                  float cap) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * LD;
  float* Qs = Vs + kB * LD;
  float* Os = Qs + kB * LD;          // the dO tile
  float* Ps = Os + kB * LD;
  float* Ds = Ps + kB * kLdP;        // the dS tile
  float* Ls = Ds + kB * kLdP;        // lse of the query tile
  float* Es = Ls + kB;               // delta of the query tile
  const int k0 = blockIdx.x * kB, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_tile<T, D>(Ks, k + ((size_t)b * Sk * Hkv + hk) * D, k0, Sk,
                  (size_t)Hkv * D);
  load_tile<T, D>(Vs, v + ((size_t)b * Sk * Hkv + hk) * D, k0, Sk,
                  (size_t)Hkv * D);
  float adk[4][NC], adv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[i][c] = adv[i][c] = 0.f;
  // the first query row that sees key k0 is k0 - q_offset; under a window
  // the last one that sees the block's last key bounds the rows above
  const int q_lo = causal ? max(0, k0 - q_offset) : 0;
  const int n_qt =
      (query_end(min(k0 + kB, Sk) - 1, Sq, window, q_offset) + kB - 1) / kB;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* qb = q + ((size_t)b * Sq * H + h) * D;
    const T* ob = dout + ((size_t)b * Sq * H + h) * D;
    const float* lb = lse + ((size_t)b * H + h) * Sq;
    const float* eb = delta + ((size_t)b * H + h) * Sq;
    for (int t = q_lo / kB; t < n_qt; ++t) {
      const int q0 = t * kB;
      __syncthreads();               // the last tile's reads are done
      load_tile<T, D>(Qs, qb, q0, Sq, (size_t)H * D);
      load_tile<T, D>(Os, ob, q0, Sq, (size_t)H * D);
      load_rows(Ls, lb, q0, Sq);
      load_rows(Es, eb, q0, Sq);
      __syncthreads();
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty + 16 * i) * LD + d];
          vv[i] = Vs[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * LD + d];
          ov[j] = Os[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] += kv[i] * qv[j];
            dp[i][j] += vv[i] * ov[j];
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty + 16 * i;
        // the rows that see key kpos end at Sq or, under a window, at the
        // first row whose window has passed it (q_offset + row >= kpos +
        // window): one bound a key, so the row test costs what it did
        const int row_end =
            window > 0 ? min(Sq, kpos + window - q_offset) : Sq;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j, qrow = q0 + r;
          const bool ok = kpos < Sk && qrow < row_end &&
                          (!causal || kpos <= q_offset + qrow);
          if constexpr (kCap) {
            const float th = tanhf(s[i][j] * scale / cap);
            const float p = ok ? expf(th * cap - Ls[r]) : 0.f;
            Ps[(ty + 16 * i) * kLdP + r] = p;
            Ds[(ty + 16 * i) * kLdP + r] =
                p * (dp[i][j] - Es[r]) * (1.f - th * th);
          } else {
            const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
            Ps[(ty + 16 * i) * kLdP + r] = p;
            Ds[(ty + 16 * i) * kLdP + r] = p * (dp[i][j] - Es[r]);
          }
        }
      }
      __syncthreads();               // the P and dS tiles are complete
#pragma unroll 2
      for (int r = 0; r < kB; ++r) {
        float ov[NC], qv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          ov[c] = Os[r * LD + tx + 16 * c];
          qv[c] = Qs[r * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[(ty + 16 * i) * kLdP + r];
          const float ds = Ds[(ty + 16 * i) * kLdP + r];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            adv[i][c] += p * ov[c];
            adk[i][c] += ds * qv[c];
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= Sk) continue;
    const size_t off = (((size_t)b * Sk + kpos) * Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + tx + 16 * c] = from_f<T>(adk[i][c] * scale);
      dv[off + tx + 16 * c] = from_f<T>(adv[i][c]);
    }
  }
}

// dQ of one 64-row query block of one head: ty owns rows ty + 16 i, tx
// owns keys tx + 16 j of each key tile.
template <typename T, int D, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                int Sk, int H, int Hkv, float scale, int causal,
                int q_offset, int window, float cap) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + kB * LD;
  float* Ks = Os + kB * LD;
  float* Vs = Ks + kB * LD;
  float* Ds = Vs + kB * LD;
  float* Ls = Ds + kB * kLdP;
  float* Es = Ls + kB;
  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kb = k + ((size_t)b * Sk * Hkv + hk) * D;
  const T* vb = v + ((size_t)b * Sk * Hkv + hk) * D;
  load_tile<T, D>(Qs, q + ((size_t)b * Sq * H + h) * D, q0, Sq,
                  (size_t)H * D);
  load_tile<T, D>(Os, dout + ((size_t)b * Sq * H + h) * D, q0, Sq,
                  (size_t)H * D);
  load_rows(Ls, lse + ((size_t)b * H + h) * Sq, q0, Sq);
  load_rows(Es, delta + ((size_t)b * H + h) * Sq, q0, Sq);
  float adq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) adq[i][c] = 0.f;
  const int n_tiles = (key_end(q0, Sq, Sk, causal, q_offset) + kB - 1) / kB;
  for (int t = key_begin(q0, window, q_offset) / kB; t < n_tiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();
    load_tile<T, D>(Ks, kb, k0, Sk, (size_t)Hkv * D);
    load_tile<T, D>(Vs, vb, k0, Sk, (size_t)Hkv * D);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * LD + d];
        ov[i] = Os[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * LD + d];
        vv[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += ov[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qrow = q0 + r;
      // keys above key_lo: none for a row past Sq, else those inside the
      // row's window (all without one): one bound a row, so the key test
      // costs what the row test did
      const int key_lo = qrow >= Sq ? INT_MAX
                         : window > 0 ? q_offset + qrow - window : -1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < Sk && kpos > key_lo &&
                        (!causal || kpos <= q_offset + qrow);
        if constexpr (kCap) {
          const float th = tanhf(s[i][j] * scale / cap);
          const float p = ok ? expf(th * cap - Ls[r]) : 0.f;
          Ds[r * kLdP + tx + 16 * j] =
              p * (dp[i][j] - Es[r]) * (1.f - th * th);
        } else {
          const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
          Ds[r * kLdP + tx + 16 * j] = p * (dp[i][j] - Es[r]);
        }
      }
    }
    __syncthreads();                 // the dS tile is complete
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float kv[NC];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) kv[cc] = Ks[c * LD + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = Ds[(ty + 16 * i) * kLdP + c];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) adq[i][cc] += ds * kv[cc];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    T* drow = dq + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) drow[tx + 16 * c] = from_f<T>(adq[i][c] * scale);
  }
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kB * (D + 1) + kB * kLdP);
}
template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * kB * (D + 1) + 2 * kB * kLdP + 2 * kB);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kB * (D + 1) + kB * kLdP + 2 * kB);
}

struct Shape {
  int B, Sq, Sk, H, Hkv;
  float scale;
  int causal, q_offset;
  int window;   // <= 0: no sliding window
  float cap;    // 0: no logit softcap (the kCap = false kernels)
};

template <typename T, int D, bool kCap>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const Shape& s, cudaStream_t stream) {
  const size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, kCap>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.Sq + kB - 1) / kB, s.H, s.B);
  flash_fwd_kernel<T, D, kCap><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, s.Sq, s.Sk, s.H,
      s.Hkv, s.scale, s.causal, s.q_offset, s.window, s.cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kCap>
int bwd(const void* q, const void* k, const void* v, const void* o,
        const float* lse, const void* dout, void* dq, void* dk, void* dv,
        float* delta, const Shape& s, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const size_t rows = (size_t)s.B * s.Sq * s.H;
  const unsigned warps = kThreads / 32;
  flash_delta_kernel<T, D><<<(unsigned)((rows + warps - 1) / warps), kThreads,
                             0, stream>>>(static_cast<const T*>(o), dot,
                                          delta, s.B, s.Sq, s.H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  size_t smem = dkdv_smem<D>();
  err = cudaFuncSetAttribute(flash_dkdv_kernel<T, D, kCap>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dkdv_kernel<T, D, kCap>
      <<<dim3((s.Sk + kB - 1) / kB, s.Hkv, s.B), kThreads, smem, stream>>>(
          qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), s.Sq, s.Sk, s.H, s.Hkv, s.scale, s.causal,
          s.q_offset, s.window, s.cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  smem = dq_smem<D>();
  err = cudaFuncSetAttribute(flash_dq_kernel<T, D, kCap>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dq_kernel<T, D, kCap>
      <<<dim3((s.Sq + kB - 1) / kB, s.H, s.B), kThreads, smem, stream>>>(
          qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), s.Sq, s.Sk, s.H,
          s.Hkv, s.scale, s.causal, s.q_offset, s.window, s.cap);
  return static_cast<int>(cudaGetLastError());
}

// ===================================================================== //
// bf16: wgmma on the tensor cores, TMA-fed tiles, warp specialisation
// ===================================================================== //
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWG = 128;                 // threads of a warpgroup
constexpr int kThreadsTC = 3 * kWG;      // 2 consumer warpgroups + producer
constexpr int kRows = 128;   // forward, dQ: the block's query rows (64 a WG)
constexpr int kN = 64;       // rows of each streamed tile; dK/dV's key tile
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8;        // arrivals that free a stage
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kErrMap = -2;              // the driver refused a tensor map

// Tile layout, wgmma sequences and accumulator helpers shared with the
// paged kernels (sm90_common.cuh).
using sm90::align1024;
using sm90::gemm_over_d;
using sm90::gemm_over_rows;
using sm90::Geo;
using sm90::kmajor;
using sm90::mnmajor;
using sm90::quad_max;
using sm90::quad_sum;
using sm90::store_row;
using sm90::to_a;

// Rows row0 .. row0 + rows - 1 of one head of a (B, S, heads, D) tensor,
// one TMA box per column chunk, signalled to ``bar``.
template <int D>
__device__ __forceinline__ void load_rows(uint8_t* tile, int rows,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int head, int row0,
                                          int b) {
  using G = Geo<D>;
#pragma unroll
  for (int c = 0; c < G::kChunks; ++c)
    sm90::tma_load_4d(tile + c * G::chunk(rows), map, bar, c * G::kChunk,
                      head, row0, b);
}

// Producer / consumer ring over the streamed tiles: tile it uses stage
// it % kStages; the consumer waits for the full phase of parity
// (it / kStages) & 1, the producer for the opposite empty phase (the first
// pass over the ring does not wait).
__device__ __forceinline__ int stage_of(int it) { return it % kStages; }
__device__ __forceinline__ uint32_t parity_of(int it) {
  return (it / kStages) & 1;
}

__device__ __forceinline__ void init_barriers(uint64_t* fixed,
                                              uint64_t* full,
                                              uint64_t* empty,
                                              uint32_t full_count) {
  if (threadIdx.x == 0) {
    sm90::mbar_init(fixed, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], full_count);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
}

// The forward's and dQ's block: query rows q0 .. q0 + kRows - 1 of head h
// (KV head hk), batch b, the tiles with the most keys launched first; it
// reads key tiles t0 .. n_tiles - 1: from the first tile its first row's
// window reaches (0 without a window) up to the causal end.
struct QueryBlock {
  int h, b, hk, q0, t0, n_tiles;
};
__device__ __forceinline__ QueryBlock query_block(int B, int Sq, int Sk,
                                                  int H, int Hkv, int causal,
                                                  int q_offset, int window) {
  const int n_qt = (Sq + kRows - 1) / kRows;
  const int per = H * B;
  const int qt = n_qt - 1 - (int)(blockIdx.x / per);   // heaviest first
  const int h = (int)(blockIdx.x % per) % H, b = (int)(blockIdx.x % per) / H;
  const int q0 = qt * kRows;
  const int key_end = causal ? min(Sk, q_offset + min(q0 + kRows, Sq)) : Sk;
  return {h, b, h / (H / Hkv), q0, key_begin(q0, window, q_offset) / kN,
          (key_end + kN - 1) / kN};
}

// The producer's loop of the forward and dQ: K and V tiles t0 .. n_tiles - 1
// of KV head hk through the ring (stage s holds K, then V); tile t is the
// ring's step t - t0.
template <int D>
__device__ __forceinline__ void stream_kv(uint8_t* KV, const CUtensorMap* tm_k,
                                          const CUtensorMap* tm_v,
                                          uint64_t* full, uint64_t* empty,
                                          int hk, int b, int t0, int n_tiles) {
  using G = Geo<D>;
  for (int t = t0; t < n_tiles; ++t) {
    const int s = stage_of(t - t0);
    uint8_t* Ks = KV + s * 2 * G::tile(kN);
    sm90::mbar_wait(&empty[s], parity_of(t - t0) ^ 1);
    sm90::mbar_arrive_expect_tx(&full[s], 2 * G::tile(kN));
    load_rows<D>(Ks, kN, tm_k, &full[s], hk, t * kN, b);
    load_rows<D>(Ks + G::tile(kN), kN, tm_v, &full[s], hk, t * kN, b);
  }
}

// Element (row0 + 8 i, col0 + 8 n + c2 + j) of this thread's m64n64
// accumulator fragment x[4 n + 2 i + j] becomes ``fill`` where
// keep(row, col) is false.
template <typename Keep>
__device__ __forceinline__ void mask_tile(float (&x)[kN / 2], int row0,
                                          int col0, int c2, float fill,
                                          Keep keep) {
#pragma unroll
  for (int n = 0; n < kN / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (!keep(row0 + 8 * i, col0 + 8 * n + c2 + j))
          x[4 * n + 2 * i + j] = fill;
}

// One block per SM: the consumers' setmaxnreg.inc takes the registers the
// producer gave back, and would wait for ever on registers held by a second
// block.  Asking for more than half the SM's 227 KB keeps a second block out.
constexpr size_t smem_floor(size_t bytes) {
  return bytes < 120 * 1024 ? 120 * 1024 : bytes;
}

template <int D>
constexpr size_t fwd_smem() {
  using G = Geo<D>;
  return smem_floor(1024 + G::tile(kRows) + kStages * 2 * G::tile(kN) +
         (1 + 2 * kStages) * 8);
}

// Under a softcap (kCap) a raw score x becomes the capped score in log2
// units, tanhf(x * scale / cap) * cap * log2(e) (soc = scale / cap,
// cap_log2 = cap log2(e)), before the mask and the running max; the
// softmax then runs on it with a unit multiplier, and lse comes out over
// the capped scores.
template <int D, bool kCap>
__global__ void __launch_bounds__(kThreadsTC, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
           float* __restrict__ lse, int B, int Sq, int Sk, int H, int Hkv,
           float scale_log2, int causal, int q_offset, int window, float soc,
           float cap_log2) {
  using G = Geo<D>;
  // the multiplier of a score in the softmax: the capped score is in log2
  // units already
  const float sl2 = kCap ? 1.f : scale_log2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* KV = Qs + G::tile(kRows);           // stage s: K, then V
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      KV + kStages * 2 * G::tile(kN));
  uint64_t *q_full = bars, *full = bars + 1, *empty = bars + 1 + kStages;
  const QueryBlock qb =
      query_block(B, Sq, Sk, H, Hkv, causal, q_offset, window);
  const int h = qb.h, b = qb.b, hk = qb.hk, q0 = qb.q0, t0 = qb.t0,
            n_tiles = qb.n_tiles;
  init_barriers(q_full, full, empty, 1);
  const int wg = threadIdx.x / kWG;

  if (wg == 2) {                               // producer
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * kWG) {
      sm90::mbar_arrive_expect_tx(q_full, G::tile(kRows));
      load_rows<D>(Qs, kRows, &tm_q, q_full, h, q0, b);
      stream_kv<D>(KV, &tm_k, &tm_v, full, empty, hk, b, t0, n_tiles);
    }
  } else {                                     // consumers
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x % kWG, lane = tid % 32;
    const int c2 = 2 * (lane % 4);
    const int wrow0 = q0 + 64 * wg;            // first row of this WG
    const int r0 = wrow0 + (tid / 32) * 16 + lane / 4;   // rows r0, r0 + 8
    const int last_row = min(wrow0 + 63, Sq - 1);
    const bool active = wrow0 < Sq;
    float acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint64_t q_desc = kmajor<D>(Qs, 64 * wg);
    sm90::mbar_wait(q_full, 0);
    for (int t = t0; t < n_tiles; ++t) {
      const int s = stage_of(t - t0), k0 = t * kN;
      const uint8_t* Ks = KV + s * 2 * G::tile(kN);
      const uint8_t* Vs = Ks + G::tile(kN);
      sm90::mbar_wait(&full[s], parity_of(t - t0));
      // the tile holds a key this warpgroup's rows see: not past the causal
      // end of its last row, not wholly below the window of its first
      if (active && (!causal || k0 <= q_offset + last_row) &&
          (window <= 0 || k0 + kN - 1 > q_offset + wrow0 - window)) {
        float sc[kN / 2];
        sm90::wgmma_fence();
        gemm_over_d<D, kRows, kN>(sc, q_desc, kmajor<D>(Ks, 0));
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(sc);
        if constexpr (kCap) {
#pragma unroll
          for (int e = 0; e < kN / 2; ++e)
            sc[e] = tanhf(sc[e] * soc) * cap_log2;
        }
        if (k0 + kN > Sk || (causal && k0 + kN - 1 > q_offset + wrow0) ||
            (window > 0 && k0 <= q_offset + last_row - window))
          mask_tile(sc, r0, k0, c2, -INFINITY, [&](int row, int key) {
            return key < Sk && (!causal || key <= q_offset + row) &&
                   in_window(key, q_offset + row, window);
          });
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < kN / 8; ++n)
            mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * i], sc[4 * n + 2 * i + 1]));
          const float m_new = fmaxf(m[i], quad_max(mx) * sl2);
          const float m_use = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = sm90::ex2(m[i] - m_use);
          m[i] = m_new;
          float rs = 0.f;
#pragma unroll
          for (int n = 0; n < kN / 8; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int e = 4 * n + 2 * i + j;
              sc[e] = sm90::ex2(fmaf(sc[e], sl2, -m_use));
              rs += sc[e];
            }
          l[i] = l[i] * alpha + rs;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            acc[4 * n + 2 * i] *= alpha;
            acc[4 * n + 2 * i + 1] *= alpha;
          }
        }
        uint32_t pa[kN / 16][4];
        to_a(sc, pa);
        sm90::wgmma_fence();
        gemm_over_rows<D>(acc, pa, mnmajor<D>(Vs, kN));
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(acc);
        sm90::fence_regs(pa);
      }
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float li = quad_sum(l[i]);
      const int row = r0 + 8 * i;
      if (!active || row >= Sq) continue;
      store_row<D>(o + (((size_t)b * Sq + row) * H + h) * D, acc, i, c2,
                   li > 0.f ? 1.f / li : 0.f);
      if (lane % 4 == 0)
        lse[((size_t)b * H + h) * Sq + row] = (m[i] + log2f(li)) * kLn2;
    }
  }
}

// Under a softcap the dK/dV block also hands warpgroup 1 the fp32 factor
// 1 - t^2 of each P^T element (kN x kN floats beside P^T).
template <int D, bool kCap>
constexpr size_t dkdv_smem() {
  using G = Geo<D>;
  return smem_floor(1024 + 2 * G::tile(kN) +
                    kStages * 2 * G::tile(kN) + kN * kN * 2 +
                    (kCap ? kN * kN * 4 : 0) +
                    kStages * 2 * kN * 4 + (1 + 2 * kStages) * 8);
}

// Named barriers (0 is __syncthreads) handing P^T from warpgroup 0 to
// warpgroup 1 in the dK/dV kernel: "ready" after warpgroup 0 wrote it,
// "free" after warpgroup 1 read it.
constexpr int kBarPReady = 1, kBarPFree = 2;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// One block per (64-key tile, KV head, batch), walking the G query heads
// and the 64-row query tiles from the causal start.  The two consumer
// warpgroups split the work of each tile: warpgroup 0 forms S^T = K Q^T,
// P^T = exp(scale S^T - lse) (rounded to bf16, handed to warpgroup 1
// through shared memory) and dV += P^T dO; warpgroup 1 forms
// dP^T = V dO^T, dS^T = P^T (dP^T - delta) and dK += dS^T Q.  Four
// products a tile, one 64 x D accumulator a warpgroup.  Under a softcap
// warpgroup 0 caps S^T (tanhf) and hands warpgroup 1 the factor
// 1 - t^2 beside P^T; warpgroup 1 scales dS^T by it before rounding.  The
// block's query tiles run from the causal start to the last row that sees
// its last key under a window.
template <int D, bool kCap>
__global__ void __launch_bounds__(kThreadsTC, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_do,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int Sq,
            int Sk, int H, int Hkv, float scale, float scale_log2,
            int causal, int q_offset, int window, float soc,
            float cap_log2) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + G::tile(kN);
  uint8_t* QO = Vs + G::tile(kN);           // stage s: Q, then dO
  uint32_t* Pt = reinterpret_cast<uint32_t*>(QO + kStages * 2 *
                                              G::tile(kN));
  float* Gt = reinterpret_cast<float*>(Pt + kN * kN / 2);   // kCap: 1 - t^2
  float* LD = Gt + (kCap ? kN * kN : 0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(LD + kStages * 2 * kN);
  uint64_t *kv_full = bars, *full = bars + 1, *empty = bars + 1 + kStages;
  const int per = Hkv * B;
  const int kt = (int)(blockIdx.x / per);      // key tile 0 (most work) first
  const int hk = (int)(blockIdx.x % per) % Hkv;
  const int b = (int)(blockIdx.x % per) / Hkv;
  const int G_ = H / Hkv, k0 = kt * kN;
  const int qt_lo = causal ? max(0, k0 - q_offset) / kN : 0;
  const int per_head = max(
      0, (query_end(min(k0 + kN, Sk) - 1, Sq, window, q_offset) + kN - 1) /
                 kN - qt_lo);
  const int n_iter = G_ * per_head;
  // the producer warp's 32 lanes each arrive (after writing lse and delta)
  init_barriers(kv_full, full, empty, 32);
  const int wg = threadIdx.x / kWG;

  if (wg == 2) {                               // producer
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 2 * kWG + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(kv_full, 2 * G::tile(kN));
        load_rows<D>(Ks, kN, &tm_k, kv_full, hk, k0, b);
        load_rows<D>(Vs, kN, &tm_v, kv_full, hk, k0, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = stage_of(it);
        const int h = hk * G_ + it / per_head;
        const int q0 = (qt_lo + it % per_head) * kN;
        uint8_t* Qs = QO + s * 2 * G::tile(kN);
        float* ls = LD + s * 2 * kN;
        sm90::mbar_wait(&empty[s], parity_of(it) ^ 1);
        for (int r = lane; r < kN; r += 32) {
          const int row = q0 + r;
          const size_t off = ((size_t)b * H + h) * Sq + row;
          ls[r] = row < Sq ? lse[off] * kLog2e : 0.f;
          ls[kN + r] = row < Sq ? delta[off] : 0.f;
        }
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&full[s], 2 * G::tile(kN));
          load_rows<D>(Qs, kN, &tm_q, &full[s], h, q0, b);
          load_rows<D>(Qs + G::tile(kN), kN, &tm_do, &full[s], h, q0,
                       b);
        } else {
          sm90::mbar_arrive(&full[s]);
        }
      }
    }
  } else {                                     // consumers
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x % kWG, lane = tid % 32;
    const int c2 = 2 * (lane % 4);
    const int kr0 = k0 + (tid / 32) * 16 + lane / 4;    // keys kr0, kr0 + 8
    float acc[D / 2];                          // dV (warpgroup 0) or dK (1)
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    const uint64_t k_desc = kmajor<D>(Ks, 0), v_desc = kmajor<D>(Vs, 0);
    sm90::mbar_wait(kv_full, 0);
    if (wg == 1) named_arrive(kBarPFree);      // the P^T buffer starts free
    for (int it = 0; it < n_iter; ++it) {
      const int s = stage_of(it);
      const int q0 = (qt_lo + it % per_head) * kN;
      const uint8_t* Qs = QO + s * 2 * G::tile(kN);
      const uint8_t* Os = Qs + G::tile(kN);
      const float* ls = LD + s * 2 * kN;
      sm90::mbar_wait(&full[s], parity_of(it));
      // both warpgroups take the same branch: the barriers pair up
      if (!causal || q_offset + min(q0 + kN - 1, Sq - 1) >= k0) {
        if (wg == 0) {
          float st[kN / 2];                 // S^T = K Q^T
          sm90::wgmma_fence();
          gemm_over_d<D, kN, kN>(st, k_desc, kmajor<D>(Qs, 0));
          sm90::wgmma_commit();
          sm90::wgmma_wait_all();
          sm90::fence_regs(st);
          // capped: 1 - t^2 goes straight to shared memory (32 more live
          // registers would spill), once warpgroup 1 has read the last
          if constexpr (kCap) named_sync(kBarPFree);
#pragma unroll
          for (int n = 0; n < kN / 8; ++n) {
            const float2 lv =
                *reinterpret_cast<const float2*>(ls + 8 * n + c2);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float* x = st + 4 * n + 2 * i;
              if constexpr (kCap) {
                const int e = 4 * n + 2 * i;
                const float t0 = tanhf(x[0] * soc), t1 = tanhf(x[1] * soc);
                Gt[e * kWG + tid] = 1.f - t0 * t0;
                Gt[(e + 1) * kWG + tid] = 1.f - t1 * t1;
                x[0] = sm90::ex2(fmaf(t0, cap_log2, -lv.x));
                x[1] = sm90::ex2(fmaf(t1, cap_log2, -lv.y));
              } else {
                x[0] = sm90::ex2(fmaf(x[0], scale_log2, -lv.x));
                x[1] = sm90::ex2(fmaf(x[1], scale_log2, -lv.y));
              }
            }
          }
          if (k0 + kN > Sk || q0 + kN > Sq ||
              (causal && k0 + kN - 1 > q_offset + q0) ||
              (window > 0 && q_offset + q0 + kN - 1 >= k0 + window))
            mask_tile(st, kr0, q0, c2, 0.f, [&](int key, int qc) {
              return key < Sk && qc < Sq && (!causal || key <= q_offset + qc) &&
                     in_window(key, q_offset + qc, window);
            });
          uint32_t pa[kN / 16][4];
          to_a(st, pa);
          if constexpr (!kCap)
            named_sync(kBarPFree);             // warpgroup 1 read the last
#pragma unroll
          for (int t = 0; t < kN / 16; ++t)
#pragma unroll
            for (int r = 0; r < 4; ++r) Pt[(4 * t + r) * kWG + tid] = pa[t][r];
          named_arrive(kBarPReady);
          sm90::wgmma_fence();                 // dV += P^T dO
          gemm_over_rows<D>(acc, pa, mnmajor<D>(Os, kN));
          sm90::wgmma_commit();
          sm90::wgmma_wait_all();
          sm90::fence_regs(acc);
          sm90::fence_regs(pa);
        } else {
          float dpt[kN / 2];                // dP^T = V dO^T
          sm90::wgmma_fence();
          gemm_over_d<D, kN, kN>(dpt, v_desc, kmajor<D>(Os, 0));
          sm90::wgmma_commit();
          sm90::wgmma_wait_all();
          sm90::fence_regs(dpt);
          // dS^T = P^T (dP^T - delta) from warpgroup 0's bf16 P^T (the same
          // fragment layout: thread tid of both warpgroups holds the same
          // keys and query columns)
          uint32_t da[kN / 16][4];
          named_sync(kBarPReady);
#pragma unroll
          for (int t = 0; t < kN / 16; ++t)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int col = 8 * (2 * t + r / 2) + c2, e = 8 * t + 2 * r;
              const float2 dl =
                  *reinterpret_cast<const float2*>(ls + kN + col);
              const float2 pr = sm90::unpack_bf16(Pt[(4 * t + r) * kWG + tid]);
              if constexpr (kCap)
                da[t][r] = sm90::pack_bf16(
                    pr.x * ((dpt[e] - dl.x) * Gt[e * kWG + tid]),
                    pr.y * ((dpt[e + 1] - dl.y) * Gt[(e + 1) * kWG + tid]));
              else
                da[t][r] = sm90::pack_bf16(pr.x * (dpt[e] - dl.x),
                                           pr.y * (dpt[e + 1] - dl.y));
            }
          named_arrive(kBarPFree);
          sm90::wgmma_fence();                 // dK += dS^T Q
          gemm_over_rows<D>(acc, da, mnmajor<D>(Qs, kN));
          sm90::wgmma_commit();
          sm90::wgmma_wait_all();
          sm90::fence_regs(acc);
          sm90::fence_regs(da);
        }
      }
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }
    // warpgroup 1 arrived on "free" once more than warpgroup 0 waited
    if (wg == 0) named_sync(kBarPFree);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = kr0 + 8 * i;
      if (key >= Sk) continue;
      const size_t off = (((size_t)b * Sk + key) * Hkv + hk) * D;
      store_row<D>((wg == 0 ? dv : dk) + off, acc, i, c2,
                   wg == 0 ? 1.f : scale);
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  using G = Geo<D>;
  return smem_floor(1024 + 2 * G::tile(kRows) + kStages * 2 * G::tile(kN) +
         (1 + 2 * kStages) * 8);
}

// Under a softcap each score is capped (tanhf) before P is formed, and
// the factor 1 - t^2 kept in registers scales dS before its rounding.
template <int D, bool kCap>
__global__ void __launch_bounds__(kThreadsTC, 1)
dq_kernel(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const __grid_constant__ CUtensorMap tm_do,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int B, int Sq, int Sk, int H, int Hkv,
          float scale, float scale_log2, int causal, int q_offset,
          int window, float soc, float cap_log2) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Os = Qs + G::tile(kRows);           // dO
  uint8_t* KV = Os + G::tile(kRows);           // stage s: K, then V
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      KV + kStages * 2 * G::tile(kN));
  uint64_t *qo_full = bars, *full = bars + 1, *empty = bars + 1 + kStages;
  const QueryBlock qb =
      query_block(B, Sq, Sk, H, Hkv, causal, q_offset, window);
  const int h = qb.h, b = qb.b, hk = qb.hk, q0 = qb.q0, t0 = qb.t0,
            n_tiles = qb.n_tiles;
  init_barriers(qo_full, full, empty, 1);
  const int wg = threadIdx.x / kWG;

  if (wg == 2) {                               // producer
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * kWG) {
      sm90::mbar_arrive_expect_tx(qo_full, 2 * G::tile(kRows));
      load_rows<D>(Qs, kRows, &tm_q, qo_full, h, q0, b);
      load_rows<D>(Os, kRows, &tm_do, qo_full, h, q0, b);
      stream_kv<D>(KV, &tm_k, &tm_v, full, empty, hk, b, t0, n_tiles);
    }
  } else {                                     // consumers
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x % kWG, lane = tid % 32;
    const int c2 = 2 * (lane % 4);
    const int wrow0 = q0 + 64 * wg;
    const int r0 = wrow0 + (tid / 32) * 16 + lane / 4;   // rows r0, r0 + 8
    const int last_row = min(wrow0 + 63, Sq - 1);
    const bool active = wrow0 < Sq;
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      const size_t off = ((size_t)b * H + h) * Sq + row;
      lse2[i] = row < Sq ? lse[off] * kLog2e : 0.f;
      dl[i] = row < Sq ? delta[off] : 0.f;
    }
    float dq_acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dq_acc[e] = 0.f;
    const uint64_t q_desc = kmajor<D>(Qs, 64 * wg);
    const uint64_t o_desc = kmajor<D>(Os, 64 * wg);
    sm90::mbar_wait(qo_full, 0);
    for (int t = t0; t < n_tiles; ++t) {
      const int s = stage_of(t - t0), k0 = t * kN;
      const uint8_t* Ks = KV + s * 2 * G::tile(kN);
      const uint8_t* Vs = Ks + G::tile(kN);
      sm90::mbar_wait(&full[s], parity_of(t - t0));
      if (active && (!causal || k0 <= q_offset + last_row) &&
          (window <= 0 || k0 + kN - 1 > q_offset + wrow0 - window)) {
        float sc[kN / 2];                   // S = Q K^T
        float dp[kN / 2];                   // dP = dO V^T
        const auto mask = [&](float (&x)[kN / 2]) {
          if (k0 + kN > Sk || wrow0 + 63 >= Sq ||
              (causal && k0 + kN - 1 > q_offset + wrow0) ||
              (window > 0 && k0 <= q_offset + last_row - window))
            mask_tile(x, r0, k0, c2, 0.f, [&](int row, int key) {
              return row < Sq && key < Sk &&
                     (!causal || key <= q_offset + row) &&
                     in_window(key, q_offset + row, window);
            });
        };
        uint32_t pa[kN / 16][4];            // P in bf16, as in dK/dV
        if constexpr (kCap) {
          // both products first; 1 - t^2 is folded into dP - delta at
          // once, so that no third fragment stays live (it would spill)
          sm90::wgmma_fence();
          gemm_over_d<D, kRows, kN>(sc, q_desc, kmajor<D>(Ks, 0));
          gemm_over_d<D, kRows, kN>(dp, o_desc, kmajor<D>(Vs, 0));
          sm90::wgmma_commit();
          sm90::wgmma_wait_all();
          sm90::fence_regs(sc);
          sm90::fence_regs(dp);
#pragma unroll
          for (int e = 0; e < kN / 2; ++e) {
            const float th = tanhf(sc[e] * soc);
            sc[e] = sm90::ex2(fmaf(th, cap_log2, -lse2[(e / 2) % 2]));
            dp[e] = (dp[e] - dl[(e / 2) % 2]) * (1.f - th * th);
          }
          mask(sc);
          to_a(sc, pa);
        } else {
          sm90::wgmma_fence();
          gemm_over_d<D, kRows, kN>(sc, q_desc, kmajor<D>(Ks, 0));
          sm90::wgmma_commit();
          sm90::wgmma_wait_all();
          sm90::fence_regs(sc);
#pragma unroll
          for (int e = 0; e < kN / 2; ++e)
            sc[e] = sm90::ex2(fmaf(sc[e], scale_log2, -lse2[(e / 2) % 2]));
          mask(sc);
          to_a(sc, pa);
          sm90::wgmma_fence();
          gemm_over_d<D, kRows, kN>(dp, o_desc, kmajor<D>(Vs, 0));
          sm90::wgmma_commit();
          sm90::wgmma_wait_all();
          sm90::fence_regs(dp);
        }
        // dS = P (dP - delta) from the bf16 P, so that both kernels form
        // the same dS (capped: P ((dP - delta)(1 - t^2)))
        uint32_t da[kN / 16][4];
#pragma unroll
        for (int t = 0; t < kN / 16; ++t)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 pr = sm90::unpack_bf16(pa[t][r]);
            const int e = 8 * t + 2 * r;
            if constexpr (kCap)
              da[t][r] = sm90::pack_bf16(pr.x * dp[e], pr.y * dp[e + 1]);
            else
              da[t][r] = sm90::pack_bf16(pr.x * (dp[e] - dl[r % 2]),
                                         pr.y * (dp[e + 1] - dl[r % 2]));
          }
        sm90::wgmma_fence();
        gemm_over_rows<D>(dq_acc, da, mnmajor<D>(Ks, kN));
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(dq_acc);
        sm90::fence_regs(da);
      }
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (!active || row >= Sq) continue;
      store_row<D>(dq + (((size_t)b * Sq + row) * H + h) * D, dq_acc, i, c2,
                   scale);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Checks the grid and lifts the kernel's dynamic shared-memory limit.
template <typename K>
int prepare(K kernel, size_t grid, size_t smem) {
  if (grid == 0 || grid > 0x7fffffff) return -1;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

// The softcap's constants of the kCap kernels: scale / cap and cap log2(e).
float cap_soc(const Shape& s) { return s.cap > 0.f ? s.scale / s.cap : 0.f; }
float cap_log2(const Shape& s) { return s.cap * kLog2e; }

template <int D, bool kCap>
int fwd_launch(const CUtensorMap& tq, const CUtensorMap& tk,
               const CUtensorMap& tv, void* o, float* lse, const Shape& s,
               cudaStream_t stream) {
  const size_t grid = (size_t)((s.Sq + kRows - 1) / kRows) * s.H * s.B;
  const int err = prepare(fwd_kernel<D, kCap>, grid, fwd_smem<D>());
  if (err) return err;
  fwd_kernel<D, kCap><<<(unsigned)grid, kThreadsTC, fwd_smem<D>(), stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, s.B, s.Sq, s.Sk, s.H, s.Hkv,
      s.scale * kLog2e, s.causal, s.q_offset, s.window, cap_soc(s),
      cap_log2(s));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const Shape& s, cudaStream_t stream) {
  if (!(s.scale > 0.f) || !aligned16(q) || !aligned16(k) || !aligned16(v))
    return -1;
  CUtensorMap tq, tk, tv;
  if (!sm90::bf16_rows_map(&tq, q, s.B, s.Sq, s.H, D, kRows) ||
      !sm90::bf16_rows_map(&tk, k, s.B, s.Sk, s.Hkv, D, kN) ||
      !sm90::bf16_rows_map(&tv, v, s.B, s.Sk, s.Hkv, D, kN))
    return kErrMap;
  return s.cap > 0.f ? fwd_launch<D, true>(tq, tk, tv, o, lse, s, stream)
                     : fwd_launch<D, false>(tq, tk, tv, o, lse, s, stream);
}

template <int D, bool kCap>
int bwd_launch(const CUtensorMap& tq, const CUtensorMap& tdo,
               const CUtensorMap& tq64, const CUtensorMap& tk64,
               const CUtensorMap& tv64, const CUtensorMap& tdo64,
               const float* lse, void* dq, void* dk, void* dv,
               const float* delta, const Shape& s, cudaStream_t stream) {
  const float sl2 = s.scale * kLog2e;
  size_t grid = (size_t)((s.Sk + kN - 1) / kN) * s.Hkv * s.B;
  int err = prepare(dkdv_kernel<D, kCap>, grid, dkdv_smem<D, kCap>());
  if (err) return err;
  dkdv_kernel<D, kCap>
      <<<(unsigned)grid, kThreadsTC, dkdv_smem<D, kCap>(), stream>>>(
          tq64, tk64, tv64, tdo64, lse, delta, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), s.B, s.Sq, s.Sk, s.H, s.Hkv, s.scale, sl2,
          s.causal, s.q_offset, s.window, cap_soc(s), cap_log2(s));
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  grid = (size_t)((s.Sq + kRows - 1) / kRows) * s.H * s.B;
  err = prepare(dq_kernel<D, kCap>, grid, dq_smem<D>());
  if (err) return err;
  dq_kernel<D, kCap><<<(unsigned)grid, kThreadsTC, dq_smem<D>(), stream>>>(
      tq, tk64, tv64, tdo, lse, delta, static_cast<bf16*>(dq), s.B, s.Sq,
      s.Sk, s.H, s.Hkv, s.scale, sl2, s.causal, s.q_offset, s.window,
      cap_soc(s), cap_log2(s));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd(const void* q, const void* k, const void* v, const void* o,
        const float* lse, const void* dout, void* dq, void* dk, void* dv,
        float* delta, const Shape& s, cudaStream_t stream) {
  if (!(s.scale > 0.f) || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(dout))
    return -1;
  CUtensorMap tq, tdo, tq64, tk64, tv64, tdo64;
  // dK/dV: the block's own 64 keys, 64-row query tiles streamed; dQ: the
  // block's own 128 query rows, 64-key tiles streamed
  if (!sm90::bf16_rows_map(&tq, q, s.B, s.Sq, s.H, D, kRows) ||
      !sm90::bf16_rows_map(&tdo, dout, s.B, s.Sq, s.H, D, kRows) ||
      !sm90::bf16_rows_map(&tq64, q, s.B, s.Sq, s.H, D, kN) ||
      !sm90::bf16_rows_map(&tdo64, dout, s.B, s.Sq, s.H, D, kN) ||
      !sm90::bf16_rows_map(&tk64, k, s.B, s.Sk, s.Hkv, D, kN) ||
      !sm90::bf16_rows_map(&tv64, v, s.B, s.Sk, s.Hkv, D, kN))
    return kErrMap;
  const size_t rows = (size_t)s.B * s.Sq * s.H;
  const unsigned warps = kThreads / 32;
  flash_delta_kernel<bf16, D><<<(unsigned)((rows + warps - 1) / warps),
                                kThreads, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta,
      s.B, s.Sq, s.H);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (s.cap > 0.f)
    return bwd_launch<D, true>(tq, tdo, tq64, tk64, tv64, tdo64, lse, dq, dk,
                               dv, delta, s, stream);
  return bwd_launch<D, false>(tq, tdo, tq64, tk64, tv64, tdo64, lse, dq, dk,
                              dv, delta, s, stream);
}

}  // namespace tc

// The fp32 kernels' instantiation: with or without the softcap.
template <int D>
int fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse,
            const Shape& s, cudaStream_t st) {
  return s.cap > 0.f ? fwd<float, D, true>(q, k, v, o, lse, s, st)
                     : fwd<float, D, false>(q, k, v, o, lse, s, st);
}
template <int D>
int bwd_f32(const void* q, const void* k, const void* v, const void* o,
            const float* lse, const void* dout, void* dq, void* dk, void* dv,
            float* delta, const Shape& s, cudaStream_t st) {
  return s.cap > 0.f
             ? bwd<float, D, true>(q, k, v, o, lse, dout, dq, dk, dv, delta,
                                   s, st)
             : bwd<float, D, false>(q, k, v, o, lse, dout, dq, dk, dv, delta,
                                    s, st);
}

int check(const Shape& s, int D, int device) {
  if (s.B <= 0 || s.Sq <= 0 || s.Sk <= 0 || s.Hkv <= 0 || s.H % s.Hkv ||
      s.q_offset < 0 || s.H > 65535 || s.B > 65535 || !(s.cap >= 0.f))
    return -1;
  if (D != 32 && D != 64 && D != 128) return -1;
  return static_cast<int>(cudaSetDevice(device));
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k and v (B, Sk, Hkv, D) -> o (B, Sq, H, D) in the same
// dtype (bf16 when is_bf16, else fp32) and lse (B, H, Sq) fp32.  window > 0
// limits row i to keys > q_offset + i - window; cap > 0 softcaps the scaled
// scores (0: neither).  Returns 0 on success, -1 for an argument the kernel
// does not take (bf16 also needs 16-byte aligned tensors and scale > 0), -2
// if the driver refused a TMA tensor map, else the cudaError_t of the
// launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int Sq, int Sk, int H, int Hkv,
                        int D, float scale, int causal, int q_offset,
                        int window, float cap, int is_bf16, int device,
                        void* stream) {
  const Shape s{B, Sq, Sk, H, Hkv, scale, causal, q_offset, window, cap};
  const int err = check(s, D, device);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {                      // the tensor-core kernels
    if (D == 32) return tc::fwd<32>(q, k, v, o, lse, s, st);
    if (D == 64) return tc::fwd<64>(q, k, v, o, lse, s, st);
    return tc::fwd<128>(q, k, v, o, lse, s, st);
  }
  if (D == 32) return fwd_f32<32>(q, k, v, o, lse, s, st);
  if (D == 64) return fwd_f32<64>(q, k, v, o, lse, s, st);
  return fwd_f32<128>(q, k, v, o, lse, s, st);
}

// The backward of flash_attention_fwd: from q, k, v, o, lse and dout
// (o's layout) -> dq, dk, dv in the inputs' layouts and dtype.  delta is
// (B, H, Sq) fp32 scratch.  Three launches; no atomics.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const float* lse, const void* dout,
                        void* dq, void* dk, void* dv, float* delta, int B,
                        int Sq, int Sk, int H, int Hkv, int D, float scale,
                        int causal, int q_offset, int window, float cap,
                        int is_bf16, int device, void* stream) {
  const Shape s{B, Sq, Sk, H, Hkv, scale, causal, q_offset, window, cap};
  const int err = check(s, D, device);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {                      // the tensor-core kernels
    if (D == 32)
      return tc::bwd<32>(q, k, v, o, lse, dout, dq, dk, dv, delta, s, st);
    if (D == 64)
      return tc::bwd<64>(q, k, v, o, lse, dout, dq, dk, dv, delta, s, st);
    return tc::bwd<128>(q, k, v, o, lse, dout, dq, dk, dv, delta, s, st);
  }
  if (D == 32)
    return bwd_f32<32>(q, k, v, o, lse, dout, dq, dk, dv, delta, s, st);
  if (D == 64)
    return bwd_f32<64>(q, k, v, o, lse, dout, dq, dk, dv, delta, s, st);
  return bwd_f32<128>(q, k, v, o, lse, dout, dq, dk, dv, delta, s, st);
}

const char* flash_attention_error_string(int code) {
  if (code == -1) return "argument not supported by the kernel";
  if (code == tc::kErrMap)
    return "cuTensorMapEncodeTiled refused a tensor map (or the driver "
           "does not have it)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
