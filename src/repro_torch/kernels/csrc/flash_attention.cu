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
// Forward: one block per (64-row query block, head, batch).  The query
// block sits in shared memory as fp32; 64-key K and V tiles are staged in
// shared memory in turn; each of the 256 threads keeps a 4 x 4 tile of
// scores and a 4 x D/16 tile of the output accumulator in registers, with
// the online softmax's max and sum in fp32.  Key tiles past the causal
// diagonal are never loaded.  The block writes O (rounded once to the
// inputs' dtype) and lse = m + log(l) per row.
//
// Backward, three kernels on one stream, no atomics, so the result is the
// same bits on every run:
//   1. delta = rowsum(dO * O) per (b, h, row), one warp a row;
//   2. dK, dV: one block per (64-key block, KV head, batch), looping over
//      the G query heads of its group and over the query blocks from the
//      causal start, with dK and dV in registers;
//   3. dQ: one block per (64-row query block, head, batch), looping over
//      the key tiles up to the causal end.
// P is recomputed as exp(s - lse); dS = P * (dP - delta).
//
// What bounds it on this card: operations.  A causal forward at
// llama3.2-3b (S = 2048, H = 24, D = 128) is 25.8 GFLOP; at the tensor
// cores' 989 TFLOP/s that is 0.026 ms.  This first kernel does its products
// on the CUDA cores in fp32 (about 1/15 of that rate at best) out of shared
// memory; tensor cores (wgmma) and TMA-fed tiles are later work.  Nothing is
// allocated (the wrapper passes delta's scratch) and nothing synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// Thread layout of a 64 x 64 tile: ty = tid / 16 owns rows ty + 16 i,
// tx = tid % 16 owns columns tx + 16 j (i, j < 4).  The 16 threads of one
// ty share a half warp, so a row's reductions are half-warp shuffles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                 float scale, int causal, int q_offset) {
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
  for (int t = 0; t < n_tiles; ++t) {
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
        const bool ok = kpos < Sk && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
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
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
                  float scale, int causal, int q_offset) {
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
  // the first query row that sees key k0 is k0 - q_offset
  const int q_lo = causal ? max(0, k0 - q_offset) : 0;
  const int n_qt = (Sq + kB - 1) / kB;
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
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j, qrow = q0 + r;
          const bool ok = kpos < Sk && qrow < Sq &&
                          (!causal || kpos <= q_offset + qrow);
          const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
          Ps[(ty + 16 * i) * kLdP + r] = p;
          Ds[(ty + 16 * i) * kLdP + r] = p * (dp[i][j] - Es[r]);
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
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                int Sk, int H, int Hkv, float scale, int causal,
                int q_offset) {
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
  for (int t = 0; t < n_tiles; ++t) {
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < Sk && qrow < Sq &&
                        (!causal || kpos <= q_offset + qrow);
        const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
        Ds[r * kLdP + tx + 16 * j] = p * (dp[i][j] - Es[r]);
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
};

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const Shape& s, cudaStream_t stream) {
  const size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.Sq + kB - 1) / kB, s.H, s.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, s.Sq, s.Sk, s.H,
      s.Hkv, s.scale, s.causal, s.q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
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
  err = cudaFuncSetAttribute(flash_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dkdv_kernel<T, D>
      <<<dim3((s.Sk + kB - 1) / kB, s.Hkv, s.B), kThreads, smem, stream>>>(
          qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), s.Sq, s.Sk, s.H, s.Hkv, s.scale, s.causal,
          s.q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  smem = dq_smem<D>();
  err = cudaFuncSetAttribute(flash_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dq_kernel<T, D>
      <<<dim3((s.Sq + kB - 1) / kB, s.H, s.B), kThreads, smem, stream>>>(
          qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), s.Sq, s.Sk, s.H,
          s.Hkv, s.scale, s.causal, s.q_offset);
  return static_cast<int>(cudaGetLastError());
}

int check(const Shape& s, int D, int device) {
  if (s.B <= 0 || s.Sq <= 0 || s.Sk <= 0 || s.Hkv <= 0 || s.H % s.Hkv ||
      s.q_offset < 0 || s.H > 65535 || s.B > 65535)
    return -1;
  if (D != 32 && D != 64 && D != 128) return -1;
  return static_cast<int>(cudaSetDevice(device));
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k and v (B, Sk, Hkv, D) -> o (B, Sq, H, D) in the same
// dtype (bf16 when is_bf16, else fp32) and lse (B, H, Sq) fp32.  Returns 0
// on success, -1 for an argument the kernel does not take, else the
// cudaError_t of the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int Sq, int Sk, int H, int Hkv,
                        int D, float scale, int causal, int q_offset,
                        int is_bf16, int device, void* stream) {
  const Shape s{B, Sq, Sk, H, Hkv, scale, causal, q_offset};
  const int err = check(s, D, device);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 32) return fwd<__nv_bfloat16, 32>(q, k, v, o, lse, s, st);
    if (D == 64) return fwd<__nv_bfloat16, 64>(q, k, v, o, lse, s, st);
    return fwd<__nv_bfloat16, 128>(q, k, v, o, lse, s, st);
  }
  if (D == 32) return fwd<float, 32>(q, k, v, o, lse, s, st);
  if (D == 64) return fwd<float, 64>(q, k, v, o, lse, s, st);
  return fwd<float, 128>(q, k, v, o, lse, s, st);
}

// The backward of flash_attention_fwd: from q, k, v, o, lse and dout
// (o's layout) -> dq, dk, dv in the inputs' layouts and dtype.  delta is
// (B, H, Sq) fp32 scratch.  Three launches; no atomics.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const float* lse, const void* dout,
                        void* dq, void* dk, void* dv, float* delta, int B,
                        int Sq, int Sk, int H, int Hkv, int D, float scale,
                        int causal, int q_offset, int is_bf16, int device,
                        void* stream) {
  const Shape s{B, Sq, Sk, H, Hkv, scale, causal, q_offset};
  const int err = check(s, D, device);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 32)
      return bwd<__nv_bfloat16, 32>(q, k, v, o, lse, dout, dq, dk, dv, delta,
                                    s, st);
    if (D == 64)
      return bwd<__nv_bfloat16, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta,
                                    s, st);
    return bwd<__nv_bfloat16, 128>(q, k, v, o, lse, dout, dq, dk, dv, delta,
                                   s, st);
  }
  if (D == 32)
    return bwd<float, 32>(q, k, v, o, lse, dout, dq, dk, dv, delta, s, st);
  if (D == 64)
    return bwd<float, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, s, st);
  return bwd<float, 128>(q, k, v, o, lse, dout, dq, dk, dv, delta, s, st);
}

const char* flash_attention_error_string(int code) {
  if (code == -1) return "argument not supported by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
