// Packed ragged paged GQA attention for Hopper (sm_90a): the serving
// engine's attention in every full-attention layer of every tick.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py:346
// paged_packed_attention (body _paged_packed_kernel, :292), without the
// int8/fp8 row-scale variant.  Oracle: src/repro/kernels/ref.py:119.
//
//   q (T, H, D) in TQ; k_pages, v_pages (P, page, Hkv, D) in TKV;
//   block_tables (S, Tb) int32; tok_slot, tok_pos (T,) int32
//   -> out (T, H, D) in TQ.
//   Token t sees the keys of slot tok_slot[t] at logical positions
//   k <= tok_pos[t], stored at page block_tables[slot][k / page], row
//   k % page.  Query head h reads KV head h / G.  Softmax is online, in
//   fp32; tok_pos == -1 writes exact zeros.
//
// What bounds it on this card: bytes.  A token reads (tok_pos + 1) K rows
// and as many V rows of 2 * D * sizeof(TKV) bytes per KV head and does
// 4 * G * D flops per key-row, so at G = 3 it does about 6 flops per byte
// read, far below the ~295 flops per byte where H100's tensor cores
// would be the limit.  The design therefore spends its effort on the
// loads:
//   * one thread block per (token, KV head) pair; the G query rows that
//     share a KV head live in registers, so each K/V row is read once for
//     all G heads (GQA reuse) and never re-read;
//   * the block walks its own token's pages in a loop (the TPU's
//     sequential page grid axis becomes this loop; blocks share nothing
//     and rely on no order between them), 64 key positions per tile;
//   * every K and V row is loaded with 16-byte vector loads, D / (16 /
//     sizeof(TKV)) lanes per row, neighbouring lanes on neighbouring
//     addresses; K is consumed from registers, V is staged in shared
//     memory for the P.V product;
//   * pages past the token's position are never touched.
// It allocates nothing and does not synchronise.  Tensor cores, TMA,
// cp.async pipelining and split-K over pages (for decode ticks with few
// tokens, which leave SMs idle) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // key positions per tile
constexpr int kMaxG = 8;           // query heads per KV head
constexpr float kNegInf = -1e30f;  // the reference's masking value

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
paged_packed_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ tok_slot,
                    const int* __restrict__ tok_pos, TQ* __restrict__ out,
                    int H, int Hkv, int G, int page, int Tb, float scale) {
  constexpr int VEC = 16 / sizeof(TKV);  // elements per 16-byte load
  constexpr int LPR = D / VEC;           // lanes per key row
  constexpr int RPW = 32 / LPR;          // key rows per warp per pass
  constexpr int ROWS = kWarps * RPW;     // key rows per pass
  constexpr int PASSES = kTile / ROWS;
  constexpr int KS = kThreads / D;       // key splits of the P.V product
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row split");
  static_assert(kTile % ROWS == 0 && kTile == 64, "tile");
  static_assert(kThreads % D == 0, "P.V split");

  __shared__ __align__(16) TKV s_v[kTile * D];
  __shared__ float s_p[kMaxG][kTile];
  __shared__ float s_alpha[kMaxG];
  __shared__ float s_l[kMaxG];
  __shared__ float s_red[kMaxG][kThreads];

  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pos = tok_pos[t];
  TQ* o = out + ((size_t)t * H + (size_t)h * G) * D;
  if (pos < 0) {  // padding token: nothing visible, exact zeros
    for (int i = tid; i < G * D; i += kThreads) o[i] = from_float<TQ>(0.f);
    return;
  }
  const int n_keys = min(pos + 1, Tb * page);
  const int* row_bt = bt + (size_t)tok_slot[t] * Tb;

  // this lane's D-chunk of each of the G query rows
  const int chunk = lane % LPR;
  const int row_in_warp = lane / LPR;
  float qr[kMaxG][VEC];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qr[g][i] = g < G ? to_float<TQ>(q[((size_t)t * H + (size_t)h * G + g) * D
                                        + chunk * VEC + i])
                       : 0.f;
    }
  }

  // P.V ownership: column d over keys r == ks (mod KS)
  const int d = tid % D;
  const int ks = tid / D;
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  // softmax state of query rows warp and warp + kWarps (whole warp holds it)
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < n_keys; k0 += kTile) {
    // 1. scores of this tile; V rows staged in shared memory
#pragma unroll
    for (int ps = 0; ps < PASSES; ++ps) {
      const int r = ps * ROWS + warp * RPW + row_in_warp;
      const int k = k0 + r;
      const bool live = k < n_keys;
      uint4 kraw = make_uint4(0u, 0u, 0u, 0u);
      uint4 vraw = make_uint4(0u, 0u, 0u, 0u);
      if (live) {
        const int pg = row_bt[k / page];
        const size_t off =
            (((size_t)pg * page + (k % page)) * Hkv + h) * D + chunk * VEC;
        kraw = *reinterpret_cast<const uint4*>(kp + off);
        vraw = *reinterpret_cast<const uint4*>(vp + off);
      }
      *reinterpret_cast<uint4*>(&s_v[r * D + chunk * VEC]) = vraw;
      const TKV* kv = reinterpret_cast<const TKV*>(&kraw);
      float kf[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) kf[i] = to_float<TKV>(kv[i]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {  // G is uniform over the block: no divergence
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < VEC; ++i) s += qr[g][i] * kf[i];
#pragma unroll
          for (int sh = LPR / 2; sh > 0; sh >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, sh);
          if (chunk == 0) s_p[g][r] = live ? s * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // 2. online softmax: warp w updates query rows w and w + kWarps
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int g = warp + j * kWarps;
      if (g < G) {
        const float s0 = s_p[g][lane];
        const float s1 = s_p[g][lane + 32];
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
        const float m_new = fmaxf(m_run[j], mx);
        const float p0 = expf(s0 - m_new);
        const float p1 = expf(s1 - m_new);
        s_p[g][lane] = p0;
        s_p[g][lane + 32] = p1;
        float sum = p0 + p1;
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, sh);
        const float alpha = expf(m_run[j] - m_new);
        l_run[j] = l_run[j] * alpha + sum;
        m_run[j] = m_new;
        if (lane == 0) s_alpha[g] = alpha;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + P . V
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) acc[g] *= s_alpha[g];
    for (int r = ks; r < kTile; r += KS) {
      const float vv = to_float<TKV>(s_v[r * D + d]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] += s_p[g][r] * vv;
    }
    __syncthreads();  // s_v / s_p are rewritten by the next tile
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int g = warp + j * kWarps;
    if (g < G && lane == 0) s_l[g] = l_run[j];
  }
  if (KS > 1) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) s_red[g][tid] = acc[g];
  }
  __syncthreads();
  if (ks == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float a = acc[g];
        for (int s = 1; s < KS; ++s) a += s_red[g][d + s * D];
        o[(size_t)g * D + d] = from_float<TQ>(a / fmaxf(s_l[g], 1e-30f));
      }
    }
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const int* bt,
           const int* tok_slot, const int* tok_pos, void* out, int T, int H,
           int Hkv, int D, int page, int Tb, float scale,
           cudaStream_t stream) {
  const dim3 grid(T, Hkv);
  const int G = H / Hkv;
#define REPRO_LAUNCH(DD)                                                     \
  paged_packed_kernel<TQ, TKV, DD><<<grid, kThreads, 0, stream>>>(           \
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),                 \
      static_cast<const TKV*>(v), bt, tok_slot, tok_pos,                     \
      static_cast<TQ*>(out), H, Hkv, G, page, Tb, scale)
  switch (D) {
    case 32: REPRO_LAUNCH(32); break;
    case 64: REPRO_LAUNCH(64); break;
    case 128: REPRO_LAUNCH(128); break;
    default: return -1;
  }
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns 0 on success, -1 for an argument the kernel does not take, else
// the cudaError_t of the launch.  q_bf16 / kv_bf16: 1 = bfloat16, 0 = fp32.
int paged_packed_attention(const void* q, const void* k, const void* v,
                           const int* bt, const int* tok_slot,
                           const int* tok_pos, void* out, int T, int H,
                           int Hkv, int D, int page, int Tb, float scale,
                           int q_bf16, int kv_bf16, int device,
                           void* stream) {
  if (T == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG || page <= 0 || Tb <= 0)
    return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, bt, tok_slot,
                                                tok_pos, out, T, H, Hkv, D,
                                                page, Tb, scale, s);
  if (q_bf16)
    return launch<__nv_bfloat16, float>(q, k, v, bt, tok_slot, tok_pos, out,
                                        T, H, Hkv, D, page, Tb, scale, s);
  if (kv_bf16)
    return launch<float, __nv_bfloat16>(q, k, v, bt, tok_slot, tok_pos, out,
                                        T, H, Hkv, D, page, Tb, scale, s);
  return launch<float, float>(q, k, v, bt, tok_slot, tok_pos, out, T, H, Hkv,
                              D, page, Tb, scale, s);
}

const char* paged_attention_error_string(int code) {
  if (code == -1) return "argument not supported by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
