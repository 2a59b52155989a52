// Device code shared by the port's paged-attention kernels for Hopper
// (sm_90a): the per-(query row, KV head) attention block that
// paged_attention.cu (packed, decode and chunk layouts) and dual_branch.cu
// (the fused MHA || FFN decode) all run.
//
// attend_block: one thread block computes G query rows that share KV head h
// against the first n_keys keys of one sequence, whose pages are listed in
// the block-table row row_bt (key k lives at page row_bt[k / page], row
// k % page).  Softmax is online, in fp32, with the reference's -1e30 mask;
// n_keys <= 0 writes exact zeros.  Each layout only decides which query row
// a block owns, which table row it reads and how many keys it sees.
//
// What bounds it on this card: bytes.  A block reads n_keys K rows and as
// many V rows of D * sizeof(TKV) bytes and does 4 * G * D flops per key, so
// at G = 3 it does about 6 flops per byte read, far below the ~295 flops per
// byte where H100's tensor cores would be the limit.  The design spends its
// effort on the loads:
//   * the G query rows that share a KV head live in registers, so each K/V
//     row is read once for all G heads (GQA reuse) and never re-read;
//   * the block walks the sequence's pages in a loop (the TPU's sequential
//     page grid axis becomes this loop; blocks share nothing and rely on no
//     order between them), 64 key positions per tile;
//   * every K and V row is loaded with 16-byte vector loads, D / (16 /
//     sizeof(TKV)) lanes per row, neighbouring lanes on neighbouring
//     addresses; K is consumed from registers, V is staged in shared memory
//     for the P.V product;
//   * pages past the last visible key are never touched.
// Tensor cores, TMA, cp.async pipelining and split-K over pages are later
// work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_paged {

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

// Shared memory of one attention block.
template <typename TKV, int D>
struct AttnSmem {
  alignas(16) TKV v[kTile * D];
  float p[kMaxG][kTile];
  float alpha[kMaxG];
  float l[kMaxG];
  float red[kMaxG][kThreads];
};

template <typename TQ, typename TKV, int D>
__device__ __forceinline__ void attend_block(
    const TQ* __restrict__ qrow, const TKV* __restrict__ kp,
    const TKV* __restrict__ vp, const int* __restrict__ row_bt, int n_keys,
    int h, int Hkv, int G, int page, float scale, TQ* __restrict__ o,
    AttnSmem<TKV, D>& sm) {
  constexpr int VEC = 16 / sizeof(TKV);  // elements per 16-byte load
  constexpr int LPR = D / VEC;           // lanes per key row
  constexpr int RPW = 32 / LPR;          // key rows per warp per pass
  constexpr int ROWS = kWarps * RPW;     // key rows per pass
  constexpr int PASSES = kTile / ROWS;
  constexpr int KS = kThreads / D;       // key splits of the P.V product
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row split");
  static_assert(kTile % ROWS == 0 && kTile == 64, "tile");
  static_assert(kThreads % D == 0, "P.V split");

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (n_keys <= 0) {  // nothing visible: exact zeros, nothing read
    for (int i = tid; i < G * D; i += kThreads) o[i] = from_float<TQ>(0.f);
    return;
  }

  // this lane's D-chunk of each of the G query rows
  const int chunk = lane % LPR;
  const int row_in_warp = lane / LPR;
  float qr[kMaxG][VEC];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qr[g][i] = g < G ? to_float<TQ>(qrow[(size_t)g * D + chunk * VEC + i])
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
      *reinterpret_cast<uint4*>(&sm.v[r * D + chunk * VEC]) = vraw;
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
          if (chunk == 0) sm.p[g][r] = live ? s * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // 2. online softmax: warp w updates query rows w and w + kWarps
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int g = warp + j * kWarps;
      if (g < G) {
        const float s0 = sm.p[g][lane];
        const float s1 = sm.p[g][lane + 32];
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
        const float m_new = fmaxf(m_run[j], mx);
        const float p0 = expf(s0 - m_new);
        const float p1 = expf(s1 - m_new);
        sm.p[g][lane] = p0;
        sm.p[g][lane + 32] = p1;
        float sum = p0 + p1;
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, sh);
        const float alpha = expf(m_run[j] - m_new);
        l_run[j] = l_run[j] * alpha + sum;
        m_run[j] = m_new;
        if (lane == 0) sm.alpha[g] = alpha;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + P . V
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) acc[g] *= sm.alpha[g];
    for (int r = ks; r < kTile; r += KS) {
      const float vv = to_float<TKV>(sm.v[r * D + d]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] += sm.p[g][r] * vv;
    }
    __syncthreads();  // v / p are rewritten by the next tile
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int g = warp + j * kWarps;
    if (g < G && lane == 0) sm.l[g] = l_run[j];
  }
  if (KS > 1) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) sm.red[g][tid] = acc[g];
  }
  __syncthreads();
  if (ks == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float a = acc[g];
        for (int s = 1; s < KS; ++s) a += sm.red[g][d + s * D];
        o[(size_t)g * D + d] = from_float<TQ>(a / fmaxf(sm.l[g], 1e-30f));
      }
    }
  }
}

// Runs L<TQ, TKV>::run(args...) for the dtypes the flags name
// (1 = bfloat16, 0 = float32).
template <template <typename, typename> class L, typename... A>
int by_dtypes(int q_bf16, int kv_bf16, A... args) {
  if (q_bf16 && kv_bf16) return L<__nv_bfloat16, __nv_bfloat16>::run(args...);
  if (q_bf16) return L<__nv_bfloat16, float>::run(args...);
  if (kv_bf16) return L<float, __nv_bfloat16>::run(args...);
  return L<float, float>::run(args...);
}

// Expands LAUNCH(32), LAUNCH(64) or LAUNCH(128) for the runtime head dim D;
// any other D returns -1 from the enclosing function.
#define REPRO_SWITCH_HEAD_DIM(D, LAUNCH) \
  switch (D) {                           \
    case 32: LAUNCH(32); break;          \
    case 64: LAUNCH(64); break;          \
    case 128: LAUNCH(128); break;        \
    default: return -1;                  \
  }

}  // namespace repro_paged
