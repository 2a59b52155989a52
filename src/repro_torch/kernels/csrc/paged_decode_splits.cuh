// Paged decode attention for bf16 q on bf16, int8 or fp8 e4m3 pages, cut
// into key splits with a pipelined gather: the path of paged_attention.cu's
// paged_decode_attention for those type pairs, and the attention blocks of
// dual_branch.cu's fused kernel for bf16 pages.  fp32 q or fp32 pages keep
// paged_common.cuh's attend_block.
//
// Replaces, for those pairs, the Pallas TPU kernel
// src/repro/kernels/paged_attention.py:106 (body _paged_kernel, :53, with
// its k_scale / v_scale variant), whose grid is (lane, KV head) with the
// pages as a sequential, pipelined grid axis.  One (lane, KV head) per
// thread block, as attend_block runs it, gives 64 blocks at the serving
// shape (8 lanes x 8 KV heads) on 132 SMs, each walking ~1000 keys with its
// loads consumed as they arrive.  Here:
//
//   * A work item is (lane b, KV head hk, key split s).  Splits are
//     split_keys(Tb * page) keys long, the packed kernel's rule
//     (paged_packed_tc.cuh: at least 256 keys, at most 8 splits of a
//     table, whole 64-key tiles), so both layouts cut keys alike.  The grid
//     is fixed, (B * Hkv, n_splits) with the split slowest, so the live
//     items (splits below a lane's length) are dispatched first; an item
//     whose split holds no key returns at once.  Nothing is planned on the
//     host or in a kernel: an item reads seq_lens[b] itself.
//   * Inside an item (256 threads, eight warps): the G <= 8 query rows of
//     KV head hk live in registers (each lane holds 8 columns of each row,
//     as in attend_block; templated on MG = 4 or 8 rows); 64-key K and V
//     tiles are gathered through the block table with 16-byte cp.async
//     into a ring of kStages = 3 stages, two tiles in flight while the
//     third is used (64 KB at D = 128 on bf16 pages).  The block-table
//     entries of a tile are loaded one tile before its gather is issued.
//     Scores and P.V are fp32 on the CUDA cores: at G = 3 an item does ~6
//     flops per byte read (~12 on one-byte pages), where tensor cores buy
//     nothing.  The math is attend_block's: scores times scale, the
//     reference's -1e30 mask, an online softmax with expf, acc * alpha +
//     p v.
//   * One-byte pages (int8, fp8 e4m3; the reference's `k * ks[:, None]`,
//     `v * vs[:, None]` with (P, page) fp32 row scales shared by the KV
//     heads): the raw rows go into the ring (a tile is half a bf16 tile;
//     its 3 stages were timed faster than 4 or 5 on one-byte pages by
//     experiments/torch_kernel_variants.py) and the tile's 64 K and 64 V
//     row scales into a scale ring beside it, by 4-byte cp.async with the
//     rows.  Each byte widens to fp32 exactly (every int8 and every e4m3
//     value is an fp32 value) and the scales are folded, in fp32: a score
//     is ((q . k_raw) ks[k]) scale, and P.V takes p vs[k] where the
//     dequantized path takes p (v_raw vs[k]); l sums the unscaled p.
//     Nothing is rounded to bf16 before the output.
//   * A lane whose keys lie in one split is written by its one item
//     (acc / max(l, 1e-30), rounded once); otherwise each item writes its
//     partial (m, l, unnormalised acc) in fp32 to the caller's workspace
//     and a combine kernel merges the splits of each (lane, head) in split
//     order (no atomics: the same bits on every run).  The combine is a
//     programmatic dependent of the attention kernel.
//   * seq_len == 0 writes exact zeros (the split-0 item); keys at or past
//     Tb * page are never read.
//
// What bounds it on this card: bytes (each visible K/V row read once for
// all G query heads of its KV head).  At 8 lanes x 1021 keys the live
// items number 256, two resident per SM (106 KB of shared memory each at
// D = 128 on bf16 pages, the largest carveout, at most 128 registers a
// thread; G > 4 takes more registers and one block an SM rather than
// spill).
//
// Workspace (bytes, from workspace_layout): when a table can have more
// than one split, (m, l) float2 then, from the next 16-byte boundary (the
// combine reads float4s), the fp32 accumulators, each indexed
// ((split * B + lane) * H + head)[* D + column]; 0 bytes otherwise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace decode_splits {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 64;          // keys of a K/V tile
constexpr int kStages = 3;         // K/V tiles in the ring (timed)
constexpr int kMinSplit = 256;     // keys of a split, at least
constexpr int kMaxSplits = 8;      // splits of a table, at most
constexpr int kMaxG = 8;           // query heads per KV head
constexpr float kNegInf = -1e30f;  // the reference's masking value

// Pages of one byte an element (int8, fp8 e4m3) are quantized, with row
// scales; bf16 pages are not.
template <typename TKV>
constexpr bool kQuant = sizeof(TKV) == 1;

// Keys of a split for a table of max_keys = Tb * page keys.
__host__ __device__ inline int split_keys(int max_keys) {
  int per = (max_keys + kMaxSplits - 1) / kMaxSplits;
  per = (per + kKeys - 1) / kKeys * kKeys;
  return per > kMinSplit ? per : kMinSplit;
}

__host__ __device__ inline int n_splits(int max_keys) {
  const int L = split_keys(max_keys);
  return (max_keys + L - 1) / L;
}

// Byte offsets of the workspace's parts and its size.
struct Layout {
  size_t ml, acc, bytes;
};

inline Layout workspace_layout(int B, int H, int D, int max_keys) {
  const int ns = n_splits(max_keys);
  const size_t parts = ns > 1 ? (size_t)ns * B * H : 0;
  Layout w;
  w.ml = 0;
  w.acc = (8 * parts + 15) / 16 * 16;
  w.bytes = w.acc + 4 * parts * D;
  return w;
}

// Shared memory of one item: the K/V ring (rows of D elements, K tile then
// V tile per stage), the tile's scores / weights, the softmax state, and
// the P.V key-split sums; on one-byte pages also the ring's row scales
// (k_scale then v_scale of each stage's 64 rows).
template <typename TKV, int D>
struct SmemCore {
  alignas(16) TKV kv[kStages][2][kKeys * D];
  alignas(16) float p[kMaxG][kKeys];
  float alpha[kMaxG];
  float m[kMaxG];
  float l[kMaxG];
  float red[kMaxG][kThreads];
};

template <typename TKV, int D, bool Q = kQuant<TKV>>
struct Smem : SmemCore<TKV, D> {};

template <typename TKV, int D>
struct Smem<TKV, D, true> : SmemCore<TKV, D> {
  alignas(16) float sc[kStages][2][kKeys];
};

// A thread's share of a tile's gather: 16-byte unit u = tid % kUnits of
// rows tid / kUnits + i * kStep, i < kPer (rows at or past kKeys, which
// only one-byte rows of D = 32 reach, are no one's).
template <typename TKV, int D>
struct Share {
  static constexpr int kUnits = D * (int)sizeof(TKV) / 16;
  static constexpr int kStep = kThreads / kUnits;
  static constexpr int kPer = (kKeys + kStep - 1) / kStep;
};

// Pool rows (page * page_size + offset) of this thread's keys of the tile
// at k0, -1 at or past k_end.
template <typename TKV, int D>
__device__ __forceinline__ void tile_rows(int (&prow)[Share<TKV, D>::kPer],
                                          const int* row_bt, int k0,
                                          int k_end, int page) {
  using S = Share<TKV, D>;
#pragma unroll
  for (int i = 0; i < S::kPer; ++i) {
    const int k = k0 + threadIdx.x / S::kUnits + i * S::kStep;
    prow[i] = k < k_end ? row_bt[k / page] * page + k % page : -1;
  }
}

// Those rows of KV head hk into ring stage st, and on one-byte pages their
// scales (units 0 and 1 of a row fetch k_scale and v_scale); rows of -1
// are zeros, their scales too.
template <typename TKV, int D>
__device__ __forceinline__ void gather(Smem<TKV, D>& sm, int st,
                                       const TKV* kp, const TKV* vp,
                                       const float* ks, const float* vs,
                                       const int (&prow)[Share<TKV, D>::kPer],
                                       int Hkv, int hk) {
  using S = Share<TKV, D>;
  constexpr int kE = 16 / (int)sizeof(TKV);   // elements of a unit
  const int u = threadIdx.x % S::kUnits;
#pragma unroll
  for (int i = 0; i < S::kPer; ++i) {
    const int r = threadIdx.x / S::kUnits + i * S::kStep;
    if constexpr (S::kStep > kKeys) {
      if (r >= kKeys) continue;
    }
    const bool valid = prow[i] >= 0;
    const size_t off = valid ? ((size_t)prow[i] * Hkv + hk) * D + u * kE : 0;
    sm90::cp_async16(sm90::smem_u32(&sm.kv[st][0][r * D + u * kE]), kp + off,
                     valid);
    sm90::cp_async16(sm90::smem_u32(&sm.kv[st][1][r * D + u * kE]), vp + off,
                     valid);
    if constexpr (kQuant<TKV>) {
      if (u < 2)
        sm90::cp_async4(sm90::smem_u32(&sm.sc[st][u][r]),
                        (u ? vs : ks) + (valid ? prow[i] : 0), valid);
    }
  }
}

// Eight consecutive one-byte values (w.x: the first four, lowest byte
// first) as fp32, exactly.
template <typename TKV>
__device__ __forceinline__ void widen8(uint2 w, float (&f)[8]);

template <>
__device__ __forceinline__ void widen8<int8_t>(uint2 w, float (&f)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // byte b + 128 as the low bits of the float 2^23 + (b + 128)
    const uint32_t x = (h ? w.y : w.x) ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * h + j] =
          __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 + j)) -
          8388736.f;
  }
}

template <>
__device__ __forceinline__ void widen8<__nv_fp8_e4m3>(uint2 w,
                                                      float (&f)[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t x = j < 2 ? w.x : w.y;
    const __half2 h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(j % 2 ? x >> 16 : x & 0xffffu),
        __NV_E4M3);
    const float2 v = __half22float2(h);
    f[2 * j] = v.x;
    f[2 * j + 1] = v.y;
  }
}

// One element of a page as fp32 (exact for every type).
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// Item (lane b, KV head hk, split s): q and out point at the lane's row of
// H * D; seq_len is the lane's length; G <= MG query heads share the KV
// head (MG = 4 or 8: the registers of the query rows); ks / vs are the
// row scales of one-byte pages (unread on bf16 pages).  Writes out (one
// split, or no key) or the split's partial.
template <typename TKV, int D, int MG>
__device__ __forceinline__ void split_item(
    const bf16* __restrict__ q, const TKV* __restrict__ kp,
    const TKV* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ row_bt,
    int seq_len, int b, int hk, int s, int B, int H, int Hkv, int G,
    int page, int Tb, float scale, bf16* __restrict__ out,
    float2* __restrict__ part_ml, float* __restrict__ part_acc,
    Smem<TKV, D>& sm) {
  constexpr int LPR = D / 8;             // lanes per key row (8 columns each)
  constexpr int RPW = 32 / LPR;          // key rows per warp per pass
  constexpr int ROWS = kWarps * RPW;     // key rows per pass
  constexpr int PASSES = kKeys / ROWS;
  constexpr int KS = kThreads / D;       // key ranges of the P.V product
  constexpr int KR = kKeys / KS;         // keys of a range
  static_assert(kKeys % ROWS == 0 && kThreads % D == 0 && KR % 4 == 0,
                "tile split");

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int max_keys = Tb * page;
  const int n_keys = min(seq_len, max_keys);
  const int L = split_keys(max_keys);
  const int k_begin = s * L;
  const size_t head0 = (size_t)hk * G;
  if (k_begin >= n_keys) {   // no key in this split
    if (s == 0)              // none at all: exact zeros
      for (int i = tid; i < G * D; i += kThreads)
        out[head0 * D + i] = __float2bfloat16_rn(0.f);
    return;
  }
  const int k_end = min(n_keys, k_begin + L);
  const int n_tiles = (k_end - k_begin + kKeys - 1) / kKeys;
  const bool whole = (n_keys + L - 1) / L == 1;   // one split: write out

  // the ring's first kStages - 1 tiles, their table entries loaded
  // together
  {
    int pr[kStages - 1][Share<TKV, D>::kPer];
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j)
      tile_rows<TKV, D>(pr[j], row_bt, k_begin + j * kKeys, k_end, page);
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
      if (j < n_tiles) gather<TKV, D>(sm, j, kp, vp, ks, vs, pr[j], Hkv, hk);
      sm90::cp_async_commit();
    }
  }
  int nxt[Share<TKV, D>::kPer];
  tile_rows<TKV, D>(nxt, row_bt, k_begin + (kStages - 1) * kKeys, k_end,
                    page);

  // this lane's 8 columns of each of the G query rows
  const int chunk = lane % LPR;
  const int row_in_warp = lane / LPR;
  float qr[MG][8];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      qr[g][i] = g < G ? __bfloat162float(q[(head0 + g) * D + chunk * 8 + i])
                       : 0.f;
  }

  // P.V ownership: column d over keys [kr * KR, kr * KR + KR)
  const int d = tid % D;
  const int kr = tid / D;
  float acc[MG];
#pragma unroll
  for (int g = 0; g < MG; ++g) acc[g] = 0.f;
  // softmax state of query row `warp` (kWarps == kMaxG: a row a warp)
  static_assert(kWarps == kMaxG, "one softmax row a warp");
  float m_run = kNegInf, l_run = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    sm90::cp_async_wait<kStages - 2>();   // this thread's tile j landed
    __syncthreads();   // everyone's did, and tile j - 1 is consumed
    if (j + kStages - 1 < n_tiles) {
      gather<TKV, D>(sm, (j + kStages - 1) % kStages, kp, vp, ks, vs, nxt,
                     Hkv, hk);
      if (j + kStages < n_tiles)
        tile_rows<TKV, D>(nxt, row_bt, k_begin + (j + kStages) * kKeys,
                          k_end, page);
    }
    sm90::cp_async_commit();              // (empty past the last tile)
    const TKV* Ks = sm.kv[j % kStages][0];
    const TKV* Vs = sm.kv[j % kStages][1];
    const int k0 = k_begin + j * kKeys;

    // 1. scores of this tile
#pragma unroll
    for (int ps = 0; ps < PASSES; ++ps) {
      const int r = ps * ROWS + warp * RPW + row_in_warp;
      const bool live = k0 + r < k_end;
      float kf[8];
      float kscale = scale;
      if constexpr (kQuant<TKV>) {
        widen8<TKV>(*reinterpret_cast<const uint2*>(&Ks[r * D + chunk * 8]),
                    kf);
      } else {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(&Ks[r * D + chunk * 8]);
        const float2 k01 = sm90::unpack_bf16(raw.x);
        const float2 k23 = sm90::unpack_bf16(raw.y);
        const float2 k45 = sm90::unpack_bf16(raw.z);
        const float2 k67 = sm90::unpack_bf16(raw.w);
        kf[0] = k01.x, kf[1] = k01.y, kf[2] = k23.x, kf[3] = k23.y;
        kf[4] = k45.x, kf[5] = k45.y, kf[6] = k67.x, kf[7] = k67.y;
      }
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g < G) {  // G is uniform over the block: no divergence
          float sc = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) sc += qr[g][i] * kf[i];
#pragma unroll
          for (int sh = LPR / 2; sh > 0; sh >>= 1)
            sc += __shfl_xor_sync(0xffffffffu, sc, sh);
          if constexpr (kQuant<TKV>) {
            if (chunk == 0)   // ((q . k_raw) ks) scale
              sm.p[g][r] =
                  live ? sc * sm.sc[j % kStages][0][r] * kscale : kNegInf;
          } else {
            if (chunk == 0) sm.p[g][r] = live ? sc * kscale : kNegInf;
          }
        }
      }
    }
    __syncthreads();

    // 2. online softmax: warp w updates query row w (on one-byte pages the
    // weights left for P.V are p vs; l sums p)
    if (warp < G) {
      const float s0 = sm.p[warp][lane];
      const float s1 = sm.p[warp][lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_new = fmaxf(m_run, mx);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      if constexpr (kQuant<TKV>) {
        sm.p[warp][lane] = p0 * sm.sc[j % kStages][1][lane];
        sm.p[warp][lane + 32] = p1 * sm.sc[j % kStages][1][lane + 32];
      } else {
        sm.p[warp][lane] = p0;
        sm.p[warp][lane + 32] = p1;
      }
      float sum = p0 + p1;
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (lane == 0) sm.alpha[warp] = alpha;
    }
    __syncthreads();

    // 3. acc = acc * alpha + P . V over this thread's key range
#pragma unroll
    for (int g = 0; g < MG; ++g)
      if (g < G) acc[g] *= sm.alpha[g];
#pragma unroll 4
    for (int r4 = 0; r4 < KR / 4; ++r4) {
      const int r = kr * KR + 4 * r4;
      float vv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) vv[e] = to_f32(Vs[(r + e) * D + d]);
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g < G) {
          const float4 pw = *reinterpret_cast<const float4*>(&sm.p[g][r]);
          acc[g] += pw.x * vv[0];
          acc[g] += pw.y * vv[1];
          acc[g] += pw.z * vv[2];
          acc[g] += pw.w * vv[3];
        }
      }
    }
  }
  sm90::cp_async_wait<0>();

  if (warp < G && lane == 0) {
    sm.m[warp] = m_run;
    sm.l[warp] = l_run;
  }
  if (KS > 1) {
#pragma unroll
    for (int g = 0; g < MG; ++g)
      if (g < G) sm.red[g][tid] = acc[g];
  }
  __syncthreads();
  if (kr == 0) {
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g < G) {
        float a = acc[g];
        for (int k2 = 1; k2 < KS; ++k2) a += sm.red[g][d + k2 * D];
        const size_t h = head0 + g;
        if (whole) {
          // l >= 1 (the largest score adds exp(0)): no slow path needed
          out[h * D + d] = __float2bfloat16_rn(
              __fdividef(a, fmaxf(sm.l[g], 1e-30f)));
        } else {
          const size_t slot = ((size_t)s * B + b) * H + h;
          part_acc[slot * D + d] = a;
          if (d == 0) part_ml[slot] = make_float2(sm.m[g], sm.l[g]);
        }
      }
    }
  }
}

// The attention-only grid: (B * Hkv, n_splits), one item a block; two
// blocks an SM (at most 128 registers a thread) up to 4 query heads per KV
// head, one for 5 to 8 (whose rows would spill at 128).
template <typename TKV, int D, int MG>
__global__ void __launch_bounds__(kThreads, MG > 4 ? 1 : 2)
split_kernel(const bf16* __restrict__ q, const TKV* __restrict__ kp,
             const TKV* __restrict__ vp, const float* __restrict__ ks,
             const float* __restrict__ vs, const int* __restrict__ bt,
             const int* __restrict__ seq_lens, bf16* __restrict__ out,
             float2* __restrict__ part_ml, float* __restrict__ part_acc,
             int B, int H, int Hkv, int G, int page, int Tb, float scale) {
  extern __shared__ __align__(16) uint8_t split_smem[];
  Smem<TKV, D>& sm = *reinterpret_cast<Smem<TKV, D>*>(split_smem);
  sm90::launch_dependents();           // the combine grid may start now
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const size_t row = (size_t)b * H * D;
  split_item<TKV, D, MG>(q + row, kp, vp, ks, vs, bt + (size_t)b * Tb,
                         seq_lens[b], b, hk, blockIdx.y, B, H, Hkv, G, page,
                         Tb, scale, out + row, part_ml, part_acc, sm);
}

// ------------------------------------------------------------- combine
// Heads hy * kHeads .. of lane b, D / 4 threads a head, four columns a
// thread: the merge of the lane's splits in split order, when it has more
// than one (a one-split lane was written by its item).
template <int D>
struct CombineShape {
  static constexpr int kPer = D / 4;                 // threads of a head
  static constexpr int kHeads = kThreads / kPer;     // heads of a block
};

template <int D>
__device__ __forceinline__ void combine_heads(
    int b, int hy, const int* __restrict__ seq_lens, bf16* __restrict__ out,
    const float2* __restrict__ part_ml, const float* __restrict__ part_acc,
    int B, int H, int max_keys) {
  using C = CombineShape<D>;
  const int h = hy * C::kHeads + threadIdx.x / C::kPer;
  const int d4 = threadIdx.x % C::kPer;
  const int L = split_keys(max_keys);
  const int n_keys = min(seq_lens[b], max_keys);
  const int ns = (n_keys + L - 1) / L;
  if (h >= H || ns <= 1) return;
  const size_t slot0 = (size_t)b * H + h, stride = (size_t)B * H;
  float2 ml[kMaxSplits];
  float4 v[kMaxSplits];
  float mx = kNegInf;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < ns) {
      ml[s] = part_ml[slot0 + s * stride];
      v[s] = reinterpret_cast<const float4*>(
          part_acc + (slot0 + s * stride) * D)[d4];
      mx = fmaxf(mx, ml[s].x);
    }
  }
  float l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < ns) {
      const float w = expf(ml[s].x - mx);
      l += w * ml[s].y;
      a.x += w * v[s].x;
      a.y += w * v[s].y;
      a.z += w * v[s].z;
      a.w += w * v[s].w;
    }
  }
  // l >= 1 here (the split holding the maximum adds at least 1)
  const float inv = __fdividef(1.f, fmaxf(l, 1e-30f));
  *reinterpret_cast<uint2*>(out + ((size_t)b * H + h) * D + 4 * d4) =
      make_uint2(sm90::pack_bf16(a.x * inv, a.y * inv),
                 sm90::pack_bf16(a.z * inv, a.w * inv));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const int* __restrict__ seq_lens, bf16* __restrict__ out,
               const float2* __restrict__ part_ml,
               const float* __restrict__ part_acc, int B, int H,
               int max_keys) {
  sm90::grid_dependency_wait();        // the attention grid's partials
  combine_heads<D>(blockIdx.x, blockIdx.y, seq_lens, out, part_ml, part_acc,
                   B, H, max_keys);
}

// ----------------------------------------------------------------- host
// Sets the dynamic shared-memory size of kernel k (bytes), and the largest
// shared-memory carveout (so that two ~100 KB blocks fit on an SM), once
// per device; false if the runtime refuses either.
template <typename K>
inline bool allow_smem(K k, size_t bytes, int device, bool (&done)[16]) {
  if (device < 0 || device >= 16) return false;
  if (!done[device]) {
    if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes) != cudaSuccess ||
        cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared) != cudaSuccess)
      return false;
    done[device] = true;
  }
  return true;
}

inline bool misaligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

template <typename TKV, int D, int MG>
int attend(const bf16* q, const TKV* kp, const TKV* vp, const float* ks,
           const float* vs, const int* bt, const int* seq_lens, bf16* out,
           int B, int H, int Hkv, int page, int Tb, float scale, uint8_t* ws,
           const Layout& w, int device, cudaStream_t st) {
  static bool smem_set[16] = {};
  if (!allow_smem(split_kernel<TKV, D, MG>, sizeof(Smem<TKV, D>), device,
                  smem_set))
    return -1;
  const int max_keys = Tb * page, ns = n_splits(max_keys);
  float2* ml = reinterpret_cast<float2*>(ws + w.ml);
  float* acc = reinterpret_cast<float*>(ws + w.acc);
  split_kernel<TKV, D, MG>
      <<<dim3(B * Hkv, ns), kThreads, sizeof(Smem<TKV, D>), st>>>(
          q, kp, vp, ks, vs, bt, seq_lens, out, ml, acc, B, H, Hkv, H / Hkv,
          page, Tb, scale);
  int err = static_cast<int>(cudaGetLastError());
  if (err || ns == 1) return err;
  using C = CombineShape<D>;
  return static_cast<int>(sm90::launch_dependent(
      combine_kernel<D>, dim3(B, (H + C::kHeads - 1) / C::kHeads),
      dim3(kThreads), 0, st, seq_lens, out,
      static_cast<const float2*>(ml), static_cast<const float*>(acc), B, H,
      max_keys));
}

// Attention and combine on stream st for bf16 q on TKV pages (bf16, int8
// or fp8 e4m3; ks / vs the (P, page) fp32 row scales of one-byte pages,
// null for bf16): 0, -1 for an argument the kernels do not take (a head
// dim, unaligned pools, scales or output, a workspace smaller than
// workspace_layout's), else the cudaError_t of a launch.
template <typename TKV>
inline int launch(const void* q, const void* kp, const void* vp,
                  const float* ks, const float* vs, const int* bt,
                  const int* seq_lens, void* out, int B, int H, int Hkv,
                  int D, int page, int Tb, float scale, void* ws,
                  long long bytes, int device, cudaStream_t st) {
  if (misaligned(kp, 16) || misaligned(vp, 16) || misaligned(out, 8) ||
      misaligned(ws, 16))
    return -1;
  if (kQuant<TKV> && (ks == nullptr || vs == nullptr || misaligned(ks, 4) ||
                      misaligned(vs, 4)))
    return -1;
  const Layout w = workspace_layout(B, H, D, Tb * page);
  if (w.bytes > 0 && (ws == nullptr || bytes < (long long)w.bytes))
    return -1;
#define REPRO_ATTEND(DD)                                                   \
  return H / Hkv <= 4                                                     \
             ? attend<TKV, DD, 4>(static_cast<const bf16*>(q),            \
                                  static_cast<const TKV*>(kp),            \
                                  static_cast<const TKV*>(vp), ks, vs,    \
                                  bt, seq_lens, static_cast<bf16*>(out),  \
                                  B, H, Hkv, page, Tb, scale,             \
                                  static_cast<uint8_t*>(ws), w, device,   \
                                  st)                                     \
             : attend<TKV, DD, 8>(static_cast<const bf16*>(q),            \
                                  static_cast<const TKV*>(kp),            \
                                  static_cast<const TKV*>(vp), ks, vs,    \
                                  bt, seq_lens, static_cast<bf16*>(out),  \
                                  B, H, Hkv, page, Tb, scale,             \
                                  static_cast<uint8_t*>(ws), w, device,   \
                                  st)
  switch (D) {
    case 32: REPRO_ATTEND(32);
    case 64: REPRO_ATTEND(64);
    case 128: REPRO_ATTEND(128);
    default: return -1;
  }
#undef REPRO_ATTEND
}

}  // namespace decode_splits
