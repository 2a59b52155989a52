// The packed and the chunk paged attention on Hopper's tensor cores: the
// path of paged_attention.cu's paged_packed_attention and
// paged_chunk_attention for bf16 q on bf16, int8 or fp8 e4m3 pages (fp32 q
// or fp32 pages run paged_common.cuh's attend_block).
//
// Replaces, for those type pairs, the Pallas TPU kernels
// src/repro/kernels/paged_attention.py:346 (body _paged_packed_kernel,
// :292) and :222 (body _paged_chunk_kernel, :161), whose grids are one
// (token or chunk, KV head) per step with the pages as a sequential,
// pipelined grid axis.  Here the tokens of a slot that sit side by side in
// the packed buffer, or the rows of a lane's chunk, share their K/V tiles
// and one tensor-core product.  The two layouts differ only in where an
// item comes from and where its rows' key limits come from (an item source:
// PackedItems, ChunkItems); the attention and combine kernels are one
// template over the source.  The packed layout:
//
//   * A run is a maximal stretch of consecutive tokens of one slot at
//     consecutive positions (tok_pos >= 0).  The engine packs each lane as
//     one run, but runs are found from tok_slot / tok_pos, not assumed:
//     padding rows (tok_pos == -1, in slot 0 like a live lane) are in no
//     run, and a slot may appear as several runs.
//   * A work item is (up to 64 / G tokens of one run, one KV head, one key
//     split).  Its 64 query rows are the (token, g) pairs, token-major, and
//     row (t, g) sees key j iff j <= tok_pos[t].  A run is cut into chunks
//     of 64 / G tokens from its first token on; a chunk's keys, up to its
//     last token's position, into splits of L keys (split_keys: at least
//     256, at most 8 splits of the table's Tb * page keys), so that a
//     decode tick of a few long lanes still gives the card a few hundred
//     items.
//   * A plan kernel (one block, no host synchronisation) finds the runs and
//     writes the work list into the caller's workspace, chunk by chunk,
//     split by split, KV head by KV head; the attention kernel runs a
//     persistent grid (SMs x resident blocks) that walks the list with a
//     stride; a combine kernel merges the splits of each token in split
//     order (no atomics: the same bits on every run) and writes the
//     padding rows as exact zeros.  A row whose keys lie in one split is
//     written by its item directly.  The attention and combine kernels are
//     programmatic dependents of the kernel before them (their blocks start
//     while it finishes and wait for it in-kernel), and every combine block
//     waits for the attention kernel, so work after the call sees all of
//     the output.
//   * Per item, one warpgroup: Q (64 rows x D) and 64-key K/V tiles are
//     gathered row by row (row_bt[k / page]) with 16-byte cp.async straight
//     into the swizzled layout of sm90_common.cuh, double-buffered so that
//     the next tile's gather overlaps this tile's products.  S = Q K^T and
//     O += P V run as wgmma m64nNk16 with fp32 accumulators; the online
//     softmax is fp32 in registers (exp2, the scale folded in); P is
//     rounded to bf16 as the A operand of P V.  Each K/V row is read once
//     per (chunk, KV head, split) for all of the chunk's tokens and heads.
//   * One-byte pages (int8, fp8 e4m3; the reference's _dequant: K and V
//     rows times (P, page) fp32 row scales shared by the KV heads): the
//     tile's raw rows and their 64 + 64 scales are gathered by cp.async
//     into a two-stage raw ring; once a stage has landed, the warpgroup
//     widens its bytes to bf16 into one K/V tile pair in the wgmma layout.
//     That pass rounds nothing: every int8 value and every e4m3 value
//     (3 mantissa bits, exponents 2^-9 .. 2^8) is a bf16 value.  The
//     scales stay fp32 and act in registers: score column k times
//     scale * ks[k] (the reference's (q . k ks) scale in another order),
//     and x = p vs[k] enters P V as two bf16 A operands, bf16(x) and
//     bf16(x - bf16(x)) (x to 2^-17; one rounding of x alone moved o by
//     up to 2^-9 max|v vs|, a bf16 ulp of o where |o| >= 4), while l sums
//     the unscaled p.
//     The wgmma products are the bf16 route's; a narrow (fp8 / int8)
//     wgmma would need Q and P in that type, which is far from the
//     reference's fp32.
//   * Partials: (m, l) in the log2 domain and the unnormalised fp32
//     accumulator, at (split, token, head) in the workspace.
//
// The chunk layout (q (B, C, H, D) as B * C tokens, token b * C + c):
//
//   * Row (b, c) reads table row b and sees key j iff j <= min(pos[b] + c,
//     pos[b] + n_valid[b] - 1) (the rule of paged_attention.cu's header;
//     rows past n_valid too).  These limits are non-decreasing in c, so an
//     item's first row has the least and its last row the greatest, as in
//     a run; they are not consecutive positions past n_valid, which is why
//     a chunk is not fed through the plan kernel as a run (every row past
//     n_valid would become a one-token run that reads the whole history).
//   * A lane's C rows are one run by construction, so there is no plan
//     kernel: item w of B x ceil(C / R) x splits x Hkv (R = 64 / G rows of
//     the chunk, KV head fastest) is decoded from w, and the persistent grid
//     (at most the number of items) walks them with a stride.  An item
//     whose split holds no key visible to its rows returns at once; the
//     split-0 item of rows that see no key at all (pos = n_valid = 0) writes
//     them as exact zeros.
//   * Key splits (chunk_plan): only when the row-tile items B x ceil(C / R)
//     x Hkv number fewer than kChunkSplitItems (few lanes: an item there
//     walks its whole history alone while most SMs idle), the packed cut
//     (split_keys) and the same combine in split order; else one split,
//     whose items write their rows directly: no partials, no combine
//     launch.  The rule reads only shapes and a constant, never the device.
//     The constant is timed (experiments/torch_chunk_splits.py, C = 128,
//     G = 3, pos 1800): splits win at 56 and 112 items (2.0x, 1.2x) and
//     lose from 224 on (0.75x); at pos 0 they lose at every count.
//
// Semantics as attend_block's: the reference's -1e30 mask (as -inf: masked
// scores weigh exactly 0), division by max(l, 1e-30), tok_pos == -1 rows
// and chunk rows with no visible key exact zeros, keys past Tb * page never
// read.  Chunk positions are >= 0.
//
// What bounds it on this card: bytes (each visible K/V row of a run or a
// chunk once per 64 / G of its tokens and per KV head; ~6 flops a byte at
// G = 3, ~12 on one-byte pages, and the 64-row products waste the rows a
// short run leaves empty, which the tensor cores absorb).  A chunk of C =
// 128 rows at G = 3 reads its lane's history ceil(128 / 21) = 7 times, not
// once per row.
//
// Workspace (bytes, from workspace_layout): int32 item count at 0; the
// items (int4: first token, tokens, split, KV head) from byte 16; then,
// when a chunk can have more than one split, (m, l) float2 and the fp32
// accumulators (from a 16-byte boundary), each (splits, T, H[, D]).  The
// chunk layout's (chunk_plan): no count and no items, the partials alone,
// and none with one split.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace packed_tc {

using bf16 = __nv_bfloat16;
using sm90::Geo;

constexpr int kThreads = 128;       // one warpgroup
constexpr int kRows = 64;           // query rows of an item (wgmma m64)
constexpr int kKeys = 64;           // keys of a K/V tile
constexpr int kStages = 2;          // K/V tiles in shared memory
constexpr int kMinSplit = 256;      // keys of a split, at least
constexpr int kMaxSplits = 8;       // splits of a chunk, at most
constexpr int kChunkSplitItems = 128;   // chunk layout: split below this
constexpr int kPlanThreads = 1024;
constexpr float kLog2e = 1.4426950408889634f;

// Keys of a split for a table of max_keys = Tb * page keys.
__host__ __device__ inline int split_keys(int max_keys) {
  int per = (max_keys + kMaxSplits - 1) / kMaxSplits;
  per = (per + kKeys - 1) / kKeys * kKeys;
  return per > kMinSplit ? per : kMinSplit;
}

// Byte offsets of the workspace's parts and its size.
struct Layout {
  size_t items, ml, acc, bytes;
};

// The partials of `parts` (split, token, head) rows from byte ml on: the
// accumulators from the next 16-byte boundary (the combine reads float4s).
inline void partials_layout(Layout& w, size_t ml, size_t parts, int D) {
  w.ml = ml;
  w.acc = (ml + 8 * parts + 15) / 16 * 16;
  w.bytes = parts ? w.acc + 4 * parts * D : ml;
}

inline Layout workspace_layout(int T, int H, int Hkv, int D, int max_keys) {
  const int L = split_keys(max_keys);
  const int splits = (max_keys + L - 1) / L;       // most of a chunk
  const size_t max_items = (size_t)T * splits * Hkv;   // chunks <= T
  const size_t parts = splits > 1 ? (size_t)splits * T * H : 0;
  Layout w;
  w.items = 16;
  partials_layout(w, w.items + 16 * max_items, parts, D);
  return w;
}

// The chunk layout's tiling: R rows of a chunk an item, `tiles` row tiles
// of a lane, splits of L keys (one split of the whole table unless the
// row-tile items are few), and the workspace of their partials (none with
// one split).
struct ChunkPlan {
  int R, tiles, L, splits;
  Layout w;
};

inline ChunkPlan chunk_plan(int B, int C, int H, int Hkv, int D,
                            int max_keys) {
  ChunkPlan p;
  p.R = kRows / (H / Hkv);
  p.tiles = (C + p.R - 1) / p.R;
  const bool split = (long long)B * p.tiles * Hkv < kChunkSplitItems;
  p.L = split ? split_keys(max_keys) : max_keys;
  p.splits = (max_keys + p.L - 1) / p.L;
  p.w.items = 0;
  partials_layout(p.w, 0,
                  p.splits > 1 ? (size_t)p.splits * B * C * H : 0, D);
  return p;
}

// ---------------------------------------------------------------- plan
// Inclusive scan of v over the block with op; every thread must call it.
template <typename Op>
__device__ __forceinline__ int block_scan(int v, Op op, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = op(v, n);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = warp_tot[lane];          // kPlanThreads / 32 == 32 warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = op(w, n);
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = op(v, warp_tot[warp - 1]);
  __syncthreads();                   // warp_tot is reused by the next scan
  return v;
}

// The work list of a tick: for each chunk (in token order), each split,
// each KV head, one int4 (first token, tokens, split, KV head); the count
// at *count.  One block of kPlanThreads threads, T in tiles of that size.
__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(const int* __restrict__ tok_slot, const int* __restrict__ tok_pos,
            int T, int R, int L, int max_keys, int Hkv,
            int* __restrict__ count, int4* __restrict__ items) {
  static_assert(kPlanThreads == 32 * 32, "block_scan's warp totals");
  sm90::launch_dependents();         // the attention grid may start now
  __shared__ int warp_tot[32];
  __shared__ int carry[2];
  int run_carry = -1, item_carry = 0;
  for (int base = 0; base < T; base += kPlanThreads) {
    const int t = base + threadIdx.x;
    const int p = t < T ? tok_pos[t] : -1;
    const int sl = t < T ? tok_slot[t] : 0;
    const bool live = p >= 0;
    // token t continues token t - 1's run; token t + 1 continues t's
    const bool cont = live && t > 0 && tok_pos[t - 1] >= 0 &&
                      tok_slot[t - 1] == sl && p == tok_pos[t - 1] + 1;
    const bool next = live && t + 1 < T && tok_slot[t + 1] == sl &&
                      tok_pos[t + 1] == p + 1;
    // the latest run start at or before t: t's run start if t is live
    int rs = block_scan(live && !cont ? t : -1,
                        [](int a, int b) { return a > b ? a : b; }, warp_tot);
    rs = rs > run_carry ? rs : run_carry;
    // t ends a chunk: the run ends, or R tokens since the run's start
    int t0 = 0, ns = 0;
    if (live && (!next || (t + 1 - rs) % R == 0)) {
      t0 = rs + (t - rs) / R * R;
      const int nk = min(p + 1, max_keys);
      ns = (nk + L - 1) / L;
    }
    const int n_items = ns * Hkv;
    const int incl = block_scan(n_items, [](int a, int b) { return a + b; },
                                warp_tot);
    const int off = item_carry + incl - n_items;
    for (int s = 0; s < ns; ++s)
      for (int hk = 0; hk < Hkv; ++hk)
        items[off + s * Hkv + hk] = make_int4(t0, t - t0 + 1, s, hk);
    if (threadIdx.x == kPlanThreads - 1) {
      carry[0] = rs;
      carry[1] = item_carry + incl;
    }
    __syncthreads();
    run_carry = carry[0];
    item_carry = carry[1];
    __syncthreads();
  }
  if (threadIdx.x == 0) *count = item_carry;
}

// ------------------------------------------------------------ attention
// Pages of one byte an element (int8, fp8 e4m3) are quantized, with row
// scales; bf16 pages are not.
template <typename TKV>
constexpr bool kQuant = sizeof(TKV) == 1;

// Shared memory of the attention kernel, byte offsets from a 1024-byte
// boundary: the Q tile; bf16 K/V tile pairs (kStages of them on bf16
// pages, which are gathered into them; one on one-byte pages, which are
// widened into it); on one-byte pages, kStages raw K/V stages (64 rows of
// D bytes, K then V) and kStages scale stages (64 k_scale, 64 v_scale).
template <typename TKV, int D>
struct Smem {
  using G = Geo<D>;
  static constexpr int kPairs = kQuant<TKV> ? 1 : kStages;
  static constexpr int kRawStage = kQuant<TKV> ? 2 * kKeys * D : 0;
  static constexpr int kScaleStage = kQuant<TKV> ? 2 * kKeys * 4 : 0;
  static constexpr int kKV = G::tile(kRows);
  static constexpr int kRaw = kKV + kPairs * 2 * G::tile(kKeys);
  static constexpr int kScales = kRaw + kStages * kRawStage;
  static constexpr size_t kBytes = 1024 + kScales + kStages * kScaleStage;
};

// The item's query rows: row r = (token j, g) = (r / G, r % G) of tokens
// t0.., KV head hk; rows at or past `rows` are zeros.
template <int D>
__device__ __forceinline__ void load_q(uint8_t* Qs, const bf16* q, int t0,
                                       int rows, int G, int hk, int H) {
  constexpr int kUnits = D / 8;                    // 16-byte units a row
  const uint32_t base = sm90::smem_u32(Qs);
#pragma unroll
  for (int i = 0; i < kRows * kUnits / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kUnits, u = e % kUnits;
    const bool valid = r < rows;
    const bf16* src = q;
    if (valid)
      src = q + ((size_t)(t0 + r / G) * H + hk * G + r % G) * D + u * 8;
    sm90::cp_async16(base + sm90::tile_offset<D>(kRows, r, u), src, valid);
  }
}

// A thread's share of a tile of 64 rows of D elements of T: 16-byte unit
// u = threadIdx.x % kUnits of tile rows threadIdx.x / kUnits + i * kStep,
// i < kPer (D / 8 units a row in bf16, D / 16 in one byte).
template <typename T, int D>
struct KvShare {
  static constexpr int kUnits = D * (int)sizeof(T) / 16;
  static constexpr int kStep = kThreads / kUnits;
  static constexpr int kPer = kKeys / kStep;
};

// The pool rows (page * page_size + offset) of keys k0 .. k0 + 63 that this
// thread gathers, -1 at or past k_end: the block-table loads, issued a tile
// ahead so that their latency hides behind a tile's products.
template <typename TKV, int D>
__device__ __forceinline__ void kv_rows(int (&prow)[KvShare<TKV, D>::kPer],
                                        const int* row_bt, int k0, int k_end,
                                        int page) {
  using S = KvShare<TKV, D>;
#pragma unroll
  for (int i = 0; i < S::kPer; ++i) {
    const int k = k0 + threadIdx.x / S::kUnits + i * S::kStep;
    prow[i] = k < k_end ? row_bt[k / page] * page + k % page : -1;
  }
}

// Those rows of KV head hk into stage s; rows of -1 are zeros.  bf16: into
// the stage's K tile and the V tile after it, in the wgmma layout.  One
// byte: the raw rows into the stage's raw K and V (row r at r * D), and
// their scales (units 0 and 1 of each row fetch k_scale and v_scale).
template <typename TKV, int D, typename S = KvShare<TKV, D>>
__device__ __forceinline__ void load_kv(uint8_t* smem, int s, const TKV* kp,
                                        const TKV* vp, const float* ks,
                                        const float* vs,
                                        const int (&prow)[S::kPer], int Hkv,
                                        int hk) {
  using M = Smem<TKV, D>;
  const uint32_t base = sm90::smem_u32(smem);
  const int u = threadIdx.x % S::kUnits;
#pragma unroll
  for (int i = 0; i < S::kPer; ++i) {
    const int r = threadIdx.x / S::kUnits + i * S::kStep;
    const bool valid = prow[i] >= 0;
    const size_t off =
        valid ? ((size_t)prow[i] * Hkv + hk) * D + u * (16 / sizeof(TKV))
              : 0;
    if constexpr (kQuant<TKV>) {
      const uint32_t raw =
          base + M::kRaw + s * M::kRawStage + r * D + u * 16;
      sm90::cp_async16(raw, kp + off, valid);
      sm90::cp_async16(raw + kKeys * D, vp + off, valid);
      if (u < 2)
        sm90::cp_async4(base + M::kScales + s * M::kScaleStage +
                            (u * kKeys + r) * 4,
                        (u ? vs : ks) + (valid ? prow[i] : 0), valid);
    } else {
      const uint32_t t = base + M::kKV + s * 2 * Geo<D>::tile(kKeys) +
                         sm90::tile_offset<D>(kKeys, r, u);
      sm90::cp_async16(t, kp + off, valid);
      sm90::cp_async16(t + Geo<D>::tile(kKeys), vp + off, valid);
    }
  }
}

// Eight one-byte values (w.x: the first four, lowest byte first) as eight
// bf16, two a register, first in the low half.  Exact for every value.
template <typename TKV>
__device__ __forceinline__ uint4 widen(uint2 w);

template <>
__device__ __forceinline__ uint4 widen<int8_t>(uint2 w) {
  uint32_t out[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // byte b + 128 as the low bits of the float 2^23 + (b + 128)
    const uint32_t x = (h ? w.y : w.x) ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 + j)) -
             8388736.f;
    out[2 * h] = sm90::pack_bf16(f[0], f[1]);
    out[2 * h + 1] = sm90::pack_bf16(f[2], f[3]);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

template <>
__device__ __forceinline__ uint4 widen<__nv_fp8_e4m3>(uint2 w) {
  uint32_t out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t x = j < 2 ? w.x : w.y;
    const __half2 h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(j % 2 ? x >> 16 : x & 0xffffu),
        __NV_E4M3);
    const float2 f = __half22float2(h);
    out[j] = sm90::pack_bf16(f.x, f.y);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// Raw stage s as bf16 into the K/V tile pair: unit u = threadIdx.x % (D /
// 8) (eight values) of rows threadIdx.x / (D / 8) + i * kStep, the bf16
// share (conflict-free writes into the swizzled tile).
template <typename TKV, int D>
__device__ __forceinline__ void widen_stage(uint8_t* smem, int s) {
  using S = KvShare<bf16, D>;
  using M = Smem<TKV, D>;
  const uint8_t* raw = smem + M::kRaw + s * M::kRawStage;
  uint8_t* Ks = smem + M::kKV;
  const int u = threadIdx.x % S::kUnits;
#pragma unroll
  for (int i = 0; i < S::kPer; ++i) {
    const int r = threadIdx.x / S::kUnits + i * S::kStep;
    const uint32_t so = sm90::tile_offset<D>(kKeys, r, u);
#pragma unroll
    for (int kv = 0; kv < 2; ++kv)
      *reinterpret_cast<uint4*>(Ks + kv * Geo<D>::tile(kKeys) + so) =
          widen<TKV>(*reinterpret_cast<const uint2*>(
              raw + kv * kKeys * D + r * D + u * 8));
  }
}

// Multiplies this thread's accumulator columns (keys 8 n + c2 + j of rows
// r0, r0 + 8) by the row scales sc[key] times mul.
__device__ __forceinline__ void scale_columns(float (&d)[kKeys / 2],
                                              const float* sc, int c2,
                                              float mul) {
#pragma unroll
  for (int n8 = 0; n8 < kKeys / 8; ++n8) {
    const float2 f = *reinterpret_cast<const float2*>(sc + 8 * n8 + c2);
    const float a = f.x * mul, b = f.y * mul;
    d[4 * n8] *= a;
    d[4 * n8 + 1] *= b;
    d[4 * n8 + 2] *= a;
    d[4 * n8 + 3] *= b;
  }
}

// What the bf16 A operands a (to_a of d) left of d: the A operands of
// d - a, so that a + lo carries d to 2^-17 (d - a is exact in fp32).
__device__ __forceinline__ void residual_a(const float (&d)[kKeys / 2],
                                           const uint32_t (&a)[kKeys / 16][4],
                                           uint32_t (&lo)[kKeys / 16][4]) {
#pragma unroll
  for (int t = 0; t < kKeys / 16; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 hi = sm90::unpack_bf16(a[t][r]);
      lo[t][r] = sm90::pack_bf16(d[8 * t + 2 * r] - hi.x,
                                 d[8 * t + 2 * r + 1] - hi.y);
    }
}

// ---------------------------------------------------------- item sources
// A work item: tokens t0 .. t0 + n - 1 of one table row (row_bt), KV head
// hk, key split s; its token j sees keys <= last(j), non-decreasing in j.
struct Item {
  int t0, n, s, hk;
  const int* row_bt;
  int first, cap;
  __device__ __forceinline__ int last(int j) const {
    return min(first + j, cap);
  }
};

// The packed layout: the plan kernel's work list in the workspace; token t
// reads table row tok_slot[t] and sees keys <= tok_pos[t] (consecutive
// positions within an item's run; -1: padding, in no item).
struct PackedItems {
  const int* tok_slot;
  const int* tok_pos;
  const int* count;
  const int4* items;
  __device__ __forceinline__ int size() const { return *count; }
  __device__ __forceinline__ Item item(int w, const int* bt, int Tb) const {
    const int4 it = items[w];
    return {it.x, it.y, it.z, it.w, bt + (size_t)tok_slot[it.x] * Tb,
            tok_pos[it.x], 0x7fffffff};
  }
  __device__ __forceinline__ int last(int t) const { return tok_pos[t]; }
};

// The chunk layout: item w of B x tiles x splits x Hkv (KV head fastest),
// R rows of lane b's chunk from row c0; row (b, c) reads table row b and
// sees keys <= min(pos[b] + c, pos[b] + n_valid[b] - 1) (-1: none).
struct ChunkItems {
  const int* pos;
  const int* n_valid;
  int B, C, R, tiles, splits, Hkv;
  __device__ __forceinline__ int size() const {
    return B * tiles * splits * Hkv;
  }
  __device__ __forceinline__ Item item(int w, const int* bt, int Tb) const {
    const int hk = w % Hkv;
    w /= Hkv;
    const int s = w % splits;
    w /= splits;
    const int c0 = w % tiles * R, b = w / tiles;
    const int p = pos[b];
    return {b * C + c0, min(R, C - c0), s, hk, bt + (size_t)b * Tb, p + c0,
            p + n_valid[b] - 1};
  }
  __device__ __forceinline__ int last(int t) const {
    const int b = t / C, p = pos[b];
    return min(p + t % C, p + n_valid[b] - 1);
  }
};

template <typename TKV, int D, typename Src>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const bf16* __restrict__ q, const TKV* __restrict__ kp,
            const TKV* __restrict__ vp, const float* __restrict__ ks,
            const float* __restrict__ vs, const int* __restrict__ bt,
            const Src src, bf16* __restrict__ out,
            float2* __restrict__ part_ml, float* __restrict__ part_acc,
            int T, int H, int Hkv, int G, int page, int Tb, int L,
            float scale_log2) {
  using Gm = Geo<D>;
  using M = Smem<TKV, D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = sm90::align1024(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c2 = 2 * (lane & 3);
  const int r0 = warp * 16 + lane / 4;       // this thread's rows r0, r0 + 8
  const int max_keys = Tb * page;
  const uint64_t q_desc = sm90::kmajor<D>(Qs, 0);
  // the plan kernel's work list (packed), the chunk's inputs (the kernel
  // before this one)
  sm90::grid_dependency_wait();
  sm90::launch_dependents();                 // the combine grid may start
  const int n_items = src.size();

  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    const Item it = src.item(w, bt, Tb);
    const int t0 = it.t0, n = it.n, s = it.s, hk = it.hk;
    const int p0 = it.last(0);                 // the least limit
    const int* row_bt = it.row_bt;
    const int k_begin = s * L;
    const int k_end = min(min(it.last(n - 1) + 1, max_keys), k_begin + L);
    const int rows = n * G;
    if (k_end <= k_begin) {              // no key of this split (chunk only)
      // split 0: its rows see no key at all: exact zeros
      if (s == 0) {
        for (int e = threadIdx.x; e < rows * (D / 8); e += kThreads) {
          const int r = e / (D / 8);
          reinterpret_cast<uint4*>(
              out + ((size_t)(t0 + r / G) * H + hk * G + r % G) * D)
              [e % (D / 8)] = make_uint4(0, 0, 0, 0);
        }
      }
      continue;
    }
    const int n_tiles = (k_end - k_begin + kKeys - 1) / kKeys;
    int prow[KvShare<TKV, D>::kPer];
    kv_rows<TKV, D>(prow, row_bt, k_begin, k_end, page);
    load_q<D>(Qs, q, t0, rows, G, hk, H);
    load_kv<TKV, D>(Qs, 0, kp, vp, ks, vs, prow, Hkv, hk);
    sm90::cp_async_commit();
    if (n_tiles > 1)
      kv_rows<TKV, D>(prow, row_bt, k_begin + kKeys, k_end, page);
    // last visible key of rows r0, r0 + 8 (empty rows: every loaded key)
    int last[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      last[i] = r < rows ? it.last(r / G) : max_keys;
    }
    float acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    for (int j = 0; j < n_tiles; ++j) {
      const int k0 = k_begin + j * kKeys;
      if (j + 1 < n_tiles) {               // gather the next tile meanwhile
        load_kv<TKV, D>(Qs, (j + 1) % kStages, kp, vp, ks, vs, prow, Hkv,
                        hk);
        sm90::cp_async_commit();
        if (j + 2 < n_tiles)
          kv_rows<TKV, D>(prow, row_bt, k0 + 2 * kKeys, k_end, page);
        sm90::cp_async_wait<1>();
      } else {
        sm90::cp_async_wait<0>();
      }
      const uint8_t* Ks;
      if constexpr (kQuant<TKV>) {
        __syncthreads();                   // every thread's raw rows landed
        widen_stage<TKV, D>(Qs, j % kStages);
        Ks = Qs + M::kKV;
      } else {
        Ks = Qs + M::kKV + (j % kStages) * 2 * Gm::tile(kKeys);
      }
      sm90::fence_proxy_async();
      __syncthreads();
      const uint8_t* Vs = Ks + Gm::tile(kKeys);
      // the stage's k_scale, then its v_scale (one-byte pages)
      const float* scl = reinterpret_cast<const float*>(
          Qs + M::kScales + (j % kStages) * M::kScaleStage);

      float sc[kKeys / 2];
      sm90::wgmma_fence();
      sm90::gemm_over_d<D, kRows, kKeys>(sc, q_desc, sm90::kmajor<D>(Ks, 0));
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(sc);
      // scores in the log2 domain (any sign of scale); key k0 + 8 n + c2 +
      // jj of row r0 + 8 i is visible iff below k_end and at most the row's
      // position (row 0 has the least)
      if constexpr (kQuant<TKV>) {
        scale_columns(sc, scl, c2, scale_log2);
      } else {
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e) sc[e] *= scale_log2;
      }
      if (k0 + kKeys > k_end || k0 + kKeys - 1 > p0) {
#pragma unroll
        for (int n8 = 0; n8 < kKeys / 8; ++n8)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int key = k0 + 8 * n8 + c2 + jj;
              if (key >= k_end || key > last[i])
                sc[4 * n8 + 2 * i + jj] = -INFINITY;
            }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n8 = 0; n8 < kKeys / 8; ++n8)
          mx = fmaxf(mx, fmaxf(sc[4 * n8 + 2 * i], sc[4 * n8 + 2 * i + 1]));
        const float m_new = fmaxf(m[i], sm90::quad_max(mx));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = sm90::ex2(m[i] - m_use);
        m[i] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int n8 = 0; n8 < kKeys / 8; ++n8)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int e = 4 * n8 + 2 * i + jj;
            sc[e] = sm90::ex2(sc[e] - m_use);
            rs += sc[e];
          }
        l[i] = l[i] * alpha + rs;
#pragma unroll
        for (int n8 = 0; n8 < D / 8; ++n8) {
          acc[4 * n8 + 2 * i] *= alpha;
          acc[4 * n8 + 2 * i + 1] *= alpha;
        }
      }
      // one-byte pages: P V's A operand is x = p vs[key] (l keeps the plain
      // p), as bf16(x) + bf16(x - bf16(x)): two products carry x to
      // 2^-17, so the scales round nothing that the reference does not
      uint32_t pa[kKeys / 16][4], lo[kKeys / 16][4];
      if constexpr (kQuant<TKV>) scale_columns(sc, scl + kKeys, c2, 1.f);
      sm90::to_a(sc, pa);
      if constexpr (kQuant<TKV>) residual_a(sc, pa, lo);
      sm90::wgmma_fence();
      sm90::gemm_over_rows<D>(acc, pa, sm90::mnmajor<D>(Vs, kKeys));
      if constexpr (kQuant<TKV>)
        sm90::gemm_over_rows<D>(acc, lo, sm90::mnmajor<D>(Vs, kKeys));
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(acc);
      sm90::fence_regs(pa);
      if constexpr (kQuant<TKV>) sm90::fence_regs(lo);
      __syncthreads();                     // the stage is gathered again
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float li = sm90::quad_sum(l[i]);
      const int r = r0 + 8 * i;
      if (r >= rows) continue;
      const int t = t0 + r / G, h = hk * G + r % G;
      const int pos = it.last(r / G);
      // no key of this split; a row that sees no key at all is written (as
      // zeros: every weight was 0) by its split-0 item
      if (pos < 0 ? s > 0 : pos < k_begin) continue;
      const int splits = pos < 0 ? 1 : (min(pos + 1, max_keys) + L - 1) / L;
      if (splits == 1) {                   // all its keys: the output
        sm90::store_row<D>(out + ((size_t)t * H + h) * D, acc, i, c2,
                           __fdividef(1.f, fmaxf(li, 1e-30f)));
        continue;
      }
      const size_t slot = ((size_t)s * T + t) * H + h;
      float* dst = part_acc + slot * D;
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8)
        *reinterpret_cast<float2*>(dst + 8 * n8 + c2) =
            make_float2(acc[4 * n8 + 2 * i], acc[4 * n8 + 2 * i + 1]);
      if ((lane & 3) == 0) part_ml[slot] = make_float2(m[i], li);
    }
  }
}

// -------------------------------------------------------------- combine
// Block (t, y): heads y * kHeads .. of token t, D / 4 threads a head, four
// columns a thread.  Rows that see no key (padding, last key -1) are
// written as zeros; a token whose keys span several splits as the merge of
// its splits' partials in split order (at most kMaxSplits, loaded
// together).
template <int D>
struct CombineShape {
  static constexpr int kPer = D / 4;                 // threads of a head
  static constexpr int kHeads = kThreads / kPer;     // heads of a block
};

template <int D, typename Src>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const Src src, bf16* __restrict__ out,
               const float2* __restrict__ part_ml,
               const float* __restrict__ part_acc, int T, int H,
               int max_keys, int L) {
  using C = CombineShape<D>;
  const int t = blockIdx.x;
  const int h = blockIdx.y * C::kHeads + threadIdx.x / C::kPer;
  const int d4 = threadIdx.x % C::kPer;
  const int p = src.last(t);
  uint2* o = reinterpret_cast<uint2*>(out + ((size_t)t * H + h) * D) + d4;
  if (h < H && p < 0) *o = make_uint2(0, 0);
  // every block waits for the attention kernel's partials (and so finishes
  // after it: work after this kernel in the stream sees all of out)
  sm90::grid_dependency_wait();
  if (h >= H || p < 0) return;
  const int splits = (min(p + 1, max_keys) + L - 1) / L;
  if (splits == 1) return;                 // written by its item
  const size_t slot0 = (size_t)t * H + h, stride = (size_t)T * H;
  float2 ml[kMaxSplits];
  float4 v[kMaxSplits];
  float mx = -INFINITY;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < splits) {
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
    if (s < splits) {
      const float w = sm90::ex2(ml[s].x - mx);
      l += w * ml[s].y;
      a.x += w * v[s].x;
      a.y += w * v[s].y;
      a.z += w * v[s].z;
      a.w += w * v[s].w;
    }
  }
  // the approximate reciprocal has no slow path (l >= 1 here: the split
  // holding the maximum adds at least 1)
  const float inv = __fdividef(1.f, fmaxf(l, 1e-30f));
  *o = make_uint2(sm90::pack_bf16(a.x * inv, a.y * inv),
                  sm90::pack_bf16(a.z * inv, a.w * inv));
}

// ----------------------------------------------------------------- host
// Writes the work list into ws; -1 if the workspace is too small.
inline int plan(const int* tok_slot, const int* tok_pos, int T, int H,
                int Hkv, int D, int page, int Tb, void* ws, long long bytes,
                cudaStream_t st) {
  const int max_keys = Tb * page;
  const Layout w = workspace_layout(T, H, Hkv, D, max_keys);
  if (ws == nullptr || bytes < (long long)w.bytes) return -1;
  uint8_t* base = static_cast<uint8_t*>(ws);
  plan_kernel<<<1, kPlanThreads, 0, st>>>(
      tok_slot, tok_pos, T, kRows / (H / Hkv), split_keys(max_keys),
      max_keys, Hkv, reinterpret_cast<int*>(base),
      reinterpret_cast<int4*>(base + w.items));
  return static_cast<int>(cudaGetLastError());
}

// The attention kernel's persistent grid: SMs x resident blocks, found once
// per device and kernel (static: the cache is this library's own, not a
// symbol that another library built from this header would share; each
// instantiation has its own cache and its own shared-memory attribute).
template <typename TKV, int D, typename Src>
static int grid_size(int device) {
  static int cached[16] = {};
  if (device < 0 || device >= 16) return -1;
  if (cached[device] == 0) {
    constexpr size_t smem = Smem<TKV, D>::kBytes;
    if (cudaFuncSetAttribute(attn_kernel<TKV, D, Src>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess)
      return -1;
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, attn_kernel<TKV, D, Src>, kThreads, smem) !=
            cudaSuccess ||
        sms * per_sm == 0)
      return -1;
    cached[device] = sms * per_sm;
  }
  return cached[device];
}

// The attention kernel over src's items on a persistent grid of at most
// max_grid blocks, then, with `combine`, the combine kernel over T tokens.
template <typename TKV, int D, typename Src>
int attend(const bf16* q, const TKV* kp, const TKV* vp, const float* ks,
           const float* vs, const int* bt, const Src& src, int max_grid,
           bool combine, bf16* out, int T, int H, int Hkv, int page, int Tb,
           int L, float scale, uint8_t* ws, const Layout& w, int device,
           cudaStream_t st) {
  int grid = grid_size<TKV, D, Src>(device);
  if (grid < 0) return -1;
  if (grid > max_grid) grid = max_grid;
  float2* ml = reinterpret_cast<float2*>(ws + w.ml);
  float* acc = reinterpret_cast<float*>(ws + w.acc);
  // the attention and combine kernels start while the kernel before each
  // finishes (programmatic dependent launch), and wait for it in-kernel
  int err = static_cast<int>(sm90::launch_dependent(
      attn_kernel<TKV, D, Src>, dim3(grid), dim3(kThreads),
      Smem<TKV, D>::kBytes, st, q, kp, vp, ks, vs, bt, src, out, ml, acc, T,
      H, Hkv, H / Hkv, page, Tb, L, scale * kLog2e));
  if (err || !combine) return err;
  const dim3 cgrid(T, (H + CombineShape<D>::kHeads - 1) /
                          CombineShape<D>::kHeads);
  return static_cast<int>(sm90::launch_dependent(
      combine_kernel<D, Src>, cgrid, dim3(kThreads), 0, st, src, out,
      static_cast<const float2*>(ml), static_cast<const float*>(acc), T, H,
      Tb * page, L));
}

inline bool misaligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

// -1 unless the kernels take this head dim, q, output and pools (16-byte
// aligned) and, on one-byte pages, both scale pools.
template <typename TKV>
inline int check_args(int D, const void* q, const void* out, const void* kp,
                      const void* vp, const float* ks, const float* vs) {
  if ((D != 32 && D != 64 && D != 128) || misaligned(q, 16) ||
      misaligned(out, 16) || misaligned(kp, 16) || misaligned(vp, 16))
    return -1;
  if (kQuant<TKV> && (ks == nullptr || vs == nullptr || misaligned(ks, 4) ||
                      misaligned(vs, 4)))
    return -1;
  return 0;
}

#define REPRO_TC_SWITCH_HEAD_DIM(D, ATTEND) \
  switch (D) {                              \
    case 32: return ATTEND(32);             \
    case 64: return ATTEND(64);             \
    case 128: return ATTEND(128);           \
    default: return -1;                     \
  }

// Plan, attention and combine on stream st for bf16 q on pages of TKV
// (bf16, int8_t or __nv_fp8_e4m3; the one-byte types with their (P, page)
// fp32 row scales ks, vs): 0, -1 for an argument the kernels do not take
// (a head dim, a missing scale pool, an unaligned q, output or pool), else
// the cudaError_t of a launch.
template <typename TKV>
int launch(const void* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* bt, const int* tok_slot,
           const int* tok_pos, void* out, int T, int H, int Hkv, int D,
           int page, int Tb, float scale, void* ws, long long bytes,
           int device, cudaStream_t st) {
  if (check_args<TKV>(D, q, out, kp, vp, ks, vs)) return -1;
  int err = plan(tok_slot, tok_pos, T, H, Hkv, D, page, Tb, ws, bytes, st);
  if (err) return err;
  const Layout w = workspace_layout(T, H, Hkv, D, Tb * page);
  uint8_t* base = static_cast<uint8_t*>(ws);
  const PackedItems src{tok_slot, tok_pos, reinterpret_cast<const int*>(base),
                        reinterpret_cast<const int4*>(base + w.items)};
  // the combine also writes the padding rows: always launched
#define REPRO_ATTEND(DD)                                                    \
  attend<TKV, DD>(static_cast<const bf16*>(q), static_cast<const TKV*>(kp), \
                  static_cast<const TKV*>(vp), ks, vs, bt, src, 1 << 30,    \
                  true, static_cast<bf16*>(out), T, H, Hkv, page, Tb,       \
                  split_keys(Tb * page), scale, base, w, device, st)
  REPRO_TC_SWITCH_HEAD_DIM(D, REPRO_ATTEND)
#undef REPRO_ATTEND
}

// The chunk layout's attention (and, when chunk_plan takes splits, the
// combine) on stream st, for the same type pairs: q and the output (B, C,
// H, D), table row b and positions pos[b] .. for lane b; the workspace of
// at least chunk_plan(...).w.bytes bytes (null when 0).  Returns as
// launch.
template <typename TKV>
int launch_chunk(const void* q, const void* kp, const void* vp,
                 const float* ks, const float* vs, const int* bt,
                 const int* pos, const int* n_valid, void* out, int B, int C,
                 int H, int Hkv, int D, int page, int Tb, float scale,
                 void* ws, long long bytes, int device, cudaStream_t st) {
  if (check_args<TKV>(D, q, out, kp, vp, ks, vs)) return -1;
  const ChunkPlan c = chunk_plan(B, C, H, Hkv, D, Tb * page);
  if (c.w.bytes && (ws == nullptr || bytes < (long long)c.w.bytes)) return -1;
  const ChunkItems src{pos, n_valid, B, C, c.R, c.tiles, c.splits, Hkv};
  const long long n_items = (long long)B * c.tiles * c.splits * Hkv;
  if (n_items > 0x7fffffff) return -1;
#define REPRO_ATTEND(DD)                                                    \
  attend<TKV, DD>(static_cast<const bf16*>(q), static_cast<const TKV*>(kp), \
                  static_cast<const TKV*>(vp), ks, vs, bt, src,             \
                  (int)n_items, c.splits > 1, static_cast<bf16*>(out),      \
                  B * C, H, Hkv, page, Tb, c.L, scale,                      \
                  static_cast<uint8_t*>(ws), c.w, device, st)
  REPRO_TC_SWITCH_HEAD_DIM(D, REPRO_ATTEND)
#undef REPRO_ATTEND
}

#undef REPRO_TC_SWITCH_HEAD_DIM

}  // namespace packed_tc
