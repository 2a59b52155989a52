// Fused dual-branch decode for Hopper (sm_90a): the paged attention of one
// decode token per lane || one dense FFN row per lane, in one grid.  It is
// FAL's decode-time property: under fal / parallel / ablation2 a block's MLP
// input does not depend on that block's attention, so the KV gather and the
// FFN weight reads go down together.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dual_branch.py:122
// fused_dual_branch_decode (body _dual_kernel, :39).  Oracle: ref.py:45
// paged_attention_ref followed by layers.mlp_apply.
//
//   q (B, H, D) in TQ; k_pages, v_pages (P, page, Hkv, D) in TKV;
//   block_tables (B, Tb), seq_lens (B,) int32; x (B, Dm) in TQ;
//   wi, wg (Dm, F) and wo (F, Dm) in TQ (wg unused for gelu)
//   -> attn (B, H, D) in TQ, y (B, Dm) in TQ.
//   y = act(x @ wg) * (x @ wi) @ wo for swiglu (silu) and geglu (tanh
//   gelu), gelu(x @ wi) @ wo for gelu, with fp32 sums and one rounding at
//   each output, as _dual_kernel does.
//
// What bounds it on this card: bytes, the FFN weights above all (151 MB at
// llama3.2-3b, Dm 3072, F 8192, bf16, against ~34 MB of K/V for 8 lanes x
// 1021 keys).  An FFN weight element does 2 B flops (8 per byte at B = 8),
// the attention ~6 per byte at G = 3: both far below the ~295 flops a byte
// where H100's tensor cores would limit.  But 16 flops a bf16 weight on the
// CUDA cores ask ~27 TFLOP/s of fp32 FMA to keep pace with HBM, and the
// first version (fp32 FMAs, one 128-thread block per 64-column tile, loads
// consumed as issued) streamed the weights at ~0.6 TB/s: its time was its
// FFN blocks' (0.2466 of 0.2504 ms with one key per lane) and it lost to
// its own two-op route.  So, for bf16 q, x, weights and pages (the serving
// path's types):
//   * One grid of two block kinds, 256 threads each.  Blocks [0, n_tiles)
//     are FFN blocks, one per tile of kFT = 64 columns of F; the rest are
//     the attention items of paged_decode_splits.cuh (lane, KV head, key
//     split), the decode kernel's own device function, with the split
//     slowest.  The TPU interleaved the two on one sequential grid; here
//     they share the SMs, two blocks an SM.
//   * An FFN block streams its weights by TMA through a four-stage ring of
//     18 KB stages (three in flight while one is used) with full / empty
//     mbarriers: first Dm / 64 stages of a 64 x 64 box of wi, one of wg
//     (its 64 columns, 64 rows) and a 16 x 64 box of x, then Dm / 128
//     stages of two 64 x 64 boxes of its 64 wo rows.  All eight warps
//     consume; warp 0 also refills a slot once the eight have released it,
//     so the stream never waits on a block-wide barrier.  The products run
//     on the tensor cores, mma.sync m16n8k16 bf16 -> fp32, swapped so that
//     the weights are the 16-row A operand (ldmatrix.trans from the boxes'
//     128B swizzle, conflict-free) and x^T the 8-column B operand (the
//     batch is N; 16 rows a pass, B > 16 takes more passes).  x @ wi and
//     x @ wg multiply bf16 by bf16, exact in fp32, and sum in fp32 as the
//     reference does (in another order: each warp sums half of each
//     stage's k-steps, and the halves meet once).  h = act(g) * i stays
//     fp32 into wo as the bf16 pair hi = bf16(h), lo = bf16(h - hi) (h to
//     2^-17; two products a k-step), so y is rounded once, at the end.
//   * Scratch: each tile writes its fp32 partial of y, (ceil(B / 8), Dm, 8)
//     per tile (the mma's C layout: 8 batch columns of a row contiguous),
//     12.6 MB at 128 tiles and B = 8, 8% of the weight bytes.  Tiles of 64
//     columns keep 128 FFN blocks streaming on 132 SMs; wider tiles would
//     halve the scratch but leave half the SMs without weights to read.
//   * A second launch (a programmatic dependent of the first) sums the
//     partials in a fixed order (tile order within 8 chunks of tiles, the
//     chunks in order: the chunks' loads go out together) and rounds y
//     once, and merges the attention splits in split order: the same bits
//     on every run, no atomics.
// On an H100 the weights stream at about cuBLAS's rate on the same three
// GEMMs (PERF.md); deeper rings, smaller or wider stages and a cp.async
// gather in place of TMA were tried and were no faster.
// Any F, Dm and B are taken: TMA zero-fills ragged tiles and stages, and
// where F or Dm is not a multiple of 8 or a base is not 16-byte aligned
// (which TMA refuses) warp 0 stages the same boxes element by element.
//
// fp32 q, x and weights, or fp32 pages, keep the CUDA-core kernel below
// (ffn_block beside attend_block, one block per (lane, KV head), partials
// summed by ffn_sum_kernel), whose fp32 gate needs fp32 products.  The
// wrapper allocates out, y and the workspace
// (fused_dual_branch_workspace_bytes).  No library GEMM is called: the FFN
// is computed here, as the TPU kernel computes it in its own body.

#include <string.h>

#include "paged_common.cuh"
#include "paged_decode_splits.cuh"
#include "sm90_common.cuh"

namespace {

using namespace repro_paged;

constexpr int kFT = 64;    // F columns per FFN block
constexpr int kRB = 8;     // batch rows per pass of an FFN block
constexpr int kKC = 256;   // Dm entries of x staged in shared memory per step
constexpr int kUnroll = 4; // weight rows whose loads a thread keeps in flight

enum Kind { kSwiglu = 0, kGeglu = 1, kGelu = 2 };

struct FfnSmem {
  float x[kRB][kKC];
  float red_i[kWarps][kRB][kFT];
  float red_g[kWarps][kRB][kFT];
  float h[kRB][kFT];
};

template <typename TKV, int D>
union DualSmem {
  AttnSmem<TKV, D> attn;
  FfnSmem ffn;
};

// VEC elements from p, packed as in memory; elements at or past `valid`
// read as 0 (all-zero bits).  One 16-byte load when `vec` (p is 16-byte
// aligned) and all VEC are valid.
template <typename T, int VEC>
__device__ __forceinline__ uint4 load_raw(const T* p, int valid, bool vec) {
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (vec && valid >= VEC) {
    raw = *reinterpret_cast<const uint4*>(p);
  } else {
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (j < valid) e[j] = p[j];
  }
  return raw;
}

template <typename T>
__device__ __forceinline__ float elem(const uint4& raw, int j) {
  return to_float<T>(reinterpret_cast<const T*>(&raw)[j]);
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// jax.nn.gelu's default (approximate=True) form
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// FFN block `tile`: scratch[tile, b, :] = h[b, tile cols] @ wo[tile rows, :]
template <typename TW>
__device__ __forceinline__ void ffn_block(
    const TW* __restrict__ x, const TW* __restrict__ wi,
    const TW* __restrict__ wg, const TW* __restrict__ wo,
    float* __restrict__ scratch, int tile, int B, int Dm, int F, int kind,
    FfnSmem& sm) {
  constexpr int VEC = 16 / sizeof(TW);  // elements per 16-byte load
  constexpr int LPR = kFT / VEC;        // lanes per weight-row segment
  constexpr int RPW = 32 / LPR;         // weight rows per warp per pass
  constexpr int ROWS = kWarps * RPW;    // weight rows per pass
  static_assert(kFT % VEC == 0 && LPR <= 32 && 32 % LPR == 0, "tile split");
  static_assert(kFT % kUnroll == 0 && kKC % (ROWS * kUnroll) == 0, "unroll");

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunk = lane % LPR;         // this lane's VEC columns of the tile
  const int krow = warp * RPW + lane / LPR;
  const int f0 = tile * kFT;
  const int col = f0 + chunk * VEC;
  const int ncols = min(kFT, F - f0);
  const bool gated = kind != kGelu;
  const bool vec_f = F % VEC == 0;      // wi / wg rows start 16-byte aligned
  const bool vec_d = Dm % VEC == 0;     // wo rows start 16-byte aligned

  for (int b0 = 0; b0 < B; b0 += kRB) {
    const int nb = min(kRB, B - b0);
    float ai[kRB][VEC];
    float ag[kRB][VEC];
#pragma unroll
    for (int r = 0; r < kRB; ++r)
#pragma unroll
      for (int j = 0; j < VEC; ++j) ai[r][j] = ag[r][j] = 0.f;

    // 1. this tile's columns of x @ wi and x @ wg, all nb rows at once
    for (int k0 = 0; k0 < Dm; k0 += kKC) {
      const int nk = min(kKC, Dm - k0);
      __syncthreads();  // earlier readers of sm are done
      for (int i = tid; i < kRB * kKC; i += kThreads) {
        const int r = i / kKC;
        const int kk = i % kKC;
        sm.x[r][kk] = r < nb && kk < nk
                          ? to_float<TW>(x[(size_t)(b0 + r) * Dm + k0 + kk])
                          : 0.f;
      }
      __syncthreads();
      for (int kk0 = krow; kk0 < nk; kk0 += ROWS * kUnroll) {
        // kUnroll rows' loads first, then their products: rows past nk
        // load as zeros, so they add exact zeros
        uint4 ri[kUnroll];
        uint4 rg[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int kk = kk0 + u * ROWS;
          const int valid = kk < nk ? F - col : 0;
          const size_t off = (size_t)(k0 + min(kk, nk - 1)) * F + col;
          ri[u] = load_raw<TW, VEC>(wi + off, valid, vec_f);
          rg[u] = gated ? load_raw<TW, VEC>(wg + off, valid, vec_f)
                        : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int kk = min(kk0 + u * ROWS, kKC - 1);
#pragma unroll
          for (int r = 0; r < kRB; ++r) {
            if (r < nb) {
              const float xv = sm.x[r][kk];
#pragma unroll
              for (int j = 0; j < VEC; ++j) {
                ai[r][j] += xv * elem<TW>(ri[u], j);
                ag[r][j] += xv * elem<TW>(rg[u], j);
              }
            }
          }
        }
      }
    }

    // 2. sum over the weight rows the threads split, in a fixed order:
    // within the warp by shuffles, then across warps in warp order
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
#pragma unroll
        for (int sh = LPR; sh < 32; sh <<= 1) {
          ai[r][j] += __shfl_xor_sync(0xffffffffu, ai[r][j], sh);
          ag[r][j] += __shfl_xor_sync(0xffffffffu, ag[r][j], sh);
        }
      }
    }
    if (lane < LPR) {
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          sm.red_i[warp][r][chunk * VEC + j] = ai[r][j];
          sm.red_g[warp][r][chunk * VEC + j] = ag[r][j];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < kRB * kFT; i += kThreads) {
      const int r = i / kFT;
      const int c = i % kFT;
      float si = 0.f;
      float sg = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        si += sm.red_i[w][r][c];
        sg += sm.red_g[w][r][c];
      }
      float hv;
      if (kind == kSwiglu) {
        hv = silu(sg) * si;
      } else if (kind == kGeglu) {
        hv = gelu_tanh(sg) * si;
      } else {
        hv = gelu_tanh(si);
      }
      sm.h[r][c] = r < nb && c < ncols ? hv : 0.f;
    }
    __syncthreads();

    // 3. the tile's partial of the output rows: h @ wo[f0 : f0 + ncols, :]
    for (int d0 = tid * VEC; d0 < Dm; d0 += kThreads * VEC) {
      float acc[kRB][VEC];
#pragma unroll
      for (int r = 0; r < kRB; ++r)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[r][j] = 0.f;
      for (int c0 = 0; c0 < ncols; c0 += kUnroll) {
        uint4 rw[kUnroll];  // rows past ncols load as zeros (h is 0 there)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int c = c0 + u;
          rw[u] = load_raw<TW, VEC>(
              wo + (size_t)(f0 + min(c, ncols - 1)) * Dm + d0,
              c < ncols ? Dm - d0 : 0, vec_d);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int r = 0; r < kRB; ++r) {
            if (r < nb) {
              const float hv = sm.h[r][c0 + u];
#pragma unroll
              for (int j = 0; j < VEC; ++j)
                acc[r][j] += hv * elem<TW>(rw[u], j);
            }
          }
        }
      }
      for (int r = 0; r < nb; ++r) {
        float* dst = scratch + ((size_t)tile * B + b0 + r) * Dm + d0;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (d0 + j < Dm) dst[j] = acc[r][j];
      }
    }
  }
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
dual_branch_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                   const TKV* __restrict__ vp, const int* __restrict__ bt,
                   const int* __restrict__ seq_lens, const TQ* __restrict__ x,
                   const TQ* __restrict__ wi, const TQ* __restrict__ wg,
                   const TQ* __restrict__ wo, TQ* __restrict__ out,
                   float* __restrict__ scratch, int n_tiles, int B, int H,
                   int Hkv, int G, int page, int Tb, int Dm, int F, int kind,
                   float scale) {
  __shared__ DualSmem<TKV, D> sm;
  if ((int)blockIdx.x < n_tiles) {
    ffn_block<TQ>(x, wi, wg, wo, scratch, blockIdx.x, B, Dm, F, kind, sm.ffn);
    return;
  }
  const int a = blockIdx.x - n_tiles;  // attention block: (lane, KV head)
  const int b = a / Hkv;
  const int h = a % Hkv;
  const int n_keys = min(seq_lens[b], Tb * page);
  const size_t row = (size_t)b * H + (size_t)h * G;
  attend_block<TQ, TKV, D>(q + row * D, kp, vp, nullptr, nullptr,
                           bt + (size_t)b * Tb, n_keys, h, Hkv, G, page,
                           scale, out + row * D, sm.attn);
}

// y[i] = sum over tiles, in tile order, of scratch[tile, i]; one rounding
template <typename TO>
__global__ void ffn_sum_kernel(const float* __restrict__ scratch,
                               TO* __restrict__ y, int n_tiles, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += scratch[(size_t)t * n + i];
  y[i] = from_float<TO>(s);
}

// Bytes of the CUDA-core route's scratch: (ceil(F / kFT), B, Dm) floats.
inline size_t core_scratch_bytes(int B, int Dm, int F) {
  return (size_t)((F + kFT - 1) / kFT) * B * Dm * 4;
}

template <typename TQ, typename TKV>
struct DualLaunch {
  static int run(const void* q, const void* k, const void* v, const int* bt,
                 const int* seq_lens, const void* x, const void* wi,
                 const void* wg, const void* wo, void* out, void* y,
                 void* ws, long long bytes, int B, int H, int Hkv, int D,
                 int page, int Tb, int Dm, int F, int kind, float scale,
                 int /*device*/, cudaStream_t s) {
    if (ws == nullptr || bytes < (long long)core_scratch_bytes(B, Dm, F))
      return -1;
    float* scratch = static_cast<float*>(ws);
    const int n_tiles = (F + kFT - 1) / kFT;
    const int blocks = n_tiles + B * Hkv;
#define REPRO_LAUNCH(DD)                                                    \
  dual_branch_kernel<TQ, TKV, DD><<<blocks, kThreads, 0, s>>>(              \
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),                \
      static_cast<const TKV*>(v), bt, seq_lens,                             \
      static_cast<const TQ*>(x), static_cast<const TQ*>(wi),                \
      static_cast<const TQ*>(wg), static_cast<const TQ*>(wo),               \
      static_cast<TQ*>(out), scratch, n_tiles, B, H, Hkv, H / Hkv, page,    \
      Tb, Dm, F, kind, scale)
    REPRO_SWITCH_HEAD_DIM(D, REPRO_LAUNCH)
#undef REPRO_LAUNCH
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n = B * Dm;
    if (n > 0)
      ffn_sum_kernel<TQ><<<(n + 255) / 256, 256, 0, s>>>(
          scratch, static_cast<TQ*>(y), n_tiles, n);
    return static_cast<int>(cudaGetLastError());
  }
};

// ----------------------------------------------------- the bf16 route
namespace ffn_tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // eight warps
constexpr int kFT = 64;        // F columns of a tile (four m16 tiles)
constexpr int kKC = 64;        // Dm rows of wi / wg (and x columns) a stage
constexpr int kDC = 128;       // Dm columns of wo a stage (16 a warp)
constexpr int kRows = 16;      // batch rows a pass: two 8-row groups (N)
constexpr int kStages = 4;     // ring stages, three in flight
constexpr int kSumChunks = 8;  // chunks of tiles the finishing sum splits
constexpr int kBox = 64 * 64 * 2;    // a 64 x 64 bf16 box: 128-byte rows
constexpr int kXBox = kRows * 64 * 2;
constexpr int kW1 = kFT + 8;   // row of h (elements): 144 bytes, padded

// A stage, 1024-byte aligned, as the 128B swizzle wants it: phase 1 the wi
// box (64 k rows x the tile's 64 columns), the wg box and the x box (16
// batch rows x 64 k); phase 2 two wo boxes (the tile's 64 f rows x 64 d
// columns each).  Row r's 16-byte unit u of a box sits at unit u ^ (r % 8).
constexpr int kStage = 2 * kBox + kXBox;
static_assert(kStage % 1024 == 0 && kStage >= 2 * kBox, "stage layout");

struct Smem {
  alignas(1024) uint8_t st[kStages][kStage];
  alignas(16) bf16 hhi[kRows * kW1];  // h = hhi + hlo, (batch row, column)
  alignas(16) bf16 hlo[kRows * kW1];
  // x @ wi, x @ wg over the second half of each stage's k-steps, from the
  // warps that summed it to the warps that add it to theirs
  alignas(16) float xch[4][2][2][4][32];  // [m tile][mat][group][elt][lane]
  uint64_t full[kStages];   // stage landed
  uint64_t empty[kStages];  // stage consumed by all eight warps
};

// Byte offset of the 16-byte unit holding column c of row r of a box.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4);
}

// The tensor maps of the weights and x (bf16, 64 x 64 boxes of 128-byte
// rows, 128B swizzle; rows and columns past the ends read as zeros).
struct Maps {
  CUtensorMap wi, wg, x, wo;
};

// Four 8x8 bf16 matrices from shared memory, transposed: with lane l
// giving the address of row l % 8 of matrix l / 8, lane t receives
// elements (2 (t % 4), t / 4) and (2 (t % 4) + 1, t / 4) of each.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += A B, A 16 x 16 (row), B 16 x 8 (col), bf16 -> fp32.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The arguments of one FFN block.
struct Ffn {
  const bf16* x;
  const bf16* wi;
  const bf16* wg;
  const bf16* wo;
  float* scratch;
  int B, Dm, F, kind;
  bool tma;  // F, Dm multiples of 8 and every base 16-byte aligned
};

// Box (rows r0.., columns c0..) of a (rows, cols) bf16 matrix with row
// stride ld into a swizzled box, element by element (zeros outside): the
// staging of shapes TMA does not take, by the 32 lanes of warp 0.
__device__ __forceinline__ void copy_box(uint8_t* box, const bf16* m,
                                         int rows, int cols, size_t ld,
                                         int r0, int c0, int box_rows,
                                         int lane) {
  for (int e = lane; e < box_rows * 8; e += 32) {
    const int r = e >> 3, u = e & 7;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    bf16* v = reinterpret_cast<bf16*>(&raw);
    if (r0 + r < rows) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c0 + u * 8 + j < cols) v[j] = m[(r0 + r) * ld + c0 + u * 8 + j];
    }
    *reinterpret_cast<uint4*>(box + swz(r, u * 8)) = raw;
  }
}

// Warp 0 fills ring slot q % kStages with stage q once all eight warps
// have consumed stage q - kStages: lane 0 by TMA, or all lanes by element
// loads (then each lane arrives).  Stage q: pass q / per (batch rows
// 16 pass ..), i = q % per; below n1 rows 64 i .. of wi / wg and columns
// 64 i .. of x; after, the tile's wo rows, columns 128 (i - n1) ...
__device__ __forceinline__ void produce(const Ffn& a, const Maps& maps,
                                        Smem& sm, int q, int per, int n1,
                                        int f0, int lane) {
  const int s = q % kStages;
  if (q >= kStages) sm90::mbar_wait(&sm.empty[s], (q / kStages - 1) & 1);
  const int b0 = q / per * kRows, i = q % per;
  uint8_t* st = sm.st[s];
  if (a.tma) {
    if (lane != 0) return;
    if (i < n1) {
      const uint32_t bytes = (a.kind != kGelu ? 2 : 1) * kBox + kXBox;
      sm90::mbar_arrive_expect_tx(&sm.full[s], bytes);
      sm90::tma_load_4d(st, &maps.wi, &sm.full[s], f0, i * kKC, 0, 0);
      if (a.kind != kGelu)
        sm90::tma_load_4d(st + kBox, &maps.wg, &sm.full[s], f0, i * kKC, 0,
                          0);
      sm90::tma_load_4d(st + 2 * kBox, &maps.x, &sm.full[s], i * kKC, b0, 0,
                        0);
    } else {
      const int d0 = (i - n1) * kDC;
      sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * kBox);
      sm90::tma_load_4d(st, &maps.wo, &sm.full[s], d0, f0, 0, 0);
      sm90::tma_load_4d(st + kBox, &maps.wo, &sm.full[s], d0 + 64, f0, 0, 0);
    }
    return;
  }
  if (i < n1) {
    copy_box(st, a.wi, a.Dm, a.F, a.F, i * kKC, f0, kKC, lane);
    if (a.kind != kGelu)
      copy_box(st + kBox, a.wg, a.Dm, a.F, a.F, i * kKC, f0, kKC, lane);
    copy_box(st + 2 * kBox, a.x, a.B, a.Dm, a.Dm, b0, i * kKC, kRows, lane);
  } else {
    const int d0 = (i - n1) * kDC;
    copy_box(st, a.wo, a.F, a.Dm, a.Dm, f0, d0, kFT, lane);
    copy_box(st + kBox, a.wo, a.F, a.Dm, a.Dm, f0, d0 + 64, kFT, lane);
  }
  sm90::mbar_arrive(&sm.full[s]);
}

// FFN block `tile`: scratch[tile, group, d, c] = sum over the tile's
// columns f of h[8 group + c, f] wo[f, d].  All eight warps consume the
// ring (warp w: in phase 1 the tile's columns 16 (w % 4) .. and k-steps
// 2 (w / 4), 2 (w / 4) + 1 of each stage; in phase 2 columns 16 w .. of
// each wo stage) and arrive on the stage's empty barrier; warp 0 also
// refills the slot, kStages stages ahead.
__device__ __forceinline__ void ffn_block(const Ffn& a, const Maps& maps,
                                          int tile, Smem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mw = warp & 3, kh = warp >> 2;
  const int f0 = tile * kFT;
  const bool gated = a.kind != kGelu;
  const int n1 = (a.Dm + kKC - 1) / kKC;
  const int per = n1 + (a.Dm + kDC - 1) / kDC;   // stages a pass
  const int total = (a.B + kRows - 1) / kRows * per;
  const int ngt = (a.B + 7) / 8;        // 8-row groups of the scratch
  // ldmatrix: lane gives row lane % 8 of matrix lane / 8, whose k offset
  // is 8 (m / 2) and m offset 8 (m % 2) (the A fragment's a0..a3)
  const int a_row = (lane >> 4) * 8 + (lane & 7);
  const int a_col = ((lane >> 3) & 1) * 8;
  // B / C fragments: row (n of B, m of C) lane / 4, column pair 2 (lane % 4)
  const int qrow = lane >> 2, qcol = 2 * (lane & 3);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.full[s], a.tma ? 1 : 32);
      sm90::mbar_init(&sm.empty[s], kThreads / 32);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (warp == 0)
    for (int q = 0; q < kStages && q < total; ++q)
      produce(a, maps, sm, q, per, n1, f0, lane);
  __syncwarp();

  float ci[2][4], cg[2][4];
  for (int q = 0; q < total; ++q) {
    const int b0 = q / per * kRows, i = q % per, s = q % kStages;
    const int ng = min(2, (a.B - b0 + 7) / 8);
    if (i == 0) {
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) ci[g][e] = cg[g][e] = 0.f;
    }
    if (i == n1) {
      // the two halves of x @ wi, x @ wg meet (first half + second), then
      // h = act(g) * i of the tile's columns as the pair hi + lo
      __syncthreads();  // the previous pass's h @ wo is done with h
      if (kh == 1) {
#pragma unroll
        for (int g = 0; g < 2; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sm.xch[mw][0][g][e][lane] = ci[g][e];
            sm.xch[mw][1][g][e][lane] = cg[g][e];
          }
      }
      __syncthreads();
      if (kh == 0) {
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          if (g < ng) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int f = mw * 16 + qrow + (e >> 1) * 8;
              const int b = g * 8 + qcol + (e & 1);
              const float iv = ci[g][e] + sm.xch[mw][0][g][e][lane];
              const float gv = cg[g][e] + sm.xch[mw][1][g][e][lane];
              const float hv = a.kind == kSwiglu  ? silu(gv) * iv
                               : a.kind == kGeglu ? gelu_tanh(gv) * iv
                                                  : gelu_tanh(iv);
              const bf16 hi = __float2bfloat16_rn(hv);
              sm.hhi[b * kW1 + f] = hi;
              sm.hlo[b * kW1 + f] =
                  __float2bfloat16_rn(hv - __bfloat162float(hi));
            }
          }
        }
      }
      __syncthreads();
    }
    sm90::mbar_wait(&sm.full[s], (q / kStages) & 1);
    const uint32_t st = sm90::smem_u32(sm.st[s]);
    if (i < n1) {
      // x @ wi, x @ wg: this warp's 16 columns, two of the four k-steps
      const uint8_t* xs = sm.st[s] + 2 * kBox;
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const int kk = 2 * kh + k2;
        const uint32_t off = swz(kk * 16 + a_row, mw * 16 + a_col);
        uint32_t ai[4], ag[4];
        ldsm_x4_t(ai, st + off);
        if (gated) ldsm_x4_t(ag, st + kBox + off);
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          if (g < ng) {
            const int r = g * 8 + qrow, c = kk * 16 + qcol;
            const uint32_t b0v = *reinterpret_cast<const uint32_t*>(
                xs + swz(r, c) + (c & 7) * 2);
            const uint32_t b1v = *reinterpret_cast<const uint32_t*>(
                xs + swz(r, c + 8) + (c & 7) * 2);
            mma16816(ci[g], ai, b0v, b1v);
            if (gated) mma16816(cg[g], ag, b0v, b1v);
          }
        }
      }
    } else {
      // h @ wo: this warp's 16 columns of the stage's 128, four k-steps
      float acc[2][4] = {};
      const uint32_t box = st + (warp >> 2) * kBox;
#pragma unroll
      for (int kk = 0; kk < kFT / 16; ++kk) {
        uint32_t aw[4];
        ldsm_x4_t(aw, box + swz(kk * 16 + a_row, (warp & 3) * 16 + a_col));
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          if (g < ng) {
            const int o = (g * 8 + qrow) * kW1 + kk * 16 + qcol;
            mma16816(acc[g], aw,
                     *reinterpret_cast<const uint32_t*>(sm.hhi + o),
                     *reinterpret_cast<const uint32_t*>(sm.hhi + o + 8));
            mma16816(acc[g], aw,
                     *reinterpret_cast<const uint32_t*>(sm.hlo + o),
                     *reinterpret_cast<const uint32_t*>(sm.hlo + o + 8));
          }
        }
      }
      const int d0 = (i - n1) * kDC + warp * 16 + qrow;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        if (g < ng) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int d = d0 + hf * 8;
            if (d < a.Dm)
              *reinterpret_cast<float2*>(
                  a.scratch +
                  (((size_t)tile * ngt + b0 / 8 + g) * a.Dm + d) * 8 + qcol) =
                  make_float2(acc[g][2 * hf], acc[g][2 * hf + 1]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&sm.empty[s]);
    if (warp == 0 && q + kStages < total)
      produce(a, maps, sm, q + kStages, per, n1, f0, lane);
    __syncwarp();
  }
}

}  // namespace ffn_tc

// (the FFN's ring is 1024-byte aligned inside the dynamic shared memory)
template <int D>
constexpr size_t tc_smem_bytes() {
  using Attn = decode_splits::Smem<__nv_bfloat16, D>;
  return sizeof(ffn_tc::Smem) + 1024 > sizeof(Attn)
             ? sizeof(ffn_tc::Smem) + 1024
             : sizeof(Attn);
}

// Blocks [0, n_tiles): FFN tiles; then the attention items (lane, KV
// head, split), split slowest.
template <int D, int MG>
__global__ void __launch_bounds__(ffn_tc::kThreads, MG > 4 ? 1 : 2)
dual_tc_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ kp,
               const __nv_bfloat16* __restrict__ vp,
               const int* __restrict__ bt, const int* __restrict__ seq_lens,
               ffn_tc::Ffn ffn, const __grid_constant__ ffn_tc::Maps maps,
               __nv_bfloat16* __restrict__ out,
               float2* __restrict__ part_ml, float* __restrict__ part_acc,
               int n_tiles, int H, int Hkv, int G, int page, int Tb,
               float scale) {
  static_assert(ffn_tc::kThreads == decode_splits::kThreads, "one block");
  extern __shared__ __align__(16) uint8_t dual_smem[];
  sm90::launch_dependents();           // the finishing grid may start now
  if ((int)blockIdx.x < n_tiles) {
    ffn_tc::ffn_block(ffn, maps, blockIdx.x,
                      *reinterpret_cast<ffn_tc::Smem*>(
                          sm90::align1024(dual_smem)));
    return;
  }
  const int a = blockIdx.x - n_tiles;
  const int lanes = ffn.B * Hkv;
  const int b = (a % lanes) / Hkv, hk = a % Hkv;
  const size_t row = (size_t)b * H * D;
  decode_splits::split_item<__nv_bfloat16, D, MG>(
      q + row, kp, vp, nullptr, nullptr, bt + (size_t)b * Tb, seq_lens[b], b,
      hk, a / lanes, ffn.B, H, Hkv, G, page, Tb, scale, out + row, part_ml,
      part_acc,
      *reinterpret_cast<decode_splits::Smem<__nv_bfloat16, D>*>(dual_smem));
}

// Blocks [0, n_sum): y = the tiles' partials summed in a fixed order,
// rounded once: block x covers 16 float4 units of the (groups, Dm, 8)
// partial; thread t sums unit t % 16 over chunk t / 16 of the tiles (tile
// order within a chunk of ceil(n_tiles / kSumChunks), its loads in flight
// together), then 64 threads add the chunks' sums in chunk order.  Then
// (lane, head group) blocks merging the attention splits.
template <int D>
__global__ void __launch_bounds__(ffn_tc::kThreads)
dual_finish_kernel(const float* __restrict__ scratch,
                   __nv_bfloat16* __restrict__ y, int n_tiles, int B, int Dm,
                   int n_sum, const int* __restrict__ seq_lens,
                   __nv_bfloat16* __restrict__ out,
                   const float2* __restrict__ part_ml,
                   const float* __restrict__ part_acc, int H, int max_keys,
                   int n_hy) {
  using ffn_tc::kSumChunks;
  constexpr int kUnits = ffn_tc::kThreads / kSumChunks;  // float4s a block
  __shared__ float4 red[kSumChunks][kUnits];
  sm90::grid_dependency_wait();        // the first grid's partials
  if ((int)blockIdx.x >= n_sum) {
    const int a = blockIdx.x - n_sum;
    decode_splits::combine_heads<D>(a / n_hy, a % n_hy, seq_lens, out,
                                    part_ml, part_acc, B, H, max_keys);
    return;
  }
  const size_t n4 = (size_t)((B + 7) / 8) * Dm * 2;   // float4s a tile
  const int c = threadIdx.x / kUnits;
  const size_t u = (size_t)blockIdx.x * kUnits + threadIdx.x % kUnits;
  const int per = (n_tiles + kSumChunks - 1) / kSumChunks;
  const int t1 = min(n_tiles, (c + 1) * per);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (u < n4) {
    const float4* p = reinterpret_cast<const float4*>(scratch) + u;
#pragma unroll 16
    for (int t = c * per; t < t1; ++t) {
      const float4 v = p[(size_t)t * n4];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  red[c][threadIdx.x % kUnits] = s;
  __syncthreads();
  if (threadIdx.x >= 4 * kUnits) return;
  const size_t i = 4 * ((size_t)blockIdx.x * kUnits) + threadIdx.x;
  if (i >= 4 * n4) return;
  const int b = (int)(i / ((size_t)Dm * 8)) * 8 + (int)(i % 8);
  if (b >= B) return;
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kSumChunks; ++k)
    sum += reinterpret_cast<const float*>(&red[k][threadIdx.x / 4])
        [threadIdx.x % 4];
  y[(size_t)b * Dm + (i / 8) % Dm] = __float2bfloat16_rn(sum);
}

// Byte offsets of the bf16 route's workspace: the attention splits'
// partials (paged_decode_splits.cuh), then the FFN tiles' partials.
struct TcLayout {
  decode_splits::Layout attn;
  size_t ffn, bytes;
};

inline TcLayout tc_layout(int B, int H, int D, int max_keys, int Dm,
                          int F) {
  TcLayout w;
  w.attn = decode_splits::workspace_layout(B, H, D, max_keys);
  w.ffn = (w.attn.bytes + 15) / 16 * 16;
  w.bytes = w.ffn + (size_t)((F + ffn_tc::kFT - 1) / ffn_tc::kFT) *
                        ((B + 7) / 8) * Dm * 8 * 4;
  return w;
}

template <int D, int MG>
int dual_tc(const __nv_bfloat16* q, const __nv_bfloat16* kp,
            const __nv_bfloat16* vp, const int* bt, const int* seq_lens,
            ffn_tc::Ffn ffn, const ffn_tc::Maps& maps, __nv_bfloat16* out,
            __nv_bfloat16* y, uint8_t* ws, const TcLayout& w, int H, int Hkv,
            int page, int Tb, float scale, int device, cudaStream_t st) {
  static bool smem_set[16] = {};
  if (!decode_splits::allow_smem(dual_tc_kernel<D, MG>, tc_smem_bytes<D>(),
                                 device, smem_set))
    return -1;
  const int B = ffn.B, max_keys = Tb * page;
  const int ns = decode_splits::n_splits(max_keys);
  const int n_tiles = (ffn.F + ffn_tc::kFT - 1) / ffn_tc::kFT;
  float2* ml = reinterpret_cast<float2*>(ws + w.attn.ml);
  float* acc = reinterpret_cast<float*>(ws + w.attn.acc);
  ffn.scratch = reinterpret_cast<float*>(ws + w.ffn);
  dual_tc_kernel<D, MG><<<n_tiles + B * Hkv * ns, ffn_tc::kThreads,
                      tc_smem_bytes<D>(), st>>>(
      q, kp, vp, bt, seq_lens, ffn, maps, out, ml, acc, n_tiles, H, Hkv,
      H / Hkv, page, Tb, scale);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  using C = decode_splits::CombineShape<D>;
  const int n_hy = (H + C::kHeads - 1) / C::kHeads;
  constexpr int kUnits = ffn_tc::kThreads / ffn_tc::kSumChunks;
  const int n_sum =
      (int)(((size_t)((B + 7) / 8) * ffn.Dm * 2 + kUnits - 1) / kUnits);
  const int n_comb = ns > 1 ? B * n_hy : 0;
  return static_cast<int>(sm90::launch_dependent(
      dual_finish_kernel<D>, dim3(n_sum + n_comb), dim3(ffn_tc::kThreads), 0,
      st, static_cast<const float*>(ffn.scratch), y, n_tiles, B, ffn.Dm,
      n_sum, seq_lens, out, static_cast<const float2*>(ml),
      static_cast<const float*>(acc), H, max_keys, n_hy));
}

// bf16 q, x, weights and pages: the tensor-core FFN and the key-split
// attention (a shape they do not take returns -1; nothing falls back to
// the CUDA-core kernel).
template <>
struct DualLaunch<__nv_bfloat16, __nv_bfloat16> {
  static int run(const void* q, const void* k, const void* v, const int* bt,
                 const int* seq_lens, const void* x, const void* wi,
                 const void* wg, const void* wo, void* out, void* y,
                 void* ws, long long bytes, int B, int H, int Hkv, int D,
                 int page, int Tb, int Dm, int F, int kind, float scale,
                 int device, cudaStream_t s) {
    using decode_splits::misaligned;
    const TcLayout w = tc_layout(B, H, D, Tb * page, Dm, F);
    if (ws == nullptr || bytes < (long long)w.bytes || misaligned(ws, 16) ||
        misaligned(k, 16) || misaligned(v, 16) || misaligned(out, 8))
      return -1;
    using bf16 = __nv_bfloat16;
    ffn_tc::Ffn ffn;
    ffn.x = static_cast<const bf16*>(x);
    ffn.wi = static_cast<const bf16*>(wi);
    ffn.wg = static_cast<const bf16*>(wg);
    ffn.wo = static_cast<const bf16*>(wo);
    ffn.scratch = nullptr;
    ffn.B = B;
    ffn.Dm = Dm;
    ffn.F = F;
    ffn.kind = kind;
    ffn.tma = F % 8 == 0 && Dm % 8 == 0 && !misaligned(x, 16) &&
              !misaligned(wi, 16) && !misaligned(wo, 16) &&
              (kind == kGelu || !misaligned(wg, 16));
    ffn_tc::Maps maps;
    memset(&maps, 0, sizeof(maps));
    if (ffn.tma &&
        !(sm90::bf16_matrix_map(&maps.wi, wi, Dm, F, 64, 64) &&
          (kind == kGelu ||
           sm90::bf16_matrix_map(&maps.wg, wg, Dm, F, 64, 64)) &&
          sm90::bf16_matrix_map(&maps.x, x, B, Dm, ffn_tc::kRows, 64) &&
          sm90::bf16_matrix_map(&maps.wo, wo, F, Dm, 64, 64)))
      return -1;
#define REPRO_DUAL(DD)                                                      \
  return H / Hkv <= 4                                                      \
             ? dual_tc<DD, 4>(static_cast<const bf16*>(q),                 \
                              static_cast<const bf16*>(k),                 \
                              static_cast<const bf16*>(v), bt, seq_lens,   \
                              ffn, maps, static_cast<bf16*>(out),          \
                              static_cast<bf16*>(y),                       \
                              static_cast<uint8_t*>(ws), w, H, Hkv, page,  \
                              Tb, scale, device, s)                        \
             : dual_tc<DD, 8>(static_cast<const bf16*>(q),                 \
                              static_cast<const bf16*>(k),                 \
                              static_cast<const bf16*>(v), bt, seq_lens,   \
                              ffn, maps, static_cast<bf16*>(out),          \
                              static_cast<bf16*>(y),                       \
                              static_cast<uint8_t*>(ws), w, H, Hkv, page,  \
                              Tb, scale, device, s)
    switch (D) {
      case 32: REPRO_DUAL(32);
      case 64: REPRO_DUAL(64);
      case 128: REPRO_DUAL(128);
      default: return -1;
    }
#undef REPRO_DUAL
  }
};

}  // namespace

extern "C" {

// Returns 0 on success, -1 for an argument the kernel does not take, else
// the cudaError_t of a launch.  kind: 0 swiglu, 1 geglu, 2 gelu.  q_bf16:
// q, x, the weights and both outputs are bfloat16 (1) or fp32 (0); kv_bf16
// likewise for the pools.  The workspace is device memory of at least
// fused_dual_branch_workspace_bytes(...) bytes, 16-byte aligned.  Both
// launches go on `stream`; nothing synchronises.
int fused_dual_branch_decode(const void* q, const void* k, const void* v,
                             const int* bt, const int* seq_lens,
                             const void* x, const void* wi, const void* wg,
                             const void* wo, void* out, void* y,
                             void* workspace, int B, int H, int Hkv, int D,
                             int page, int Tb, int Dm, int F, int kind,
                             float scale, int q_bf16, int kv_bf16,
                             int device, void* stream,
                             long long workspace_bytes) {
  if (B == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG || page <= 0 || Tb <= 0 ||
      Dm <= 0 || F <= 0 || kind < kSwiglu || kind > kGelu ||
      (kind != kGelu && wg == nullptr))
    return -1;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return by_dtypes<DualLaunch>(q_bf16, kv_bf16, q, k, v, bt, seq_lens, x, wi,
                               wg, wo, out, y, workspace, workspace_bytes, B,
                               H, Hkv, D, page, Tb, Dm, F, kind, scale,
                               device, static_cast<cudaStream_t>(stream));
}

// Bytes of the workspace for these arguments: the bf16 route's attention
// and FFN partials, or the CUDA-core route's FFN scratch.
long long fused_dual_branch_workspace_bytes(int B, int H, int Hkv, int D,
                                            int page, int Tb, int Dm, int F,
                                            int q_bf16, int kv_bf16) {
  if (B <= 0 || Hkv <= 0 || page <= 0 || Tb <= 0 || Dm <= 0 || F <= 0)
    return 0;
  if (q_bf16 && kv_bf16)
    return (long long)tc_layout(B, H, D, Tb * page, Dm, F).bytes;
  return (long long)core_scratch_bytes(B, Dm, F);
}

const char* dual_branch_error_string(int code) {
  if (code == -1) return "argument not supported by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
