// Fused dual-branch decode for Hopper (sm_90a): the paged attention of one
// decode token per lane || one dense FFN row per lane, in one launch.  It is
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
//   gelu), gelu(x @ wi) @ wo for gelu, computed in fp32 with one rounding
//   at each output, as _dual_kernel does.
//
// What bounds it on this card: bytes.  At the serving shape (B = 8,
// llama3.2-3b: Dm 3072, F 8192, bf16) the FFN weights are 151 MB and do
// 2 * B flops per weight element read, 8 per byte; the attention half does
// about 6 per byte.  Both sit far below the ~295 flops per byte where the
// tensor cores would limit, so the design streams the weights once:
//   * two kinds of thread block in one grid.  Blocks [0, n_tiles) are FFN
//     blocks; the rest are attention blocks, one per (lane, KV head),
//     running exactly the decode kernel's attend_block (paged_common.cuh).
//     The TPU interleaved the two on one sequential grid; here they run side
//     by side on the SMs;
//   * an FFN block owns a tile of kFT = 64 columns of F (128 contiguous
//     bytes per weight row in bf16, 256 in fp32; the TPU's F / (Hkv * T)
//     would be 16 bytes at T = 128).  It reads its wi / wg columns with
//     16-byte loads for all B rows at once (kRB rows per pass, x staged in
//     shared memory), each thread keeping kUnroll rows' loads in flight,
//     forms h = act(g) * i in fp32 in shared memory, then multiplies h by
//     its kFT rows of wo and writes an fp32 partial (B, Dm) to
//     scratch[tile];
//   * a second small launch sums the partials in tile order, so a run gives
//     the same bits every time (no float atomics), and rounds once;
//   * a ragged last tile is masked; any F, Dm and B are taken (16-byte loads
//     where the row strides allow them, element loads otherwise).
// The wrapper allocates out, y and the (n_tiles, B, Dm) fp32 scratch.  No
// library GEMM is called: the FFN is computed here, as the TPU kernel
// computes it in its own body.  Tensor cores (wgmma) for larger B, TMA and
// split-K over pages for the attention blocks are later work.

#include "paged_common.cuh"

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
  attend_block<TQ, TKV, D>(q + row * D, kp, vp, bt + (size_t)b * Tb, n_keys,
                           h, Hkv, G, page, scale, out + row * D, sm.attn);
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

template <typename TQ, typename TKV>
struct DualLaunch {
  static int run(const void* q, const void* k, const void* v, const int* bt,
                 const int* seq_lens, const void* x, const void* wi,
                 const void* wg, const void* wo, void* out, void* y,
                 float* scratch, int B, int H, int Hkv, int D, int page,
                 int Tb, int Dm, int F, int kind, float scale,
                 cudaStream_t s) {
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

}  // namespace

extern "C" {

// Returns 0 on success, -1 for an argument the kernel does not take, else
// the cudaError_t of a launch.  kind: 0 swiglu, 1 geglu, 2 gelu.  q_bf16:
// q, x, the weights and both outputs are bfloat16 (1) or fp32 (0); kv_bf16
// likewise for the pools.  scratch holds ceil(F / 64) * B * Dm floats.
// Both launches go on `stream`; nothing synchronises.
int fused_dual_branch_decode(const void* q, const void* k, const void* v,
                             const int* bt, const int* seq_lens,
                             const void* x, const void* wi, const void* wg,
                             const void* wo, void* out, void* y,
                             float* scratch, int B, int H, int Hkv, int D,
                             int page, int Tb, int Dm, int F, int kind,
                             float scale, int q_bf16, int kv_bf16,
                             int device, void* stream) {
  if (B == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG || page <= 0 || Tb <= 0 ||
      Dm <= 0 || F <= 0 || kind < kSwiglu || kind > kGelu ||
      (kind != kGelu && wg == nullptr))
    return -1;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return by_dtypes<DualLaunch>(q_bf16, kv_bf16, q, k, v, bt, seq_lens, x, wi,
                               wg, wo, out, y, scratch, B, H, Hkv, D, page,
                               Tb, Dm, F, kind, scale,
                               static_cast<cudaStream_t>(stream));
}

const char* dual_branch_error_string(int code) {
  if (code == -1) return "argument not supported by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
