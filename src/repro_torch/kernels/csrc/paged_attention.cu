// Paged GQA attention for Hopper (sm_90a) in the three layouts the serving
// paths use.  Each kernel launches one thread block per (query row, KV head)
// and runs paged_common.cuh's attend_block; the layouts differ only in how a
// block finds its query row, its sequence's block-table row and the number
// of keys it sees.  Bounded by bytes; see paged_common.cuh for the design.
//
// paged_packed_attention -- replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py:346 (body _paged_packed_kernel,
//   :292), without the int8/fp8 row-scale variant.  Oracle ref.py:119.
//   q (T, H, D); block_tables (S, Tb); tok_slot, tok_pos (T,) -> (T, H, D).
//   Token t reads table row tok_slot[t], keys k <= tok_pos[t]; tok_pos == -1
//   writes zeros.  Grid (T, Hkv).
//
// paged_decode_attention -- replaces src/repro/kernels/paged_attention.py:106
//   (body _paged_kernel, :53), without the scale variant.  Oracle ref.py:45.
//   q (B, H, D); block_tables (B, Tb); seq_lens (B,) -> (B, H, D).
//   Lane b reads table row b, keys k < seq_lens[b]; seq_lens[b] == 0 writes
//   zeros, as the Pallas kernel does (ref.py's oracle gives the mean of V
//   there).  Grid (B, Hkv).
//
// paged_chunk_attention -- replaces src/repro/kernels/paged_attention.py:222
//   (body _paged_chunk_kernel, :161), without the scale variant.  Oracle
//   ref.py:76.  q (B, C, H, D); block_tables (B, Tb); pos, n_valid (B,)
//   -> (B, C, H, D).  Row (b, c) reads table row b, keys
//   k <= min(pos + c, pos + n_valid - 1); a row with no visible key writes
//   zeros.  Rows past n_valid are defined by the same rule.  Grid (B*C, Hkv).
//
// The pools are (P, page, Hkv, D) in TKV, q and the output in TQ; every
// index array is int32.  Nothing is allocated and nothing synchronises.

#include "paged_common.cuh"

namespace {

using namespace repro_paged;

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
paged_packed_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ tok_slot,
                    const int* __restrict__ tok_pos, TQ* __restrict__ out,
                    int H, int Hkv, int G, int page, int Tb, float scale) {
  __shared__ AttnSmem<TKV, D> sm;
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int pos = tok_pos[t];
  const int n_keys = pos < 0 ? 0 : min(pos + 1, Tb * page);
  const size_t row = (size_t)t * H + (size_t)h * G;
  attend_block<TQ, TKV, D>(q + row * D, kp, vp,
                           bt + (size_t)tok_slot[t] * Tb, n_keys, h, Hkv, G,
                           page, scale, out + row * D, sm);
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ seq_lens, TQ* __restrict__ out,
                    int H, int Hkv, int G, int page, int Tb, float scale) {
  __shared__ AttnSmem<TKV, D> sm;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int n_keys = min(seq_lens[b], Tb * page);
  const size_t row = (size_t)b * H + (size_t)h * G;
  attend_block<TQ, TKV, D>(q + row * D, kp, vp, bt + (size_t)b * Tb, n_keys,
                           h, Hkv, G, page, scale, out + row * D, sm);
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                   const TKV* __restrict__ vp, const int* __restrict__ bt,
                   const int* __restrict__ pos, const int* __restrict__ n_valid,
                   TQ* __restrict__ out, int C, int H, int Hkv, int G,
                   int page, int Tb, float scale) {
  __shared__ AttnSmem<TKV, D> sm;
  const int r = blockIdx.x;  // (b, c) row of the chunk
  const int h = blockIdx.y;
  const int b = r / C;
  const int c = r % C;
  // causal within the chunk, and only the lane's live history
  const int last = min(pos[b] + c, pos[b] + n_valid[b] - 1);
  const int n_keys = min(last + 1, Tb * page);
  const size_t row = (size_t)r * H + (size_t)h * G;
  attend_block<TQ, TKV, D>(q + row * D, kp, vp, bt + (size_t)b * Tb, n_keys,
                           h, Hkv, G, page, scale, out + row * D, sm);
}

template <typename TQ, typename TKV>
struct PackedLaunch {
  static int run(const void* q, const void* k, const void* v, const int* bt,
                 const int* tok_slot, const int* tok_pos, void* out, int T,
                 int H, int Hkv, int D, int page, int Tb, float scale,
                 cudaStream_t s) {
    const dim3 grid(T, Hkv);
#define REPRO_LAUNCH(DD)                                                    \
  paged_packed_kernel<TQ, TKV, DD><<<grid, kThreads, 0, s>>>(               \
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),                \
      static_cast<const TKV*>(v), bt, tok_slot, tok_pos,                    \
      static_cast<TQ*>(out), H, Hkv, H / Hkv, page, Tb, scale)
    REPRO_SWITCH_HEAD_DIM(D, REPRO_LAUNCH)
#undef REPRO_LAUNCH
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename TQ, typename TKV>
struct DecodeLaunch {
  static int run(const void* q, const void* k, const void* v, const int* bt,
                 const int* seq_lens, void* out, int B, int H, int Hkv, int D,
                 int page, int Tb, float scale, cudaStream_t s) {
    const dim3 grid(B, Hkv);
#define REPRO_LAUNCH(DD)                                                    \
  paged_decode_kernel<TQ, TKV, DD><<<grid, kThreads, 0, s>>>(               \
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),                \
      static_cast<const TKV*>(v), bt, seq_lens, static_cast<TQ*>(out), H,   \
      Hkv, H / Hkv, page, Tb, scale)
    REPRO_SWITCH_HEAD_DIM(D, REPRO_LAUNCH)
#undef REPRO_LAUNCH
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename TQ, typename TKV>
struct ChunkLaunch {
  static int run(const void* q, const void* k, const void* v, const int* bt,
                 const int* pos, const int* n_valid, void* out, int B, int C,
                 int H, int Hkv, int D, int page, int Tb, float scale,
                 cudaStream_t s) {
    const dim3 grid(B * C, Hkv);
#define REPRO_LAUNCH(DD)                                                    \
  paged_chunk_kernel<TQ, TKV, DD><<<grid, kThreads, 0, s>>>(                \
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),                \
      static_cast<const TKV*>(v), bt, pos, n_valid, static_cast<TQ*>(out),  \
      C, H, Hkv, H / Hkv, page, Tb, scale)
    REPRO_SWITCH_HEAD_DIM(D, REPRO_LAUNCH)
#undef REPRO_LAUNCH
    return static_cast<int>(cudaGetLastError());
  }
};

// -1 for a shape the kernels do not take, else the cudaError_t of
// cudaSetDevice (0 on success).
int prologue(int H, int Hkv, int page, int Tb, int device) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG || page <= 0 || Tb <= 0)
    return -1;
  return static_cast<int>(cudaSetDevice(device));
}

}  // namespace

extern "C" {

// Each entry returns 0 on success, -1 for an argument the kernel does not
// take, else the cudaError_t of the launch.  q_bf16 / kv_bf16: 1 =
// bfloat16, 0 = fp32.  The launch goes on `stream` and does not synchronise.
int paged_packed_attention(const void* q, const void* k, const void* v,
                           const int* bt, const int* tok_slot,
                           const int* tok_pos, void* out, int T, int H,
                           int Hkv, int D, int page, int Tb, float scale,
                           int q_bf16, int kv_bf16, int device,
                           void* stream) {
  if (T == 0) return 0;
  const int err = prologue(H, Hkv, page, Tb, device);
  if (err) return err;
  return by_dtypes<PackedLaunch>(q_bf16, kv_bf16, q, k, v, bt, tok_slot,
                                 tok_pos, out, T, H, Hkv, D, page, Tb, scale,
                                 static_cast<cudaStream_t>(stream));
}

int paged_decode_attention(const void* q, const void* k, const void* v,
                           const int* bt, const int* seq_lens, void* out,
                           int B, int H, int Hkv, int D, int page, int Tb,
                           float scale, int q_bf16, int kv_bf16, int device,
                           void* stream) {
  if (B == 0) return 0;
  const int err = prologue(H, Hkv, page, Tb, device);
  if (err) return err;
  return by_dtypes<DecodeLaunch>(q_bf16, kv_bf16, q, k, v, bt, seq_lens, out,
                                 B, H, Hkv, D, page, Tb, scale,
                                 static_cast<cudaStream_t>(stream));
}

int paged_chunk_attention(const void* q, const void* k, const void* v,
                          const int* bt, const int* pos, const int* n_valid,
                          void* out, int B, int C, int H, int Hkv, int D,
                          int page, int Tb, float scale, int q_bf16,
                          int kv_bf16, int device, void* stream) {
  if (B == 0 || C == 0) return 0;
  const int err = prologue(H, Hkv, page, Tb, device);
  if (err) return err;
  return by_dtypes<ChunkLaunch>(q_bf16, kv_bf16, q, k, v, bt, pos, n_valid,
                                out, B, C, H, Hkv, D, page, Tb, scale,
                                static_cast<cudaStream_t>(stream));
}

const char* paged_attention_error_string(int code) {
  if (code == -1) return "argument not supported by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
