// Paged GQA attention for Hopper (sm_90a) in the three layouts the serving
// paths use.  Each kernel launches one thread block per (query row, KV head)
// and runs paged_common.cuh's attend_block; the layouts differ only in how a
// block finds its query row, its sequence's block-table row and the number
// of keys it sees.  Bounded by bytes; see paged_common.cuh for the design.
// The exceptions: the packed and the chunk layouts with bf16 q on bf16, int8
// or fp8 pages run on the tensor cores (paged_packed_tc.cuh), and the decode
// layout with bf16 q on the same three page types runs key splits with a
// pipelined gather (paged_decode_splits.cuh).
//
// paged_packed_attention -- replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py:346 (body _paged_packed_kernel,
//   :292), with its int8/fp8 row-scale variant.  Oracle ref.py:119.
//   q (T, H, D); block_tables (S, Tb); tok_slot, tok_pos (T,) -> (T, H, D).
//   Token t reads table row tok_slot[t], keys k <= tok_pos[t]; tok_pos == -1
//   writes zeros.  Grid (T, Hkv) for fp32 q or fp32 pages; bf16 q on bf16,
//   int8 or fp8 pages: paged_packed_tc.cuh's plan, attention and combine
//   kernels over a caller's workspace, chosen by type (the only route for
//   those pairs).
//
// paged_decode_attention -- replaces src/repro/kernels/paged_attention.py:106
//   (body _paged_kernel, :53), with its scale variant.  Oracle ref.py:45.
//   q (B, H, D); block_tables (B, Tb); seq_lens (B,) -> (B, H, D).
//   Lane b reads table row b, keys k < seq_lens[b]; seq_lens[b] == 0 writes
//   zeros, as the Pallas kernel does (ref.py's oracle gives the mean of V
//   there).  Grid (B, Hkv) for fp32 q or fp32 pages; bf16 q on bf16, int8
//   or fp8 pages: paged_decode_splits.cuh's (B * Hkv, key splits) grid and
//   combine kernel over a caller's workspace, chosen by type (the only
//   route for those pairs).
//
// paged_chunk_attention -- replaces src/repro/kernels/paged_attention.py:222
//   (body _paged_chunk_kernel, :161), with its scale variant.  Oracle
//   ref.py:76.  q (B, C, H, D); block_tables (B, Tb); pos, n_valid (B,)
//   -> (B, C, H, D).  Row (b, c) reads table row b, keys
//   k <= min(pos + c, pos + n_valid - 1); a row with no visible key writes
//   zeros.  Rows past n_valid are defined by the same rule.  Grid (B*C, Hkv)
//   for fp32 q or fp32 pages; bf16 q on bf16, int8 or fp8 pages:
//   paged_packed_tc.cuh's attention kernel over chunk items (64 / G rows of
//   a lane, KV head, key split; no plan kernel), with key splits and the
//   combine only when the row-tile items are few (its partials in a caller's
//   workspace, paged_chunk_workspace_bytes), chosen by type (the only route
//   for those pairs).
//
// The pools are (P, page, Hkv, D) in TKV, q and the output in TQ; every
// index array is int32.  int8 / fp8 pools come with (P, page) fp32 row
// scales ks / vs (null for bf16 / fp32 pools), dequantized at the load
// (paged_common.cuh).  Nothing is allocated and nothing synchronises.

#include "paged_common.cuh"
#include "paged_decode_splits.cuh"
#include "paged_packed_tc.cuh"

namespace {

using namespace repro_paged;

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
paged_packed_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ bt,
                    const int* __restrict__ tok_slot,
                    const int* __restrict__ tok_pos, TQ* __restrict__ out,
                    int H, int Hkv, int G, int page, int Tb, float scale) {
  __shared__ AttnSmem<TKV, D> sm;
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int pos = tok_pos[t];
  const int n_keys = pos < 0 ? 0 : min(pos + 1, Tb * page);
  const size_t row = (size_t)t * H + (size_t)h * G;
  attend_block<TQ, TKV, D>(q + row * D, kp, vp, ks, vs,
                           bt + (size_t)tok_slot[t] * Tb, n_keys, h, Hkv, G,
                           page, scale, out + row * D, sm);
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ bt,
                    const int* __restrict__ seq_lens, TQ* __restrict__ out,
                    int H, int Hkv, int G, int page, int Tb, float scale) {
  __shared__ AttnSmem<TKV, D> sm;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int n_keys = min(seq_lens[b], Tb * page);
  const size_t row = (size_t)b * H + (size_t)h * G;
  attend_block<TQ, TKV, D>(q + row * D, kp, vp, ks, vs, bt + (size_t)b * Tb,
                           n_keys, h, Hkv, G, page, scale, out + row * D, sm);
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                   const TKV* __restrict__ vp, const float* __restrict__ ks,
                   const float* __restrict__ vs, const int* __restrict__ bt,
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
  attend_block<TQ, TKV, D>(q + row * D, kp, vp, ks, vs, bt + (size_t)b * Tb,
                           n_keys, h, Hkv, G, page, scale, out + row * D, sm);
}

// The workspace (ws, bytes) is the tensor-core route's; the attend_block
// route takes none.
template <typename TQ, typename TKV>
struct PackedLaunch {
  static int run(const void* q, const void* k, const void* v,
                 const float* ks, const float* vs, const int* bt,
                 const int* tok_slot, const int* tok_pos, void* out, int T,
                 int H, int Hkv, int D, int page, int Tb, float scale,
                 void* /*ws*/, long long /*bytes*/, int /*device*/,
                 cudaStream_t s) {
    const dim3 grid(T, Hkv);
#define REPRO_LAUNCH(DD)                                                    \
  paged_packed_kernel<TQ, TKV, DD><<<grid, kThreads, 0, s>>>(               \
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),                \
      static_cast<const TKV*>(v), ks, vs, bt, tok_slot, tok_pos,            \
      static_cast<TQ*>(out), H, Hkv, H / Hkv, page, Tb, scale)
    REPRO_SWITCH_HEAD_DIM(D, REPRO_LAUNCH)
#undef REPRO_LAUNCH
    return static_cast<int>(cudaGetLastError());
  }
};

// bf16 q on bf16, int8 or fp8 e4m3 pages: the tensor-core kernels (a
// shape they do not take returns -1; nothing falls back to attend_block).
template <typename TKV>
struct TensorCoreLaunch {
  static int run(const void* q, const void* k, const void* v,
                 const float* ks, const float* vs, const int* bt,
                 const int* tok_slot, const int* tok_pos, void* out, int T,
                 int H, int Hkv, int D, int page, int Tb, float scale,
                 void* ws, long long bytes, int device, cudaStream_t s) {
    return packed_tc::launch<TKV>(q, k, v, ks, vs, bt, tok_slot, tok_pos,
                                  out, T, H, Hkv, D, page, Tb, scale, ws,
                                  bytes, device, s);
  }
};
template <>
struct PackedLaunch<__nv_bfloat16, __nv_bfloat16>
    : TensorCoreLaunch<__nv_bfloat16> {};
template <>
struct PackedLaunch<__nv_bfloat16, int8_t> : TensorCoreLaunch<int8_t> {};
template <>
struct PackedLaunch<__nv_bfloat16, __nv_fp8_e4m3>
    : TensorCoreLaunch<__nv_fp8_e4m3> {};

// The workspace (ws, bytes) is the key-split route's; the attend_block
// route takes none.
template <typename TQ, typename TKV>
struct DecodeLaunch {
  static int run(const void* q, const void* k, const void* v,
                 const float* ks, const float* vs, const int* bt,
                 const int* seq_lens, void* out, int B, int H, int Hkv, int D,
                 int page, int Tb, float scale, void* /*ws*/,
                 long long /*bytes*/, int /*device*/, cudaStream_t s) {
    const dim3 grid(B, Hkv);
#define REPRO_LAUNCH(DD)                                                    \
  paged_decode_kernel<TQ, TKV, DD><<<grid, kThreads, 0, s>>>(               \
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),                \
      static_cast<const TKV*>(v), ks, vs, bt, seq_lens,                     \
      static_cast<TQ*>(out), H, Hkv, H / Hkv, page, Tb, scale)
    REPRO_SWITCH_HEAD_DIM(D, REPRO_LAUNCH)
#undef REPRO_LAUNCH
    return static_cast<int>(cudaGetLastError());
  }
};

// bf16 q on bf16, int8 or fp8 e4m3 pages: the key-split kernels (a shape
// they do not take returns -1; nothing falls back to attend_block).
template <typename TKV>
struct SplitDecodeLaunch {
  static int run(const void* q, const void* k, const void* v,
                 const float* ks, const float* vs, const int* bt,
                 const int* seq_lens, void* out, int B, int H, int Hkv, int D,
                 int page, int Tb, float scale, void* ws, long long bytes,
                 int device, cudaStream_t s) {
    return decode_splits::launch<TKV>(q, k, v, ks, vs, bt, seq_lens, out, B,
                                      H, Hkv, D, page, Tb, scale, ws, bytes,
                                      device, s);
  }
};
template <>
struct DecodeLaunch<__nv_bfloat16, __nv_bfloat16>
    : SplitDecodeLaunch<__nv_bfloat16> {};
template <>
struct DecodeLaunch<__nv_bfloat16, int8_t> : SplitDecodeLaunch<int8_t> {};
template <>
struct DecodeLaunch<__nv_bfloat16, __nv_fp8_e4m3>
    : SplitDecodeLaunch<__nv_fp8_e4m3> {};

// The workspace (ws, bytes) is the tensor-core route's; the attend_block
// route takes none.
template <typename TQ, typename TKV>
struct ChunkLaunch {
  static int run(const void* q, const void* k, const void* v,
                 const float* ks, const float* vs, const int* bt,
                 const int* pos, const int* n_valid, void* out, int B, int C,
                 int H, int Hkv, int D, int page, int Tb, float scale,
                 void* /*ws*/, long long /*bytes*/, int /*device*/,
                 cudaStream_t s) {
    const dim3 grid(B * C, Hkv);
#define REPRO_LAUNCH(DD)                                                    \
  paged_chunk_kernel<TQ, TKV, DD><<<grid, kThreads, 0, s>>>(                \
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),                \
      static_cast<const TKV*>(v), ks, vs, bt, pos, n_valid,                 \
      static_cast<TQ*>(out), C, H, Hkv, H / Hkv, page, Tb, scale)
    REPRO_SWITCH_HEAD_DIM(D, REPRO_LAUNCH)
#undef REPRO_LAUNCH
    return static_cast<int>(cudaGetLastError());
  }
};

// bf16 q on bf16, int8 or fp8 e4m3 pages: the tensor-core kernels over
// chunk items (a shape they do not take returns -1; nothing falls back to
// attend_block).
template <typename TKV>
struct TensorCoreChunkLaunch {
  static int run(const void* q, const void* k, const void* v,
                 const float* ks, const float* vs, const int* bt,
                 const int* pos, const int* n_valid, void* out, int B, int C,
                 int H, int Hkv, int D, int page, int Tb, float scale,
                 void* ws, long long bytes, int device, cudaStream_t s) {
    return packed_tc::launch_chunk<TKV>(q, k, v, ks, vs, bt, pos, n_valid,
                                        out, B, C, H, Hkv, D, page, Tb,
                                        scale, ws, bytes, device, s);
  }
};
template <>
struct ChunkLaunch<__nv_bfloat16, __nv_bfloat16>
    : TensorCoreChunkLaunch<__nv_bfloat16> {};
template <>
struct ChunkLaunch<__nv_bfloat16, int8_t> : TensorCoreChunkLaunch<int8_t> {};
template <>
struct ChunkLaunch<__nv_bfloat16, __nv_fp8_e4m3>
    : TensorCoreChunkLaunch<__nv_fp8_e4m3> {};

// -1 for a shape the kernels do not take, or scales that do not match the
// page type (types 2 and 3 need both, 0 and 1 take none), else the
// cudaError_t of cudaSetDevice (0 on success).
int prologue(int H, int Hkv, int page, int Tb, int kv_type, const float* ks,
             const float* vs, int device) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG || page <= 0 || Tb <= 0)
    return -1;
  const bool scaled = kv_type == 2 || kv_type == 3;
  if (scaled != (ks != nullptr) || scaled != (vs != nullptr)) return -1;
  return static_cast<int>(cudaSetDevice(device));
}

}  // namespace

extern "C" {

// Each entry returns 0 on success, -1 for an argument the kernel does not
// take, else the cudaError_t of the launch.  q_bf16: 1 = bfloat16, 0 =
// fp32.  kv_type: 0 fp32, 1 bfloat16, 2 int8, 3 fp8 e4m3; ks / vs are the
// (P, page) fp32 row scales of types 2 and 3 and null otherwise.  The
// launch goes on `stream` and does not synchronise.
//
// paged_packed_attention's workspace is device memory of at least
// paged_packed_workspace_bytes(...) bytes (0 for fp32 q or fp32 pages; the
// tensor-core kernels of bf16 q on bf16, int8 or fp8 pages keep their work
// list and split partials there; null when 0).
int paged_packed_attention(const void* q, const void* k, const void* v,
                           const float* ks, const float* vs, const int* bt,
                           const int* tok_slot, const int* tok_pos,
                           void* out, int T, int H, int Hkv, int D,
                           int page, int Tb, float scale,
                           int q_bf16, int kv_type, int device,
                           void* stream, void* workspace,
                           long long workspace_bytes) {
  if (T == 0) return 0;
  const int err = prologue(H, Hkv, page, Tb, kv_type, ks, vs, device);
  if (err) return err;
  return by_kv_types<PackedLaunch>(q_bf16, kv_type, q, k, v, ks, vs, bt,
                                   tok_slot, tok_pos, out, T, H, Hkv, D,
                                   page, Tb, scale, workspace,
                                   workspace_bytes, device,
                                   static_cast<cudaStream_t>(stream));
}

long long paged_packed_workspace_bytes(int T, int H, int Hkv, int D,
                                       int page, int Tb, int q_bf16,
                                       int kv_type) {
  if (!q_bf16 || kv_type < 1 || kv_type > 3 || T <= 0 || Hkv <= 0) return 0;
  return (long long)packed_tc::workspace_layout(T, H, Hkv, D, Tb * page)
      .bytes;
}

// The tensor-core route's plan kernel alone: the work list of a tick into
// the workspace (int32 count at byte 0, int4 items from byte 16).
int paged_packed_plan(const int* tok_slot, const int* tok_pos, int T, int H,
                      int Hkv, int D, int page, int Tb, void* workspace,
                      long long workspace_bytes, int device, void* stream) {
  if (T <= 0 || Hkv <= 0 || H % Hkv || H / Hkv > repro_paged::kMaxG ||
      page <= 0 || Tb <= 0)
    return -1;
  const int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  return packed_tc::plan(tok_slot, tok_pos, T, H, Hkv, D, page, Tb,
                         workspace, workspace_bytes,
                         static_cast<cudaStream_t>(stream));
}

// paged_decode_attention's workspace is device memory of at least
// paged_decode_workspace_bytes(...) bytes (0 unless bf16 q on bf16, int8 or
// fp8 pages whose table can hold more than one key split; null when 0).
int paged_decode_attention(const void* q, const void* k, const void* v,
                           const float* ks, const float* vs, const int* bt,
                           const int* seq_lens, void* out, int B, int H,
                           int Hkv, int D, int page, int Tb, float scale,
                           int q_bf16, int kv_type, int device,
                           void* stream, void* workspace,
                           long long workspace_bytes) {
  if (B == 0) return 0;
  const int err = prologue(H, Hkv, page, Tb, kv_type, ks, vs, device);
  if (err) return err;
  return by_kv_types<DecodeLaunch>(q_bf16, kv_type, q, k, v, ks, vs, bt,
                                   seq_lens, out, B, H, Hkv, D, page, Tb,
                                   scale, workspace, workspace_bytes, device,
                                   static_cast<cudaStream_t>(stream));
}

long long paged_decode_workspace_bytes(int B, int H, int Hkv, int D,
                                       int page, int Tb, int q_bf16,
                                       int kv_type) {
  if (!q_bf16 || kv_type < 1 || kv_type > 3 || B <= 0 || Hkv <= 0 ||
      page <= 0 || Tb <= 0)
    return 0;
  return (long long)decode_splits::workspace_layout(B, H, D, Tb * page)
      .bytes;
}

// paged_chunk_attention's workspace is device memory of at least
// paged_chunk_workspace_bytes(...) bytes (0 unless bf16 q on bf16, int8 or
// fp8 pages whose chunk the tensor-core route cuts into key splits: few
// row-tile items and a table of more than one split; null when 0).
int paged_chunk_attention(const void* q, const void* k, const void* v,
                          const float* ks, const float* vs, const int* bt,
                          const int* pos, const int* n_valid, void* out,
                          int B, int C, int H, int Hkv, int D, int page,
                          int Tb, float scale, int q_bf16, int kv_type,
                          int device, void* stream, void* workspace,
                          long long workspace_bytes) {
  if (B == 0 || C == 0) return 0;
  const int err = prologue(H, Hkv, page, Tb, kv_type, ks, vs, device);
  if (err) return err;
  return by_kv_types<ChunkLaunch>(q_bf16, kv_type, q, k, v, ks, vs, bt, pos,
                                  n_valid, out, B, C, H, Hkv, D, page, Tb,
                                  scale, workspace, workspace_bytes, device,
                                  static_cast<cudaStream_t>(stream));
}

long long paged_chunk_workspace_bytes(int B, int C, int H, int Hkv, int D,
                                      int page, int Tb, int q_bf16,
                                      int kv_type) {
  if (!q_bf16 || kv_type < 1 || kv_type > 3 || B <= 0 || C <= 0 ||
      Hkv <= 0 || H % Hkv || H / Hkv > repro_paged::kMaxG || page <= 0 ||
      Tb <= 0)
    return 0;
  return (long long)packed_tc::chunk_plan(B, C, H, Hkv, D, Tb * page)
      .w.bytes;
}

const char* paged_attention_error_string(int code) {
  if (code == -1) return "argument not supported by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
