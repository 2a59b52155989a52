// Hopper (sm_90a) building blocks for hand-written kernels: shared-memory
// addresses, mbarriers, TMA tile loads, cp.async copies, wgmma descriptors
// and the bf16 wgmma shapes the attention kernels use, the tile layout and
// the wgmma sequences over it (flash_attention.cu, paged_packed_tc.cuh),
// register rebalancing between warpgroups, and the host-side encoding of
// TMA tensor maps.
//
// Everything is raw PTX through inline asm (PTX ISA 8.0: cp.async.bulk.tensor,
// cp.async, mbarrier.*.expect_tx, wgmma.mma_async, setmaxnreg); no CUTLASS.
// The
// driver's cuTensorMapEncodeTiled is reached through the runtime's
// cudaGetDriverEntryPoint, so a library that includes this header does not
// link against libcuda.
//
// Shared-memory tile layout (what TMA writes with a swizzle and wgmma reads
// back through a descriptor of the same swizzle): a tile of R rows and D
// bf16 columns is stored as D / C column chunks of C = 64 elements (128-byte
// rows, 128B swizzle) or, for D = 32, one chunk of C = 32 (64-byte rows,
// 64B swizzle); chunk c holds rows 0..R-1 of columns cC..cC+C-1, R rows of
// C * 2 bytes each.  Every chunk starts on a 1024-byte boundary.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and to the
// other threads; follow with __syncthreads().
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrives once and adds ``bytes`` to the transactions the current phase
// waits for (the TMA copies signalled to this barrier).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity ``parity`` has completed.  A wait of more
// than about ten seconds (2^34 clocks) traps, so that a pipeline fault ends
// the kernel with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - start > (1ll << 34)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// -------------------------------------------------------------------- TMA
// One box of a 4-d tensor map at coordinates (c0 innermost .. c3) into
// shared memory; completion is signalled to ``bar`` as transaction bytes.
// Out-of-bounds elements of the box are written as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// ------------------------------------------------------------------ wgmma
// Matrix descriptor of a shared-memory operand: start address, leading and
// stride byte offsets (16-byte units), swizzle mode (1 = 128B, 2 = 64B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swz) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swz << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins registers that an in-flight wgmma reads or writes: the compiler may
// neither move their uses across this point nor reuse them before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Register rebalancing between warpgroups (every warp of the warpgroup runs
// it; the count is a multiple of 8 in [24, 256]).
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Two floats as the bf16 pair of one A-fragment register (first in the low
// half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 pair of an A-fragment register as two floats (low half first).
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Accumulator layout of every m64nNk16 shape below (fp32, N / 2 registers
// a thread): warp w of the warpgroup owns rows 16 w .. 16 w + 15; in it,
// lane l holds d[4 n + 2 i + j] = D[16 w + l / 4 + 8 i][8 n + 2 (l % 4) + j].
// The A fragment from registers (m64k16 bf16, four registers) is the same
// layout over 16 columns, so columns 16 t .. 16 t + 15 of an accumulator
// become the A operand of k-step t as pack(d[8 t + 2 r], d[8 t + 2 r + 1]),
// r = 0..3.
//
// The bf16 wgmma shapes, each with its k-step's descriptor offset (in the
// 16-byte units of the address field) as an immediate added inside the asm:
// only the base descriptors stay live across a sequence of k-steps, where
// descriptors computed in C++ tend to be formed all at once beforehand.
//
// m64nNk16, A and B from shared memory, both K-major (D = A B^T); scale_d
// = 0 overwrites d.
template <int OffA, int OffB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 da, db;\n"
      "add.s64 da, %32, %35;\n"
      "add.s64 db, %33, %36;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(OffA), "n"(OffB));
}

// The same at N = 32 (the 192-wide flash kernels' 32-row tiles).
template <int OffA, int OffB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 da, db;\n"
      "add.s64 da, %16, %19;\n"
      "add.s64 db, %17, %20;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "da, db, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(OffA), "n"(OffB));
}

// m64nNk16, A from registers, B from shared memory MN-major (trans-b);
// accumulates into d.
template <int OffB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 db;\n"
      "add.s64 db, %20, %21;\n"
      "setp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, db, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "n"(OffB), "r"(1));
}

template <int OffB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 db;\n"
      "add.s64 db, %36, %37;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "n"(OffB), "r"(1));
}

template <int OffB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 db;\n"
      "add.s64 db, %68, %69;\n"
      "setp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, db, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "n"(OffB), "r"(1));
}

// N = 192: the accumulator of a 192-wide flash row.
template <int OffB>
__device__ __forceinline__ void wgmma_rs(float (&d)[96],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 db;\n"
      "add.s64 db, %100, %101;\n"
      "setp.ne.b32 p, %102, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, db, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "n"(OffB), "r"(1));
}

// -------------------------------------------------------------- cp.async
// 16 bytes from global to shared memory, asynchronously; with valid false
// the 16 bytes are written as zeros and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// The same for 4 bytes (through L1: .cg takes only 16).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's shared-memory writes (st.shared, finished cp.async)
// visible to the async proxy that wgmma reads its operands through; follow
// with a barrier before the wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------ programmatic dependent launch
// In a kernel launched by launch_dependent: waits until the kernel before it
// in the stream has finished and its writes are visible (a no-op in a
// kernel launched plainly).
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
// Lets the kernel after this one in the stream, when launched by
// launch_dependent, start its blocks (up to its grid_dependency_wait) now.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ------------------------------------------- tiles and wgmma sequences
// Tile geometry in shared memory (the layout at the top of this file): D /
// kChunk column chunks of kRowBytes-byte rows, swizzled to match the wgmma
// descriptors.
template <int D>
struct Geo {
  static constexpr int kChunk = D >= 64 ? 64 : D;
  static constexpr int kRowBytes = kChunk * 2;
  static constexpr int kChunks = D / kChunk;
  static constexpr uint32_t kSwz = D >= 64 ? 1 : 2;      // 128B / 64B
  static constexpr uint32_t kSBO = 8 * kRowBytes;        // next 8 rows
  __host__ __device__ static constexpr int tile(int rows) {
    return rows * D * 2;
  }
  __host__ __device__ static constexpr int chunk(int rows) {
    return rows * kRowBytes;
  }
};

// Descriptor of an operand whose contraction runs over D (K-major): rows
// r0 .. r0 + 63 (A) or all rows (B, r0 = 0) of a tile, at k-step 0.  K-step
// kk (columns 16 kk ..) of a ``rows``-row tile is kstep<D>(rows, kk) further.
template <int D>
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int r0) {
  using G = Geo<D>;
  return sm90::make_desc(sm90::smem_u32(tile) + r0 * G::kRowBytes, 16,
                         G::kSBO, G::kSwz);
}
template <int D>
__host__ __device__ constexpr int kstep(int rows, int kk) {
  // in the 16-byte units of the descriptor's address field
  return ((kk * 16 / Geo<D>::kChunk) * Geo<D>::chunk(rows) +
          (kk * 16 % Geo<D>::kChunk) * 2) >> 4;
}

// Descriptor of a B operand whose contraction runs over the tile's rows and
// whose N is D (MN-major, trans-b), at k-step 0; k-step t (rows 16 t ..
// 16 t + 15) is mnstep<D>(t) further.
template <int D>
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile, int rows) {
  using G = Geo<D>;
  return sm90::make_desc(sm90::smem_u32(tile), G::chunk(rows), G::kSBO,
                         G::kSwz);
}
template <int D>
__host__ __device__ constexpr int mnstep(int t) {
  return (t * 16 * Geo<D>::kRowBytes) >> 4;
}

// d = A B^T over D in k-steps of 16, A (RowsA-row tile) and B (RowsB rows)
// K-major in shared memory, from their k-step-0 descriptors.
template <int D, int RowsA, int RowsB, int KK = 0, int N2>
__device__ __forceinline__ void gemm_over_d(float (&d)[N2], uint64_t a,
                                            uint64_t b) {
  sm90::wgmma_ss<kstep<D>(RowsA, KK), kstep<D>(RowsB, KK)>(d, a, b, KK > 0);
  if constexpr (KK + 1 < D / 16)
    gemm_over_d<D, RowsA, RowsB, KK + 1>(d, a, b);
}

// d += A B over the rows of B: A the bf16 register fragments a[t] of
// k-steps t, B an MN-major tile from its k-step-0 descriptor.
template <int D, int T = 0, int N2, int KT>
__device__ __forceinline__ void gemm_over_rows(float (&d)[N2],
                                               const uint32_t (&a)[KT][4],
                                               uint64_t b) {
  sm90::wgmma_rs<mnstep<D>(T)>(d, a[T], b);
  if constexpr (T + 1 < KT) gemm_over_rows<D, T + 1>(d, a, b);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Columns 16 t .. 16 t + 15 of an m64nN accumulator (N / 2 floats) as the
// bf16 A operands of N / 16 k-steps.
template <int N2>
__device__ __forceinline__ void to_a(const float (&d)[N2],
                                     uint32_t (&a)[N2 / 8][4]) {
#pragma unroll
  for (int t = 0; t < N2 / 8; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[t][r] = sm90::pack_bf16(d[8 * t + 2 * r], d[8 * t + 2 * r + 1]);
}

// One row of an m64nD accumulator (rows i of this thread) to a bf16 row in
// global memory, times ``mul``.
template <int D>
__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const float (&acc)[D / 2],
                                          int i, int c2, float mul) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    *reinterpret_cast<uint32_t*>(dst + 8 * n + c2) = sm90::pack_bf16(
        acc[4 * n + 2 * i] * mul, acc[4 * n + 2 * i + 1] * mul);
}

// Byte offset of 16-byte unit u (columns 8 u .. 8 u + 7) of row r in a
// ``rows``-row tile of this layout, for a tile written by the threads
// themselves (cp.async or st.shared) rather than by TMA: the 128B swizzle
// stores unit c of a 128-byte row at c ^ (r % 8), the 64B swizzle (D = 32)
// unit c of a 64-byte row at c ^ ((r / 2) % 4).  The tile starts on a
// 1024-byte boundary, as the swizzle is a function of the address.
template <int D>
__device__ __forceinline__ uint32_t tile_offset(int rows, int r, int u) {
  using G = Geo<D>;
  constexpr int kUnits = G::kChunk / 8;            // units of a chunk row
  const int c = u / kUnits, uc = u % kUnits;
  const int sw = D >= 64 ? (r & 7) : ((r >> 1) & 3);
  return c * G::chunk(rows) + r * G::kRowBytes + ((uc ^ sw) << 4);
}

// ------------------------------------------------------------ host side
// Launches kernel on st as a programmatic dependent of the kernel before it
// in the stream: its blocks may start once that kernel has called
// launch_dependents (or finished) and must grid_dependency_wait before
// reading what that kernel writes.
template <typename... Params, typename... Args>
inline cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                                    dim3 block, size_t smem, cudaStream_t st,
                                    Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// cuTensorMapEncodeTiled through the runtime's driver entry point; null if
// the driver does not have it.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor map of a contiguous bf16 (B, S, heads, D) tensor, one box =
// ``rows`` sequence rows x one column chunk (64 columns with the 128B
// swizzle, or all 32 for D = 32 with the 64B swizzle) of one head of one
// batch.  Rows past S read as zeros.  Returns false if the driver refuses.
inline bool bf16_rows_map(CUtensorMap* map, const void* base, int B, int S,
                          int heads, int D, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const int chunk = D >= 64 ? 64 : D;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)chunk, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            chunk == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of a contiguous bf16 (rows, cols) matrix as a 4-d map
// (cols, rows, 1, 1), one box = box_rows rows x box_cols columns (64
// columns: 128-byte rows, 128B swizzle).  Elements past the ends read as
// zeros.  Returns false if the driver refuses (cols * 2 must be a multiple
// of 16 and base 16-byte aligned).
inline bool bf16_matrix_map(CUtensorMap* map, const void* base, int rows,
                            int cols, int box_rows, int box_cols) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows, 1, 1};
  const cuuint64_t strides[3] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
