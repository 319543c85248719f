// Hopper building blocks for the hand-written kernels of this package:
// mbarriers, TMA tile and bulk loads, named barriers, register
// rebalancing, wgmma (sm_90a) and f32 reductions into global memory, as
// inline PTX; and the host half of a launch (the operands' strides,
// tensor maps, the device bind, the dispatch over head widths and
// instantiation). Header only; a kernel source includes it and
// kernels/build.py hashes it with the source.
//
// Conventions that the helpers assume:
// - shared addresses are 32-bit (__cvta_generic_to_shared);
// - a tile loaded by TMA with 128-byte swizzle lies on a 1024-byte
//   boundary, rows of 128 bytes (64 bf16), 8 rows to a swizzle atom; the
//   wgmma descriptors below describe exactly that layout;
// - the wgmma accumulator of m64nNk16 (f32) gives thread t of the
//   warpgroup, with w = t / 32, g = (t % 32) / 4, q = t % 4, the entries
//   d[4j + 2h + e] = (row 16w + g + 8h, column 8j + 2q + e), and the A
//   operand from registers the same rows: a[0] (row g, k 2q..2q+1),
//   a[1] (row g+8, same), a[2] (row g, k 2q+8..2q+9), a[3] (row g+8, same).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// makes the barriers' initialisation visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------------

constexpr int kBoxCols = 64;  // bf16 columns per box: the 128-byte swizzle span

// box of a 3-D tensor map at coordinates (c0 innermost, c1, c2) into
// shared memory at `dst`, completing transactions on `bar`; rows outside
// the tensor arrive as zeros and still count their bytes
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- state in shared memory -------------------------------------------------

// a 32-bit word of shared memory, read and written where the code says and
// nowhere else: state kept out of registers across a loop
__device__ __forceinline__ int ld_shared_s32(uint32_t addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_s32(uint32_t addr, int v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

// shared memory through 32-bit addresses: a generic pointer into it takes
// two registers where a kernel has none to spare
__device__ __forceinline__ float2 ld_shared_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_f32x4(uint32_t addr, float a,
                                                float b, float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}

// ---- named barriers and registers -------------------------------------------

__device__ __forceinline__ void named_sync(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(uint32_t id, uint32_t threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

// ---- wgmma -----------------------------------------------------------------

// shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (all in 16-byte units), layout type 1.
// K-major (the contiguous dimension is the product's depth): sbo is the
// step between 8-row atoms (1024 bytes), lbo is unused; a k16 step within
// the 128-byte row adds 32 bytes to the start. MN-major (the contiguous
// dimension is the output's): lbo is the step between 64-element column
// blocks, sbo the step between 8-row (depth) atoms.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most kPending committed groups of this warpgroup are in
// flight
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending)
               : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// the same for A fragments in registers: they stay live, and unchanged,
// until the fence after the wait that retires their product
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// d (+)= a . b, A and B from shared memory (both K-major), m64n128k16
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t a,
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += a . b, A from registers, B from shared memory MN-major
// (transposed), m64n128k16
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a . b, A from registers, B from shared memory MN-major
// (transposed), m64n64k16
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a . b, A from registers, B from shared memory MN-major
// (transposed), m64n192k16
__device__ __forceinline__ void wgmma_rs_m64n192k16(float (&d)[96],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (+)= a . b, A and B from shared memory, m64n32k16; kTransA and kTransB
// as below
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_m64n32k16(float (&d)[16], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// d (+)= a . b, A and B from shared memory, m64n64k16; kTransA and kTransB
// pick each operand's layout: 0 K-major, 1 MN-major (transposed)
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// ---- shared memory written by threads, read by the async proxy -------------

// orders this thread's writes to shared memory before later reads of it by
// the async proxy (wgmma operands); the readers still wait on a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory at `src` into shared memory at `dst`, completing transactions on
// `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// global f32 at `dst` += shared f32 at `src`, `bytes` (a multiple of 16,
// both addresses 16-byte aligned) as one asynchronous bulk reduction by
// the issuing thread, in its current bulk group
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, uint32_t src,
                                                    uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;\n"
      :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most kPending of this thread's bulk groups still read their
// shared memory
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(kPending)
               : "memory");
}

// until at most kPending of this thread's bulk groups are still in flight
template <int kPending>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(kPending) : "memory");
}

}  // namespace hopper

// ---- host: tensor maps, the device, the dispatch ---------------------------
// In the including source's anonymous namespace, where its kernels are: a
// kernel that takes RowStrides by value is named with
// (anonymous namespace)::RowStrides like its source's other types, and
// each library keeps its own copy of the encoder's entry point.

namespace {

// a [bh, rows, d] operand's strides over bh and over rows, in elements
struct RowStrides {
  int64_t bh, row;
};

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so a
// library links no libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 3-D map over [bh, rows, d] bf16 (dims innermost first) with the
// tensor's own strides over rows and bh (elements; TMA takes them in
// bytes, multiples of 16), boxes of [1, box_rows, 64] with the 128-byte
// swizzle; out-of-range rows read as zeros
bool encode_map(EncodeTiled fn, CUtensorMap* map, const void* ptr,
                int64_t bh, int64_t rows, int64_t d, RowStrides st,
                int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(st.row * 2),
                                 static_cast<cuuint64_t>(st.bh * 2)};
  const cuuint32_t box[3] = {hopper::kBoxCols,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the (bh, row) strides of n operands from `strides` (elements, a pair an
// operand, in the C entry point's order) into st: false unless each is a
// non-negative multiple of 8 elements (16 bytes, as a TMA map and the
// 16-byte accesses need) and each operand's base is 16-byte aligned
bool read_strides(const int64_t* strides, const void* const* bases, int n,
                  RowStrides* st) {
  if (strides == nullptr) return false;
  for (int i = 0; i < n; ++i) {
    st[i] = RowStrides{strides[2 * i], strides[2 * i + 1]};
    if (st[i].bh < 0 || st[i].row < 0 || st[i].bh % 8 != 0 ||
        st[i].row % 8 != 0 || reinterpret_cast<uintptr_t>(bases[i]) % 16 != 0)
      return false;
  }
  return true;
}

// makes `device` current on this thread. The driver's tensor-map encoder
// needs the device's context current, which a thread that has made no
// CUDA runtime call yet lacks: autograd's worker thread, when a kernel's
// launch is its first work. Returns a cudaError_t
int bind_device(int device) { return static_cast<int>(cudaSetDevice(device)); }

// `device`'s multiprocessors into *count, the grid of a persistent kernel:
// asked of the runtime once a device, not on every launch. Returns a
// cudaError_t
int sm_count(int device, int* count) {
  static std::atomic<int> counts[64];
  if (device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  int n = counts[device].load(std::memory_order_relaxed);
  if (n == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    counts[device].store(n, std::memory_order_relaxed);
  }
  *count = n;
  return static_cast<int>(cudaSuccess);
}

// whether the kernels take these K/V groups and this window: bh a
// multiple of group >= 1, and a window of at most 2^31 - 1 keys, with
// the causal mask only
bool group_window_ok(int64_t bh, int64_t group, int64_t window, int causal) {
  return group >= 1 && bh % group == 0 && window >= 0 &&
         window <= 2147483647 && (window == 0 || causal);
}

// f(std::integral_constant<int, D>, std::integral_constant<int, DV>,
// std::bool_constant<kBand>, group, window) for key and value widths
// (d, dv) of (64, 64) or (128, 128): the band instantiation (grouped KV
// heads, a sliding window or a sink) with the call's group and window,
// else the MHA one with 1 and 0; and for (192, 128) (keys wider than
// values) the band one always, at any group and window, 1 and 0
// included. cudaErrorInvalidValue for another pair
template <class F>
int dispatch(int64_t d, int64_t dv, int64_t group, int64_t window, bool sink,
             F&& f) {
  const int g = static_cast<int>(group), w = static_cast<int>(window);
  const bool band = group > 1 || window > 0 || sink;
  using D64 = std::integral_constant<int, 64>;
  using D128 = std::integral_constant<int, 128>;
  using D192 = std::integral_constant<int, 192>;
  if (d == 64 && dv == 64)
    return band ? f(D64(), D64(), std::true_type(), g, w)
                : f(D64(), D64(), std::false_type(), 1, 0);
  if (d == 128 && dv == 128)
    return band ? f(D128(), D128(), std::true_type(), g, w)
                : f(D128(), D128(), std::false_type(), 1, 0);
  if (d == 192 && dv == 128) return f(D192(), D128(), std::true_type(), g, w);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
