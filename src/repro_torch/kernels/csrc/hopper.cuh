// Hopper (sm_90a) building blocks shared by the port's bf16 and fp16
// kernels: mbarriers, TMA loads and their tensor maps, wgmma and its
// shared-memory descriptors, and the two tile products built from them.
//
// Tiles live in shared memory as TMA writes them with the 128-byte
// swizzle: boxes of BOX 2-byte columns (ROW bytes a row), each box's rows
// contiguous, every box 1024-byte aligned (the swizzle repeats every 1024
// bytes).  A (rows x cols) tile of cols > BOX is cols / BOX such boxes, one
// after the other.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

constexpr int BOX = 64;       // bf16 / fp16 columns of one TMA box: the 128-byte swizzle span
constexpr int ROW = 128;      // bytes of one box row in shared memory

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The wgmma kernels' element type T: bf16, or fp16 (the same products in
// f16 wgmma, the same tiles and tensor maps); fp32 arithmetic in both.
// Each helper below picks bf16's code or fp16's with `if constexpr`, so a
// bf16 instantiation compiles to what it compiled to before fp16 existed.
template <typename T>
constexpr bool IS_HALF = std::is_same<T, __half>::value;
template <typename T>
using pair_t = typename std::conditional<IS_HALF<T>, __half2, __nv_bfloat162>::type;

// two floats as a T pair, each rounded to nearest, in one 32-bit word
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (IS_HALF<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

// two floats rounded to a T pair at dst (4-byte aligned)
template <typename T>
__device__ __forceinline__ void store2(T* dst, float lo, float hi) {
  if constexpr (IS_HALF<T>)
    *reinterpret_cast<__half2*>(dst) = __floats2half2_rn(lo, hi);
  else
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(lo, hi);
}

// a T pair as two floats
__device__ __forceinline__ float2 to_f2(__nv_bfloat162 v) { return __bfloat1622float2(v); }
__device__ __forceinline__ float2 to_f2(__half2 v) { return __half22float2(v); }

// a and b as bf16 pairs: hi, each rounded to nearest, and lo, what is
// left of each (exact in fp32) rounded to bf16.  hi + lo keeps 16 bits of
// mantissa.  (An integer-only split measured slower.)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// the SIMT kernels' element types: bf16 or fp32 in memory, fp32 arithmetic
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// and fp16, on the SSD's general SIMT kernels (csrc/ssd_scan_any.cu)
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ void store_f(__half* p, float v) { *p = __float2half_rn(v); }

// A launch's real widths (flash: the q/k and v head dims; SSD: P and N).
// FixedWidths: the instantiation's own, compile-time constants, so the
// code that reads them is the code of a kernel without them.  Widths: the
// padded route's, at run time inside the instantiation's (a bucket): TMA
// zero-fills the columns past them, and stores stop at them.  Elem: the
// flash kernels' element type, bf16 in both; HalfWidths and
// FixedHalfWidths are the same in fp16.
template <int W0, int W1>
struct FixedWidths {
  using Elem = __nv_bfloat16;
  static constexpr bool PADDED = false;
  __device__ __forceinline__ int w0() const { return W0; }
  __device__ __forceinline__ int w1() const { return W1; }
};
struct Widths {
  using Elem = __nv_bfloat16;
  static constexpr bool PADDED = true;
  int v0, v1;
  __device__ __forceinline__ int w0() const { return v0; }
  __device__ __forceinline__ int w1() const { return v1; }
};
struct HalfWidths : Widths {
  using Elem = __half;
};
template <int W0, int W1>
struct FixedHalfWidths : FixedWidths<W0, W1> {
  using Elem = __half;
};

// What an SSD call with B/C groups (G > 1) or an initial state adds: an
// argument of its own, read only by the kernels' X instantiations, so that
// the G = 1 instantiations keep their code (more fields in a kernel's
// Params have made ptxas serialize wgmma in other kernels).
struct SsdExt {
  const void* s0;   // (B, H, P, N) contiguous, or null: a zero initial state
  float* ds0;       // the backward's: (B, H, P, N) fp32, s0's gradient (null: none)
  int hpg;          // heads a B/C group: head h reads group h / hpg
  int s0_f32;       // s0 is fp32 (else of x's type T)
};

// element i of s0, of type T unless it is fp32
template <typename T>
__device__ __forceinline__ float ld_s0(const SsdExt& e, size_t i) {
  return e.s0_f32 ? static_cast<const float*>(e.s0)[i] : to_f(static_cast<const T*>(e.s0)[i]);
}

// 2^x on the special-function unit
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// this thread's arrival, and `bytes` more for the barrier's phase to wait on
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one box of a 4-D tensor map (innermost coordinate first) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes of shared memory (a multiple of 16, both
// addresses 16-byte aligned) to device memory, in this thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

// one box of shared memory into a 4-D tensor map, in this thread's bulk
// group; rows past the tensor's end are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// until this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// until this thread's bulk stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// a barrier of `threads` threads (a multiple of 32) on hardware barrier id
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// this warp's arrival at barrier id, without waiting for the others
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// orders this thread's shared-memory stores before later reads by the
// async proxy (wgmma operands, TMA writes to the same bytes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
// Offsets in 16-byte units.  K-major: rows of 128 bytes, SBO = 1024 B
// between 8-row groups, LBO unused.  MN-major (rows along k, the 64 MN
// values of a box contiguous): SBO = 1024 B between 8-row groups along k,
// LBO = the step between 64-column boxes along MN.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// until at most one committed group is in flight (they complete in order)
__device__ __forceinline__ void wgmma_wait_all_but_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// keeps the compiler from reading an accumulator before wgmma_wait_all
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Each product's asm as a macro of its operand type, "bf16" or "f16": the
// instruction string is the only difference between the two
#define HOPPER_WGMMA_SS_N128(AB) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "%64, %65, p, 1, 1, %67, %68;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB))
// d (64 x 128, f32) {=, +=} a (64 x 16, smem) * b (16 x 128, smem); TA / TB
// 0 for a K-major operand, 1 for an MN-major one
template <int TA = 0, int TB = 0, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                             int accumulate) {
  if constexpr (IS_HALF<T>) {
    HOPPER_WGMMA_SS_N128("f16");
  } else {
    HOPPER_WGMMA_SS_N128("bf16");
  }
}

#define HOPPER_WGMMA_SS_N64(AB) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, %35, %36;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB))
// d (64 x 64, f32) {=, +=} a (64 x 16, smem) * b (16 x 64, smem); TA / TB as above
template <int TA = 0, int TB = 0, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                            int accumulate) {
  if constexpr (IS_HALF<T>) {
    HOPPER_WGMMA_SS_N64("f16");
  } else {
    HOPPER_WGMMA_SS_N64("bf16");
  }
}

#define HOPPER_WGMMA_SS_N32(AB) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
      "%16, %17, p, 1, 1, %19, %20;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB))
// d (64 x 32, f32) {=, +=} a (64 x 16, smem) * b (16 x 32, smem); TA / TB as above
template <int TA = 0, int TB = 0, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b,
                                            int accumulate) {
  if constexpr (IS_HALF<T>) {
    HOPPER_WGMMA_SS_N32("f16");
  } else {
    HOPPER_WGMMA_SS_N32("bf16");
  }
}

#define HOPPER_WGMMA_RS_N64(AB) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
// d (64 x 64, f32) += a (64 x 16, registers) * b (16 x 64, smem, MN-major)
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  if constexpr (IS_HALF<T>) {
    HOPPER_WGMMA_RS_N64("f16");
  } else {
    HOPPER_WGMMA_RS_N64("bf16");
  }
}

#define HOPPER_WGMMA_RS_N128(AB) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
// d (64 x 128, f32) += a (64 x 16, registers) * b (16 x 128, smem, MN-major)
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b) {
  if constexpr (IS_HALF<T>) {
    HOPPER_WGMMA_RS_N128("f16");
  } else {
    HOPPER_WGMMA_RS_N128("bf16");
  }
}

#define HOPPER_WGMMA_RS_N192(AB) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n192k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63," \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, " \
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
// d (64 x 192, f32) += a (64 x 16, registers) * b (16 x 192, smem, MN-major)
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4],
                                             uint64_t b) {
  if constexpr (IS_HALF<T>) {
    HOPPER_WGMMA_RS_N192("f16");
  } else {
    HOPPER_WGMMA_RS_N192("bf16");
  }
}

#define HOPPER_WGMMA_RS_N256(AB) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." AB "." AB " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63," \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95," \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111," \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, " \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
// d (64 x 256, f32) += a (64 x 16, registers) * b (16 x 256, smem, MN-major)
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t b) {
  if constexpr (IS_HALF<T>) {
    HOPPER_WGMMA_RS_N256("f16");
  } else {
    HOPPER_WGMMA_RS_N256("bf16");
  }
}

// S (64 rows x 2 NS columns, fp32) {=, +=} A B^T over a depth of D, both
// operands K-major in shared memory: a, the first of the 64 A rows inside
// an A_ROWS-row tile; b, the first of 2 NS B rows inside a B_ROWS-row
// tile (a multiple of 8 rows from its start, where the swizzle repeats);
// D / 64 boxes each.  `accumulate` adds to S instead.  WAIT false
// leaves the product in flight: the caller waits (wgmma_wait_all, pin)
// before it touches S.  T: the operands' type, bf16 or fp16.
template <int D, int A_ROWS, int B_ROWS, int NS, bool WAIT = true, typename T = __nv_bfloat16>
__device__ __forceinline__ void qk_product(float (&s)[NS], uint32_t a, uint32_t b,
                                           bool accumulate = false) {
  static_assert(NS == 64 || NS == 32 || NS == 16, "32, 64 or 128 columns");
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {   // 16 columns (32 bytes) a step
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = smem_desc(a + (kk / 4) * (A_ROWS * ROW) + col, 1, 64);
    const uint64_t db = smem_desc(b + (kk / 4) * (B_ROWS * ROW) + col, 1, 64);
    if constexpr (NS == 64) wgmma_ss_n128<0, 0, T>(s, da, db, accumulate || kk > 0);
    else if constexpr (NS == 32) wgmma_ss_n64<0, 0, T>(s, da, db, accumulate || kk > 0);
    else wgmma_ss_n32<0, 0, T>(s, da, db, accumulate || kk > 0);
  }
  wgmma_commit();
  if constexpr (WAIT) {
    wgmma_wait_all();
    pin(s);
  }
}

// O (64 x D, fp32) += P (64 x K_ROWS, T A fragments) V (K_ROWS x D at
// shared address v, MN-major); D 64, 128, 192 or 256 (the widest wgmma N).
// WAIT and T as for qk_product; the fragments too stay untouched until the wait.
template <int D, int K_ROWS, bool WAIT = true, typename T = __nv_bfloat16>
__device__ __forceinline__ void pv_product(float (&o)[D / 2], const uint32_t (&pf)[K_ROWS / 16][4],
                                           uint32_t v) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < K_ROWS / 16; ++j) {     // 16 k rows (2048 bytes) a step
    const uint64_t desc = smem_desc(v + j * 16 * ROW, K_ROWS * ROW / 16, 64);
    if constexpr (D == 64) wgmma_rs_n64<T>(o, pf[j], desc);
    else if constexpr (D == 128) wgmma_rs_n128<T>(o, pf[j], desc);
    else if constexpr (D == 192) wgmma_rs_n192<T>(o, pf[j], desc);
    else wgmma_rs_n256<T>(o, pf[j], desc);
  }
  wgmma_commit();
  if constexpr (WAIT) {
    wgmma_wait_all();
    pin(o);
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (no -lcuda)
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// Above 48 KB of dynamic shared memory a launch is refused unless the
// kernel opts in.  Opts in once on each device (`opted` holds a bit per
// device, one variable per kernel): the call costs host time next to a
// kernel of ~0.1 ms.  Returns 0 or the CUDA error.
inline int opt_in_smem(const void* kernel, size_t bytes, uint32_t& opted) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && ((opted >> dev) & 1u)) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (dev < 32) opted |= 1u << dev;
  return 0;
}

// Whether a flash entry's q/k head dim dk (a multiple of 8) may be scaled
// as real_dk: real_dk is dk, or, on the staged route
// (kernels/flash_attention.py:route, kind "stage"), the real dim whose
// rows were copied into buffers of pitch dk, real_dk rounded up to a
// multiple of 8 (host code: no kernel reads it).
inline bool pitch_of(int real_dk, int dk) {
  return real_dk > 0 && real_dk <= dk && dk - real_dk < 8;
}

// the tensor-map data type of a kernel's element type T
template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return IS_HALF<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// layout: dims (cols, heads, rows, batch) innermost first, byte strides
// of dims 1-3, box (11 values), as kernels/flash_attention.py:tma_layout
// computes them; `type` the elements' (2 bytes: bf16 or fp16).  Returns 0,
// or -1 without the encoder, -2 if the layout is not the kernel's (box
// other than BOX columns by box_rows rows) or is refused.  Rows past the
// tensor's end load as zeros.
inline int encode(CUtensorMap* map, const void* ptr, const long long* layout, int box_rows,
                  CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return -1;
  // the driver encodes only with a context current on the calling thread,
  // which a thread that has run no CUDA work yet (autograd's, when this
  // kernel's gradient is its first) does not have: bind this device's
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess) return -1;
  if (layout[7] != BOX || layout[8] != 1 || layout[9] != box_rows || layout[10] != 1) return -2;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = static_cast<cuuint64_t>(layout[i]);
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(layout[4 + i]);
  for (int i = 0; i < 4; ++i) box[i] = static_cast<cuuint32_t>(layout[7 + i]);
  const CUresult r = fn(map, type, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -2;
}

}  // namespace hopper
