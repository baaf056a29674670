// The pieces the fp32 flash kernels share (csrc/flash_attention_fwd_f32.cu,
// csrc/flash_attention_bwd_f32.cu): the block's threads, the rows' pad,
// cp.async copies of tiles into padded shared rows and their waits.
#pragma once

#include "hopper.cuh"   // smem_u32

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 256;
constexpr int PAD = 4;   // floats past each shared row of an operand

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// the copies of tile `it` of `n` landed, where those of tiles up to it +
// STAGES - 2 may be in flight
template <int STAGES>
__device__ __forceinline__ void cp_wait_tile(int it, int n) {
  if (STAGES == 3 && it + 1 < n)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    cp_wait_all();
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// rows [r0, r0 + ROWS) of a (rows, dim) fp32 operand whose rows are
// `stride` floats apart into shared rows of LD floats: columns [0, dim)
// and zeros up to the next multiple of 4, zero rows at and past `rows`.
// Every thread of the block issues its share of the copies
template <int ROWS, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, size_t stride, int r0,
                                          int rows, int dim) {
  if ((dim & 3) == 0) {
    const int chunks = dim >> 2;
    for (int i = threadIdx.x; i < ROWS * chunks; i += THREADS) {
      const int r = i / chunks, c = (i - r * chunks) << 2;
      const bool ok = r0 + r < rows;
      cp_async16(dst + r * LD + c, ok ? src + (size_t)(r0 + r) * stride + c : src, ok);
    }
  } else {
    const int cols = (dim + 3) & ~3;
    for (int i = threadIdx.x; i < ROWS * cols; i += THREADS) {
      const int r = i / cols, c = i - r * cols;
      const bool ok = r0 + r < rows && c < dim;
      cp_async4(dst + r * LD + c, ok ? src + (size_t)(r0 + r) * stride + c : src, ok);
    }
  }
}

}  // namespace
