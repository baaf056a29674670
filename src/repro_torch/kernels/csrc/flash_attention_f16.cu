// Flash attention forward in fp16 on the wgmma + TMA kernel
// (kernels/flash_attention.py:route, kind "f16"); its backward is
// csrc/flash_attention_bwd_f16.cu, and at (192, 128) its forward
// csrc/flash_attention_fwd_ws.cu's flash_attention_fwd_ws_f16.
//
// Replaces, as csrc/flash_attention.cu does,
// src/repro/kernels/flash_attention.py:flash_attention_bh, which takes
// fp16 as it takes bf16.  On the H100, f16 wgmma has the shapes and the
// rate of bf16 wgmma and TMA loads f16 boxes as it loads bf16 ones, so fp16
// runs the bf16 design (csrc/flash_attention.cu's header: two consumer
// warpgroups of 64 q rows, a ring of K/V stages by TMA, S and P V on
// wgmma, P rounded to the element type in registers) with __half in place
// of __nv_bfloat16, and what bounds it is what bounds bf16.  fp16 keeps 10
// mantissa bits against bf16's 7; P lies in [0, 1] and O at unit-scale
// inputs stays far below fp16's 65504.
//
// Only the padded route's form is built (hopper::HalfWidths, the real dims
// at run time), at every head-dim pair that bf16 runs on wgmma: the built
// pairs (64, 64), (128, 128), (256, 256) with widths equal to the bucket,
// and dims that are multiples of 8 inside them, each at its bucket's
// default kv tile alone (KV_TILES[...][0]); the autotuner stays bf16's.
// At the built pairs it reads the time of a build at fixed widths (0.99x
// at D 64 and 128 on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6), so
// none is built.

#include "flash_attention_fwd.cuh"

// q: (B, S, H, dk); k: (B, Sk, KV, dk); v: (B, Sk, KV, dv); o: (B, S, H,
// dv); all fp16, contiguous; dk and dv multiples of 8 inside the bucket
// (bk, bv): (64, 64), (128, 128) or (256, 256).  dtype: the launcher's
// dtype code, 2 (fp16); another is refused.  layout: the TMA layouts of q
// (boxes of 128 rows), k and v (boxes of kv_tile rows) at their real dims,
// 11 values each, as kernels/flash_attention.py:tma_layout computes them.
// lse: null or a (B, H, S) fp32 buffer.  kv_tile: the bucket's default, 128
// at (64, 64) and (128, 128), 64 at (256, 256).  scale_dk: as
// csrc/flash_attention_pad.cu's (dk, or the staged route's real dim).
// Returns cudaGetLastError() after the launch, a negative code from
// encode(), or cudaErrorInvalidValue for a dtype, dims, a bucket or a tile
// it does not take.
extern "C" int flash_attention_fwd_f16(const void* q, const void* k, const void* v, void* o,
                                       int B, int S, int Sk, int H, int KV, int dk, int dv,
                                       int bk, int bv, int causal, int window, int dtype,
                                       void* stream, const long long* layout, float* lse,
                                       int kv_tile, int scale_dk) {
  if (dtype != 2 || dk <= 0 || dv <= 0 || dk > bk || dv > bv || dk % 8 || dv % 8 ||
      layout == nullptr || !pitch_of(scale_dk, dk))
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, B, S, Sk, H, KV, causal, window,
                 LOG2E / sqrtf((float)scale_dk), lse};
  const HalfWidths wd{{dk, dv}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bk == 64 && bv == 64 && kv_tile == 128)
    return launch_fwd<64, 64, 128, HalfWidths>(p, wd, layout, st);
  if (bk == 128 && bv == 128 && kv_tile == 128)
    return launch_fwd<128, 128, 128, HalfWidths>(p, wd, layout, st);
  if (bk == 256 && bv == 256 && kv_tile == 64)
    return launch_fwd<256, 256, 64, HalfWidths>(p, wd, layout, st);
  return (int)cudaErrorInvalidValue;
}
