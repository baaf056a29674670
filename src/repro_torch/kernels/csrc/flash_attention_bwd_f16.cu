// Flash attention backward in fp16 on the wgmma + TMA kernels
// (kernels/flash_attention.py:route, kind "f16"): the gradient of
// csrc/flash_attention_f16.cu's forward (and, in the (192, 128) bucket, of
// csrc/flash_attention_fwd_ws.cu's flash_attention_fwd_ws_f16).
//
// The gradient csrc/flash_attention_bwd.cu computes, which replaces the
// autodiff of src/repro/models/layers.py:blockwise_mha around
// src/repro/kernels/flash_attention.py:flash_attention_bh, in fp16: the
// same kernels with __half in place of __nv_bfloat16 (hopper::HalfWidths),
// whose f16 wgmma has bf16's shapes and rate on the H100, so what bounds
// them is what bounds bf16 (csrc/flash_attention_bwd.cu's header).  Q, K,
// V and dO arrive by TMA in f16 boxes; P and dS are rounded to fp16 as
// product operands (10 mantissa bits against bf16's 7, but 5 exponent
// bits: a dS below fp16's subnormals, ~6e-8, rounds to 0, as SDPA's fp16
// backward rounds it); the gradients accumulate in fp32 and are written
// once in fp16, and the split dK/dV kernel's head shares are summed in a
// fixed order, so two launches give the same bits.
//
// At the built pairs the kernels take their own widths as compile-time
// constants (hopper::FixedHalfWidths, never read), as bf16's do: the
// padded form (hopper::HalfWidths, the real dims at run time) read
// 1.05-1.21x their device time there (an NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md §6).  Dims that are
// multiples of 8 inside a built pair take that padded form.  (64, 64) and
// (128, 128) run the one-warpgroup dQ and dK/dV kernels, (192, 128) and
// (256, 256) the two-warpgroup ones.

#include "flash_attention_bwd.cuh"

// As csrc/flash_attention_bwd_pad.cu's flash_attention_bwd_pad, all fp16:
// real head dims dk and dv (multiples of 8) inside the bucket (bk, bv),
// the layouts of q, k, v and dO at their real dims with boxes of 64 rows,
// the scratch, part, shares and scale_dk as there.  dtype: the launcher's
// dtype code, 2 (fp16); another is refused with cudaErrorInvalidValue.
extern "C" int flash_attention_bwd_f16(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const float* lse,
                                       void* dq, void* dk, void* dv, float* scratch, int B,
                                       int S, int Sk, int H, int KV, int DK, int DV, int bk,
                                       int bv, int causal, int window, int dtype, void* stream,
                                       const long long* layout, float* part, int shares,
                                       int s_pad, int scale_dk) {
  if (dtype != 2) return (int)cudaErrorInvalidValue;
  const int err = padded_args(S, H, KV, DK, DV, bk, bv, layout, part, shares, s_pad);
  if (err) return err;
  if (!pitch_of(scale_dk, DK)) return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)scale_dk);
  const Params p{q, k, v, o, dout, lse, dq, dk, dv, scratch, scratch + (size_t)B * H * s_pad,
                 B, S, Sk, H, KV, causal, window, scale, LOG2E * scale, s_pad};
  const Shares sh{part, shares};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (DK == bk && DV == bv) {   // a built pair: its own widths, fixed
    if (bk == 64 && bv == 64) return launch_one<64>(p, FixedHalfWidths<64, 64>{}, layout, st);
    if (bk == 128 && bv == 128)
      return launch_one<128>(p, FixedHalfWidths<128, 128>{}, layout, st);
    if (bk == 256 && bv == 256)
      return launch_split<256, 256>(p, sh, FixedHalfWidths<256, 256>{}, layout, st);
    if (bk == 192 && bv == 128)
      return launch_split<192, 128>(p, sh, FixedHalfWidths<192, 128>{}, layout, st);
  }
  const HalfWidths wd{{DK, DV}};
  return launch_bucket(p, sh, wd, bk, bv, layout, st);
}
