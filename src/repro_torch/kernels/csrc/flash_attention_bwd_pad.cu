// Flash attention backward in bf16 at head dims that are no built pair:
// the padded route (kernels/flash_attention.py:route), the gradient of
// csrc/flash_attention_pad.cu's forward (and, in the (192, 128) bucket, of
// csrc/flash_attention_fwd_ws.cu's).
//
// The gradient csrc/flash_attention_bwd.cu computes, which replaces the
// autodiff of src/repro/models/layers.py:blockwise_mha around
// src/repro/kernels/flash_attention.py:flash_attention_bh, at q/k dim dk
// and v dim dv, each a multiple of 8, on the kernels of the smallest
// built pair (the bucket) that holds them: (64, 64) and (128, 128) run
// the one-warpgroup dQ and dK/dV kernels, (192, 128) and (256, 256) the
// two-warpgroup ones (and the head shares' sum where the launcher splits).
// The tensor maps carry the real dims, so TMA zero-fills q, k, v and dO
// past them: the scores and dP are those of the real dims, and the
// columns of dQ, dK and dV past them come out zero and are not stored.
// Delta = rowsum(dO * O) reads O and dO at their real width.  The kernels'
// Widths instantiations take the real dims as an argument of their own
// (hopper.cuh), so the buckets' own instantiations keep their code; the
// launches are flash_attention_bwd.cuh's launch_bucket.  What bounds it is
// what bounds the bucket (csrc/flash_attention_bwd.cu's header), on the
// bucket's products: D 80 does 1.6x the MACs it needs.

#include "flash_attention_bwd.cuh"

// As csrc/flash_attention_bwd.cu's flash_attention_bwd at real head dims
// dk and dv (multiples of 8) inside the bucket (bk, bv): (64, 64), (128,
// 128), (192, 128) or (256, 256); all bf16.  layout: q's, k's, v's and
// dO's TMA layouts at their real dims with boxes of 64 rows.  scratch: 2 *
// B * H * s_pad fp32, s_pad S rounded up to the bucket's dQ block (128 at
// (192, 128) and (256, 256), else 64).  part and shares as there, the
// partial sums at the bucket's widths, (shares, B, Sk, KV, bk + bv).
// scale_dk: as csrc/flash_attention_pad.cu's (DK, or on the staged route
// the real dim that DK, the pitch of its buffers, rounds up).
extern "C" int flash_attention_bwd_pad(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const float* lse,
                                       void* dq, void* dk, void* dv, float* scratch, int B,
                                       int S, int Sk, int H, int KV, int DK, int DV, int bk,
                                       int bv, int causal, int window, void* stream,
                                       const long long* layout, float* part, int shares,
                                       int s_pad, int scale_dk) {
  const int err = padded_args(S, H, KV, DK, DV, bk, bv, layout, part, shares, s_pad);
  if (err) return err;
  if (!pitch_of(scale_dk, DK)) return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)scale_dk);
  const Params p{q, k, v, o, dout, lse, dq, dk, dv, scratch, scratch + (size_t)B * H * s_pad,
                 B, S, Sk, H, KV, causal, window, scale, LOG2E * scale, s_pad};
  const Widths wd{DK, DV};
  return launch_bucket(p, Shares{part, shares}, wd, bk, bv, layout,
                       static_cast<cudaStream_t>(stream));
}
