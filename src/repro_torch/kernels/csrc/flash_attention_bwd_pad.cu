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
// (hopper.cuh), so the buckets' own instantiations keep their code.  What
// bounds it is what bounds the bucket (csrc/flash_attention_bwd.cu's
// header), on the bucket's products: D 80 does 1.6x the MACs it needs.

#include "flash_attention_bwd.cuh"

namespace {

using namespace hopper;

// the TMA maps of q, dO, k and v: layout holds q's, k's, v's and dO's
int encode_maps(const Params& p, const long long* layout, CUtensorMap& tm_q, CUtensorMap& tm_do,
                CUtensorMap& tm_k, CUtensorMap& tm_v) {
  int err = encode(&tm_q, p.q, layout, ROWS);
  if (!err) err = encode(&tm_k, p.k, layout + 11, ROWS);
  if (!err) err = encode(&tm_v, p.v, layout + 22, ROWS);
  if (!err) err = encode(&tm_do, p.dout, layout + 33, ROWS);
  return err;
}

// buckets (64, 64) and (128, 128): the dQ kernel, then the one-warpgroup dK/dV kernel
template <int D>
int launch_one(const Params& p, const Widths& wd, const long long* layout, cudaStream_t stream) {
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  int err = encode_maps(p, layout, tm_q, tm_do, tm_k, tm_v);
  if (err) return err;
  static uint32_t opted_dq = 0, opted_kv = 0;   // a bit per device
  err = opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dq_bf16<D, D, Widths>),
                    DqSmem<D, D>::BYTES, opted_dq);
  if (err) return err;
  flash_bwd_dq_bf16<D, D, Widths><<<dim3(p.B * p.H, (p.S + ROWS - 1) / ROWS), 128,
                                    DqSmem<D, D>::BYTES, stream>>>(tm_q, tm_do, tm_k, tm_v, p,
                                                                   wd);
  if ((err = (int)cudaGetLastError())) return err;
  err = opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dkdv_bf16<D, Widths>),
                    DkdvSmem<D>::BYTES, opted_kv);
  if (err) return err;
  flash_bwd_dkdv_bf16<D, Widths><<<dim3(p.B * p.KV, (p.Sk + ROWS - 1) / ROWS), 128,
                                   DkdvSmem<D>::BYTES, stream>>>(tm_q, tm_do, tm_k, tm_v, p, wd);
  return (int)cudaGetLastError();
}

// buckets (192, 128) and (256, 256): the two-warpgroup dQ kernel (K and V
// in boxes of its stages' KR rows), the two-warpgroup dK/dV kernel over
// sh.n head shares and, for more than one, the pass that sums them
template <int DK, int DV>
int launch_split(const Params& p, const Shares& sh, const Widths& wd, const long long* layout,
                 cudaStream_t stream) {
  using L = PairSmem<DK, DV>;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  int err = encode_maps(p, layout, tm_q, tm_do, tm_k, tm_v);
  if (err) return err;
  CUtensorMap tm_kr = tm_k, tm_vr = tm_v;
  if constexpr (L::KR != ROWS) {
    long long kl[11], vl[11];
    for (int i = 0; i < 11; ++i) kl[i] = layout[11 + i], vl[i] = layout[22 + i];
    kl[9] = vl[9] = L::KR;
    err = encode(&tm_kr, p.k, kl, L::KR);
    if (!err) err = encode(&tm_vr, p.v, vl, L::KR);
    if (err) return err;
  }
  static uint32_t opted_dq = 0, opted_kv = 0;   // a bit per device
  err = opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dq_bf16_pair<DK, DV, Widths>),
                    L::BYTES, opted_dq);
  if (err) return err;
  const int blocks = p.B * p.H * ((p.S + L::Q_ROWS - 1) / L::Q_ROWS);
  flash_bwd_dq_bf16_pair<DK, DV, Widths><<<blocks, 256, L::BYTES, stream>>>(
      tm_q, tm_do, tm_kr, tm_vr, p, wd);
  if ((err = (int)cudaGetLastError())) return err;
  err = opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dkdv_bf16_split<DK, DV, Widths>),
                    SplitSmem<DK, DV>::BYTES, opted_kv);
  if (err) return err;
  const int kv_blocks = p.B * p.KV * sh.n * ((p.Sk + ROWS - 1) / ROWS);
  flash_bwd_dkdv_bf16_split<DK, DV, Widths><<<kv_blocks, 256, SplitSmem<DK, DV>::BYTES,
                                              stream>>>(tm_q, tm_do, tm_k, tm_v, p, sh, wd);
  err = (int)cudaGetLastError();
  if (err || sh.n == 1) return err;
  const size_t quads = (size_t)p.B * p.Sk * p.KV * (DK + DV) / 4;
  const int sum_blocks = (int)((quads + 255) / 256 < 8192 ? (quads + 255) / 256 : 8192);
  flash_bwd_sum_shares<DK, DV, Widths><<<sum_blocks, 256, 0, stream>>>(p, sh, wd);
  return (int)cudaGetLastError();
}

}  // namespace

// As csrc/flash_attention_bwd.cu's flash_attention_bwd at real head dims
// dk and dv (multiples of 8) inside the bucket (bk, bv): (64, 64), (128,
// 128), (192, 128) or (256, 256); all bf16.  layout: q's, k's, v's and
// dO's TMA layouts at their real dims with boxes of 64 rows.  scratch: 2 *
// B * H * s_pad fp32, s_pad S rounded up to the bucket's dQ block (128 at
// (192, 128) and (256, 256), else 64).  part and shares as there, the
// partial sums at the bucket's widths, (shares, B, Sk, KV, bk + bv).
extern "C" int flash_attention_bwd_pad(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const float* lse,
                                       void* dq, void* dk, void* dv, float* scratch, int B,
                                       int S, int Sk, int H, int KV, int DK, int DV, int bk,
                                       int bv, int causal, int window, void* stream,
                                       const long long* layout, float* part, int shares,
                                       int s_pad) {
  if (DK <= 0 || DV <= 0 || DK > bk || DV > bv || DK % 8 || DV % 8 || layout == nullptr)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)DK);
  const bool split = (bk == 256 && bv == 256) || (bk == 192 && bv == 128);
  const int pad_rows = split ? 2 * ROWS : ROWS;   // the dQ kernel's block
  if (s_pad < S || s_pad % pad_rows) return (int)cudaErrorInvalidValue;
  if (shares < 1 || shares > H / KV || (shares > 1 && (!split || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, dout, lse, dq, dk, dv, scratch, scratch + (size_t)B * H * s_pad,
                 B, S, Sk, H, KV, causal, window, scale, LOG2E * scale, s_pad};
  const Shares sh{part, shares};
  const Widths wd{DK, DV};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bk == 64 && bv == 64) return launch_one<64>(p, wd, layout, st);
  if (bk == 128 && bv == 128) return launch_one<128>(p, wd, layout, st);
  if (bk == 256 && bv == 256) return launch_split<256, 256>(p, sh, wd, layout, st);
  if (bk == 192 && bv == 128) return launch_split<192, 128>(p, sh, wd, layout, st);
  return (int)cudaErrorInvalidValue;
}
