// Flash attention forward in bf16 at head dims that are no built pair: the
// padded route (kernels/flash_attention.py:route); its backward is
// csrc/flash_attention_bwd_pad.cu.
//
// Replaces, as csrc/flash_attention.cu and csrc/flash_attention_bwd.cu
// do, src/repro/kernels/flash_attention.py:flash_attention_bh, which takes
// any head dim; this route takes bf16 at q/k dim DK and v dim DV, each a
// multiple of 8 (so that every byte stride is a multiple of 16, as TMA
// needs), on the wgmma + TMA kernels of the smallest built pair (the
// bucket) that holds them: (64, 64), (128, 128) or (256, 256) here, and
// (192, 128) in csrc/flash_attention_fwd_ws.cu's forward.  phi-2's D 80
// and phi-3-mini's D 96 take (128, 128).
//
// How the kernels do it: the tensor maps carry the real dims, so TMA
// zero-fills the columns of the last 64-column box past them; zero q and
// k columns leave every score as it is, and zero v and dO columns give
// zero O, dQ, dK and dV columns.  No input is copied or padded.  The
// stores of O, dQ, dK and dV stop at the real dims (the *_pad kernels
// take them in their Widths instantiations, as an argument of their own,
// hopper.cuh, so that the buckets' own instantiations keep their code),
// and the scale is 1 / sqrt(real DK).
//
// What bounds it: as at the bucket, the tensor cores (csrc/flash_attention.cu
// and csrc/flash_attention_bwd.cu say why), but on the bucket's products:
// D 80 does (128 / 80) = 1.6x the MACs its own dims need.  A kernel at
// other widths (m64n80 products, 80-column boxes) would not; it is not
// built (PERF.md §7).

#include "flash_attention_fwd.cuh"

namespace {

using namespace hopper;

// the bucket at kv tile kv_tile (kernels/flash_attention.py:KV_TILES)
template <int DK, int DV>
int launch_tile(const Params& p, const Widths& wd, const long long* layout, cudaStream_t stream,
                int kv_tile) {
  if (kv_tile == 64) return launch_fwd<DK, DV, 64, Widths>(p, wd, layout, stream);
  if constexpr (DK != 256) {
    if (kv_tile == 128) return launch_fwd<DK, DV, 128, Widths>(p, wd, layout, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (B, S, H, dk); k: (B, Sk, KV, dk); v: (B, Sk, KV, dv); o: (B, S, H,
// dv); all bf16, contiguous; dk and dv multiples of 8 inside the bucket
// (bk, bv): (64, 64), (128, 128) or (256, 256).  layout: the TMA layouts
// of q (boxes of 128 rows), k and v (boxes of kv_tile rows) at their real
// dims, 11 values each, as kernels/flash_attention.py:tma_layout computes
// them.  lse: null or a (B, H, S) fp32 buffer.  scale_dk: the q/k head
// dim the scores are scaled by, 1 / sqrt(scale_dk): dk, or on the staged
// route (kernels/flash_attention.py:route, kind "stage") the real dim that
// dk, its pitch, rounds up to a multiple of 8.  Returns cudaGetLastError()
// after the launch, a negative code from encode(), or
// cudaErrorInvalidValue for dims, a bucket or a tile it does not take.
extern "C" int flash_attention_fwd_pad(const void* q, const void* k, const void* v, void* o,
                                       int B, int S, int Sk, int H, int KV, int dk, int dv,
                                       int bk, int bv, int causal, int window, void* stream,
                                       const long long* layout, float* lse, int kv_tile,
                                       int scale_dk) {
  if (dk <= 0 || dv <= 0 || dk > bk || dv > bv || dk % 8 || dv % 8 || layout == nullptr ||
      !pitch_of(scale_dk, dk))
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, B, S, Sk, H, KV, causal, window,
                 LOG2E / sqrtf((float)scale_dk), lse};
  const Widths wd{dk, dv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bk == 64 && bv == 64) return launch_tile<64, 64>(p, wd, layout, st, kv_tile);
  if (bk == 128 && bv == 128) return launch_tile<128, 128>(p, wd, layout, st, kv_tile);
  if (bk == 256 && bv == 256) return launch_tile<256, 256>(p, wd, layout, st, kv_tile);
  return (int)cudaErrorInvalidValue;
}
