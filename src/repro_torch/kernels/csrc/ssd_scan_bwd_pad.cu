// Mamba-2 SSD chunked scan backward in bf16 at (P, N) other than mamba2's
// (64, 128): the padded route (kernels/ssd_scan.py:route), the gradient of
// csrc/ssd_scan_pad.cu's forward.
//
// The gradient csrc/ssd_scan_bwd.cu computes (the autodiff of
// src/repro/models/ssm.py:ssd_scan, whose forward src/repro/kernels/
// ssd_scan.py's Pallas kernel replaces) at head dim P and state dim N,
// each a multiple of 8 up to (64, 128), on the three wgmma + TMA kernels
// built for (64, 128).  The tensor maps of x, B, C and dy carry the real
// (P, N), so TMA zero-fills them past it: the states and their gradients
// stay zero in the rows past P and the columns past N, and so do du's
// columns past P and dB's and dC's past N.  dstate's and s0's loads, s0's
// gradient and dx stop at the real (P, N) (the *_pad kernels take it as an
// argument of their own, hopper.cuh: Widths); dB's and dC's shares stay at
// N 128, which the launcher cuts to N.  It always runs the X code.  What
// bounds it is what bounds the (64, 128) kernels (csrc/ssd_scan_bwd.cu),
// on their tiles.

#include "ssd_scan_bwd.cuh"

namespace {

using namespace hopper;
using namespace tc;

template <typename TA>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
           const void* dy, const void* dstate, void* dx, void* ddt, float* vec, void* states,
           void* dstates, float* da_part, float* db_part, float* dc_part, int B, int L, int H,
           int hg, const long long* layout, const SsdExt& ext, const Widths& wd,
           cudaStream_t stream) {
  CUtensorMap tm[4];   // x, b, c, dy
  const void* ptrs[4] = {x, b, c, dy};
  int err = 0;
  for (int k = 0; k < 4; ++k)   // -1x / -2x: the encoder's code for map k
    if ((err = encode(&tm[k], ptrs[k], layout + 11 * k, Q))) return err - 10 * (k + 1);
  // blocks of hg heads a (b, chunk), each B/C group's in turn (G = H / hpg)
  const int nc = (L + Q - 1) / Q, items = B * H * nc;
  const int ng = (H / ext.hpg) * ((ext.hpg + hg - 1) / hg);
  ssd_bwd_prep<TA><<<(items + 3) / 4, 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(dt), static_cast<const TA*>(a), vec, L, H, nc, items);
  if ((err = (int)cudaGetLastError())) return err;
  static uint32_t opted_st = 0, opted_ch = 0;   // a bit per device
  if ((err = opt_in_smem(reinterpret_cast<const void*>(ssd_bwd_states_pad<Widths>), ST_BYTES,
                         opted_st)))
    return err;
  const StParams sp{static_cast<const __nv_bfloat16*>(dstate), vec,
                    static_cast<__nv_bfloat16*>(states), static_cast<__nv_bfloat16*>(dstates), H,
                    nc};
  ssd_bwd_states_pad<Widths><<<dim3(B * H, NBX, 2), 128, ST_BYTES, stream>>>(
      tm[0], tm[1], tm[2], tm[3], sp, ext, wd);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = opt_in_smem(reinterpret_cast<const void*>(ssd_bwd_chunks_pad<TA>), CH_BYTES,
                         opted_ch)))
    return err;
  const ChParams cp{vec, static_cast<const __nv_bfloat16*>(states),
                    static_cast<const __nv_bfloat16*>(dstates), a,
                    static_cast<__nv_bfloat16*>(dx), static_cast<__nv_bfloat16*>(ddt), da_part,
                    db_part, dc_part, L, H, nc, hg, ng};
  ssd_bwd_chunks_pad<TA><<<B * nc * ng, 256, CH_BYTES, stream>>>(tm[0], tm[1], tm[2], tm[3], cp,
                                                                 ext, wd);
  return (int)cudaGetLastError();
}

}  // namespace

// As csrc/ssd_scan_bwd.cu's ssd_scan_bwd_tc at (p_dim, n_dim), multiples
// of 8 up to (64, 128): x, dy, dx (B, L, H, p_dim); b, c (B, L, G, n_dim);
// dstate, s0 and ds0 (B, H, p_dim, n_dim).  db_part and dc_part are (B, L,
// G ceil(H / G / head_group), 128) fp32 shares, columns past n_dim zero.
// layout: x's, b's, c's and dy's TMA layouts at their real dims with boxes
// of 64 rows.
extern "C" int ssd_scan_bwd_pad(const void* x, const void* dt, const void* a, const void* b,
                                const void* c, const void* dy, const void* dstate, void* dx,
                                void* ddt, float* vec, void* states, void* dstates,
                                float* da_part, float* db_part, float* dc_part, int B, int L,
                                int H, int head_group, int a_is_bf16, const long long* layout,
                                void* stream, const void* s0, float* ds0, int s0_f32,
                                int groups, int p_dim, int n_dim) {
  if (B <= 0 || L <= 0 || H <= 0 || head_group <= 0 || layout == nullptr || groups <= 0 ||
      H % groups || head_group > H / groups || p_dim <= 0 || n_dim <= 0 || p_dim > P ||
      n_dim > N || p_dim % 8 || n_dim % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SsdExt ext{s0, ds0, H / groups, s0_f32};
  const Widths wd{p_dim, n_dim};
  if (a_is_bf16)
    return launch<__nv_bfloat16>(x, dt, a, b, c, dy, dstate, dx, ddt, vec, states, dstates,
                                 da_part, db_part, dc_part, B, L, H, head_group, layout, ext, wd,
                                 st);
  return launch<float>(x, dt, a, b, c, dy, dstate, dx, ddt, vec, states, dstates, da_part,
                       db_part, dc_part, B, L, H, head_group, layout, ext, wd, st);
}
