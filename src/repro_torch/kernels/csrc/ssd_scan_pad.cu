// Mamba-2 SSD chunked scan forward in bf16 at (P, N) other than mamba2's
// (64, 128): the padded route (kernels/ssd_scan.py:route).
//
// Replaces, as csrc/ssd_scan.cu does, src/repro/kernels/ssd_scan.py's
// Pallas kernel (ssd_scan_kernel, which takes any (P, N)), at head dim P
// and state dim N, each a multiple of 8 (so that every byte stride is a
// multiple of 16, as TMA needs), up to (64, 128), on the wgmma + TMA
// kernel built for (64, 128) (Zamba2's (64, 64) takes it).  The tensor
// maps carry the real (P, N): TMA zero-fills x, B and C past them, so the
// state's rows past P and columns past N stay zero and y's columns past P
// come out zero; y's TMA store clips at P, and the initial state's loads
// and the final state's stores stop at (P, N) (ssd_fwd_bf16_pad takes the
// real dims as an argument of its own, hopper.cuh: Widths, so that the
// (64, 128) instantiations keep their code).  It always runs the X code
// (B/C groups and an initial state as the call gives them).
//
// What bounds it: as at (64, 128), bytes on paper and the serial chain of
// a chunk in practice (csrc/ssd_scan.cu's header), on (64, 128)'s tiles:
// (64, 64) does twice the state MACs it needs.

#include "ssd_scan.cuh"

namespace {

using namespace hopper;

template <int Q, typename TA>
int launch_pad(const BfParams& p, const SsdExt& ext, const Widths& wd, const void* x,
               const void* b, const void* c, const long long* layout, int blocks,
               cudaStream_t stream) {
  CUtensorMap tm_x, tm_b, tm_c, tm_y;
  int err = encode(&tm_x, x, layout, Q);
  if (!err) err = encode(&tm_b, b, layout + 11, Q);
  if (!err) err = encode(&tm_c, c, layout + 22, Q);
  if (!err) err = encode(&tm_y, p.y, layout + 33, 64);
  if (err) return err;
  constexpr size_t smem = Tile<Q>::BYTES;
  static uint32_t opted = 0;   // a bit per device
  err = opt_in_smem(reinterpret_cast<const void*>(ssd_fwd_bf16_pad<Q, TA>), smem, opted);
  if (err) return err;
  ssd_fwd_bf16_pad<Q, TA><<<blocks, Tile<Q>::THREADS, smem, stream>>>(tm_x, tm_b, tm_c, tm_y, p,
                                                                      ext, wd);
  return (int)cudaGetLastError();
}

template <typename TA>
int by_chunk(const BfParams& p, const SsdExt& ext, const Widths& wd, const void* x,
             const void* b, const void* c, const long long* layout, int blocks, int q,
             cudaStream_t stream) {
  switch (q) {
    case 64: return launch_pad<64, TA>(p, ext, wd, x, b, c, layout, blocks, stream);
    case 128: return launch_pad<128, TA>(p, ext, wd, x, b, c, layout, blocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// As csrc/ssd_scan.cu's ssd_scan_fwd on its bf16 route, at (p_dim, n_dim),
// multiples of 8 up to (64, 128): x, y (B, L, H, p_dim); b, c (B, L, G,
// n_dim); state and s0 (B, H, p_dim, n_dim).  layout: x's, b's and c's
// TMA layouts at their real dims with boxes of q rows, and y's with boxes
// of 64, 11 values each.  q: 64 or 128.
extern "C" int ssd_scan_fwd_pad(const void* x, const void* dt, const void* a, const void* b,
                                const void* c, void* y, void* state, int B, int L, int H,
                                int p_dim, int n_dim, int q, int a_is_bf16, void* stream,
                                const long long* layout, const void* s0, int s0_f32,
                                int groups) {
  if (B <= 0 || L <= 0 || H <= 0 || groups <= 0 || H % groups || layout == nullptr ||
      p_dim <= 0 || n_dim <= 0 || p_dim > P || n_dim > N || p_dim % 8 || n_dim % 8)
    return (int)cudaErrorInvalidValue;
  const BfParams p{dt, a, y, state, L, H};
  const SsdExt ext{s0, nullptr, H / groups, s0_f32};
  const Widths wd{p_dim, n_dim};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_is_bf16)
    return by_chunk<__nv_bfloat16>(p, ext, wd, x, b, c, layout, B * H, q, st);
  return by_chunk<float>(p, ext, wd, x, b, c, layout, B * H, q, st);
}
