// Flash attention backward for Hopper (sm_90a), model layout (B, S, H, D).
//
// The gradient of the function csrc/flash_attention.cu computes, which
// replaces src/repro/kernels/flash_attention.py:flash_attention_bh.  The
// Pallas kernel is forward-only: the JAX package trains through autodiff of
// the jnp blockwise_mha (src/repro/models/layers.py), and this kernel
// computes that gradient.  P = exp(q.k / sqrt(D) - lse) is recomputed from
// the forward's per-row logsumexp under the same causal, sliding-window and
// ragged (keys past Sk) masks; a row with no visible key (lse = -inf) gets
// zero gradients.  FlashAttention-2's split into two kernels, deterministic,
// with no atomics:
//
//   flash_bwd_dq    grid (B*H, q tiles):  Delta = rowsum(dO * O) and lse in
//                   base 2, stored for the second kernel; over the kv tiles
//                   dP = dO V^T, dS = P * (dP - Delta), dQ += dS K / sqrt(D)
//                   (at (256, 256) and (192, 128) flash_bwd_dq_bf16_pair,
//                   128 q rows a block, below)
//   flash_bwd_dkdv  grid (B*KV, kv tiles): over the q heads of the kv head's
//                   GQA group and their q tiles dV += P^T dO,
//                   dK += dS^T Q / sqrt(D), so the group's sum is taken in
//                   the block and needs no second reduction (but where the
//                   two-warpgroup kernel splits the group into head shares,
//                   below)
//
// What bounds it on the H100: the tensor cores.  The gradient needs five
// products over the visible pairs (q k, dO v, P^T dO, dS k, dS^T q): at
// granite-3-2b's training shape (B 4, S 1024, H 32, KV 8, D 64, bf16,
// causal) 43 GFLOP, 0.044 ms at 989 TFLOP/s, against 84 MB of q, k, v, o,
// dO, lse and the three gradients, 0.025 ms at 3.35 TB/s.  The split does
// seven (each kernel recomputes q k and dO v), the price of no atomics.
//
// What the bf16 design does about it (FlashAttention-3's backward, without
// its dQ atomics):
//  * Every product on wgmma, no transposed copy.  The dK/dV kernel forms
//    S^T = K Q^T and dP^T = V dO^T with K, V, Q and dO K-major as TMA
//    writes them; the S^T accumulator's layout is the A-fragment layout,
//    so P^T and dS^T pack to bf16 in registers and dV += P^T dO,
//    dK += dS^T Q read dO and Q as MN-major B operands.  The dQ kernel
//    forms S = Q K^T and dP = dO V^T, then dQ += dS K reads the same K
//    tile MN-major.  P and dS are rounded to bf16 as product operands, as
//    the forward rounds P; gradients accumulate in fp32 registers and are
//    written once in the inputs' dtype.
//  * At D 64 and 128 a block is one warpgroup: its 64 kv rows (dK/dV) or
//    64 q rows (dQ) stay in shared memory, and the other side streams
//    through a ring of 64-row stages by TMA (128-byte swizzle, 64-column
//    boxes), with a "full" mbarrier per stage counting the TMA's bytes and
//    an "empty" one taking every thread's arrival; one elected thread keeps
//    the ring STAGES - 1 tiles ahead.  The dK/dV stage also brings the q tile's lse
//    and Delta (a 256-byte bulk copy each from a scratch padded to whole
//    tiles, which the dQ kernel writes).  Within a tile, exp2 of S runs
//    while dP is in flight, and the dV product while dS is formed; the
//    dK/dV kernel also issues a tile's S^T and dP^T while the previous
//    tile's dV and dK products finish.
//  * Registers decide occupancy, as in the forward: the dQ kernel keeps to
//    128 at D 64, so four blocks share an SM, the dK/dV kernel (dK, dV,
//    S^T and dP^T in registers) two.  Measured slower there (PERF.md §6): two
//    warpgroups a block, deeper rings, three dK/dV blocks an SM.
//  * TMA zero-fills rows past S or Sk, so ragged lengths need no padding
//    copy.  Masks are tested on edge tiles only (the causal diagonal, the
//    window's ends, the ragged ends); tiles with no visible pair are
//    neither loaded nor computed.
//  * Heaviest blocks first: under the causal mask the first kv tiles
//    (dK/dV) and the last q tiles (dQ) run longest, and launch first
//    (within each group of ORDER_UNITS (batch, head) units at D 256 and
//    (192, 128)).
//  * GQA by index through the tensor maps: no copy of K or V.
// fp32 inputs take csrc/flash_attention_bwd_f32.cu's register-tiled
// kernels at every head dim (kernels/flash_attention.py:bwd_route).
//
// Head dims: (64, 64) and (128, 128) as above; (256, 256) (recurrentgemma-9b)
// and (192, 128) (deepseek-v3's multi-head latent attention: q/k 192, v
// 128) in bf16 take a dQ kernel and a dK/dV kernel of two
// warpgroups (flash_bwd_dkdv_bf16_split): at D 256 one warpgroup's dK and
// dV of 64 kv rows are 2 x 64 x 256 / 128 = 256 fp32 registers a thread,
// past the 255 limit.  So each warpgroup owns whole 64-column boxes of dK
// and dV (at D 256 two of each; at (192, 128) the first warpgroup two of
// dK's three and one of dV's two, the second the rest).  S^T and dP^T are
// formed once a block: each warpgroup takes 32 of an item's 64 q columns
// (m64n32 over all of DK or DV), writes its half of P^T and dS^T to shared
// memory as bf16 in the swizzled K-major layout a wgmma A descriptor reads,
// and after a named barrier of both warpgroups (one for P^T, one for dS^T)
// runs its column slices of dV += P^T dO and dK += dS^T Q with A read from
// there.  P^T and dS^T alternate between two tiles each, so one barrier
// pair an item orders all reuse; item i's S^T and dP^T are issued while
// item i - 1's dV and dK run, and dV while dS^T is formed.  K and V (64 kv
// rows) stay in 64 KB of shared memory at D 256, two 64-row stages of Q
// and dO take 128 KB, P^T and dS^T 32 KB (226 KB of 227).  One block an
// SM: where B * KV * kv tiles fill fewer than two waves (recurrentgemma's
// MQA at B 1 and 2: 40 and 80 blocks), the launcher splits each kv tile's
// q heads into head shares over as many blocks
// (kernels/flash_attention.py:bwd_head_shares); each writes fp32 partial
// dK and dV to a scratch, and flash_bwd_sum_shares adds the shares in
// their order, scales dK and rounds once: deterministic, no atomics.
// Blocks go in groups of eight (batch, kv head, share) units, kv tile by
// kv tile, so that the blocks in flight read a few heads' q and dO rows
// from L2 (ORDER_UNITS; MLA's 128 kv heads otherwise miss it).
// The dQ kernel there (flash_bwd_dq_bf16_pair): the one-warpgroup kernel
// ran one block an SM at these widths (121-192 KB of shared memory), a
// serial chain a kv tile (S and dP, exp2, dS, the dQ product), and its
// (batch, head)-fastest grid made a wave's blocks read 132 MLA heads' K
// and V, past L2.  Now a block holds 128 q rows of one head: two
// warpgroups, each with its own 64 rows of Q and dO, running the whole
// m64n64 S and dP (m64n32 at D 256) and the m64n192 (m64n256) dQ product,
// over one ring of three K/V stages both read (64 kv rows at (192, 128),
// 206 KB; 32 at D 256, where Q and dO of 128 rows take 128 KB, 230 KB).
// Each K/V tile so serves 128 q rows, the two chains interleave on the
// tensor cores, and a tile's dQ product stays in flight while the next
// tile's S and dP are issued.  The ring streams the union of the two
// warpgroups' kv tiles; a warpgroup that sees no key of a tile (the first
// one's last causal tile, a window's edge, rows all past S) waits for it
// and releases it all the same, so that each arrival on a stage's "empty"
// counts toward that tile's phase.  Blocks go in groups of ORDER_UNITS
// (batch, head) units, q tile by q tile, heaviest first; the Delta / lse
// scratch is padded to 128 rows (kernels/flash_attention.py:
// bwd_scratch_rows).  What bounds it on an H100 80GB HBM3 at 700 W
// (PERF.md §6): at MLA's training shape (B 2, S 1024, 128 heads) its own
// bound is bytes, 0.151 ms, and it takes 0.374 ms; cut-out probes read
// 0.231 ms with no tile computed (prologue, K/V stream, store: one block
// an SM overlaps none of them), 0.271 without the dQ product, 0.308
// without exp2.  So the Delta prologue reads a warp's 16 rows at once.
// Measured slower: a producer warp of its own (288 threads, which ptxas
// held to 168 registers, spilling) and clusters of two CTAs that share
// each K/V tile by TMA multicast (each ring then waits on both CTAs).
// At (192, 128) the two products differ in depth (S over 192, dP over
// 128), dO and V have tensor maps of their own (two boxes against q's and
// k's three), Delta sums over v's 128 columns, and the scale is
// 1 / sqrt(192).  dQ += dS K is one m64n192k16 a k-step; at D 256 the K
// and V maps are encoded again with 32-row boxes for the dQ kernel.
// The smoke configs' head dims, (16, 16) and (24, 16), take the SIMT
// kernels in bf16 (T, the element type in memory; fp32 arithmetic): their
// tiles are not whole 64-column TMA boxes.  The route is chosen by head
// dims and dtype only.

#include "flash_attention_bwd.cuh"

namespace {

using namespace hopper;

// ---------------------------------------------------------------------------
// SIMT, one warp a row, lane l holding columns l, l + 32, ... (those below
// the head dim): bf16 at the smoke configs' (16, 16) and (24, 16).  T is
// the element type in memory; TN rows of the other
// side are staged in fp32 shared memory where they fit in 48 KB, else TN / 2
// ---------------------------------------------------------------------------
template <int DK, int DV>
__host__ __device__ constexpr int simt_rows() { return (DK + DV) * TN * 4 <= 49152 ? TN : TN / 2; }

// column e of a lane holding E_ columns of a D-column row
template <int D>
__device__ __forceinline__ bool has_col(int lane, int e) {
  return D % 32 == 0 || lane + 32 * e < D;
}

template <int DK, int DV, typename T>
__global__ void __launch_bounds__(WR * 32) flash_bwd_dq_f32(Params p) {
  constexpr int EK = (DK + 31) / 32, EV = (DV + 31) / 32;
  constexpr int TN_ = simt_rows<DK, DV>();
  __shared__ __align__(16) float sK[TN_][DK];
  __shared__ __align__(16) float sV[TN_][DV];

  const int bh = blockIdx.x;   // B * H on x: any B * H
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * WR, row = q0 + warp;
  const size_t q_stride = (size_t)p.H * DK, o_stride = (size_t)p.H * DV;
  const size_t k_stride = (size_t)p.KV * DK, v_stride = (size_t)p.KV * DV;
  const size_t q_off = ((size_t)b * p.S * p.H + h) * DK;
  const size_t o_off = ((size_t)b * p.S * p.H + h) * DV;
  const T* kb = static_cast<const T*>(p.k) + ((size_t)b * p.Sk * p.KV + kvh) * DK;
  const T* vb = static_cast<const T*>(p.v) + ((size_t)b * p.Sk * p.KV + kvh) * DV;
  const size_t row_off = ((size_t)b * p.H + h) * p.S;
  const bool live = row < p.S;

  float q[EK], dq[EK], dout[EV];
  float delta = 0.f;
#pragma unroll
  for (int i = 0; i < EK; ++i) {
    const bool in = live && has_col<DK>(lane, i);
    q[i] = in ? to_f(static_cast<const T*>(p.q)[q_off + (size_t)row * q_stride + lane + 32 * i])
              : 0.f;
    dq[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < EV; ++i) {
    const bool in = live && has_col<DV>(lane, i);
    const size_t at = o_off + (size_t)row * o_stride + lane + 32 * i;
    dout[i] = in ? to_f(static_cast<const T*>(p.dout)[at]) : 0.f;
    delta += in ? to_f(static_cast<const T*>(p.o)[at]) * dout[i] : 0.f;
  }
  delta = warp_sum(delta);
  if (live && lane == 0) p.delta[row_off + row] = delta;
  const float lse2 = live ? p.lse[row_off + row] * LOG2E : 0.f;

  int lo, hi;
  kv_range(p, q0, WR, lo, hi);
  for (int k0 = (lo / TN_) * TN_; k0 < hi; k0 += TN_) {
    __syncthreads();
    for (int c = threadIdx.x; c < TN_ * DK; c += blockDim.x) {
      const int r = c / DK, d = c % DK;
      sK[r][d] = k0 + r < p.Sk ? to_f(kb[(size_t)(k0 + r) * k_stride + d]) : 0.f;
    }
    for (int c = threadIdx.x; c < TN_ * DV; c += blockDim.x) {
      const int r = c / DV, d = c % DV;
      sV[r][d] = k0 + r < p.Sk ? to_f(vb[(size_t)(k0 + r) * v_stride + d]) : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < TN_; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < EK; ++i)
        if (has_col<DK>(lane, i)) s = fmaf(q[i], sK[j][lane + 32 * i], s);
#pragma unroll
      for (int i = 0; i < EV; ++i)
        if (has_col<DV>(lane, i)) dp = fmaf(dout[i], sV[j][lane + 32 * i], dp);
      s = warp_sum(s);
      dp = warp_sum(dp);
      if (visible(p, row, k0 + j)) {   // uniform over the warp
        const float ds = exp2f(fmaf(s, p.scale_log2, -lse2)) * (dp - delta);
#pragma unroll
        for (int i = 0; i < EK; ++i)
          if (has_col<DK>(lane, i)) dq[i] = fmaf(ds, sK[j][lane + 32 * i], dq[i]);
      }
    }
  }
  if (live)
#pragma unroll
    for (int i = 0; i < EK; ++i)
      if (has_col<DK>(lane, i))
        store_f(static_cast<T*>(p.dq) + q_off + (size_t)row * q_stride + lane + 32 * i,
                dq[i] * p.scale);
}

template <int DK, int DV, typename T>
__global__ void __launch_bounds__(WR * 32) flash_bwd_dkdv_f32(Params p) {
  constexpr int EK = (DK + 31) / 32, EV = (DV + 31) / 32;
  constexpr int TN_ = simt_rows<DK, DV>();
  __shared__ __align__(16) float sQ[TN_][DK];
  __shared__ __align__(16) float sdO[TN_][DV];
  __shared__ float sL[TN_], sDl[TN_];

  const int bk = blockIdx.x;
  const int b = bk / p.KV, kvh = bk % p.KV;
  const int group = p.H / p.KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.y * WR, krow = k0 + warp;
  const size_t q_stride = (size_t)p.H * DK, o_stride = (size_t)p.H * DV;
  const size_t k_stride = (size_t)p.KV * DK, v_stride = (size_t)p.KV * DV;
  const size_t k_off = ((size_t)b * p.Sk * p.KV + kvh) * DK;
  const size_t v_off = ((size_t)b * p.Sk * p.KV + kvh) * DV;
  const bool live = krow < p.Sk;

  float k[EK], dk[EK], v[EV], dv[EV];
#pragma unroll
  for (int i = 0; i < EK; ++i) {
    const bool in = live && has_col<DK>(lane, i);
    k[i] = in ? to_f(static_cast<const T*>(p.k)[k_off + (size_t)krow * k_stride + lane + 32 * i])
              : 0.f;
    dk[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < EV; ++i) {
    const bool in = live && has_col<DV>(lane, i);
    v[i] = in ? to_f(static_cast<const T*>(p.v)[v_off + (size_t)krow * v_stride + lane + 32 * i])
              : 0.f;
    dv[i] = 0.f;
  }

  int lo, hi;
  q_range(p, k0, WR, lo, hi);
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const T* qb = static_cast<const T*>(p.q) + ((size_t)b * p.S * p.H + h) * DK;
    const T* dob = static_cast<const T*>(p.dout) + ((size_t)b * p.S * p.H + h) * DV;
    const size_t row_off = ((size_t)b * p.H + h) * p.S;
    for (int q0 = (lo / TN_) * TN_; q0 < hi; q0 += TN_) {
      __syncthreads();
      for (int c = threadIdx.x; c < TN_ * DK; c += blockDim.x) {
        const int r = c / DK, d = c % DK;
        sQ[r][d] = q0 + r < p.S ? to_f(qb[(size_t)(q0 + r) * q_stride + d]) : 0.f;
      }
      for (int c = threadIdx.x; c < TN_ * DV; c += blockDim.x) {
        const int r = c / DV, d = c % DV;
        sdO[r][d] = q0 + r < p.S ? to_f(dob[(size_t)(q0 + r) * o_stride + d]) : 0.f;
      }
      for (int i = threadIdx.x; i < TN_; i += blockDim.x) {
        const bool in = q0 + i < p.S;
        sL[i] = in ? p.lse[row_off + q0 + i] * LOG2E : 0.f;
        sDl[i] = in ? p.delta[row_off + q0 + i] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < TN_; ++j) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < EK; ++i)
          if (has_col<DK>(lane, i)) s = fmaf(k[i], sQ[j][lane + 32 * i], s);
#pragma unroll
        for (int i = 0; i < EV; ++i)
          if (has_col<DV>(lane, i)) dp = fmaf(v[i], sdO[j][lane + 32 * i], dp);
        s = warp_sum(s);
        dp = warp_sum(dp);
        if (live && visible(p, q0 + j, krow)) {   // uniform over the warp
          const float pj = exp2f(fmaf(s, p.scale_log2, -sL[j]));
          const float ds = pj * (dp - sDl[j]);
#pragma unroll
          for (int i = 0; i < EV; ++i)
            if (has_col<DV>(lane, i)) dv[i] = fmaf(pj, sdO[j][lane + 32 * i], dv[i]);
#pragma unroll
          for (int i = 0; i < EK; ++i)
            if (has_col<DK>(lane, i)) dk[i] = fmaf(ds, sQ[j][lane + 32 * i], dk[i]);
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < EK; ++i)
      if (has_col<DK>(lane, i))
        store_f(static_cast<T*>(p.dk) + k_off + (size_t)krow * k_stride + lane + 32 * i,
                dk[i] * p.scale);
#pragma unroll
    for (int i = 0; i < EV; ++i)
      if (has_col<DV>(lane, i))
        store_f(static_cast<T*>(p.dv) + v_off + (size_t)krow * v_stride + lane + 32 * i, dv[i]);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// the TMA maps of q, dO, k and v: layout holds q's, k's, v's and dO's
template <int DK, int DV>
int encode_maps(const Params& p, const long long* layout, CUtensorMap& tm_q, CUtensorMap& tm_do,
                CUtensorMap& tm_k, CUtensorMap& tm_v) {
  int err = encode(&tm_q, p.q, layout, ROWS);
  if (!err) err = encode(&tm_k, p.k, layout + 11, ROWS);
  if (!err) err = encode(&tm_v, p.v, layout + 22, ROWS);
  if (!err) err = encode(&tm_do, p.dout, layout + 33, ROWS);
  return err;
}

template <int DK, int DV>
int launch_dq_bf16(const Params& p, const CUtensorMap& tm_q, const CUtensorMap& tm_do,
                   const CUtensorMap& tm_k, const CUtensorMap& tm_v, cudaStream_t stream) {
  using W = FixedWidths<DK, DV>;
  static uint32_t opted = 0;   // a bit per device
  const int err = opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dq_bf16<DK, DV, W>),
                              DqSmem<DK, DV>::BYTES, opted);
  if (err) return err;
  flash_bwd_dq_bf16<DK, DV, W><<<dim3(p.B * p.H, (p.S + ROWS - 1) / ROWS), 128,
                                 DqSmem<DK, DV>::BYTES, stream>>>(tm_q, tm_do, tm_k, tm_v, p,
                                                                  W{});
  return (int)cudaGetLastError();
}

// the two-warpgroup dQ kernel; K and V in boxes of its stages' KR rows
// (tm_k, tm_v have boxes of ROWS)
template <int DK, int DV>
int launch_dq_pair(const Params& p, const long long* layout, const CUtensorMap& tm_q,
                   const CUtensorMap& tm_do, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                   cudaStream_t stream) {
  using L = PairSmem<DK, DV>;
  CUtensorMap tm_kr = tm_k, tm_vr = tm_v;
  if constexpr (L::KR != ROWS) {
    long long kl[11], vl[11];
    for (int i = 0; i < 11; ++i) kl[i] = layout[11 + i], vl[i] = layout[22 + i];
    kl[9] = vl[9] = L::KR;
    int err = encode(&tm_kr, p.k, kl, L::KR);
    if (!err) err = encode(&tm_vr, p.v, vl, L::KR);
    if (err) return err;
  }
  using W = FixedWidths<DK, DV>;
  static uint32_t opted = 0;   // a bit per device
  const int err = opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dq_bf16_pair<DK, DV, W>),
                              L::BYTES, opted);
  if (err) return err;
  const int blocks = p.B * p.H * ((p.S + L::Q_ROWS - 1) / L::Q_ROWS);
  flash_bwd_dq_bf16_pair<DK, DV, W><<<blocks, 256, L::BYTES, stream>>>(tm_q, tm_do, tm_kr, tm_vr,
                                                                       p, W{});
  return (int)cudaGetLastError();
}

// D 64 and 128: the dQ kernel, then the one-warpgroup dK/dV kernel
template <int D>
int launch_bf16(const Params& p, const long long* layout, cudaStream_t stream) {
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  int err = encode_maps<D, D>(p, layout, tm_q, tm_do, tm_k, tm_v);
  if (!err) err = launch_dq_bf16<D, D>(p, tm_q, tm_do, tm_k, tm_v, stream);
  if (err) return err;
  using W = FixedWidths<D, D>;
  static uint32_t opted = 0;   // a bit per device
  err = opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dkdv_bf16<D, W>), DkdvSmem<D>::BYTES,
                    opted);
  if (err) return err;
  flash_bwd_dkdv_bf16<D, W><<<dim3(p.B * p.KV, (p.Sk + ROWS - 1) / ROWS), 128,
                              DkdvSmem<D>::BYTES, stream>>>(tm_q, tm_do, tm_k, tm_v, p, W{});
  return (int)cudaGetLastError();
}

// (256, 256) and (192, 128): the two-warpgroup dQ kernel, then the
// two-warpgroup dK/dV kernel over sh.n head shares and, for more than one,
// the pass that sums them
template <int DK, int DV>
int launch_bf16_split(const Params& p, const Shares& sh, const long long* layout,
                      cudaStream_t stream) {
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  int err = encode_maps<DK, DV>(p, layout, tm_q, tm_do, tm_k, tm_v);
  if (!err) err = launch_dq_pair<DK, DV>(p, layout, tm_q, tm_do, tm_k, tm_v, stream);
  if (err) return err;
  using W = FixedWidths<DK, DV>;
  static uint32_t opted = 0;   // a bit per device
  err = opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dkdv_bf16_split<DK, DV, W>),
                    SplitSmem<DK, DV>::BYTES, opted);
  if (err) return err;
  const int blocks = p.B * p.KV * sh.n * ((p.Sk + ROWS - 1) / ROWS);
  flash_bwd_dkdv_bf16_split<DK, DV, W><<<blocks, 256, SplitSmem<DK, DV>::BYTES, stream>>>(
      tm_q, tm_do, tm_k, tm_v, p, sh, W{});
  err = (int)cudaGetLastError();
  if (err || sh.n == 1) return err;
  const size_t quads = (size_t)p.B * p.Sk * p.KV * (DK + DV) / 4;
  const int sum_blocks = (int)((quads + 255) / 256 < 8192 ? (quads + 255) / 256 : 8192);
  flash_bwd_sum_shares<DK, DV, W><<<sum_blocks, 256, 0, stream>>>(p, sh, W{});
  return (int)cudaGetLastError();
}

template <int DK, int DV, typename T>
int launch_simt(const Params& p, cudaStream_t stream) {
  flash_bwd_dq_f32<DK, DV, T><<<dim3(p.B * p.H, (p.S + WR - 1) / WR), WR * 32, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_f32<DK, DV, T><<<dim3(p.B * p.KV, (p.Sk + WR - 1) / WR), WR * 32, 0, stream>>>(
      p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dq: (B, S, H, DK); o, dout: (B, S, H, DV); k, dk: (B, Sk, KV, DK);
// v, dv: (B, Sk, KV, DV); all contiguous bf16, the launcher's dtype code
// 1 (0, fp32, runs csrc/flash_attention_bwd_f32.cu and 2, fp16,
// csrc/flash_attention_bwd_f16.cu; both are refused here, as is any other
// code, with cudaErrorInvalidValue).  lse: (B, H, S) fp32 from the forward.  scratch: 2 * B * H * s_pad
// fp32, where s_pad is S rounded up to the dQ block's rows (128 where the
// bf16 dQ kernel is two warpgroups, else 64), as
// kernels/flash_attention.py:bwd_scratch_rows computes it; another s_pad
// is refused.  layout: for bf16 at the wgmma head dims ((64, 64), (128,
// 128), (256, 256), (192, 128)), the TMA layouts of
// q, k, v and dout with boxes of 64 rows, 11 values each, as
// kernels/flash_attention.py:tma_layout computes them; unused otherwise.
// shares: the head shares of the two-warpgroup dK/dV kernel (bf16 at
// (256, 256) and (192, 128)), 1 on every other route; above 1, part holds
// shares * B * Sk * KV * (DK + DV) fp32, as
// kernels/flash_attention.py:bwd_head_shares chooses it.  The kernels run
// in order on `stream`.  Returns cudaGetLastError() after the launches, or
// a negative code from encode().
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, void* dq, void* dk,
                                   void* dv, float* scratch, int B, int S, int Sk, int H, int KV,
                                   int DK, int DV, int causal, int window, int dtype,
                                   void* stream, const long long* layout, float* part,
                                   int shares, int s_pad) {
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const bool is_bf16 = dtype == 1;
  const float scale = 1.f / sqrtf((float)DK);
  const bool split = is_bf16 && ((DK == 256 && DV == 256) || (DK == 192 && DV == 128));
  const int pad_rows = split ? 2 * ROWS : ROWS;   // the dQ kernel's block
  if (s_pad < S || s_pad % pad_rows) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, dout, lse, dq, dk, dv, scratch, scratch + (size_t)B * H * s_pad,
           B, S, Sk, H, KV, causal, window, scale, LOG2E * scale, s_pad};
  const Shares sh{part, shares};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shares < 1 || shares > H / KV || (shares > 1 && (!split || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (DK == 16 && DV == 16) return launch_simt<16, 16, __nv_bfloat16>(p, st);
  if (DK == 24 && DV == 16) return launch_simt<24, 16, __nv_bfloat16>(p, st);
  if (layout == nullptr) return (int)cudaErrorInvalidValue;
  if (DK == 64 && DV == 64) return launch_bf16<64>(p, layout, st);
  if (DK == 128 && DV == 128) return launch_bf16<128>(p, layout, st);
  if (DK == 256 && DV == 256) return launch_bf16_split<256, 256>(p, sh, layout, st);
  if (DK == 192 && DV == 128) return launch_bf16_split<192, 128>(p, sh, layout, st);
  return (int)cudaErrorInvalidValue;
}
