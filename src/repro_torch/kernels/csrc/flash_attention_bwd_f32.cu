// The fp32 flash-attention backward for Hopper (sm_90a), model layout
// (B, S, H, D), at every q/k head dim dk and v head dim dv from 1 to 256.
//
// The gradient of the function csrc/flash_attention_fwd_f32.cu computes
// in fp32, which replaces
// src/repro/kernels/flash_attention.py:flash_attention_bh: the Pallas
// kernel is forward-only and the JAX package trains through autodiff of
// the jnp blockwise_mha (src/repro/models/layers.py), so these kernels
// compute that gradient, in full fp32 on the CUDA cores (every product an
// fp32 FMA: TF32 on the tensor cores keeps about three digits, and the fp32
// gates hold 1e-4 against jax.grad).  P = exp(q.k / sqrt(dk) - lse) is
// recomputed from the forward's per-row logsumexp under the causal,
// sliding-window and ragged masks; a row with no visible key gets zero
// gradients.  FlashAttention-2's split, deterministic, with no atomics:
//
//   flash_bwd_dq_tiled    a block: RR q rows of one head, Q and dO
//                         resident.  Delta = rowsum(dO * O) and lse in base
//                         2 of its rows, stored for the second kernel; over
//                         the kv tiles S = Q K^T, dP = dO V^T,
//                         dS = P * (dP - Delta), dQ += dS K / sqrt(dk)
//   flash_bwd_dkdv_tiled  a block: RR kv rows of one kv head, K and V
//                         resident; over the q heads of the kv head's GQA
//                         group (or of one head share of it) and their q
//                         tiles S^T = K Q^T, dP^T = V dO^T,
//                         dV += P^T dO, dK += dS^T Q / sqrt(dk)
//   flash_bwd_sum_tiled   where the dK/dV kernel splits a group into head
//                         shares: their fp32 partials added in share order
//
// What bounds it on the H100: fp32 FMAs, 67 TFLOP/s on the CUDA cores.  At
// granite-3-2b's training shape (B 4, S 1024, H 32, KV 8, D 64, causal) the
// five products over the visible pairs are 43 GFLOP, 0.64 ms, against 0.05
// ms for the bytes; the split does seven (each kernel forms S and dP).
// The SIMT kernels these replace (a warp a row, every score a warp
// reduction, a staged tile serving 8 rows) read 0.045-0.075 of their
// bound (PERF.md §6).
//
// What the design does about it: every product is a register-tiled outer
// product of 256 threads over shared memory.
//  * Tiles: a block keeps RR rows (kv rows in dK/dV, q rows in dQ) of its
//    two operands in shared memory and streams RS rows of the other side's
//    two a stage, two or three stages by cp.async (16-byte copies where the
//    head dim is a multiple of 4, 4-byte ones else; rows past S or Sk and
//    the columns up to a multiple of 4 zero-filled by the copy).  Each
//    staged tile so serves RR rows.  Rows are padded by 4 floats, so the
//    16-byte reads of 8 consecutive rows fall in 8 bank quads.
//  * Scores: the RR x RS tile S (S^T in dK/dV) is the first 128 threads',
//    dP (dP^T) the other 128's; where a stage is 32 rows each half is cut
//    again in two over the head dim (DSPLIT: two partial sums a tile,
//    added in order).  Each thread holds an MA x 4 micro-tile (rows
//    r + TAR i, columns c + TAC j: 8 x 4, or 4 x 4 at D 256) summed over
//    its share of the head dim by float4 reads of both operands' rows: no
//    per-score reduction, and one product a thread, so each micro-tile is
//    two to four times what both products over 256 threads would give.
//    Shared memory feeds an SM 32 floats a clock against 128 FMA lanes, so
//    FMAs per float read is what a layout buys: 8 x 4 reads 12 float4 for
//    128 FMAs.  The loop stops at the real dim rounded up to 4.  The
//    partial S and dP tiles meet in shared memory, where all 256 threads
//    form P = exp2(S scale_log2 - lse2) and dS = P * (dP - Delta), a float4
//    at a time (masks skipped on tiles that are wholly visible).
//  * The outputs (dQ; dK and dV) are RR x bucket width tiles of TBR x TBC
//    threads, each holding MB = RR / TBR rows by chunks of CW columns,
//    CW TBC apart (4 x 4 to 4 x 12 a thread), summed over the RS staged
//    rows: a float4 of P^T (dS^T, dS) per row and a float4 (float2 in the
//    (96, 96) bucket) of the staged row per chunk.  dK, dV (or dQ) stay in
//    registers over the whole stream and are written once.
//  * Widths: templated on a bucket of widths (BUCKETS, the first that
//    holds (dk, dv)), with the real dims at run time: the products over the
//    head dim run to the real dim, the output tiles over the bucket's
//    columns, of which only the real ones are stored.
//  * Few kv tiles: where B * KV * ceil(Sk / RR) blocks fill fewer than two
//    waves of the card, the launcher splits each kv tile's q heads into
//    head shares of as many heads each (kernels/flash_attention.py:
//    bwd_f32_head_shares), each block writing fp32 partial dK and dV,
//    summed in share order.
//  * Three barriers a tile: the next tile's copies are issued after the
//    first, when every thread is done with the buffer they overwrite.
//  * Heaviest blocks first: under the causal mask the last q tiles (dQ)
//    and the first kv tiles (dK/dV) launch first.
//  * Budget: one block an SM (140-219 KB of shared memory, bwd_f32_tiles),
//    at most 80 accumulators a thread (dK and dV of 64 kv rows at (192,
//    128)); D 256 takes 32-row tiles on both sides (dK and dV of 64 rows
//    would be 128 KB, as many registers as 256 threads may hold).
//
// GQA by index: q head h reads kv head h / (H / KV), no copy of K or V.

#include <math.h>
#include <stdint.h>

#include "flash_attention_f32.cuh"   // THREADS, PAD, cp.async tiles; hopper.cuh's opt_in_smem

namespace {

// The buckets of widths, smallest first: (DKB, DVB, RR, RS).  RR: rows a
// block keeps (kv rows of dK/dV, q rows of dQ); RS: rows a stage streams
// (kernels/flash_attention.py:F32_BUCKETS, bwd_f32_tiles)
constexpr int BUCKETS[5][4] = {
    {64, 64, 64, 64}, {96, 96, 64, 64}, {128, 128, 64, 32}, {192, 128, 64, 32},
    {256, 256, 32, 32}};

constexpr int bucket_row(int dkb, int dvb) {
  for (int i = 0; i < 5; ++i)
    if (BUCKETS[i][0] == dkb && BUCKETS[i][1] == dvb) return i;
  return -1;
}

template <int DKB_, int DVB_>
struct Tiles {
  static constexpr int DKB = DKB_, DVB = DVB_;
  static constexpr int RR = BUCKETS[bucket_row(DKB, DVB)][2];
  static constexpr int RS = BUCKETS[bucket_row(DKB, DVB)][3];
  static constexpr int LK = DKB + PAD, LV = DVB + PAD, LP = RS + PAD;   // shared row strides
  // the scores: S over the first half of the threads, dP over the second;
  // where a stage is 32 rows each half is cut again into DSPLIT groups that
  // sum over their share of the head dim (partial sums added in order).  A
  // group is TAR x TAC threads of MA x NA micro-tiles
  static constexpr int DSPLIT = RS == 32 ? 2 : 1;
  static constexpr int GROUP = THREADS / 2 / DSPLIT;
  static constexpr int NA = 4, TAC = RS / NA, TAR = GROUP / TAC, MA = RR / TAR;
  // the outputs: TBR x TBC threads, MB rows and CK / CV chunks of CW columns each
  static constexpr int TBC = DKB == 256 ? 32 : 16;
  static constexpr int CW = (DKB % (4 * TBC) || DVB % (4 * TBC)) ? 2 : 4;
  static constexpr int TBR = THREADS / TBC;
  static constexpr int MB = RR / TBR;
  static constexpr int CK = DKB / (CW * TBC), CV = DVB / (CW * TBC);
  static constexpr int STAGE = RS * (LK + LV);   // floats of a stage's two tiles
  static constexpr int RES = RR * (LK + LV);     // floats of the resident two
  // the score tiles: P (P^T) and dS (dS^T), each DSPLIT partial sums
  static constexpr int SCORES = 2 * DSPLIT * RR * LP;
  // dK/dV: K, V; the stages of Q, dO; the scores; each stage's lse2, Delta
  static constexpr size_t dkdv_bytes(int stages) {
    return 4 * (RES + stages * STAGE + SCORES + stages * 2 * RS);
  }
  // dQ: Q, dO; the stages of K, V; the scores; lse2, Delta
  static constexpr size_t dq_bytes(int stages) {
    return 4 * (RES + stages * STAGE + SCORES + 2 * RR);
  }
  // three stages (two tiles in flight) where both kernels fit them, else two
  static constexpr int STAGES = dkdv_bytes(3) <= 232448 && dq_bytes(3) <= 232448 ? 3 : 2;
  static constexpr size_t DKDV_BYTES = dkdv_bytes(STAGES), DQ_BYTES = dq_bytes(STAGES);
  static_assert(RR % TAR == 0 && RS % NA == 0 && RR % TBR == 0, "tile rows");
  static_assert(DKB % (CW * TBC) == 0 && DVB % (CW * TBC) == 0, "tile columns");
  static_assert(DKDV_BYTES <= 232448 && DQ_BYTES <= 232448, "shared memory");
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;       // (B, H, S), natural log, from the forward
  float* dq;
  float* dk;
  float* dv;
  float* delta;           // scratch: rowsum(dO * O), (B, H, s_pad)
  float* lse2;            // scratch: lse * log2(e), (B, H, s_pad)
  float* part;            // (shares, B, Sk, KV, dk + dv) fp32 partials, shares > 1
  int B, S, Sk, H, KV;
  int dk_dim, dv_dim;     // the real head dims
  int causal, window;
  int shares;             // head shares a kv tile's q heads are split into
  int s_pad;              // the scratch's rows a (batch, head)
  float scale;            // 1 / sqrt(dk)
  float scale_log2;       // log2(e) / sqrt(dk): scores in base 2
};

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  bool ok = kpos < p.Sk && qpos < p.S;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window) ok = ok && kpos > qpos - p.window;
  return ok;
}

// kv rows [lo, hi) that some q row of [q0, q0 + rows) sees
__device__ __forceinline__ void kv_range(const Params& p, int q0, int rows, int& lo, int& hi) {
  hi = p.causal ? min(p.Sk, q0 + rows) : p.Sk;
  lo = p.window ? max(0, q0 - p.window + 1) : 0;
}

// q rows [lo, hi) that see some kv row of [k0, k0 + rows)
__device__ __forceinline__ void q_range(const Params& p, int k0, int rows, int& lo, int& hi) {
  lo = p.causal ? k0 : 0;
  hi = p.window ? min(p.S, k0 + rows - 1 + p.window) : p.S;
}

// c[i][j] = sum over d < d4 of A[ar + TAR i][d] * B[ac + TAC j][d]: a
// score micro-tile, A and B rows of stride L
template <class T, int L>
__device__ __forceinline__ void dot_tile(float (&c)[T::MA][T::NA], const float* sA,
                                         const float* sB, int ar, int ac, int d4) {
#pragma unroll
  for (int i = 0; i < T::MA; ++i)
#pragma unroll
    for (int j = 0; j < T::NA; ++j) c[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < d4; d += 4) {
    float4 a[T::MA], b[T::NA];
#pragma unroll
    for (int i = 0; i < T::MA; ++i)
      a[i] = *reinterpret_cast<const float4*>(sA + (ar + T::TAR * i) * L + d);
#pragma unroll
    for (int j = 0; j < T::NA; ++j)
      b[j] = *reinterpret_cast<const float4*>(sB + (ac + T::TAC * j) * L + d);
#pragma unroll
    for (int i = 0; i < T::MA; ++i)
#pragma unroll
      for (int j = 0; j < T::NA; ++j) {
        c[i][j] = fmaf(a[i].x, b[j].x, c[i][j]);
        c[i][j] = fmaf(a[i].y, b[j].y, c[i][j]);
        c[i][j] = fmaf(a[i].z, b[j].z, c[i][j]);
        c[i][j] = fmaf(a[i].w, b[j].w, c[i][j]);
      }
  }
}

// whether every pair of q rows [q_lo, q_lo + qn) and kv rows [k_lo, k_lo +
// kn) is visible: then a tile needs no mask
__device__ __forceinline__ bool tile_full(const Params& p, int q_lo, int qn, int k_lo, int kn) {
  bool ok = q_lo + qn <= p.S && k_lo + kn <= p.Sk;
  if (p.causal) ok = ok && k_lo + kn - 1 <= q_lo;
  if (p.window) ok = ok && k_lo > q_lo + qn - 1 - p.window;
  return ok;
}

// The score group of this thread: S (S^T) or dP (dP^T) over its share of
// the head dim, its partial micro-tile stored to its own RR x LP tile
// (sScores + (product * DSPLIT + share) * RR * LP; product 0 S, 1 dP)
template <class T>
__device__ __forceinline__ void score_partials(float* sScores, const float* sAk,
                                               const float* sBk, const float* sAv,
                                               const float* sBv, int dk4, int dv4) {
  const int g = threadIdx.x / T::GROUP, t = threadIdx.x % T::GROUP;
  const int ar = t / T::TAC, ac = t % T::TAC;
  const int product = g / T::DSPLIT, share = g % T::DSPLIT;
  const int d4 = product ? dv4 : dk4;
  // the share's columns: [lo, hi), cut at a multiple of 4
  const int cut = T::DSPLIT == 1 ? d4 : ((d4 / 2 + 3) & ~3);
  const int lo = share ? cut : 0, hi = share ? d4 : cut;
  float c[T::MA][T::NA];
  if (product == 0)
    dot_tile<T, T::LK>(c, sAk + lo, sBk + lo, ar, ac, hi - lo);
  else
    dot_tile<T, T::LV>(c, sAv + lo, sBv + lo, ar, ac, hi - lo);
  float* dst = sScores + g * T::RR * T::LP;
#pragma unroll
  for (int i = 0; i < T::MA; ++i)
#pragma unroll
    for (int j = 0; j < T::NA; ++j) dst[(ar + T::TAR * i) * T::LP + ac + T::TAC * j] = c[i][j];
}

// P = exp2(S scale_log2 - lse2) where visible (else 0) and dS = P (dP -
// Delta), from the score partials (added in share order), into the first
// S tile (P) and the first dP tile (dS): a float4 a thread at a time.
// ROWS_ARE_Q: the tile's rows are q rows (dQ: lse2 and Delta by row),
// else its columns (dK/dV); r0 and c0 the first row's and column's positions
template <class T, bool ROWS_ARE_Q>
__device__ __forceinline__ void scores_to_ds(const Params& p, float* sScores, const float* lse2,
                                             const float* delta, int r0, int c0, bool full) {
  constexpr int Q4 = T::RS / 4, TILE = T::RR * T::LP;
  float* sP = sScores;
  float* sdS = sScores + T::DSPLIT * TILE;
  for (int e = threadIdx.x; e < T::RR * Q4; e += THREADS) {
    const int r = e / Q4, c = 4 * (e - r * Q4), at = r * T::LP + c;
    float4 sc = *reinterpret_cast<const float4*>(sP + at);
    float4 dp = *reinterpret_cast<const float4*>(sdS + at);
    if (T::DSPLIT == 2) {
      const float4 s1 = *reinterpret_cast<const float4*>(sP + TILE + at);
      const float4 d1 = *reinterpret_cast<const float4*>(sdS + TILE + at);
      sc.x += s1.x, sc.y += s1.y, sc.z += s1.z, sc.w += s1.w;
      dp.x += d1.x, dp.y += d1.y, dp.z += d1.z, dp.w += d1.w;
    }
    float s4[4] = {sc.x, sc.y, sc.z, sc.w}, d4[4] = {dp.x, dp.y, dp.z, dp.w};
    float l4[4], dl4[4];
    if (ROWS_ARE_Q) {
#pragma unroll
      for (int w = 0; w < 4; ++w) l4[w] = lse2[r], dl4[w] = delta[r];
    } else {
      const float4 l = *reinterpret_cast<const float4*>(lse2 + c);
      const float4 dl = *reinterpret_cast<const float4*>(delta + c);
      l4[0] = l.x, l4[1] = l.y, l4[2] = l.z, l4[3] = l.w;
      dl4[0] = dl.x, dl4[1] = dl.y, dl4[2] = dl.z, dl4[3] = dl.w;
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const bool vis = full || (ROWS_ARE_Q ? visible(p, r0 + r, c0 + c + w)
                                           : visible(p, c0 + c + w, r0 + r));
      s4[w] = vis ? hopper::ex2(fmaf(s4[w], p.scale_log2, -l4[w])) : 0.f;
      d4[w] = s4[w] * (d4[w] - dl4[w]);
    }
    *reinterpret_cast<float4*>(sP + at) = make_float4(s4[0], s4[1], s4[2], s4[3]);
    *reinterpret_cast<float4*>(sdS + at) = make_float4(d4[0], d4[1], d4[2], d4[3]);
  }
}

// acc[i][CW j + e] += sum over x < RS of A[br + TBR i][x] * B[x][CW (bc + TBC j) + e]:
// an output tile, A (P^T, dS^T or dS) rows of stride LP, B (the staged
// rows) of stride LB
template <class T, int C, int LB>
__device__ __forceinline__ void outer_tile(float (&acc)[T::MB][T::CW * C], const float* sA,
                                           const float* sB, int br, int bc) {
  constexpr int CW = T::CW;
#pragma unroll 2
  for (int x = 0; x < T::RS; x += 4) {
    float4 a[T::MB];
#pragma unroll
    for (int i = 0; i < T::MB; ++i)
      a[i] = *reinterpret_cast<const float4*>(sA + (br + T::TBR * i) * T::LP + x);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float* bp = sB + (x + e) * LB + CW * (bc + T::TBC * j);
        float b[CW];
        if constexpr (CW == 4) {
          const float4 v = *reinterpret_cast<const float4*>(bp);
          b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
        } else {
          const float2 v = *reinterpret_cast<const float2*>(bp);
          b[0] = v.x, b[1] = v.y;
        }
#pragma unroll
        for (int i = 0; i < T::MB; ++i) {
          const float ai = at(a[i], e);
#pragma unroll
          for (int w = 0; w < CW; ++w) acc[i][CW * j + w] = fmaf(ai, b[w], acc[i][CW * j + w]);
        }
      }
  }
}

// row `row`'s columns CW (bc + TBC j) .. + CW - 1 below `dim` of an output
// tile, times `scale`, to dst (the row's first column)
template <class T, int C>
__device__ __forceinline__ void store_row(float* dst, const float (&acc)[T::CW * C], int bc,
                                          int dim, float scale) {
  constexpr int CW = T::CW;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int col = CW * (bc + T::TBC * j);
    if (col >= dim) continue;
    if (col + CW <= dim && (dim & (CW - 1)) == 0) {   // aligned: one vector store
      if constexpr (CW == 4)
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(acc[4 * j] * scale, acc[4 * j + 1] * scale, acc[4 * j + 2] * scale,
                        acc[4 * j + 3] * scale);
      else
        *reinterpret_cast<float2*>(dst + col) =
            make_float2(acc[2 * j] * scale, acc[2 * j + 1] * scale);
    } else {
#pragma unroll
      for (int w = 0; w < CW; ++w)
        if (col + w < dim) dst[col + w] = acc[CW * j + w] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: RR q rows of one head
// ---------------------------------------------------------------------------
template <int DKB, int DVB>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_tiled(Params p) {
  using T = Tiles<DKB, DVB>;
  constexpr int RR = T::RR, RS = T::RS, LK = T::LK, LV = T::LV, LP = T::LP;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                       // RR x LK
  float* sdO = sQ + RR * LK;              // RR x LV
  float* sStage = sdO + RR * LV;          // two stages: K (RS x LK), V (RS x LV)
  float* sScores = sStage + T::STAGES * T::STAGE;   // S, then P; dP, then dS (DSPLIT each)
  const float* sdS = sScores + T::DSPLIT * RR * LP;
  float* sLse = sScores + T::SCORES;      // RR
  float* sDelta = sLse + RR;              // RR

  const int tid = threadIdx.x;
  const int dk = p.dk_dim, dv = p.dv_dim;
  const int units = p.B * p.H;
  const int n_qt = (p.S + RR - 1) / RR;
  const int rank = blockIdx.x / units, bh = blockIdx.x % units;
  // causal: the first blocks take the last q tiles, which have the most kv tiles
  const int qt = p.causal ? n_qt - 1 - rank : rank;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * RR;
  int lo, hi;
  kv_range(p, q0, RR, lo, hi);
  const int t_lo = lo / RS;
  const int n = hi > lo ? (hi + RS - 1) / RS - t_lo : 0;   // kv tiles with a visible key
  const size_t q_off = ((size_t)b * p.S * p.H + h) * dk, o_off = ((size_t)b * p.S * p.H + h) * dv;
  const float* kb = p.k + ((size_t)b * p.Sk * p.KV + kvh) * dk;
  const float* vb = p.v + ((size_t)b * p.Sk * p.KV + kvh) * dv;
  const size_t k_stride = (size_t)p.KV * dk, v_stride = (size_t)p.KV * dv;

  auto load_kv = [&](int j) {   // kv tile t_lo + j into stage j % STAGES
    float* st = sStage + (j % T::STAGES) * T::STAGE;
    const int k0 = (t_lo + j) * RS;
    load_tile<RS, LK>(st, kb, k_stride, k0, p.Sk, dk);
    load_tile<RS, LV>(st + RS * LK, vb, v_stride, k0, p.Sk, dv);
  };
  if (n > 0) {
    load_tile<RR, LK>(sQ, p.q + q_off, (size_t)p.H * dk, q0, p.S, dk);
    load_tile<RR, LV>(sdO, p.dout + o_off, (size_t)p.H * dv, q0, p.S, dv);
    for (int j = 0; j < T::STAGES - 1 && j < n; ++j) {
      load_kv(j);
      cp_commit();
    }
  }

  // Delta = rowsum(dO * O) and lse in base 2 of the block's rows, THREADS /
  // RR adjacent threads a row, kept and stored (rows below S) for dK/dV
  {
    constexpr int TPR = THREADS / RR;
    const int r = tid / TPR, part = tid % TPR, row = q0 + r;
    float acc = 0.f, l2 = 0.f;
    if (row < p.S) {
      const float* orow = p.o + o_off + (size_t)row * p.H * dv;
      const float* drow = p.dout + o_off + (size_t)row * p.H * dv;
      if ((dv & 3) == 0) {
        for (int c = 4 * part; c < dv; c += 4 * TPR) {
          const float4 x = *reinterpret_cast<const float4*>(orow + c);
          const float4 y = *reinterpret_cast<const float4*>(drow + c);
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
          acc = fmaf(x.z, y.z, acc);
          acc = fmaf(x.w, y.w, acc);
        }
      } else {
        for (int c = part; c < dv; c += TPR) acc = fmaf(orow[c], drow[c], acc);
      }
      l2 = p.lse[((size_t)b * p.H + h) * p.S + row] * LOG2E;
    }
#pragma unroll
    for (int m = 1; m < TPR; m <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (part == 0) {
      sDelta[r] = acc;
      sLse[r] = l2;
      if (row < p.S) {
        const size_t at_row = ((size_t)b * p.H + h) * p.s_pad + row;
        p.delta[at_row] = acc;
        p.lse2[at_row] = l2;
      }
    }
  }

  const int br = tid % T::TBR, bc = tid / T::TBR;
  const int dk4 = (dk + 3) & ~3, dv4 = (dv + 3) & ~3;
  float acc[T::MB][T::CW * T::CK];
#pragma unroll
  for (int i = 0; i < T::MB; ++i)
#pragma unroll
    for (int c = 0; c < T::CW * T::CK; ++c) acc[i][c] = 0.f;

  for (int j = 0; j < n; ++j) {
    cp_wait_tile<T::STAGES>(j, n);
    __syncthreads();   // tile j landed; every thread is done with tile j - 1
    if (j + T::STAGES - 1 < n) {   // into the stage tile j - 1 left
      load_kv(j + T::STAGES - 1);
      cp_commit();
    }
    const float* sK = sStage + (j % T::STAGES) * T::STAGE;
    const float* sV = sK + RS * LK;
    const int k0 = (t_lo + j) * RS;
    score_partials<T>(sScores, sQ, sK, sdO, sV, dk4, dv4);   // S = Q K^T, dP = dO V^T
    __syncthreads();
    scores_to_ds<T, true>(p, sScores, sLse, sDelta, q0, k0, tile_full(p, q0, RR, k0, RS));
    __syncthreads();
    outer_tile<T, T::CK, LK>(acc, sdS, sK, br, bc);   // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < T::MB; ++i) {
    const int row = q0 + br + T::TBR * i;
    if (row < p.S) store_row<T, T::CK>(p.dq + q_off + (size_t)row * p.H * dk, acc[i], bc, dk,
                                       p.scale);
  }
}

// ---------------------------------------------------------------------------
// dK and dV: RR kv rows of one kv head, over one head share of its q heads
// ---------------------------------------------------------------------------
template <int DKB, int DVB>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv_tiled(Params p) {
  using T = Tiles<DKB, DVB>;
  constexpr int RR = T::RR, RS = T::RS, LK = T::LK, LV = T::LV, LP = T::LP;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                       // RR x LK
  float* sV = sK + RR * LK;               // RR x LV
  float* sStage = sV + RR * LV;           // two stages: Q (RS x LK), dO (RS x LV)
  float* sScores = sStage + T::STAGES * T::STAGE;   // S^T, then P^T; dP^T, then dS^T
  const float* sP = sScores;
  const float* sdS = sScores + T::DSPLIT * RR * LP;
  float* sVec = sScores + T::SCORES;      // a stage's lse2 (RS), Delta (RS)

  const int tid = threadIdx.x;
  const int dk = p.dk_dim, dv = p.dv_dim;
  const int units = p.B * p.KV * p.shares;
  // kv tile outermost: under the causal mask the first ones see the most q rows
  const int kt = blockIdx.x / units, rem = blockIdx.x % units;
  const int share = rem % p.shares, bk = rem / p.shares;
  const int b = bk / p.KV, kvh = bk % p.KV;
  const int group = p.H / p.KV;
  const int h0 = kvh * group + share * group / p.shares;
  const int h1 = kvh * group + (share + 1) * group / p.shares;
  const int k0 = kt * RR;
  int lo, hi;
  q_range(p, k0, RR, lo, hi);
  const int t_lo = lo / RS;
  const int nqt = hi > lo ? (hi + RS - 1) / RS - t_lo : 0;   // q tiles with a visible row
  const int items = (h1 - h0) * nqt;
  const size_t q_stride = (size_t)p.H * dk, o_stride = (size_t)p.H * dv;
  const size_t k_off = ((size_t)b * p.Sk * p.KV + kvh) * dk;
  const size_t v_off = ((size_t)b * p.Sk * p.KV + kvh) * dv;

  auto load_item = [&](int it) {   // head h0 + it / nqt, q tile t_lo + it % nqt
    const int h = h0 + it / nqt, q0 = (t_lo + it % nqt) * RS;
    float* st = sStage + (it % T::STAGES) * T::STAGE;
    load_tile<RS, LK>(st, p.q + ((size_t)b * p.S * p.H + h) * dk, q_stride, q0, p.S, dk);
    load_tile<RS, LV>(st + RS * LK, p.dout + ((size_t)b * p.S * p.H + h) * dv, o_stride, q0,
                      p.S, dv);
    const size_t row = ((size_t)b * p.H + h) * p.s_pad + q0;
    float* vec = sVec + (it % T::STAGES) * 2 * RS;
    for (int i = tid; i < 2 * RS; i += THREADS) {
      const int r = i % RS;
      const bool ok = q0 + r < p.S;
      cp_async4(vec + i, (i < RS ? p.lse2 : p.delta) + row + (ok ? r : 0), ok);
    }
  };
  if (items > 0) {
    load_tile<RR, LK>(sK, p.k + k_off, (size_t)p.KV * dk, k0, p.Sk, dk);
    load_tile<RR, LV>(sV, p.v + v_off, (size_t)p.KV * dv, k0, p.Sk, dv);
    for (int it = 0; it < T::STAGES - 1 && it < items; ++it) {
      load_item(it);
      cp_commit();
    }
  }

  const int br = tid % T::TBR, bc = tid / T::TBR;
  const int dk4 = (dk + 3) & ~3, dv4 = (dv + 3) & ~3;
  float acc_k[T::MB][T::CW * T::CK], acc_v[T::MB][T::CW * T::CV];
#pragma unroll
  for (int i = 0; i < T::MB; ++i) {
#pragma unroll
    for (int c = 0; c < T::CW * T::CK; ++c) acc_k[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < T::CW * T::CV; ++c) acc_v[i][c] = 0.f;
  }

  for (int it = 0; it < items; ++it) {
    cp_wait_tile<T::STAGES>(it, items);
    __syncthreads();   // item it landed; every thread is done with item it - 1
    if (it + T::STAGES - 1 < items) {   // into the stage item it - 1 left
      load_item(it + T::STAGES - 1);
      cp_commit();
    }
    const float* sQ = sStage + (it % T::STAGES) * T::STAGE;
    const float* sdO = sQ + RS * LK;
    const float* vec = sVec + (it % T::STAGES) * 2 * RS;
    const int q0 = (t_lo + it % nqt) * RS;
    score_partials<T>(sScores, sK, sQ, sV, sdO, dk4, dv4);   // S^T = K Q^T, dP^T = V dO^T
    __syncthreads();
    scores_to_ds<T, false>(p, sScores, vec, vec + RS, k0, q0, tile_full(p, q0, RS, k0, RR));
    __syncthreads();
    outer_tile<T, T::CV, LV>(acc_v, sP, sdO, br, bc);    // dV += P^T dO
    outer_tile<T, T::CK, LK>(acc_k, sdS, sQ, br, bc);    // dK += dS^T Q
  }

  const int w = dk + dv;
#pragma unroll
  for (int i = 0; i < T::MB; ++i) {
    const int row = k0 + br + T::TBR * i;
    if (row >= p.Sk) continue;
    if (p.shares == 1) {
      store_row<T, T::CK>(p.dk + k_off + (size_t)row * p.KV * dk, acc_k[i], bc, dk, p.scale);
      store_row<T, T::CV>(p.dv + v_off + (size_t)row * p.KV * dv, acc_v[i], bc, dv, 1.f);
    } else {   // this share's partial sums, unscaled: (share, b, row, kvh, dk + dv)
      float* dst = p.part + ((((size_t)share * p.B + b) * p.Sk + row) * p.KV + kvh) * w;
#pragma unroll
      for (int j = 0; j < T::CK; ++j)
#pragma unroll
        for (int e = 0; e < T::CW; ++e) {
          const int col = T::CW * (bc + T::TBC * j) + e;
          if (col < dk) dst[col] = acc_k[i][T::CW * j + e];
        }
#pragma unroll
      for (int j = 0; j < T::CV; ++j)
#pragma unroll
        for (int e = 0; e < T::CW; ++e) {
          const int col = T::CW * (bc + T::TBC * j) + e;
          if (col < dv) dst[dk + col] = acc_v[i][T::CW * j + e];
        }
    }
  }
}

// the head shares' partial dK and dV added in share order; dK scaled once
__global__ void __launch_bounds__(THREADS) flash_bwd_sum_tiled(Params p) {
  const int w = p.dk_dim + p.dv_dim;
  const size_t total = (size_t)p.B * p.Sk * p.KV * w;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * THREADS) {
    float acc = p.part[i];
    for (int j = 1; j < p.shares; ++j) acc += p.part[(size_t)j * total + i];
    const size_t row = i / w;
    const int col = (int)(i - row * w);
    if (col < p.dk_dim)
      p.dk[row * p.dk_dim + col] = acc * p.scale;
    else
      p.dv[row * p.dv_dim + col - p.dk_dim] = acc;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <int DKB, int DVB>
int launch(const Params& p, cudaStream_t stream) {
  using T = Tiles<DKB, DVB>;
  static uint32_t opted_dq = 0, opted_dkdv = 0;   // a bit per device
  int err = hopper::opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dq_tiled<DKB, DVB>),
                                T::DQ_BYTES, opted_dq);
  if (!err)
    err = hopper::opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dkdv_tiled<DKB, DVB>),
                              T::DKDV_BYTES, opted_dkdv);
  if (err) return err;
  const long long dq_blocks = (long long)p.B * p.H * ((p.S + T::RR - 1) / T::RR);
  const long long kv_blocks = (long long)p.B * p.KV * p.shares * ((p.Sk + T::RR - 1) / T::RR);
  if (dq_blocks > 0x7fffffff || kv_blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_bwd_dq_tiled<DKB, DVB><<<(unsigned)dq_blocks, THREADS, T::DQ_BYTES, stream>>>(p);
  err = (int)cudaGetLastError();
  if (err) return err;
  flash_bwd_dkdv_tiled<DKB, DVB><<<(unsigned)kv_blocks, THREADS, T::DKDV_BYTES, stream>>>(p);
  err = (int)cudaGetLastError();
  if (err || p.shares == 1) return err;
  const size_t total = (size_t)p.B * p.Sk * p.KV * (p.dk_dim + p.dv_dim);
  const size_t blocks = (total + THREADS - 1) / THREADS;
  flash_bwd_sum_tiled<<<(unsigned)(blocks < 8192 ? blocks : 8192), THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dq: (B, S, H, DK); o, dout: (B, S, H, DV); k, dk: (B, Sk, KV, DK);
// v, dv: (B, Sk, KV, DV); all contiguous fp32 (dtype code 0; any other is
// refused with cudaErrorInvalidValue), 1 <= DK, DV <= 256.  lse: (B, H, S)
// fp32 from the forward.  scratch: 2 * B * H * s_pad fp32, s_pad >= S
// (kernels/flash_attention.py:bwd_scratch_rows).  shares: the head shares
// of the dK/dV kernel, 1 <= shares <= H / KV; above 1, part holds shares *
// B * Sk * KV * (DK + DV) fp32 (kernels/flash_attention.py:
// bwd_head_shares at bwd_f32_tiles' rows).  The bucket is the first of
// BUCKETS that holds (DK, DV).  The kernels run in order on `stream`.
// Returns cudaGetLastError() after the launches.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const float* lse,
                                       void* dq, void* dk, void* dv, float* scratch, int B,
                                       int S, int Sk, int H, int KV, int DK, int DV, int causal,
                                       int window, int dtype, void* stream, float* part,
                                       int shares, int s_pad) {
  if (dtype != 0 || B < 1 || S < 1 || Sk < 1 || KV < 1 || H % KV || DK < 1 || DV < 1 ||
      DK > 256 || DV > 256 || s_pad < S || shares < 1 || shares > H / KV ||
      (shares > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)DK);
  const Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<const float*>(o),
                 static_cast<const float*>(dout), lse, static_cast<float*>(dq),
                 static_cast<float*>(dk), static_cast<float*>(dv), scratch,
                 scratch + (size_t)B * H * s_pad, part, B, S, Sk, H, KV, DK, DV, causal, window,
                 shares, s_pad, scale, LOG2E * scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int row = 0;
  while (row < 5 && (DK > BUCKETS[row][0] || DV > BUCKETS[row][1])) ++row;
  switch (row) {
    case 0: return launch<64, 64>(p, st);
    case 1: return launch<96, 96>(p, st);
    case 2: return launch<128, 128>(p, st);
    case 3: return launch<192, 128>(p, st);
    case 4: return launch<256, 256>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
