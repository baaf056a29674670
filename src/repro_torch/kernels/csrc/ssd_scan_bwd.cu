// Mamba-2 SSD chunked scan, backward, for Hopper (sm_90a), model layout.
//
// The gradient of the function csrc/ssd_scan.cu computes, which replaces
// src/repro/kernels/ssd_scan.py:ssd_scan_kernel.  The Pallas kernel is
// forward-only: the JAX package trains through autodiff of the jnp
// ssd_scan (src/repro/models/ssm.py), and this kernel computes that
// gradient with one B/C group (G = 1) and no initial state.
//
// Per (b, h), a tile of Q steps with in-tile cumulative sums cs of da =
// dt a, u_j = dt_j x_j and S the state entering the tile (P x N):
//
//   y_i   = sum_{j<=i} (C_i . B_j) e^{cs_i - cs_j} u_j + e^{cs_i} S C_i
//   S'    = e^{cs_last} S + sum_j e^{cs_last - cs_j} u_j B_j^T
//
// Given dy and dS' (the gradient of the state leaving the tile: the final
// state's for the last tile), with W_ij = (C_i . B_j) e^{cs_i - cs_j} and
// dY_ij = dy_i . u_j on j <= i:
//
//   du_j  = sum_i W_ij dy_i + e^{cs_last - cs_j} dS' B_j      dx = dt du
//   dC_i  = sum_j e^{cs_i - cs_j} dY_ij B_j + e^{cs_i} S^T dy_i
//   dB_j  = sum_i e^{cs_i - cs_j} dY_ij C_i + e^{cs_last - cs_j} dS'^T u_j
//   dS    = e^{cs_last} dS' + sum_i e^{cs_i} dy_i C_i^T           (carried back)
//   dcs_i = sum_j W_ij dY_ij - sum_k W_ki dY_ki + e^{cs_i} dy_i . S C_i
//           - e^{cs_last - cs_i} u_i . dS' B_i
//   dcs_last += sum_j e^{cs_last - cs_j} u_j . dS' B_j + e^{cs_last} <dS', S>
//   dda_k = sum_{i>=k} dcs_i   ddt = x . du + a dda   da = sum dt dda
//
// Masks are applied before each exp (only j <= i is exponentiated), as the
// forward does.  The function does not depend on the chunk the forward
// took, so this kernel keeps its own tile: Q 64 at mamba2's (P 64, N 128)
// (a 128-step tile's fp32 operands, B, C, x, dy, S and dS, would be
// 256 KB, over the 227 KB of an SM), Q 32 at the smoke config's (16, 16).
//
// What bounds it on the H100: at mamba2-780m's training shape (B 4, L
// 1024, H 48, P 64, N 128, bf16) the five gradients need 20.4 GFLOP at a
// 64-step tile (roofline/cost.py:ssd_bwd_bound: the intra-tile products
// on the causal pairs, the products against S and dS, the carried parts
// and the recomputed states), 0.021 ms at the bf16 tensor-core rate,
// against 80 MB moved (x, dt, B, C, dy read, dx, ddt, dB, dC written; the
// states and the per-head dB and dC shares are scratch), 0.024 ms at
// 3.35 TB/s: bytes, on paper.  This design does its arithmetic in fp32 on
// the CUDA cores, where the same work takes 0.31 ms at 67 TFLOP/s.
//
// What this first design does (a simple kernel that is right, one block of
// 256 threads per (b, h) walking the tiles):
//  * A first pass over the tiles recomputes the state entering each tile
//    (the forward's state update alone) into an fp32 scratch in device
//    memory, (B H, tiles, P, N); the second pass walks the tiles in
//    reverse with dS in shared memory.
//  * Every operand of a tile is staged in fp32 shared memory with odd row
//    strides (B, C, x, dy, S, dS, and the Q x Q tiles W and
//    e^{cs_i - cs_j} dY), ~210 KB at Q 64: one block an SM.  Each product
//    is a register tile of up to 4 x 8 outputs a thread over its depth.
//  * The cumulative sum is fp64 (one warp scan), exp(cs_i - cs_j) takes
//    the fp64 difference, as the forward's SIMT kernel does.
//  * Deterministic: no atomics.  dB and dC (the one group is broadcast to
//    every head) are written per head as fp32 partials (B, L, H, N), and
//    da per (b, h); the launcher sums them in one ordered torch sum.
//    Row and column sums of the tiles go through shared memory in a fixed
//    order; the per-step scalars are summed by one thread in fp64.
//  * bf16 inputs are read and converted to fp32, so both dtypes take the
//    same arithmetic; dx and ddt are written in the inputs' type.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int NT = 256;   // threads per block
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* x;        // (B, L, H, P), each (H, P) row contiguous
  const void* dt;       // (B, L, H), contiguous
  const void* a;        // (H,)
  const void* b;        // (B, L, N), each N row contiguous
  const void* c;        // (B, L, N), each N row contiguous
  const void* dy;       // (B, L, H, P), contiguous
  const void* dstate;   // (B, H, P, N), contiguous, or null: a zero gradient
  void* dx;             // (B, L, H, P), contiguous
  void* ddt;            // (B, L, H), contiguous
  float* da_part;       // (B, H): da's share of each (b, h)
  float* db_part;       // (B, L, H, N): dB's share of each head
  float* dc_part;       // (B, L, H, N): dC's share of each head
  float* states;        // (B H, tiles, P, N): the state entering each tile
  int L, H;
  long long xs_b, xs_l, bs_b, bs_l, cs_b, cs_l;   // batch and step strides, in elements
};

// a thread's part of an (M x NC) product: rows tr + TR r, columns tc + TC c
template <int M, int NC>
struct Map {
  static constexpr int TC = NC >= 16 ? 16 : NC;
  static constexpr int TR = NT / TC;
  static constexpr int RM = M / TR;
  static constexpr int RC = NC / TC;
  static_assert(RM * TR == M && RC * TC == NC, "the product splits evenly over the threads");
};

// acc[r][c] = sum_{k < K} A(m, k) Bm(k, n) at m = tr + TR r, n = tc + TC c,
// with A(m, k) = a[m am + k ak] and Bm(k, n) = b[k bk + n bn] in shared memory
template <int M, int NC, int K>
__device__ __forceinline__ void tile_mm(float (&acc)[Map<M, NC>::RM][Map<M, NC>::RC],
                                        const float* a, int am, int ak, const float* b, int bk,
                                        int bn) {
  using MP = Map<M, NC>;
  const int tr = threadIdx.x / MP::TC, tc = threadIdx.x % MP::TC;
#pragma unroll
  for (int r = 0; r < MP::RM; ++r)
#pragma unroll
    for (int c = 0; c < MP::RC; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[MP::RM], bv[MP::RC];
#pragma unroll
    for (int r = 0; r < MP::RM; ++r) av[r] = a[(tr + MP::TR * r) * am + k * ak];
#pragma unroll
    for (int c = 0; c < MP::RC; ++c) bv[c] = b[k * bk + (tc + MP::TC * c) * bn];
#pragma unroll
    for (int r = 0; r < MP::RM; ++r)
#pragma unroll
      for (int c = 0; c < MP::RC; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// Shared memory at tile Q: the fp64 cumsum, then fp32 B and C (Q x NS), x
// and dy (Q x PS), S and dS (P x NS), W and V (Q x QS), two (16 x Q)
// reduction buffers, eight per-step vectors, a block's partials and one
// scalar.  Odd strides keep a column's reads on distinct banks.
template <int Q, int P, int N>
struct Smem {
  static constexpr int NS = N + 1, PS = P + 1, QS = Q + 1;
  static constexpr size_t FLOATS = (size_t)2 * Q * NS + (size_t)2 * Q * PS +
                                   (size_t)2 * P * NS + (size_t)2 * Q * QS + 2 * 16 * Q +
                                   8 * Q + NT + 4;
  static constexpr size_t BYTES = sizeof(double) * Q + sizeof(float) * FLOATS;
  static_assert(BYTES <= 232448, "over the shared memory of an SM");
};

template <int Q, int P, int N, typename T, typename TA>
__global__ void __launch_bounds__(NT, 1) ssd_bwd(Params prm) {
  static_assert(Q % 32 == 0 && Q <= 128, "tiles of 32, 64 or 128 steps");
  static_assert(P % 16 == 0 && N % 16 == 0, "P and N must be multiples of 16");
  using SM = Smem<Q, P, N>;
  constexpr int NS = SM::NS, PS = SM::PS, QS = SM::QS;
  extern __shared__ __align__(16) unsigned char smem[];
  double* cum = reinterpret_cast<double*>(smem);   // (Q,) cumsum of da within the tile
  float* sB = reinterpret_cast<float*>(cum + Q);
  float* sC = sB + Q * NS;
  float* sX = sC + Q * NS;
  float* sDY = sX + Q * PS;
  float* sS = sDY + Q * PS;       // the state entering the tile
  float* sDS = sS + P * NS;       // the gradient of the state leaving it
  float* sW = sDS + P * NS;       // (C_i . B_j) e^{cs_i - cs_j}, j <= i
  float* sV = sW + Q * QS;        // e^{cs_i - cs_j} dY_ij, j <= i
  float* red0 = sV + Q * QS;      // (16, Q) partial sums
  float* red1 = red0 + 16 * Q;    // (16, Q) partial sums
  float* dts = red1 + 16 * Q;     // dt_j
  float* ein = dts + Q;           // e^{cs_i}
  float* wout = ein + Q;          // e^{cs_last - cs_j}
  float* rowq = wout + Q;         // sum_j W_ij dY_ij
  float* colq = rowq + Q;         // sum_i W_ij dY_ij
  float* xdu = colq + Q;          // x_j . du_j
  float* tdot = xdu + Q;          // e^{cs_last - cs_j} u_j . dS' B_j
  float* rdot = tdot + Q;         // e^{cs_i} dy_i . S C_i
  float* blk = rdot + Q;          // (NT,) the threads' shares of <dS', S>
  float* keep_s = blk + NT;       // e^{cs_last}

  const int L = prm.L, H = prm.H;
  const int bh = blockIdx.x, bi = bh / H, h = bh % H;
  const int t = threadIdx.x;
  const int ntiles = (L + Q - 1) / Q;
  // this (b, h)'s rows at step 0; step l is l strides further on
  const T* xg = static_cast<const T*>(prm.x) + bi * prm.xs_b + h * P;
  const T* dtg = static_cast<const T*>(prm.dt) + (size_t)bi * L * H + h;
  const T* bg = static_cast<const T*>(prm.b) + bi * prm.bs_b;
  const T* cg = static_cast<const T*>(prm.c) + bi * prm.cs_b;
  const T* dyg = static_cast<const T*>(prm.dy) + (size_t)bi * L * H * P + h * P;
  T* dxg = static_cast<T*>(prm.dx) + (size_t)bi * L * H * P + h * P;
  T* ddtg = static_cast<T*>(prm.ddt) + (size_t)bi * L * H + h;
  float* dbg = prm.db_part + ((size_t)bi * L * H + h) * N;
  float* dcg = prm.dc_part + ((size_t)bi * L * H + h) * N;
  float* stg = prm.states + (size_t)bh * ntiles * P * N;
  const long long xs_l = prm.xs_l, bs_l = prm.bs_l, cs_l = prm.cs_l;
  const float a = to_f(static_cast<const TA*>(prm.a)[h]);

  // the tile's B, x and dt (and C, dy) from step l0; zeros past L
  auto load_bx = [&](int l0) {
    for (int e = t; e < Q * N; e += NT) {
      const int i = e / N, n = e % N, l = l0 + i;
      sB[i * NS + n] = l < L ? to_f(bg[l * bs_l + n]) : 0.f;
    }
    for (int e = t; e < Q * P; e += NT) {
      const int i = e / P, pp = e % P, l = l0 + i;
      sX[i * PS + pp] = l < L ? to_f(xg[l * xs_l + pp]) : 0.f;
    }
    if (t < Q) dts[t] = l0 + t < L ? to_f(dtg[(size_t)(l0 + t) * H]) : 0.f;
  };
  auto load_cdy = [&](int l0) {
    for (int e = t; e < Q * N; e += NT) {
      const int i = e / N, n = e % N, l = l0 + i;
      sC[i * NS + n] = l < L ? to_f(cg[l * cs_l + n]) : 0.f;
    }
    for (int e = t; e < Q * P; e += NT) {
      const int i = e / P, pp = e % P, l = l0 + i;
      sDY[i * PS + pp] = l < L ? to_f(dyg[(size_t)l * H * P + pp]) : 0.f;
    }
  };
  // warp 0: cum = cumsum(dt a) over the tile in fp64; ein, wout, keep
  auto scan = [&]() {
    if (t < 32) {
      constexpr int PER = Q / 32;
      double v[PER];
      double run = 0.0;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        run += (double)(dts[t * PER + k] * a);
        v[k] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double o = __shfl_up_sync(FULL, incl, off);
        if (t >= off) incl += o;
      }
      const double total = __shfl_sync(FULL, incl, 31);
      const double excl = incl - run;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const double c_ = v[k] + excl;
        cum[t * PER + k] = c_;
        ein[t * PER + k] = expf((float)c_);
        wout[t * PER + k] = expf((float)(total - c_));
      }
      if (t == 0) *keep_s = expf((float)total);
    }
  };

  // -- pass 1: the state entering each tile, into the scratch ---------------
  for (int e = t; e < P * NS; e += NT) sS[e] = 0.f;
  __syncthreads();
  for (int tile = 0; tile < ntiles; ++tile) {
    const int l0 = tile * Q;
    for (int e = t; e < P * N; e += NT) stg[(size_t)tile * P * N + e] = sS[(e / N) * NS + e % N];
    if (tile + 1 == ntiles) break;
    load_bx(l0);
    __syncthreads();
    scan();
    __syncthreads();
    for (int e = t; e < Q * P; e += NT) {   // x_j e^{cs_last - cs_j} dt_j, in place
      const int j = e / P;
      sX[j * PS + e % P] *= wout[j] * dts[j];
    }
    __syncthreads();
    {   // S' = keep S + xw^T B: each thread rewrites the elements it reads
      using MP = Map<P, N>;
      float acc[MP::RM][MP::RC];
      tile_mm<P, N, Q>(acc, sX, 1, PS, sB, NS, 1);
      const float keep = *keep_s;
      const int tr = t / MP::TC, tc = t % MP::TC;
#pragma unroll
      for (int r = 0; r < MP::RM; ++r)
#pragma unroll
        for (int c = 0; c < MP::RC; ++c) {
          float& s = sS[(tr + MP::TR * r) * NS + tc + MP::TC * c];
          s = keep * s + acc[r][c];
        }
    }
    __syncthreads();
  }

  // -- pass 2: the tiles in reverse, dS carried back -------------------------
  const T* dsg = static_cast<const T*>(prm.dstate);
  for (int e = t; e < P * NS; e += NT) {
    const int pp = e / NS, n = e % NS;
    sDS[e] = dsg != nullptr && n < N ? to_f(dsg[((size_t)bh * P + pp) * N + n]) : 0.f;
  }
  double da_acc = 0.0;   // thread 0: sum_k dt_k dda_k
  for (int tile = ntiles - 1; tile >= 0; --tile) {
    const int l0 = tile * Q;
    load_bx(l0);
    load_cdy(l0);
    for (int e = t; e < P * N; e += NT) sS[(e / N) * NS + e % N] = stg[(size_t)tile * P * N + e];
    __syncthreads();
    scan();
    __syncthreads();

    // -- W = (C B^T) e^{cs_i - cs_j} on j <= i, masked before the exp ------
    {
      using MP = Map<Q, Q>;
      float acc[MP::RM][MP::RC];
      tile_mm<Q, Q, N>(acc, sC, NS, 1, sB, 1, NS);
      const int tr = t / MP::TC, tc = t % MP::TC;
#pragma unroll
      for (int r = 0; r < MP::RM; ++r)
#pragma unroll
        for (int c = 0; c < MP::RC; ++c) {
          const int i = tr + MP::TR * r, j = tc + MP::TC * c;
          sW[i * QS + j] = j <= i ? acc[r][c] * expf((float)(cum[i] - cum[j])) : 0.f;
        }
    }
    __syncthreads();

    // -- dY = dt_j (dy_i . x_j); V = e^{cs_i - cs_j} dY and W dY's row and
    //    column sums on j <= i ---------------------------------------------
    {
      using MP = Map<Q, Q>;
      float acc[MP::RM][MP::RC];
      tile_mm<Q, Q, P>(acc, sDY, PS, 1, sX, 1, PS);
      const int tr = t / MP::TC, tc = t % MP::TC;
      float rs[MP::RM], cs[MP::RC];
#pragma unroll
      for (int r = 0; r < MP::RM; ++r) rs[r] = 0.f;
#pragma unroll
      for (int c = 0; c < MP::RC; ++c) cs[c] = 0.f;
#pragma unroll
      for (int r = 0; r < MP::RM; ++r)
#pragma unroll
        for (int c = 0; c < MP::RC; ++c) {
          const int i = tr + MP::TR * r, j = tc + MP::TC * c;
          float v = 0.f, qv = 0.f;
          if (j <= i) {
            const float dyv = dts[j] * acc[r][c];
            v = dyv * expf((float)(cum[i] - cum[j]));
            qv = sW[i * QS + j] * dyv;
          }
          sV[i * QS + j] = v;
          rs[r] += qv;
          cs[c] += qv;
        }
#pragma unroll
      for (int r = 0; r < MP::RM; ++r) red0[tc * Q + tr + MP::TR * r] = rs[r];
#pragma unroll
      for (int c = 0; c < MP::RC; ++c) red1[tr * Q + tc + MP::TC * c] = cs[c];
    }
    __syncthreads();
    if (t < Q) {
      float r = 0.f, c = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        r += red0[k * Q + t];
        c += red1[k * Q + t];
      }
      rowq[t] = r;
      colq[t] = c;
    }
    __syncthreads();

    // -- du = W^T dy + e^{cs_last - cs_j} dS' B_j; dx = dt du; x . du and
    //    x . dS' B per step --------------------------------------------------
    {
      using MP = Map<Q, P>;
      float acc1[MP::RM][MP::RC], acc2[MP::RM][MP::RC];
      tile_mm<Q, P, Q>(acc1, sW, 1, QS, sDY, PS, 1);
      tile_mm<Q, P, N>(acc2, sB, NS, 1, sDS, 1, NS);
      const int tr = t / MP::TC, tc = t % MP::TC;
#pragma unroll
      for (int r = 0; r < MP::RM; ++r) {
        const int j = tr + MP::TR * r, l = l0 + j;
        float px = 0.f, pt = 0.f;
#pragma unroll
        for (int c = 0; c < MP::RC; ++c) {
          const int pp = tc + MP::TC * c;
          const float du = acc1[r][c] + wout[j] * acc2[r][c];
          const float xv = sX[j * PS + pp];
          px += xv * du;
          pt += xv * acc2[r][c];
          if (l < L) store_f(dxg + (size_t)l * H * P + pp, dts[j] * du);
        }
        red0[tc * Q + j] = px;
        red1[tc * Q + j] = pt;
      }
    }
    __syncthreads();
    if (t < Q) {
      float px = 0.f, pt = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        px += red0[k * Q + t];
        pt += red1[k * Q + t];
      }
      xdu[t] = px;
      tdot[t] = wout[t] * dts[t] * pt;
    }
    __syncthreads();

    // -- dC = V B + e^{cs_i} dy S, and C . (e^{cs_i} dy S) per step; then
    //    dB = V^T C + e^{cs_last - cs_j} dt_j x dS' ------------------------
    {
      using MP = Map<Q, N>;
      float acc1[MP::RM][MP::RC], acc2[MP::RM][MP::RC];
      const int tr = t / MP::TC, tc = t % MP::TC;
      tile_mm<Q, N, Q>(acc1, sV, QS, 1, sB, NS, 1);
      tile_mm<Q, N, P>(acc2, sDY, PS, 1, sS, NS, 1);
#pragma unroll
      for (int r = 0; r < MP::RM; ++r) {
        const int i = tr + MP::TR * r, l = l0 + i;
        float pr = 0.f;
#pragma unroll
        for (int c = 0; c < MP::RC; ++c) {
          const int n = tc + MP::TC * c;
          const float carried = ein[i] * acc2[r][c];
          pr += sC[i * NS + n] * carried;
          if (l < L) dcg[(size_t)l * H * N + n] = acc1[r][c] + carried;
        }
        red0[tc * Q + i] = pr;
      }
      tile_mm<Q, N, Q>(acc1, sV, 1, QS, sC, NS, 1);
      tile_mm<Q, N, P>(acc2, sX, PS, 1, sDS, NS, 1);
#pragma unroll
      for (int r = 0; r < MP::RM; ++r) {
        const int j = tr + MP::TR * r, l = l0 + j;
        const float w = wout[j] * dts[j];
        if (l < L)
#pragma unroll
          for (int c = 0; c < MP::RC; ++c)
            dbg[(size_t)l * H * N + tc + MP::TC * c] = acc1[r][c] + w * acc2[r][c];
      }
    }
    __syncthreads();
    if (t < Q) {
      float pr = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) pr += red0[k * Q + t];
      rdot[t] = pr;
    }
    for (int e = t; e < Q * N; e += NT) sC[(e / N) * NS + e % N] *= ein[e / N];   // e^{cs_i} C_i
    __syncthreads();

    // -- <dS', S>; dS = e^{cs_last} dS' + dy^T (e^{cs} C): each thread
    //    rewrites the elements of dS' it reads -------------------------------
    {
      using MP = Map<P, N>;
      float acc[MP::RM][MP::RC];
      tile_mm<P, N, Q>(acc, sDY, 1, PS, sC, NS, 1);
      const float keep = *keep_s;
      const int tr = t / MP::TC, tc = t % MP::TC;
      float part = 0.f;
#pragma unroll
      for (int r = 0; r < MP::RM; ++r)
#pragma unroll
        for (int c = 0; c < MP::RC; ++c) {
          const int at = (tr + MP::TR * r) * NS + tc + MP::TC * c;
          const float d = sDS[at];
          part += d * sS[at];
          sDS[at] = keep * d + acc[r][c];
        }
      blk[t] = part;
    }
    __syncthreads();

    // -- thread 0: dcs per step, dda = its reverse cumsum, ddt and da ------
    if (t == 0) {
      double sdot = 0.0, tsum = 0.0, run = 0.0;
      for (int k = 0; k < NT; ++k) sdot += blk[k];
      for (int j = 0; j < Q; ++j) tsum += tdot[j];
      for (int k = Q - 1; k >= 0; --k) {
        double dcs = (double)rowq[k] - colq[k] + rdot[k] - tdot[k];
        if (k == Q - 1) dcs += tsum + (double)*keep_s * sdot;
        run += dcs;   // dda_k = sum_{i >= k} dcs_i
        if (l0 + k < L) store_f(ddtg + (size_t)(l0 + k) * H, (float)(xdu[k] + a * run));
        da_acc += (double)dts[k] * run;
      }
    }
    __syncthreads();   // before the next tile restages
  }
  if (t == 0) prm.da_part[bh] = (float)da_acc;
}

template <int Q, int P, int N, typename T, typename TA>
int launch(const Params& p, int blocks, cudaStream_t stream) {
  constexpr size_t smem = Smem<Q, P, N>::BYTES;
  static uint32_t opted = 0;   // a bit per device
  const int err = opt_in_smem(reinterpret_cast<const void*>(ssd_bwd<Q, P, N, T, TA>), smem,
                              opted);
  if (err) return err;
  ssd_bwd<Q, P, N, T, TA><<<blocks, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int Q, int P, int N>
int by_dtype(const Params& p, int blocks, int is_bf16, int a_is_bf16, cudaStream_t stream) {
  if (!is_bf16) {
    if (a_is_bf16) return (int)cudaErrorInvalidValue;
    return launch<Q, P, N, float, float>(p, blocks, stream);
  }
  if (a_is_bf16) return launch<Q, P, N, __nv_bfloat16, __nv_bfloat16>(p, blocks, stream);
  return launch<Q, P, N, __nv_bfloat16, float>(p, blocks, stream);
}

}  // namespace

// x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, N), as the forward
// took them (x, b and c through their batch and step strides, in
// elements); dy, dx: (B, L, H, P) contiguous; dstate: (B, H, P, N)
// contiguous or null; ddt: (B, L, H) contiguous.  x, dt, b, c, dy, dstate,
// dx, ddt are of one type (bf16 if is_bf16 else fp32), a bf16 if a_is_bf16
// else fp32.  The fp32 outputs da_part (B, H), db_part and dc_part (B, L,
// H, N) are each head's shares, which the caller sums; states is scratch
// of B H tiles P N fp32.  (P, N, tile) is (64, 128, 64) or (16, 16, 32).
// Returns cudaGetLastError() after the launch.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* a, const void* b,
                            const void* c, const void* dy, const void* dstate, void* dx,
                            void* ddt, float* da_part, float* db_part, float* dc_part,
                            float* states, int B, int L, int H, int p_dim, int n_dim, int tile,
                            int is_bf16, int a_is_bf16, long long xs_b, long long xs_l,
                            long long bs_b, long long bs_l, long long cs_b, long long cs_l,
                            void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  Params p{x, dt, a, b, c, dy, dstate, dx, ddt, da_part, db_part, dc_part, states, L, H,
           xs_b, xs_l, bs_b, bs_l, cs_b, cs_l};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = B * H;
  if (p_dim == 64 && n_dim == 128 && tile == 64)
    return by_dtype<64, 64, 128>(p, blocks, is_bf16, a_is_bf16, st);
  if (p_dim == 16 && n_dim == 16 && tile == 32)
    return by_dtype<32, 16, 16>(p, blocks, is_bf16, a_is_bf16, st);
  return (int)cudaErrorInvalidValue;
}
