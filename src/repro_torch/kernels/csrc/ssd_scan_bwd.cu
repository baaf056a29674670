// Mamba-2 SSD chunked scan, backward, for Hopper (sm_90a), model layout.
//
// The gradient of the function csrc/ssd_scan.cu computes, which replaces
// src/repro/kernels/ssd_scan.py:ssd_scan_kernel.  The Pallas kernel is
// forward-only: the JAX package trains through autodiff of the jnp
// ssd_scan (src/repro/models/ssm.py), and these kernels compute that
// gradient at any B/C group count G dividing H (head h reads group h /
// (H / G); dB and dC sum over a group's heads) and from an optional
// initial state S_0, whose gradient is dS carried back past the first
// chunk:  dS_0 = e^{cs_last} dS' + sum_i e^{cs_i} dy_i C_i^T over chunk 0.
// A call with G > 1 or an S_0 runs the kernels' X instantiations, which
// take both through an argument of their own (hopper.cuh: SsdExt); G = 1
// with no S_0 runs instantiations that read neither (X = false), whose
// code does not see the argument.
//
// Per (b, h), a chunk of Q steps with in-chunk cumulative sums cs of da =
// dt a, u_j = dt_j x_j and S the state entering the chunk (P x N):
//
//   y_i   = sum_{j<=i} (C_i . B_j) e^{cs_i - cs_j} u_j + e^{cs_i} S C_i
//   S'    = e^{cs_last} S + sum_j e^{cs_last - cs_j} u_j B_j^T
//
// Given dy and dS' (the gradient of the state leaving the chunk: the final
// state's for the last chunk), with W_ij = (C_i . B_j) e^{cs_i - cs_j} and
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
// took, so the backward keeps its own: Q 64 at mamba2's (P 64, N 128), Q
// 32 at the smoke config's (16, 16).  Steps past L are dt = 0 identities.
//
// What bounds it on the H100: at mamba2-780m's training shape (B 4, L
// 1024, H 48, P 64, N 128, bf16) the five gradients need 20.4 GFLOP at a
// 64-step chunk (roofline/cost.py:ssd_bwd_bound), 0.021 ms at the bf16
// tensor-core rate, against 80 MB moved (x, dt, B, C, dy read, dx, ddt, dB,
// dC written), 0.024 ms at 3.35 TB/s: bytes, on paper.  The chunk-parallel
// design below adds the two state sets, 2 x 100.7 MB written once and read
// once, so its own floor is ~0.15 ms of bytes.
//
// bf16 at (64, 128): three kernels on wgmma, chunk-parallel
// ----------------------------------------------------------
//  1. ssd_bwd_prep, a warp per (b h, chunk): the chunk's cumulative sum of
//     dt a in fp64 (one warp scan), kept as the float pair hi + lo of cs
//     log2(e) as the forward keeps it, and dt, to fp32 scratch (B H, nc,
//     3, Q).
//  2. ssd_bwd_states, grid (B H, N / 64, 2), one warpgroup a block: the
//     state and dS recursions are independent per 64-column slice of the
//     (P, N) state, so each block walks the chunks forward (S_{c+1} =
//     e^{cs_last} S_c + xw^T B, xw = x e^{cs_last - cs_j} dt_j) or backward
//     (dS_{c-1} = e^{cs_last} dS_c + dy^T (e^{cs} C)) with its 64 x 64 fp32
//     slice in wgmma accumulators, one m64n64 product of depth Q a chunk,
//     the chunk's tiles by TMA, two stages.  It writes S entering each chunk
//     but the first, and dS leaving each chunk, as bf16 hi and lo parts laid
//     out as the 128-byte swizzle puts them in shared memory (32 KB a (b h,
//     chunk) each: the bytes of fp32), so that kernel 3 takes each with
//     plain bulk copies.
//  3. ssd_bwd_chunks, a block per (b, chunk, block of HG heads of one B/C
//     group; a group's last block may be short), two
//     warpgroups: C B^T once a chunk for the block's heads (warpgroup 0
//     keeps it as G^T in registers), then per head, its tiles (x and dy by
//     TMA, S and dS by bulk copy) double-buffered across the heads:
//       warpgroup 0: du = B dS^T (scaled by e^{cs_last - cs_j}) + W^T dy,
//         dY^T = x dy^T, then W^T and V^T = (e^{cs_i - cs_j} dY)^T masked
//         before the exp in registers (W^T as A fragments, V^T to shared
//         memory), dx = dt du, and dC += V B;
//       warpgroup 1: dC's carried share e^{cs_i} dy S and dB's e^{cs_last -
//         cs_j} dt_j x dS' in 64-column halves, then dB += V^T C, and
//         <dS', S>.
//     The per-step sums (W dY's row and column sums, x . du, C . (dy S),
//     B . (x dS')) come from row and column sums of the fragments through
//     warp shuffles, and one warp of warpgroup 1 turns them into dcs, its
//     in-chunk reverse sum dda (a warp scan in fp64), ddt and the head's
//     share of da while the others go on to the next head.  dB and dC are
//     summed over the block's heads in the accumulators and written once a
//     block as fp32 (B, L, blocks, N), each group's blocks in turn; da per
//     (b, chunk, h).  The launcher sums each over a group's blocks in one
//     ordered torch sum: no atomics, bit for bit.
//
// One backward call runs these three kernels, then the launcher's three
// ordered torch sums and their casts.  HG is 12 (kernels/ssd_scan.py:
// BWD_HEAD_GROUP), or a group's H / G heads where fewer (6 at G 8 on 48
// heads, bwd_head_block): on an H100 a sweep of 1-48 heads (event times) put
// 12-24 first, and of 4, 8, 12 and 16 (the profiler's device time of a
// call) 12 was least at both B 4 and B 2.  Fewer heads a group add blocks
// but also partial bytes and block starts, whose first loads nothing
// hides (one block an SM: 215 KB of shared memory); at 12, B 2's 128
// blocks make one wave.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; device time at mamba2's training
// shape, B 4): prep 0.0035 ms, states 0.105, chunks 0.140, the sums 0.025;
// 0.275 in all against the SIMT kernel's 2.58.  Writing the state blobs by
// bulk copies from shared memory instead of 4-byte stores took the states
// kernel from 0.287 to 0.105 ms; with no stores at all it reads 0.056.
// The chunks kernel is a serial chain a head (products, waits, the
// elementwise W and V tiles, barriers) that its two warpgroups overlap in
// part: cutting any one piece (<dS', S>, the finishing warp, the W/V
// exponentials, dx, the carried products) saves 4-10% each, no piece more.
//
// Operand precision, as the forward settled it: x, dy, B and C are exact
// bf16 and enter each product once.  Every fp32 intermediate that enters a
// product goes in as two bf16 parts, hi = bf16(v) and lo = bf16(v - hi),
// and its product runs on both: W, V, S, dS, e^{cs} C and xw.  Rounded once
// instead, each alone puts the worst gradient at mamba2's shape (L 1024, 8
// heads, tools/ssd_rounding.py --part bwd) this far from the exact one,
// max |out - ref| / (1 + |ref|): W 0.194 (ddt), V 0.236 (dB), S 0.053
// (ddt), dS 0.162 (ddt), e^{cs} C 0.073 (dx), xw 0.052 (ddt), against the
// 5e-2 gate; with all six split, 0.0039, the outputs' own bf16 rounding.
//
// fp32 at (64, 128) and both dtypes at (16, 16): the SIMT kernel
// --------------------------------------------------------------
// The first design, kept for fp32 (a comparison path) and the smoke
// config's (16, 16), whose 16-column rows are not whole TMA boxes: one
// block of 256 threads per (b, h) walks the chunks.
//  * A first pass over the chunks recomputes the state entering each chunk
//    (the forward's state update alone) into an fp32 scratch in device
//    memory, (B H, chunks, P, N); the second pass walks the chunks in
//    reverse with dS in shared memory.
//  * Every operand of a chunk is staged in fp32 shared memory with odd row
//    strides (B, C, x, dy, S, dS, and the Q x Q tiles W and
//    e^{cs_i - cs_j} dY), ~210 KB at Q 64: one block an SM.  Each product
//    is a register tile of up to 4 x 8 outputs a thread over its depth, in
//    fp32 on the CUDA cores.
//  * The cumulative sum is fp64 (one warp scan), exp(cs_i - cs_j) takes
//    the fp64 difference, as the forward's SIMT kernel does.
//  * Deterministic: no atomics.  dB and dC (the one group is broadcast to
//    every head) are written per head as fp32 partials (B, L, H, N), and
//    da per (b, h); the launcher sums them in one ordered torch sum.
//    Row and column sums of the chunks go through shared memory in a fixed
//    order; the per-step scalars are summed by one thread in fp64.
//  * bf16 inputs are read and converted to fp32, so both dtypes take the
//    same arithmetic; dx and ddt are written in the inputs' type.

#include "ssd_scan_bwd.cuh"

namespace {

using namespace hopper;

constexpr int NT = 256;   // threads per block

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

template <int Q, int P, int N, typename T, typename TA, bool X>
__global__ void __launch_bounds__(NT, 1) ssd_bwd(Params prm, SsdExt ext) {
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
  const int grp = X ? h / ext.hpg : 0;   // this head's B/C group, N apart in a step
  const T* bg = static_cast<const T*>(prm.b) + bi * prm.bs_b + grp * N;
  const T* cg = static_cast<const T*>(prm.c) + bi * prm.cs_b + grp * N;
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
  if (X && ext.s0 != nullptr) {   // from the initial state, else zero
    for (int e = t; e < P * NS; e += NT) {
      const int pp = e / NS, n = e % NS;
      sS[e] = n < N ? ld_s0<T>(ext, ((size_t)bh * P + pp) * N + n) : 0.f;
    }
  } else {
    for (int e = t; e < P * NS; e += NT) sS[e] = 0.f;
  }
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
  if (X && ext.ds0 != nullptr)   // dS carried back past the first tile: s0's gradient
    for (int e = t; e < P * N; e += NT) ext.ds0[(size_t)bh * P * N + e] = sDS[(e / N) * NS + e % N];
}

template <int Q, int P, int N, typename T, typename TA, bool X>
int launch(const Params& p, const SsdExt& ext, int blocks, cudaStream_t stream) {
  constexpr size_t smem = Smem<Q, P, N>::BYTES;
  static uint32_t opted = 0;   // a bit per device
  const int err = opt_in_smem(reinterpret_cast<const void*>(ssd_bwd<Q, P, N, T, TA, X>), smem,
                              opted);
  if (err) return err;
  ssd_bwd<Q, P, N, T, TA, X><<<blocks, NT, smem, stream>>>(p, ext);
  return (int)cudaGetLastError();
}

template <int Q, int P, int N, typename T, typename TA>
int launch_x(const Params& p, const SsdExt& ext, bool x, int blocks, cudaStream_t stream) {
  return x ? launch<Q, P, N, T, TA, true>(p, ext, blocks, stream)
           : launch<Q, P, N, T, TA, false>(p, ext, blocks, stream);
}

template <int Q, int P, int N>
int by_dtype(const Params& p, const SsdExt& ext, bool x, int blocks, int is_bf16,
             int a_is_bf16, cudaStream_t stream) {
  if (!is_bf16) {
    if (a_is_bf16) return (int)cudaErrorInvalidValue;
    return launch_x<Q, P, N, float, float>(p, ext, x, blocks, stream);
  }
  if (a_is_bf16) return launch_x<Q, P, N, __nv_bfloat16, __nv_bfloat16>(p, ext, x, blocks, stream);
  return launch_x<Q, P, N, __nv_bfloat16, float>(p, ext, x, blocks, stream);
}

namespace tc {

template <typename TA, bool X>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
           const void* dy, const void* dstate, void* dx, void* ddt, float* vec, void* states,
           void* dstates, float* da_part, float* db_part, float* dc_part, int B, int L, int H,
           int hg, const long long* layout, const SsdExt& ext, cudaStream_t stream) {
  CUtensorMap tm[4];   // x, b, c, dy
  const void* ptrs[4] = {x, b, c, dy};
  int err = 0;
  for (int k = 0; k < 4; ++k)   // -1x / -2x: the encoder's code for map k
    if ((err = encode(&tm[k], ptrs[k], layout + 11 * k, Q))) return err - 10 * (k + 1);
  const CUtensorMap &tm_x = tm[0], &tm_b = tm[1], &tm_c = tm[2], &tm_dy = tm[3];
  // blocks of hg heads a (b, chunk), each B/C group's in turn (G = H / hpg)
  const int nc = (L + Q - 1) / Q, items = B * H * nc;
  const int ng = X ? (H / ext.hpg) * ((ext.hpg + hg - 1) / hg) : (H + hg - 1) / hg;
  ssd_bwd_prep<TA><<<(items + 3) / 4, 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(dt), static_cast<const TA*>(a), vec, L, H, nc, items);
  if ((err = (int)cudaGetLastError())) return err;
  static uint32_t opted_st = 0, opted_ch = 0;   // a bit per device
  if ((err = opt_in_smem(reinterpret_cast<const void*>(ssd_bwd_states<X>), ST_BYTES, opted_st)))
    return err;
  StParams sp{static_cast<const __nv_bfloat16*>(dstate), vec,
              static_cast<__nv_bfloat16*>(states), static_cast<__nv_bfloat16*>(dstates), H, nc};
  ssd_bwd_states<X><<<dim3(B * H, NBX, 2), 128, ST_BYTES, stream>>>(tm_x, tm_b, tm_c, tm_dy, sp,
                                                                     ext);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = opt_in_smem(reinterpret_cast<const void*>(ssd_bwd_chunks<TA, X>), CH_BYTES,
                         opted_ch)))
    return err;
  ChParams cp{vec, static_cast<const __nv_bfloat16*>(states),
              static_cast<const __nv_bfloat16*>(dstates), a, static_cast<__nv_bfloat16*>(dx),
              static_cast<__nv_bfloat16*>(ddt), da_part, db_part, dc_part, L, H, nc, hg, ng};
  ssd_bwd_chunks<TA, X><<<B * nc * ng, 256, CH_BYTES, stream>>>(tm_x, tm_b, tm_c, tm_dy, cp,
                                                                ext);
  return (int)cudaGetLastError();
}

template <typename TA>
int launch_x(const void* x, const void* dt, const void* a, const void* b, const void* c,
             const void* dy, const void* dstate, void* dx, void* ddt, float* vec, void* states,
             void* dstates, float* da_part, float* db_part, float* dc_part, int B, int L, int H,
             int hg, const long long* layout, const SsdExt& ext, bool xe,
             cudaStream_t stream) {
  return xe ? launch<TA, true>(x, dt, a, b, c, dy, dstate, dx, ddt, vec, states, dstates,
                               da_part, db_part, dc_part, B, L, H, hg, layout, ext, stream)
            : launch<TA, false>(x, dt, a, b, c, dy, dstate, dx, ddt, vec, states, dstates,
                                da_part, db_part, dc_part, B, L, H, hg, layout, ext, stream);
}

}  // namespace tc

}  // namespace

// x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, G, N), G =
// groups dividing H, as the forward took them (x, b and c through their
// batch and step strides, in elements; a step's (G, N) row contiguous);
// dy, dx: (B, L, H, P) contiguous; dstate: (B, H, P, N) contiguous or
// null; ddt: (B, L, H) contiguous; s0 the forward's initial state (B, H,
// P, N) contiguous, fp32 if s0_f32 else of x's type, or null, and ds0 its
// gradient's fp32 buffer (written where s0 is given).  G > 1 or an s0 runs
// the X instantiations.  x, dt, b, c, dy, dstate,
// dx, ddt are of one type (bf16 if is_bf16 else fp32), a bf16 if a_is_bf16
// else fp32.  The fp32 outputs da_part (B, H), db_part and dc_part (B, L,
// H, N) are each head's shares, which the caller sums; states is scratch
// of B H tiles P N fp32.  The SIMT kernel: (P, N, tile) (64, 128, 64) in
// fp32, or (16, 16, 32) in either dtype (bf16 at (64, 128) takes
// ssd_scan_bwd_tc).  Returns cudaGetLastError() after the launch.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* a, const void* b,
                            const void* c, const void* dy, const void* dstate, void* dx,
                            void* ddt, float* da_part, float* db_part, float* dc_part,
                            float* states, int B, int L, int H, int p_dim, int n_dim, int tile,
                            int is_bf16, int a_is_bf16, long long xs_b, long long xs_l,
                            long long bs_b, long long bs_l, long long cs_b, long long cs_l,
                            void* stream, const void* s0, float* ds0, int s0_f32, int groups) {
  if (B <= 0 || L <= 0 || H <= 0 || groups <= 0 || H % groups) return (int)cudaErrorInvalidValue;
  Params p{x, dt, a, b, c, dy, dstate, dx, ddt, da_part, db_part, dc_part, states, L, H,
           xs_b, xs_l, bs_b, bs_l, cs_b, cs_l};
  const SsdExt ext{s0, ds0, H / groups, s0_f32};
  const bool xe = groups > 1 || s0 != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = B * H;
  if (p_dim == 64 && n_dim == 128 && tile == 64 && !is_bf16 && !a_is_bf16)
    return launch_x<64, 64, 128, float, float>(p, ext, xe, blocks, st);
  if (p_dim == 16 && n_dim == 16 && tile == 32)
    return by_dtype<32, 16, 16>(p, ext, xe, blocks, is_bf16, a_is_bf16, st);
  return (int)cudaErrorInvalidValue;
}

// bf16 at (P 64, N 128): prep, states and chunks (see the header).  x, b,
// c, dy as for ssd_scan_bwd (all bf16; dy contiguous), dstate bf16 (B, H,
// P, N) contiguous or null, dx and ddt bf16 contiguous; a bf16 if
// a_is_bf16 else fp32.  Scratch: vec (B H, nc, 3, 64) fp32; states and
// dstates (B H, nc) blobs of 32 KB.  Outputs: da_part (B, nc, H), db_part
// and dc_part (B, L, G ceil(H / G / head_group), N), fp32 shares per block
// of head_group heads, group by group, which the caller sums; s0, ds0,
// s0_f32 and groups as for ssd_scan_bwd.
// layout: the TMA layouts of x (B, L, H, P), b and c (B, L, G, N) and dy
// (B, L, H, P), each with boxes of 64 rows, 11 values each, as
// kernels/ssd_scan.py computes them.  Returns cudaGetLastError() after the
// launches, or encode()'s negative code less 10 (k + 1) for map k.
extern "C" int ssd_scan_bwd_tc(const void* x, const void* dt, const void* a, const void* b,
                               const void* c, const void* dy, const void* dstate, void* dx,
                               void* ddt, float* vec, void* states, void* dstates,
                               float* da_part, float* db_part, float* dc_part, int B, int L,
                               int H, int head_group, int a_is_bf16, const long long* layout,
                               void* stream, const void* s0, float* ds0, int s0_f32,
                               int groups) {
  if (B <= 0 || L <= 0 || H <= 0 || head_group <= 0 || layout == nullptr || groups <= 0 ||
      H % groups || (groups > 1 && head_group > H / groups))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SsdExt ext{s0, ds0, H / groups, s0_f32};
  const bool xe = groups > 1 || s0 != nullptr;
  if (a_is_bf16)
    return tc::launch_x<__nv_bfloat16>(x, dt, a, b, c, dy, dstate, dx, ddt, vec, states,
                                       dstates, da_part, db_part, dc_part, B, L, H, head_group,
                                       layout, ext, xe, st);
  return tc::launch_x<float>(x, dt, a, b, c, dy, dstate, dx, ddt, vec, states, dstates,
                             da_part, db_part, dc_part, B, L, H, head_group, layout, ext, xe,
                             st);
}
