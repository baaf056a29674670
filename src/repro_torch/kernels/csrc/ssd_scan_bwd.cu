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

// ---------------------------------------------------------------------------
// bf16 at (P 64, N 128): prep, states and chunks on wgmma
// ---------------------------------------------------------------------------
namespace tc {

constexpr int Q = 64, P = 64, N = 128;
constexpr int NBX = N / BOX;                   // 64-column boxes of a state row
constexpr uint32_t TILE = 64 * ROW;            // one box of 64 rows: 8 KB
constexpr uint32_t BLOB = 2 * NBX * TILE;      // a state's hi boxes, then its lo boxes: 32 KB
constexpr int VEC = 3 * Q;                     // a chunk's per-step floats: ch, cl, dt
constexpr double LOG2E = 1.4426950408889634;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// the byte offset of (row, col) in a 64-column box as the 128-byte swizzle lays it out
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * ROW + (((uint32_t)col * 2) ^ ((row & 7) << 4));
}

__device__ __forceinline__ float2 ld_bf2(const unsigned char* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---- 1. the chunks' per-step vectors ---------------------------------------
// vec (B H, nc, 3, Q): cs log2(e) as the float pair ch + cl (cs the chunk's
// cumsum of dt a, in fp64), and dt; steps past L have dt 0.
template <typename TA>
__global__ void __launch_bounds__(128) ssd_bwd_prep(const __nv_bfloat16* __restrict__ dt,
                                                    const TA* __restrict__ a, float* vec, int L,
                                                    int H, int nc, int items) {
  const int item = blockIdx.x * 4 + (threadIdx.x >> 5);   // (b h, chunk)
  if (item >= items) return;                              // warp-uniform
  const int lane = threadIdx.x & 31;
  const int bh = item / nc, c = item % nc, bi = bh / H, h = bh % H;
  const float av = to_f(a[h]);
  float d[2];
  double v[2], run = 0.0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int l = c * Q + 2 * lane + k;
    d[k] = l < L ? __bfloat162float(dt[((size_t)bi * L + l) * H + h]) : 0.f;
    run += (double)(d[k] * av);
    v[k] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += o;
  }
  const double excl = incl - run;
  float* out = vec + (size_t)item * VEC;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = 2 * lane + k;
    const double c2 = (v[k] + excl) * LOG2E;
    const float hi = (float)c2;
    out[j] = hi;
    out[Q + j] = (float)(c2 - (double)hi);
    out[2 * Q + j] = d[k];
  }
}

// ---- 2. the states entering and the gradients leaving each chunk ----------
struct StParams {
  const __nv_bfloat16* dstate;   // (B, H, P, N) contiguous, or null: a zero gradient
  const float* vec;              // kernel 1's
  __nv_bfloat16* st;             // (B H, nc) blobs: S entering chunk c (c >= 1)
  __nv_bfloat16* ds;             // (B H, nc) blobs: dS leaving chunk c
  int H, nc;
};

// two stages of (the A tile: x or dy; a 64-column box of B or C; the
// chunk's vectors), the split operand's hi and lo tiles, two barriers
constexpr size_t ST_BYTES = 1024 + 6 * TILE + 2 * VEC * 4 + 16;

// acc (64 x 64 fp32, the wgmma layout: rows warp*16 + g (+8), columns
// 8 nb + 2 t4 (+1)) as hi and lo parts into two boxes of shared memory,
// laid out as a blob's
__device__ __forceinline__ void stage_parts(unsigned char* hi, unsigned char* lo,
                                            const float (&acc)[32], int warp, int g, int t4) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t off = swz(warp * 16 + g + 8 * r, nb * 8 + 2 * t4);
      split_bf16(acc[4 * nb + 2 * r], acc[4 * nb + 2 * r + 1],
                 *reinterpret_cast<uint32_t*>(hi + off), *reinterpret_cast<uint32_t*>(lo + off));
    }
}

// blockIdx: (b h, 64-column slice, direction).  Direction 0 walks chunks
// 0 .. nc-2 forward and writes S entering chunks 1 .. nc-1; direction 1
// starts from dstate, walks chunks nc-1 .. 1 back and writes dS leaving
// chunks nc-1 .. 0.  X with an initial state: direction 0 starts from it
// and writes it as S entering chunk 0 too; direction 1 takes one more
// step, past chunk 0, and writes s0's gradient (fp32, ext.ds0).
template <bool X>
__global__ void __launch_bounds__(128, 4)
    ssd_bwd_states(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_c,
                   const __grid_constant__ CUtensorMap tm_dy, StParams prm, SsdExt ext) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* sHi = base + 4 * TILE;   // the scaled operand's parts
  unsigned char* sLo = base + 5 * TILE;
  float* sVec = reinterpret_cast<float*>(base + 6 * TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(sVec + 2 * VEC);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, nbx = blockIdx.y, dir = blockIdx.z;
  const int H = prm.H, nc = prm.nc, bi = bh / H, h = bh % H;
  const CUtensorMap* tma = dir ? &tm_dy : &tm_x;
  const CUtensorMap* tmb = dir ? &tm_c : &tm_b;
  const int grp = X ? h / ext.hpg : 0;   // this head's B/C group
  const bool has_s0 = X && ext.s0 != nullptr;
  const int steps = nc - 1 + (has_s0 && dir ? 1 : 0);
  __nv_bfloat16* out = dir ? prm.ds : prm.st;
  float acc[32];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = warp * 16 + g + 8 * (e >> 1), n = nbx * BOX + nb * 8 + 2 * t4 + (e & 1);
      const size_t at = ((size_t)bh * P + p) * N + n;
      if (has_s0 && !dir) acc[4 * nb + e] = ld_s0<__nv_bfloat16>(ext, at);
      else
        acc[4 * nb + e] = dir && prm.dstate != nullptr ? __bfloat162float(prm.dstate[at]) : 0.f;
    }
  // the parts of acc, staged in sHi and sLo, to box nbx of chunk c's blob:
  // one bulk copy each, whole lines
  auto store = [&](int c) {
    stage_parts(sHi, sLo, acc, warp, g, t4);
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      unsigned char* dst = reinterpret_cast<unsigned char*>(out + ((size_t)bh * nc + c) * (BLOB / 2));
      bulk_store(dst + nbx * TILE, sHi, TILE);
      bulk_store(dst + (NBX + nbx) * TILE, sLo, TILE);
      bulk_commit();
    }
  };
  auto chunk_of = [&](int t) { return dir ? nc - 1 - t : t; };
  auto load = [&](int t) {
    const int s = t & 1, c = chunk_of(t);
    unsigned char* sa = base + s * 2 * TILE;
    mbar_expect_tx(full + s, 2 * TILE + VEC * 4);
    tma_load(sa, tma, full + s, 0, h, c * Q, bi);
    tma_load(sa + TILE, tmb, full + s, nbx * BOX, grp, c * Q, bi);
    bulk_load(sVec + s * VEC, prm.vec + ((size_t)bh * nc + c) * VEC, VEC * 4, full + s);
  };

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    if (steps > 0) load(0);
    if (steps > 1) load(1);
  }

  if (dir) store(nc - 1);
  else if (has_s0) store(0);

  for (int t = 0; t < steps; ++t) {
    const int s = t & 1, c = chunk_of(t);
    unsigned char* sa = base + s * 2 * TILE;
    unsigned char* sb = sa + TILE;
    const float* ch = sVec + s * VEC;
    const float* cl = ch + Q;
    const float* dts = cl + Q;
    mbar_wait(full + s, (t >> 1) & 1);
    if (tid == 0) bulk_wait_read();   // the last store has read sHi and sLo
    __syncthreads();
    const float chL = ch[Q - 1], clL = cl[Q - 1];
    // the operand this direction scales, as hi and lo parts in the source's
    // layout: x's rows by e^{cs_last - cs_j} dt_j, or C's by e^{cs_i}.  The
    // swizzle moves 16-byte pieces within a row, so a piece's row is its
    // offset over ROW.
    const unsigned char* src = dir ? sb : sa;
    for (int e = tid; e < Q * BOX / 8; e += 128) {
      const int r = e * 16 / ROW;
      const float w = dir ? ex2(ch[r] + cl[r]) : ex2((chL - ch[r]) + (clL - cl[r])) * dts[r];
      const uint4 v = *reinterpret_cast<const uint4*>(src + e * 16);
      const uint32_t* u = reinterpret_cast<const uint32_t*>(&v);
      uint4 hi, lo;
      uint32_t* uh = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* ul = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[k]));
        split_bf16(f.x * w, f.y * w, uh[k], ul[k]);
      }
      *reinterpret_cast<uint4*>(sHi + e * 16) = hi;
      *reinterpret_cast<uint4*>(sLo + e * 16) = lo;
    }
    fence_proxy_async();
    __syncthreads();
    // acc = e^{cs_last} acc + A^T Bm over the chunk's steps: direction 0 A
    // = xw (hi, lo), Bm = B; direction 1 A = dy, Bm = e^{cs} C (hi, lo);
    // both read MN-major
    const float keep = ex2(chL + clL);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= keep;
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        const uint32_t sp = smem_u32(part ? sLo : sHi) + kk * 16 * ROW;
        const uint32_t so = smem_u32(dir ? sa : sb) + kk * 16 * ROW;
        wgmma_ss_n64<1, 1>(acc, smem_desc(dir ? so : sp, Q * ROW / 16, 64),
                           smem_desc(dir ? sp : so, Q * ROW / 16, 64), 1);
      }
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    __syncthreads();   // stage s and the parts are read
    if (has_s0 && dir && c == 0) {   // past chunk 0: s0's gradient, fp32
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = warp * 16 + g + 8 * r, n = nbx * BOX + nb * 8 + 2 * t4;
          *reinterpret_cast<float2*>(ext.ds0 + ((size_t)bh * P + p) * N + n) =
              make_float2(acc[4 * nb + 2 * r], acc[4 * nb + 2 * r + 1]);
        }
    } else {
      store(dir ? c - 1 : c + 1);
    }
    if (tid == 0 && t + 2 < steps) load(t + 2);
  }
  if (tid == 0) bulk_wait();
}

// ---- 3. every chunk's gradients ---------------------------------------------
struct ChParams {
  const float* vec;
  const __nv_bfloat16* st;
  const __nv_bfloat16* ds;
  const void* a;            // (H,)
  __nv_bfloat16* dx;        // (B, L, H, P), contiguous
  __nv_bfloat16* ddt;       // (B, L, H), contiguous
  float* da_part;           // (B, nc, H)
  float* db_part;           // (B, L, ng, N): dB's share of each head group
  float* dc_part;           // (B, L, ng, N)
  int L, H, nc, hg, ng;
};

// one head's per-step sums, for the warp that finishes the head
struct Res {
  float rowq[4][Q];   // sum_j W_ij dY_ij, a share per warp of warpgroup 0
  float colq[Q];      // sum_i W_ij dY_ij
  float xdu[Q];       // x_j . du_j
  float rdot[Q];      // e^{cs_i} C_i . (dy_i S)
  float tdot[Q];      // e^{cs_last - cs_j} dt_j B_j . (x_j dS')
  float sdot[4];      // <dS', S>, a share per warp of warpgroup 1
};

// C and B (two boxes each); two stages of a head's x, dy, S (hi, lo boxes)
// and dS'; V^T's hi and lo parts; two stages of per-step vectors and Res;
// three barriers
constexpr size_t CH_BYTES = 1024 + 26 * TILE + 2 * VEC * 4 + 2 * sizeof(Res) + 3 * 8;
static_assert(CH_BYTES <= 232448, "over the shared memory of an SM");

constexpr int BAR_HEAD = 1, BAR_V = 2, BAR_WG0 = 3;   // named barriers

template <typename TA, bool X>
__global__ void __launch_bounds__(256, 1)
    ssd_bwd_chunks(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_c,
                   const __grid_constant__ CUtensorMap tm_dy, ChParams prm, SsdExt ext) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* sC = base;
  unsigned char* sB = base + 2 * TILE;
  unsigned char* sVt = base + 24 * TILE;   // V^T (rows j, columns i): hi, then lo
  float* sVec = reinterpret_cast<float*>(base + 26 * TILE);
  Res* res = reinterpret_cast<Res*>(sVec + 2 * VEC);
  uint64_t* bars = reinterpret_cast<uint64_t*>(res + 2);   // C and B; stage 0; stage 1
  // stage s: x, dy, S (hi boxes, lo boxes), dS' (likewise)
  auto stage = [&](int s) { return base + 4 * TILE + s * 10 * TILE; };

  const int tid = threadIdx.x, wg = tid >> 7, ltid = tid & 127;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int L = prm.L, H = prm.H, nc = prm.nc, ng = prm.ng;
  const int gi = blockIdx.x % ng, c = (blockIdx.x / ng) % nc, bi = blockIdx.x / (ng * nc);
  // X: the ng blocks of a (b, chunk) are each B/C group's blocks in turn,
  // a group's last block short where hg does not divide its heads
  int grp = 0, h0, nh;
  if constexpr (X) {
    const int bpg = ng / (H / ext.hpg);   // blocks a group
    grp = gi / bpg;
    h0 = grp * ext.hpg + (gi % bpg) * prm.hg;
    nh = min(prm.hg, (grp + 1) * ext.hpg - h0);
  } else {
    h0 = gi * prm.hg;
    nh = min(prm.hg, H - h0);
  }
  const int l0 = c * Q;
  // the state entering the chunk is zero in chunk 0 unless s0 is given
  const bool carried = c > 0 || (X && ext.s0 != nullptr);
  const int r0 = warp * 16 + g;   // this thread's accumulator rows r0 and r0 + 8

  auto load_head = [&](int k) {
    const int s = k & 1, h = h0 + k;
    const size_t item = ((size_t)bi * H + h) * nc + c;
    unsigned char* st = stage(s);
    uint64_t* bar = bars + 1 + s;
    mbar_expect_tx(bar, 2 * TILE + (carried ? BLOB : 0) + BLOB + VEC * 4);
    tma_load(st, &tm_x, bar, 0, h, l0, bi);
    tma_load(st + TILE, &tm_dy, bar, 0, h, l0, bi);
    const unsigned char* bs = reinterpret_cast<const unsigned char*>(prm.st) + item * BLOB;
    const unsigned char* bd = reinterpret_cast<const unsigned char*>(prm.ds) + item * BLOB;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (carried) bulk_load(st + (2 + q) * TILE, bs + q * TILE, TILE, bar);
      bulk_load(st + (6 + q) * TILE, bd + q * TILE, TILE, bar);
    }
    bulk_load(sVec + s * VEC, prm.vec + item * VEC, VEC * 4, bar);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, 4 * TILE);
#pragma unroll
    for (int q = 0; q < NBX; ++q) {
      tma_load(sC + q * TILE, &tm_c, bars, q * BOX, grp, l0, bi);
      tma_load(sB + q * TILE, &tm_b, bars, q * BOX, grp, l0, bi);
    }
    load_head(0);
    if (nh > 1) load_head(1);
  }
  mbar_wait(bars, 0);

  if (wg == 0) {
    // ---- warpgroup 0: du, dx, W^T, V^T and dC += V B ----------------------
    float gt[32];   // G^T = B C^T (rows j, columns i), for every head of the group
    qk_product<N, Q, Q, 32>(gt, smem_u32(sB), smem_u32(sC));
    float acc_dc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_dc[i] = 0.f;
    for (int k = 0; k < nh; ++k) {
      const int s = k & 1, h = h0 + k;
      unsigned char* sX = stage(s);
      unsigned char* sDY = sX + TILE;
      unsigned char* sDS = sX + 6 * TILE;
      const float* ch = sVec + s * VEC;
      const float* cl = ch + Q;
      const float* dts = cl + Q;
      Res& rs = res[s];
      mbar_wait(bars + 1 + s, (k >> 1) & 1);
      // du = B dS'^T (hi, lo) and dY^T = x dy^T, both in flight at once
      float du[32], yt[32];
      qk_product<N, Q, P, 32, false>(du, smem_u32(sB), smem_u32(sDS));
      qk_product<N, Q, P, 32, false>(du, smem_u32(sB), smem_u32(sDS + NBX * TILE), true);
      qk_product<P, Q, Q, 32>(yt, smem_u32(sX), smem_u32(sDY));
      pin(du);
      const float chL = ch[Q - 1], clL = cl[Q - 1];
      float cj[2], lj[2], dj[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = r0 + 8 * r;
        cj[r] = ch[j];
        lj[r] = cl[j];
        dj[r] = dts[j];
        const float wj = ex2((chL - cj[r]) + (clL - lj[r]));   // e^{cs_last - cs_j}
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          du[4 * nb + 2 * r] *= wj;
          du[4 * nb + 2 * r + 1] *= wj;
        }
      }
      // W^T and V^T on i >= j (masked before the exp), and W dY's sums: the
      // row sums (over i) in csum, each column's (over j) reduced over the
      // warp's 16 rows and written per warp
      uint32_t wh[4][4], wl[4][4];
      float csum[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int i = nb * 8 + 2 * t4;
        float wv[4] = {0.f, 0.f, 0.f, 0.f}, vv[4] = {0.f, 0.f, 0.f, 0.f};
        float rsum[2] = {0.f, 0.f};
        if (nb * 8 + 7 >= warp * 16) {   // warp-uniform: a block wholly below i >= j is zero
          const float2 ih = *reinterpret_cast<const float2*>(ch + i);
          const float2 il = *reinterpret_cast<const float2*>(cl + i);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, ii = i + (e & 1);
            if (ii >= r0 + 8 * r) {
              const float ed = ex2(((e & 1 ? ih.y : ih.x) - cj[r]) + ((e & 1 ? il.y : il.x) - lj[r]));
              const float dyv = yt[4 * nb + e] * dj[r];
              wv[e] = gt[4 * nb + e] * ed;
              vv[e] = dyv * ed;
              const float q = wv[e] * dyv;
              csum[r] += q;
              rsum[e & 1] += q;
            }
          }
        }
        split_bf16(wv[0], wv[1], wh[nb / 2][(nb % 2) * 2 + 0], wl[nb / 2][(nb % 2) * 2 + 0]);
        split_bf16(wv[2], wv[3], wh[nb / 2][(nb % 2) * 2 + 1], wl[nb / 2][(nb % 2) * 2 + 1]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t off = swz(r0 + 8 * r, i);
          split_bf16(vv[2 * r], vv[2 * r + 1], *reinterpret_cast<uint32_t*>(sVt + off),
                     *reinterpret_cast<uint32_t*>(sVt + TILE + off));
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = rsum[e];
          v += __shfl_xor_sync(FULL, v, 4);
          v += __shfl_xor_sync(FULL, v, 8);
          v += __shfl_xor_sync(FULL, v, 16);
          if (g == 0) rs.rowq[warp][i + e] = v;
        }
      }
      fence_proxy_async();
      named_sync(BAR_WG0, 128);     // V^T is whole for warpgroup 0 ...
      named_arrive(BAR_V, 256);     // ... and warpgroup 1 may read it
      // du += W^T dy (hi, lo), the A fragments from registers
      pv_product<P, Q, false>(du, wh, smem_u32(sDY));
      pv_product<P, Q, false>(du, wl, smem_u32(sDY));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        csum[r] += __shfl_xor_sync(FULL, csum[r], 1);
        csum[r] += __shfl_xor_sync(FULL, csum[r], 2);
        if (t4 == 0) rs.colq[r0 + 8 * r] = csum[r];
      }
      wgmma_wait_all();
      pin(du);
      // dC += V B: V read MN-major from V^T (its rows j are the depth), B
      // MN-major; in flight while dx is written
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < Q / 16; ++kk)
          wgmma_ss_n128<1, 1>(acc_dc,
                              smem_desc(smem_u32(sVt + part * TILE) + kk * 16 * ROW, Q * ROW / 16, 64),
                              smem_desc(smem_u32(sB) + kk * 16 * ROW, Q * ROW / 16, 64), 1);
      wgmma_commit();
      // dx = dt_j du_j, and x_j . du_j
      float xd[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = r0 + 8 * r, l = l0 + j;
        __nv_bfloat16* dxr = prm.dx + (((size_t)bi * L + l) * H + h) * P;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int p = nb * 8 + 2 * t4;
          const float2 xv = ld_bf2(sX + swz(j, p));
          const float u0 = du[4 * nb + 2 * r], u1 = du[4 * nb + 2 * r + 1];
          xd[r] += xv.x * u0 + xv.y * u1;
          if (l < L)
            *reinterpret_cast<__nv_bfloat162*>(dxr + p) = __floats2bfloat162_rn(dj[r] * u0, dj[r] * u1);
        }
        xd[r] += __shfl_xor_sync(FULL, xd[r], 1);
        xd[r] += __shfl_xor_sync(FULL, xd[r], 2);
        if (t4 == 0) rs.xdu[j] = xd[r];
      }
      wgmma_wait_all();
      pin(acc_dc);
      named_sync(BAR_HEAD, 256);   // the head is done: its stage may be refilled
      if (tid == 0 && k + 2 < nh) load_head(k + 2);
    }
    // dC = this share + warpgroup 1's carried share, handed over in stage 0
    named_sync(BAR_HEAD, 256);
    const float* part = reinterpret_cast<const float*>(stage(0));
#pragma unroll
    for (int e = 0; e < 64; ++e) acc_dc[e] += part[e * 128 + ltid];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int l = l0 + r0 + 8 * r;
      if (l >= L) continue;
      float* row = prm.dc_part + ((size_t)bi * L + l) * ng * N + (size_t)gi * N;
#pragma unroll
      for (int nb = 0; nb < 16; ++nb)
        *reinterpret_cast<float2*>(row + nb * 8 + 2 * t4) =
            make_float2(acc_dc[4 * nb + 2 * r], acc_dc[4 * nb + 2 * r + 1]);
    }
  } else {
    // ---- warpgroup 1: the carried shares, dB += V^T C, <dS', S>; its last
    //      warp finishes each head ------------------------------------------
    float acc_db[64], acc_dcc[64], tmp[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_db[i] = acc_dcc[i] = 0.f;
    for (int k = 0; k < nh; ++k) {
      const int s = k & 1, h = h0 + k;
      unsigned char* sX = stage(s);
      unsigned char* sDY = sX + TILE;
      unsigned char* sS = sX + 2 * TILE;
      unsigned char* sDS = sX + 6 * TILE;
      const float* ch = sVec + s * VEC;
      const float* cl = ch + Q;
      const float* dts = cl + Q;
      Res& rs = res[s];
      mbar_wait(bars + 1 + s, (k >> 1) & 1);
      const float chL = ch[Q - 1], clL = cl[Q - 1], keep = ex2(chL + clL);
      float ein[2], wdt[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        ein[r] = ex2(ch[row] + cl[row]);
        wdt[r] = ex2((chL - ch[row]) + (clL - cl[row])) * dts[row];
      }
      float rp[2] = {0.f, 0.f}, tp[2] = {0.f, 0.f}, sd = 0.f;
      if (carried) {
        // <dS', S> over hi + lo, 16 bytes of each part a step; both blobs
        // share one layout
        for (int e = ltid; e < NBX * TILE / 16; e += 128) {
          const uint4 sh = *reinterpret_cast<const uint4*>(sS + e * 16);
          const uint4 sl = *reinterpret_cast<const uint4*>(sS + NBX * TILE + e * 16);
          const uint4 dh = *reinterpret_cast<const uint4*>(sDS + e * 16);
          const uint4 dl = *reinterpret_cast<const uint4*>(sDS + NBX * TILE + e * 16);
          const unsigned char *a0 = reinterpret_cast<const unsigned char*>(&sh),
                              *a1 = reinterpret_cast<const unsigned char*>(&sl),
                              *b0 = reinterpret_cast<const unsigned char*>(&dh),
                              *b1 = reinterpret_cast<const unsigned char*>(&dl);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 x0 = ld_bf2(a0 + 4 * q), x1 = ld_bf2(a1 + 4 * q);
            const float2 y0 = ld_bf2(b0 + 4 * q), y1 = ld_bf2(b1 + 4 * q);
            sd += (x0.x + x1.x) * (y0.x + y1.x) + (x0.y + x1.y) * (y0.y + y1.y);
          }
        }
        // dC's carried share e^{cs_i} dy S, a 64-column half at a time: dy
        // K-major, S MN-major (hi, lo); C . (dy S) per step
#pragma unroll
        for (int hb = 0; hb < NBX; ++hb) {
          wgmma_fence();
#pragma unroll
          for (int part = 0; part < 2; ++part)
#pragma unroll
            for (int kk = 0; kk < P / 16; ++kk)
              wgmma_ss_n64<0, 1>(tmp, smem_desc(smem_u32(sDY) + kk * 32, 1, 64),
                                 smem_desc(smem_u32(sS + (part * NBX + hb) * TILE) + kk * 16 * ROW,
                                           P * ROW / 16, 64),
                                 part | kk);
          wgmma_commit();
          wgmma_wait_all();
          pin(tmp);
#pragma unroll
          for (int nb = 0; nb < 8; ++nb)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float2 cv = ld_bf2(sC + hb * TILE + swz(r0 + 8 * r, nb * 8 + 2 * t4));
              const float v0 = tmp[4 * nb + 2 * r], v1 = tmp[4 * nb + 2 * r + 1];
              rp[r] += cv.x * v0 + cv.y * v1;
              acc_dcc[4 * (nb + 8 * hb) + 2 * r] += ein[r] * v0;
              acc_dcc[4 * (nb + 8 * hb) + 2 * r + 1] += ein[r] * v1;
            }
        }
      }
      // dB's carried share e^{cs_last - cs_j} dt_j x dS', a half at a time,
      // and B . (x dS') per step
#pragma unroll
      for (int hb = 0; hb < NBX; ++hb) {
        wgmma_fence();
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int kk = 0; kk < P / 16; ++kk)
            wgmma_ss_n64<0, 1>(tmp, smem_desc(smem_u32(sX) + kk * 32, 1, 64),
                               smem_desc(smem_u32(sDS + (part * NBX + hb) * TILE) + kk * 16 * ROW,
                                         P * ROW / 16, 64),
                               part | kk);
        wgmma_commit();
        wgmma_wait_all();
        pin(tmp);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 bv = ld_bf2(sB + hb * TILE + swz(r0 + 8 * r, nb * 8 + 2 * t4));
            const float v0 = tmp[4 * nb + 2 * r], v1 = tmp[4 * nb + 2 * r + 1];
            tp[r] += bv.x * v0 + bv.y * v1;
            acc_db[4 * (nb + 8 * hb) + 2 * r] += wdt[r] * v0;
            acc_db[4 * (nb + 8 * hb) + 2 * r + 1] += wdt[r] * v1;
          }
      }
      // dB += V^T C once warpgroup 0 has written V^T: V^T K-major, C MN-major
      named_sync(BAR_V, 256);
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < Q / 16; ++kk)
          wgmma_ss_n128<0, 1>(acc_db, smem_desc(smem_u32(sVt + part * TILE) + kk * 32, 1, 64),
                              smem_desc(smem_u32(sC) + kk * 16 * ROW, Q * ROW / 16, 64), 1);
      wgmma_commit();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rp[r] += __shfl_xor_sync(FULL, rp[r], 1);
        rp[r] += __shfl_xor_sync(FULL, rp[r], 2);
        tp[r] += __shfl_xor_sync(FULL, tp[r], 1);
        tp[r] += __shfl_xor_sync(FULL, tp[r], 2);
        if (t4 == 0) {
          rs.rdot[r0 + 8 * r] = ein[r] * rp[r];
          rs.tdot[r0 + 8 * r] = wdt[r] * tp[r];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sd += __shfl_xor_sync(FULL, sd, off);
      if (lane == 0) rs.sdot[warp] = carried ? sd : 0.f;
      // the finishing warp keeps this head's dt (the stage is refilled after
      // the barrier)
      float fdt[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) fdt[q] = dts[2 * lane + q];
      wgmma_wait_all();
      pin(acc_db);
      named_sync(BAR_HEAD, 256);
      if (warp == 3) {
        // dcs per step, dda its in-chunk reverse sum (fp64 warp scan), ddt
        // and the head's share of da
        const float av = to_f(static_cast<const TA*>(prm.a)[h]);
        double dcs[2], ts = 0.0;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int kq = 2 * lane + q;
          const float rq = rs.rowq[0][kq] + rs.rowq[1][kq] + rs.rowq[2][kq] + rs.rowq[3][kq];
          dcs[q] = (double)rq - rs.colq[kq] + rs.rdot[kq] - rs.tdot[kq];
          ts += rs.tdot[kq];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ts += __shfl_xor_sync(FULL, ts, off);
        if (lane == 31)
          dcs[1] += ts + (double)keep * ((rs.sdot[0] + rs.sdot[1]) + (rs.sdot[2] + rs.sdot[3]));
        const double s0 = dcs[0] + dcs[1];
        double incl = s0;   // sum over this lane's steps and every later lane's
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double o = __shfl_down_sync(FULL, incl, off);
          if (lane + off < 32) incl += o;
        }
        const double after = incl - s0;
        const double dda[2] = {s0 + after, dcs[1] + after};
        double dap = 0.0;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int kq = 2 * lane + q, l = l0 + kq;
          if (l < L)
            prm.ddt[((size_t)bi * L + l) * H + h] = __float2bfloat16((float)(rs.xdu[kq] + av * dda[q]));
          dap += (double)fdt[q] * dda[q];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) dap += __shfl_xor_sync(FULL, dap, off);
        if (lane == 0) prm.da_part[((size_t)bi * nc + c) * H + h] = (float)dap;
      }
    }
    // dB out; dC's carried share to warpgroup 0 through stage 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int l = l0 + r0 + 8 * r;
      if (l >= L) continue;
      float* row = prm.db_part + ((size_t)bi * L + l) * ng * N + (size_t)gi * N;
#pragma unroll
      for (int nb = 0; nb < 16; ++nb)
        *reinterpret_cast<float2*>(row + nb * 8 + 2 * t4) =
            make_float2(acc_db[4 * nb + 2 * r], acc_db[4 * nb + 2 * r + 1]);
    }
    float* part = reinterpret_cast<float*>(stage(0));
#pragma unroll
    for (int e = 0; e < 64; ++e) part[e * 128 + ltid] = acc_dcc[e];
    named_sync(BAR_HEAD, 256);
  }
}

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
