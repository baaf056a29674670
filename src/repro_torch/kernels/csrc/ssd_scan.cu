// Mamba-2 SSD chunked scan for Hopper (sm_90a), model layout.
//
// Replaces src/repro/kernels/ssd_scan.py:_kernel (the Pallas TPU kernel
// behind ssd_scan_kernel) and computes the same function.  Per (b, h)
// the sequence is cut into chunks of Q steps and a fp32 (P x N) state is
// carried from chunk to chunk.  Per chunk, with da = dt * a and
// cs = cumsum(da) over the chunk:
//
//   y[i]   = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j      intra-chunk
//          + exp(cs_i) (C_i . state)                              carried state
//   state  = exp(cs_Q) state + sum_j exp(cs_Q - cs_j) dt_j x_j B_j^T
//
// B and C come in G groups dividing H: head h reads group h / (H / G).
// The state starts from an initial state S_0 where one is given, else
// from zero.  A call with G > 1 or an S_0 runs the kernels' X
// instantiations, which take both through an argument of their own
// (hopper.cuh: SsdExt); G = 1 with no S_0 runs instantiations that read
// neither (X = false), whose code does not see the argument.
//
// Steps past L are dt = 0 identities (exp(0) = 1, dt x = 0): they leave
// the state as it is, and their y is not written.  y and the final state
// are written in x's type.  Two kernels: ssd_fwd_bf16 for bf16 inputs
// (the model's), ssd_fwd (fp32 SIMT, notes below) for fp32.
//
// What bounds it on the H100: at mamba2-780m's prefill (B 4, L 1024,
// H 48, P 64, N 128, Q 128, bf16) one launch must move about 56 MB (x and
// y 25.2 MB each, B and C 2.1 MB, the state 3.1 MB, dt 0.4 MB), 0.0167 ms
// at 3.35 TB/s.  The function needs 7.7 GFLOP (2 per MAC): per chunk C B^T
// on the causal pairs only, once a B/C group (here one), and per head the
// decay tile times x dt on the same pairs, C . state (none in the first
// chunk, whose carried state is zero unless S_0 is given) and the state
// update; that is 0.0078 ms at 989 TFLOP/s.  So bytes bound it, by 2x.
// At G 8 from a bf16 S_0 (B and C 16.8 MB, S_0 3.1 MB) 73.8 MB, 0.0220 ms of
// bytes (roofline/cost.py:ssd_bound).
//
// What the bf16 design does about it:
//  * The TPU grid's sequential chunk axis is a loop inside one block per
//    (b, h), so the state never leaves the SM and every input is read
//    once, in place (x, B and C through tensor maps over the model's
//    views of its conv output), and y is written once.
//  * All four products run on wgmma (bf16 operands, fp32 sums), on two
//    consumer warpgroups that take rows 0-63 and 64-127 of a Q 128 chunk
//    (one warpgroup at Q 64):
//      y = C state^T             m64n64, B from bf16 copies of the state;
//      y = exp(cs_i) y + M x     per 64 steps j: S = C B^T (m64n64, both
//                                K-major), M = S exp(cs_i - cs_j) dt_j
//                                masked to j <= i before the exp and packed
//                                to bf16 in registers (as flash packs P),
//                                then m64n64 with x MN-major; steps past a
//                                warpgroup's last row are skipped;
//      state = exp(cs_Q) state + xw^T B   m64n(128 / warpgroups), xw =
//                                x exp(cs_Q - cs_j) dt_j and B both read
//                                MN-major.
//    The fp32 state is the update's accumulator and stays in registers
//    from the first chunk to the last (32 a thread at Q 128).
//  * Each operand the kernel rounds (M, the state's copy, xw) goes in as
//    two bf16 parts, hi = bf16(v) and lo = bf16(v - hi), and its product
//    runs on both: 16 bits of mantissa.  Rounded once, at mamba2's shape
//    the decay tile alone puts y 0.125 max |out - ref| / (1 + |ref|) from
//    ssd_ref and the state's copy 0.085 (limit 5e-2), xw 0.024 between
//    chunk 64 and 128 (limit 1e-2), from sums that cancel; split, 0.004,
//    y's own rounding (tools/ssd_rounding.py).  C, B and x enter exactly.
//    This costs 7.0 M MACs a head and chunk where one part would take 4.25 M.
//  * C, B and x arrive by TMA (128-byte swizzle, 64-column boxes; rows
//    past L are zero-filled) on full mbarriers; the next chunk's C is
//    loaded once this chunk's C is read, its B and x after the state
//    update.  y goes out through shared memory by one TMA store a
//    warpgroup, which also clips rows past L.  A second stage measured no
//    faster: the chunk's loads are not what holds a block.
//  * The chunk's cumulative sum stays fp64 (one warp scan): with this
//    repo's init da reaches tens per step and cs ~-1e3 over a chunk, where
//    exp(cs_i - cs_j) of two fp32 sums loses ~1e-4 to cancellation.  It is
//    kept as the float pair hi + lo of cs log2(e), so that cs_i - cs_j is
//    three fp32 adds and exp one ex2 (an fp64 difference and its
//    conversion per element took a third of the kernel's time).
//  * Warpgroup 0's rows see half the steps, so it also scales x into xw
//    and scans the next chunk's dt (into a second set of per-step
//    vectors) while warpgroup 1 finishes its rows.
//  * 165 KB of shared memory and up to 170 registers a thread: one block
//    an SM, so the 192 blocks of the prefill run in two waves.  C B^T is
//    computed once per head (the heads of a group could share it).
//
// What the measurements say still holds it back (0.100 ms at mamba2's
// prefill, 17% of the byte bound; probes that drop one piece each, timed
// with tools/flash_ab.py on an H100): no single piece.  Each block runs a
// serial chain a chunk (products, waits, the elementwise decay tile,
// block-wide barriers) that its two warpgroups hide only in part, and one
// block an SM puts the prefill's 192 blocks in two waves on 132 SMs.  The
// decay tile's elementwise work is 13% of the time, the state update 8%,
// warpgroup 1's second 64 steps 4.5%; the carried term is hidden.  Two
// blocks an SM (shared memory aliased, registers capped at 128, wrong
// results) gained 11%.  The next step is structural: C B^T shared across
// heads, or a chunk-parallel split that gives the SMs more, shorter blocks.

#include "ssd_scan.cuh"

namespace {

using namespace hopper;

constexpr int NT = 256;       // threads per block of the SIMT kernel

// ---------------------------------------------------------------------------
// SIMT: fp32 at mamba2's (P 64, N 128), both dtypes at the smoke config's
// (P 16, N 16)
// ---------------------------------------------------------------------------
// The SIMT kernel (the first design, kept for fp32 inputs and for the smoke
// config, whose 16-column rows are not whole TMA boxes): templated on the
// chunk Q, the head and state dims P and N, the element type T of x, dt, b,
// c, y and the state (bf16 or fp32; the arithmetic is fp32) and TA of a.
// The launcher picks it by shape and dtype alone.  One block of 256
// threads per (b, h) loops over the chunks with the fp32 state in shared
// memory (32 KB at P 64, N 128).  A chunk's B, C and x*dt are staged in shared memory as
// fp32 (about 196 KB at Q 128, so one block an SM), the Q x Q decay tile
// (C B^T masked, then exp(cs_i - cs_j)) is built in registers and written
// over C, and the products are fp32 FMAs on the CUDA cores with register
// tiles of up to 8 x 8 a thread.  So it is bound by shared-memory loads and
// FMA throughput, not bytes: fp32 binds on operations at 67 TFLOP/s.
struct Params {
  const void* x;      // (B, L, H, P), each (H, P) row contiguous
  const void* dt;     // (B, L, H), contiguous
  const void* a;      // (H,)
  const void* b;      // (B, L, N), each N row contiguous
  const void* c;      // (B, L, N), each N row contiguous
  void* y;            // (B, L, H, P), contiguous
  void* state;        // (B, H, P, N), contiguous
  int L, H;
  long long xs_b, xs_l, bs_b, bs_l, cs_b, cs_l;   // batch and step strides, in elements
};

// padded row strides: of B and the state (NS), of C and the decay tile
// that is written over it (CS: a Q-wide tile needs Q columns where N < Q)
template <int Q, int N_>
struct SimtStrides {
  static constexpr int NS = N_ + 1;
  static constexpr int CS = (N_ > Q ? N_ : Q) + 1;
};

template <int Q, int P_, int N_>
constexpr size_t smem_bytes() {
  // the fp64 cumsum, then B, C/decay tile, x*dt, state, and three per-step vectors
  using ST = SimtStrides<Q, N_>;
  return sizeof(double) * Q +
         sizeof(float) * ((size_t)Q * ST::NS + (size_t)Q * ST::CS + (size_t)Q * P_ +
                          (size_t)P_ * ST::NS + 3 * Q);
}

template <int Q, int P_, int N_, typename T, typename TA, bool X>
__global__ void __launch_bounds__(NT) ssd_fwd(Params prm, SsdExt ext) {
  static_assert(Q % 32 == 0 && Q <= NT, "chunk must be 32, 64 or 128");
  static_assert(P_ % 16 == 0 && N_ % 16 == 0, "P and N must be multiples of 16");
  static_assert(NT % N_ == 0 && NT % P_ == 0 && (Q * N_) % NT == 0 && (Q * P_) % NT == 0,
                "rows are split evenly");
  constexpr int NS = SimtStrides<Q, N_>::NS, CS = SimtStrides<Q, N_>::CS;
  constexpr int P = P_, N = N_;
  extern __shared__ __align__(16) unsigned char smem[];
  double* cum = reinterpret_cast<double*>(smem);   // (Q,) cumsum of da within the chunk
  float* bs = reinterpret_cast<float*>(cum + Q);   // (Q, NS) B rows
  float* cs = bs + Q * NS;          // (Q, CS) C rows, then the decay tile
  float* xdt = cs + Q * CS;         // (Q, P) x * dt
  float* sts = xdt + Q * P;         // (P, NS) the carried state
  float* dts = sts + P * NS;        // (Q,) dt
  float* ein = dts + Q;             // (Q,) exp(cum_i): decay of the carried state into y
  float* wout = ein + Q;            // (Q,) exp(cum_last - cum_j): decay of step j into the state

  const int L = prm.L, H = prm.H;
  const int bh = blockIdx.x, bi = bh / H, h = bh % H;
  const int t = threadIdx.x;
  // this (b, h)'s rows at step 0; step l is l strides further on
  const T* xg = static_cast<const T*>(prm.x) + bi * prm.xs_b + h * P;
  const T* dtg = static_cast<const T*>(prm.dt) + (size_t)bi * L * H + h;
  // this head's B/C group (X: the groups of a step lie N apart)
  const int grp = X ? h / ext.hpg : 0;
  const T* bg = static_cast<const T*>(prm.b) + bi * prm.bs_b + grp * N;
  const T* cg = static_cast<const T*>(prm.c) + bi * prm.cs_b + grp * N;
  const long long xs_l = prm.xs_l, bs_l = prm.bs_l, cs_l = prm.cs_l;
  T* yg = static_cast<T*>(prm.y);
  const float a = ld(static_cast<const TA*>(prm.a) + h);

  if (X && ext.s0 != nullptr) {   // the initial state, else zero
    for (int e = t; e < P * NS; e += NT) {
      const int pp = e / NS, n = e % NS;
      sts[e] = n < N ? ld_s0<T>(ext, ((size_t)bh * P + pp) * N + n) : 0.f;
    }
  } else {
    for (int e = t; e < P * NS; e += NT) sts[e] = 0.f;
  }

  // (Q x P) and (Q x Q) products: rows i = ti + RI r, columns tc + 16 k
  constexpr int RI = NT / 16;
  constexpr int YR = Q / RI;        // rows per thread
  constexpr int DC = Q / 16;        // decay-tile columns per thread
  constexpr int PC = P / 16;        // y columns per thread
  const int ti = t / 16, tc = t % 16;
  // (P x N) state update: p = tp + TPR r, n = tn + TNC k (P 64, N 128: 8 x 4 a thread)
  constexpr int TNC = N < 32 ? N : 32, TPR = NT / TNC;
  constexpr int SR = P / TPR, SK = N / TNC;
  static_assert(SR * TPR == P, "state rows are split evenly");
  const int tp = t / TNC, tn = t % TNC;

  const int nchunks = (L + Q - 1) / Q;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int l0 = ch * Q;
    // -- stage dt, B, C and x of the chunk; steps past L are zeros ------
    if (t < Q) {
      const int l = l0 + t;
      dts[t] = l < L ? ld(dtg + (size_t)l * H) : 0.f;
    }
    // each thread keeps one column (n, or pp of x) and walks the rows; the
    // trip counts are fixed and unrolled so that many loads are in flight
    // at once (one block per SM hides little latency)
#pragma unroll 8
    for (int k = 0; k < Q * N / NT; ++k) {
      const int i = t / N + k * (NT / N), n = t % N, l = l0 + i;
      bs[i * NS + n] = l < L ? ld(bg + l * bs_l + n) : 0.f;
      cs[i * CS + n] = l < L ? ld(cg + l * cs_l + n) : 0.f;
    }
#pragma unroll 8
    for (int k = 0; k < Q * P / NT; ++k) {
      const int i = t / P + k * (NT / P), pp = t % P, l = l0 + i;
      xdt[i * P + pp] = l < L ? ld(xg + l * xs_l + pp) : 0.f;
    }
    __syncthreads();
    // -- x * dt; warp 0 scans da = dt * a in fp64 ----------------------
    for (int e = t; e < Q * P; e += NT) xdt[e] *= dts[e / P];
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
    }
    __syncthreads();

    // -- carried-state term: acc = exp(cum_i) (C_i . state_p) -----------
    float acc[YR][PC];
#pragma unroll
    for (int r = 0; r < YR; ++r)
#pragma unroll
      for (int k = 0; k < PC; ++k) acc[r][k] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[YR], sv[PC];
#pragma unroll
      for (int r = 0; r < YR; ++r) cv[r] = cs[(ti + RI * r) * CS + n];
#pragma unroll
      for (int k = 0; k < PC; ++k) sv[k] = sts[(tc + 16 * k) * NS + n];
#pragma unroll
      for (int r = 0; r < YR; ++r)
#pragma unroll
        for (int k = 0; k < PC; ++k) acc[r][k] = fmaf(cv[r], sv[k], acc[r][k]);
    }
#pragma unroll
    for (int r = 0; r < YR; ++r) {
      const float e = ein[ti + RI * r];
#pragma unroll
      for (int k = 0; k < PC; ++k) acc[r][k] *= e;
    }

    // -- decay tile: (C_i . B_j) exp(cum_i - cum_j) for j <= i, else 0 --
    float dcy[YR][DC];
#pragma unroll
    for (int r = 0; r < YR; ++r)
#pragma unroll
      for (int k = 0; k < DC; ++k) dcy[r][k] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[YR], bv[DC];
#pragma unroll
      for (int r = 0; r < YR; ++r) cv[r] = cs[(ti + RI * r) * CS + n];
#pragma unroll
      for (int k = 0; k < DC; ++k) bv[k] = bs[(tc + 16 * k) * NS + n];
#pragma unroll
      for (int r = 0; r < YR; ++r)
#pragma unroll
        for (int k = 0; k < DC; ++k) dcy[r][k] = fmaf(cv[r], bv[k], dcy[r][k]);
    }
#pragma unroll
    for (int r = 0; r < YR; ++r) {
      const int i = ti + RI * r;
#pragma unroll
      for (int k = 0; k < DC; ++k) {
        const int j = tc + 16 * k;
        // mask first: the exp is taken only where j <= i
        dcy[r][k] = j <= i ? dcy[r][k] * expf((float)(cum[i] - cum[j])) : 0.f;
      }
    }
    __syncthreads();                // every read of C is done
#pragma unroll
    for (int r = 0; r < YR; ++r)
#pragma unroll
      for (int k = 0; k < DC; ++k) cs[(ti + RI * r) * CS + tc + 16 * k] = dcy[r][k];
    __syncthreads();

    // -- intra-chunk term: acc += decay_i . (x dt); write y -------------
    const int jmax = ti + RI * (YR - 1) + 1;   // past this thread's last row
    for (int j = 0; j < jmax; ++j) {
      float dv[YR], xv[PC];
#pragma unroll
      for (int r = 0; r < YR; ++r) dv[r] = cs[(ti + RI * r) * CS + j];
#pragma unroll
      for (int k = 0; k < PC; ++k) xv[k] = xdt[j * P + tc + 16 * k];
#pragma unroll
      for (int r = 0; r < YR; ++r)
#pragma unroll
        for (int k = 0; k < PC; ++k) acc[r][k] = fmaf(dv[r], xv[k], acc[r][k]);
    }
#pragma unroll
    for (int r = 0; r < YR; ++r) {
      const int l = l0 + ti + RI * r;
      if (l < L) {
        T* yrow = yg + (((size_t)bi * L + l) * H + h) * P;
#pragma unroll
        for (int k = 0; k < PC; ++k) store_f(yrow + tc + 16 * k, acc[r][k]);
      }
    }

    // -- state = exp(cum_last) state + sum_j wout_j (x dt)_j B_j^T --------
    {
      const float keep = expf((float)cum[Q - 1]);
      float sacc[SR][SK];
#pragma unroll
      for (int r = 0; r < SR; ++r)
#pragma unroll
        for (int k = 0; k < SK; ++k) sacc[r][k] = sts[(tp + TPR * r) * NS + tn + TNC * k] * keep;
#pragma unroll 4
      for (int j = 0; j < Q; ++j) {
        const float w = wout[j];
        float xv[SR], bv[SK];
#pragma unroll
        for (int r = 0; r < SR; ++r) xv[r] = xdt[j * P + tp + TPR * r];
#pragma unroll
        for (int k = 0; k < SK; ++k) bv[k] = bs[j * NS + tn + TNC * k] * w;
#pragma unroll
        for (int r = 0; r < SR; ++r)
#pragma unroll
          for (int k = 0; k < SK; ++k) sacc[r][k] = fmaf(xv[r], bv[k], sacc[r][k]);
      }
      // each thread rewrites only the state elements it read
#pragma unroll
      for (int r = 0; r < SR; ++r)
#pragma unroll
        for (int k = 0; k < SK; ++k) sts[(tp + TPR * r) * NS + tn + TNC * k] = sacc[r][k];
    }
    __syncthreads();                // before the next chunk restages
  }

  T* sg = static_cast<T*>(prm.state) + (size_t)bh * P * N;
  for (int e = t; e < P * N; e += NT) store_f(sg + e, sts[(e / N) * NS + e % N]);
}

template <int Q, int P_, int N_, typename T, typename TA, bool X>
int launch(const Params& p, const SsdExt& ext, int blocks, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<Q, P_, N_>();
  // above 48 KB the launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd<Q, P_, N_, T, TA, X>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_fwd<Q, P_, N_, T, TA, X><<<blocks, NT, smem, stream>>>(p, ext);
  return (int)cudaGetLastError();
}

template <int Q, int P_, int N_, typename T, typename TA>
int launch_x(const Params& p, const SsdExt& ext, bool x, int blocks, cudaStream_t stream) {
  return x ? launch<Q, P_, N_, T, TA, true>(p, ext, blocks, stream)
           : launch<Q, P_, N_, T, TA, false>(p, ext, blocks, stream);
}

template <int P_, int N_, typename T, typename TA>
int by_chunk(const Params& p, const SsdExt& ext, bool x, int blocks, int q,
             cudaStream_t stream) {
  switch (q) {
    case 32: return launch_x<32, P_, N_, T, TA>(p, ext, x, blocks, stream);
    case 64: return launch_x<64, P_, N_, T, TA>(p, ext, x, blocks, stream);
    case 128: return launch_x<128, P_, N_, T, TA>(p, ext, x, blocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int Q, typename TA, bool X>
int launch_bf16(const BfParams& p, const SsdExt& ext, const void* x, const void* b,
                const void* c, const long long* layout, int blocks, cudaStream_t stream) {
  CUtensorMap tm_x, tm_b, tm_c, tm_y;
  int err = encode(&tm_x, x, layout, Q);
  if (!err) err = encode(&tm_b, b, layout + 11, Q);
  if (!err) err = encode(&tm_c, c, layout + 22, Q);
  if (!err) err = encode(&tm_y, p.y, layout + 33, 64);
  if (err) return err;
  constexpr size_t smem = Tile<Q>::BYTES;
  static uint32_t opted = 0;   // a bit per device
  err = opt_in_smem(reinterpret_cast<const void*>(ssd_fwd_bf16<Q, TA, X>), smem, opted);
  if (err) return err;
  ssd_fwd_bf16<Q, TA, X><<<blocks, Tile<Q>::THREADS, smem, stream>>>(tm_x, tm_b, tm_c, tm_y, p,
                                                                     ext);
  return (int)cudaGetLastError();
}

template <int Q, typename TA>
int bf16_x(const BfParams& p, const SsdExt& ext, bool x_ext, const void* x, const void* b,
           const void* c, const long long* layout, int blocks, cudaStream_t stream) {
  return x_ext ? launch_bf16<Q, TA, true>(p, ext, x, b, c, layout, blocks, stream)
               : launch_bf16<Q, TA, false>(p, ext, x, b, c, layout, blocks, stream);
}

template <typename TA>
int bf16_by_chunk(const BfParams& p, const SsdExt& ext, bool x_ext, const void* x,
                  const void* b, const void* c, const long long* layout, int blocks, int q,
                  cudaStream_t stream) {
  switch (q) {
    case 64: return bf16_x<64, TA>(p, ext, x_ext, x, b, c, layout, blocks, stream);
    case 128: return bf16_x<128, TA>(p, ext, x_ext, x, b, c, layout, blocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, G, N), G =
// groups dividing H, head h reading group h / (H / G); state: (B, H, P,
// N).  x, b and c are read through their batch and step strides (xs_*,
// bs_*, cs_*, in elements), so they may be views of one wider tensor;
// each (H, P) row of x and each step's (G, N) row of b and c is
// contiguous.  s0: the initial state (B, H, P, N) contiguous, fp32 if
// s0_f32 else of x's type, or null (zero).  G > 1 or an s0 runs the X
// instantiations.  dt, a, y and state are contiguous.  x, dt, b, c, y, state
// are of one type (bf16 if is_bf16 else fp32), a bf16 if a_is_bf16 else
// fp32.  (P, N) is (64, 128), bf16 on the wgmma kernel, fp32 on the SIMT
// one (a fp32); or (16, 16), the SIMT kernel in either dtype.  q is the
// chunk: 64 or 128 on the wgmma kernel, 32, 64 or 128 on the SIMT one.
// layout: for the wgmma kernel, the TMA layouts of x (viewed as (B, L, H,
// P)), b and c (each viewed as (B, L, G, N)) with boxes of q rows, as
// kernels/ssd_scan.py:tma_layouts computes them, and of y with boxes of
// 64 rows, 11 values each; unused for the SIMT kernel.
// Returns cudaGetLastError() after the launch, or a negative code from
// encode().
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* b,
                            const void* c, void* y, void* state, int B, int L, int H,
                            int p_dim, int n_dim, int q, int is_bf16, int a_is_bf16,
                            long long xs_b, long long xs_l, long long bs_b, long long bs_l,
                            long long cs_b, long long cs_l, void* stream,
                            const long long* layout, const void* s0, int s0_f32, int groups) {
  if (B <= 0 || L <= 0 || H <= 0 || groups <= 0 || H % groups) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = B * H;
  Params sp{x, dt, a, b, c, y, state, L, H, xs_b, xs_l, bs_b, bs_l, cs_b, cs_l};
  const SsdExt ext{s0, nullptr, H / groups, s0_f32};
  const bool xe = groups > 1 || s0 != nullptr;
  if (p_dim == 16 && n_dim == 16) {   // the smoke config: SIMT in either dtype
    if (!is_bf16) return a_is_bf16 ? (int)cudaErrorInvalidValue
                                   : by_chunk<16, 16, float, float>(sp, ext, xe, blocks, q, st);
    if (a_is_bf16)
      return by_chunk<16, 16, __nv_bfloat16, __nv_bfloat16>(sp, ext, xe, blocks, q, st);
    return by_chunk<16, 16, __nv_bfloat16, float>(sp, ext, xe, blocks, q, st);
  }
  if (p_dim != P || n_dim != N) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    if (layout == nullptr) return (int)cudaErrorInvalidValue;
    BfParams p{dt, a, y, state, L, H};
    if (a_is_bf16)
      return bf16_by_chunk<__nv_bfloat16>(p, ext, xe, x, b, c, layout, blocks, q, st);
    return bf16_by_chunk<float>(p, ext, xe, x, b, c, layout, blocks, q, st);
  }
  if (!a_is_bf16) return by_chunk<P, N, float, float>(sp, ext, xe, blocks, q, st);
  return (int)cudaErrorInvalidValue;
}
