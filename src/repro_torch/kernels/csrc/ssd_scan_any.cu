// Mamba-2 SSD chunked scan, forward and backward, on SIMT at any (P, N) up
// to (128, 256) and in bf16, fp16 or fp32: the general route
// (kernels/ssd_scan.py:route), for what the wgmma + TMA kernels do not take
// (fp16; fp32 and bf16 at (P, N) other than (64, 128) and (16, 16) that are
// not multiples of 8 inside (64, 128); P above 64 or N above 128).
//
// Replaces src/repro/kernels/ssd_scan.py:ssd_scan_kernel (the Pallas
// kernel, which takes any (P, N)) forward, and the autodiff of
// src/repro/models/ssm.py:ssd_scan backward, and computes what
// csrc/ssd_scan.cu and csrc/ssd_scan_bwd.cu compute (their headers give the
// formulas): chunks of Q steps, the in-chunk cumulative sum of dt a in
// fp64, decays exp(cs_i - cs_j) from the fp64 difference, masked before
// the exp, B/C groups (head h reads group h / (H / G)) and an optional
// initial state (x's dtype or fp32) and its gradient; steps past L are dt =
// 0 identities.  Deterministic, no atomics: dB, dC and da come per head,
// the launcher sums them in order.
//
// The function does not depend on the chunk, so both kernels take Q = 32.
// Every product is a plain loop over its depth, one output element a
// thread at a time, on fp32 operands staged in shared memory:
//  * forward (ssd_fwd_any): a block per (b, h, slice of PS rows of P).
//    The state's P rows are independent of one another, so a block carries
//    its slice of the fp32 state (PS x N) in shared memory from chunk to
//    chunk: at N 256, 107 KB with the chunk's B, C, x dt and decay tile.
//  * backward (ssd_bwd_any): a block per (b, h).  A first pass writes the
//    state entering each chunk to an fp32 scratch in device memory, then
//    the chunks are walked in reverse with dS (P x N) in a second fp32
//    scratch; the chunk's B, C, x, dy, the Q x Q tiles and du stay in
//    shared memory (179 KB at (128, 256)).
//
// What bounds it: fp32 FMAs and shared-memory loads, not bytes; this is
// the simple, exact route.  Shapes whose speed matters take the wgmma
// kernels (bf16 with P and N multiples of 8 inside (64, 128)).

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int Q = 32;      // steps a chunk
constexpr int QS = Q + 1;  // row stride of the Q x Q tiles
constexpr int PS = 32;     // forward: rows of P a block
constexpr int NT = 256;    // threads a block
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* x;       // (B, L, H, P), each (H, P) row contiguous, strides xs_*
  const void* dt;      // (B, L, H), contiguous
  const void* a;       // (H,)
  const void* b;       // (B, L, G, N), each step's (G, N) row contiguous, strides bs_*
  const void* c;       // likewise, strides cs_*
  const void* s0;      // (B, H, P, N) contiguous, or null: zero
  int s0_f32;          // s0 is fp32 (else of x's type)
  int L, H, P, N, hpg;  // hpg: heads a B/C group
  long long xs_b, xs_l, bs_b, bs_l, cs_b, cs_l;
  // forward
  void* y;             // (B, L, H, P), contiguous
  void* state;         // (B, H, P, N), contiguous
  // backward
  const void* dy;      // (B, L, H, P), contiguous
  const void* dstate;  // (B, H, P, N), contiguous, or null: zero
  void* dx;            // (B, L, H, P), contiguous
  void* ddt;           // (B, L, H), contiguous
  float* da_part;      // (B, H)
  float* db_part;      // (B, L, H, N)
  float* dc_part;      // (B, L, H, N)
  float* states;       // scratch (B H, chunks, P, N): the state entering each chunk
  float* dstates;      // scratch (B H, P, N): dS
  float* ds0;          // (B, H, P, N) fp32, s0's gradient, or null
};

template <typename T>
__device__ __forceinline__ float s0_at(const Params& p, size_t i) {
  return p.s0_f32 ? static_cast<const float*>(p.s0)[i] : to_f(static_cast<const T*>(p.s0)[i]);
}

// warp 0 (one step a lane): the chunk's cumsum of dt a in fp64 (cum),
// e^{cum} (ein), e^{cum_last - cum_j} (wout) and e^{cum_last} (keep)
__device__ __forceinline__ void scan(double* cum, const float* dts, float* ein, float* wout,
                                     float* keep, float a) {
  const int t = threadIdx.x;
  if (t >= 32) return;
  double incl = (double)(dts[t] * a);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(FULL, incl, off);
    if (t >= off) incl += o;
  }
  const double total = __shfl_sync(FULL, incl, 31);
  cum[t] = incl;
  ein[t] = expf((float)incl);
  wout[t] = expf((float)(total - incl));
  if (t == 0) *keep = expf((float)total);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
size_t fwd_smem(int n) {
  const int ns = n + 1;
  return sizeof(double) * Q +
         sizeof(float) * ((size_t)2 * Q * ns + (size_t)Q * (PS + 1) + (size_t)PS * ns +
                          (size_t)Q * QS + 3 * Q + 4);
}

template <typename T, typename TA>
__global__ void __launch_bounds__(NT) ssd_fwd_any(Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = prm.L, H = prm.H, P = prm.P, N = prm.N, NS = N + 1;
  double* cum = reinterpret_cast<double*>(smem);
  float* sB = reinterpret_cast<float*>(cum + Q);   // (Q, NS)
  float* sC = sB + Q * NS;                         // (Q, NS)
  float* sX = sC + Q * NS;                         // (Q, PS + 1): x dt of the slice's rows
  float* sS = sX + Q * (PS + 1);                   // (PS, NS): the slice's state
  float* sW = sS + PS * NS;                        // (Q, QS): the decay tile
  float* dts = sW + Q * QS;
  float* ein = dts + Q;
  float* wout = ein + Q;
  float* keep = wout + Q;

  const int bh = blockIdx.x, bi = bh / H, h = bh % H, t = threadIdx.x;
  const int p0 = blockIdx.y * PS, np = min(PS, P - p0);   // this block's rows of P
  const int grp = h / prm.hpg;
  const T* xg = static_cast<const T*>(prm.x) + bi * prm.xs_b + h * P + p0;
  const T* dtg = static_cast<const T*>(prm.dt) + (size_t)bi * L * H + h;
  const T* bg = static_cast<const T*>(prm.b) + bi * prm.bs_b + grp * N;
  const T* cg = static_cast<const T*>(prm.c) + bi * prm.cs_b + grp * N;
  T* yg = static_cast<T*>(prm.y) + (size_t)bi * L * H * P + h * P + p0;
  const float a = to_f(static_cast<const TA*>(prm.a)[h]);

  for (int e = t; e < PS * NS; e += NT) {   // the initial state, else zero
    const int r = e / NS, n = e % NS;
    sS[e] = prm.s0 != nullptr && r < np && n < N
                ? s0_at<T>(prm, ((size_t)bh * P + p0 + r) * N + n)
                : 0.f;
  }
  const int nchunks = (L + Q - 1) / Q;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int l0 = ch * Q;
    __syncthreads();   // the last chunk's reads are done
    if (t < Q) dts[t] = l0 + t < L ? to_f(dtg[(size_t)(l0 + t) * H]) : 0.f;
    for (int e = t; e < Q * N; e += NT) {
      const int i = e / N, n = e % N, l = l0 + i;
      sB[i * NS + n] = l < L ? to_f(bg[l * prm.bs_l + n]) : 0.f;
      sC[i * NS + n] = l < L ? to_f(cg[l * prm.cs_l + n]) : 0.f;
    }
    for (int e = t; e < Q * PS; e += NT) {
      const int i = e / PS, r = e % PS, l = l0 + i;
      sX[i * (PS + 1) + r] = l < L && r < np ? to_f(xg[l * prm.xs_l + r]) : 0.f;
    }
    __syncthreads();
    scan(cum, dts, ein, wout, keep, a);
    for (int e = t; e < Q * PS; e += NT) sX[(e / PS) * (PS + 1) + e % PS] *= dts[e / PS];
    __syncthreads();
    // the decay tile: (C_i . B_j) e^{cum_i - cum_j} on j <= i, masked before the exp
    for (int e = t; e < Q * Q; e += NT) {
      const int i = e / Q, j = e % Q;
      float acc = 0.f;
      if (j <= i) {
        for (int n = 0; n < N; ++n) acc = fmaf(sC[i * NS + n], sB[j * NS + n], acc);
        acc *= expf((float)(cum[i] - cum[j]));
      }
      sW[i * QS + j] = acc;
    }
    __syncthreads();
    // y = e^{cum_i} C_i . state + sum_{j <= i} decay_ij x_j dt_j
    for (int e = t; e < Q * np; e += NT) {
      const int i = e / np, r = e % np, l = l0 + i;
      float carried = 0.f, intra = 0.f;
      for (int n = 0; n < N; ++n) carried = fmaf(sC[i * NS + n], sS[r * NS + n], carried);
      for (int j = 0; j <= i; ++j) intra = fmaf(sW[i * QS + j], sX[j * (PS + 1) + r], intra);
      if (l < L) store_f(yg + (size_t)l * H * P + r, ein[i] * carried + intra);
    }
    __syncthreads();
    // state = e^{cum_last} state + sum_j wout_j (x dt)_j B_j^T: own elements only
    const float kp = *keep;
    for (int e = t; e < np * N; e += NT) {
      const int r = e / N, n = e % N;
      float acc = 0.f;
      for (int j = 0; j < Q; ++j) acc = fmaf(wout[j] * sX[j * (PS + 1) + r], sB[j * NS + n], acc);
      sS[r * NS + n] = kp * sS[r * NS + n] + acc;
    }
  }
  __syncthreads();
  T* sg = static_cast<T*>(prm.state) + ((size_t)bh * P + p0) * N;
  for (int e = t; e < np * N; e += NT) store_f(sg + e, sS[(e / N) * NS + e % N]);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
size_t bwd_smem(int p, int n) {
  const size_t ns = n + 1, pss = p + 1;
  return sizeof(double) * Q +
         sizeof(float) * (2 * Q * ns + 2 * Q * pss + 3 * (size_t)Q * QS + 2 * Q * pss +
                          Q * ns + 8 * Q + NT + 4);
}

template <typename T, typename TA>
__global__ void __launch_bounds__(NT) ssd_bwd_any(Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = prm.L, H = prm.H, P = prm.P, N = prm.N, NS = N + 1, PSS = P + 1;
  double* cum = reinterpret_cast<double*>(smem);
  float* sB = reinterpret_cast<float*>(cum + Q);   // (Q, NS)
  float* sC = sB + Q * NS;                         // (Q, NS)
  float* sX = sC + Q * NS;                         // (Q, PSS)
  float* sDY = sX + Q * PSS;                       // (Q, PSS)
  float* sW = sDY + Q * PSS;                       // (Q, QS) (C_i . B_j) e^{cs_i - cs_j}, j <= i
  float* sV = sW + Q * QS;                         // (Q, QS) e^{cs_i - cs_j} dY_ij
  float* sQV = sV + Q * QS;                        // (Q, QS) W_ij dY_ij
  float* sDU = sQV + Q * QS;                       // (Q, PSS) du
  float* sT2 = sDU + Q * PSS;                      // (Q, PSS) dS' B_j
  float* sTmp = sT2 + Q * PSS;                     // (Q, NS) C_i e^{cs_i} (dy_i S)
  float* dts = sTmp + Q * NS;
  float* ein = dts + Q;
  float* wout = ein + Q;
  float* rowq = wout + Q;
  float* colq = rowq + Q;
  float* xdu = colq + Q;
  float* tdot = xdu + Q;
  float* rdot = tdot + Q;
  float* blk = rdot + Q;                           // (NT,) shares of <dS', S>
  float* keep = blk + NT;

  const int bh = blockIdx.x, bi = bh / H, h = bh % H, t = threadIdx.x;
  const int ntiles = (L + Q - 1) / Q;
  const int grp = h / prm.hpg;
  const size_t PN = (size_t)P * N;
  const T* xg = static_cast<const T*>(prm.x) + bi * prm.xs_b + h * P;
  const T* dtg = static_cast<const T*>(prm.dt) + (size_t)bi * L * H + h;
  const T* bg = static_cast<const T*>(prm.b) + bi * prm.bs_b + grp * N;
  const T* cg = static_cast<const T*>(prm.c) + bi * prm.cs_b + grp * N;
  const T* dyg = static_cast<const T*>(prm.dy) + (size_t)bi * L * H * P + h * P;
  T* dxg = static_cast<T*>(prm.dx) + (size_t)bi * L * H * P + h * P;
  T* ddtg = static_cast<T*>(prm.ddt) + (size_t)bi * L * H + h;
  float* dbg = prm.db_part + ((size_t)bi * L * H + h) * N;
  float* dcg = prm.dc_part + ((size_t)bi * L * H + h) * N;
  float* stg = prm.states + (size_t)bh * ntiles * PN;
  float* dS = prm.dstates + (size_t)bh * PN;
  const float a = to_f(static_cast<const TA*>(prm.a)[h]);

  auto load_bx = [&](int l0) {   // the chunk's B, x and dt; zeros past L
    for (int e = t; e < Q * N; e += NT) {
      const int i = e / N, n = e % N, l = l0 + i;
      sB[i * NS + n] = l < L ? to_f(bg[l * prm.bs_l + n]) : 0.f;
    }
    for (int e = t; e < Q * P; e += NT) {
      const int i = e / P, r = e % P, l = l0 + i;
      sX[i * PSS + r] = l < L ? to_f(xg[l * prm.xs_l + r]) : 0.f;
    }
    if (t < Q) dts[t] = l0 + t < L ? to_f(dtg[(size_t)(l0 + t) * H]) : 0.f;
  };

  // -- pass 1: the state entering each chunk, into the scratch -------------
  for (size_t e = t; e < PN; e += NT)
    stg[e] = prm.s0 != nullptr ? s0_at<T>(prm, (size_t)bh * PN + e) : 0.f;
  for (int tile = 0; tile + 1 < ntiles; ++tile) {
    __syncthreads();
    load_bx(tile * Q);
    __syncthreads();
    scan(cum, dts, ein, wout, keep, a);
    __syncthreads();
    for (int e = t; e < Q * P; e += NT) {   // x_j e^{cs_last - cs_j} dt_j, in place
      const int j = e / P;
      sX[j * PSS + e % P] *= wout[j] * dts[j];
    }
    __syncthreads();
    const float kp = *keep;
    const float* s_in = stg + (size_t)tile * PN;
    float* s_out = stg + (size_t)(tile + 1) * PN;
    for (int e = t; e < P * N; e += NT) {
      const int r = e / N, n = e % N;
      float acc = 0.f;
      for (int j = 0; j < Q; ++j) acc = fmaf(sX[j * PSS + r], sB[j * NS + n], acc);
      s_out[e] = kp * s_in[e] + acc;
    }
  }

  // -- pass 2: the chunks in reverse, dS carried back -----------------------
  const T* dsg = static_cast<const T*>(prm.dstate);
  for (size_t e = t; e < PN; e += NT) dS[e] = dsg != nullptr ? to_f(dsg[(size_t)bh * PN + e]) : 0.f;
  double da_acc = 0.0;   // thread 0: sum_k dt_k dda_k
  for (int tile = ntiles - 1; tile >= 0; --tile) {
    const int l0 = tile * Q;
    const float* S = stg + (size_t)tile * PN;
    __syncthreads();   // the last tile's reads are done, and dS and the states written
    load_bx(l0);
    for (int e = t; e < Q * N; e += NT) {
      const int i = e / N, n = e % N, l = l0 + i;
      sC[i * NS + n] = l < L ? to_f(cg[l * prm.cs_l + n]) : 0.f;
    }
    for (int e = t; e < Q * P; e += NT) {
      const int i = e / P, r = e % P, l = l0 + i;
      sDY[i * PSS + r] = l < L ? to_f(dyg[(size_t)l * H * P + r]) : 0.f;
    }
    __syncthreads();
    scan(cum, dts, ein, wout, keep, a);
    __syncthreads();
    // W = (C B^T) e^{cs_i - cs_j} on j <= i
    for (int e = t; e < Q * Q; e += NT) {
      const int i = e / Q, j = e % Q;
      float acc = 0.f;
      if (j <= i) {
        for (int n = 0; n < N; ++n) acc = fmaf(sC[i * NS + n], sB[j * NS + n], acc);
        acc *= expf((float)(cum[i] - cum[j]));
      }
      sW[i * QS + j] = acc;
    }
    __syncthreads();
    // dY = dt_j (dy_i . x_j); V = e^{cs_i - cs_j} dY; W dY, on j <= i
    for (int e = t; e < Q * Q; e += NT) {
      const int i = e / Q, j = e % Q;
      float v = 0.f, qv = 0.f;
      if (j <= i) {
        float acc = 0.f;
        for (int r = 0; r < P; ++r) acc = fmaf(sDY[i * PSS + r], sX[j * PSS + r], acc);
        const float dyv = dts[j] * acc;
        v = dyv * expf((float)(cum[i] - cum[j]));
        qv = sW[i * QS + j] * dyv;
      }
      sV[i * QS + j] = v;
      sQV[i * QS + j] = qv;
    }
    __syncthreads();
    if (t < Q) {
      float r = 0.f, c = 0.f;
      for (int k = 0; k < Q; ++k) {
        r += sQV[t * QS + k];
        c += sQV[k * QS + t];
      }
      rowq[t] = r;
      colq[t] = c;
    }
    // du = W^T dy + e^{cs_last - cs_j} dS' B_j; dx = dt du
    for (int e = t; e < Q * P; e += NT) {
      const int j = e / P, r = e % P, l = l0 + j;
      float a1 = 0.f, a2 = 0.f;
      for (int i = j; i < Q; ++i) a1 = fmaf(sW[i * QS + j], sDY[i * PSS + r], a1);
      for (int n = 0; n < N; ++n) a2 = fmaf(sB[j * NS + n], dS[(size_t)r * N + n], a2);
      const float du = a1 + wout[j] * a2;
      sDU[j * PSS + r] = du;
      sT2[j * PSS + r] = a2;
      if (l < L) store_f(dxg + (size_t)l * H * P + r, dts[j] * du);
    }
    // dC = V B + e^{cs_i} dy S, and C . (e^{cs_i} dy S) per step
    for (int e = t; e < Q * N; e += NT) {
      const int i = e / N, n = e % N, l = l0 + i;
      float a1 = 0.f, a2 = 0.f;
      for (int j = 0; j <= i; ++j) a1 = fmaf(sV[i * QS + j], sB[j * NS + n], a1);
      for (int r = 0; r < P; ++r) a2 = fmaf(sDY[i * PSS + r], S[(size_t)r * N + n], a2);
      const float carried = ein[i] * a2;
      sTmp[i * NS + n] = sC[i * NS + n] * carried;
      if (l < L) dcg[(size_t)l * H * N + n] = a1 + carried;
    }
    // dB = V^T C + e^{cs_last - cs_j} dt_j x dS'
    for (int e = t; e < Q * N; e += NT) {
      const int j = e / N, n = e % N, l = l0 + j;
      float a1 = 0.f, a2 = 0.f;
      for (int i = j; i < Q; ++i) a1 = fmaf(sV[i * QS + j], sC[i * NS + n], a1);
      for (int r = 0; r < P; ++r) a2 = fmaf(sX[j * PSS + r], dS[(size_t)r * N + n], a2);
      if (l < L) dbg[(size_t)l * H * N + n] = a1 + wout[j] * dts[j] * a2;
    }
    __syncthreads();   // every read of dS' is done
    if (t < Q) {
      float px = 0.f, pt = 0.f, pr = 0.f;
      for (int r = 0; r < P; ++r) {
        px += sX[t * PSS + r] * sDU[t * PSS + r];
        pt += sX[t * PSS + r] * sT2[t * PSS + r];
      }
      for (int n = 0; n < N; ++n) pr += sTmp[t * NS + n];
      xdu[t] = px;
      tdot[t] = wout[t] * dts[t] * pt;
      rdot[t] = pr;
    }
    // <dS', S>; dS = e^{cs_last} dS' + dy^T (e^{cs} C): own elements only
    {
      const float kp = *keep;
      float part = 0.f;
      for (int e = t; e < P * N; e += NT) {
        const int r = e / N, n = e % N;
        const float d = dS[e];
        part += d * S[e];
        float acc = 0.f;
        for (int i = 0; i < Q; ++i) acc = fmaf(sDY[i * PSS + r], ein[i] * sC[i * NS + n], acc);
        dS[e] = kp * d + acc;
      }
      blk[t] = part;
    }
    __syncthreads();
    // thread 0: dcs per step, dda = its reverse cumsum, ddt and da
    if (t == 0) {
      double sdot = 0.0, tsum = 0.0, run = 0.0;
      for (int k = 0; k < NT; ++k) sdot += blk[k];
      for (int j = 0; j < Q; ++j) tsum += tdot[j];
      for (int k = Q - 1; k >= 0; --k) {
        double dcs = (double)rowq[k] - colq[k] + rdot[k] - tdot[k];
        if (k == Q - 1) dcs += tsum + (double)*keep * sdot;
        run += dcs;   // dda_k = sum_{i >= k} dcs_i
        if (l0 + k < L) store_f(ddtg + (size_t)(l0 + k) * H, (float)(xdu[k] + a * run));
        da_acc += (double)dts[k] * run;
      }
    }
  }
  __syncthreads();
  if (t == 0) prm.da_part[bh] = (float)da_acc;
  if (prm.ds0 != nullptr)   // dS carried back past the first chunk: s0's gradient
    for (size_t e = t; e < PN; e += NT) prm.ds0[(size_t)bh * PN + e] = dS[e];
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
constexpr size_t MAX_SMEM = 232448;   // what a block may take on the H100

template <typename T, typename TA>
int launch_fwd(const Params& p, int B, cudaStream_t stream) {
  static uint32_t opted = 0;   // a bit per device
  int err = opt_in_smem(reinterpret_cast<const void*>(ssd_fwd_any<T, TA>), MAX_SMEM, opted);
  if (err) return err;
  const size_t smem = fwd_smem(p.N);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  ssd_fwd_any<T, TA><<<dim3(B * p.H, (p.P + PS - 1) / PS), NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename TA>
int launch_bwd(const Params& p, int B, cudaStream_t stream) {
  static uint32_t opted = 0;   // a bit per device
  int err = opt_in_smem(reinterpret_cast<const void*>(ssd_bwd_any<T, TA>), MAX_SMEM, opted);
  if (err) return err;
  const size_t smem = bwd_smem(p.P, p.N);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  ssd_bwd_any<T, TA><<<B * p.H, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// by dtype (0 fp32, 1 bf16, 2 fp16) and a's (fp32, or x's)
template <template <typename, typename> class F>
int by_dtype(const Params& p, int B, int dtype, int a_f32, cudaStream_t st) {
  if (dtype == 0) return a_f32 ? F<float, float>::run(p, B, st) : (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return a_f32 ? F<__nv_bfloat16, float>::run(p, B, st)
                 : F<__nv_bfloat16, __nv_bfloat16>::run(p, B, st);
  if (dtype == 2) return a_f32 ? F<__half, float>::run(p, B, st) : F<__half, __half>::run(p, B, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename TA>
struct Fwd {
  static int run(const Params& p, int B, cudaStream_t st) { return launch_fwd<T, TA>(p, B, st); }
};
template <typename T, typename TA>
struct Bwd {
  static int run(const Params& p, int B, cudaStream_t st) { return launch_bwd<T, TA>(p, B, st); }
};

bool takes(int B, int L, int H, int P, int N, int groups) {
  return B > 0 && L > 0 && H > 0 && groups > 0 && H % groups == 0 && P > 0 && N > 0 &&
         P <= 128 && N <= 256;
}

}  // namespace

// x, y: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, G, N) (x, b, c
// through their batch and step strides, in elements; an (H, P) row of x
// and a step's (G, N) row of b and c contiguous); state: (B, H, P, N); s0
// the initial state (B, H, P, N) contiguous, fp32 if s0_f32 else of x's
// type, or null.  dtype: 0 fp32, 1 bf16, 2 fp16, of x, dt, b, c, y and the
// state; a_f32: a is fp32, else of x's type.  P <= 128, N <= 256.
extern "C" int ssd_scan_fwd_any(const void* x, const void* dt, const void* a, const void* b,
                                const void* c, void* y, void* state, int B, int L, int H,
                                int p_dim, int n_dim, int dtype, int a_f32, long long xs_b,
                                long long xs_l, long long bs_b, long long bs_l, long long cs_b,
                                long long cs_l, void* stream, const void* s0, int s0_f32,
                                int groups) {
  if (!takes(B, L, H, p_dim, n_dim, groups)) return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = x, p.dt = dt, p.a = a, p.b = b, p.c = c, p.s0 = s0, p.s0_f32 = s0_f32;
  p.L = L, p.H = H, p.P = p_dim, p.N = n_dim, p.hpg = H / groups;
  p.xs_b = xs_b, p.xs_l = xs_l, p.bs_b = bs_b, p.bs_l = bs_l, p.cs_b = cs_b, p.cs_l = cs_l;
  p.y = y, p.state = state;
  return by_dtype<Fwd>(p, B, dtype, a_f32, static_cast<cudaStream_t>(stream));
}

// The gradient: as ssd_scan_fwd_any's inputs, with dy, dx (B, L, H, P)
// contiguous; dstate (B, H, P, N) contiguous or null; ddt (B, L, H); the
// fp32 outputs da_part (B, H), db_part and dc_part (B, L, H, N), each
// head's shares, which the caller sums; ds0 (B, H, P, N) fp32 where s0 is
// given.  Scratch: states (B H, ceil(L / 32), P, N) and dstates (B H, P,
// N), fp32.
extern "C" int ssd_scan_bwd_any(const void* x, const void* dt, const void* a, const void* b,
                                const void* c, const void* dy, const void* dstate, void* dx,
                                void* ddt, float* da_part, float* db_part, float* dc_part,
                                float* states, float* dstates, int B, int L, int H, int p_dim,
                                int n_dim, int dtype, int a_f32, long long xs_b, long long xs_l,
                                long long bs_b, long long bs_l, long long cs_b, long long cs_l,
                                void* stream, const void* s0, float* ds0, int s0_f32,
                                int groups) {
  if (!takes(B, L, H, p_dim, n_dim, groups)) return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = x, p.dt = dt, p.a = a, p.b = b, p.c = c, p.s0 = s0, p.s0_f32 = s0_f32;
  p.L = L, p.H = H, p.P = p_dim, p.N = n_dim, p.hpg = H / groups;
  p.xs_b = xs_b, p.xs_l = xs_l, p.bs_b = bs_b, p.bs_l = bs_l, p.cs_b = cs_b, p.cs_l = cs_l;
  p.dy = dy, p.dstate = dstate, p.dx = dx, p.ddt = ddt, p.da_part = da_part;
  p.db_part = db_part, p.dc_part = dc_part, p.states = states, p.dstates = dstates, p.ds0 = ds0;
  return by_dtype<Bwd>(p, B, dtype, a_f32, static_cast<cudaStream_t>(stream));
}
