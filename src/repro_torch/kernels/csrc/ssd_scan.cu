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
// Steps past L are dt = 0 identities (exp(0) = 1, dt x = 0): they leave
// the state as it is, and their y is not written.  x, dt, b, c come in
// as bf16 or fp32 (all alike), a as x's type or fp32; all arithmetic is
// fp32, and y and the final state are written in x's type.
//
// What bounds it on the H100: at mamba2-780m's prefill (B 4, L 1024,
// H 48, P 64, N 128, Q 128, bf16) one launch must move about 56 MB (x and
// y 25.2 MB each, B and C 2.1 MB, the state 3.1 MB, dt 0.4 MB), 0.0167 ms
// at 3.35 TB/s.  The function needs 7.7 GFLOP (2 per MAC): per chunk C B^T
// on the causal pairs only, once for all heads (one B/C group), and per
// head the decay tile times x dt on the same pairs, C . state (none in the
// first chunk, whose carried state is zero) and the state update; that is
// 0.0078 ms at 989 TFLOP/s.  So bytes bound it, by 2x.
//
// What the design does about it, in this first, simple version:
//  * The TPU grid's sequential chunk axis becomes a loop inside one
//    thread block per (b, h), so the state never leaves the SM: it lives
//    in shared memory (32 KB fp32) from the first chunk to the last, and
//    only the final state is written.  Every input is read once, in
//    place (x, B and C through their strides, as views of the model's
//    conv output), and y is written once, so the kernel moves the bound's
//    bytes and no more.
//  * A chunk's B, C and x*dt are staged in shared memory as fp32 (about
//    196 KB at Q 128, hence the opt-in above 48 KB).  The Q x Q decay
//    tile (C B^T masked, then exp(cs_i - cs_j)) is built in registers and
//    written over C once C is no longer needed, so it costs no memory of
//    its own.  The mask comes before the exp: above the diagonal nothing
//    is exponentiated, so nothing overflows (the Pallas kernel takes the
//    exp of the whole tile first).
//  * The chunk's cumulative sum is one warp scan (__shfl_up_sync), taken
//    in fp64.  With this repo's init da reaches tens per step, so over a
//    chunk cs grows to about -1e3, and exp(cs_i - cs_j) of two fp32 sums
//    that large loses ~1e-4 of its value to cancellation, more the later
//    the step (the Pallas kernel and the jnp op do exactly that).  In fp64
//    the difference is exact to fp32, so the kernel agrees with the
//    step-by-step recurrence (decode, ssd_ref) at every position.
//  * The products are fp32 FMAs on the CUDA cores with register tiles of
//    up to 8 x 8 per thread, not the tensor cores.  So today the kernel
//    is bound by shared-memory loads and FMA throughput, far from its byte
//    bound.  Tensor-core products (mma/wgmma on bf16 tiles), cp.async or
//    TMA staging, chunk-parallel state passing and sharing C B^T across
//    heads (G = 1) are later work (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 64;         // head dim (mamba2-780m)
constexpr int N = 128;        // state dim
constexpr int NS = N + 1;     // padded row stride of B, C, the decay tile and the state
constexpr int NT = 256;       // threads per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

template <int Q>
constexpr size_t smem_bytes() {
  // the fp64 cumsum, then B, C/decay tile, x*dt, state, and three per-step vectors
  return sizeof(double) * Q +
         sizeof(float) * ((size_t)2 * Q * NS + (size_t)Q * P + (size_t)P * NS + 3 * Q);
}

template <int Q, typename T, typename TA>
__global__ void __launch_bounds__(NT) ssd_fwd(Params prm) {
  static_assert(Q % 32 == 0 && Q <= N && Q <= NT, "chunk must be 32, 64 or 128");
  extern __shared__ __align__(16) unsigned char smem[];
  double* cum = reinterpret_cast<double*>(smem);   // (Q,) cumsum of da within the chunk
  float* bs = reinterpret_cast<float*>(cum + Q);   // (Q, NS) B rows
  float* cs = bs + Q * NS;          // (Q, NS) C rows, then the decay tile
  float* xdt = cs + Q * NS;         // (Q, P) x * dt
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
  const T* bg = static_cast<const T*>(prm.b) + bi * prm.bs_b;
  const T* cg = static_cast<const T*>(prm.c) + bi * prm.cs_b;
  const long long xs_l = prm.xs_l, bs_l = prm.bs_l, cs_l = prm.cs_l;
  T* yg = static_cast<T*>(prm.y);
  const float a = ld(static_cast<const TA*>(prm.a) + h);

  for (int e = t; e < P * NS; e += NT) sts[e] = 0.f;

  // (Q x P) and (Q x Q) products: rows i = ti + RI r, columns tc + 16 k
  constexpr int RI = NT / 16;
  constexpr int YR = Q / RI;        // rows per thread
  constexpr int DC = Q / 16;        // decay-tile columns per thread
  const int ti = t / 16, tc = t % 16;
  // (P x N) state update: p = tp + 8 r, n = tn + 32 k
  const int tp = t / 32, tn = t % 32;

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
    static_assert(NT % N == 0 && NT % P == 0, "rows are split evenly");
#pragma unroll 8
    for (int k = 0; k < Q * N / NT; ++k) {
      const int i = t / N + k * (NT / N), n = t % N, l = l0 + i;
      bs[i * NS + n] = l < L ? ld(bg + l * bs_l + n) : 0.f;
      cs[i * NS + n] = l < L ? ld(cg + l * cs_l + n) : 0.f;
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
    float acc[YR][4];
#pragma unroll
    for (int r = 0; r < YR; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[YR], sv[4];
#pragma unroll
      for (int r = 0; r < YR; ++r) cv[r] = cs[(ti + RI * r) * NS + n];
#pragma unroll
      for (int k = 0; k < 4; ++k) sv[k] = sts[(tc + 16 * k) * NS + n];
#pragma unroll
      for (int r = 0; r < YR; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(cv[r], sv[k], acc[r][k]);
    }
#pragma unroll
    for (int r = 0; r < YR; ++r) {
      const float e = ein[ti + RI * r];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] *= e;
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
      for (int r = 0; r < YR; ++r) cv[r] = cs[(ti + RI * r) * NS + n];
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
      for (int k = 0; k < DC; ++k) cs[(ti + RI * r) * NS + tc + 16 * k] = dcy[r][k];
    __syncthreads();

    // -- intra-chunk term: acc += decay_i . (x dt); write y -------------
    const int jmax = ti + RI * (YR - 1) + 1;   // past this thread's last row
    for (int j = 0; j < jmax; ++j) {
      float dv[YR], xv[4];
#pragma unroll
      for (int r = 0; r < YR; ++r) dv[r] = cs[(ti + RI * r) * NS + j];
#pragma unroll
      for (int k = 0; k < 4; ++k) xv[k] = xdt[j * P + tc + 16 * k];
#pragma unroll
      for (int r = 0; r < YR; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(dv[r], xv[k], acc[r][k]);
    }
#pragma unroll
    for (int r = 0; r < YR; ++r) {
      const int l = l0 + ti + RI * r;
      if (l < L) {
        T* yrow = yg + (((size_t)bi * L + l) * H + h) * P;
#pragma unroll
        for (int k = 0; k < 4; ++k) st(yrow + tc + 16 * k, acc[r][k]);
      }
    }

    // -- state = exp(cum_last) state + sum_j wout_j (x dt)_j B_j^T --------
    {
      const float keep = expf((float)cum[Q - 1]);
      float sacc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) sacc[r][k] = sts[(tp + 8 * r) * NS + tn + 32 * k] * keep;
#pragma unroll 4
      for (int j = 0; j < Q; ++j) {
        const float w = wout[j];
        float xv[8], bv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) xv[r] = xdt[j * P + tp + 8 * r];
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[k] = bs[j * NS + tn + 32 * k] * w;
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) sacc[r][k] = fmaf(xv[r], bv[k], sacc[r][k]);
      }
      // each thread rewrites only the state elements it read
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) sts[(tp + 8 * r) * NS + tn + 32 * k] = sacc[r][k];
    }
    __syncthreads();                // before the next chunk restages
  }

  T* sg = static_cast<T*>(prm.state) + (size_t)bh * P * N;
  for (int e = t; e < P * N; e += NT) st(sg + e, sts[(e / N) * NS + e % N]);
}

template <int Q, typename T, typename TA>
int launch(const Params& p, int blocks, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<Q>();
  // above 48 KB the launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd<Q, T, TA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_fwd<Q, T, TA><<<blocks, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename TA>
int by_chunk(const Params& p, int blocks, int q, cudaStream_t stream) {
  switch (q) {
    case 32: return launch<32, T, TA>(p, blocks, stream);
    case 64: return launch<64, T, TA>(p, blocks, stream);
    case 128: return launch<128, T, TA>(p, blocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, N); state:
// (B, H, P, N).  x, b and c are read through their batch and step
// strides (xs_*, bs_*, cs_*, in elements), so they may be views of one
// wider tensor; each (H, P) row of x and each N row of b and c is
// contiguous.  dt, a, y and state are contiguous.  x, dt, b, c, y, state
// are of one type (bf16 if is_bf16 else fp32), a bf16 if a_is_bf16 else
// fp32.  q is the chunk (32, 64 or 128).  Returns cudaGetLastError()
// after the launch.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* b,
                            const void* c, void* y, void* state, int B, int L, int H,
                            int p_dim, int n_dim, int q, int is_bf16, int a_is_bf16,
                            long long xs_b, long long xs_l, long long bs_b, long long bs_l,
                            long long cs_b, long long cs_l, void* stream) {
  if (p_dim != P || n_dim != N || B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  Params p{x, dt, a, b, c, y, state, L, H, xs_b, xs_l, bs_b, bs_l, cs_b, cs_l};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = B * H;
  if (is_bf16 && a_is_bf16) return by_chunk<__nv_bfloat16, __nv_bfloat16>(p, blocks, q, st);
  if (is_bf16) return by_chunk<__nv_bfloat16, float>(p, blocks, q, st);
  if (!a_is_bf16) return by_chunk<float, float>(p, blocks, q, st);
  return (int)cudaErrorInvalidValue;
}
