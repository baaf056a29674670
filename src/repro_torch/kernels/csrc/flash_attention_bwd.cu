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
//   flash_bwd_dq    grid (q tiles, B*H):  Delta = rowsum(dO * O), stored for
//                   the second kernel; over the kv tiles dP = dO V^T,
//                   dS = P * (dP - Delta), dQ += dS K / sqrt(D)
//   flash_bwd_dkdv  grid (kv tiles, B*KV): over the q heads of the kv head's
//                   GQA group and their q tiles dV += P^T dO,
//                   dK += dS^T Q / sqrt(D), so the group's sum is taken in
//                   the block and needs no second reduction
//
// What bounds it on the H100: the tensor cores.  The gradient needs five
// products over the visible pairs (q k, dO v, P^T dO, dS k, dS^T q): at
// granite-3-2b's training shape (B 4, S 1024, H 32, KV 8, D 64, bf16,
// causal) 43 GFLOP, 0.044 ms at 989 TFLOP/s, against 84 MB of q, k, v, o,
// dO, lse and the three gradients, 0.025 ms at 3.35 TB/s.  The split does
// seven (each kernel recomputes q k and dO v), the price of no atomics.
//
// What this first design does about it: the products run on the tensor
// cores as mma.sync m16n8k16 (bf16 in, fp32 accumulate), four warps of 16
// rows a block, tiles of 64 rows staged through padded shared memory with
// 16-byte loads; the products that sum over a tile's rows read transposed
// copies (K^T for dQ, Q^T and dO^T for dK and dV).  P and dS are rounded to
// bf16 as the A operands of their products, as the forward rounds P.
// Gradients accumulate in fp32 registers and are written once in the
// inputs' dtype.  wgmma, TMA and a pipelined ring are later work.
// fp32 inputs take SIMT kernels, one warp a row, exact in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BM = 64;    // q rows: of a dq block, of a q tile in the dkdv kernel
constexpr int BN = 64;    // kv rows: of a kv tile in the dq kernel, of a dkdv block
constexpr int NT = 128;   // bf16 blocks: 4 warps of 16 rows
constexpr int WR = 8;     // fp32 blocks: 8 warps, one row each
constexpr int TN = 32;    // fp32 kernels: rows of a staged tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;       // (B, H, S), natural log
  void* dq;
  void* dk;
  void* dv;
  float* delta;           // (B, H, S) scratch: rowsum(dO * O)
  int B, S, Sk, H, KV;
  int causal, window;
  float scale;            // 1 / sqrt(D)
  float scale_log2;       // log2(e) / sqrt(D): scores in base 2
};

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  bool ok = kpos < p.Sk && qpos < p.S;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window) ok = ok && kpos > qpos - p.window;
  return ok;
}

// kv rows [lo, hi) that some q row of [q0, q0 + rows) sees
__device__ __forceinline__ void kv_range(const Params& p, int q0, int rows, int& lo, int& hi) {
  hi = p.causal ? min(p.Sk, q0 + rows) : p.Sk;            // k <= q
  lo = p.window ? max(0, q0 - p.window + 1) : 0;          // k > q - window
}

// q rows [lo, hi) that see some kv row of [k0, k0 + rows)
__device__ __forceinline__ void q_range(const Params& p, int k0, int rows, int& lo, int& hi) {
  lo = p.causal ? k0 : 0;                                         // q >= k
  hi = p.window ? min(p.S, k0 + rows - 1 + p.window) : p.S;       // q < k + window
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [r0, r0 + ROWS) of one head of a (B, L, heads, D) tensor (base at
// that head, `stride` elements between positions) into a [ROWS][D + 8]
// tile; rows past L are zero
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, size_t stride, int r0,
                                          int L) {
  constexpr int CH = D / 8, DP = D + 8;
  for (int c = threadIdx.x; c < ROWS * CH; c += blockDim.x) {
    const int r = c / CH, cc = c % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L) val = *reinterpret_cast<const uint4*>(base + (size_t)(r0 + r) * stride + cc * 8);
    *reinterpret_cast<uint4*>(dst + r * DP + cc * 8) = val;
  }
}

// the same rows transposed into a [D][ROWS + 8] tile
template <int D, int ROWS>
__device__ __forceinline__ void load_rows_t(bf16* dst, const bf16* base, size_t stride, int r0,
                                            int L) {
  constexpr int CH = D / 8, NP = ROWS + 8;
  for (int c = threadIdx.x; c < ROWS * CH; c += blockDim.x) {
    const int r = c % ROWS, cc = c / ROWS;   // lanes walk rows: conflict-free stores
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L) val = *reinterpret_cast<const uint4*>(base + (size_t)(r0 + r) * stride + cc * 8);
    const uint32_t w[4] = {val.x, val.y, val.z, val.w};
    uint16_t* col = reinterpret_cast<uint16_t*>(dst) + (cc * 8) * NP + r;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      col[i * NP] = static_cast<uint16_t>((i & 1) ? (w[i / 2] >> 16) : (w[i / 2] & 0xffffu));
  }
}

// the A fragment of k-step kk from rows r0, r0 + 8 of a [rows][P] tile
template <int P>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile, int r0, int kk, int t4) {
  const bf16* x = tile + r0 * P + kk * 16 + t4 * 2;
  a[0] = ld32(x);
  a[1] = ld32(x + 8 * P);
  a[2] = ld32(x + 8);
  a[3] = ld32(x + 8 * P + 8);
}

// c[nt] = A (the warp's 16 rows of `a`, K = D) times B^T (rows nt*8.. of `bt`)
template <int D, int NCOL>
__device__ __forceinline__ void product_abt(float (&c)[NCOL / 8][4], const bf16* a, int r0,
                                            const bf16* bt, int g, int t4) {
  constexpr int DP = D + 8;
#pragma unroll
  for (int nt = 0; nt < NCOL / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    frag_a<DP>(af, a, r0, kk, t4);
#pragma unroll
    for (int nt = 0; nt < NCOL / 8; ++nt) {
      const bf16* y = bt + (nt * 8 + g) * DP + kk * 16 + t4 * 2;
      mma_bf16(c[nt], af, ld32(y), ld32(y + 8));
    }
  }
}

// acc[dt] += A (packed 16 x K fragments) times the [D][K + 8] transposed tile
template <int D, int K>
__device__ __forceinline__ void product_at(float (&acc)[D / 8][4], const uint32_t (&af)[K / 16][4],
                                           const bf16* t, int g, int t4) {
  constexpr int KP = K + 8;
#pragma unroll
  for (int j = 0; j < K / 16; ++j)
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const bf16* y = t + (dt * 8 + g) * KP + j * 16 + t4 * 2;
      mma_bf16(acc[dt], af[j], ld32(y), ld32(y + 8));
    }
}

// the accumulator rows r, r + 8 of a (B, L, heads, D) tensor, times `scale`
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, size_t stride, int row0, int L,
                                           const float (&acc)[D / 8][4], float scale, int t4) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if (row0 < L)
      *reinterpret_cast<__nv_bfloat162*>(base + (size_t)row0 * stride + col) =
          __floats2bfloat162_rn(acc[dt][0] * scale, acc[dt][1] * scale);
    if (row0 + 8 < L)
      *reinterpret_cast<__nv_bfloat162*>(base + (size_t)(row0 + 8) * stride + col) =
          __floats2bfloat162_rn(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

template <int D>
struct BwdSmem {
  static constexpr int DP = D + 8;
  // dq: Q, dO, K, V as [64][DP], K^T as [D][BN + 8]
  static constexpr size_t DQ = (size_t)(4 * 64 * DP + D * (BN + 8)) * sizeof(bf16);
  // dkdv: K, V, Q, dO as [64][DP], Q^T and dO^T as [D][BM + 8], lse and Delta of a q tile
  static constexpr size_t DKDV =
      (size_t)(4 * 64 * DP + 2 * D * (BM + 8)) * sizeof(bf16) + 2 * BM * sizeof(float);
};

// ---------------------------------------------------------------------------
// bf16: mma.sync, 4 warps x 16 rows
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_bf16(Params p) {
  constexpr int DP = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);   // [BM][DP]
  bf16* sdO = sQ + BM * DP;                     // [BM][DP]
  bf16* sK = sdO + BM * DP;                     // [BN][DP]
  bf16* sV = sK + BN * DP;                      // [BN][DP]
  bf16* sKt = sV + BN * DP;                     // [D][BN + 8]

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t q_stride = (size_t)p.H * D, kv_stride = (size_t)p.KV * D;
  const size_t q_off = ((size_t)b * p.S * p.H + h) * D;
  const size_t kv_off = ((size_t)b * p.Sk * p.KV + kvh) * D;
  const bf16* qb = static_cast<const bf16*>(p.q) + q_off;
  const bf16* ob = static_cast<const bf16*>(p.o) + q_off;
  const bf16* dob = static_cast<const bf16*>(p.dout) + q_off;
  const bf16* kb = static_cast<const bf16*>(p.k) + kv_off;
  const bf16* vb = static_cast<const bf16*>(p.v) + kv_off;
  const size_t row_off = ((size_t)b * p.H + h) * p.S;   // into lse and delta

  load_rows<D, BM>(sQ, qb, q_stride, q0, p.S);
  load_rows<D, BM>(sdO, dob, q_stride, q0, p.S);

  // Delta of the warp's 16 rows: lanes split the row, then a warp sum
  const int r0 = warp * 16 + g;               // this thread's rows in the tile: r0, r0 + 8
  const int row0 = q0 + r0, row1 = row0 + 8;
  float d0 = 0.f, d1 = 0.f;
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    float acc = 0.f;
    if (row < p.S)
      for (int d = lane; d < D; d += 32)
        acc += __bfloat162float(ob[(size_t)row * q_stride + d]) *
               __bfloat162float(dob[(size_t)row * q_stride + d]);
    acc = warp_sum(acc);
    if (row < p.S && lane == 0) p.delta[row_off + row] = acc;
    if (r == g) d0 = acc;
    if (r == g + 8) d1 = acc;
  }
  const float l0 = row0 < p.S ? p.lse[row_off + row0] * LOG2E : 0.f;
  const float l1 = row1 < p.S ? p.lse[row_off + row1] * LOG2E : 0.f;
  const float sl = p.scale_log2;

  float dq[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dt][e] = 0.f;

  int lo, hi;
  kv_range(p, q0, BM, lo, hi);
  for (int k0 = (lo / BN) * BN; k0 < hi; k0 += BN) {
    __syncthreads();   // the previous tile is consumed (and Q, dO are written)
    load_rows<D, BN>(sK, kb, kv_stride, k0, p.Sk);
    load_rows<D, BN>(sV, vb, kv_stride, k0, p.Sk);
    load_rows_t<D, BN>(sKt, kb, kv_stride, k0, p.Sk);
    __syncthreads();

    float s[BN / 8][4], dp[BN / 8][4];
    product_abt<D, BN>(s, sQ, r0, sK, g, t4);     // S = Q K^T
    product_abt<D, BN>(dp, sdO, r0, sV, g, t4);   // dP = dO V^T
    // dS as the A operand of dS K: 8-column blocks 2j and 2j+1 form k-step j
    uint32_t dsf[BN / 16][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + nt * 8 + t4 * 2 + (e & 1);
        const bool top = e < 2;
        const float pe = visible(p, top ? row0 : row1, kpos)
                             ? exp2f(fmaf(s[nt][e], sl, -(top ? l0 : l1))) : 0.f;
        ds[e] = pe * (dp[nt][e] - (top ? d0 : d1));
      }
      dsf[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    product_at<D, BN>(dq, dsf, sKt, g, t4);      // dQ += dS K
  }
  store_rows<D>(static_cast<bf16*>(p.dq) + q_off, q_stride, row0, p.S, dq, p.scale, t4);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_bf16(Params p) {
  constexpr int DP = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);   // [BN][DP]
  bf16* sV = sK + BN * DP;                      // [BN][DP]
  bf16* sQ = sV + BN * DP;                      // [BM][DP]
  bf16* sdO = sQ + BM * DP;                     // [BM][DP]
  bf16* sQt = sdO + BM * DP;                    // [D][BM + 8]
  bf16* sdOt = sQt + D * (BM + 8);              // [D][BM + 8]
  float* sL = reinterpret_cast<float*>(sdOt + D * (BM + 8));   // [BM] lse, base 2
  float* sDl = sL + BM;                                         // [BM] Delta

  const int bk = blockIdx.y;
  const int b = bk / p.KV, kvh = bk % p.KV;
  const int group = p.H / p.KV;
  const int k0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t q_stride = (size_t)p.H * D, kv_stride = (size_t)p.KV * D;
  const size_t kv_off = ((size_t)b * p.Sk * p.KV + kvh) * D;
  load_rows<D, BN>(sK, static_cast<const bf16*>(p.k) + kv_off, kv_stride, k0, p.Sk);
  load_rows<D, BN>(sV, static_cast<const bf16*>(p.v) + kv_off, kv_stride, k0, p.Sk);

  const int r0 = warp * 16 + g;               // this thread's kv rows in the tile: r0, r0 + 8
  const int krow0 = k0 + r0, krow1 = krow0 + 8;
  const float sl = p.scale_log2;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  int lo, hi;
  q_range(p, k0, BN, lo, hi);
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const size_t q_off = ((size_t)b * p.S * p.H + h) * D;
    const bf16* qb = static_cast<const bf16*>(p.q) + q_off;
    const bf16* dob = static_cast<const bf16*>(p.dout) + q_off;
    const size_t row_off = ((size_t)b * p.H + h) * p.S;
    for (int q0 = (lo / BM) * BM; q0 < hi; q0 += BM) {
      __syncthreads();   // the previous q tile is consumed (and K, V are written)
      load_rows<D, BM>(sQ, qb, q_stride, q0, p.S);
      load_rows<D, BM>(sdO, dob, q_stride, q0, p.S);
      load_rows_t<D, BM>(sQt, qb, q_stride, q0, p.S);
      load_rows_t<D, BM>(sdOt, dob, q_stride, q0, p.S);
      for (int i = tid; i < BM; i += NT) {
        const bool in = q0 + i < p.S;
        sL[i] = in ? p.lse[row_off + q0 + i] * LOG2E : 0.f;
        sDl[i] = in ? p.delta[row_off + q0 + i] : 0.f;
      }
      __syncthreads();

      float st[BM / 8][4], dpt[BM / 8][4];
      product_abt<D, BM>(st, sK, r0, sQ, g, t4);    // S^T = K Q^T
      product_abt<D, BM>(dpt, sV, r0, sdO, g, t4);  // dP^T = V dO^T
      uint32_t pf[BM / 16][4], dsf[BM / 16][4];
#pragma unroll
      for (int nt = 0; nt < BM / 8; ++nt) {
        float pe[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = nt * 8 + t4 * 2 + (e & 1);
          pe[e] = visible(p, q0 + qc, e < 2 ? krow0 : krow1)
                      ? exp2f(fmaf(st[nt][e], sl, -sL[qc])) : 0.f;
          ds[e] = pe[e] * (dpt[nt][e] - sDl[qc]);
        }
        pf[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(pe[0], pe[1]);
        pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(pe[2], pe[3]);
        dsf[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
        dsf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      product_at<D, BM>(dv, pf, sdOt, g, t4);       // dV += P^T dO
      product_at<D, BM>(dk, dsf, sQt, g, t4);       // dK += dS^T Q
    }
  }
  store_rows<D>(static_cast<bf16*>(p.dk) + kv_off, kv_stride, krow0, p.Sk, dk, p.scale, t4);
  store_rows<D>(static_cast<bf16*>(p.dv) + kv_off, kv_stride, krow0, p.Sk, dv, 1.f, t4);
}

// ---------------------------------------------------------------------------
// fp32: SIMT, one warp a row, lane l holding elements l, l + 32, ...
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(WR * 32) flash_bwd_dq_f32(Params p) {
  constexpr int E = D / 32;
  __shared__ __align__(16) float sK[TN][D];
  __shared__ __align__(16) float sV[TN][D];

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * WR, row = q0 + warp;
  const size_t q_stride = (size_t)p.H * D, kv_stride = (size_t)p.KV * D;
  const size_t q_off = ((size_t)b * p.S * p.H + h) * D;
  const float* kb = static_cast<const float*>(p.k) + ((size_t)b * p.Sk * p.KV + kvh) * D;
  const float* vb = static_cast<const float*>(p.v) + ((size_t)b * p.Sk * p.KV + kvh) * D;
  const size_t row_off = ((size_t)b * p.H + h) * p.S;
  const bool live = row < p.S;

  float q[E], dout[E], dq[E];
  float delta = 0.f;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const size_t at = q_off + (size_t)row * q_stride + lane + 32 * i;
    q[i] = live ? static_cast<const float*>(p.q)[at] : 0.f;
    dout[i] = live ? static_cast<const float*>(p.dout)[at] : 0.f;
    delta += live ? static_cast<const float*>(p.o)[at] * dout[i] : 0.f;
    dq[i] = 0.f;
  }
  delta = warp_sum(delta);
  if (live && lane == 0) p.delta[row_off + row] = delta;
  const float lse2 = live ? p.lse[row_off + row] * LOG2E : 0.f;

  int lo, hi;
  kv_range(p, q0, WR, lo, hi);
  for (int k0 = (lo / TN) * TN; k0 < hi; k0 += TN) {
    __syncthreads();
    for (int c = threadIdx.x; c < TN * D; c += blockDim.x) {
      const int r = c / D, d = c % D;
      const bool in = k0 + r < p.Sk;
      sK[r][d] = in ? kb[(size_t)(k0 + r) * kv_stride + d] : 0.f;
      sV[r][d] = in ? vb[(size_t)(k0 + r) * kv_stride + d] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < TN; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        s = fmaf(q[i], sK[j][lane + 32 * i], s);
        dp = fmaf(dout[i], sV[j][lane + 32 * i], dp);
      }
      s = warp_sum(s);
      dp = warp_sum(dp);
      if (visible(p, row, k0 + j)) {   // uniform over the warp
        const float ds = exp2f(fmaf(s, p.scale_log2, -lse2)) * (dp - delta);
#pragma unroll
        for (int i = 0; i < E; ++i) dq[i] = fmaf(ds, sK[j][lane + 32 * i], dq[i]);
      }
    }
  }
  if (live)
#pragma unroll
    for (int i = 0; i < E; ++i)
      static_cast<float*>(p.dq)[q_off + (size_t)row * q_stride + lane + 32 * i] = dq[i] * p.scale;
}

template <int D>
__global__ void __launch_bounds__(WR * 32) flash_bwd_dkdv_f32(Params p) {
  constexpr int E = D / 32;
  __shared__ __align__(16) float sQ[TN][D];
  __shared__ __align__(16) float sdO[TN][D];
  __shared__ float sL[TN], sDl[TN];

  const int bk = blockIdx.y;
  const int b = bk / p.KV, kvh = bk % p.KV;
  const int group = p.H / p.KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * WR, krow = k0 + warp;
  const size_t q_stride = (size_t)p.H * D, kv_stride = (size_t)p.KV * D;
  const size_t kv_off = ((size_t)b * p.Sk * p.KV + kvh) * D;
  const bool live = krow < p.Sk;

  float k[E], v[E], dk[E], dv[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const size_t at = kv_off + (size_t)krow * kv_stride + lane + 32 * i;
    k[i] = live ? static_cast<const float*>(p.k)[at] : 0.f;
    v[i] = live ? static_cast<const float*>(p.v)[at] : 0.f;
    dk[i] = dv[i] = 0.f;
  }

  int lo, hi;
  q_range(p, k0, WR, lo, hi);
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const size_t q_off = ((size_t)b * p.S * p.H + h) * D;
    const float* qb = static_cast<const float*>(p.q) + q_off;
    const float* dob = static_cast<const float*>(p.dout) + q_off;
    const size_t row_off = ((size_t)b * p.H + h) * p.S;
    for (int q0 = (lo / TN) * TN; q0 < hi; q0 += TN) {
      __syncthreads();
      for (int c = threadIdx.x; c < TN * D; c += blockDim.x) {
        const int r = c / D, d = c % D;
        const bool in = q0 + r < p.S;
        sQ[r][d] = in ? qb[(size_t)(q0 + r) * q_stride + d] : 0.f;
        sdO[r][d] = in ? dob[(size_t)(q0 + r) * q_stride + d] : 0.f;
      }
      for (int i = threadIdx.x; i < TN; i += blockDim.x) {
        const bool in = q0 + i < p.S;
        sL[i] = in ? p.lse[row_off + q0 + i] * LOG2E : 0.f;
        sDl[i] = in ? p.delta[row_off + q0 + i] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < TN; ++j) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          s = fmaf(k[i], sQ[j][lane + 32 * i], s);
          dp = fmaf(v[i], sdO[j][lane + 32 * i], dp);
        }
        s = warp_sum(s);
        dp = warp_sum(dp);
        if (live && visible(p, q0 + j, krow)) {   // uniform over the warp
          const float pj = exp2f(fmaf(s, p.scale_log2, -sL[j]));
          const float ds = pj * (dp - sDl[j]);
#pragma unroll
          for (int i = 0; i < E; ++i) {
            dv[i] = fmaf(pj, sdO[j][lane + 32 * i], dv[i]);
            dk[i] = fmaf(ds, sQ[j][lane + 32 * i], dk[i]);
          }
        }
      }
    }
  }
  if (live)
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const size_t at = kv_off + (size_t)krow * kv_stride + lane + 32 * i;
      static_cast<float*>(p.dk)[at] = dk[i] * p.scale;
      static_cast<float*>(p.dv)[at] = dv[i];
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <int D>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using L = BwdSmem<D>;
  // above 48 KB a launch is refused unless the kernel opts in
  cudaFuncSetAttribute(flash_bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)L::DQ);
  cudaFuncSetAttribute(flash_bwd_dkdv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)L::DKDV);
  flash_bwd_dq_bf16<D><<<dim3((p.S + BM - 1) / BM, p.B * p.H), NT, L::DQ, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_bf16<D><<<dim3((p.Sk + BN - 1) / BN, p.B * p.KV), NT, L::DKDV, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Params& p, cudaStream_t stream) {
  flash_bwd_dq_f32<D><<<dim3((p.S + WR - 1) / WR, p.B * p.H), WR * 32, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_f32<D><<<dim3((p.Sk + WR - 1) / WR, p.B * p.KV), WR * 32, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, S, H, D); k, v, dk, dv: (B, Sk, KV, D); all contiguous,
// one dtype (bf16 if is_bf16 else fp32).  lse: (B, H, S) fp32 from the
// forward; delta: (B, H, S) fp32 scratch.  The two kernels run in order on
// `stream`.  Returns cudaGetLastError() after the launches.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, void* dq, void* dk,
                                   void* dv, float* delta, int B, int S, int Sk, int H, int KV,
                                   int D, int causal, int window, int is_bf16, void* stream) {
  const float scale = 1.f / sqrtf((float)D);
  Params p{q, k, v, o, dout, lse, dq, dk, dv, delta, B, S, Sk, H, KV, causal, window,
           scale, LOG2E * scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && D == 64) return launch_bf16<64>(p, st);
  if (is_bf16 && D == 128) return launch_bf16<128>(p, st);
  if (!is_bf16 && D == 64) return launch_f32<64>(p, st);
  if (!is_bf16 && D == 128) return launch_f32<128>(p, st);
  return (int)cudaErrorInvalidValue;
}
