// Flash attention forward for Hopper (sm_90a), model layout (B, S, H, D).
//
// Replaces src/repro/kernels/flash_attention.py:_kernel (the Pallas TPU
// kernel behind flash_attention_bh) and computes the same function:
// softmax(q k^T / sqrt(D) + mask) v with fp32 scores, a running max m,
// normaliser l and fp32 accumulator, the finite NEG_INF = -1e30 for
// masked scores (causal, sliding window, keys past Sk), and an output of
// acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on the H100: at the serving path's prefill shapes
// (S = 1024, D = 64, bf16, causal) the work is about 2 * B*H*S^2*D
// FLOPs against about 4 * B*S*H*D * 2 bytes, i.e. hundreds of FLOPs per
// byte, so the tensor cores bound it, not HBM.
//
// What the design does about it:
//  * The TPU grid's sequential kv axis becomes a loop inside one thread
//    block per (b*h, 64-row q tile); K/V tiles are staged through shared
//    memory and every score stays in registers (fp32 m, l and acc too).
//  * bf16 runs on the tensor cores with mma.sync m16n8k16 (fp32
//    accumulate).  Each warp owns 16 q rows; the score fragment of
//    S = Q K^T is re-packed in registers as the A operand of P V, so P
//    never touches shared memory.  P is rounded to bf16 for that product
//    (the reference rounds its normalised p to bf16 as well).
//  * GQA is resolved by indexing: q head h reads kv head h / (H / KV);
//    no repeated copy of K or V is made.
//  * Tiles wholly above the causal diagonal or before the window are
//    skipped; the ragged edge (S not a multiple of the tile) is masked
//    in the kernel, with zero-filled shared memory and no padding copy.
//  * fp32 inputs take a plain SIMT kernel (one q row per thread), exact
//    in fp32 to the reference's 1e-4.
// Later work (wgmma, TMA, a producer warp, double buffering) is noted in
// ROADMAP.md; this first kernel is the simple, right one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BM = 64;        // q rows per block (both kernels)
constexpr int BN = 64;        // kv rows per tile, bf16 kernel
constexpr int TN = 32;        // kv rows per tile, fp32 kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, Sk, H, KV;
  int causal, window;
  float scale_log2;           // log2(e) / sqrt(D): scores in base 2
};

// kv tiles [t_lo, t_hi) that hold any unmasked key for q rows [q0, q0+BM)
__device__ __forceinline__ void kv_tiles(const Params& p, int q0, int bn,
                                         int& t_lo, int& t_hi) {
  int hi = p.Sk;
  if (p.causal) hi = min(hi, q0 + BM);            // keys k <= q
  int lo = 0;
  if (p.window) lo = max(0, q0 - p.window + 1);   // keys k > q - window
  t_lo = lo / bn;
  t_hi = (hi + bn - 1) / bn;
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  bool ok = kpos < p.Sk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window) ok = ok && kpos > qpos - p.window;
  return ok;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// ---------------------------------------------------------------------------
// bf16: tensor cores, 4 warps x 16 q rows
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(128) flash_fwd_bf16(Params p) {
  constexpr int DP = D + 8;   // padded smem row of Q and K (bf16 elements)
  constexpr int NP = BN + 8;  // padded smem row of V^T
  constexpr int CH = D / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // [BM][DP]
  __nv_bfloat16* sK = sQ + BM * DP;                             // [BN][DP]
  __nv_bfloat16* sVt = sK + BN * DP;                            // [D][NP]

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row group / column pair

  const size_t q_stride = (size_t)p.H * D;   // elements between sequence positions
  const size_t kv_stride = (size_t)p.KV * D;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) + ((size_t)b * p.S * p.H + h) * D;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + ((size_t)b * p.Sk * p.KV + kvh) * D;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + ((size_t)b * p.Sk * p.KV + kvh) * D;
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + ((size_t)b * p.S * p.H + h) * D;

  for (int c = tid; c < BM * CH; c += blockDim.x) {
    const int r = c / CH, cc = c % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.S) val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * q_stride + cc * 8);
    *reinterpret_cast<uint4*>(sQ + r * DP + cc * 8) = val;
  }
  __syncthreads();

  const int r0 = warp * 16 + g;   // this thread's rows in the tile: r0, r0 + 8
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = kk * 16 + t4 * 2;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(sQ + r0 * DP + col);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(sQ + (r0 + 8) * DP + col);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(sQ + r0 * DP + col + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(sQ + (r0 + 8) * DP + col + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;   // running max of rows r0, r0 + 8 (base 2)
  float l0 = 0.f, l1 = 0.f;           // this thread's share of the normaliser
  const int qpos0 = q0 + r0, qpos1 = qpos0 + 8;

  int t_lo, t_hi;
  kv_tiles(p, q0, BN, t_lo, t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BN;
    __syncthreads();   // the previous tile is consumed
    for (int c = tid; c < BN * CH; c += blockDim.x) {
      const int r = c / CH, cc = c % CH;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < p.Sk) val = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * kv_stride + cc * 8);
      *reinterpret_cast<uint4*>(sK + r * DP + cc * 8) = val;
    }
    for (int c = tid; c < BN * CH; c += blockDim.x) {
      const int r = c % BN, cc = c / BN;   // lanes walk kv rows: conflict-free transpose
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < p.Sk) val = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * kv_stride + cc * 8);
      const uint32_t w[4] = {val.x, val.y, val.z, val.w};
      uint16_t* col = reinterpret_cast<uint16_t*>(sVt) + (cc * 8) * NP + r;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        col[i * NP] = static_cast<uint16_t>((i & 1) ? (w[i / 2] >> 16) : (w[i / 2] & 0xffffu));
    }
    __syncthreads();

    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* krow = sK + (nt * 8 + g) * DP + kk * 16 + t4 * 2;
        mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(krow),
                 *reinterpret_cast<const uint32_t*>(krow + 8));
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + nt * 8 + t4 * 2 + (e & 1);
        const int qpos = e < 2 ? qpos0 : qpos1;
        const float x = visible(p, qpos, kpos) ? s[nt][e] * p.scale_log2 : NEG_INF;
        s[nt][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    // the four lanes of a quad share rows r0 and r0 + 8
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    // P as the A operand of P V: score n-tiles 2j and 2j+1 form k-step j
    uint32_t pf[BN / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const float p0 = exp2f(s[nt][0] - m0), p1 = exp2f(s[nt][1] - m0);
      const float p2 = exp2f(s[nt][2] - m1), p3 = exp2f(s[nt][3] - m1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pf[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p0, p1);
      pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= a0;
      acc[dt][1] *= a0;
      acc[dt][2] *= a1;
      acc[dt][3] *= a1;
    }
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vrow = sVt + (dt * 8 + g) * NP + j * 16 + t4 * 2;
        mma_bf16(acc[dt], pf[j], *reinterpret_cast<const uint32_t*>(vrow),
                 *reinterpret_cast<const uint32_t*>(vrow + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if (qpos0 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qpos0 * q_stride + col) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (qpos1 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qpos1 * q_stride + col) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// fp32: SIMT, one q row per thread
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(BM) flash_fwd_f32(Params p) {
  __shared__ __align__(16) float sK[TN][D];
  __shared__ __align__(16) float sV[TN][D];

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = blockIdx.x * BM;
  const int qpos = q0 + threadIdx.x;
  const size_t q_stride = (size_t)p.H * D;
  const size_t kv_stride = (size_t)p.KV * D;
  const float* qb = static_cast<const float*>(p.q) + ((size_t)b * p.S * p.H + h) * D;
  const float* kb = static_cast<const float*>(p.k) + ((size_t)b * p.Sk * p.KV + kvh) * D;
  const float* vb = static_cast<const float*>(p.v) + ((size_t)b * p.Sk * p.KV + kvh) * D;
  float* ob = static_cast<float*>(p.o) + ((size_t)b * p.S * p.H + h) * D;

  float q[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = qpos < p.S ? qb[(size_t)qpos * q_stride + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  int t_lo, t_hi;
  kv_tiles(p, q0, TN, t_lo, t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * TN;
    __syncthreads();
    for (int c = threadIdx.x; c < TN * D / 4; c += blockDim.x) {
      const int r = c / (D / 4), cc = c % (D / 4);
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (k0 + r < p.Sk) {
        kv4 = *reinterpret_cast<const float4*>(kb + (size_t)(k0 + r) * kv_stride + cc * 4);
        vv4 = *reinterpret_cast<const float4*>(vb + (size_t)(k0 + r) * kv_stride + cc * 4);
      }
      *reinterpret_cast<float4*>(&sK[r][cc * 4]) = kv4;
      *reinterpret_cast<float4*>(&sV[r][cc * 4]) = vv4;
    }
    __syncthreads();

    float s[TN];
    float mx = m;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(q[d], sK[j][d], dot);
      s[j] = visible(p, qpos, k0 + j) ? dot * p.scale_log2 : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = exp2f(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float pj = exp2f(s[j] - m);
      l += pj;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(pj, sV[j][d], acc[d]);
    }
  }
  if (qpos < p.S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) ob[(size_t)qpos * q_stride + d] = acc[d] * inv;
  }
}

template <int D>
void launch_bf16(const Params& p, dim3 grid, cudaStream_t stream) {
  constexpr size_t smem = ((size_t)BM * (D + 8) + (size_t)BN * (D + 8) + (size_t)D * (BN + 8)) *
                          sizeof(__nv_bfloat16);
  // above 48 KB (D = 128) the launch is refused unless the kernel opts in
  cudaFuncSetAttribute(flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  flash_fwd_bf16<D><<<grid, 128, smem, stream>>>(p);
}

template <int D>
void launch_f32(const Params& p, dim3 grid, cudaStream_t stream) {
  flash_fwd_f32<D><<<grid, BM, 0, stream>>>(p);
}

}  // namespace

// q, o: (B, S, H, D); k, v: (B, Sk, KV, D); all contiguous, same dtype
// (bf16 if is_bf16 else fp32).  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int Sk, int H, int KV, int D,
                                   int causal, int window, int is_bf16, void* stream) {
  Params p{q, k, v, o, B, S, Sk, H, KV, causal, window, LOG2E / sqrtf((float)D)};
  const dim3 grid((S + BM - 1) / BM, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && D == 64) launch_bf16<64>(p, grid, st);
  else if (is_bf16 && D == 128) launch_bf16<128>(p, grid, st);
  else if (!is_bf16 && D == 64) launch_f32<64>(p, grid, st);
  else if (!is_bf16 && D == 128) launch_f32<128>(p, grid, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
