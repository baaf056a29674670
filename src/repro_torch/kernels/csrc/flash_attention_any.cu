// Flash attention forward and backward on SIMT at any head dims up to 256:
// the general route (kernels/flash_attention.py:route), for what the wgmma
// + TMA kernels do not take (fp16 and bf16 at head dims that are no built
// pair and not multiples of 8 inside one), in bf16 or fp16 (fp32 runs
// csrc/flash_attention_fwd_f32.cu and csrc/flash_attention_bwd_f32.cu at
// every head dim).
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_bh (the
// Pallas kernel, which takes any head dim and float dtype) forward, and the
// autodiff of src/repro/models/layers.py:blockwise_mha backward, and
// computes what csrc/flash_attention.cu and csrc/flash_attention_bwd.cu
// compute: fp32 scores, a running max and normaliser in base 2, the causal,
// sliding-window and ragged (keys past Sk) masks, GQA by index (q head h
// reads kv head h / (H / KV)), each row's logsumexp for the backward, and
// the gradient from it, deterministic, with no atomics.
//
// The kernels are templated on a bucket of widths and on the element type
// T (__nv_bfloat16 or __half in memory; the arithmetic is fp32),
// with the real q/k dim dk and v dim dv at run time:
//  * forward (flash_fwd_any<PARTS, T>): PARTS adjacent lanes share a q row,
//    each holding 32 columns of q and of the accumulator (column c at lane
//    part c % PARTS), so 32 PARTS >= max(dk, dv); the dot products are
//    summed across the PARTS lanes by shuffles.  A block is 64 q rows; the
//    K and V tiles are staged in fp32 shared memory, zero past dk, dv and
//    Sk, so every product runs over the bucket's width.
//  * backward (flash_bwd_{dq,dkdv}_any<E, T>): a warp a row, lane l holding
//    columns l + 32 i (i < E) below dk or dv; dQ, then dK and dV over the
//    kv head's q heads, as csrc/flash_attention_bwd.cu's SIMT kernels.
//
// What bounds it: fp32 FMAs on the CUDA cores (67 TFLOP/s on an H100) and
// the shared-memory loads that feed them, not bytes; the padded columns of
// a bucket cost their share.  It is the simple, exact route: shapes whose
// speed matters take the wgmma kernels (bf16, head dims multiples of 8).

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BM = 64;   // forward: q rows a block
constexpr int WR = 8;    // backward: rows a block, a warp each

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;                // the forward's output; the backward reads it
  const void* dout;       // backward: dO, (B, S, H, dv)
  const float* lse_in;    // backward: the forward's (B, H, S), natural log
  float* lse;             // forward: (B, H, S) or null
  void* dq;
  void* dk;
  void* dv;
  float* delta;           // backward scratch: rowsum(dO * O), (B, H, S)
  int B, S, Sk, H, KV;
  int causal, window;
  int dk_dim, dv_dim;     // the real head dims
  float scale;            // 1 / sqrt(dk)
  float scale_log2;       // log2(e) / sqrt(dk)
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// rows [r0, r0 + ROWS) of a (rows, heads, width) operand of type T with
// `stride` elements between rows into fp32 shared memory of W columns:
// zeros at and past `width` columns and `rows` rows; every thread of the block
template <int ROWS, int W, typename T>
__device__ __forceinline__ void stage(float (*dst)[W], const T* src, size_t stride, int r0,
                                      int rows, int width) {
  for (int c = threadIdx.x; c < ROWS * W; c += blockDim.x) {
    const int r = c / W, d = c % W;
    dst[r][d] = r0 + r < rows && d < width ? to_f(src[(size_t)(r0 + r) * stride + d]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// forward: PARTS lanes a q row, 32 columns each
// ---------------------------------------------------------------------------
template <int PARTS>
__host__ __device__ constexpr int fwd_tile() { return PARTS == 8 ? 16 : 32; }

template <int PARTS, typename T>
__global__ void __launch_bounds__(BM * PARTS) flash_fwd_any(Params p) {
  constexpr int W = 32 * PARTS;   // the bucket's width
  constexpr int TN = fwd_tile<PARTS>();
  __shared__ __align__(16) float sK[TN][W];
  __shared__ __align__(16) float sV[TN][W];

  const int bh = blockIdx.x;   // B * H on x: any B * H
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int part = threadIdx.x % PARTS;
  const int q0 = blockIdx.y * BM;
  const int qpos = q0 + threadIdx.x / PARTS;
  const int dk = p.dk_dim, dv = p.dv_dim;
  const size_t q_stride = (size_t)p.H * dk, o_stride = (size_t)p.H * dv;
  const size_t k_stride = (size_t)p.KV * dk, v_stride = (size_t)p.KV * dv;
  const T* qb = static_cast<const T*>(p.q) + ((size_t)b * p.S * p.H + h) * dk;
  const T* kb = static_cast<const T*>(p.k) + ((size_t)b * p.Sk * p.KV + kvh) * dk;
  const T* vb = static_cast<const T*>(p.v) + ((size_t)b * p.Sk * p.KV + kvh) * dv;
  T* ob = static_cast<T*>(p.o) + ((size_t)b * p.S * p.H + h) * dv;

  float q[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = part + PARTS * i;
    q[i] = qpos < p.S && col < dk ? to_f(qb[(size_t)qpos * q_stride + col]) : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  int lo, hi;
  kv_range(p, q0, BM, lo, hi);
  for (int k0 = (lo / TN) * TN; k0 < hi; k0 += TN) {
    __syncthreads();
    stage<TN, W>(sK, kb, k_stride, k0, p.Sk, dk);
    stage<TN, W>(sV, vb, v_stride, k0, p.Sk, dv);
    __syncthreads();
    float s[TN];
    float mx = m;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) dot = fmaf(q[i], sK[j][part + PARTS * i], dot);
#pragma unroll
      for (int o = 1; o < PARTS; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[j] = visible(p, qpos, k0 + j) ? dot * p.scale_log2 : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = exp2f(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float pj = exp2f(s[j] - m);
      l += pj;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = fmaf(pj, sV[j][part + PARTS * i], acc[i]);
    }
  }
  if (qpos < p.S && p.lse != nullptr && part == 0)   // m and l are in base 2 here
    p.lse[((size_t)b * p.H + h) * p.S + qpos] =
        m == NEG_INF ? -INFINITY : (m + log2f(l)) / LOG2E;
  if (qpos < p.S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = part + PARTS * i;
      if (col < dv) store_f(ob + (size_t)qpos * o_stride + col, acc[i] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: a warp a row, lane l holding columns l + 32 i (i < E)
// ---------------------------------------------------------------------------
template <int E>
__host__ __device__ constexpr int bwd_tile() { return E == 8 ? 16 : 32; }

template <int E, typename T>
__global__ void __launch_bounds__(WR * 32) flash_bwd_dq_any(Params p) {
  constexpr int W = 32 * E, TN = bwd_tile<E>();
  __shared__ __align__(16) float sK[TN][W];
  __shared__ __align__(16) float sV[TN][W];

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * WR, row = q0 + warp;
  const int dk = p.dk_dim, dv = p.dv_dim;
  const size_t q_stride = (size_t)p.H * dk, o_stride = (size_t)p.H * dv;
  const size_t k_stride = (size_t)p.KV * dk, v_stride = (size_t)p.KV * dv;
  const size_t q_off = ((size_t)b * p.S * p.H + h) * dk;
  const size_t o_off = ((size_t)b * p.S * p.H + h) * dv;
  const T* kb = static_cast<const T*>(p.k) + ((size_t)b * p.Sk * p.KV + kvh) * dk;
  const T* vb = static_cast<const T*>(p.v) + ((size_t)b * p.Sk * p.KV + kvh) * dv;
  const size_t row_off = ((size_t)b * p.H + h) * p.S;
  const bool live = row < p.S;

  float q[E], dq[E], dout[E];
  float delta = 0.f;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int c = lane + 32 * i;
    q[i] = live && c < dk ? to_f(static_cast<const T*>(p.q)[q_off + (size_t)row * q_stride + c])
                          : 0.f;
    dq[i] = 0.f;
    const bool in = live && c < dv;
    const size_t at = o_off + (size_t)row * o_stride + c;
    dout[i] = in ? to_f(static_cast<const T*>(p.dout)[at]) : 0.f;
    delta += in ? to_f(static_cast<const T*>(p.o)[at]) * dout[i] : 0.f;
  }
  delta = warp_sum(delta);
  if (live && lane == 0) p.delta[row_off + row] = delta;
  const float lse2 = live ? p.lse_in[row_off + row] * LOG2E : 0.f;

  int lo, hi;
  kv_range(p, q0, WR, lo, hi);
  for (int k0 = (lo / TN) * TN; k0 < hi; k0 += TN) {
    __syncthreads();
    stage<TN, W>(sK, kb, k_stride, k0, p.Sk, dk);
    stage<TN, W>(sV, vb, v_stride, k0, p.Sk, dv);
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
      if (lane + 32 * i < dk)
        store_f(static_cast<T*>(p.dq) + q_off + (size_t)row * q_stride + lane + 32 * i,
                dq[i] * p.scale);
}

template <int E, typename T>
__global__ void __launch_bounds__(WR * 32) flash_bwd_dkdv_any(Params p) {
  constexpr int W = 32 * E, TN = bwd_tile<E>();
  __shared__ __align__(16) float sQ[TN][W];
  __shared__ __align__(16) float sdO[TN][W];
  __shared__ float sL[TN], sDl[TN];

  const int bk = blockIdx.x;
  const int b = bk / p.KV, kvh = bk % p.KV;
  const int group = p.H / p.KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.y * WR, krow = k0 + warp;
  const int dk = p.dk_dim, dv = p.dv_dim;
  const size_t q_stride = (size_t)p.H * dk, o_stride = (size_t)p.H * dv;
  const size_t k_stride = (size_t)p.KV * dk, v_stride = (size_t)p.KV * dv;
  const size_t k_off = ((size_t)b * p.Sk * p.KV + kvh) * dk;
  const size_t v_off = ((size_t)b * p.Sk * p.KV + kvh) * dv;
  const bool live = krow < p.Sk;

  float k[E], dkr[E], v[E], dvr[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int c = lane + 32 * i;
    k[i] = live && c < dk ? to_f(static_cast<const T*>(p.k)[k_off + (size_t)krow * k_stride + c])
                          : 0.f;
    v[i] = live && c < dv ? to_f(static_cast<const T*>(p.v)[v_off + (size_t)krow * v_stride + c])
                          : 0.f;
    dkr[i] = dvr[i] = 0.f;
  }

  int lo, hi;
  q_range(p, k0, WR, lo, hi);
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const T* qb = static_cast<const T*>(p.q) + ((size_t)b * p.S * p.H + h) * dk;
    const T* dob = static_cast<const T*>(p.dout) + ((size_t)b * p.S * p.H + h) * dv;
    const size_t row_off = ((size_t)b * p.H + h) * p.S;
    for (int q0 = (lo / TN) * TN; q0 < hi; q0 += TN) {
      __syncthreads();
      stage<TN, W>(sQ, qb, q_stride, q0, p.S, dk);
      stage<TN, W>(sdO, dob, o_stride, q0, p.S, dv);
      for (int i = threadIdx.x; i < TN; i += blockDim.x) {
        const bool in = q0 + i < p.S;
        sL[i] = in ? p.lse_in[row_off + q0 + i] * LOG2E : 0.f;
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
            dvr[i] = fmaf(pj, sdO[j][lane + 32 * i], dvr[i]);
            dkr[i] = fmaf(ds, sQ[j][lane + 32 * i], dkr[i]);
          }
        }
      }
    }
  }
  if (live)
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int c = lane + 32 * i;
      if (c < dk)
        store_f(static_cast<T*>(p.dk) + k_off + (size_t)krow * k_stride + c, dkr[i] * p.scale);
      if (c < dv) store_f(static_cast<T*>(p.dv) + v_off + (size_t)krow * v_stride + c, dvr[i]);
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// the bucket: 32 w columns a lane or a part, w in {1, 2, 4, 8}, the least
// with 32 w >= max(dk, dv)
int bucket(int dk, int dv) {
  const int d = dk > dv ? dk : dv;
  return d <= 32 ? 1 : d <= 64 ? 2 : d <= 128 ? 4 : 8;
}

template <typename T>
int launch_fwd(const Params& p, cudaStream_t stream) {
  const int parts = bucket(p.dk_dim, p.dv_dim);
  const dim3 grid(p.B * p.H, (p.S + BM - 1) / BM);
  switch (parts) {
    case 1: flash_fwd_any<1, T><<<grid, BM * 1, 0, stream>>>(p); break;
    case 2: flash_fwd_any<2, T><<<grid, BM * 2, 0, stream>>>(p); break;
    case 4: flash_fwd_any<4, T><<<grid, BM * 4, 0, stream>>>(p); break;
    default: flash_fwd_any<8, T><<<grid, BM * 8, 0, stream>>>(p); break;
  }
  return (int)cudaGetLastError();
}

template <int E, typename T>
int launch_bwd_e(const Params& p, cudaStream_t stream) {
  flash_bwd_dq_any<E, T><<<dim3(p.B * p.H, (p.S + WR - 1) / WR), WR * 32, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_any<E, T><<<dim3(p.B * p.KV, (p.Sk + WR - 1) / WR), WR * 32, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const Params& p, cudaStream_t stream) {
  switch (bucket(p.dk_dim, p.dv_dim)) {
    case 1: return launch_bwd_e<1, T>(p, stream);
    case 2: return launch_bwd_e<2, T>(p, stream);
    case 4: return launch_bwd_e<4, T>(p, stream);
    default: return launch_bwd_e<8, T>(p, stream);
  }
}

bool takes(int B, int S, int Sk, int H, int KV, int dk, int dv) {
  return B > 0 && S > 0 && Sk > 0 && KV > 0 && H % KV == 0 && dk > 0 && dv > 0 && dk <= 256 &&
         dv <= 256;
}

}  // namespace

// q: (B, S, H, dk); k: (B, Sk, KV, dk); v: (B, Sk, KV, dv); o: (B, S, H,
// dv); all contiguous, of one dtype: 1 bf16, 2 fp16 (0, fp32, is refused:
// csrc/flash_attention_fwd_f32.cu computes it); 1 <= dk, dv <= 256.  lse:
// null, or a (B, H, S) fp32 buffer.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for what it does not take.
extern "C" int flash_attention_fwd_any(const void* q, const void* k, const void* v, void* o,
                                       int B, int S, int Sk, int H, int KV, int dk, int dv,
                                       int causal, int window, int dtype, void* stream,
                                       float* lse) {
  if (!takes(B, S, Sk, H, KV, dk, dv)) return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)dk);
  const Params p{q, k, v, o, nullptr, nullptr, lse, nullptr, nullptr, nullptr, nullptr,
                 B, S, Sk, H, KV, causal, window, dk, dv, scale, LOG2E * scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(p, st);
  if (dtype == 2) return launch_fwd<__half>(p, st);
  return (int)cudaErrorInvalidValue;
}

// The gradient: q, dq (B, S, H, dk); o, dout (B, S, H, dv); k, dk (B, Sk,
// KV, dk); v, dv (B, Sk, KV, dv); all contiguous, one dtype: 1 bf16, 2 fp16
// (0, fp32, is refused: csrc/flash_attention_bwd_f32.cu computes it).
// lse: (B, H, S) fp32 from the forward.  scratch: at least B * H * S fp32
// (Delta).  The two kernels run in order on `stream`.
extern "C" int flash_attention_bwd_any(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const float* lse,
                                       void* dq, void* dk, void* dv, float* scratch, int B,
                                       int S, int Sk, int H, int KV, int DK, int DV, int causal,
                                       int window, int dtype, void* stream) {
  if (!takes(B, S, Sk, H, KV, DK, DV)) return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)DK);
  const Params p{q, k, v, const_cast<void*>(o), dout, lse, nullptr, dq, dk, dv, scratch,
                 B, S, Sk, H, KV, causal, window, DK, DV, scale, LOG2E * scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(p, st);
  if (dtype == 2) return launch_bwd<__half>(p, st);
  return (int)cudaErrorInvalidValue;
}
