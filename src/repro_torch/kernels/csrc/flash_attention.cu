// Flash attention forward for Hopper (sm_90a), model layout (B, S, H, D).
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_bh (the
// Pallas TPU kernel, body _kernel) and computes the same function:
// softmax(q k^T / sqrt(D) + mask) v with fp32 scores, a running max m,
// normaliser l and fp32 accumulator, the finite NEG_INF = -1e30 for
// masked scores (causal, sliding window, keys past Sk), P rounded to bf16
// for the P V product, and an output of acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on the H100: the tensor cores.  At the serving path's
// prefill shape (B 4, S 1024, H 32, KV 8, D 64, bf16, causal) the visible
// pairs need 17.2 GFLOP (4 D FLOPs a pair), 0.0174 ms at 989 TFLOP/s,
// against 42 MB of q, k, v and o, 0.0125 ms at 3.35 TB/s.  On paper exp2
// on the special-function units (16 a cycle per SM against 4096 tensor
// FLOPs a cycle) costs as much again at D 64; measured, an FMA in its
// place saves 4%.  What holds the kernel is each warpgroup's serial chain
// S -> softmax -> P V, which other warpgroups on the SM hide only in part.
//
// What the bf16 design does about it:
//  * Both products on wgmma: S = Q K^T as m64n128k16 with Q and K read
//    from shared memory, O += P V as m64nDk16 with P in registers (the S
//    accumulator's layout is the A-fragment layout, so P is packed to bf16
//    pairs in place) and V read from shared memory as TMA wrote it,
//    (kv, d) with d contiguous: the MN-major B operand, no transpose.
//  * A block takes 128 q rows as two consumer warpgroups of 64 rows.
//    Q, K and V arrive by TMA (cp.async.bulk.tensor, 128-byte swizzle,
//    64-column boxes) into a ring of K/V stages guarded by mbarriers: a
//    "full" barrier per stage and operand counts the TMA's bytes, an
//    "empty" barrier per stage takes every consumer thread's arrival.
//    One elected consumer thread keeps the ring STAGES - 1 tiles ahead,
//    so the loads of later tiles are in flight while a tile is computed.
//  * At D 64 a block holds 80 KB of shared memory and 127 registers a
//    thread, so two blocks share an SM: one block's loads and epilogue
//    overlap the other's products, and four warpgroups interleave their
//    exp2 with the tensor cores.  A separate producer warp would take
//    registers the consumers need at two blocks an SM (setmaxnreg can only
//    hand on what the producer frees).  Measured slower: one block an SM
//    with a producer warpgroup and S / P V overlap in each warpgroup, and
//    that overlap at two blocks an SM with P staged in shared memory.
//  * TMA zero-fills rows past S or Sk, so ragged lengths need no padding
//    copy; keys past Sk are still masked, as are the causal diagonal tile
//    and the window's first tiles.  Tiles with no masked pair skip the
//    mask; tiles with no visible pair are neither loaded nor computed.
//  * Causal q tiles launch heaviest first (blockIdx.y counts down from
//    the last q tile), so the last wave holds the shortest blocks.
//  * GQA by index: q head h reads kv head h / (H / KV) through the K/V
//    tensor maps; no copy of K or V is made.
//  * The smoke configs' head dims, (16, 16) and (24, 16) (MLA's 16 + 8
//    q/k columns over 16 of v), take a plain SIMT kernel in bf16 (one q
//    row per thread, fp32 arithmetic): a bf16 tile of 16 or 24 columns is
//    not whole 64-column TMA boxes.  The launcher picks the route by head
//    dims and dtype alone, never after another route failed.
//  * fp32 runs csrc/flash_attention_fwd_f32.cu's register-tiled kernel at
//    every head-dim pair (kernels/flash_attention.py:route, kind "f32"):
//    this entry refuses it.
//
// The kernels are templated on the q/k head dim DK and the v head dim DV:
// (64, 64), (128, 128) and (256, 256), and (16, 16) and (24, 16) (SIMT,
// above).  bf16 at (192, 128), deepseek-v3's multi-head latent attention
// (MLA), whose prefill attends with 128 "nope" + 64 rope columns of q and
// k and 128 columns of v, is a kernel of its own,
// csrc/flash_attention_fwd_ws.cu: this entry refuses it.
//
// D 256 (recurrentgemma-9b) has instantiations of its own; D 64 and 128
// are unchanged.  In bf16 the 128-key tile of D 64/128 does not fit: Q
// is 64 KB and a K/V stage 2 x 64 KB, over the 227 KB of an SM, and the
// O accumulator (64 x 256 fp32 a warpgroup) takes 128 registers a thread
// on top of S.  So D 256 takes 64-key tiles (Smem<256, 256, 64>): K/V 32 KB a
// stage, two stages and Q ~193 KB at one block an SM; S = Q K^T as
// m64n64k16 over 16 k-steps and O += P V as m64n256k16, the widest wgmma
// N.
// A row with no visible key at all (only possible when S > Sk) comes out
// as zeros in the bf16 kernel; the reference averages every key there.
//
// For training, both kernels also write each row's logsumexp of the scaled
// scores, lse = m + log(l) in fp32, laid out (B, H, S), when the caller
// passes a buffer for it (flash_attention_bwd.cu recomputes P from it).  A
// row with no visible key gets lse = -inf.  With a null buffer the kernels
// do exactly the serving path's work.

#include "flash_attention_fwd.cuh"

namespace {

using namespace hopper;

// four consecutive bf16 elements (8-byte aligned) as floats
__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// rows [k0, k0 + ROWS) of a (Sk, W) operand of type T with `stride`
// elements between rows into shared memory as fp32, zeros past Sk; every
// thread of the block
template <int ROWS, int W, typename T>
__device__ __forceinline__ void load_rows(float (*dst)[W], const T* src, size_t stride,
                                          int k0, int Sk) {
  static_assert(W % 4 == 0, "rows of whole float4s");
  for (int c = threadIdx.x; c < ROWS * W / 4; c += blockDim.x) {
    const int r = c / (W / 4), cc = c % (W / 4);
    float4 v4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 + r < Sk) v4 = load4(src + (size_t)(k0 + r) * stride + cc * 4);
    *reinterpret_cast<float4*>(&dst[r][cc * 4]) = v4;
  }
}

// ---------------------------------------------------------------------------
// SIMT, one q row per thread: bf16 at the smoke configs' (16, 16) and (24,
// 16); T is the element type in memory
// ---------------------------------------------------------------------------
template <int DK, int DV, typename T>
__global__ void __launch_bounds__(BM) flash_fwd_f32(Params p) {
  __shared__ __align__(16) float sK[TN][DK];
  __shared__ __align__(16) float sV[TN][DV];

  const int bh = blockIdx.x;   // B * H on x: any B * H
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = blockIdx.y * BM;
  const int qpos = q0 + threadIdx.x;
  const size_t q_stride = (size_t)p.H * DK, o_stride = (size_t)p.H * DV;
  const size_t k_stride = (size_t)p.KV * DK, v_stride = (size_t)p.KV * DV;
  const T* qb = static_cast<const T*>(p.q) + ((size_t)b * p.S * p.H + h) * DK;
  const T* kb = static_cast<const T*>(p.k) + ((size_t)b * p.Sk * p.KV + kvh) * DK;
  const T* vb = static_cast<const T*>(p.v) + ((size_t)b * p.Sk * p.KV + kvh) * DV;
  T* ob = static_cast<T*>(p.o) + ((size_t)b * p.S * p.H + h) * DV;

  float q[DK], acc[DV];
#pragma unroll
  for (int d = 0; d < DK; ++d) q[d] = qpos < p.S ? to_f(qb[(size_t)qpos * q_stride + d]) : 0.f;
#pragma unroll
  for (int d = 0; d < DV; ++d) acc[d] = 0.f;
  float m = NEG_INF, l = 0.f;

  int t_lo, t_hi;
  kv_tiles(p, q0, TN, t_lo, t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * TN;
    __syncthreads();
    load_rows<TN, DK>(sK, kb, k_stride, k0, p.Sk);
    load_rows<TN, DV>(sV, vb, v_stride, k0, p.Sk);
    __syncthreads();

    float s[TN];
    float mx = m;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DK; ++d) dot = fmaf(q[d], sK[j][d], dot);
      s[j] = visible(p, qpos, k0 + j) ? dot * p.scale_log2 : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = exp2f(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DV; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float pj = exp2f(s[j] - m);
      l += pj;
#pragma unroll
      for (int d = 0; d < DV; ++d) acc[d] = fmaf(pj, sV[j][d], acc[d]);
    }
  }
  if (qpos < p.S && p.lse != nullptr)   // m and l are in base 2 here
    p.lse[((size_t)b * p.H + h) * p.S + qpos] =
        m == NEG_INF ? -INFINITY : (m + log2f(l)) / LOG2E;
  if (qpos < p.S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < DV; ++d) store_f(ob + (size_t)qpos * o_stride + d, acc[d] * inv);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <int DK, int DV, int WN>
int launch_bf16(const Params& p, const long long* layout, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int err = encode(&tm_q, p.q, layout, WM);
  if (!err) err = encode(&tm_k, p.k, layout + 11, WN);
  if (!err) err = encode(&tm_v, p.v, layout + 22, WN);
  if (err) return err;
  constexpr size_t smem = Smem<DK, DV, WN>::BYTES;
  static uint32_t opted = 0;   // a bit per device, one variable per instantiation
  using W = FixedWidths<DK, DV>;
  err = opt_in_smem(reinterpret_cast<const void*>(flash_fwd_bf16<DK, DV, WN, W>), smem, opted);
  if (err) return err;
  const dim3 grid(p.B * p.H, (p.S + WM - 1) / WM);
  flash_fwd_bf16<DK, DV, WN, W><<<grid, 256, smem, stream>>>(tm_q, tm_k, tm_v, p, W{});
  return 0;
}

// the bf16 kernel at head dims (DK, DV) with a kv tile of kv_tile rows:
// 64 or 128, and 64 alone at D 256 (kernels/flash_attention.py:KV_TILES)
template <int DK, int DV>
int launch_bf16_tile(const Params& p, const long long* layout, cudaStream_t stream,
                     int kv_tile) {
  if (kv_tile == 64) return launch_bf16<DK, DV, 64>(p, layout, stream);
  if constexpr (DK != 256) {
    if (kv_tile == 128) return launch_bf16<DK, DV, 128>(p, layout, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// the smoke configs' head dims in bf16: the SIMT kernel
template <int DK, int DV>
void launch_simt(const Params& p, dim3 grid, cudaStream_t stream) {
  flash_fwd_f32<DK, DV, __nv_bfloat16><<<grid, BM, 0, stream>>>(p);
}

}  // namespace

// q: (B, S, H, DK); k: (B, Sk, KV, DK); v: (B, Sk, KV, DV); o: (B, S, H, DV);
// all contiguous bf16, dtype code 1 (0, fp32, runs
// csrc/flash_attention_fwd_f32.cu and 2, fp16, csrc/flash_attention_f16.cu:
// both are refused here, as is any other code, with
// cudaErrorInvalidValue).  layout: at the wgmma head dims, the TMA layouts
// of q, k and v (11 values each); unused for the SIMT head dims (16, 16),
// (24, 16).  lse: null, or a (B, H, S) fp32 buffer for each row's
// logsumexp.  kv_tile: the wgmma kernel's kv rows a stage (its layouts'
// box rows for k and v).  Returns cudaGetLastError() after the launch, or
// a negative code from encode().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int Sk, int H, int KV, int DK, int DV,
                                   int causal, int window, int dtype, void* stream,
                                   const long long* layout, float* lse, int kv_tile) {
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, B, S, Sk, H, KV, causal, window, LOG2E / sqrtf((float)DK), lse};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * H, (S + BM - 1) / BM);   // the SIMT kernel's
  int err = 0;
  if (DK == DV && DK == 64) {
    err = launch_bf16_tile<64, 64>(p, layout, st, kv_tile);
  } else if (DK == DV && DK == 128) {
    err = launch_bf16_tile<128, 128>(p, layout, st, kv_tile);
  } else if (DK == DV && DK == 256) {
    err = launch_bf16_tile<256, 256>(p, layout, st, kv_tile);
  } else if (DK == 16 && DV == 16) {
    launch_simt<16, 16>(p, grid, st);
  } else if (DK == 24 && DV == 16) {
    launch_simt<24, 16>(p, grid, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}
