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
//   flash_bwd_dq    grid (B*H, q tiles):  Delta = rowsum(dO * O) and lse in
//                   base 2, stored for the second kernel; over the kv tiles
//                   dP = dO V^T, dS = P * (dP - Delta), dQ += dS K / sqrt(D)
//   flash_bwd_dkdv  grid (B*KV, kv tiles): over the q heads of the kv head's
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
// What the bf16 design does about it (FlashAttention-3's backward, without
// its dQ atomics):
//  * Every product on wgmma, no transposed copy.  The dK/dV kernel forms
//    S^T = K Q^T and dP^T = V dO^T with K, V, Q and dO K-major as TMA
//    writes them; the S^T accumulator's layout is the A-fragment layout,
//    so P^T and dS^T pack to bf16 in registers and dV += P^T dO,
//    dK += dS^T Q read dO and Q as MN-major B operands.  The dQ kernel
//    forms S = Q K^T and dP = dO V^T, then dQ += dS K reads the same K
//    tile MN-major.  P and dS are rounded to bf16 as product operands, as
//    the forward rounds P; gradients accumulate in fp32 registers and are
//    written once in the inputs' dtype.
//  * A block is one warpgroup: its 64 kv rows (dK/dV) or 64 q rows (dQ)
//    stay in shared memory, and the other side streams through a ring of
//    64-row stages by TMA (128-byte swizzle, 64-column boxes), with a
//    "full" mbarrier per stage counting the TMA's bytes and an "empty"
//    one taking every thread's arrival; one elected thread keeps the ring
//    STAGES - 1 tiles ahead.  The dK/dV stage also brings the q tile's lse
//    and Delta (a 256-byte bulk copy each from a scratch padded to whole
//    tiles, which the dQ kernel writes).  Within a tile, exp2 of S runs
//    while dP is in flight, and the dV product while dS is formed; the
//    dK/dV kernel also issues a tile's S^T and dP^T while the previous
//    tile's dV and dK products finish.
//  * Registers decide occupancy, as in the forward: the dQ kernel keeps to
//    128 at D 64, so four blocks share an SM, the dK/dV kernel (dK, dV,
//    S^T and dP^T in registers) two.  Measured slower (PERF.md §6): two
//    warpgroups a block, deeper rings, three dK/dV blocks an SM.
//  * TMA zero-fills rows past S or Sk, so ragged lengths need no padding
//    copy.  Masks are tested on edge tiles only (the causal diagonal, the
//    window's ends, the ragged ends); tiles with no visible pair are
//    neither loaded nor computed.
//  * Heaviest blocks first: under the causal mask the first kv tiles
//    (dK/dV) and the last q tiles (dQ) run longest, and launch first.
//  * GQA by index through the tensor maps: no copy of K or V.
// fp32 inputs take SIMT kernels, one warp a row, exact in fp32.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int ROWS = 64;   // bf16: rows of a warpgroup's tile, of a stage and of a TMA box
constexpr int WR = 8;      // fp32 blocks: 8 warps, one row each
constexpr int TN = 32;     // fp32 kernels: rows of a staged tile

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
  float* delta;           // scratch: rowsum(dO * O), (B, H, S) fp32, (B, H, s_pad) bf16
  float* lse2;            // bf16 scratch: (B, H, s_pad) lse * log2(e); both 0 past S
  int B, S, Sk, H, KV;
  int causal, window;
  float scale;            // 1 / sqrt(D)
  float scale_log2;       // log2(e) / sqrt(D): scores in base 2
  int s_pad;              // S rounded up to ROWS
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

// rows row0 and row0 + 8 of a wgmma accumulator (64 x D: 4 values per
// 8-column block) into a (B, L, heads, D) tensor, times `scale`
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, size_t stride, int row0, int L,
                                           const float (&acc)[D / 2], float scale, int t4) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if (row0 < L)
      *reinterpret_cast<__nv_bfloat162*>(base + (size_t)row0 * stride + col) =
          __floats2bfloat162_rn(acc[4 * dt] * scale, acc[4 * dt + 1] * scale);
    if (row0 + 8 < L)
      *reinterpret_cast<__nv_bfloat162*>(base + (size_t)(row0 + 8) * stride + col) =
          __floats2bfloat162_rn(acc[4 * dt + 2] * scale, acc[4 * dt + 3] * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16 dQ: wgmma, TMA, one warpgroup of 64 q rows
// ---------------------------------------------------------------------------
// Shared memory: Q and dO, then STAGES K tiles and STAGES V tiles (64 rows
// each: D / 64 boxes of 64 rows x 128 bytes), the mbarriers.  At D 64 the
// kernel keeps to 128 registers, so four blocks share an SM.
template <int D>
struct DqSmem {
  static constexpr int STAGES = 2;
  static constexpr int BLOCKS_PER_SM = D == 64 ? 4 : 2;
  static constexpr uint32_t TILE_BYTES = ROWS * D * 2;
  static constexpr size_t BYTES =
      1024 + 2 * (1 + STAGES) * TILE_BYTES + 8 * (1 + 2 * STAGES);   // 1024: alignment
};

template <int D>
__global__ void __launch_bounds__(128, DqSmem<D>::BLOCKS_PER_SM)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, Params p) {
  using L = DqSmem<D>;
  constexpr int STAGES = L::STAGES;
  constexpr int BOXES = D / BOX;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sdO = sQ + L::TILE_BYTES;
  unsigned char* sK = sdO + L::TILE_BYTES;
  unsigned char* sV = sK + STAGES * L::TILE_BYTES;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + STAGES * L::TILE_BYTES);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // accumulator row group / column pair
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KV);
  // causal: the first blocks take the last q tiles, which have the most kv tiles
  const int qt = p.causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y) : blockIdx.y;
  const int q0 = qt * ROWS;
  int lo, hi;
  kv_range(p, q0, ROWS, lo, hi);
  const int t_lo = lo / ROWS;
  const int n = hi > lo ? (hi + ROWS - 1) / ROWS - t_lo : 0;   // kv tiles with a visible key

  auto load_kv = [&](int j) {   // kv tile t_lo + j into stage j % STAGES
    const int s = j % STAGES, k0 = (t_lo + j) * ROWS;
    mbar_expect_tx(&full[s], 2 * L::TILE_BYTES);
#pragma unroll
    for (int c = 0; c < BOXES; ++c) {
      const uint32_t at = s * L::TILE_BYTES + c * ROWS * ROW;
      tma_load(sK + at, &tm_k, &full[s], c * BOX, kvh, k0, b);
      tma_load(sV + at, &tm_v, &full[s], c * BOX, kvh, k0, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], blockDim.x);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n > 0) {
    mbar_expect_tx(bar_q, 2 * L::TILE_BYTES);
#pragma unroll
    for (int c = 0; c < BOXES; ++c) {
      tma_load(sQ + c * ROWS * ROW, &tm_q, bar_q, c * BOX, h, q0, b);
      tma_load(sdO + c * ROWS * ROW, &tm_do, bar_q, c * BOX, h, q0, b);
    }
    for (int j = 0; j < min(STAGES, n); ++j) load_kv(j);
  }

  // Delta = rowsum(dO * O) and lse in base 2 of the warp's 16 rows, kept
  // for this thread's rows and stored (0 past S) for the dK/dV kernel
  const size_t q_stride = (size_t)p.H * D;
  const size_t q_off = ((size_t)b * p.S * p.H + h) * D;
  const bf16* ob = static_cast<const bf16*>(p.o) + q_off;
  const bf16* dob = static_cast<const bf16*>(p.dout) + q_off;
  const size_t pad_off = ((size_t)b * p.H + h) * p.s_pad;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  float d0 = 0.f, d1 = 0.f, l0 = 0.f, l1 = 0.f;
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    float acc = 0.f, l2 = 0.f;
    if (row < p.S) {
#pragma unroll
      for (int c = 2 * lane; c < D; c += 64) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ob + (size_t)row * q_stride + c));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dob + (size_t)row * q_stride + c));
        acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
      }
      l2 = p.lse[((size_t)b * p.H + h) * p.S + row] * LOG2E;
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      p.delta[pad_off + row] = acc;
      p.lse2[pad_off + row] = l2;
    }
    if (r == g) d0 = acc, l0 = l2;
    if (r == g + 8) d1 = acc, l1 = l2;
  }

  const uint32_t q_smem = smem_u32(sQ), do_smem = smem_u32(sdO);
  const float sl = p.scale_log2;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  if (n > 0) mbar_wait(bar_q, 0);

  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    if (tid == 0 && i > 0 && i + STAGES - 1 < n) {
      // the next tile goes where tile i - 1 was: wait until every thread is done with it
      const int j = i + STAGES - 1;
      mbar_wait(&empty[j % STAGES], ((j / STAGES) & 1) ^ 1);
      load_kv(j);
    }
    __syncwarp();
    const int k0 = (t_lo + i) * ROWS;
    const uint32_t k_s = smem_u32(sK + s * L::TILE_BYTES);
    const uint32_t v_s = smem_u32(sV + s * L::TILE_BYTES);
    mbar_wait(&full[s], (i / STAGES) & 1);
    float sc[32], dp[32];   // S, dP: 64 q rows x 64 kv columns
    qk_product<D, ROWS, ROWS, 32, false>(sc, q_smem, k_s);
    qk_product<D, ROWS, ROWS, 32, false>(dp, do_smem, v_s);
    // test the mask only where a pair of the tile is masked
    const bool edge = k0 + ROWS > p.Sk || (p.causal && k0 + ROWS - 1 > q0) ||
                      (p.window && k0 <= q0 + ROWS - 1 - p.window);
    wgmma_wait_all_but_one();   // S is done; dP may still run
    pin(sc);
#pragma unroll
    for (int e = 0; e < 32; ++e) {   // P, in place of S
      const bool top = (e & 2) == 0;
      sc[e] = ex2(fmaf(sc[e], sl, -(top ? l0 : l1)));
      if (edge && !visible(p, top ? row0 : row1, k0 + (e / 4) * 8 + 2 * t4 + (e & 1)))
        sc[e] = 0.f;
    }
    wgmma_wait_all();
    pin(dp);
    // dS as the A operand of dS K: 8-column blocks 2j and 2j+1 form k-step j
    uint32_t dsf[ROWS / 16][4];
#pragma unroll
    for (int nb = 0; nb < ROWS / 8; ++nb) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[e] = sc[4 * nb + e] * (dp[4 * nb + e] - (e < 2 ? d0 : d1));
      dsf[nb / 2][(nb % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    pv_product<D, ROWS>(dq, dsf, k_s);   // dQ += dS K, K read MN-major
    mbar_arrive(&empty[s]);
  }
  store_rows<D>(static_cast<bf16*>(p.dq) + q_off, q_stride, row0, p.S, dq, p.scale, t4);
}

// ---------------------------------------------------------------------------
// bf16 dK/dV: wgmma, TMA, one warpgroup of 64 kv rows
// ---------------------------------------------------------------------------
// Shared memory: K and V, then STAGES Q tiles and STAGES dO tiles (64 rows
// each: D / 64 boxes of 64 rows x 128 bytes), the stages' lse and Delta,
// the mbarriers.  Two blocks share an SM.
template <int D>
struct DkdvSmem {
  static constexpr int STAGES = 2;
  static constexpr uint32_t TILE_BYTES = ROWS * D * 2;
  static constexpr uint32_t VEC_BYTES = ROWS * 4;
  static constexpr uint32_t STAGE_TX = 2 * TILE_BYTES + 2 * VEC_BYTES;
  static constexpr size_t BYTES =
      1024 + 2 * TILE_BYTES + STAGES * STAGE_TX + 8 * (1 + 2 * STAGES);   // 1024: alignment
};

template <int D>
__global__ void __launch_bounds__(128, 2)
    flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, Params p) {
  using L = DkdvSmem<D>;
  constexpr int STAGES = L::STAGES;
  constexpr int BOXES = D / BOX;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sV = sK + L::TILE_BYTES;
  unsigned char* sQ = sV + L::TILE_BYTES;
  unsigned char* sdO = sQ + STAGES * L::TILE_BYTES;
  float* sL = reinterpret_cast<float*>(sdO + STAGES * L::TILE_BYTES);   // [STAGES][ROWS]
  float* sDl = sL + STAGES * ROWS;                                       // [STAGES][ROWS]
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sDl + STAGES * ROWS);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / p.KV, kvh = blockIdx.x % p.KV;
  const int group = p.H / p.KV;
  // causal: the first kv tiles see the most q tiles, and blockIdx.y = 0 launches first
  const int k0 = blockIdx.y * ROWS;
  int lo, hi;
  q_range(p, k0, ROWS, lo, hi);
  const int t_lo = lo / ROWS;
  const int nq = hi > lo ? (hi + ROWS - 1) / ROWS - t_lo : 0;   // q tiles a head
  const int n = group * nq;                                     // (head, q tile) items

  auto load_q = [&](int j) {   // item j into stage j % STAGES
    const int s = j % STAGES, h = kvh * group + j / nq, q0 = (t_lo + j % nq) * ROWS;
    mbar_expect_tx(&full[s], L::STAGE_TX);
#pragma unroll
    for (int c = 0; c < BOXES; ++c) {
      const uint32_t at = s * L::TILE_BYTES + c * ROWS * ROW;
      tma_load(sQ + at, &tm_q, &full[s], c * BOX, h, q0, b);
      tma_load(sdO + at, &tm_do, &full[s], c * BOX, h, q0, b);
    }
    const size_t off = ((size_t)b * p.H + h) * p.s_pad + q0;
    bulk_load(sL + s * ROWS, p.lse2 + off, L::VEC_BYTES, &full[s]);
    bulk_load(sDl + s * ROWS, p.delta + off, L::VEC_BYTES, &full[s]);
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], blockDim.x);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n > 0) {
    mbar_expect_tx(bar_kv, 2 * L::TILE_BYTES);
#pragma unroll
    for (int c = 0; c < BOXES; ++c) {
      tma_load(sK + c * ROWS * ROW, &tm_k, bar_kv, c * BOX, kvh, k0, b);
      tma_load(sV + c * ROWS * ROW, &tm_v, bar_kv, c * BOX, kvh, k0, b);
    }
    for (int j = 0; j < min(STAGES, n); ++j) load_q(j);
  }

  const int krow0 = k0 + warp * 16 + g, krow1 = krow0 + 8;
  const uint32_t k_smem = smem_u32(sK), v_smem = smem_u32(sV);
  const float sl = p.scale_log2;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  if (n > 0) mbar_wait(bar_kv, 0);

  // Item i - 1's dV and dK products run on while item i's S^T and dP^T
  // are issued; its stage is released once they are done.
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    const int q0 = (t_lo + i % nq) * ROWS;
    const uint32_t q_s = smem_u32(sQ + s * L::TILE_BYTES);
    const uint32_t do_s = smem_u32(sdO + s * L::TILE_BYTES);
    const float* lse2 = sL + s * ROWS;
    const float* delta = sDl + s * ROWS;
    mbar_wait(&full[s], (i / STAGES) & 1);
    float st[32], dpt[32];   // S^T, dP^T: 64 kv rows x 64 q columns
    qk_product<D, ROWS, ROWS, 32, false>(st, k_smem, q_s);
    qk_product<D, ROWS, ROWS, 32, false>(dpt, v_smem, do_s);
    // test the mask only where a pair of the tile is masked
    const bool edge = q0 + ROWS > p.S || k0 + ROWS > p.Sk ||
                      (p.causal && k0 + ROWS - 1 > q0) ||
                      (p.window && q0 + ROWS - 1 >= k0 + p.window);
    wgmma_wait_all_but_one();   // S^T and item i - 1's products are done; dP^T may still run
    pin(st);
    if (i > 0) {
      mbar_arrive(&empty[(i - 1) % STAGES]);
      if (tid == 0 && i + STAGES - 1 < n) {
        // the next item goes where item i - 1 was: wait until every thread is done with it
        const int j = i + STAGES - 1;
        mbar_wait(&empty[j % STAGES], ((j / STAGES) & 1) ^ 1);
        load_q(j);
      }
      __syncwarp();
    }
    // P^T (in place of S^T) and then dS^T as A operands: 8-column blocks
    // 2j and 2j+1 form k-step j; this thread's q columns are c, c + 1
    uint32_t pf[ROWS / 16][4], dsf[ROWS / 16][4];
#pragma unroll
    for (int nb = 0; nb < ROWS / 8; ++nb) {
      const int c = nb * 8 + 2 * t4;
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& pe = st[4 * nb + e];
        pe = ex2(fmaf(pe, sl, -((e & 1) ? l2.y : l2.x)));
        if (edge && !visible(p, q0 + c + (e & 1), (e & 2) ? krow1 : krow0)) pe = 0.f;
      }
      pf[nb / 2][(nb % 2) * 2 + 0] = pack_bf16(st[4 * nb], st[4 * nb + 1]);
      pf[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(st[4 * nb + 2], st[4 * nb + 3]);
    }
    pv_product<D, ROWS, false>(dv, pf, do_s);    // dV += P^T dO, in flight
    wgmma_wait_all_but_one();   // dP^T is done
    pin(dpt);
#pragma unroll
    for (int nb = 0; nb < ROWS / 8; ++nb) {
      const float2 d2 = *reinterpret_cast<const float2*>(delta + nb * 8 + 2 * t4);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[e] = st[4 * nb + e] * (dpt[4 * nb + e] - ((e & 1) ? d2.y : d2.x));
      dsf[nb / 2][(nb % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    pv_product<D, ROWS, false>(dk, dsf, q_s);    // dK += dS^T Q, in flight
  }
  wgmma_wait_all();
  pin(dv);
  pin(dk);
  const size_t kv_stride = (size_t)p.KV * D;
  const size_t kv_off = ((size_t)b * p.Sk * p.KV + kvh) * D;
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
int launch_bf16(const Params& p, const long long* layout, cudaStream_t stream) {
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  int err = encode(&tm_q, p.q, layout, ROWS);
  if (!err) err = encode(&tm_do, p.dout, layout, ROWS);
  if (!err) err = encode(&tm_k, p.k, layout + 11, ROWS);
  if (!err) err = encode(&tm_v, p.v, layout + 11, ROWS);
  if (err) return err;
  static uint32_t opted_dq = 0, opted_dkdv = 0;   // a bit per device
  err = opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dq_bf16<D>), DqSmem<D>::BYTES,
                    opted_dq);
  if (!err)
    err = opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dkdv_bf16<D>), DkdvSmem<D>::BYTES,
                      opted_dkdv);
  if (err) return err;
  flash_bwd_dq_bf16<D><<<dim3(p.B * p.H, (p.S + ROWS - 1) / ROWS), 128, DqSmem<D>::BYTES,
                         stream>>>(tm_q, tm_do, tm_k, tm_v, p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_bf16<D><<<dim3(p.B * p.KV, (p.Sk + ROWS - 1) / ROWS), 128, DkdvSmem<D>::BYTES,
                           stream>>>(tm_q, tm_do, tm_k, tm_v, p);
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
// forward.  scratch: 2 * B * H * s_pad fp32, s_pad = S rounded up to 64.
// layout: for bf16, the TMA layouts of q (also dout's) and of k (also
// v's) with boxes of 64 rows, 11 values each, as
// kernels/flash_attention.py:tma_layout computes them; unused for fp32.
// The two kernels run in order on `stream`.  Returns cudaGetLastError()
// after the launches, or a negative code from encode().
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, void* dq, void* dk,
                                   void* dv, float* scratch, int B, int S, int Sk, int H, int KV,
                                   int D, int causal, int window, int is_bf16, void* stream,
                                   const long long* layout) {
  const float scale = 1.f / sqrtf((float)D);
  const int s_pad = (S + ROWS - 1) / ROWS * ROWS;
  Params p{q, k, v, o, dout, lse, dq, dk, dv, scratch, scratch + (size_t)B * H * s_pad,
           B, S, Sk, H, KV, causal, window, scale, LOG2E * scale, s_pad};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && layout == nullptr) return (int)cudaErrorInvalidValue;
  if (is_bf16 && D == 64) return launch_bf16<64>(p, layout, st);
  if (is_bf16 && D == 128) return launch_bf16<128>(p, layout, st);
  if (!is_bf16 && D == 64) return launch_f32<64>(p, st);
  if (!is_bf16 && D == 128) return launch_f32<128>(p, st);
  return (int)cudaErrorInvalidValue;
}
