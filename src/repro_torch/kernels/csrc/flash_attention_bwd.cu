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
//                   (at (256, 256) and (192, 128) flash_bwd_dq_bf16_pair,
//                   128 q rows a block, below)
//   flash_bwd_dkdv  grid (B*KV, kv tiles): over the q heads of the kv head's
//                   GQA group and their q tiles dV += P^T dO,
//                   dK += dS^T Q / sqrt(D), so the group's sum is taken in
//                   the block and needs no second reduction (but where the
//                   two-warpgroup kernel splits the group into head shares,
//                   below)
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
//  * At D 64 and 128 a block is one warpgroup: its 64 kv rows (dK/dV) or
//    64 q rows (dQ) stay in shared memory, and the other side streams
//    through a ring of 64-row stages by TMA (128-byte swizzle, 64-column
//    boxes), with a "full" mbarrier per stage counting the TMA's bytes and
//    an "empty" one taking every thread's arrival; one elected thread keeps
//    the ring STAGES - 1 tiles ahead.  The dK/dV stage also brings the q tile's lse
//    and Delta (a 256-byte bulk copy each from a scratch padded to whole
//    tiles, which the dQ kernel writes).  Within a tile, exp2 of S runs
//    while dP is in flight, and the dV product while dS is formed; the
//    dK/dV kernel also issues a tile's S^T and dP^T while the previous
//    tile's dV and dK products finish.
//  * Registers decide occupancy, as in the forward: the dQ kernel keeps to
//    128 at D 64, so four blocks share an SM, the dK/dV kernel (dK, dV,
//    S^T and dP^T in registers) two.  Measured slower there (PERF.md §6): two
//    warpgroups a block, deeper rings, three dK/dV blocks an SM.
//  * TMA zero-fills rows past S or Sk, so ragged lengths need no padding
//    copy.  Masks are tested on edge tiles only (the causal diagonal, the
//    window's ends, the ragged ends); tiles with no visible pair are
//    neither loaded nor computed.
//  * Heaviest blocks first: under the causal mask the first kv tiles
//    (dK/dV) and the last q tiles (dQ) run longest, and launch first
//    (within each group of ORDER_UNITS (batch, head) units at D 256 and
//    (192, 128)).
//  * GQA by index through the tensor maps: no copy of K or V.
// fp32 inputs take SIMT kernels, one warp a row, exact in fp32.
//
// Head dims: (64, 64) and (128, 128) as above; (256, 256) (recurrentgemma-9b)
// and (192, 128) (deepseek-v3's multi-head latent attention: q/k 192, v
// 128) in bf16 take a dQ kernel and a dK/dV kernel of two
// warpgroups (flash_bwd_dkdv_bf16_split): at D 256 one warpgroup's dK and
// dV of 64 kv rows are 2 x 64 x 256 / 128 = 256 fp32 registers a thread,
// past the 255 limit.  So each warpgroup owns whole 64-column boxes of dK
// and dV (at D 256 two of each; at (192, 128) the first warpgroup two of
// dK's three and one of dV's two, the second the rest).  S^T and dP^T are
// formed once a block: each warpgroup takes 32 of an item's 64 q columns
// (m64n32 over all of DK or DV), writes its half of P^T and dS^T to shared
// memory as bf16 in the swizzled K-major layout a wgmma A descriptor reads,
// and after a named barrier of both warpgroups (one for P^T, one for dS^T)
// runs its column slices of dV += P^T dO and dK += dS^T Q with A read from
// there.  P^T and dS^T alternate between two tiles each, so one barrier
// pair an item orders all reuse; item i's S^T and dP^T are issued while
// item i - 1's dV and dK run, and dV while dS^T is formed.  K and V (64 kv
// rows) stay in 64 KB of shared memory at D 256, two 64-row stages of Q
// and dO take 128 KB, P^T and dS^T 32 KB (226 KB of 227).  One block an
// SM: where B * KV * kv tiles fill fewer than two waves (recurrentgemma's
// MQA at B 1 and 2: 40 and 80 blocks), the launcher splits each kv tile's
// q heads into head shares over as many blocks
// (kernels/flash_attention.py:bwd_head_shares); each writes fp32 partial
// dK and dV to a scratch, and flash_bwd_sum_shares adds the shares in
// their order, scales dK and rounds once: deterministic, no atomics.
// Blocks go in groups of eight (batch, kv head, share) units, kv tile by
// kv tile, so that the blocks in flight read a few heads' q and dO rows
// from L2 (ORDER_UNITS; MLA's 128 kv heads otherwise miss it).
// The dQ kernel there (flash_bwd_dq_bf16_pair): the one-warpgroup kernel
// ran one block an SM at these widths (121-192 KB of shared memory), a
// serial chain a kv tile (S and dP, exp2, dS, the dQ product), and its
// (batch, head)-fastest grid made a wave's blocks read 132 MLA heads' K
// and V, past L2.  Now a block holds 128 q rows of one head: two
// warpgroups, each with its own 64 rows of Q and dO, running the whole
// m64n64 S and dP (m64n32 at D 256) and the m64n192 (m64n256) dQ product,
// over one ring of three K/V stages both read (64 kv rows at (192, 128),
// 206 KB; 32 at D 256, where Q and dO of 128 rows take 128 KB, 230 KB).
// Each K/V tile so serves 128 q rows, the two chains interleave on the
// tensor cores, and a tile's dQ product stays in flight while the next
// tile's S and dP are issued.  The ring streams the union of the two
// warpgroups' kv tiles; a warpgroup that sees no key of a tile (the first
// one's last causal tile, a window's edge, rows all past S) waits for it
// and releases it all the same, so that each arrival on a stage's "empty"
// counts toward that tile's phase.  Blocks go in groups of ORDER_UNITS
// (batch, head) units, q tile by q tile, heaviest first; the Delta / lse
// scratch is padded to 128 rows (kernels/flash_attention.py:
// bwd_scratch_rows).  What bounds it on an H100 80GB HBM3 at 700 W
// (PERF.md §6): at MLA's training shape (B 2, S 1024, 128 heads) its own
// bound is bytes, 0.151 ms, and it takes 0.374 ms; cut-out probes read
// 0.231 ms with no tile computed (prologue, K/V stream, store: one block
// an SM overlaps none of them), 0.271 without the dQ product, 0.308
// without exp2.  So the Delta prologue reads a warp's 16 rows at once.
// Measured slower: a producer warp of its own (288 threads, which ptxas
// held to 168 registers, spilling) and clusters of two CTAs that share
// each K/V tile by TMA multicast (each ring then waits on both CTAs).
// At (192, 128) the two products differ in depth (S over 192, dP over
// 128), dO and V have tensor maps of their own (two boxes against q's and
// k's three), Delta sums over v's 128 columns, and the scale is
// 1 / sqrt(192).  dQ += dS K is one m64n192k16 a k-step; at D 256 the K
// and V maps are encoded again with 32-row boxes for the dQ kernel.
// The smoke configs' head dims, (16, 16) and (24, 16), take the SIMT
// kernels in both dtypes (T, the element type in memory; fp32 arithmetic):
// their tiles are not whole 64-column TMA boxes.  The route is chosen by
// head dims and dtype only.

#include <math.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int ROWS = 64;   // bf16: rows of a warpgroup's tile, of a stage and of a TMA box
constexpr int WR = 8;      // fp32 blocks: 8 warps, one row each
constexpr int TN = 32;     // SIMT kernels: rows of a staged tile (16 where 32 do not fit)

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
  float* delta;           // scratch: rowsum(dO * O), (B, H, S) SIMT, (B, H, s_pad) wgmma
  float* lse2;            // wgmma scratch: (B, H, s_pad) lse * log2(e); both 0 past S
  int B, S, Sk, H, KV;
  int causal, window;
  float scale;            // 1 / sqrt(DK)
  float scale_log2;       // log2(e) / sqrt(DK): scores in base 2
  int s_pad;              // S rounded up to the dQ block's rows (64; 128 in pairs)
};

// the two-warpgroup dK/dV kernel's head shares, an argument of its own:
// with these two fields in Params, ptxas compiled the dQ and the
// one-warpgroup dK/dV kernels differently (serialized wgmma, 5-40% slower
// on the card), though none of them reads the fields
struct Shares {
  float* part;            // (n, B, Sk, KV, DK + DV) fp32 partial sums, for n > 1
  int n;                  // head shares a kv tile's (head, q tile) items are split into
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
// bf16 dQ at D 64 and 128: wgmma, TMA, one warpgroup of 64 q rows
// ---------------------------------------------------------------------------
// Shared memory: Q and dO, then STAGES K tiles and STAGES V tiles (64 rows
// each: DK / 64 or DV / 64 boxes of 64 rows x 128 bytes), the mbarriers.
// At D 64 the kernel keeps to 128 registers, so four blocks share an SM;
// at D 128 two.
template <int DK, int DV>
struct DqSmem {
  static constexpr int STAGES = 2;
  static constexpr int BLOCKS_PER_SM = DK == 64 ? 4 : 2;
  static constexpr uint32_t K_BYTES = ROWS * DK * 2;   // a Q or a K tile
  static constexpr uint32_t V_BYTES = ROWS * DV * 2;   // a dO or a V tile
  static constexpr size_t BYTES =
      1024 + (1 + STAGES) * (K_BYTES + V_BYTES) + 8 * (1 + 2 * STAGES);   // 1024: alignment
};

template <int DK, int DV>
__global__ void __launch_bounds__(128, DqSmem<DK, DV>::BLOCKS_PER_SM)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, Params p) {
  using L = DqSmem<DK, DV>;
  constexpr int STAGES = L::STAGES;
  constexpr int K_BOXES = DK / BOX, V_BOXES = DV / BOX;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sdO = sQ + L::K_BYTES;
  unsigned char* sK = sdO + L::V_BYTES;
  unsigned char* sV = sK + STAGES * L::K_BYTES;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + STAGES * L::V_BYTES);
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
    mbar_expect_tx(&full[s], L::K_BYTES + L::V_BYTES);
#pragma unroll
    for (int c = 0; c < K_BOXES; ++c)
      tma_load(sK + s * L::K_BYTES + c * ROWS * ROW, &tm_k, &full[s], c * BOX, kvh, k0, b);
#pragma unroll
    for (int c = 0; c < V_BOXES; ++c)
      tma_load(sV + s * L::V_BYTES + c * ROWS * ROW, &tm_v, &full[s], c * BOX, kvh, k0, b);
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
    mbar_expect_tx(bar_q, L::K_BYTES + L::V_BYTES);
#pragma unroll
    for (int c = 0; c < K_BOXES; ++c) tma_load(sQ + c * ROWS * ROW, &tm_q, bar_q, c * BOX, h, q0, b);
#pragma unroll
    for (int c = 0; c < V_BOXES; ++c)
      tma_load(sdO + c * ROWS * ROW, &tm_do, bar_q, c * BOX, h, q0, b);
    for (int j = 0; j < min(STAGES, n); ++j) load_kv(j);
  }

  // Delta = rowsum(dO * O) over DV and lse in base 2 of the warp's 16
  // rows, kept for this thread's rows and stored (0 past S) for the dK/dV
  // kernel
  const size_t q_stride = (size_t)p.H * DK, o_stride = (size_t)p.H * DV;
  const size_t q_off = ((size_t)b * p.S * p.H + h) * DK;
  const size_t o_off = ((size_t)b * p.S * p.H + h) * DV;
  const bf16* ob = static_cast<const bf16*>(p.o) + o_off;
  const bf16* dob = static_cast<const bf16*>(p.dout) + o_off;
  const size_t pad_off = ((size_t)b * p.H + h) * p.s_pad;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  float d0 = 0.f, d1 = 0.f, l0 = 0.f, l1 = 0.f;
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    float acc = 0.f, l2 = 0.f;
    if (row < p.S) {
#pragma unroll
      for (int c = 2 * lane; c < DV; c += 64) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ob + (size_t)row * o_stride + c));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dob + (size_t)row * o_stride + c));
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
  float dq[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dq[i] = 0.f;
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
    const uint32_t k_s = smem_u32(sK + s * L::K_BYTES);
    const uint32_t v_s = smem_u32(sV + s * L::V_BYTES);
    mbar_wait(&full[s], (i / STAGES) & 1);
    float sc[32], dp[32];   // S, dP: 64 q rows x 64 kv columns
    qk_product<DK, ROWS, ROWS, 32, false>(sc, q_smem, k_s);
    qk_product<DV, ROWS, ROWS, 32, false>(dp, do_smem, v_s);
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
    pv_product<DK, ROWS>(dq, dsf, k_s);   // dQ += dS K, K read MN-major
    mbar_arrive(&empty[s]);
  }
  store_rows<DK>(static_cast<bf16*>(p.dq) + q_off, q_stride, row0, p.S, dq, p.scale, t4);
}

// ---------------------------------------------------------------------------
// bf16 dQ at (192, 128) and (256, 256): two warpgroups of 64 q rows, 128 q
// rows of one head a block, over one ring of K/V stages (see the header)
// ---------------------------------------------------------------------------
// Shared memory: each warpgroup's Q and dO tile (64 rows), then STAGES K
// and V stages of KR rows (DK / 64 or DV / 64 boxes of KR rows x 128
// bytes), the mbarriers; one block an SM.  At D 256 the two warpgroups' Q
// and dO take 128 KB, so a stage holds 32 kv rows.
template <int DK, int DV>
struct PairSmem {
  static constexpr int KR = DK == 256 ? 32 : ROWS;   // kv rows of a stage
  static constexpr int STAGES = 3;
  static constexpr int Q_ROWS = 2 * ROWS;             // q rows of a block
  static constexpr uint32_t Q_BYTES = ROWS * DK * 2;    // a warpgroup's Q tile
  static constexpr uint32_t DO_BYTES = ROWS * DV * 2;   // a warpgroup's dO tile
  static constexpr uint32_t K_BYTES = KR * DK * 2;      // a K stage
  static constexpr uint32_t V_BYTES = KR * DV * 2;      // a V stage
  static constexpr size_t BYTES = 1024 + 2 * (Q_BYTES + DO_BYTES) +
                                  STAGES * (K_BYTES + V_BYTES) + 8 * (1 + 2 * STAGES);
  static_assert(BYTES <= 232448, "over the shared memory of an SM");
};

// units (b, head) of a launch ordered in groups of ORDER_UNITS, each
// group's blocks tile by tile (see flash_bwd_dkdv_bf16_split): the blocks
// in flight read the K and V of a few heads, which stay in L2
constexpr int ORDER_UNITS = 8;

// grid (B * H * q tiles of 128 rows) in the order above, the last q tiles
// (the heaviest under the causal mask) first within a group
template <int DK, int DV>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_dq_bf16_pair(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, Params p) {
  using L = PairSmem<DK, DV>;
  constexpr int STAGES = L::STAGES, KR = L::KR;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sdO = sQ + 2 * L::Q_BYTES;
  unsigned char* sK = sdO + 2 * L::DO_BYTES;
  unsigned char* sV = sK + STAGES * L::K_BYTES;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + STAGES * L::V_BYTES);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = tid >> 7;
  const int g = lane >> 2, t4 = lane & 3;
  const int units = p.B * p.H, tiles = (p.S + L::Q_ROWS - 1) / L::Q_ROWS;
  const int grp = blockIdx.x / (ORDER_UNITS * tiles), in = blockIdx.x % (ORDER_UNITS * tiles);
  const int width = min(ORDER_UNITS, units - grp * ORDER_UNITS);
  const int unit = grp * ORDER_UNITS + in % width;
  const int b = unit / p.H, h = unit % p.H;
  const int kvh = h / (p.H / p.KV);
  const int qt = p.causal ? tiles - 1 - in / width : in / width;
  const int q0 = qt * L::Q_ROWS, qw = q0 + wg * ROWS;   // the block's, the warpgroup's first row
  int lo, hi;
  kv_range(p, q0, L::Q_ROWS, lo, hi);   // both warpgroups' kv rows: the ring streams these
  const int t_lo = lo / KR;
  const int n = hi > lo ? (hi + KR - 1) / KR - t_lo : 0;   // kv tiles with a visible key
  int wlo, whi;   // this warpgroup's; none where all its rows lie past S
  kv_range(p, qw, ROWS, wlo, whi);
  if (qw >= p.S) whi = wlo;

  auto load_kv = [&](int j) {   // kv tile t_lo + j into stage j % STAGES
    const int s = j % STAGES, k0 = (t_lo + j) * KR;
    mbar_expect_tx(&full[s], L::K_BYTES + L::V_BYTES);
#pragma unroll
    for (int c = 0; c < DK / BOX; ++c)
      tma_load(sK + s * L::K_BYTES + c * KR * ROW, &tm_k, &full[s], c * BOX, kvh, k0, b);
#pragma unroll
    for (int c = 0; c < DV / BOX; ++c)
      tma_load(sV + s * L::V_BYTES + c * KR * ROW, &tm_v, &full[s], c * BOX, kvh, k0, b);
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
    // the second warpgroup's rows only where one of them lies below S
    const int live = q0 + ROWS < p.S ? 2 : 1;
    mbar_expect_tx(bar_q, live * (L::Q_BYTES + L::DO_BYTES));
    for (int w = 0; w < live; ++w) {
#pragma unroll
      for (int c = 0; c < DK / BOX; ++c)
        tma_load(sQ + w * L::Q_BYTES + c * ROWS * ROW, &tm_q, bar_q, c * BOX, h, q0 + w * ROWS, b);
#pragma unroll
      for (int c = 0; c < DV / BOX; ++c)
        tma_load(sdO + w * L::DO_BYTES + c * ROWS * ROW, &tm_do, bar_q, c * BOX, h,
                 q0 + w * ROWS, b);
    }
    for (int j = 0; j < min(STAGES, n); ++j) load_kv(j);
  }

  // Delta = rowsum(dO * O) over DV and lse in base 2 of the warp's 16
  // rows, kept for this thread's rows and stored (0 past S) for the dK/dV
  // kernel; the scratch is padded to whole blocks of 128 rows.  One block
  // takes an SM, so this prologue overlaps no compute: each lane reads
  // DV / 32 columns of all 16 rows at once (one row after another took
  // 0.11 ms more at MLA's B 2, H100 80GB HBM3 at 700 W), rows past S read
  // row S - 1 and count 0, and lane r < 16 stores row r's values
  const size_t q_stride = (size_t)p.H * DK, o_stride = (size_t)p.H * DV;
  const size_t q_off = ((size_t)b * p.S * p.H + h) * DK;
  const size_t o_off = ((size_t)b * p.S * p.H + h) * DV;
  const bf16* ob = static_cast<const bf16*>(p.o) + o_off;
  const bf16* dob = static_cast<const bf16*>(p.dout) + o_off;
  const size_t pad_off = ((size_t)b * p.H + h) * p.s_pad;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;   // warp * 16 = qw - q0 + (warp % 4) * 16
  constexpr int PER = DV / 32;
  using Vec = typename std::conditional<PER == 8, uint4, uint2>::type;
  const int my_row = q0 + warp * 16 + (lane & 15);
  const float my_l = my_row < p.S ? p.lse[((size_t)b * p.H + h) * p.S + my_row] * LOG2E : 0.f;
  float part[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = min(q0 + warp * 16 + r, p.S - 1);
    const Vec x = *reinterpret_cast<const Vec*>(ob + (size_t)row * o_stride + PER * lane);
    const Vec y = *reinterpret_cast<const Vec*>(dob + (size_t)row * o_stride + PER * lane);
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < PER / 2; ++c) {
      const float2 xf = __bfloat1622float2(xp[c]), yf = __bfloat1622float2(yp[c]);
      acc = fmaf(xf.x, yf.x, fmaf(xf.y, yf.y, acc));
    }
    part[r] = acc;
  }
  float my_d = 0.f;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float sum = warp_sum(part[r]);
    if ((lane & 15) == r) my_d = q0 + warp * 16 + r < p.S ? sum : 0.f;
  }
  if (lane < 16) {
    p.delta[pad_off + my_row] = my_d;
    p.lse2[pad_off + my_row] = my_l;
  }
  const float d0 = __shfl_sync(0xffffffffu, my_d, g), d1 = __shfl_sync(0xffffffffu, my_d, g + 8);
  const float l0 = __shfl_sync(0xffffffffu, my_l, g), l1 = __shfl_sync(0xffffffffu, my_l, g + 8);

  const uint32_t q_smem = smem_u32(sQ + wg * L::Q_BYTES);
  const uint32_t do_smem = smem_u32(sdO + wg * L::DO_BYTES);
  const float sl = p.scale_log2;
  float dq[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dq[i] = 0.f;
  if (n > 0) mbar_wait(bar_q, 0);

  // A tile's dQ product runs on while the next tile's S and dP are issued;
  // its stage is released (`pend`) once they are done.  A warpgroup that
  // sees no key of a tile still waits for it and releases it, so that
  // every arrival on a stage's `empty` counts toward that tile's phase.
  int pend = -1;
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES, k0 = (t_lo + i) * KR;
    const uint32_t k_s = smem_u32(sK + s * L::K_BYTES);
    const uint32_t v_s = smem_u32(sV + s * L::V_BYTES);
    mbar_wait(&full[s], (i / STAGES) & 1);
    if (k0 < whi && k0 + KR > wlo) {
      float sc[KR / 2], dp[KR / 2];   // S, dP: 64 q rows x KR kv columns
      qk_product<DK, ROWS, KR, KR / 2, false>(sc, q_smem, k_s);
      qk_product<DV, ROWS, KR, KR / 2, false>(dp, do_smem, v_s);
      // test the mask only where a pair of the tile is masked
      const bool edge = k0 + KR > p.Sk || (p.causal && k0 + KR - 1 > qw) ||
                        (p.window && k0 <= qw + ROWS - 1 - p.window);
      wgmma_wait_all_but_one();   // the last dQ product and S are done; dP may still run
      pin(sc);
      if (pend >= 0) mbar_arrive(&empty[pend]);
#pragma unroll
      for (int e = 0; e < KR / 2; ++e) {   // P, in place of S
        const bool top = (e & 2) == 0;
        sc[e] = ex2(fmaf(sc[e], sl, -(top ? l0 : l1)));
        if (edge && !visible(p, top ? row0 : row1, k0 + (e / 4) * 8 + 2 * t4 + (e & 1)))
          sc[e] = 0.f;
      }
      wgmma_wait_all();
      pin(dp);
      // dS as the A operand of dS K: 8-column blocks 2j and 2j+1 form k-step j
      uint32_t dsf[KR / 16][4];
#pragma unroll
      for (int nb = 0; nb < KR / 8; ++nb) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = sc[4 * nb + e] * (dp[4 * nb + e] - (e < 2 ? d0 : d1));
        dsf[nb / 2][(nb % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
        dsf[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      pv_product<DK, KR, false>(dq, dsf, k_s);   // dQ += dS K, K read MN-major, in flight
      pend = s;
    } else {
      if (pend >= 0) {
        wgmma_wait_all();
        mbar_arrive(&empty[pend]);
        pend = -1;
      }
      mbar_arrive(&empty[s]);
    }
    if (tid == 0 && i > 0 && i + STAGES - 1 < n) {
      // the next tile goes where tile i - 1 was: wait until both warpgroups are done with it
      const int j = i + STAGES - 1;
      mbar_wait(&empty[j % STAGES], ((j / STAGES) & 1) ^ 1);
      load_kv(j);
    }
    __syncwarp();
  }
  wgmma_wait_all();
  pin(dq);
  store_rows<DK>(static_cast<bf16*>(p.dq) + q_off, q_stride, row0, p.S, dq, p.scale, t4);
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
// bf16 dK/dV at (256, 256) and (192, 128): two warpgroups of the same 64 kv
// rows, over one head share of the kv head's group (see the header)
// ---------------------------------------------------------------------------
// Shared memory: K and V, then STAGES Q tiles and STAGES dO tiles, two
// P^T and two dS^T tiles (64 x 64 bf16, one box each), the stages' lse and
// Delta, the mbarriers; one block an SM.
template <int DK, int DV>
struct SplitSmem {
  static constexpr int STAGES = 2;
  static constexpr uint32_t K_BYTES = ROWS * DK * 2;   // a K or a Q tile
  static constexpr uint32_t V_BYTES = ROWS * DV * 2;   // a V or a dO tile
  static constexpr uint32_t PS_BYTES = ROWS * ROWS * 2;   // a P^T or a dS^T tile
  static constexpr uint32_t VEC_BYTES = ROWS * 4;
  static constexpr uint32_t STAGE_TX = K_BYTES + V_BYTES + 2 * VEC_BYTES;
  static constexpr size_t BYTES = 1024 + (1 + STAGES) * (K_BYTES + V_BYTES) + 4 * PS_BYTES +
                                  STAGES * 2 * VEC_BYTES + 8 * (1 + 2 * STAGES);
  static_assert(BYTES <= 232448, "over the shared memory of an SM");
};

// the first warpgroup's columns of a D-column gradient: half its boxes,
// rounded up; the second warpgroup takes the rest
template <int D>
__host__ __device__ constexpr int first_cols() { return (D / BOX + 1) / 2 * BOX; }

// the block's tiles in shared memory
struct SplitTiles {
  unsigned char *k, *v, *q, *dout, *pt, *dst;
  float *lse2, *delta;
};

// (head, q tile) item j of a dK/dV block into stage j % STAGES: its Q and
// dO tiles by TMA, its rows' lse and Delta by bulk copy, all on full[s].
// The block's items are the q tiles of heads h0, h0 + 1, ..., nq a head.
template <int DK, int DV>
__device__ __forceinline__ void split_load_item(const Params& p, const CUtensorMap* tm_q,
                                                const CUtensorMap* tm_do, const SplitTiles& t,
                                                uint64_t* full, int b, int h0, int t_lo, int nq,
                                                int j) {
  using L = SplitSmem<DK, DV>;
  const int s = j % L::STAGES, h = h0 + j / nq, q0 = (t_lo + j % nq) * ROWS;
  mbar_expect_tx(&full[s], L::STAGE_TX);
#pragma unroll
  for (int c = 0; c < DK / BOX; ++c)
    tma_load(t.q + s * L::K_BYTES + c * ROWS * ROW, tm_q, &full[s], c * BOX, h, q0, b);
#pragma unroll
  for (int c = 0; c < DV / BOX; ++c)
    tma_load(t.dout + s * L::V_BYTES + c * ROWS * ROW, tm_do, &full[s], c * BOX, h, q0, b);
  const size_t off = ((size_t)b * p.H + h) * p.s_pad + q0;
  bulk_load(t.lse2 + s * ROWS, p.lse2 + off, L::VEC_BYTES, &full[s]);
  bulk_load(t.delta + s * ROWS, p.delta + off, L::VEC_BYTES, &full[s]);
}

// this thread's values of a 64 x 32 accumulator (rows r0 and r0 + 8, the
// warpgroup's q columns c0 .. c0 + 31) as bf16 into a 64 x 64 tile laid
// out as TMA writes a box with the 128-byte swizzle (16-byte chunk c of
// row r at chunk c ^ (r % 8)), which a K-major wgmma A descriptor reads
__device__ __forceinline__ void store_swizzled(unsigned char* tile, const float (&x)[16], int c0,
                                               int r0, int t4) {
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const int chunk = c0 / 8 + nb;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      *reinterpret_cast<uint32_t*>(tile + r * ROW + ((chunk ^ (r & 7)) << 4) + 4 * t4) =
          pack_bf16(x[4 * nb + 2 * half], x[4 * nb + 2 * half + 1]);
    }
  }
}

// G (64 x N, fp32) += A (64 x 64 at shared address a, bf16, K-major, one
// box) B (64 x N at shared address b, MN-major, N / 64 boxes), left in
// flight
template <int N>
__device__ __forceinline__ void ss_product(float (&acc)[N / 2], uint32_t a, uint32_t b) {
  static_assert(N == 64 || N == 128, "64 or 128 columns");
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < ROWS / 16; ++j) {   // 16 k rows a step
    const uint64_t da = smem_desc(a + j * 32, 1, 64);
    const uint64_t db = smem_desc(b + j * 16 * ROW, ROWS * ROW / 16, 64);
    if constexpr (N == 64) wgmma_ss_n64<0, 1>(acc, da, db, 1);
    else wgmma_ss_n128<0, 1>(acc, da, db, 1);
  }
  wgmma_commit();
}

// rows row0 and row0 + 8 of a wgmma accumulator (64 x D) in fp32 into a
// (rows, D')-strided scratch, unscaled: a head share's partial sum
template <int D>
__device__ __forceinline__ void store_rows_f32(float* base, size_t stride, int row0, int L,
                                               const float (&acc)[D / 2], int t4) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if (row0 < L)
      *reinterpret_cast<float2*>(base + (size_t)row0 * stride + col) =
          make_float2(acc[4 * dt], acc[4 * dt + 1]);
    if (row0 + 8 < L)
      *reinterpret_cast<float2*>(base + (size_t)(row0 + 8) * stride + col) =
          make_float2(acc[4 * dt + 2], acc[4 * dt + 3]);
  }
}

// One warpgroup's share of flash_bwd_dkdv_bf16_split: the S^T and dP^T
// columns [c0, c0 + 32) of each item (c0 = 32 wg), then dK columns [KC0,
// KC0 + WK) and dV columns [VC0, VC0 + WV) of the block's 64 kv rows over
// all 64 q columns, read from the tiles both warpgroups wrote.  Thread 0
// (of the first warpgroup) refills the stages.
template <int DK, int DV, int KC0, int WK, int VC0, int WV>
__device__ __forceinline__ void dkdv_split_part(const Params& p, const CUtensorMap* tm_q,
                                                const CUtensorMap* tm_do, const SplitTiles& t,
                                                const Shares& sh, uint64_t* full, uint64_t* empty,
                                                int b, int kvh, int h0, int share, int k0,
                                                int t_lo, int nq, int n, int wg) {
  using L = SplitSmem<DK, DV>;
  constexpr int STAGES = L::STAGES;
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
  const int t4 = lane & 3, g = lane >> 2;
  const int r0 = warp * 16 + g;                 // this thread's first row of a tile
  const int krow0 = k0 + r0, krow1 = krow0 + 8;
  const int c0 = wg * 32;                       // the warpgroup's q columns of an item
  const uint32_t k_smem = smem_u32(t.k), v_smem = smem_u32(t.v);
  const float sl = p.scale_log2;

  float dk[WK / 2], dv[WV / 2];
#pragma unroll
  for (int i = 0; i < WK / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < WV / 2; ++i) dv[i] = 0.f;

  // Item i - 1's dV and dK products run on while item i's S^T and dP^T
  // are issued; its stage is released once they are done.  P^T and dS^T
  // alternate between two tiles: a warpgroup writes item i's where item
  // i - 2's were read, which both warpgroups finished before they met at
  // item i - 1's first barrier.
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    const int q0 = (t_lo + i % nq) * ROWS;
    const uint32_t q_s = smem_u32(t.q + s * L::K_BYTES);
    const uint32_t do_s = smem_u32(t.dout + s * L::V_BYTES);
    unsigned char* pt = t.pt + (i & 1) * L::PS_BYTES;
    unsigned char* dst = t.dst + (i & 1) * L::PS_BYTES;
    const float* lse2 = t.lse2 + s * ROWS;
    const float* delta = t.delta + s * ROWS;
    mbar_wait(&full[s], (i / STAGES) & 1);
    float st[16], dpt[16];   // S^T, dP^T: 64 kv rows x this warpgroup's 32 q columns
    qk_product<DK, ROWS, ROWS, 16, false>(st, k_smem, q_s + c0 * ROW);
    qk_product<DV, ROWS, ROWS, 16, false>(dpt, v_smem, do_s + c0 * ROW);
    const bool edge = q0 + ROWS > p.S || k0 + ROWS > p.Sk ||
                      (p.causal && k0 + ROWS - 1 > q0) ||
                      (p.window && q0 + ROWS - 1 >= k0 + p.window);
    wgmma_wait_all_but_one();   // item i - 1's products and S^T are done; dP^T may still run
    pin(st);
    if (i > 0) {
      mbar_arrive(&empty[(i - 1) % STAGES]);
      if (tid == 0 && i + STAGES - 1 < n) {
        // the next item goes where item i - 1 was: wait until both warpgroups are done with it
        const int j = i + STAGES - 1;
        mbar_wait(&empty[j % STAGES], ((j / STAGES) & 1) ^ 1);
        split_load_item<DK, DV>(p, tm_q, tm_do, t, full, b, h0, t_lo, nq, j);
      }
      __syncwarp();
    }
    // P^T in place of S^T; this thread's q columns are c, c + 1
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int c = c0 + nb * 8 + 2 * t4;
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& pe = st[4 * nb + e];
        pe = ex2(fmaf(pe, sl, -((e & 1) ? l2.y : l2.x)));
        if (edge && !visible(p, q0 + c + (e & 1), (e & 2) ? krow1 : krow0)) pe = 0.f;
      }
    }
    store_swizzled(pt, st, c0, r0, t4);
    fence_proxy_async();
    named_sync(1, 256);   // both halves of P^T are written
    // dV[:, VC0:VC0+WV] += P^T dO[:, VC0:VC0+WV], in flight while dS^T is formed
    ss_product<WV>(dv, smem_u32(pt), do_s + (VC0 / BOX) * ROWS * ROW);
    wgmma_wait_all_but_one();   // dP^T is done
    pin(dpt);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const float2 d2 = *reinterpret_cast<const float2*>(delta + c0 + nb * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e)   // dS^T in place of dP^T
        dpt[4 * nb + e] = st[4 * nb + e] * (dpt[4 * nb + e] - ((e & 1) ? d2.y : d2.x));
    }
    store_swizzled(dst, dpt, c0, r0, t4);
    fence_proxy_async();
    named_sync(2, 256);   // both halves of dS^T are written
    // dK[:, KC0:KC0+WK] += dS^T Q[:, KC0:KC0+WK]
    ss_product<WK>(dk, smem_u32(dst), q_s + (KC0 / BOX) * ROWS * ROW);
  }
  wgmma_wait_all();
  pin(dv);
  pin(dk);
  if (sh.n == 1) {
    const size_t kv_stride = (size_t)p.KV * DK, v_stride = (size_t)p.KV * DV;
    bf16* dkb = static_cast<bf16*>(p.dk) + ((size_t)b * p.Sk * p.KV + kvh) * DK + KC0;
    bf16* dvb = static_cast<bf16*>(p.dv) + ((size_t)b * p.Sk * p.KV + kvh) * DV + VC0;
    store_rows<WK>(dkb, kv_stride, krow0, p.Sk, dk, p.scale, t4);
    store_rows<WV>(dvb, v_stride, krow0, p.Sk, dv, 1.f, t4);
  } else {   // this share's partial sums, (shares, B, Sk, KV, DK + DV) fp32
    const size_t stride = (size_t)p.KV * (DK + DV);
    float* base = sh.part + (((size_t)share * p.B + b) * p.Sk * p.KV + kvh) * (DK + DV);
    store_rows_f32<WK>(base + KC0, stride, krow0, p.Sk, dk, t4);
    store_rows_f32<WV>(base + DK + VC0, stride, krow0, p.Sk, dv, t4);
  }
}

// units (b, kv head, head share) of a launch ordered in groups of
// ORDER_UNITS, each group's blocks kv tile by kv tile: the blocks that run
// together read the q and dO rows of a few heads, which stay in L2 (MLA:
// 128 kv heads at B 2; kv head by kv head, the 132 blocks of a wave read
// 132 heads' rows, 86 MB), and within a group the heaviest tiles (the
// first, under the causal mask) launch first

// grid (B * KV * shares * kv tiles) in the order above; share s of a
// group of G q heads takes heads [s G / shares, (s + 1) G / shares)
template <int DK, int DV>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_dkdv_bf16_split(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, Params p, Shares sh) {
  using L = SplitSmem<DK, DV>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  SplitTiles t;
  t.k = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  t.v = t.k + L::K_BYTES;
  t.q = t.v + L::V_BYTES;
  t.dout = t.q + STAGES * L::K_BYTES;
  t.pt = t.dout + STAGES * L::V_BYTES;
  t.dst = t.pt + 2 * L::PS_BYTES;
  t.lse2 = reinterpret_cast<float*>(t.dst + 2 * L::PS_BYTES);   // [STAGES][ROWS]
  t.delta = t.lse2 + STAGES * ROWS;                             // [STAGES][ROWS]
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(t.delta + STAGES * ROWS);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int units = p.B * p.KV * sh.n, tiles = (p.Sk + ROWS - 1) / ROWS;
  const int grp = blockIdx.x / (ORDER_UNITS * tiles), in = blockIdx.x % (ORDER_UNITS * tiles);
  const int width = min(ORDER_UNITS, units - grp * ORDER_UNITS);
  const int unit = grp * ORDER_UNITS + in % width;
  const int share = unit % sh.n, bk = unit / sh.n;
  const int b = bk / p.KV, kvh = bk % p.KV;
  const int group = p.H / p.KV;
  const int h0 = kvh * group + share * group / sh.n;
  const int heads = kvh * group + (share + 1) * group / sh.n - h0;
  const int k0 = in / width * ROWS;   // causal: the first kv tiles see the most q tiles
  int lo, hi;
  q_range(p, k0, ROWS, lo, hi);
  const int t_lo = lo / ROWS;
  const int nq = hi > lo ? (hi + ROWS - 1) / ROWS - t_lo : 0;   // q tiles a head
  const int n = heads * nq;                                     // (head, q tile) items

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
    mbar_expect_tx(bar_kv, L::K_BYTES + L::V_BYTES);
#pragma unroll
    for (int c = 0; c < DK / BOX; ++c)
      tma_load(t.k + c * ROWS * ROW, &tm_k, bar_kv, c * BOX, kvh, k0, b);
#pragma unroll
    for (int c = 0; c < DV / BOX; ++c)
      tma_load(t.v + c * ROWS * ROW, &tm_v, bar_kv, c * BOX, kvh, k0, b);
    for (int j = 0; j < STAGES && j < n; ++j)
      split_load_item<DK, DV>(p, &tm_q, &tm_do, t, full, b, h0, t_lo, nq, j);
  }
  if (n > 0) mbar_wait(bar_kv, 0);
  constexpr int K0 = first_cols<DK>(), V0 = first_cols<DV>();
  if (tid < 128)
    dkdv_split_part<DK, DV, 0, K0, 0, V0>(p, &tm_q, &tm_do, t, sh, full, empty, b, kvh, h0,
                                          share, k0, t_lo, nq, n, 0);
  else
    dkdv_split_part<DK, DV, K0, DK - K0, V0, DV - V0>(p, &tm_q, &tm_do, t, sh, full, empty, b,
                                                      kvh, h0, share, k0, t_lo, nq, n, 1);
}

// dK and dV from the head shares' partial sums, (shares, B, Sk, KV, DK +
// DV) fp32: summed in share order, dK scaled, each rounded to bf16 once.
// Four columns a thread (DK and DV are whole 64-column boxes, so four
// never straddle the two).
template <int DK, int DV>
__global__ void __launch_bounds__(256) flash_bwd_sum_shares(Params p, Shares sh) {
  constexpr int W = DK + DV;
  const size_t rows = (size_t)p.B * p.Sk * p.KV;   // (b, kv row, kv head)
  const size_t quads = rows * W / 4, share_stride = rows * W;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < quads;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = 4 * i, r = e / W;
    const int c = static_cast<int>(e % W);
    float4 acc = *reinterpret_cast<const float4*>(sh.part + e);
    for (int j = 1; j < sh.n; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(sh.part + j * share_stride + e);
      acc.x += x.x, acc.y += x.y, acc.z += x.z, acc.w += x.w;
    }
    const float sc = c < DK ? p.scale : 1.f;
    bf16* dst = c < DK ? static_cast<bf16*>(p.dk) + r * DK + c
                       : static_cast<bf16*>(p.dv) + r * DV + (c - DK);
    uint2 out;
    out.x = pack_bf16(acc.x * sc, acc.y * sc);
    out.y = pack_bf16(acc.z * sc, acc.w * sc);
    *reinterpret_cast<uint2*>(dst) = out;
  }
}

// ---------------------------------------------------------------------------
// SIMT, one warp a row, lane l holding columns l, l + 32, ... (those below
// the head dim): fp32 at every head dim, bf16 at the smoke configs' (16,
// 16) and (24, 16).  T is the element type in memory; TN rows of the other
// side are staged in fp32 shared memory where they fit in 48 KB, else TN / 2
// ---------------------------------------------------------------------------
template <int DK, int DV>
__host__ __device__ constexpr int simt_rows() { return (DK + DV) * TN * 4 <= 49152 ? TN : TN / 2; }

// column e of a lane holding E_ columns of a D-column row
template <int D>
__device__ __forceinline__ bool has_col(int lane, int e) {
  return D % 32 == 0 || lane + 32 * e < D;
}

template <int DK, int DV, typename T>
__global__ void __launch_bounds__(WR * 32) flash_bwd_dq_f32(Params p) {
  constexpr int EK = (DK + 31) / 32, EV = (DV + 31) / 32;
  constexpr int TN_ = simt_rows<DK, DV>();
  __shared__ __align__(16) float sK[TN_][DK];
  __shared__ __align__(16) float sV[TN_][DV];

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * WR, row = q0 + warp;
  const size_t q_stride = (size_t)p.H * DK, o_stride = (size_t)p.H * DV;
  const size_t k_stride = (size_t)p.KV * DK, v_stride = (size_t)p.KV * DV;
  const size_t q_off = ((size_t)b * p.S * p.H + h) * DK;
  const size_t o_off = ((size_t)b * p.S * p.H + h) * DV;
  const T* kb = static_cast<const T*>(p.k) + ((size_t)b * p.Sk * p.KV + kvh) * DK;
  const T* vb = static_cast<const T*>(p.v) + ((size_t)b * p.Sk * p.KV + kvh) * DV;
  const size_t row_off = ((size_t)b * p.H + h) * p.S;
  const bool live = row < p.S;

  float q[EK], dq[EK], dout[EV];
  float delta = 0.f;
#pragma unroll
  for (int i = 0; i < EK; ++i) {
    const bool in = live && has_col<DK>(lane, i);
    q[i] = in ? to_f(static_cast<const T*>(p.q)[q_off + (size_t)row * q_stride + lane + 32 * i])
              : 0.f;
    dq[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < EV; ++i) {
    const bool in = live && has_col<DV>(lane, i);
    const size_t at = o_off + (size_t)row * o_stride + lane + 32 * i;
    dout[i] = in ? to_f(static_cast<const T*>(p.dout)[at]) : 0.f;
    delta += in ? to_f(static_cast<const T*>(p.o)[at]) * dout[i] : 0.f;
  }
  delta = warp_sum(delta);
  if (live && lane == 0) p.delta[row_off + row] = delta;
  const float lse2 = live ? p.lse[row_off + row] * LOG2E : 0.f;

  int lo, hi;
  kv_range(p, q0, WR, lo, hi);
  for (int k0 = (lo / TN_) * TN_; k0 < hi; k0 += TN_) {
    __syncthreads();
    for (int c = threadIdx.x; c < TN_ * DK; c += blockDim.x) {
      const int r = c / DK, d = c % DK;
      sK[r][d] = k0 + r < p.Sk ? to_f(kb[(size_t)(k0 + r) * k_stride + d]) : 0.f;
    }
    for (int c = threadIdx.x; c < TN_ * DV; c += blockDim.x) {
      const int r = c / DV, d = c % DV;
      sV[r][d] = k0 + r < p.Sk ? to_f(vb[(size_t)(k0 + r) * v_stride + d]) : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < TN_; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < EK; ++i)
        if (has_col<DK>(lane, i)) s = fmaf(q[i], sK[j][lane + 32 * i], s);
#pragma unroll
      for (int i = 0; i < EV; ++i)
        if (has_col<DV>(lane, i)) dp = fmaf(dout[i], sV[j][lane + 32 * i], dp);
      s = warp_sum(s);
      dp = warp_sum(dp);
      if (visible(p, row, k0 + j)) {   // uniform over the warp
        const float ds = exp2f(fmaf(s, p.scale_log2, -lse2)) * (dp - delta);
#pragma unroll
        for (int i = 0; i < EK; ++i)
          if (has_col<DK>(lane, i)) dq[i] = fmaf(ds, sK[j][lane + 32 * i], dq[i]);
      }
    }
  }
  if (live)
#pragma unroll
    for (int i = 0; i < EK; ++i)
      if (has_col<DK>(lane, i))
        store_f(static_cast<T*>(p.dq) + q_off + (size_t)row * q_stride + lane + 32 * i,
                dq[i] * p.scale);
}

template <int DK, int DV, typename T>
__global__ void __launch_bounds__(WR * 32) flash_bwd_dkdv_f32(Params p) {
  constexpr int EK = (DK + 31) / 32, EV = (DV + 31) / 32;
  constexpr int TN_ = simt_rows<DK, DV>();
  __shared__ __align__(16) float sQ[TN_][DK];
  __shared__ __align__(16) float sdO[TN_][DV];
  __shared__ float sL[TN_], sDl[TN_];

  const int bk = blockIdx.y;
  const int b = bk / p.KV, kvh = bk % p.KV;
  const int group = p.H / p.KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * WR, krow = k0 + warp;
  const size_t q_stride = (size_t)p.H * DK, o_stride = (size_t)p.H * DV;
  const size_t k_stride = (size_t)p.KV * DK, v_stride = (size_t)p.KV * DV;
  const size_t k_off = ((size_t)b * p.Sk * p.KV + kvh) * DK;
  const size_t v_off = ((size_t)b * p.Sk * p.KV + kvh) * DV;
  const bool live = krow < p.Sk;

  float k[EK], dk[EK], v[EV], dv[EV];
#pragma unroll
  for (int i = 0; i < EK; ++i) {
    const bool in = live && has_col<DK>(lane, i);
    k[i] = in ? to_f(static_cast<const T*>(p.k)[k_off + (size_t)krow * k_stride + lane + 32 * i])
              : 0.f;
    dk[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < EV; ++i) {
    const bool in = live && has_col<DV>(lane, i);
    v[i] = in ? to_f(static_cast<const T*>(p.v)[v_off + (size_t)krow * v_stride + lane + 32 * i])
              : 0.f;
    dv[i] = 0.f;
  }

  int lo, hi;
  q_range(p, k0, WR, lo, hi);
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const T* qb = static_cast<const T*>(p.q) + ((size_t)b * p.S * p.H + h) * DK;
    const T* dob = static_cast<const T*>(p.dout) + ((size_t)b * p.S * p.H + h) * DV;
    const size_t row_off = ((size_t)b * p.H + h) * p.S;
    for (int q0 = (lo / TN_) * TN_; q0 < hi; q0 += TN_) {
      __syncthreads();
      for (int c = threadIdx.x; c < TN_ * DK; c += blockDim.x) {
        const int r = c / DK, d = c % DK;
        sQ[r][d] = q0 + r < p.S ? to_f(qb[(size_t)(q0 + r) * q_stride + d]) : 0.f;
      }
      for (int c = threadIdx.x; c < TN_ * DV; c += blockDim.x) {
        const int r = c / DV, d = c % DV;
        sdO[r][d] = q0 + r < p.S ? to_f(dob[(size_t)(q0 + r) * o_stride + d]) : 0.f;
      }
      for (int i = threadIdx.x; i < TN_; i += blockDim.x) {
        const bool in = q0 + i < p.S;
        sL[i] = in ? p.lse[row_off + q0 + i] * LOG2E : 0.f;
        sDl[i] = in ? p.delta[row_off + q0 + i] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < TN_; ++j) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < EK; ++i)
          if (has_col<DK>(lane, i)) s = fmaf(k[i], sQ[j][lane + 32 * i], s);
#pragma unroll
        for (int i = 0; i < EV; ++i)
          if (has_col<DV>(lane, i)) dp = fmaf(v[i], sdO[j][lane + 32 * i], dp);
        s = warp_sum(s);
        dp = warp_sum(dp);
        if (live && visible(p, q0 + j, krow)) {   // uniform over the warp
          const float pj = exp2f(fmaf(s, p.scale_log2, -sL[j]));
          const float ds = pj * (dp - sDl[j]);
#pragma unroll
          for (int i = 0; i < EV; ++i)
            if (has_col<DV>(lane, i)) dv[i] = fmaf(pj, sdO[j][lane + 32 * i], dv[i]);
#pragma unroll
          for (int i = 0; i < EK; ++i)
            if (has_col<DK>(lane, i)) dk[i] = fmaf(ds, sQ[j][lane + 32 * i], dk[i]);
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < EK; ++i)
      if (has_col<DK>(lane, i))
        store_f(static_cast<T*>(p.dk) + k_off + (size_t)krow * k_stride + lane + 32 * i,
                dk[i] * p.scale);
#pragma unroll
    for (int i = 0; i < EV; ++i)
      if (has_col<DV>(lane, i))
        store_f(static_cast<T*>(p.dv) + v_off + (size_t)krow * v_stride + lane + 32 * i, dv[i]);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// the TMA maps of q, dO, k and v: layout holds q's, k's, v's and dO's
template <int DK, int DV>
int encode_maps(const Params& p, const long long* layout, CUtensorMap& tm_q, CUtensorMap& tm_do,
                CUtensorMap& tm_k, CUtensorMap& tm_v) {
  int err = encode(&tm_q, p.q, layout, ROWS);
  if (!err) err = encode(&tm_k, p.k, layout + 11, ROWS);
  if (!err) err = encode(&tm_v, p.v, layout + 22, ROWS);
  if (!err) err = encode(&tm_do, p.dout, layout + 33, ROWS);
  return err;
}

template <int DK, int DV>
int launch_dq_bf16(const Params& p, const CUtensorMap& tm_q, const CUtensorMap& tm_do,
                   const CUtensorMap& tm_k, const CUtensorMap& tm_v, cudaStream_t stream) {
  static uint32_t opted = 0;   // a bit per device
  const int err = opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dq_bf16<DK, DV>),
                              DqSmem<DK, DV>::BYTES, opted);
  if (err) return err;
  flash_bwd_dq_bf16<DK, DV><<<dim3(p.B * p.H, (p.S + ROWS - 1) / ROWS), 128,
                              DqSmem<DK, DV>::BYTES, stream>>>(tm_q, tm_do, tm_k, tm_v, p);
  return (int)cudaGetLastError();
}

// the two-warpgroup dQ kernel; K and V in boxes of its stages' KR rows
// (tm_k, tm_v have boxes of ROWS)
template <int DK, int DV>
int launch_dq_pair(const Params& p, const long long* layout, const CUtensorMap& tm_q,
                   const CUtensorMap& tm_do, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                   cudaStream_t stream) {
  using L = PairSmem<DK, DV>;
  CUtensorMap tm_kr = tm_k, tm_vr = tm_v;
  if constexpr (L::KR != ROWS) {
    long long kl[11], vl[11];
    for (int i = 0; i < 11; ++i) kl[i] = layout[11 + i], vl[i] = layout[22 + i];
    kl[9] = vl[9] = L::KR;
    int err = encode(&tm_kr, p.k, kl, L::KR);
    if (!err) err = encode(&tm_vr, p.v, vl, L::KR);
    if (err) return err;
  }
  static uint32_t opted = 0;   // a bit per device
  const int err = opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dq_bf16_pair<DK, DV>),
                              L::BYTES, opted);
  if (err) return err;
  const int blocks = p.B * p.H * ((p.S + L::Q_ROWS - 1) / L::Q_ROWS);
  flash_bwd_dq_bf16_pair<DK, DV><<<blocks, 256, L::BYTES, stream>>>(tm_q, tm_do, tm_kr, tm_vr, p);
  return (int)cudaGetLastError();
}

// D 64 and 128: the dQ kernel, then the one-warpgroup dK/dV kernel
template <int D>
int launch_bf16(const Params& p, const long long* layout, cudaStream_t stream) {
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  int err = encode_maps<D, D>(p, layout, tm_q, tm_do, tm_k, tm_v);
  if (!err) err = launch_dq_bf16<D, D>(p, tm_q, tm_do, tm_k, tm_v, stream);
  if (err) return err;
  static uint32_t opted = 0;   // a bit per device
  err = opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dkdv_bf16<D>), DkdvSmem<D>::BYTES,
                    opted);
  if (err) return err;
  flash_bwd_dkdv_bf16<D><<<dim3(p.B * p.KV, (p.Sk + ROWS - 1) / ROWS), 128, DkdvSmem<D>::BYTES,
                           stream>>>(tm_q, tm_do, tm_k, tm_v, p);
  return (int)cudaGetLastError();
}

// (256, 256) and (192, 128): the two-warpgroup dQ kernel, then the
// two-warpgroup dK/dV kernel over sh.n head shares and, for more than one,
// the pass that sums them
template <int DK, int DV>
int launch_bf16_split(const Params& p, const Shares& sh, const long long* layout,
                      cudaStream_t stream) {
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  int err = encode_maps<DK, DV>(p, layout, tm_q, tm_do, tm_k, tm_v);
  if (!err) err = launch_dq_pair<DK, DV>(p, layout, tm_q, tm_do, tm_k, tm_v, stream);
  if (err) return err;
  static uint32_t opted = 0;   // a bit per device
  err = opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dkdv_bf16_split<DK, DV>),
                    SplitSmem<DK, DV>::BYTES, opted);
  if (err) return err;
  const int blocks = p.B * p.KV * sh.n * ((p.Sk + ROWS - 1) / ROWS);
  flash_bwd_dkdv_bf16_split<DK, DV><<<blocks, 256, SplitSmem<DK, DV>::BYTES, stream>>>(
      tm_q, tm_do, tm_k, tm_v, p, sh);
  err = (int)cudaGetLastError();
  if (err || sh.n == 1) return err;
  const size_t quads = (size_t)p.B * p.Sk * p.KV * (DK + DV) / 4;
  const int sum_blocks = (int)((quads + 255) / 256 < 8192 ? (quads + 255) / 256 : 8192);
  flash_bwd_sum_shares<DK, DV><<<sum_blocks, 256, 0, stream>>>(p, sh);
  return (int)cudaGetLastError();
}

template <int DK, int DV, typename T>
int launch_simt(const Params& p, cudaStream_t stream) {
  flash_bwd_dq_f32<DK, DV, T><<<dim3((p.S + WR - 1) / WR, p.B * p.H), WR * 32, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_f32<DK, DV, T><<<dim3((p.Sk + WR - 1) / WR, p.B * p.KV), WR * 32, 0, stream>>>(
      p);
  return (int)cudaGetLastError();
}

template <int DK, int DV>
int launch_simt_either(const Params& p, cudaStream_t stream, int is_bf16) {
  return is_bf16 ? launch_simt<DK, DV, __nv_bfloat16>(p, stream)
                 : launch_simt<DK, DV, float>(p, stream);
}

}  // namespace

// q, dq: (B, S, H, DK); o, dout: (B, S, H, DV); k, dk: (B, Sk, KV, DK);
// v, dv: (B, Sk, KV, DV); all contiguous, one dtype (bf16 if is_bf16 else
// fp32).  lse: (B, H, S) fp32 from the forward.  scratch: 2 * B * H * s_pad
// fp32, where s_pad is S rounded up to the dQ block's rows (128 where the
// bf16 dQ kernel is two warpgroups, else 64), as
// kernels/flash_attention.py:bwd_scratch_rows computes it; another s_pad
// is refused.  layout: for bf16 at the wgmma head dims ((64, 64), (128,
// 128), (256, 256), (192, 128)), the TMA layouts of
// q, k, v and dout with boxes of 64 rows, 11 values each, as
// kernels/flash_attention.py:tma_layout computes them; unused otherwise.
// shares: the head shares of the two-warpgroup dK/dV kernel (bf16 at
// (256, 256) and (192, 128)), 1 on every other route; above 1, part holds
// shares * B * Sk * KV * (DK + DV) fp32, as
// kernels/flash_attention.py:bwd_head_shares chooses it.  The kernels run
// in order on `stream`.  Returns cudaGetLastError() after the launches, or
// a negative code from encode().
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, void* dq, void* dk,
                                   void* dv, float* scratch, int B, int S, int Sk, int H, int KV,
                                   int DK, int DV, int causal, int window, int is_bf16,
                                   void* stream, const long long* layout, float* part,
                                   int shares, int s_pad) {
  const float scale = 1.f / sqrtf((float)DK);
  const bool split = is_bf16 && ((DK == 256 && DV == 256) || (DK == 192 && DV == 128));
  const int pad_rows = split ? 2 * ROWS : ROWS;   // the dQ kernel's block
  if (s_pad < S || s_pad % pad_rows) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, dout, lse, dq, dk, dv, scratch, scratch + (size_t)B * H * s_pad,
           B, S, Sk, H, KV, causal, window, scale, LOG2E * scale, s_pad};
  const Shares sh{part, shares};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shares < 1 || shares > H / KV || (shares > 1 && (!split || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (DK == 16 && DV == 16) return launch_simt_either<16, 16>(p, st, is_bf16);
  if (DK == 24 && DV == 16) return launch_simt_either<24, 16>(p, st, is_bf16);
  if (!is_bf16) {
    if (DK == 64 && DV == 64) return launch_simt<64, 64, float>(p, st);
    if (DK == 128 && DV == 128) return launch_simt<128, 128, float>(p, st);
    if (DK == 256 && DV == 256) return launch_simt<256, 256, float>(p, st);
    if (DK == 192 && DV == 128) return launch_simt<192, 128, float>(p, st);
    return (int)cudaErrorInvalidValue;
  }
  if (layout == nullptr) return (int)cudaErrorInvalidValue;
  if (DK == 64 && DV == 64) return launch_bf16<64>(p, layout, st);
  if (DK == 128 && DV == 128) return launch_bf16<128>(p, layout, st);
  if (DK == 256 && DV == 256) return launch_bf16_split<256, 256>(p, sh, layout, st);
  if (DK == 192 && DV == 128) return launch_bf16_split<192, 128>(p, sh, layout, st);
  return (int)cudaErrorInvalidValue;
}
