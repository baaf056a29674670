// The bf16 flash-attention backward kernels (wgmma + TMA), shared by
// csrc/flash_attention_bwd.cu (the models' head dims),
// csrc/flash_attention_bwd_pad.cu (the padded route: head dims that are
// multiples of 8 inside a built pair, the Widths instantiations) and
// csrc/flash_attention_bwd_f16.cu (fp16 at the built pairs and at such
// dims, the HalfWidths instantiations: the same kernels in f16 wgmma and
// f16 tensor maps).  Every kernel's element type T is its W::Elem.  The
// design notes are in csrc/flash_attention_bwd.cu's header.
#pragma once

#include <math.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int ROWS = 64;   // wgmma: rows of a warpgroup's tile, of a stage and of a TMA box
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
// 8-column block) into a (B, L, heads, D) tensor of T, times `scale`; with
// PAD, only its first `cols` columns (a multiple of 8 on the padded route)
template <int D, bool PAD = false, typename T>
__device__ __forceinline__ void store_rows(T* base, size_t stride, int row0, int L,
                                           const float (&acc)[D / 2], float scale, int t4,
                                           int cols = D) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if (PAD && col >= cols) continue;
    if (row0 < L)
      store2(base + (size_t)row0 * stride + col, acc[4 * dt] * scale, acc[4 * dt + 1] * scale);
    if (row0 + 8 < L)
      store2(base + (size_t)(row0 + 8) * stride + col, acc[4 * dt + 2] * scale,
             acc[4 * dt + 3] * scale);
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

// At the instantiation's head dims; wd: the real ones (hopper.cuh:
// FixedWidths, not read, on the built pairs; Widths on the padded route,
// where Delta reads O and dO at the real v dim and dQ's stores stop at the
// real q/k dim).  Every kernel of this file takes them alike
template <int DK, int DV, class W>
__global__ void __launch_bounds__(128, DqSmem<DK, DV>::BLOCKS_PER_SM)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, Params p, W wd) {
  using L = DqSmem<DK, DV>;
  using T = typename W::Elem;
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
  const int dk = wd.w0(), dv = wd.w1();
  const size_t q_stride = (size_t)p.H * dk, o_stride = (size_t)p.H * dv;
  const size_t q_off = ((size_t)b * p.S * p.H + h) * dk;
  const size_t o_off = ((size_t)b * p.S * p.H + h) * dv;
  const T* ob = static_cast<const T*>(p.o) + o_off;
  const T* dob = static_cast<const T*>(p.dout) + o_off;
  const size_t pad_off = ((size_t)b * p.H + h) * p.s_pad;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  float d0 = 0.f, d1 = 0.f, l0 = 0.f, l1 = 0.f;
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    float acc = 0.f, l2 = 0.f;
    if (row < p.S) {
#pragma unroll
      for (int c = 2 * lane; c < dv; c += 64) {
        const float2 x =
            to_f2(*reinterpret_cast<const pair_t<T>*>(ob + (size_t)row * o_stride + c));
        const float2 y =
            to_f2(*reinterpret_cast<const pair_t<T>*>(dob + (size_t)row * o_stride + c));
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
    qk_product<DK, ROWS, ROWS, 32, false, T>(sc, q_smem, k_s);
    qk_product<DV, ROWS, ROWS, 32, false, T>(dp, do_smem, v_s);
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
      dsf[nb / 2][(nb % 2) * 2 + 0] = pack2<T>(ds[0], ds[1]);
      dsf[nb / 2][(nb % 2) * 2 + 1] = pack2<T>(ds[2], ds[3]);
    }
    pv_product<DK, ROWS, true, T>(dq, dsf, k_s);   // dQ += dS K, K read MN-major
    mbar_arrive(&empty[s]);
  }
  store_rows<DK, W::PADDED>(static_cast<T*>(p.dq) + q_off, q_stride, row0, p.S, dq, p.scale,
                            t4, dk);
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
template <int DK, int DV, class W>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_dq_bf16_pair(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, Params p, W wd) {
  using L = PairSmem<DK, DV>;
  using T = typename W::Elem;
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
  const int dk = wd.w0(), dv = wd.w1();
  const size_t q_stride = (size_t)p.H * dk, o_stride = (size_t)p.H * dv;
  const size_t q_off = ((size_t)b * p.S * p.H + h) * dk;
  const size_t o_off = ((size_t)b * p.S * p.H + h) * dv;
  const T* ob = static_cast<const T*>(p.o) + o_off;
  const T* dob = static_cast<const T*>(p.dout) + o_off;
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
    // the padded route: a lane's PER columns are all below dv (a multiple
    // of 8) or all past it
    const bool in = !W::PADDED || PER * lane < dv;
    const Vec x = in ? *reinterpret_cast<const Vec*>(ob + (size_t)row * o_stride + PER * lane)
                     : Vec{};
    const Vec y = in ? *reinterpret_cast<const Vec*>(dob + (size_t)row * o_stride + PER * lane)
                     : Vec{};
    const pair_t<T>* xp = reinterpret_cast<const pair_t<T>*>(&x);
    const pair_t<T>* yp = reinterpret_cast<const pair_t<T>*>(&y);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < PER / 2; ++c) {
      const float2 xf = to_f2(xp[c]), yf = to_f2(yp[c]);
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
      qk_product<DK, ROWS, KR, KR / 2, false, T>(sc, q_smem, k_s);
      qk_product<DV, ROWS, KR, KR / 2, false, T>(dp, do_smem, v_s);
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
        dsf[nb / 2][(nb % 2) * 2 + 0] = pack2<T>(ds[0], ds[1]);
        dsf[nb / 2][(nb % 2) * 2 + 1] = pack2<T>(ds[2], ds[3]);
      }
      pv_product<DK, KR, false, T>(dq, dsf, k_s);   // dQ += dS K, K read MN-major, in flight
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
  store_rows<DK, W::PADDED>(static_cast<T*>(p.dq) + q_off, q_stride, row0, p.S, dq, p.scale,
                            t4, dk);
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

template <int D, class W>
__global__ void __launch_bounds__(128, 2)
    flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, Params p, W wd) {
  using L = DkdvSmem<D>;
  using T = typename W::Elem;
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
    qk_product<D, ROWS, ROWS, 32, false, T>(st, k_smem, q_s);
    qk_product<D, ROWS, ROWS, 32, false, T>(dpt, v_smem, do_s);
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
      pf[nb / 2][(nb % 2) * 2 + 0] = pack2<T>(st[4 * nb], st[4 * nb + 1]);
      pf[nb / 2][(nb % 2) * 2 + 1] = pack2<T>(st[4 * nb + 2], st[4 * nb + 3]);
    }
    pv_product<D, ROWS, false, T>(dv, pf, do_s);    // dV += P^T dO, in flight
    wgmma_wait_all_but_one();   // dP^T is done
    pin(dpt);
#pragma unroll
    for (int nb = 0; nb < ROWS / 8; ++nb) {
      const float2 d2 = *reinterpret_cast<const float2*>(delta + nb * 8 + 2 * t4);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[e] = st[4 * nb + e] * (dpt[4 * nb + e] - ((e & 1) ? d2.y : d2.x));
      dsf[nb / 2][(nb % 2) * 2 + 0] = pack2<T>(ds[0], ds[1]);
      dsf[nb / 2][(nb % 2) * 2 + 1] = pack2<T>(ds[2], ds[3]);
    }
    pv_product<D, ROWS, false, T>(dk, dsf, q_s);    // dK += dS^T Q, in flight
  }
  wgmma_wait_all();
  pin(dv);
  pin(dk);
  const int dkw = wd.w0(), dvw = wd.w1();   // the real widths of dK and dV
  const size_t k_stride = (size_t)p.KV * dkw, v_stride = (size_t)p.KV * dvw;
  const size_t k_off = ((size_t)b * p.Sk * p.KV + kvh) * dkw;
  const size_t v_off = ((size_t)b * p.Sk * p.KV + kvh) * dvw;
  store_rows<D, W::PADDED>(static_cast<T*>(p.dk) + k_off, k_stride, krow0, p.Sk, dk, p.scale,
                           t4, dkw);
  store_rows<D, W::PADDED>(static_cast<T*>(p.dv) + v_off, v_stride, krow0, p.Sk, dv, 1.f, t4,
                           dvw);
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
// warpgroup's q columns c0 .. c0 + 31) as T into a 64 x 64 tile laid
// out as TMA writes a box with the 128-byte swizzle (16-byte chunk c of
// row r at chunk c ^ (r % 8)), which a K-major wgmma A descriptor reads
template <typename T>
__device__ __forceinline__ void store_swizzled(unsigned char* tile, const float (&x)[16], int c0,
                                               int r0, int t4) {
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const int chunk = c0 / 8 + nb;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      *reinterpret_cast<uint32_t*>(tile + r * ROW + ((chunk ^ (r & 7)) << 4) + 4 * t4) =
          pack2<T>(x[4 * nb + 2 * half], x[4 * nb + 2 * half + 1]);
    }
  }
}

// G (64 x N, fp32) += A (64 x 64 at shared address a, T, K-major, one
// box) B (64 x N at shared address b, MN-major, N / 64 boxes), left in
// flight
template <int N, typename T>
__device__ __forceinline__ void ss_product(float (&acc)[N / 2], uint32_t a, uint32_t b) {
  static_assert(N == 64 || N == 128, "64 or 128 columns");
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < ROWS / 16; ++j) {   // 16 k rows a step
    const uint64_t da = smem_desc(a + j * 32, 1, 64);
    const uint64_t db = smem_desc(b + j * 16 * ROW, ROWS * ROW / 16, 64);
    if constexpr (N == 64) wgmma_ss_n64<0, 1, T>(acc, da, db, 1);
    else wgmma_ss_n128<0, 1, T>(acc, da, db, 1);
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
template <int DK, int DV, int KC0, int WK, int VC0, int WV, class W>
__device__ __forceinline__ void dkdv_split_part(const Params& p, const CUtensorMap* tm_q,
                                                const CUtensorMap* tm_do, const SplitTiles& t,
                                                const Shares& sh, uint64_t* full, uint64_t* empty,
                                                int b, int kvh, int h0, int share, int k0,
                                                int t_lo, int nq, int n, int wg, const W& wd) {
  using L = SplitSmem<DK, DV>;
  using T = typename W::Elem;
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
    qk_product<DK, ROWS, ROWS, 16, false, T>(st, k_smem, q_s + c0 * ROW);
    qk_product<DV, ROWS, ROWS, 16, false, T>(dpt, v_smem, do_s + c0 * ROW);
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
    store_swizzled<T>(pt, st, c0, r0, t4);
    fence_proxy_async();
    named_sync(1, 256);   // both halves of P^T are written
    // dV[:, VC0:VC0+WV] += P^T dO[:, VC0:VC0+WV], in flight while dS^T is formed
    ss_product<WV, T>(dv, smem_u32(pt), do_s + (VC0 / BOX) * ROWS * ROW);
    wgmma_wait_all_but_one();   // dP^T is done
    pin(dpt);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const float2 d2 = *reinterpret_cast<const float2*>(delta + c0 + nb * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e)   // dS^T in place of dP^T
        dpt[4 * nb + e] = st[4 * nb + e] * (dpt[4 * nb + e] - ((e & 1) ? d2.y : d2.x));
    }
    store_swizzled<T>(dst, dpt, c0, r0, t4);
    fence_proxy_async();
    named_sync(2, 256);   // both halves of dS^T are written
    // dK[:, KC0:KC0+WK] += dS^T Q[:, KC0:KC0+WK]
    ss_product<WK, T>(dk, smem_u32(dst), q_s + (KC0 / BOX) * ROWS * ROW);
  }
  wgmma_wait_all();
  pin(dv);
  pin(dk);
  if (sh.n == 1) {
    const int dkw = wd.w0(), dvw = wd.w1();   // the real widths of dK and dV
    const size_t kv_stride = (size_t)p.KV * dkw, v_stride = (size_t)p.KV * dvw;
    T* dkb = static_cast<T*>(p.dk) + ((size_t)b * p.Sk * p.KV + kvh) * dkw + KC0;
    T* dvb = static_cast<T*>(p.dv) + ((size_t)b * p.Sk * p.KV + kvh) * dvw + VC0;
    store_rows<WK, W::PADDED>(dkb, kv_stride, krow0, p.Sk, dk, p.scale, t4, dkw - KC0);
    store_rows<WV, W::PADDED>(dvb, v_stride, krow0, p.Sk, dv, 1.f, t4, dvw - VC0);
  } else {   // this share's partial sums, (shares, B, Sk, KV, DK + DV) fp32, at the
             // instantiation's widths (flash_bwd_sum_shares stores the real ones)
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
template <int DK, int DV, class W>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_dkdv_bf16_split(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, Params p, Shares sh,
                              W wd) {
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
                                          share, k0, t_lo, nq, n, 0, wd);
  else
    dkdv_split_part<DK, DV, K0, DK - K0, V0, DV - V0>(p, &tm_q, &tm_do, t, sh, full, empty, b,
                                                      kvh, h0, share, k0, t_lo, nq, n, 1, wd);
}

// dK and dV from the head shares' partial sums, (shares, B, Sk, KV, DK +
// DV) fp32: summed in share order, dK scaled, each rounded to WD::Elem once.
// Four columns a thread (DK and DV are whole 64-column boxes, so four
// never straddle the two).
template <int DK, int DV, class WD>
__global__ void __launch_bounds__(256) flash_bwd_sum_shares(Params p, Shares sh, WD wd) {
  constexpr int W = DK + DV;
  using T = typename WD::Elem;
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
    const int dkw = wd.w0(), dvw = wd.w1();   // the real widths: whole quads past them skip
    if constexpr (WD::PADDED) {
      if (c < DK ? c >= dkw : c - DK >= dvw) continue;
    }
    T* dst = c < DK ? static_cast<T*>(p.dk) + r * dkw + c
                    : static_cast<T*>(p.dv) + r * dvw + (c - DK);
    uint2 out;
    out.x = pack2<T>(acc.x * sc, acc.y * sc);
    out.y = pack2<T>(acc.z * sc, acc.w * sc);
    *reinterpret_cast<uint2*>(dst) = out;
  }
}

// ---------------------------------------------------------------------------
// host side: the padded route's launches (Widths in bf16, HalfWidths in
// fp16), every kernel at the bucket's widths with the real ones in `wd`
// ---------------------------------------------------------------------------
// the TMA maps of q, dO, k and v in T: layout holds q's, k's, v's and dO's
template <typename T>
int encode_bwd_maps(const Params& p, const long long* layout, CUtensorMap& tm_q,
                    CUtensorMap& tm_do, CUtensorMap& tm_k, CUtensorMap& tm_v) {
  constexpr CUtensorMapDataType type = tma_type<T>();
  int err = encode(&tm_q, p.q, layout, ROWS, type);
  if (!err) err = encode(&tm_k, p.k, layout + 11, ROWS, type);
  if (!err) err = encode(&tm_v, p.v, layout + 22, ROWS, type);
  if (!err) err = encode(&tm_do, p.dout, layout + 33, ROWS, type);
  return err;
}

// buckets (64, 64) and (128, 128): the dQ kernel, then the one-warpgroup dK/dV kernel
template <int D, class W>
int launch_one(const Params& p, const W& wd, const long long* layout, cudaStream_t stream) {
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  int err = encode_bwd_maps<typename W::Elem>(p, layout, tm_q, tm_do, tm_k, tm_v);
  if (err) return err;
  static uint32_t opted_dq = 0, opted_kv = 0;   // a bit per device
  err = opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dq_bf16<D, D, W>),
                    DqSmem<D, D>::BYTES, opted_dq);
  if (err) return err;
  flash_bwd_dq_bf16<D, D, W><<<dim3(p.B * p.H, (p.S + ROWS - 1) / ROWS), 128,
                               DqSmem<D, D>::BYTES, stream>>>(tm_q, tm_do, tm_k, tm_v, p, wd);
  if ((err = (int)cudaGetLastError())) return err;
  err = opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dkdv_bf16<D, W>),
                    DkdvSmem<D>::BYTES, opted_kv);
  if (err) return err;
  flash_bwd_dkdv_bf16<D, W><<<dim3(p.B * p.KV, (p.Sk + ROWS - 1) / ROWS), 128,
                              DkdvSmem<D>::BYTES, stream>>>(tm_q, tm_do, tm_k, tm_v, p, wd);
  return (int)cudaGetLastError();
}

// buckets (192, 128) and (256, 256): the two-warpgroup dQ kernel (K and V
// in boxes of its stages' KR rows), the two-warpgroup dK/dV kernel over
// sh.n head shares and, for more than one, the pass that sums them
template <int DK, int DV, class W>
int launch_split(const Params& p, const Shares& sh, const W& wd, const long long* layout,
                 cudaStream_t stream) {
  using L = PairSmem<DK, DV>;
  using T = typename W::Elem;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  int err = encode_bwd_maps<T>(p, layout, tm_q, tm_do, tm_k, tm_v);
  if (err) return err;
  CUtensorMap tm_kr = tm_k, tm_vr = tm_v;
  if constexpr (L::KR != ROWS) {
    long long kl[11], vl[11];
    for (int i = 0; i < 11; ++i) kl[i] = layout[11 + i], vl[i] = layout[22 + i];
    kl[9] = vl[9] = L::KR;
    err = encode(&tm_kr, p.k, kl, L::KR, tma_type<T>());
    if (!err) err = encode(&tm_vr, p.v, vl, L::KR, tma_type<T>());
    if (err) return err;
  }
  static uint32_t opted_dq = 0, opted_kv = 0;   // a bit per device
  err = opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dq_bf16_pair<DK, DV, W>), L::BYTES,
                    opted_dq);
  if (err) return err;
  const int blocks = p.B * p.H * ((p.S + L::Q_ROWS - 1) / L::Q_ROWS);
  flash_bwd_dq_bf16_pair<DK, DV, W><<<blocks, 256, L::BYTES, stream>>>(tm_q, tm_do, tm_kr, tm_vr,
                                                                       p, wd);
  if ((err = (int)cudaGetLastError())) return err;
  err = opt_in_smem(reinterpret_cast<const void*>(flash_bwd_dkdv_bf16_split<DK, DV, W>),
                    SplitSmem<DK, DV>::BYTES, opted_kv);
  if (err) return err;
  const int kv_blocks = p.B * p.KV * sh.n * ((p.Sk + ROWS - 1) / ROWS);
  flash_bwd_dkdv_bf16_split<DK, DV, W><<<kv_blocks, 256, SplitSmem<DK, DV>::BYTES, stream>>>(
      tm_q, tm_do, tm_k, tm_v, p, sh, wd);
  err = (int)cudaGetLastError();
  if (err || sh.n == 1) return err;
  const size_t quads = (size_t)p.B * p.Sk * p.KV * (DK + DV) / 4;
  const int sum_blocks = (int)((quads + 255) / 256 < 8192 ? (quads + 255) / 256 : 8192);
  flash_bwd_sum_shares<DK, DV, W><<<sum_blocks, 256, 0, stream>>>(p, sh, wd);
  return (int)cudaGetLastError();
}

// the padded entries' arguments: real head dims DK, DV (multiples of 8)
// inside the bucket (bk, bv), the scratch's rows and the head shares;
// 0, or cudaErrorInvalidValue
inline int padded_args(int S, int H, int KV, int DK, int DV, int bk, int bv,
                       const long long* layout, const float* part, int shares, int s_pad) {
  if (DK <= 0 || DV <= 0 || DK > bk || DV > bv || DK % 8 || DV % 8 || layout == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool split = (bk == 256 && bv == 256) || (bk == 192 && bv == 128);
  const int pad_rows = split ? 2 * ROWS : ROWS;   // the dQ kernel's block
  if (s_pad < S || s_pad % pad_rows) return (int)cudaErrorInvalidValue;
  if (shares < 1 || shares > H / KV || (shares > 1 && (!split || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// the bucket (bk, bv)'s kernels at the widths wd (Widths or HalfWidths)
template <class W>
int launch_bucket(const Params& p, const Shares& sh, const W& wd, int bk, int bv,
                  const long long* layout, cudaStream_t stream) {
  if (bk == 64 && bv == 64) return launch_one<64>(p, wd, layout, stream);
  if (bk == 128 && bv == 128) return launch_one<128>(p, wd, layout, stream);
  if (bk == 256 && bv == 256) return launch_split<256, 256>(p, sh, wd, layout, stream);
  if (bk == 192 && bv == 128) return launch_split<192, 128>(p, sh, wd, layout, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
