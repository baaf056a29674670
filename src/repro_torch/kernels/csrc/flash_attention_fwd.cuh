// The bf16 flash-attention forward kernel (wgmma + TMA), shared by
// csrc/flash_attention.cu (the models' head dims),
// csrc/flash_attention_pad.cu (the padded route: any head dims that are
// multiples of 8 inside a built pair, the Widths instantiations) and
// csrc/flash_attention_f16.cu (fp16 at any such head dims and at the built
// pairs, the HalfWidths instantiations: the same kernel in f16 wgmma and
// f16 tensor maps).  The design notes are in csrc/flash_attention.cu's
// header.
#pragma once

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BM = 64;        // q rows per block, SIMT kernel
constexpr int TN = 32;        // kv rows per tile, SIMT kernel
constexpr int WM = 128;       // q rows per block, bf16 kernel (two warpgroups of 64)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, Sk, H, KV;
  int causal, window;
  float scale_log2;           // log2(e) / sqrt(DK): scores in base 2
  float* lse;                 // (B, H, S) fp32 row logsumexp, or null
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

// Shared memory of the bf16 kernel: Q, then STAGES K tiles (each DK / 64
// boxes of WN rows x 128 bytes), STAGES V tiles (DV / 64 boxes each), then
// the mbarriers.  The kv tile WN is a template parameter (the autotuner
// picks among the instantiations, kernels/flash_attention.py:KV_TILES);
// the stages and the blocks an SM follow from the shared-memory budget:
// two blocks an SM where two stages fit twice in the SM's 228 KB, else one
// block with as many stages as fit in 227 KB, at most three.  So D 64 with
// 128-key tiles keeps 80 KB and two blocks (a third stage, two blocks
// still fitting, gained nothing); D 128 with 128-key tiles 224 KB, three
// stages at one block; D 256 (64-key tiles only: 128 would not fit beside
// Q) two stages at one block.  A 64-key tile halves a stage: D 64 48 KB
// and D 128 96 KB at two blocks an SM.
constexpr size_t SM_SMEM = 233472;      // 228 KB of shared memory an SM
constexpr size_t BLOCK_SMEM = 232448;   // 227 KB a block may take
constexpr size_t BLOCK_RESERVED = 1024; // the system's share of each resident block

// bytes of a block with `stages` K/V stages (1024: alignment)
constexpr size_t smem_bytes(int dk, int dv, int wn, int stages) {
  return 1024 + (size_t)WM * dk * 2 + (size_t)stages * ((size_t)wn * dk * 2 + (size_t)wn * dv * 2) +
         8 * (1 + 3 * stages);
}

template <int DK, int DV, int WN_>
struct Smem {
  static constexpr int WN = WN_;                      // kv rows per tile
  static_assert(WN == 64 || WN == 128, "kv tiles of 64 or 128 rows");
  static constexpr uint32_t Q_BYTES = WM * DK * 2;
  static constexpr uint32_t K_BYTES = WN * DK * 2;
  static constexpr uint32_t V_BYTES = WN * DV * 2;
  static constexpr int BLOCKS_PER_SM =
      2 * (smem_bytes(DK, DV, WN, 2) + BLOCK_RESERVED) <= SM_SMEM ? 2 : 1;
  static constexpr int STAGES =
      BLOCKS_PER_SM == 2 ? 2 : (smem_bytes(DK, DV, WN, 3) <= BLOCK_SMEM ? 3 : 2);
  static constexpr size_t BYTES = smem_bytes(DK, DV, WN, STAGES);
  static_assert(BYTES <= BLOCK_SMEM, "over the shared memory of an SM");
};

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA, two consumer warpgroups of 64 q rows
// ---------------------------------------------------------------------------
// At the instantiation's head dims (DK, DV); `wd` gives the real ones
// (hopper.cuh): FixedWidths, the same, for the built pairs, whose code does
// not read the argument; Widths on the padded route (any dims that are
// multiples of 8 inside the pair), where the tensor maps carry the real
// dims, so TMA zero-fills q, k and v past them and the scores and O are
// those of the real dims (the launcher's scale is 1 / sqrt(real DK)), and
// O's stores stop at the real v dim.  W::Elem is the element type: bf16,
// or fp16 in the HalfWidths instantiations
template <int DK, int DV, int WN_, class W>
__global__ void __launch_bounds__(256, Smem<DK, DV, WN_>::BLOCKS_PER_SM)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, Params p, W wd) {
  using L = Smem<DK, DV, WN_>;
  using T = typename W::Elem;
  constexpr int STAGES = L::STAGES;
  constexpr int WN = L::WN;
  constexpr int K_BOXES = DK / BOX, V_BOXES = DV / BOX;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* sQ = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sK = sQ + L::Q_BYTES;
  unsigned char* sV = sK + STAGES * L::K_BYTES;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + STAGES * L::V_BYTES);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // accumulator row group / column pair
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  // causal: the first blocks take the last q tiles, which have the most kv tiles
  const int qt = p.causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y) : blockIdx.y;
  const int q0 = qt * WM;
  int hi = p.Sk;
  if (p.causal) hi = min(hi, q0 + WM);              // keys k <= q
  const int lo = p.window ? max(0, q0 - p.window + 1) : 0;   // keys k > q - window
  const int t_lo = lo / WN;
  const int n = (hi + WN - 1) / WN - t_lo;           // kv tiles with a visible key

  auto load_kv = [&](int j) {   // kv tile t_lo + j into stage j % STAGES
    const int s = j % STAGES, k0 = (t_lo + j) * WN;
    mbar_expect_tx(&full_k[s], L::K_BYTES);
#pragma unroll
    for (int c = 0; c < K_BOXES; ++c)
      tma_load(sK + s * L::K_BYTES + c * WN * ROW, &tm_k, &full_k[s], c * BOX, kvh, k0, b);
    mbar_expect_tx(&full_v[s], L::V_BYTES);
#pragma unroll
    for (int c = 0; c < V_BOXES; ++c)
      tma_load(sV + s * L::V_BYTES + c * WN * ROW, &tm_v, &full_v[s], c * BOX, kvh, k0, b);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], blockDim.x);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n > 0) {
    mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
    for (int c = 0; c < K_BOXES; ++c) tma_load(sQ + c * WM * ROW, &tm_q, bar_q, c * BOX, h, q0, b);
    for (int j = 0; j < min(STAGES, n); ++j) load_kv(j);
  }

  float o[DV / 2];   // the m64nDV accumulator: 4 values per 8-column block
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;   // running max of rows row0, row1 (raw scores)
  float l0 = 0.f, l1 = 0.f;           // this thread's share of the normaliser
  const int wq0 = q0 + wg * 64;       // the warpgroup's first q row
  const int row0 = wq0 + warp * 16 + g, row1 = row0 + 8;
  const uint32_t q_smem = smem_u32(sQ) + wg * 64 * ROW;
  if (n > 0) mbar_wait(bar_q, 0);

  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    const uint32_t phase = (i / STAGES) & 1;
    if (tid == 0 && i > 0 && i + STAGES - 1 < n) {
      // the next tile goes where tile i - 1 was: wait until every thread is done with it
      const int j = i + STAGES - 1;
      mbar_wait(&empty[j % STAGES], ((j / STAGES) & 1) ^ 1);
      load_kv(j);
    }
    __syncwarp();
    const int k0 = (t_lo + i) * WN;

    float sc[WN / 2];
    mbar_wait(&full_k[s], phase);
    qk_product<DK, WM, WN, WN / 2, true, T>(sc, q_smem, smem_u32(sK + s * L::K_BYTES));

    // mask only where this warpgroup's rows meet a masked pair
    const bool edge = k0 + WN > p.Sk || (p.causal && k0 + WN - 1 > wq0) ||
                      (p.window && k0 <= wq0 + 63 - p.window);
    if (edge) {
      // key k0 + c is visible to a row iff lo <= c <= hi; c - 2 t4 is a
      // constant of the element, so each element costs two compares
      int lo[2] = {-(1 << 30), -(1 << 30)}, hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? row1 : row0;
        hi[r] = p.Sk - 1 - k0;                               // k < Sk
        if (p.causal) hi[r] = min(hi[r], row - k0);          // k <= q
        if (p.window) lo[r] = row - p.window + 1 - k0;       // k > q - window
        lo[r] -= 2 * t4;
        hi[r] -= 2 * t4;
      }
#pragma unroll
      for (int e = 0; e < WN / 2; ++e) {
        const int c = (e / 4) * 8 + (e & 1), r = (e >> 1) & 1;
        if (c < lo[r] || c > hi[r]) sc[e] = NEG_INF;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nb = 0; nb < WN / 8; ++nb) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * nb], sc[4 * nb + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * nb + 2], sc[4 * nb + 3]));
    }
    // the four lanes of a quad share rows row0 and row1
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float sl = p.scale_log2;
    const float a0 = ex2((m0 - mx0) * sl), a1 = ex2((m1 - mx1) * sl);
    m0 = mx0;
    m1 = mx1;
    // a row with no visible key yet keeps p = 0 (an fma against a max of
    // NEG_INF could leave a residue of ~1e22 in the exponent)
    const float ms0 = mx0 == NEG_INF ? 0.f : mx0 * sl;
    const float ms1 = mx1 == NEG_INF ? 0.f : mx1 * sl;

    // P as the A operand of P V: 8-column blocks 2j and 2j+1 form k-step j
    uint32_t pf[WN / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < WN / 8; ++nb) {
      const float p0 = ex2(fmaf(sc[4 * nb], sl, -ms0));
      const float p1 = ex2(fmaf(sc[4 * nb + 1], sl, -ms0));
      const float p2 = ex2(fmaf(sc[4 * nb + 2], sl, -ms1));
      const float p3 = ex2(fmaf(sc[4 * nb + 3], sl, -ms1));
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pf[nb / 2][(nb % 2) * 2 + 0] = pack2<T>(p0, p1);
      pf[nb / 2][(nb % 2) * 2 + 1] = pack2<T>(p2, p3);
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt) {
      o[4 * dt + 0] *= a0;
      o[4 * dt + 1] *= a0;
      o[4 * dt + 2] *= a1;
      o[4 * dt + 3] *= a1;
    }
    mbar_wait(&full_v[s], phase);
    pv_product<DV, WN, true, T>(o, pf, smem_u32(sV + s * L::V_BYTES));
    mbar_arrive(&empty[s]);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (p.lse != nullptr && t4 == 0) {   // natural log: m is a raw score, l sums exp2((s - m) sl)
    float* lb = p.lse + ((size_t)b * p.H + h) * p.S;
    const float sc = p.scale_log2 / LOG2E;
    if (row0 < p.S) lb[row0] = m0 == NEG_INF ? -INFINITY : m0 * sc + logf(l0);
    if (row1 < p.S) lb[row1] = m1 == NEG_INF ? -INFINITY : m1 * sc + logf(l1);
  }
  const int dv = wd.w1();
  const size_t o_stride = (size_t)p.H * dv;   // elements between sequence positions of o
  T* ob = static_cast<T*>(p.o) + ((size_t)b * p.S * p.H + h) * dv;
#pragma unroll
  for (int dt = 0; dt < DV / 8; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if constexpr (W::PADDED) {
      if (col >= dv) continue;   // dv is a multiple of 8: whole pairs
    }
    if (row0 < p.S)
      store2(ob + (size_t)row0 * o_stride + col, o[4 * dt + 0] * inv0, o[4 * dt + 1] * inv0);
    if (row1 < p.S)
      store2(ob + (size_t)row1 * o_stride + col, o[4 * dt + 2] * inv1, o[4 * dt + 3] * inv1);
  }
}

// the kernel at the bucket (DK, DV) and kv tile WN on the padded route's
// widths (Widths in bf16, HalfWidths in fp16); layout: q's, k's and v's
// (real dims).  Returns cudaGetLastError() after the launch, or the
// error of encode() or of the shared-memory opt-in
template <int DK, int DV, int WN, class W>
int launch_fwd(const Params& p, const W& wd, const long long* layout, cudaStream_t stream) {
  constexpr CUtensorMapDataType type = tma_type<typename W::Elem>();
  CUtensorMap tm_q, tm_k, tm_v;
  int err = encode(&tm_q, p.q, layout, WM, type);
  if (!err) err = encode(&tm_k, p.k, layout + 11, WN, type);
  if (!err) err = encode(&tm_v, p.v, layout + 22, WN, type);
  if (err) return err;
  constexpr size_t smem = Smem<DK, DV, WN>::BYTES;
  static uint32_t opted = 0;   // a bit per device
  err = opt_in_smem(reinterpret_cast<const void*>(flash_fwd_bf16<DK, DV, WN, W>), smem, opted);
  if (err) return err;
  const dim3 grid(p.B * p.H, (p.S + WM - 1) / WM);
  flash_fwd_bf16<DK, DV, WN, W><<<grid, 256, smem, stream>>>(tm_q, tm_k, tm_v, p, wd);
  return (int)cudaGetLastError();
}

}  // namespace
