// Flash attention forward for Hopper (sm_90a) at q/k head dim 192 and v
// head dim 128 in bf16: deepseek-v3's multi-head latent attention (MLA)
// prefill and train-step forward, model layout (B, S, H, D).
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_bh (the
// Pallas TPU kernel, body _kernel) at these head dims and computes what
// csrc/flash_attention.cu's flash_fwd_bf16 computes: softmax(q k^T /
// sqrt(192) + mask) v with fp32 scores, a running max and normaliser, the
// finite NEG_INF = -1e30 for masked scores (causal, sliding window, keys
// past Sk), P rounded to bf16 for the P V product, acc / max(l, 1e-30) in
// bf16, zeros for a row with no visible key, and with a buffer each row's
// logsumexp in fp32 (natural log, (B, H, S)) for the backward.
//
// What bounds it on the H100 at MLA's prefill shape (B 4, S 1024, 128
// heads, causal): by the roofline, bytes: q, k, v and o once, 671 MB,
// 0.200 ms at 3.35 TB/s, against 172 GFLOP of visible pairs, 0.174 ms at
// 989 TFLOP/s.  But a block of 128 q rows reads its head's K and V for
// every kv tile up to its diagonal, 36 tiles of 80 KB a head: 1.47 GB
// through L2, most of it from L2, and L2 delivers ~5.7 TB/s.  A probe that
// computes nothing (the stream, Q and the stores alone) reads 0.316 ms one
// block a launch slot, 0.251 with the persistent grid below (PERF.md §6).
//
// What the design does about it:
//  * Blocks run 128 q rows of one (batch, head) as two consumer
//    warpgroups of 64 rows, and a producer warpgroup.  The producer drops
//    to 24 registers a thread (setmaxnreg), the consumers take 240; one
//    producer thread loads each warpgroup's Q rows and keeps a ring of two
//    128-key K/V stages full by TMA (128-byte swizzle, 64-column boxes), K
//    of tile j + 1 before V of tile j, the consumers' order.  K and V have
//    "full" and "empty" mbarriers of their own, so K of a stage is refilled
//    once both S products have read it, not after P V.
//  * The consumers take turns at the tensor cores (named barriers 1 and
//    2): each issues S of tile i (m64n128k16 over 12 k-steps, Q and K from
//    shared memory) and P V of tile i - 1 (m64n128k16, P from registers, V
//    MN-major) in its turn, then runs tile i's mask, max and exp2 while the
//    other warpgroup's products run.  Only S waits before the softmax; P V's
//    fragments and the O accumulator stay untouched until it is done.
//  * A persistent grid, one block an SM: each block's producer takes its
//    next item from a counter (the first gridDim.x by block index), loads
//    that item's first K tile while the last item ends, and a warpgroup's Q
//    rows once the warpgroup has stored its O from them.  The items keep the
//    launch order, so the blocks in flight read the K and V of a few heads,
//    which stay in L2: (batch, head) units in groups of ORDER_UNITS, q tile
//    by q tile, the heaviest under the causal mask first.
//  * O goes through shared memory: each warpgroup writes its 64 rows,
//    swizzled as TMA reads them, into its own rows of Q, and one thread
//    stores them as two 64-column boxes; rows past S are not written.
//  * TMA zero-fills rows past S or Sk; keys past Sk are still masked, as
//    are the causal diagonal tile and a window's first tiles; tiles with no
//    visible pair are neither loaded nor computed.  GQA by index: q head h
//    reads kv head h / (H / KV) through the K/V tensor maps.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6), MLA B 4,
// by step: the old kernel 0.618 ms; its body in the grouped order 0.436; a
// producer warpgroup 0.440; turns and S before P V 0.395; O by TMA 0.362;
// the persistent grid 0.339.  Measured slower: a persistent grid that
// strides its items (0.425: its blocks drift apart in the order and miss
// L2), clusters of two CTAs on adjacent q tiles sharing each K/V tile by
// TMA multicast (0.728), 64-key tiles in four stages; L2 eviction hints
// on the loads changed nothing, and O staged in 16 KB of its own, so that
// Q's rows free at an item's last S, gained 1%.
//
// fp16 runs the same kernel (flash_attention_fwd_ws_f16 below): the
// template argument W is hopper::Widths for bf16 and hopper::HalfWidths
// for fp16, read only for its element type (f16 wgmma, f16 tensor maps, P
// and O rounded to fp16).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int DK = 192, DV = 128;   // the head dims this kernel is built for
constexpr int WM = 128;             // q rows a block: two warpgroups of 64
// (batch, head) units a group of the block order: the blocks in flight
// read the K and V of a few heads, which stay in L2
constexpr int ORDER_UNITS = 8;
constexpr int CONSUMERS = 256;      // threads of the two consumer warpgroups
// registers a thread after setmaxnreg: the producer hands the consumers
// what it frees of the 168 a thread that 384 threads at one block an SM
// launch with (128 x (168 - 24) = 256 x (240 - 168))
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, Sk, H, KV;
  int causal, window;
  float scale_log2;           // log2(e) / sqrt(DK): scores in base 2
  float* lse;                 // (B, H, S) fp32 row logsumexp, or null
  // the launch's next item (past the first gridDim.x) and its blocks that
  // have taken their last: 0 at a launch's start, set back to 0 at its
  // end; one pair a stream (kernels/flash_attention.py:_sched_counters)
  unsigned int* sched;
};

// Shared memory: Q (128 rows, three 64-column boxes; each warpgroup's 64
// rows of each box hold its O at the end of an item), then STAGES K tiles
// (three boxes of WN rows) and STAGES V tiles (two boxes), then the
// mbarriers (Q full and empty a warpgroup, two item slots full and empty,
// K and V full and empty a stage) and the two item slots; one block an SM.
constexpr int WN = 128;             // kv rows a tile (kernels/flash_attention.py:KV_TILES)
constexpr int STAGES = 2;
constexpr uint32_t Q_BYTES = WM * DK * 2;
constexpr uint32_t K_BYTES = WN * DK * 2;
constexpr uint32_t V_BYTES = WN * DV * 2;
constexpr size_t SMEM_BYTES =
    1024 + Q_BYTES + STAGES * (K_BYTES + V_BYTES) + 8 * (8 + 4 * STAGES) + 8;
static_assert(SMEM_BYTES <= 232448, "over the shared memory of an SM");

// the consumers' softmax of one tile, in place: S (raw scores of rows row0
// and row0 + 8, this thread's columns) masked where the tile meets a masked
// pair, the running max m and normaliser l updated, S replaced by
// exp2((S - m) scale_log2); returns the factors a0, a1 that rescale what
// was accumulated against the old max
__device__ __forceinline__ void softmax_tile(const Params& p, float (&sc)[WN / 2], int k0,
                                             int wq0, int row0, int t4, float& m0, float& m1,
                                             float& l0, float& l1, float& a0, float& a1) {
  const int row1 = row0 + 8;
  const bool edge = k0 + WN > p.Sk || (p.causal && k0 + WN - 1 > wq0) ||
                    (p.window && k0 <= wq0 + 63 - p.window);
  if (edge) {
    // key k0 + c is visible to a row iff lo <= c <= hi; c - 2 t4 is a
    // constant of the element, so each element costs two compares
    int lo[2] = {-(1 << 30), -(1 << 30)}, hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row1 : row0;
      hi[r] = p.Sk - 1 - k0;
      if (p.causal) hi[r] = min(hi[r], row - k0);
      if (p.window) lo[r] = row - p.window + 1 - k0;
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
  a0 = ex2((m0 - mx0) * sl);
  a1 = ex2((m1 - mx1) * sl);
  m0 = mx0;
  m1 = mx1;
  // a row with no visible key yet keeps p = 0 (an fma against a max of
  // NEG_INF could leave a residue of ~1e22 in the exponent)
  const float ms0 = mx0 == NEG_INF ? 0.f : mx0 * sl;
  const float ms1 = mx1 == NEG_INF ? 0.f : mx1 * sl;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int nb = 0; nb < WN / 8; ++nb) {
    sc[4 * nb + 0] = ex2(fmaf(sc[4 * nb + 0], sl, -ms0));
    sc[4 * nb + 1] = ex2(fmaf(sc[4 * nb + 1], sl, -ms0));
    sc[4 * nb + 2] = ex2(fmaf(sc[4 * nb + 2], sl, -ms1));
    sc[4 * nb + 3] = ex2(fmaf(sc[4 * nb + 3], sl, -ms1));
    rs0 += sc[4 * nb] + sc[4 * nb + 1];
    rs1 += sc[4 * nb + 2] + sc[4 * nb + 3];
  }
  l0 = l0 * a0 + rs0;
  l1 = l1 * a1 + rs1;
}

// P (fp32, in S's accumulator layout) as T A fragments of P V:
// 8-column blocks 2j and 2j+1 form k-step j
template <typename T>
__device__ __forceinline__ void pack_p(const float (&sc)[WN / 2], uint32_t (&pf)[WN / 16][4]) {
#pragma unroll
  for (int nb = 0; nb < WN / 8; ++nb) {
    pf[nb / 2][(nb % 2) * 2 + 0] = pack2<T>(sc[4 * nb], sc[4 * nb + 1]);
    pf[nb / 2][(nb % 2) * 2 + 1] = pack2<T>(sc[4 * nb + 2], sc[4 * nb + 3]);
  }
}

__device__ __forceinline__ void rescale(float (&o)[DV / 2], float a0, float a1) {
#pragma unroll
  for (int dt = 0; dt < DV / 8; ++dt) {
    o[4 * dt + 0] *= a0;
    o[4 * dt + 1] *= a0;
    o[4 * dt + 2] *= a1;
    o[4 * dt + 3] *= a1;
  }
}

// one work item: 128 q rows of one (batch, head), and its kv tiles
struct Item {
  int b, h, q0;
  int t_lo, n;   // the first kv tile with a visible key, and how many
};

// item x of a launch (x < B * H * tiles): units in groups of ORDER_UNITS,
// each group's items q tile by q tile, the last q tiles (the heaviest
// under the causal mask) first
__device__ __forceinline__ Item item_at(const Params& p, int x, int tiles) {
  const int units = p.B * p.H;
  const int grp = x / (ORDER_UNITS * tiles), in = x % (ORDER_UNITS * tiles);
  const int width = min(ORDER_UNITS, units - grp * ORDER_UNITS);
  const int unit = grp * ORDER_UNITS + in % width;
  Item it;
  it.b = unit / p.H;
  it.h = unit % p.H;
  const int qt = p.causal ? tiles - 1 - in / width : in / width;
  it.q0 = qt * WM;
  int hi = p.Sk;
  if (p.causal) hi = min(hi, it.q0 + WM);                        // keys k <= q
  const int lo = p.window ? max(0, it.q0 - p.window + 1) : 0;    // keys k > q - window
  it.t_lo = lo / WN;
  it.n = hi > lo ? (hi + WN - 1) / WN - it.t_lo : 0;            // kv tiles with a visible key
  return it;
}

// a persistent grid of at most one block an SM: block x takes item x,
// then the counter's next until the items run out; 384 threads: two
// consumer warpgroups of 64 q rows, then the producer warpgroup; W:
// Widths (bf16) or HalfWidths (fp16), for its element type alone
template <class W>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_bf16_ws(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o, Params p) {
  using T = typename W::Elem;
  constexpr int K_BOXES = DK / BOX, V_BOXES = DV / BOX;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* sQ = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sK = sQ + Q_BYTES;
  unsigned char* sV = sK + STAGES * K_BYTES;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sV + STAGES * V_BYTES);   // [2]
  uint64_t* empty_q = full_q + 2;                                               // [2]
  uint64_t* full_x = empty_q + 2;     // [2]: an item index published
  uint64_t* empty_x = full_x + 2;     // [2]: and read by every consumer
  uint64_t* full_k = empty_x + 2;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;
  int* next_x = reinterpret_cast<int*>(empty_v + STAGES);   // [2]

  const int tid = threadIdx.x, wg = tid >> 7;
  const int tiles = (p.S + WM - 1) / WM, items = p.B * p.H * tiles;

  if (tid == 0) {
    for (int w = 0; w < 2; ++w) {
      mbar_init(&full_q[w], 1);
      mbar_init(&empty_q[w], 1);
      mbar_init(&full_x[w], 1);
      mbar_init(&empty_x[w], CONSUMERS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], CONSUMERS);
      mbar_init(&empty_v[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: one thread, item after item, loads K of the item's
    // first kv tile, each warpgroup's 64 rows of Q once that warpgroup has
    // stored the last item's O from them, then K and V tile by tile (K of
    // tile j + 1 before V of tile j: the consumers' order), each into its
    // stage once the consumers have released the tile before it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      int jk = 0, jv = 0;   // K and V tiles loaded so far, over all items
      auto load_k = [&](const Item& it, int i) {
        const int s = jk % STAGES;
        if (jk >= STAGES) mbar_wait(&empty_k[s], ((jk / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full_k[s], K_BYTES);
        const int kvh = it.h / (p.H / p.KV);
#pragma unroll
        for (int c = 0; c < K_BOXES; ++c)
          tma_load(sK + s * K_BYTES + c * WN * ROW, &tm_k, &full_k[s], c * BOX, kvh,
                   (it.t_lo + i) * WN, it.b);
        ++jk;
      };
      auto load_v = [&](const Item& it, int i) {
        const int s = jv % STAGES;
        if (jv >= STAGES) mbar_wait(&empty_v[s], ((jv / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full_v[s], V_BYTES);
        const int kvh = it.h / (p.H / p.KV);
#pragma unroll
        for (int c = 0; c < V_BOXES; ++c)
          tma_load(sV + s * V_BYTES + c * WN * ROW, &tm_v, &full_v[s], c * BOX, kvh,
                   (it.t_lo + i) * WN, it.b);
        ++jv;
      };
      // items in launch order: the first gridDim.x by block, the rest taken
      // one at a time from a counter, so that the items in flight stay
      // together in the order and their K/V in L2
      int x = blockIdx.x;
      for (int round = 0;; ++round) {
        const int slot = round & 1;
        if (round >= 2) mbar_wait(&empty_x[slot], ((round >> 1) & 1) ^ 1);
        next_x[slot] = x;
        mbar_arrive(&full_x[slot]);
        if (x >= items) break;
        const Item it = item_at(p, x, tiles);
        if (it.n > 0) load_k(it, 0);
        for (int w = 0; w < 2; ++w) {
          // every item's O goes through these rows, so wait for each
          if (round > 0) mbar_wait(&empty_q[w], (round - 1) & 1);
          if (it.n > 0) {
            mbar_expect_tx(&full_q[w], Q_BYTES / 2);
#pragma unroll
            for (int c = 0; c < K_BOXES; ++c)
              tma_load(sQ + c * WM * ROW + w * 64 * ROW, &tm_q, &full_q[w], c * BOX, it.h,
                       it.q0 + w * 64, it.b);
          }
        }
        for (int j = 1; j <= it.n; ++j) {
          if (j < it.n) load_k(it, j);
          load_v(it, j - 1);
        }
        x = gridDim.x + (int)atomicAdd(&p.sched[0], 1u);
      }
      // the last block to take its last item sets both counters back to 0
      __threadfence();
      if (atomicAdd(&p.sched[1], 1u) == gridDim.x - 1) {
        p.sched[0] = 0;
        p.sched[1] = 0;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;   // accumulator row group / column pair
    const uint32_t q_smem = smem_u32(sQ) + wg * 64 * ROW;
    unsigned char* so = sQ + wg * 64 * ROW;   // the warpgroup's rows of Q, then of O
    // The two warpgroups take turns at the tensor cores (named barriers 1
    // and 2, warpgroup 0 first): each issues its S of tile i and its P V of
    // tile i - 1 in its turn, then runs tile i's softmax while the other's
    // products run.  S of tile i is issued before tile i - 1's P V, so the
    // softmax waits only for its own S; P V's fragments and O stay untouched
    // until it is done.
    const int me = 1 + wg, other = 2 - wg;
    if (wg == 1) named_arrive(1, CONSUMERS);
    int base = 0, loaded = 0;   // kv tiles and Q tiles consumed so far, over all items
    for (int round = 0;; ++round) {
      const int slot = round & 1;
      mbar_wait(&full_x[slot], (round >> 1) & 1);
      const int x = next_x[slot];
      mbar_arrive(&empty_x[slot]);
      if (x >= items) break;
      const Item it = item_at(p, x, tiles);
      const int wq0 = it.q0 + wg * 64;   // the warpgroup's first q row
      const int row0 = wq0 + warp * 16 + g, row1 = row0 + 8;
      float o[DV / 2];   // the m64n128 accumulator: 4 values per 8-column block
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
      float m0 = NEG_INF, m1 = NEG_INF;   // running max of rows row0, row1 (raw scores)
      float l0 = 0.f, l1 = 0.f;           // this thread's share of the normaliser
      const int n = it.n;
      if (n > 0) {
        mbar_wait(&full_q[wg], loaded & 1);
        ++loaded;
        float sc[WN / 2];
        uint32_t pf[WN / 16][4];
        float a0, a1;
        int s = base % STAGES;
        mbar_wait(&full_k[s], (base / STAGES) & 1);
        named_sync(me, CONSUMERS);
        qk_product<DK, WM, WN, WN / 2, false, T>(sc, q_smem, smem_u32(sK + s * K_BYTES));
        named_arrive(other, CONSUMERS);
        wgmma_wait_all();
        pin(sc);
        mbar_arrive(&empty_k[s]);
        softmax_tile(p, sc, it.t_lo * WN, wq0, row0, t4, m0, m1, l0, l1, a0, a1);
        pack_p<T>(sc, pf);
        for (int i = 1; i < n; ++i) {
          const int j = base + i, sp = (j - 1) % STAGES;
          s = j % STAGES;
          mbar_wait(&full_k[s], (j / STAGES) & 1);
          named_sync(me, CONSUMERS);
          qk_product<DK, WM, WN, WN / 2, false, T>(sc, q_smem, smem_u32(sK + s * K_BYTES));
          mbar_wait(&full_v[sp], ((j - 1) / STAGES) & 1);
          pv_product<DV, WN, false, T>(o, pf, smem_u32(sV + sp * V_BYTES));
          named_arrive(other, CONSUMERS);
          wgmma_wait_all_but_one();   // S of tile i is done; P V of tile i - 1 may still run
          pin(sc);
          mbar_arrive(&empty_k[s]);
          softmax_tile(p, sc, (it.t_lo + i) * WN, wq0, row0, t4, m0, m1, l0, l1, a0, a1);
          wgmma_wait_all();
          pin(o);
          mbar_arrive(&empty_v[sp]);
          pack_p<T>(sc, pf);
          rescale(o, a0, a1);
        }
        const int jl = base + n - 1;
        s = jl % STAGES;
        mbar_wait(&full_v[s], (jl / STAGES) & 1);
        pv_product<DV, WN, true, T>(o, pf, smem_u32(sV + s * V_BYTES));
        mbar_arrive(&empty_v[s]);
        base += n;
      }

      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
      if (p.lse != nullptr && t4 == 0) {   // natural log: m is a raw score, l sums exp2((s - m) sl)
        float* lb = p.lse + ((size_t)it.b * p.H + it.h) * p.S;
        const float sc = p.scale_log2 / LOG2E;
        if (row0 < p.S) lb[row0] = m0 == NEG_INF ? -INFINITY : m0 * sc + logf(l0);
        if (row1 < p.S) lb[row1] = m1 == NEG_INF ? -INFINITY : m1 * sc + logf(l1);
      }
      // O through shared memory: the warpgroup's 64 rows as two 64-column
      // boxes, swizzled as TMA reads them, into its own rows of Q's first two
      // boxes (its last S is done; an item with no kv tile first waits until
      // the last item's store has read them); one thread stores them, rows
      // past S are not written, and hands the rows back to the producer
      if (n == 0) named_sync(3 + wg, 128);
      const int r0 = warp * 16 + g, r1 = r0 + 8;   // r0 & 7 == r1 & 7 == g
#pragma unroll
      for (int dt = 0; dt < DV / 8; ++dt) {
        unsigned char* box = so + (dt / 8) * WM * ROW + (((dt % 8) ^ g) << 4) + t4 * 4;
        *reinterpret_cast<uint32_t*>(box + r0 * ROW) =
            pack2<T>(o[4 * dt + 0] * inv0, o[4 * dt + 1] * inv0);
        *reinterpret_cast<uint32_t*>(box + r1 * ROW) =
            pack2<T>(o[4 * dt + 2] * inv1, o[4 * dt + 3] * inv1);
      }
      fence_proxy_async();
      named_sync(3 + wg, 128);
      if ((tid & 127) == 0) {
        if (wq0 < p.S) {
#pragma unroll
          for (int c = 0; c < DV / BOX; ++c)
            tma_store(&tm_o, so + c * WM * ROW, c * BOX, it.h, wq0, it.b);
          bulk_commit();
          bulk_wait_read();
        }
        mbar_arrive(&empty_q[wg]);
      }
    }
    // warpgroup 0 takes the turn warpgroup 1 handed it last, so that each
    // barrier ends with as many arrivals as waits
    if (wg == 0) named_sync(1, CONSUMERS);
  }
}

template <class W>
int launch(const Params& p, const long long* layout, cudaStream_t stream) {
  constexpr CUtensorMapDataType type = tma_type<typename W::Elem>();
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  int err = encode(&tm_q, p.q, layout, 64, type);
  if (!err) err = encode(&tm_k, p.k, layout + 11, WN, type);
  if (!err) err = encode(&tm_v, p.v, layout + 22, WN, type);
  if (!err) err = encode(&tm_o, p.o, layout + 33, 64, type);
  if (err) return err;
  static uint32_t opted = 0;
  err = opt_in_smem(reinterpret_cast<const void*>(flash_fwd_bf16_ws<W>), SMEM_BYTES, opted);
  if (err) return err;
  const int items = p.B * p.H * ((p.S + WM - 1) / WM);
  static int sms[32] = {0};   // SMs of each device, read once
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  const int blocks = min(items, dev < 32 ? sms[dev] : 132);
  flash_fwd_bf16_ws<W><<<blocks, 384, SMEM_BYTES, stream>>>(tm_q, tm_k, tm_v, tm_o, p);
  return 0;
}

// the entries' shared checks and launch: (dk, dv) (192, 128), or the
// padded route's dims in that bucket; kv_tile WN
template <class W>
int launch_checked(const void* q, const void* k, const void* v, void* o, int B, int S, int Sk,
                   int H, int KV, int dk, int dv, int causal, int window, void* stream,
                   const long long* layout, float* lse, int kv_tile, unsigned int* sched,
                   int scale_dk) {
  const bool routed = dk == 192 && dv == 128;
  // the padded route (kernels/flash_attention.py:route): real head dims,
  // multiples of 8, whose smallest built pair is (192, 128).  The tensor
  // maps carry them: TMA zero-fills q, k and v past them and clips O's
  // stores, so the kernel is this one, scaled by 1 / sqrt(real dk)
  const bool padded = dk > 128 && dk <= DK && dv > 0 && dv <= DV && dk % 8 == 0 && dv % 8 == 0;
  if (!(routed || padded) || kv_tile != WN || !pitch_of(scale_dk, dk))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, B, S, Sk, H, KV, causal, window, LOG2E / sqrtf((float)scale_dk), lse,
           sched};
  const int err = launch<W>(p, layout, static_cast<cudaStream_t>(stream));
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

// q: (B, S, H, 192); k: (B, Sk, KV, 192); v: (B, Sk, KV, 128); o: (B, S,
// H, 128); all bf16, contiguous (or, on the padded route, q/k dim dk in
// (128, 192] and v dim dv up to 128, multiples of 8).  layout: the TMA layouts of q and o
// (boxes of 64 rows) and k and v (boxes of kv_tile rows), 11 values each.
// lse: null, or a (B, H, S) fp32 buffer for each row's logsumexp.
// kv_tile: 128 (kernels/flash_attention.py:KV_TILES).  sched: the
// stream's two counters, 0.  scale_dk: the q/k head dim the scores are
// scaled by, dk or on the staged route the real dim that dk, its pitch,
// rounds up (csrc/flash_attention_pad.cu).  Returns cudaGetLastError()
// after the launch, a negative code from encode(), or
// cudaErrorInvalidValue for head dims or a tile it is not built for.
extern "C" int flash_attention_fwd_ws(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int Sk, int H, int KV, int dk, int dv,
                                      int causal, int window, void* stream,
                                      const long long* layout, float* lse, int kv_tile,
                                      unsigned int* sched, int scale_dk) {
  return launch_checked<Widths>(q, k, v, o, B, S, Sk, H, KV, dk, dv, causal, window, stream,
                                layout, lse, kv_tile, sched, scale_dk);
}

// The same in fp16 (q, k, v and o all fp16; the layouts as above): dtype
// is the launcher's code, 2 (fp16), and any other is refused with
// cudaErrorInvalidValue.
extern "C" int flash_attention_fwd_ws_f16(const void* q, const void* k, const void* v, void* o,
                                          int B, int S, int Sk, int H, int KV, int dk, int dv,
                                          int causal, int window, int dtype, void* stream,
                                          const long long* layout, float* lse, int kv_tile,
                                          unsigned int* sched, int scale_dk) {
  if (dtype != 2) return (int)cudaErrorInvalidValue;
  return launch_checked<HalfWidths>(q, k, v, o, B, S, Sk, H, KV, dk, dv, causal, window, stream,
                                    layout, lse, kv_tile, sched, scale_dk);
}
