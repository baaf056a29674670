// The fp32 flash-attention forward for Hopper (sm_90a), model layout
// (B, S, H, D), at every q/k head dim dk and v head dim dv from 1 to 256.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_bh (the
// Pallas TPU kernel, body _kernel) in fp32 and computes the same function:
// softmax(q k^T / sqrt(dk) + mask) v with fp32 scores, a running max m and
// normaliser l in base 2, the causal, sliding-window and ragged (keys past
// Sk) masks, GQA by index (q head h reads kv head h / (H / KV), no copy of
// K or V), and o = acc / max(l, 1e-30).  Every product is a full fp32 FMA
// on the CUDA cores: TF32 on the tensor cores keeps about three digits,
// and the fp32 gates hold 1e-4.  When given a buffer it also writes each
// row's logsumexp in natural log, (B, H, S), which the fp32 backward
// (csrc/flash_attention_bwd_f32.cu) reads.  A row with no visible key
// (only where Sk < S under a window) keeps m at -1e30, so every key slot
// of the kv tiles its block visits weighs 1 (zero rows past Sk): it gets
// the mean of those slots' V, and lse -inf, as the SIMT kernel it
// replaces gave it; a block that visits no tile writes zeros.
//
// What bounds it on the H100: fp32 FMAs, 67 TFLOP/s on the CUDA cores.  At
// granite-3-2b's prefill shape (B 4, S 1024, H 32, KV 8, D 64, causal) the
// two products over the visible pairs are 17.2 GFLOP, 0.2567 ms, against
// 0.0125 ms for the bytes.  The SIMT kernels this replaces (a thread a q
// row reading one float of K or V from shared memory per FMA, or four
// threads a row with two shuffles a score; phi-2's D 80 on 128 columns)
// read 0.089-0.185 of their bound (PERF.md §6).  Shared memory feeds an
// SM 32 floats a clock against 128 FMA lanes, so what a layout buys is
// FMAs per shared-memory wavefront.
//
// What the design does about it, as the fp32 backward does: both products
// are register-tiled outer products of 256 threads over shared memory.
//  * Tiles: a block keeps RR = 128 q rows of Q in shared memory (64 at D
//    256) and streams K and V in stages of RS rows by cp.async (16-byte
//    copies where the head dim is a multiple of 4, 4-byte ones else; rows
//    past Sk and the columns up to a multiple of 4 zero-filled by the
//    copy), two or three stages, so each staged tile serves RR q rows.
//    Rows are padded by 4 floats (the score tile's by 8), so the float4
//    reads of a warp's 4 or 8 rows fall in distinct bank quads.
//  * S = Q K^T: each thread an MA x NA = 8 x 4 micro-tile (4 x 4 at D 256;
//    rows r + TAR i, columns c + TAC j), summed over the head dim by float4
//    reads of both operands' rows; a warp is 4 rows by 8 columns of the
//    thread grid, so a step's 8 + 4 float4 reads are one wavefront each
//    against 128 FMAs.  No per-score shuffle.  Where a stage is 32 rows
//    (from DK 128) the threads form two groups, each over half the head dim
//    (DSPLIT: two partial sums a score, added in order).  The loop stops at
//    the real dim rounded up to 4.
//  * Online softmax over the tile in shared memory, TPR = 2 adjacent
//    threads a row (4 at D 256): the row max by shuffles, m, alpha =
//    exp2(m_old - m), P = exp2(S scale_log2 - m) written over S, l +=
//    rowsum(P); masks skipped on tiles that are wholly visible.
//  * O += P V: an RR x bucket-width register tile of TBR x TBC threads,
//    each MB rows by C chunks of 4 columns (8 x 4 at (64, 64), 4 x 12 at
//    (96, 96), 8 x 8 at 128 columns, 4 x 16 at 256), a warp 4 rows by 8
//    chunks; fed a float4 of P per row and a float4 of V per chunk,
//    rescaled by each row's alpha, and written once.
//  * Widths: templated on a bucket of widths (BUCKETS, the first that holds
//    (dk, dv); kernels/flash_attention.py:F32_BUCKETS), with the real dims
//    at run time: phi-2's D 80 runs the (96, 96) bucket, the smoke dims and
//    D 40 the (64, 64) one.
//  * Heaviest blocks first: under the causal mask the last q tiles launch
//    first; only the kv tiles that hold a key some row of the block sees
//    are loaded and computed.
//  * Budget: one block an SM, 173-221 KB of shared memory, 214-254
//    registers a thread with no spill: 128 q rows a block read 1.02-1.23x
//    faster than 64 at two blocks an SM (PERF.md §6).  At D 256 the O tile of
//    128 rows would be 128 accumulators a thread and Q 133 KB, so it keeps
//    64 rows with 32-row stages and the head dim cut in two for the scores
//    (Q 66.5 KB, two stages of K and V 133 KB; without the cut 1.22x
//    slower).
//
// Three barriers a tile: the next tile's copies are issued after the
// first, when every thread is done with the stage they overwrite.

#include <math.h>
#include <stdint.h>

#include "flash_attention_f32.cuh"   // THREADS, PAD, cp.async tiles; hopper.cuh's ex2

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int SPAD = 8;   // floats past each shared row of the score tile
constexpr size_t BLOCK_SMEM = 232448;   // 227 KB a block may take

// The buckets of widths, smallest first: (DKB, DVB, RR, RS).  RR: q rows a
// block keeps; RS: kv rows a stage streams (kernels/flash_attention.py:
// F32_BUCKETS, F32_FWD_TILES)
constexpr int BUCKETS[5][4] = {
    {64, 64, 128, 64}, {96, 96, 128, 64}, {128, 128, 128, 32}, {192, 128, 128, 32},
    {256, 256, 64, 32}};

constexpr int bucket_row(int dkb, int dvb) {
  for (int i = 0; i < 5; ++i)
    if (BUCKETS[i][0] == dkb && BUCKETS[i][1] == dvb) return i;
  return -1;
}

template <int DKB_, int DVB_>
struct Tiles {
  static constexpr int DKB = DKB_, DVB = DVB_;
  static constexpr int ROW = bucket_row(DKB, DVB);
  static constexpr int RR = BUCKETS[ROW][2], RS = BUCKETS[ROW][3];
  static constexpr int LK = DKB + PAD, LV = DVB + PAD, LP = RS + SPAD;   // shared row strides
  // S: DSPLIT groups of TAR x TAC threads, each over its share of the head
  // dim, of MA x NA micro-tiles
  static constexpr int DSPLIT = RS == 32 ? 2 : 1;
  static constexpr int GROUP = THREADS / DSPLIT;
  static constexpr int NA = 4, TAC = RS / NA, TAR = GROUP / TAC, MA = RR / TAR;
  // O: TBR x TBC threads of MB rows by C chunks of 4 columns
  static constexpr int TBC = DVB % 64 ? 8 : 16;
  static constexpr int TBR = THREADS / TBC, MB = RR / TBR, C = DVB / (4 * TBC);
  // the softmax: TPR threads a row, NQ float4 of it each
  static constexpr int TPR = THREADS / RR, NQ = RS / (4 * TPR);
  static constexpr int STAGE = RS * (LK + LV);   // floats of a stage's K and V
  static constexpr int SCORES = DSPLIT * RR * LP;
  // Q; the stages of K, V; the scores; each row's alpha and l
  static constexpr size_t bytes(int stages) {
    return 4 * (RR * LK + stages * STAGE + SCORES + 2 * RR);
  }
  // three stages (two tiles in flight) where they fit, else two
  static constexpr int STAGES = bytes(3) <= BLOCK_SMEM ? 3 : 2;
  static constexpr size_t BYTES = bytes(STAGES);
  static_assert(ROW >= 0, "a bucket of BUCKETS");
  static_assert(TAC % 8 == 0 && TAR % 4 == 0 && RR % TAR == 0, "score grid");
  static_assert(TBC % 8 == 0 && TBR % 4 == 0 && RR % TBR == 0, "output grid");
  static_assert(DVB % (4 * TBC) == 0 && DKB % 4 == 0, "output columns");
  static_assert(RS % (4 * TPR) == 0 && (TPR & (TPR - 1)) == 0 && TPR <= 32, "softmax rows");
  static_assert(BYTES <= BLOCK_SMEM, "shared memory");
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;             // (B, H, S) natural log, or null
  int B, S, Sk, H, KV;
  int dk_dim, dv_dim;     // the real head dims
  int causal, window;
  float scale_log2;       // log2(e) / sqrt(dk): scores in base 2
};

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  bool ok = kpos < p.Sk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window) ok = ok && kpos > qpos - p.window;
  return ok;
}

// whether every pair of q rows [q_lo, q_lo + qn) and kv rows [k_lo, k_lo +
// kn) is visible: then a tile needs no mask
__device__ __forceinline__ bool tile_full(const Params& p, int q_lo, int qn, int k_lo, int kn) {
  bool ok = k_lo + kn <= p.Sk;
  if (p.causal) ok = ok && k_lo + kn - 1 <= q_lo;
  if (p.window) ok = ok && k_lo > q_lo + qn - 1 - p.window;
  return ok;
}

// thread t of a grid of TC columns (a multiple of 8) as (row, column): each
// warp 4 rows by 8 columns of it
template <int TC>
__device__ __forceinline__ void warp_grid(int t, int& r, int& c) {
  const int w = t >> 5, lane = t & 31;
  r = (w / (TC / 8)) * 4 + (lane >> 3);
  c = (w % (TC / 8)) * 8 + (lane & 7);
}

// S = Q K^T over this thread's group's share of the head dim: its MA x NA
// micro-tile stored to the group's RR x LP partial tile
template <class T>
__device__ __forceinline__ void scores(float* sS, const float* sQ, const float* sK, int dk4) {
  const int g = threadIdx.x / T::GROUP;
  int ar, ac;
  warp_grid<T::TAC>(threadIdx.x % T::GROUP, ar, ac);
  // the group's columns [lo, hi), cut at a multiple of 4
  const int cut = T::DSPLIT == 1 ? dk4 : ((dk4 / 2 + 3) & ~3);
  const int lo = g ? cut : 0, hi = g ? dk4 : cut;
  float c[T::MA][T::NA];
#pragma unroll
  for (int i = 0; i < T::MA; ++i)
#pragma unroll
    for (int j = 0; j < T::NA; ++j) c[i][j] = 0.f;
#pragma unroll 2
  for (int d = lo; d < hi; d += 4) {
    float4 a[T::MA], b[T::NA];
#pragma unroll
    for (int i = 0; i < T::MA; ++i)
      a[i] = *reinterpret_cast<const float4*>(sQ + (ar + T::TAR * i) * T::LK + d);
#pragma unroll
    for (int j = 0; j < T::NA; ++j)
      b[j] = *reinterpret_cast<const float4*>(sK + (ac + T::TAC * j) * T::LK + d);
#pragma unroll
    for (int i = 0; i < T::MA; ++i)
#pragma unroll
      for (int j = 0; j < T::NA; ++j) {
        c[i][j] = fmaf(a[i].x, b[j].x, c[i][j]);
        c[i][j] = fmaf(a[i].y, b[j].y, c[i][j]);
        c[i][j] = fmaf(a[i].z, b[j].z, c[i][j]);
        c[i][j] = fmaf(a[i].w, b[j].w, c[i][j]);
      }
  }
  float* dst = sS + g * T::RR * T::LP;
#pragma unroll
  for (int i = 0; i < T::MA; ++i)
#pragma unroll
    for (int j = 0; j < T::NA; ++j) dst[(ar + T::TAR * i) * T::LP + ac + T::TAC * j] = c[i][j];
}

// The online softmax of the tile's rows, TPR adjacent threads a row (row
// threadIdx.x / TPR, whose m and l they each keep): scores (the partials
// added in order) in base 2, masked to -1e30 unless the tile is full; the
// new row max m, alpha = exp2(m_old - m) to sAlpha, P = exp2(s - m) over
// the first partial tile, l = l alpha + rowsum(P)
template <class T>
__device__ __forceinline__ void softmax(const Params& p, float* sS, float* sAlpha, float& m,
                                        float& l, int q0, int k0, bool full) {
  const int r = threadIdx.x / T::TPR, part = threadIdx.x % T::TPR;
  float s[T::NQ][4];
  float mx = NEG_INF;
#pragma unroll
  for (int n = 0; n < T::NQ; ++n) {
    const int c = 4 * (part + T::TPR * n), at_ = r * T::LP + c;
    float4 x = *reinterpret_cast<const float4*>(sS + at_);
    if (T::DSPLIT == 2) {
      const float4 y = *reinterpret_cast<const float4*>(sS + T::RR * T::LP + at_);
      x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w;
    }
    s[n][0] = x.x, s[n][1] = x.y, s[n][2] = x.z, s[n][3] = x.w;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      s[n][w] = full || visible(p, q0 + r, k0 + c + w) ? s[n][w] * p.scale_log2 : NEG_INF;
      mx = fmaxf(mx, s[n][w]);
    }
  }
#pragma unroll
  for (int o = 1; o < T::TPR; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float m_new = fmaxf(m, mx);
  const float alpha = hopper::ex2(m - m_new);
  float sum = 0.f;
#pragma unroll
  for (int n = 0; n < T::NQ; ++n) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      s[n][w] = hopper::ex2(s[n][w] - m_new);
      sum += s[n][w];
    }
    *reinterpret_cast<float4*>(sS + r * T::LP + 4 * (part + T::TPR * n)) =
        make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
  }
#pragma unroll
  for (int o = 1; o < T::TPR; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  l = l * alpha + sum;
  m = m_new;
  if (part == 0) sAlpha[r] = alpha;
}

// acc[i][4 j + e] = acc alpha(row) + sum over x < RS of P[br + TBR i][x] *
// V[x][4 (bc + TBC j) + e]
template <class T>
__device__ __forceinline__ void pv(float (&acc)[T::MB][4 * T::C], const float* sP,
                                   const float* sV, const float* sAlpha, int br, int bc) {
#pragma unroll
  for (int i = 0; i < T::MB; ++i) {
    const float a = sAlpha[br + T::TBR * i];
#pragma unroll
    for (int c = 0; c < 4 * T::C; ++c) acc[i][c] *= a;
  }
#pragma unroll 2
  for (int x = 0; x < T::RS; x += 4) {
    float4 a[T::MB];
#pragma unroll
    for (int i = 0; i < T::MB; ++i)
      a[i] = *reinterpret_cast<const float4*>(sP + (br + T::TBR * i) * T::LP + x);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int j = 0; j < T::C; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(sV + (x + e) * T::LV +
                                                          4 * (bc + T::TBC * j));
#pragma unroll
        for (int i = 0; i < T::MB; ++i) {
          const float ai = at(a[i], e);
          acc[i][4 * j + 0] = fmaf(ai, b.x, acc[i][4 * j + 0]);
          acc[i][4 * j + 1] = fmaf(ai, b.y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(ai, b.z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(ai, b.w, acc[i][4 * j + 3]);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// the kernel: RR q rows of one head over the kv tiles they see
// ---------------------------------------------------------------------------
template <int DKB, int DVB>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_f32_tiled(Params p) {
  using T = Tiles<DKB, DVB>;
  constexpr int RR = T::RR, RS = T::RS, LK = T::LK, LV = T::LV;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                                  // RR x LK
  float* sStage = sQ + RR * LK;                      // stages: K (RS x LK), V (RS x LV)
  float* sS = sStage + T::STAGES * T::STAGE;         // S partials, then P (RR x LP)
  float* sAlpha = sS + T::SCORES;                    // RR
  float* sL = sAlpha + RR;                           // RR

  const int tid = threadIdx.x;
  const int dk = p.dk_dim, dv = p.dv_dim;
  const int units = p.B * p.H;
  const int n_qt = (p.S + RR - 1) / RR;
  const int rank = blockIdx.x / units, bh = blockIdx.x % units;
  // causal: the first blocks take the last q tiles, which have the most kv tiles
  const int qt = p.causal ? n_qt - 1 - rank : rank;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * RR;
  // kv rows [lo, hi) that some q row of the block sees, in tiles of RS
  const int hi = p.causal ? min(p.Sk, q0 + RR) : p.Sk;
  const int lo = p.window ? max(0, q0 - p.window + 1) : 0;
  const int t_lo = lo / RS;
  const int n = hi > lo ? (hi + RS - 1) / RS - t_lo : 0;
  const size_t q_off = ((size_t)b * p.S * p.H + h) * dk, o_off = ((size_t)b * p.S * p.H + h) * dv;
  const float* kb = p.k + ((size_t)b * p.Sk * p.KV + kvh) * dk;
  const float* vb = p.v + ((size_t)b * p.Sk * p.KV + kvh) * dv;
  const size_t k_stride = (size_t)p.KV * dk, v_stride = (size_t)p.KV * dv;

  auto load_kv = [&](int j) {   // kv tile t_lo + j into stage j % STAGES
    float* st = sStage + (j % T::STAGES) * T::STAGE;
    const int k0 = (t_lo + j) * RS;
    load_tile<RS, LK>(st, kb, k_stride, k0, p.Sk, dk);
    load_tile<RS, LV>(st + RS * LK, vb, v_stride, k0, p.Sk, dv);
  };
  if (n > 0) {
    load_tile<RR, LK>(sQ, p.q + q_off, (size_t)p.H * dk, q0, p.S, dk);
    for (int j = 0; j < T::STAGES - 1 && j < n; ++j) {
      load_kv(j);
      cp_commit();
    }
  }

  int br, bc;
  warp_grid<T::TBC>(tid, br, bc);
  const int dk4 = (dk + 3) & ~3;
  float m = NEG_INF, l = 0.f;   // of softmax row tid / TPR
  float acc[T::MB][4 * T::C];
#pragma unroll
  for (int i = 0; i < T::MB; ++i)
#pragma unroll
    for (int c = 0; c < 4 * T::C; ++c) acc[i][c] = 0.f;

  for (int j = 0; j < n; ++j) {
    cp_wait_tile<T::STAGES>(j, n);
    __syncthreads();   // tile j landed; every thread is done with tile j - 1
    if (j + T::STAGES - 1 < n) {   // into the stage tile j - 1 left
      load_kv(j + T::STAGES - 1);
      cp_commit();
    }
    const float* sK = sStage + (j % T::STAGES) * T::STAGE;
    const float* sV = sK + RS * LK;
    const int k0 = (t_lo + j) * RS;
    scores<T>(sS, sQ, sK, dk4);
    __syncthreads();
    softmax<T>(p, sS, sAlpha, m, l, q0, k0, tile_full(p, q0, RR, k0, RS));
    __syncthreads();
    pv<T>(acc, sS, sV, sAlpha, br, bc);
  }

  // each row's l for the output and, when asked, its lse (m and l are in
  // base 2 here)
  if (tid % T::TPR == 0) {
    const int r = tid / T::TPR;
    sL[r] = l;
    if (p.lse != nullptr && q0 + r < p.S)
      p.lse[((size_t)b * p.H + h) * p.S + q0 + r] =
          m == NEG_INF ? -INFINITY : (m + log2f(l)) / LOG2E;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < T::MB; ++i) {
    const int row = q0 + br + T::TBR * i;
    if (row >= p.S) continue;
    const float inv = 1.f / fmaxf(sL[br + T::TBR * i], 1e-30f);
    float* dst = p.o + o_off + (size_t)row * p.H * dv;
#pragma unroll
    for (int j = 0; j < T::C; ++j) {
      const int col = 4 * (bc + T::TBC * j);
      if (col >= dv) continue;
      if (col + 4 <= dv && (dv & 3) == 0) {   // aligned: one vector store
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(acc[i][4 * j] * inv, acc[i][4 * j + 1] * inv, acc[i][4 * j + 2] * inv,
                        acc[i][4 * j + 3] * inv);
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (col + w < dv) dst[col + w] = acc[i][4 * j + w] * inv;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <int DKB, int DVB>
int launch(const Params& p, cudaStream_t stream) {
  using T = Tiles<DKB, DVB>;
  static uint32_t opted = 0;   // a bit per device
  const int err = hopper::opt_in_smem(
      reinterpret_cast<const void*>(flash_fwd_f32_tiled<DKB, DVB>), T::BYTES, opted);
  if (err) return err;
  const long long blocks = (long long)p.B * p.H * ((p.S + T::RR - 1) / T::RR);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_fwd_f32_tiled<DKB, DVB><<<(unsigned)blocks, THREADS, T::BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, S, H, DK); k: (B, Sk, KV, DK); v: (B, Sk, KV, DV); o: (B, S, H,
// DV); all contiguous fp32 (dtype code 0; any other is refused with
// cudaErrorInvalidValue), 1 <= DK, DV <= 256.  lse: null, or a (B, H, S)
// fp32 buffer for each row's logsumexp.  The bucket is the first of
// BUCKETS that holds (DK, DV).  Returns cudaGetLastError() after the
// launch.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                       int B, int S, int Sk, int H, int KV, int DK, int DV,
                                       int causal, int window, int dtype, void* stream,
                                       float* lse) {
  if (dtype != 0 || B < 1 || S < 1 || Sk < 1 || H < 1 || KV < 1 || H % KV || DK < 1 ||
      DV < 1 || DK > 256 || DV > 256)
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<float*>(o), lse, B, S, Sk, H, KV, DK,
                 DV, causal, window, LOG2E / sqrtf((float)DK)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int row = 0;
  while (row < 5 && (DK > BUCKETS[row][0] || DV > BUCKETS[row][1])) ++row;
  switch (row) {
    case 0: return launch<64, 64>(p, st);
    case 1: return launch<96, 96>(p, st);
    case 2: return launch<128, 128>(p, st);
    case 3: return launch<192, 128>(p, st);
    case 4: return launch<256, 256>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
