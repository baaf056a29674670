// The bf16 SSD backward kernels (wgmma + TMA, namespace tc), shared by
// csrc/ssd_scan_bwd.cu (mamba2's (P 64, N 128)) and
// csrc/ssd_scan_bwd_pad.cu (the padded route: P and N multiples of 8
// inside them, the *_pad kernels).  The design notes are in
// csrc/ssd_scan_bwd.cu's header.
#pragma once

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// bf16 at (P 64, N 128): prep, states and chunks on wgmma
// ---------------------------------------------------------------------------
namespace tc {

constexpr int Q = 64, P = 64, N = 128;
constexpr int NBX = N / BOX;                   // 64-column boxes of a state row
constexpr uint32_t TILE = 64 * ROW;            // one box of 64 rows: 8 KB
constexpr uint32_t BLOB = 2 * NBX * TILE;      // a state's hi boxes, then its lo boxes: 32 KB
constexpr int VEC = 3 * Q;                     // a chunk's per-step floats: ch, cl, dt
constexpr double LOG2E = 1.4426950408889634;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// the byte offset of (row, col) in a 64-column box as the 128-byte swizzle lays it out
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * ROW + (((uint32_t)col * 2) ^ ((row & 7) << 4));
}

__device__ __forceinline__ float2 ld_bf2(const unsigned char* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---- 1. the chunks' per-step vectors ---------------------------------------
// vec (B H, nc, 3, Q): cs log2(e) as the float pair ch + cl (cs the chunk's
// cumsum of dt a, in fp64), and dt; steps past L have dt 0.
template <typename TA>
__global__ void __launch_bounds__(128) ssd_bwd_prep(const __nv_bfloat16* __restrict__ dt,
                                                    const TA* __restrict__ a, float* vec, int L,
                                                    int H, int nc, int items) {
  const int item = blockIdx.x * 4 + (threadIdx.x >> 5);   // (b h, chunk)
  if (item >= items) return;                              // warp-uniform
  const int lane = threadIdx.x & 31;
  const int bh = item / nc, c = item % nc, bi = bh / H, h = bh % H;
  const float av = to_f(a[h]);
  float d[2];
  double v[2], run = 0.0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int l = c * Q + 2 * lane + k;
    d[k] = l < L ? __bfloat162float(dt[((size_t)bi * L + l) * H + h]) : 0.f;
    run += (double)(d[k] * av);
    v[k] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += o;
  }
  const double excl = incl - run;
  float* out = vec + (size_t)item * VEC;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = 2 * lane + k;
    const double c2 = (v[k] + excl) * LOG2E;
    const float hi = (float)c2;
    out[j] = hi;
    out[Q + j] = (float)(c2 - (double)hi);
    out[2 * Q + j] = d[k];
  }
}

// ---- 2. the states entering and the gradients leaving each chunk ----------
struct StParams {
  const __nv_bfloat16* dstate;   // (B, H, P, N) contiguous, or null: a zero gradient
  const float* vec;              // kernel 1's
  __nv_bfloat16* st;             // (B H, nc) blobs: S entering chunk c (c >= 1)
  __nv_bfloat16* ds;             // (B H, nc) blobs: dS leaving chunk c
  int H, nc;
};

// two stages of (the A tile: x or dy; a 64-column box of B or C; the
// chunk's vectors), the split operand's hi and lo tiles, two barriers
constexpr size_t ST_BYTES = 1024 + 6 * TILE + 2 * VEC * 4 + 16;

// acc (64 x 64 fp32, the wgmma layout: rows warp*16 + g (+8), columns
// 8 nb + 2 t4 (+1)) as hi and lo parts into two boxes of shared memory,
// laid out as a blob's
__device__ __forceinline__ void stage_parts(unsigned char* hi, unsigned char* lo,
                                            const float (&acc)[32], int warp, int g, int t4) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t off = swz(warp * 16 + g + 8 * r, nb * 8 + 2 * t4);
      split_bf16(acc[4 * nb + 2 * r], acc[4 * nb + 2 * r + 1],
                 *reinterpret_cast<uint32_t*>(hi + off), *reinterpret_cast<uint32_t*>(lo + off));
    }
}

// blockIdx: (b h, 64-column slice, direction).  Direction 0 walks chunks
// 0 .. nc-2 forward and writes S entering chunks 1 .. nc-1; direction 1
// starts from dstate, walks chunks nc-1 .. 1 back and writes dS leaving
// chunks nc-1 .. 0.  X with an initial state: direction 0 starts from it
// and writes it as S entering chunk 0 too; direction 1 takes one more
// step, past chunk 0, and writes s0's gradient (fp32, ext.ds0).
// The body at (P, N); wd: the real (P, N) (hopper.cuh: FixedWidths, or
// Widths on the padded route, where dstate's and s0's loads and s0's
// gradient's stores stop at them)
template <bool X, class W>
__device__ __forceinline__ void ssd_bwd_states_body(const CUtensorMap& tm_x,
                                                    const CUtensorMap& tm_b,
                                                    const CUtensorMap& tm_c,
                                                    const CUtensorMap& tm_dy,
                                                    const StParams& prm, const SsdExt& ext,
                                                    const W& wd) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* sHi = base + 4 * TILE;   // the scaled operand's parts
  unsigned char* sLo = base + 5 * TILE;
  float* sVec = reinterpret_cast<float*>(base + 6 * TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(sVec + 2 * VEC);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, nbx = blockIdx.y, dir = blockIdx.z;
  const int H = prm.H, nc = prm.nc, bi = bh / H, h = bh % H;
  const CUtensorMap* tma = dir ? &tm_dy : &tm_x;
  const CUtensorMap* tmb = dir ? &tm_c : &tm_b;
  const int grp = X ? h / ext.hpg : 0;   // this head's B/C group
  const bool has_s0 = X && ext.s0 != nullptr;
  const int steps = nc - 1 + (has_s0 && dir ? 1 : 0);
  __nv_bfloat16* out = dir ? prm.ds : prm.st;
  const int pw = wd.w0(), nw = wd.w1();   // the real (P, N)
  float acc[32];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = warp * 16 + g + 8 * (e >> 1), n = nbx * BOX + nb * 8 + 2 * t4 + (e & 1);
      const size_t at = ((size_t)bh * pw + p) * nw + n;
      if (W::PADDED && (p >= pw || n >= nw)) acc[4 * nb + e] = 0.f;   // past the real (P, N)
      else if (has_s0 && !dir) acc[4 * nb + e] = ld_s0<__nv_bfloat16>(ext, at);
      else
        acc[4 * nb + e] = dir && prm.dstate != nullptr ? __bfloat162float(prm.dstate[at]) : 0.f;
    }
  // the parts of acc, staged in sHi and sLo, to box nbx of chunk c's blob:
  // one bulk copy each, whole lines
  auto store = [&](int c) {
    stage_parts(sHi, sLo, acc, warp, g, t4);
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      unsigned char* dst = reinterpret_cast<unsigned char*>(out + ((size_t)bh * nc + c) * (BLOB / 2));
      bulk_store(dst + nbx * TILE, sHi, TILE);
      bulk_store(dst + (NBX + nbx) * TILE, sLo, TILE);
      bulk_commit();
    }
  };
  auto chunk_of = [&](int t) { return dir ? nc - 1 - t : t; };
  auto load = [&](int t) {
    const int s = t & 1, c = chunk_of(t);
    unsigned char* sa = base + s * 2 * TILE;
    mbar_expect_tx(full + s, 2 * TILE + VEC * 4);
    tma_load(sa, tma, full + s, 0, h, c * Q, bi);
    tma_load(sa + TILE, tmb, full + s, nbx * BOX, grp, c * Q, bi);
    bulk_load(sVec + s * VEC, prm.vec + ((size_t)bh * nc + c) * VEC, VEC * 4, full + s);
  };

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    if (steps > 0) load(0);
    if (steps > 1) load(1);
  }

  if (dir) store(nc - 1);
  else if (has_s0) store(0);

  for (int t = 0; t < steps; ++t) {
    const int s = t & 1, c = chunk_of(t);
    unsigned char* sa = base + s * 2 * TILE;
    unsigned char* sb = sa + TILE;
    const float* ch = sVec + s * VEC;
    const float* cl = ch + Q;
    const float* dts = cl + Q;
    mbar_wait(full + s, (t >> 1) & 1);
    if (tid == 0) bulk_wait_read();   // the last store has read sHi and sLo
    __syncthreads();
    const float chL = ch[Q - 1], clL = cl[Q - 1];
    // the operand this direction scales, as hi and lo parts in the source's
    // layout: x's rows by e^{cs_last - cs_j} dt_j, or C's by e^{cs_i}.  The
    // swizzle moves 16-byte pieces within a row, so a piece's row is its
    // offset over ROW.
    const unsigned char* src = dir ? sb : sa;
    for (int e = tid; e < Q * BOX / 8; e += 128) {
      const int r = e * 16 / ROW;
      const float w = dir ? ex2(ch[r] + cl[r]) : ex2((chL - ch[r]) + (clL - cl[r])) * dts[r];
      const uint4 v = *reinterpret_cast<const uint4*>(src + e * 16);
      const uint32_t* u = reinterpret_cast<const uint32_t*>(&v);
      uint4 hi, lo;
      uint32_t* uh = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* ul = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[k]));
        split_bf16(f.x * w, f.y * w, uh[k], ul[k]);
      }
      *reinterpret_cast<uint4*>(sHi + e * 16) = hi;
      *reinterpret_cast<uint4*>(sLo + e * 16) = lo;
    }
    fence_proxy_async();
    __syncthreads();
    // acc = e^{cs_last} acc + A^T Bm over the chunk's steps: direction 0 A
    // = xw (hi, lo), Bm = B; direction 1 A = dy, Bm = e^{cs} C (hi, lo);
    // both read MN-major
    const float keep = ex2(chL + clL);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= keep;
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        const uint32_t sp = smem_u32(part ? sLo : sHi) + kk * 16 * ROW;
        const uint32_t so = smem_u32(dir ? sa : sb) + kk * 16 * ROW;
        wgmma_ss_n64<1, 1>(acc, smem_desc(dir ? so : sp, Q * ROW / 16, 64),
                           smem_desc(dir ? sp : so, Q * ROW / 16, 64), 1);
      }
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    __syncthreads();   // stage s and the parts are read
    if (has_s0 && dir && c == 0) {   // past chunk 0: s0's gradient, fp32
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = warp * 16 + g + 8 * r, n = nbx * BOX + nb * 8 + 2 * t4;
          if (!W::PADDED || (p < pw && n < nw))   // n even, nw a multiple of 8
            *reinterpret_cast<float2*>(ext.ds0 + ((size_t)bh * pw + p) * nw + n) =
                make_float2(acc[4 * nb + 2 * r], acc[4 * nb + 2 * r + 1]);
        }
    } else {
      store(dir ? c - 1 : c + 1);
    }
    if (tid == 0 && t + 2 < steps) load(t + 2);
  }
  if (tid == 0) bulk_wait();
}

template <bool X>
__global__ void __launch_bounds__(128, 4)
    ssd_bwd_states(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_c,
                   const __grid_constant__ CUtensorMap tm_dy, StParams prm, SsdExt ext) {
  ssd_bwd_states_body<X>(tm_x, tm_b, tm_c, tm_dy, prm, ext, FixedWidths<P, N>{});
}

// the padded route: the real (P, N) wd (W = Widths) inside (64, 128), the
// X code; a template, so that only the source that launches it builds it
template <class W>
__global__ void __launch_bounds__(128, 4)
    ssd_bwd_states_pad(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_b,
                       const __grid_constant__ CUtensorMap tm_c,
                       const __grid_constant__ CUtensorMap tm_dy, StParams prm, SsdExt ext,
                       W wd) {
  ssd_bwd_states_body<true>(tm_x, tm_b, tm_c, tm_dy, prm, ext, wd);
}

// ---- 3. every chunk's gradients ---------------------------------------------
struct ChParams {
  const float* vec;
  const __nv_bfloat16* st;
  const __nv_bfloat16* ds;
  const void* a;            // (H,)
  __nv_bfloat16* dx;        // (B, L, H, P), contiguous
  __nv_bfloat16* ddt;       // (B, L, H), contiguous
  float* da_part;           // (B, nc, H)
  float* db_part;           // (B, L, ng, N): dB's share of each head group
  float* dc_part;           // (B, L, ng, N)
  int L, H, nc, hg, ng;
};

// one head's per-step sums, for the warp that finishes the head
struct Res {
  float rowq[4][Q];   // sum_j W_ij dY_ij, a share per warp of warpgroup 0
  float colq[Q];      // sum_i W_ij dY_ij
  float xdu[Q];       // x_j . du_j
  float rdot[Q];      // e^{cs_i} C_i . (dy_i S)
  float tdot[Q];      // e^{cs_last - cs_j} dt_j B_j . (x_j dS')
  float sdot[4];      // <dS', S>, a share per warp of warpgroup 1
};

// C and B (two boxes each); two stages of a head's x, dy, S (hi, lo boxes)
// and dS'; V^T's hi and lo parts; two stages of per-step vectors and Res;
// three barriers
constexpr size_t CH_BYTES = 1024 + 26 * TILE + 2 * VEC * 4 + 2 * sizeof(Res) + 3 * 8;
static_assert(CH_BYTES <= 232448, "over the shared memory of an SM");

constexpr int BAR_HEAD = 1, BAR_V = 2, BAR_WG0 = 3;   // named barriers

// The body at (P, N); wd: the real (P, N), where dx's stores stop on the
// padded route (dB and dC go to shares at N's width, which the launcher
// cuts to the real N)
template <typename TA, bool X, class W>
__device__ __forceinline__ void ssd_bwd_chunks_body(const CUtensorMap& tm_x,
                                                    const CUtensorMap& tm_b,
                                                    const CUtensorMap& tm_c,
                                                    const CUtensorMap& tm_dy,
                                                    const ChParams& prm, const SsdExt& ext,
                                                    const W& wd) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* sC = base;
  unsigned char* sB = base + 2 * TILE;
  unsigned char* sVt = base + 24 * TILE;   // V^T (rows j, columns i): hi, then lo
  float* sVec = reinterpret_cast<float*>(base + 26 * TILE);
  Res* res = reinterpret_cast<Res*>(sVec + 2 * VEC);
  uint64_t* bars = reinterpret_cast<uint64_t*>(res + 2);   // C and B; stage 0; stage 1
  // stage s: x, dy, S (hi boxes, lo boxes), dS' (likewise)
  auto stage = [&](int s) { return base + 4 * TILE + s * 10 * TILE; };

  const int tid = threadIdx.x, wg = tid >> 7, ltid = tid & 127;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int L = prm.L, H = prm.H, nc = prm.nc, ng = prm.ng;
  const int gi = blockIdx.x % ng, c = (blockIdx.x / ng) % nc, bi = blockIdx.x / (ng * nc);
  // X: the ng blocks of a (b, chunk) are each B/C group's blocks in turn,
  // a group's last block short where hg does not divide its heads
  int grp = 0, h0, nh;
  if constexpr (X) {
    const int bpg = ng / (H / ext.hpg);   // blocks a group
    grp = gi / bpg;
    h0 = grp * ext.hpg + (gi % bpg) * prm.hg;
    nh = min(prm.hg, (grp + 1) * ext.hpg - h0);
  } else {
    h0 = gi * prm.hg;
    nh = min(prm.hg, H - h0);
  }
  const int l0 = c * Q;
  // the state entering the chunk is zero in chunk 0 unless s0 is given
  const bool carried = c > 0 || (X && ext.s0 != nullptr);
  const int r0 = warp * 16 + g;   // this thread's accumulator rows r0 and r0 + 8

  auto load_head = [&](int k) {
    const int s = k & 1, h = h0 + k;
    const size_t item = ((size_t)bi * H + h) * nc + c;
    unsigned char* st = stage(s);
    uint64_t* bar = bars + 1 + s;
    mbar_expect_tx(bar, 2 * TILE + (carried ? BLOB : 0) + BLOB + VEC * 4);
    tma_load(st, &tm_x, bar, 0, h, l0, bi);
    tma_load(st + TILE, &tm_dy, bar, 0, h, l0, bi);
    const unsigned char* bs = reinterpret_cast<const unsigned char*>(prm.st) + item * BLOB;
    const unsigned char* bd = reinterpret_cast<const unsigned char*>(prm.ds) + item * BLOB;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (carried) bulk_load(st + (2 + q) * TILE, bs + q * TILE, TILE, bar);
      bulk_load(st + (6 + q) * TILE, bd + q * TILE, TILE, bar);
    }
    bulk_load(sVec + s * VEC, prm.vec + item * VEC, VEC * 4, bar);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars, 4 * TILE);
#pragma unroll
    for (int q = 0; q < NBX; ++q) {
      tma_load(sC + q * TILE, &tm_c, bars, q * BOX, grp, l0, bi);
      tma_load(sB + q * TILE, &tm_b, bars, q * BOX, grp, l0, bi);
    }
    load_head(0);
    if (nh > 1) load_head(1);
  }
  mbar_wait(bars, 0);

  if (wg == 0) {
    // ---- warpgroup 0: du, dx, W^T, V^T and dC += V B ----------------------
    float gt[32];   // G^T = B C^T (rows j, columns i), for every head of the group
    qk_product<N, Q, Q, 32>(gt, smem_u32(sB), smem_u32(sC));
    float acc_dc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_dc[i] = 0.f;
    for (int k = 0; k < nh; ++k) {
      const int s = k & 1, h = h0 + k;
      unsigned char* sX = stage(s);
      unsigned char* sDY = sX + TILE;
      unsigned char* sDS = sX + 6 * TILE;
      const float* ch = sVec + s * VEC;
      const float* cl = ch + Q;
      const float* dts = cl + Q;
      Res& rs = res[s];
      mbar_wait(bars + 1 + s, (k >> 1) & 1);
      // du = B dS'^T (hi, lo) and dY^T = x dy^T, both in flight at once
      float du[32], yt[32];
      qk_product<N, Q, P, 32, false>(du, smem_u32(sB), smem_u32(sDS));
      qk_product<N, Q, P, 32, false>(du, smem_u32(sB), smem_u32(sDS + NBX * TILE), true);
      qk_product<P, Q, Q, 32>(yt, smem_u32(sX), smem_u32(sDY));
      pin(du);
      const float chL = ch[Q - 1], clL = cl[Q - 1];
      float cj[2], lj[2], dj[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = r0 + 8 * r;
        cj[r] = ch[j];
        lj[r] = cl[j];
        dj[r] = dts[j];
        const float wj = ex2((chL - cj[r]) + (clL - lj[r]));   // e^{cs_last - cs_j}
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          du[4 * nb + 2 * r] *= wj;
          du[4 * nb + 2 * r + 1] *= wj;
        }
      }
      // W^T and V^T on i >= j (masked before the exp), and W dY's sums: the
      // row sums (over i) in csum, each column's (over j) reduced over the
      // warp's 16 rows and written per warp
      uint32_t wh[4][4], wl[4][4];
      float csum[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int i = nb * 8 + 2 * t4;
        float wv[4] = {0.f, 0.f, 0.f, 0.f}, vv[4] = {0.f, 0.f, 0.f, 0.f};
        float rsum[2] = {0.f, 0.f};
        if (nb * 8 + 7 >= warp * 16) {   // warp-uniform: a block wholly below i >= j is zero
          const float2 ih = *reinterpret_cast<const float2*>(ch + i);
          const float2 il = *reinterpret_cast<const float2*>(cl + i);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, ii = i + (e & 1);
            if (ii >= r0 + 8 * r) {
              const float ed = ex2(((e & 1 ? ih.y : ih.x) - cj[r]) + ((e & 1 ? il.y : il.x) - lj[r]));
              const float dyv = yt[4 * nb + e] * dj[r];
              wv[e] = gt[4 * nb + e] * ed;
              vv[e] = dyv * ed;
              const float q = wv[e] * dyv;
              csum[r] += q;
              rsum[e & 1] += q;
            }
          }
        }
        split_bf16(wv[0], wv[1], wh[nb / 2][(nb % 2) * 2 + 0], wl[nb / 2][(nb % 2) * 2 + 0]);
        split_bf16(wv[2], wv[3], wh[nb / 2][(nb % 2) * 2 + 1], wl[nb / 2][(nb % 2) * 2 + 1]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t off = swz(r0 + 8 * r, i);
          split_bf16(vv[2 * r], vv[2 * r + 1], *reinterpret_cast<uint32_t*>(sVt + off),
                     *reinterpret_cast<uint32_t*>(sVt + TILE + off));
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = rsum[e];
          v += __shfl_xor_sync(FULL, v, 4);
          v += __shfl_xor_sync(FULL, v, 8);
          v += __shfl_xor_sync(FULL, v, 16);
          if (g == 0) rs.rowq[warp][i + e] = v;
        }
      }
      fence_proxy_async();
      named_sync(BAR_WG0, 128);     // V^T is whole for warpgroup 0 ...
      named_arrive(BAR_V, 256);     // ... and warpgroup 1 may read it
      // du += W^T dy (hi, lo), the A fragments from registers
      pv_product<P, Q, false>(du, wh, smem_u32(sDY));
      pv_product<P, Q, false>(du, wl, smem_u32(sDY));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        csum[r] += __shfl_xor_sync(FULL, csum[r], 1);
        csum[r] += __shfl_xor_sync(FULL, csum[r], 2);
        if (t4 == 0) rs.colq[r0 + 8 * r] = csum[r];
      }
      wgmma_wait_all();
      pin(du);
      // dC += V B: V read MN-major from V^T (its rows j are the depth), B
      // MN-major; in flight while dx is written
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < Q / 16; ++kk)
          wgmma_ss_n128<1, 1>(acc_dc,
                              smem_desc(smem_u32(sVt + part * TILE) + kk * 16 * ROW, Q * ROW / 16, 64),
                              smem_desc(smem_u32(sB) + kk * 16 * ROW, Q * ROW / 16, 64), 1);
      wgmma_commit();
      // dx = dt_j du_j, and x_j . du_j
      float xd[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = r0 + 8 * r, l = l0 + j;
        __nv_bfloat16* dxr = prm.dx + (((size_t)bi * L + l) * H + h) * wd.w0();
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int p = nb * 8 + 2 * t4;
          const float2 xv = ld_bf2(sX + swz(j, p));
          const float u0 = du[4 * nb + 2 * r], u1 = du[4 * nb + 2 * r + 1];
          xd[r] += xv.x * u0 + xv.y * u1;
          if (l < L && (!W::PADDED || p < wd.w0()))   // p even, the real P a multiple of 8
            *reinterpret_cast<__nv_bfloat162*>(dxr + p) = __floats2bfloat162_rn(dj[r] * u0, dj[r] * u1);
        }
        xd[r] += __shfl_xor_sync(FULL, xd[r], 1);
        xd[r] += __shfl_xor_sync(FULL, xd[r], 2);
        if (t4 == 0) rs.xdu[j] = xd[r];
      }
      wgmma_wait_all();
      pin(acc_dc);
      named_sync(BAR_HEAD, 256);   // the head is done: its stage may be refilled
      if (tid == 0 && k + 2 < nh) load_head(k + 2);
    }
    // dC = this share + warpgroup 1's carried share, handed over in stage 0
    named_sync(BAR_HEAD, 256);
    const float* part = reinterpret_cast<const float*>(stage(0));
#pragma unroll
    for (int e = 0; e < 64; ++e) acc_dc[e] += part[e * 128 + ltid];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int l = l0 + r0 + 8 * r;
      if (l >= L) continue;
      float* row = prm.dc_part + ((size_t)bi * L + l) * ng * N + (size_t)gi * N;
#pragma unroll
      for (int nb = 0; nb < 16; ++nb)
        *reinterpret_cast<float2*>(row + nb * 8 + 2 * t4) =
            make_float2(acc_dc[4 * nb + 2 * r], acc_dc[4 * nb + 2 * r + 1]);
    }
  } else {
    // ---- warpgroup 1: the carried shares, dB += V^T C, <dS', S>; its last
    //      warp finishes each head ------------------------------------------
    float acc_db[64], acc_dcc[64], tmp[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_db[i] = acc_dcc[i] = 0.f;
    for (int k = 0; k < nh; ++k) {
      const int s = k & 1, h = h0 + k;
      unsigned char* sX = stage(s);
      unsigned char* sDY = sX + TILE;
      unsigned char* sS = sX + 2 * TILE;
      unsigned char* sDS = sX + 6 * TILE;
      const float* ch = sVec + s * VEC;
      const float* cl = ch + Q;
      const float* dts = cl + Q;
      Res& rs = res[s];
      mbar_wait(bars + 1 + s, (k >> 1) & 1);
      const float chL = ch[Q - 1], clL = cl[Q - 1], keep = ex2(chL + clL);
      float ein[2], wdt[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        ein[r] = ex2(ch[row] + cl[row]);
        wdt[r] = ex2((chL - ch[row]) + (clL - cl[row])) * dts[row];
      }
      float rp[2] = {0.f, 0.f}, tp[2] = {0.f, 0.f}, sd = 0.f;
      if (carried) {
        // <dS', S> over hi + lo, 16 bytes of each part a step; both blobs
        // share one layout
        for (int e = ltid; e < NBX * TILE / 16; e += 128) {
          const uint4 sh = *reinterpret_cast<const uint4*>(sS + e * 16);
          const uint4 sl = *reinterpret_cast<const uint4*>(sS + NBX * TILE + e * 16);
          const uint4 dh = *reinterpret_cast<const uint4*>(sDS + e * 16);
          const uint4 dl = *reinterpret_cast<const uint4*>(sDS + NBX * TILE + e * 16);
          const unsigned char *a0 = reinterpret_cast<const unsigned char*>(&sh),
                              *a1 = reinterpret_cast<const unsigned char*>(&sl),
                              *b0 = reinterpret_cast<const unsigned char*>(&dh),
                              *b1 = reinterpret_cast<const unsigned char*>(&dl);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 x0 = ld_bf2(a0 + 4 * q), x1 = ld_bf2(a1 + 4 * q);
            const float2 y0 = ld_bf2(b0 + 4 * q), y1 = ld_bf2(b1 + 4 * q);
            sd += (x0.x + x1.x) * (y0.x + y1.x) + (x0.y + x1.y) * (y0.y + y1.y);
          }
        }
        // dC's carried share e^{cs_i} dy S, a 64-column half at a time: dy
        // K-major, S MN-major (hi, lo); C . (dy S) per step
#pragma unroll
        for (int hb = 0; hb < NBX; ++hb) {
          wgmma_fence();
#pragma unroll
          for (int part = 0; part < 2; ++part)
#pragma unroll
            for (int kk = 0; kk < P / 16; ++kk)
              wgmma_ss_n64<0, 1>(tmp, smem_desc(smem_u32(sDY) + kk * 32, 1, 64),
                                 smem_desc(smem_u32(sS + (part * NBX + hb) * TILE) + kk * 16 * ROW,
                                           P * ROW / 16, 64),
                                 part | kk);
          wgmma_commit();
          wgmma_wait_all();
          pin(tmp);
#pragma unroll
          for (int nb = 0; nb < 8; ++nb)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float2 cv = ld_bf2(sC + hb * TILE + swz(r0 + 8 * r, nb * 8 + 2 * t4));
              const float v0 = tmp[4 * nb + 2 * r], v1 = tmp[4 * nb + 2 * r + 1];
              rp[r] += cv.x * v0 + cv.y * v1;
              acc_dcc[4 * (nb + 8 * hb) + 2 * r] += ein[r] * v0;
              acc_dcc[4 * (nb + 8 * hb) + 2 * r + 1] += ein[r] * v1;
            }
        }
      }
      // dB's carried share e^{cs_last - cs_j} dt_j x dS', a half at a time,
      // and B . (x dS') per step
#pragma unroll
      for (int hb = 0; hb < NBX; ++hb) {
        wgmma_fence();
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int kk = 0; kk < P / 16; ++kk)
            wgmma_ss_n64<0, 1>(tmp, smem_desc(smem_u32(sX) + kk * 32, 1, 64),
                               smem_desc(smem_u32(sDS + (part * NBX + hb) * TILE) + kk * 16 * ROW,
                                         P * ROW / 16, 64),
                               part | kk);
        wgmma_commit();
        wgmma_wait_all();
        pin(tmp);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 bv = ld_bf2(sB + hb * TILE + swz(r0 + 8 * r, nb * 8 + 2 * t4));
            const float v0 = tmp[4 * nb + 2 * r], v1 = tmp[4 * nb + 2 * r + 1];
            tp[r] += bv.x * v0 + bv.y * v1;
            acc_db[4 * (nb + 8 * hb) + 2 * r] += wdt[r] * v0;
            acc_db[4 * (nb + 8 * hb) + 2 * r + 1] += wdt[r] * v1;
          }
      }
      // dB += V^T C once warpgroup 0 has written V^T: V^T K-major, C MN-major
      named_sync(BAR_V, 256);
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < Q / 16; ++kk)
          wgmma_ss_n128<0, 1>(acc_db, smem_desc(smem_u32(sVt + part * TILE) + kk * 32, 1, 64),
                              smem_desc(smem_u32(sC) + kk * 16 * ROW, Q * ROW / 16, 64), 1);
      wgmma_commit();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rp[r] += __shfl_xor_sync(FULL, rp[r], 1);
        rp[r] += __shfl_xor_sync(FULL, rp[r], 2);
        tp[r] += __shfl_xor_sync(FULL, tp[r], 1);
        tp[r] += __shfl_xor_sync(FULL, tp[r], 2);
        if (t4 == 0) {
          rs.rdot[r0 + 8 * r] = ein[r] * rp[r];
          rs.tdot[r0 + 8 * r] = wdt[r] * tp[r];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sd += __shfl_xor_sync(FULL, sd, off);
      if (lane == 0) rs.sdot[warp] = carried ? sd : 0.f;
      // the finishing warp keeps this head's dt (the stage is refilled after
      // the barrier)
      float fdt[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) fdt[q] = dts[2 * lane + q];
      wgmma_wait_all();
      pin(acc_db);
      named_sync(BAR_HEAD, 256);
      if (warp == 3) {
        // dcs per step, dda its in-chunk reverse sum (fp64 warp scan), ddt
        // and the head's share of da
        const float av = to_f(static_cast<const TA*>(prm.a)[h]);
        double dcs[2], ts = 0.0;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int kq = 2 * lane + q;
          const float rq = rs.rowq[0][kq] + rs.rowq[1][kq] + rs.rowq[2][kq] + rs.rowq[3][kq];
          dcs[q] = (double)rq - rs.colq[kq] + rs.rdot[kq] - rs.tdot[kq];
          ts += rs.tdot[kq];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ts += __shfl_xor_sync(FULL, ts, off);
        if (lane == 31)
          dcs[1] += ts + (double)keep * ((rs.sdot[0] + rs.sdot[1]) + (rs.sdot[2] + rs.sdot[3]));
        const double s0 = dcs[0] + dcs[1];
        double incl = s0;   // sum over this lane's steps and every later lane's
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double o = __shfl_down_sync(FULL, incl, off);
          if (lane + off < 32) incl += o;
        }
        const double after = incl - s0;
        const double dda[2] = {s0 + after, dcs[1] + after};
        double dap = 0.0;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int kq = 2 * lane + q, l = l0 + kq;
          if (l < L)
            prm.ddt[((size_t)bi * L + l) * H + h] = __float2bfloat16((float)(rs.xdu[kq] + av * dda[q]));
          dap += (double)fdt[q] * dda[q];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) dap += __shfl_xor_sync(FULL, dap, off);
        if (lane == 0) prm.da_part[((size_t)bi * nc + c) * H + h] = (float)dap;
      }
    }
    // dB out; dC's carried share to warpgroup 0 through stage 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int l = l0 + r0 + 8 * r;
      if (l >= L) continue;
      float* row = prm.db_part + ((size_t)bi * L + l) * ng * N + (size_t)gi * N;
#pragma unroll
      for (int nb = 0; nb < 16; ++nb)
        *reinterpret_cast<float2*>(row + nb * 8 + 2 * t4) =
            make_float2(acc_db[4 * nb + 2 * r], acc_db[4 * nb + 2 * r + 1]);
    }
    float* part = reinterpret_cast<float*>(stage(0));
#pragma unroll
    for (int e = 0; e < 64; ++e) part[e * 128 + ltid] = acc_dcc[e];
    named_sync(BAR_HEAD, 256);
  }
}

template <typename TA, bool X>
__global__ void __launch_bounds__(256, 1)
    ssd_bwd_chunks(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_c,
                   const __grid_constant__ CUtensorMap tm_dy, ChParams prm, SsdExt ext) {
  ssd_bwd_chunks_body<TA, X>(tm_x, tm_b, tm_c, tm_dy, prm, ext, FixedWidths<P, N>{});
}

// the padded route: the real (P, N) wd inside (64, 128), the X code
template <typename TA>
__global__ void __launch_bounds__(256, 1)
    ssd_bwd_chunks_pad(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_b,
                       const __grid_constant__ CUtensorMap tm_c,
                       const __grid_constant__ CUtensorMap tm_dy, ChParams prm, SsdExt ext,
                       Widths wd) {
  ssd_bwd_chunks_body<TA, true>(tm_x, tm_b, tm_c, tm_dy, prm, ext, wd);
}
}  // namespace tc

}  // namespace
