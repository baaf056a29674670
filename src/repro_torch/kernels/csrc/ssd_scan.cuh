// The bf16 SSD forward kernel (wgmma + TMA), shared by csrc/ssd_scan.cu
// (mamba2's (P 64, N 128)) and csrc/ssd_scan_pad.cu (the padded route: P
// and N multiples of 8 inside them, ssd_fwd_bf16_pad).  The design notes
// are in csrc/ssd_scan.cu's header.
#pragma once

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int P = 64;         // head dim (mamba2-780m) of the bf16 wgmma kernel
constexpr int N = 128;        // its state dim
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// ---------------------------------------------------------------------------
// bf16: wgmma for the four products, TMA for the chunk's C, B and x
// ---------------------------------------------------------------------------
// Every operand that the kernel rounds to bf16 (the decay tile M, the
// state's copy for C . state, x scaled by its weights for the state
// update) is split into hi = bf16(v) and lo = bf16(v - hi), and each of
// those products runs twice, on hi and on lo: 16 bits of mantissa, so the
// products are as good as fp32 ones (one part alone fails a gate of
// chip_smoke.py: see the header).  C, B and x enter exactly.
//
// Shared memory at chunk Q: the chunk's C (Q x N), B (Q x N) and x (Q x P)
// as TMA writes them (64-column boxes of Q rows,
// 128-byte swizzle); xw's hi and lo parts (Q x P each); the state's hi and
// lo copies (P x N each, two boxes of P rows); y (Q x P) on its way out by
// TMA; then two sets (this chunk's, the next one's) of four per-step
// vectors and the full barriers.
template <int Q>
struct Tile {
  static constexpr int NWG = Q / 64;          // consumer warpgroups, 64 chunk rows each
  static constexpr int THREADS = 128 * NWG;
  static constexpr int NW = N / NWG;          // state columns a warpgroup carries
  static constexpr uint32_t CB_BYTES = Q * N * 2;   // C or B of one chunk
  static constexpr uint32_t X_BYTES = Q * P * 2;
  static constexpr uint32_t ST_BYTES = P * N * 2;   // one bf16 copy of the state
  static constexpr size_t BYTES = 1024 + 2 * CB_BYTES + 4 * X_BYTES + 2 * ST_BYTES +
                                  2 * Q * 4 * 4 + 8 * 2;   // 1024: alignment
  static constexpr int BLOCKS_PER_SM = 232448 / (BYTES + 1024) > 0 ? 232448 / (BYTES + 1024) : 1;
};

struct BfParams {
  const void* dt;     // (B, L, H), contiguous
  const void* a;      // (H,)
  void* y;            // (B, L, H, P), contiguous
  void* state;        // (B, H, P, N), contiguous
  int L, H;
};

// dt of steps l0 + j0 .. l0 + j0 + PER - 1; steps past L are 0
template <int PER>
__device__ __forceinline__ void load_dt(float (&dtv)[PER], const __nv_bfloat16* dtg, int l0,
                                        int j0, int L, int H) {
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int l = l0 + j0 + k;
    dtv[k] = l < L ? __bfloat162float(dtg[(size_t)l * H]) : 0.f;
  }
}

// warp 0: da = dt a over a chunk (dtv, PER steps a lane) and its cumsum
// in fp64, into one set of per-step vectors (see the kernel)
template <int Q>
__device__ __forceinline__ void scan_chunk(float* set, const float (&dtv)[Q / 32], float a,
                                           int lane) {
  constexpr int PER = Q / 32;
  constexpr double LOG2E = 1.4426950408889634;
  float* chh = set;
  float* chl = chh + Q;
  float* wout = chl + Q;
  float* dts = wout + Q;
  double v[PER];
  double run = 0.0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    run += (double)(dtv[k] * a);
    v[k] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += o;
  }
  const double total = __shfl_sync(FULL, incl, 31);
  const double excl = incl - run;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = lane * PER + k;
    const double c2 = (v[k] + excl) * LOG2E;
    const float hi = (float)c2;
    chh[j] = hi;
    chl[j] = (float)(c2 - (double)hi);
    wout[j] = __expf((float)(total - v[k] - excl)) * dtv[k];
    dts[j] = dtv[k];
  }
}

// The body at (P, N); wd: the real (P, N) (hopper.cuh: FixedWidths, or
// Widths on the padded route, where the initial state's loads and the
// final state's stores stop at them)
template <int Q, typename TA, bool X, class W>
__device__ __forceinline__ void ssd_fwd_bf16_body(const CUtensorMap& tm_x,
                                                  const CUtensorMap& tm_b,
                                                  const CUtensorMap& tm_c,
                                                  const CUtensorMap& tm_y, const BfParams& prm,
                                                  const SsdExt& ext, const W& wd) {
  using TL = Tile<Q>;
  constexpr int NWG = TL::NWG, NW = TL::NW, PER = Q / 32;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* sC = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sB = sC + TL::CB_BYTES;
  unsigned char* sX = sB + TL::CB_BYTES;
  unsigned char* sXhi = sX + TL::X_BYTES;
  unsigned char* sXlo = sXhi + TL::X_BYTES;
  unsigned char* sStHi = sXlo + TL::X_BYTES;
  unsigned char* sStLo = sStHi + TL::ST_BYTES;
  unsigned char* sY = sStLo + TL::ST_BYTES;   // 64 rows (8 KB) a warpgroup
  // per step j, two sets: the chunk's cumsum of da in base 2, cum_j
  // log2(e), as the float pair ch_j + cl_j (a difference of two is then
  // exact to fp32 in three adds); exp(cum_last - cum_j) dt_j, step j's
  // weight into the state; dt_j
  float* vec = reinterpret_cast<float*>(sY + TL::X_BYTES);
  uint64_t* full_c = reinterpret_cast<uint64_t*>(vec + 2 * 4 * Q);   // C has landed
  uint64_t* full_bx = full_c + 1;                                     // B and x have

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // accumulator row group / column pair
  const int L = prm.L, H = prm.H;
  const int bh = blockIdx.x, bi = bh / H, h = bh % H;
  const int nchunks = (L + Q - 1) / Q;
  const float a = ld(static_cast<const TA*>(prm.a) + h);
  const __nv_bfloat16* dtg = static_cast<const __nv_bfloat16*>(prm.dt) + (size_t)bi * L * H + h;
  // this thread's accumulator rows: chunk rows row0 and row0 + 8, and
  // state rows p0 and p0 + 8
  const int p0 = warp * 16 + g, row0 = wg * 64 + p0;
  // this head's B/C group, the tensor maps' group coordinate; X with an
  // initial state carries it into the first chunk too
  const int grp = X ? h / ext.hpg : 0;
  const bool has_s0 = X && ext.s0 != nullptr;

  auto load_c = [&](int ch) {   // chunk ch's C
    mbar_expect_tx(full_c, TL::CB_BYTES);
#pragma unroll
    for (int c = 0; c < N / BOX; ++c)
      tma_load(sC + c * Q * ROW, &tm_c, full_c, c * BOX, grp, ch * Q, bi);
  };
  auto load_bx = [&](int ch) {  // chunk ch's B and x
    mbar_expect_tx(full_bx, TL::CB_BYTES + TL::X_BYTES);
#pragma unroll
    for (int c = 0; c < N / BOX; ++c)
      tma_load(sB + c * Q * ROW, &tm_b, full_bx, c * BOX, grp, ch * Q, bi);
    tma_load(sX, &tm_x, full_bx, 0, h, ch * Q, bi);
  };

  if (tid == 0) {
    mbar_init(full_c, 1);
    mbar_init(full_bx, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_c(0);
    load_bx(0);
  }
  float dtv[PER];   // warp 0: a chunk's dt, PER steps a lane
  if (tid < 32) {
    load_dt<PER>(dtv, dtg, 0, lane * PER, L, H);
    scan_chunk<Q>(vec, dtv, a, lane);
    if (nchunks > 1) load_dt<PER>(dtv, dtg, Q, lane * PER, L, H);
  }
  __syncthreads();

  // the fp32 state, (P x NW) of it in each warpgroup: the accumulator of
  // the update, kept in registers from the first chunk to the last
  float state[NW / 2];
  // the state's hi and lo bf16 copies for C . state, written as TMA would
  // (K-major, 128-byte swizzle)
  auto write_copies = [&]() {
#pragma unroll
    for (int nb = 0; nb < NW / 8; ++nb) {
      const int n = wg * NW + nb * 8 + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pr = p0 + 8 * r;
        const uint32_t off = (n / BOX) * (P * ROW) + pr * ROW + (n % BOX) * 2;
        const uint32_t swz = off ^ ((pr & 7) << 4);
        split_bf16(state[4 * nb + 2 * r], state[4 * nb + 2 * r + 1],
                   *reinterpret_cast<uint32_t*>(sStHi + swz),
                   *reinterpret_cast<uint32_t*>(sStLo + swz));
      }
    }
    fence_proxy_async();
  };
  const int pw = wd.w0(), nw = wd.w1();   // the real (P, N)
  if (has_s0) {   // the initial state, and its copies for the first chunk
    const size_t s0b = (size_t)bh * pw * nw;
#pragma unroll
    for (int nb = 0; nb < NW / 8; ++nb) {
      const int n = wg * NW + nb * 8 + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int k = 0; k < 2; ++k)   // the padded route: 0 past the real (P, N)
          state[4 * nb + 2 * r + k] =
              !W::PADDED || (p0 + 8 * r < pw && n < nw)
                  ? ld_s0<__nv_bfloat16>(ext, s0b + (p0 + 8 * r) * nw + n + k)
                  : 0.f;
    }
    write_copies();
    __syncthreads();
  } else {
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) state[i] = 0.f;
  }

  for (int ch = 0; ch < nchunks; ++ch) {
    const uint32_t phase = ch & 1;   // of both full barriers: one load each a chunk
    const int l0 = ch * Q;

    float* chh = vec + (ch & 1) * 4 * Q;
    float* chl = chh + Q;
    float* wout = chl + Q;
    float* dts = wout + Q;
    const float c0h = chh[row0], c0l = chl[row0], c1h = chh[row0 + 8], c1l = chl[row0 + 8];
    mbar_wait(full_c, phase);

    // -- y = exp(cum_i) (C_i . state): the state's hi and lo copies ------
    float y[P / 2];
#pragma unroll
    for (int i = 0; i < P / 2; ++i) y[i] = 0.f;
    if (ch > 0 || has_s0) {   // the first chunk's carried state is zero unless given
      qk_product<N, Q, P>(y, smem_u32(sC) + wg * 64 * ROW, smem_u32(sStHi));
      qk_product<N, Q, P>(y, smem_u32(sC) + wg * 64 * ROW, smem_u32(sStLo), true);
      const float e0 = ex2(c0h + c0l), e1 = ex2(c1h + c1l);
#pragma unroll
      for (int nb = 0; nb < P / 8; ++nb) {
        y[4 * nb + 0] *= e0;
        y[4 * nb + 1] *= e0;
        y[4 * nb + 2] *= e1;
        y[4 * nb + 3] *= e1;
      }
    }

    // -- y += M x, 64 steps j at a time: S = C B^T on this warpgroup's
    //    rows, M = S exp(cum_i - cum_j) dt_j for j <= i, else 0 (masked
    //    before the exp); rows of warpgroup wg see steps j < (wg + 1) 64 ----
    mbar_wait(full_bx, phase);
#pragma unroll
    for (int hf = 0; hf < NWG; ++hf) {
      if (hf > wg) break;
      float sc[32];
      qk_product<N, Q, Q>(sc, smem_u32(sC) + wg * 64 * ROW, smem_u32(sB) + hf * 64 * ROW);
      uint32_t mh[4][4], ml[4][4];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        float m[4] = {0.f, 0.f, 0.f, 0.f};
        const int j = hf * 64 + nb * 8 + 2 * t4;
        if (hf * 64 + nb * 8 <= wg * 64 + warp * 16 + 15) {   // warp-uniform: past the diagonal is 0
          const float2 jh = *reinterpret_cast<const float2*>(chh + j);
          const float2 jl = *reinterpret_cast<const float2*>(chl + j);
          const float2 dj = *reinterpret_cast<const float2*>(dts + j);
          if (j <= row0) m[0] = sc[4 * nb] * ex2((c0h - jh.x) + (c0l - jl.x)) * dj.x;
          if (j + 1 <= row0) m[1] = sc[4 * nb + 1] * ex2((c0h - jh.y) + (c0l - jl.y)) * dj.y;
          if (j <= row0 + 8) m[2] = sc[4 * nb + 2] * ex2((c1h - jh.x) + (c1l - jl.x)) * dj.x;
          if (j + 1 <= row0 + 8) m[3] = sc[4 * nb + 3] * ex2((c1h - jh.y) + (c1l - jl.y)) * dj.y;
        }
        split_bf16(m[0], m[1], mh[nb / 2][(nb % 2) * 2 + 0], ml[nb / 2][(nb % 2) * 2 + 0]);
        split_bf16(m[2], m[3], mh[nb / 2][(nb % 2) * 2 + 1], ml[nb / 2][(nb % 2) * 2 + 1]);
      }
      pv_product<P, 64>(y, mh, smem_u32(sX) + hf * 64 * ROW);
      pv_product<P, 64>(y, ml, smem_u32(sX) + hf * 64 * ROW);
    }
    // -- y out: into this warpgroup's 64 rows of sY as TMA would write them
    //    (128-byte swizzle), then one TMA store, which skips rows past L --
    {
      const bool elected = (tid & 127) == 0;
      if (elected) bulk_wait_read();   // the previous chunk's store has read sY
      named_sync(1 + wg, 128);
      unsigned char* yw = sY + wg * 64 * ROW;
#pragma unroll
      for (int nb = 0; nb < P / 8; ++nb) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rr = p0 + 8 * r;   // the row within the warpgroup's 64
          const uint32_t off = rr * ROW + (nb * 8 + 2 * t4) * 2;
          *reinterpret_cast<uint32_t*>(yw + (off ^ ((rr & 7) << 4))) =
              pack_bf16(y[4 * nb + 2 * r], y[4 * nb + 2 * r + 1]);
        }
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if (elected) {
        tma_store(&tm_y, yw, 0, h, l0 + wg * 64, bi);
        bulk_commit();
      }
    }

    // -- warpgroup 0, whose rows see half the steps, meanwhile: xw_j =
    //    x_j exp(cum_last - cum_j) dt_j as hi and lo parts, 16 bytes a
    //    step.  The swizzle moves 16-byte pieces within a row only, so a
    //    piece's row is its offset over ROW. -----------------------------
    if (wg == 0) {
      for (int e = tid; e < Q * P / 8; e += 128) {
        const float w = wout[e * 16 / ROW];
        const uint4 v = *reinterpret_cast<const uint4*>(sX + e * 16);
        const uint32_t* u = reinterpret_cast<const uint32_t*>(&v);
        uint4 hi, lo;
        uint32_t* uh = reinterpret_cast<uint32_t*>(&hi);
        uint32_t* ul = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[k]));
          split_bf16(f.x * w, f.y * w, uh[k], ul[k]);
        }
        *reinterpret_cast<uint4*>(sXhi + e * 16) = hi;
        *reinterpret_cast<uint4*>(sXlo + e * 16) = lo;
      }
      fence_proxy_async();
      // the next chunk's per-step vectors, into the other set
      if (tid < 32 && ch + 1 < nchunks) {
        scan_chunk<Q>(vec + ((ch + 1) & 1) * 4 * Q, dtv, a, lane);
        if (ch + 2 < nchunks) load_dt<PER>(dtv, dtg, l0 + 2 * Q, lane * PER, L, H);
      }
    }
    __syncthreads();   // C, x and the state copies are read; xw and the next vectors written
    if (tid == 0 && ch + 1 < nchunks) load_c(ch + 1);

    // -- state = exp(cum_last) state + xw^T B: A is xw (hi, then lo) read
    //    MN-major, B this warpgroup's NW columns of B read MN-major ------
    {
      const float keep = ex2(chh[Q - 1] + chl[Q - 1]);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) state[i] *= keep;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2 * Q / 16; ++kk) {   // 16 steps (2048 bytes) a k-step
        const uint32_t xa = (kk < Q / 16 ? smem_u32(sXhi) : smem_u32(sXlo)) +
                            (kk % (Q / 16)) * 16 * ROW;
        const uint64_t da = smem_desc(xa, Q * ROW / 16, 64);
        const uint64_t db = smem_desc(smem_u32(sB) + wg * (NW / BOX) * Q * ROW +
                                      (kk % (Q / 16)) * 16 * ROW, Q * ROW / 16, 64);
        if constexpr (NW == 64) wgmma_ss_n64<1, 1>(state, da, db, 1);
        else wgmma_ss_n128<1, 1>(state, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(state);
    }
    // -- the state's hi and lo copies for the next chunk's C . state ----
    if (ch + 1 < nchunks) write_copies();
    __syncthreads();   // B and x are read, the state copies written
    if (tid == 0 && ch + 1 < nchunks) load_bx(ch + 1);
  }

  __nv_bfloat16* sg = static_cast<__nv_bfloat16*>(prm.state) + (size_t)bh * pw * nw;
#pragma unroll
  for (int nb = 0; nb < NW / 8; ++nb) {
    const int n = wg * NW + nb * 8 + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (!W::PADDED || (p0 + 8 * r < pw && n < nw))   // n even, nw a multiple of 8
        *reinterpret_cast<__nv_bfloat162*>(sg + (p0 + 8 * r) * nw + n) =
            __floats2bfloat162_rn(state[4 * nb + 2 * r], state[4 * nb + 2 * r + 1]);
  }
  if ((tid & 127) == 0) bulk_wait();
}

template <int Q, typename TA, bool X>
__global__ void __launch_bounds__(Tile<Q>::THREADS, Tile<Q>::BLOCKS_PER_SM)
    ssd_fwd_bf16(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_c,
                 const __grid_constant__ CUtensorMap tm_y, BfParams prm, SsdExt ext) {
  ssd_fwd_bf16_body<Q, TA, X>(tm_x, tm_b, tm_c, tm_y, prm, ext, FixedWidths<P, N>{});
}

// the padded route: the real (P, N) wd, multiples of 8 inside (64, 128);
// the tensor maps carry them, so TMA zero-fills x, B and C past them
// (zero state rows and columns, zero y columns) and clips y's stores.
// Always the X code: groups and an initial state as the call gives them
template <int Q, typename TA>
__global__ void __launch_bounds__(Tile<Q>::THREADS, Tile<Q>::BLOCKS_PER_SM)
    ssd_fwd_bf16_pad(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_b,
                     const __grid_constant__ CUtensorMap tm_c,
                     const __grid_constant__ CUtensorMap tm_y, BfParams prm, SsdExt ext,
                     Widths wd) {
  ssd_fwd_bf16_body<Q, TA, true>(tm_x, tm_b, tm_c, tm_y, prm, ext, wd);
}


}  // namespace
