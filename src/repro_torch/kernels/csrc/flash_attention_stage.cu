// The staged route's copies (kernels/flash_attention.py:route, kind
// "stage"): bf16 and fp16 flash attention at head dims that are not
// multiples of 8.
//
// Replaces no TPU kernel on its own: it is the part of the staged route
// that lets src/repro/kernels/flash_attention.py:flash_attention_bh's
// Hopper port, the wgmma + TMA kernels of csrc/flash_attention_pad.cu,
// csrc/flash_attention_f16.cu, csrc/flash_attention_fwd_ws.cu,
// csrc/flash_attention_bwd_pad.cu and csrc/flash_attention_bwd_f16.cu, take
// such head dims.  Those kernels need a row pitch of a multiple of 16 bytes
// (TMA's stride rule) and store O, dQ, dK and dV as aligned pairs.  Zero
// columns are exact in every product of attention, so the launcher copies
// Q, K and V (and in the backward O and dO) into buffers whose rows are
// the real head dim rounded up to a multiple of 8, the columns past it
// zero; the kernels run at those pitches with the real dim's scale; and the
// outputs come back at the real dims.  This kernel makes those copies,
// every tensor of one direction in one launch: row by row from a source of
// `ws` elements a row into a destination of `wd`, the columns of the
// destination past `ws` written as zeros.
//
// What bounds it: bytes (each element read once and written once, nothing
// computed).  Each thread writes one 16-byte chunk of 8 destination
// elements: one vector store where the destination is a pitched buffer,
// single stores where it is an output at an odd width; a chunk read from
// a pitched buffer is one vector load.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_JOBS = 5;    // the backward's q, k, v, o and dO
constexpr int THREADS = 256;

struct Job {
  const uint16_t* src;
  uint16_t* dst;
  unsigned int chunks;   // 8-element chunks of the destination: rows * ceil(wd / 8)
  int ws, wd;            // elements a row of src and of dst
};

struct Jobs {
  Job j[MAX_JOBS];
};

// grid (x, jobs): job blockIdx.y, its chunks strided over the x blocks
__global__ void __launch_bounds__(THREADS) flash_stage(const Jobs jobs) {
  Job jb = jobs.j[0];
#pragma unroll
  for (int i = 1; i < MAX_JOBS; ++i)   // static indices: the parameters stay in constant space
    if ((int)blockIdx.y == i) jb = jobs.j[i];
  const unsigned int per_row = (jb.wd + 7) / 8;
  const bool vec_in = jb.ws % 8 == 0, vec_out = jb.wd % 8 == 0;
  for (unsigned int c = blockIdx.x * THREADS + threadIdx.x; c < jb.chunks;
       c += gridDim.x * THREADS) {
    const unsigned int row = c / per_row;
    const int col0 = (int)(c - row * per_row) * 8;
    const uint16_t* s = jb.src + (size_t)row * jb.ws + col0;
    uint16_t* d = jb.dst + (size_t)row * jb.wd + col0;
    alignas(16) uint16_t v[8];
    if (vec_in && col0 + 8 <= jb.ws) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = col0 + e < jb.ws ? s[e] : (uint16_t)0;
    }
    if (vec_out) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (col0 + e < jb.wd) d[e] = v[e];
    }
  }
}

}  // namespace

// jobs: n (1 to 5) groups of five values (src, dst, rows, ws, wd): src a
// contiguous (rows, ws) tensor of 2-byte elements (bf16 or fp16), dst a
// contiguous (rows, wd) one; a row of dst gets the first min(ws, wd)
// elements of src's row and zeros past ws.  A side whose width is a
// multiple of 8 must be 16-byte aligned.  Launches one kernel on `stream`;
// returns cudaGetLastError() after it, or cudaErrorInvalidValue for a job
// it does not take (2^31 chunks or more among them).
extern "C" int flash_attention_stage(const long long* jobs, int n, void* stream) {
  if (jobs == nullptr || n < 1 || n > MAX_JOBS) return (int)cudaErrorInvalidValue;
  Jobs js{};
  unsigned int most = 0;
  for (int i = 0; i < n; ++i) {
    const long long* j = jobs + 5 * i;
    const long long rows = j[2], ws = j[3], wd = j[4];
    const long long chunks = rows * ((wd + 7) / 8);
    if (j[0] == 0 || j[1] == 0 || rows < 1 || ws < 1 || wd < 1 || chunks >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    if ((ws % 8 == 0 && j[0] % 16) || (wd % 8 == 0 && j[1] % 16))
      return (int)cudaErrorInvalidValue;
    js.j[i] = Job{reinterpret_cast<const uint16_t*>(j[0]), reinterpret_cast<uint16_t*>(j[1]),
                  (unsigned int)chunks, (int)ws, (int)wd};
    if ((unsigned int)chunks > most) most = (unsigned int)chunks;
  }
  // enough blocks for every chunk of the largest job, at most 16 an SM's worth
  const unsigned int blocks = (most + THREADS - 1) / THREADS;
  const dim3 grid(blocks < 132u * 16u ? blocks : 132u * 16u, n);
  flash_stage<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(js);
  return (int)cudaGetLastError();
}
