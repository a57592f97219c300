// Whole-record reference-exact encode for Hopper (sm_90a): every window of a recorded
// series in one launch, from fresh state, with the frames and the final accumulators out.
//
// Replaces the TPU whole-series kernels of kwave_tpu/ops/encode_pallas.py:
//   series40<true/false>  <- _series40_kernel (40-bit, overlap / no overlap)
//   seriesf<true/false>   <- _seriesf_kernel  (float, overlap / no overlap)
//
// Layout: series [T, N] float32 with sensors N fastest (only the first K*o steps are read);
// stacked basis table tabs [2o, 4H] = [bE_re | bE_im | bE1_re | bE1_im] columns;
// frames [K, H, N] per plane; final state planes [H, N] (post-emission). The 40-bit planes
// are uint32 words.
//
// Design: the TPU version walks a (sensor tile, window) grid in order and carries the
// accumulators in scratch memory from one grid step to the next. On this card a chain of
// K*o dependent steps per (harmonic, sensor) leaves it idle: H*N threads are too few, and
// each step waits for its own load. But the emitted buffer restarts from zero
// (encoder._emit), so every frame is a chain of its own: frame k (odd) is buffer 1 from
// zero over windows k-1 and k, frame k (even, >= 2) is buffer 2 from zero over windows k-1
// and k, frame 0 is buffer 2 over window 0 plus the mirror; without overlap frame k is the
// one accumulator over window k. So the record is split at window boundaries: one thread
// owns one (harmonic h, sensor n) over a chunk of G consecutive windows. It starts from
// zero accumulators; with overlap and a chunk that starts at window k0 > 0 it first
// recomputes, over window k0-1 alone, the buffer that is live at that boundary (buffer 1
// when k0 is odd, buffer 2 when k0 is even; the other one was just emitted and is zero);
// then it walks its windows as the window loop does and writes one frame element per
// window. The thread of the last chunk writes the final state planes. The two buffers of
// a step never read each other (encode_step.cuh), so the recomputed buffer has the bits
// the unsplit chain gives it.
//
// Geometry: blockIdx.x = sensor tile * H + h, blockIdx.y = chunk. Harmonics are separate
// threads, not a loop in one thread: H is a run-time value, the 40-bit state of one
// harmonic is already 8 registers, and with h fastest in blockIdx.x the H blocks that read
// the same samples run side by side, so all but the first find them in the L2 cache. Each
// block stages its harmonic's 4 table columns over both parities (2o x 4 floats) in shared
// memory; window k takes rows (k % 2)*o + u. The samples of a batch of steps are loaded
// before the first of them is used (o is a run-time value, so the compiler cannot unroll
// the window itself). The ragged edge of N is masked; all offsets are 64-bit.
//
// What bounds it on the H100: the float body moves (1 + 1/G) * T*N*4 B of samples and
// the frames once, little arithmetic: memory. The 40-bit body requantises each accumulator
// at every step, nearly all of it integer instructions (counted per step from the built
// library's SASS: PERF.md section 6, "issue"), and spends most of its time issuing them;
// the accumulators stay unpacked between steps and are packed once a window, when a frame
// is written. The per-step arithmetic is encode_step.cuh's, shared with encode_window.cu,
// so both give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_step.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBatch = 4;  // samples loaded ahead of their use

// Stage this block's harmonic columns over both parities: tab[r*4 + k], r in [0, 2o).
__device__ __forceinline__ void load_table2(float* tab, const float* __restrict__ tabs, int o,
                                            int H, int h) {
  for (int j = threadIdx.x; j < 8 * o; j += blockDim.x) {
    const int r = j >> 2, k = j & 3;
    tab[j] = tabs[(size_t)r * (4 * H) + k * H + h];
  }
  __syncthreads();
}

// 40-bit state of one thread: both buffers as the floats their words decode to (q*, see
// quant40), and the post-MAC floats of the last step (c*), which the words are packed from.
struct Acc40 {
  float q1r = 0.f, q1i = 0.f, q2r = 0.f, q2i = 0.f;
  float c1r = 0.f, c1i = 0.f, c2r = 0.f, c2i = 0.f;
};

struct AccF {
  float a1r = 0.f, a1i = 0.f, a2r = 0.f, a2i = 0.f;
};

// What a walk over one window updates: both buffers, the aliased one, or one buffer alone.
enum Walk { kBoth, kAliased, kFirst, kSecond };

template <Walk W>
__device__ __forceinline__ void step(float x, const float* t, int e, Acc40& a) {
  if (W == kAliased) {
    step40_aliased(x, t[0], t[1], t[2], t[3], e, a.q1r, a.q1i, a.c1r, a.c1i);
  } else {
    if (W != kSecond) step40_one(x, t[0], t[1], e, a.q1r, a.q1i, a.c1r, a.c1i);
    if (W != kFirst) step40_one(x, t[2], t[3], e, a.q2r, a.q2i, a.c2r, a.c2i);
  }
}

template <Walk W>
__device__ __forceinline__ void step(float x, const float* t, int, AccF& a) {
  if (W == kBoth) {
    stepf<true>(x, t[0], t[1], t[2], t[3], a.a1r, a.a1i, a.a2r, a.a2i);
  } else if (W == kAliased) {
    stepf<false>(x, t[0], t[1], t[2], t[3], a.a1r, a.a1i, a.a2r, a.a2i);
  } else if (W == kFirst) {
    stepf_one(x, t[0], t[1], a.a1r, a.a1i);
  } else {
    stepf_one(x, t[2], t[3], a.a2r, a.a2i);
  }
}

// The o steps of one window: x[u*N] against table rows t[4u .. 4u+3].
template <Walk W, typename Acc>
__device__ __forceinline__ void walk_window(const float* __restrict__ x, const float* t, int o,
                                            int N, int e, Acc& a) {
  int u = 0;
  for (; u + kBatch <= o; u += kBatch) {
    float xs[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) xs[b] = x[(size_t)(u + b) * N];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) step<W>(xs[b], t + 4 * (u + b), e, a);
  }
  for (; u < o; ++u) step<W>(x[(size_t)u * N], t + 4 * u, e, a);
}

// Zero accumulators, then the buffer that is live at the chunk's first boundary k0.
template <typename Acc>
__device__ __forceinline__ void recompute_live(const float* __restrict__ series,
                                               const float* tab, int k0, int o, int N, int n,
                                               int e, Acc& a) {
  if (k0 == 0) return;
  const float* x = series + (size_t)(k0 - 1) * o * N + n;
  const float* t = tab + 4 * o * ((k0 - 1) & 1);
  if (k0 & 1) {
    walk_window<kFirst>(x, t, o, N, e, a);
  } else {
    walk_window<kSecond>(x, t, o, N, e, a);
  }
}

template <bool OVERLAP>
__global__ void __launch_bounds__(kThreads)
series40(const float* __restrict__ series, const float* __restrict__ tabs,
         uint32_t* __restrict__ fh, uint32_t* __restrict__ fr, uint32_t* __restrict__ fi,
         uint32_t* __restrict__ h1_out, uint32_t* __restrict__ r1_out,
         uint32_t* __restrict__ i1_out, uint32_t* __restrict__ h2_out,
         uint32_t* __restrict__ r2_out, uint32_t* __restrict__ i2_out, int K, int o, int H,
         int N, int e, int G) {
  extern __shared__ float tab[];
  const int h = blockIdx.x % H;
  load_table2(tab, tabs, o, H, h);
  const int n = (blockIdx.x / H) * kThreads + threadIdx.x;
  if (n >= N) return;
  const int k0 = blockIdx.y * G;
  const int k1 = min(K, k0 + G);

  Acc40 a;
  if (OVERLAP) recompute_live(series, tab, k0, o, N, n, e, a);
  for (int k = k0; k < k1; ++k) {
    const float* x = series + (size_t)k * o * N + n;
    const float* t = tab + 4 * o * (k & 1);
    walk_window<OVERLAP ? kBoth : kAliased>(x, t, o, N, e, a);
    const size_t f = ((size_t)k * H + h) * N + n;
    uint32_t wh, wr, wi;
    if (OVERLAP && !(k & 1)) {  // even frame: buffer 2 is finished, and restarts from zero
      if (k == 0) a.c2r = __fadd_rn(a.c2r, a.c1r), a.c2i = __fadd_rn(a.c2i, a.c1i);  // mirror
      encode40(a.c2r, a.c2i, e, wh, wr, wi);
      a.q2r = a.q2i = 0.f;
    } else {  // odd frame, or the one accumulator without overlap: buffer 1
      encode40(a.c1r, a.c1i, e, wh, wr, wi);
      a.q1r = a.q1i = 0.f;
    }
    fh[f] = wh, fr[f] = wr, fi[f] = wi;
  }
  if (k1 == K) {
    // the last chunk holds the record's final state: zero words for the buffer that window
    // K - 1 emitted, the last step's floats packed for the one that lives on
    const size_t p = (size_t)h * N + n;
    uint32_t wh = 0, wr = 0, wi = 0;
    const bool first_lives = OVERLAP && !((K - 1) & 1);
    if (first_lives) encode40(a.c1r, a.c1i, e, wh, wr, wi);
    h1_out[p] = wh, r1_out[p] = wr, i1_out[p] = wi;
    if (OVERLAP) {
      wh = wr = wi = 0;
      if (!first_lives) encode40(a.c2r, a.c2i, e, wh, wr, wi);
      h2_out[p] = wh, r2_out[p] = wr, i2_out[p] = wi;
    }
  }
}

template <bool OVERLAP>
__global__ void __launch_bounds__(kThreads)
seriesf(const float* __restrict__ series, const float* __restrict__ tabs,
        float* __restrict__ f_re, float* __restrict__ f_im, float* __restrict__ a1r_out,
        float* __restrict__ a1i_out, float* __restrict__ a2r_out, float* __restrict__ a2i_out,
        int K, int o, int H, int N, int G) {
  extern __shared__ float tab[];
  const int h = blockIdx.x % H;
  load_table2(tab, tabs, o, H, h);
  const int n = (blockIdx.x / H) * kThreads + threadIdx.x;
  if (n >= N) return;
  const int k0 = blockIdx.y * G;
  const int k1 = min(K, k0 + G);

  AccF a;
  if (OVERLAP) recompute_live(series, tab, k0, o, N, n, 0, a);
  for (int k = k0; k < k1; ++k) {
    const float* x = series + (size_t)k * o * N + n;
    const float* t = tab + 4 * o * (k & 1);
    walk_window<OVERLAP ? kBoth : kAliased>(x, t, o, N, 0, a);
    const size_t f = ((size_t)k * H + h) * N + n;
    if (OVERLAP) {
      if (k == 0) {  // first frame: a2 += a1 after the saving step
        a.a2r = __fadd_rn(a.a2r, a.a1r);
        a.a2i = __fadd_rn(a.a2i, a.a1i);
      }
      if (k & 1) {
        f_re[f] = a.a1r, f_im[f] = a.a1i;
        a.a1r = a.a1i = 0.f;
      } else {
        f_re[f] = a.a2r, f_im[f] = a.a2i;
        a.a2r = a.a2i = 0.f;
      }
    } else {
      f_re[f] = a.a1r, f_im[f] = a.a1i;
      a.a1r = a.a1i = 0.f;
    }
  }
  if (k1 == K) {
    const size_t p = (size_t)h * N + n;
    a1r_out[p] = a.a1r, a1i_out[p] = a.a1i;
    if (OVERLAP) a2r_out[p] = a.a2r, a2i_out[p] = a.a2i;
  }
}

// False when the launch would not fit a grid: blockIdx.y holds at most 65535 chunks.
bool grid_for(int K, int H, int N, int G, dim3& grid) {
  if (K < 1 || H < 1 || N < 1 || G < 1) return false;
  const long long tiles = ((long long)N + kThreads - 1) / kThreads;
  const int chunks = (K + G - 1) / G;
  if (tiles * H > 2147483647LL || chunks > 65535) return false;
  grid = dim3((unsigned)(tiles * H), (unsigned)chunks);
  return true;
}

}  // namespace

extern "C" {

// Both return cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for a chunk size G that gives more chunks than a grid takes or an
// exponent offset e outside 0 .. kQuant40MaxE.
// Without overlap the second set of state planes is not written (the caller holds zeros
// there).
int kw_encode_series_40b(const float* series, const float* tabs, uint32_t* fh, uint32_t* fr,
                         uint32_t* fi, uint32_t* h1, uint32_t* r1, uint32_t* i1, uint32_t* h2,
                         uint32_t* r2, uint32_t* i2, int K, int o, int H, int N, int e,
                         int overlap, int G, void* stream) {
  dim3 grid;
  if (e < 0 || e > kQuant40MaxE || !grid_for(K, H, N, G, grid))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)o * 8 * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (overlap) {
    series40<true><<<grid, kThreads, smem, s>>>(series, tabs, fh, fr, fi, h1, r1, i1, h2, r2,
                                                i2, K, o, H, N, e, G);
  } else {
    series40<false><<<grid, kThreads, smem, s>>>(series, tabs, fh, fr, fi, h1, r1, i1, h2, r2,
                                                 i2, K, o, H, N, e, G);
  }
  return (int)cudaGetLastError();
}

int kw_encode_series_float(const float* series, const float* tabs, float* f_re, float* f_im,
                           float* a1r, float* a1i, float* a2r, float* a2i, int K, int o, int H,
                           int N, int overlap, int G, void* stream) {
  dim3 grid;
  if (!grid_for(K, H, N, G, grid)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)o * 8 * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (overlap) {
    seriesf<true><<<grid, kThreads, smem, s>>>(series, tabs, f_re, f_im, a1r, a1i, a2r, a2i, K,
                                               o, H, N, G);
  } else {
    seriesf<false><<<grid, kThreads, smem, s>>>(series, tabs, f_re, f_im, a1r, a1i, a2r, a2i,
                                                K, o, H, N, G);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
