// Fused compression-window encode for Hopper (sm_90a): the reference-exact per-step
// accumulate of one compressed output stream over one window of sampled steps.
//
// Replaces the TPU window kernels of kwave_tpu/ops/encode_pallas.py:
//   w40_window<true>     <- _w40_kernel               (40-bit, overlap)
//   w40_window<false>    <- _w40_noov_kernel          (40-bit, no overlap)
//   wfloat_window<true>  <- _wfloat_exact_kernel      (float, overlap)
//   wfloat_window<false> <- _wfloat_exact_noov_kernel (float, no overlap)
//
// Layout (kwave_tpu.encoder conventions): samples chunk [steps, N] with sensors N fastest;
// stacked basis table tabs [2o, 4H] = [bE_re | bE_im | bE1_re | bE1_im] columns, time-major;
// coefficient planes [H, N]. The 40-bit planes are uint32 words (low 8/16/16 bits used).
//
// Design: one thread per (harmonic h, sensor n). Each block serves one harmonic
// (blockIdx.y) and a tile of sensors, so it stages only the 4 table columns of that
// harmonic over the window's parity half (steps x 4 floats) in shared memory. The
// accumulators stay in registers for all steps; the chunk is read once, coalesced along
// n. parity and mirror are kernel arguments, so one build serves every window; steps may
// be shorter than o (the trailing partial window, with mirror off). The ragged edge of N
// is masked, no padding.
//
// What bounds it on the H100: memory and launch latency. Per window it reads steps*N*4 B
// of samples and reads and writes each [H, N] plane once; the per-element arithmetic
// (a few dozen integer ops per 40-bit decode/encode) is far below the card's integer
// rate. The design therefore moves each byte once and keeps everything else on chip.
//
// Bit-exactness: the per-step arithmetic lives in encode_step.cuh (explicit
// round-to-nearest products and sums, no FMA contraction), shared with the whole-record
// kernels of encode_series.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_step.cuh"

namespace {

// Stage this block's harmonic columns of the parity half: tab[u*4 + k], k = t1r,t1i,t2r,t2i.
__device__ __forceinline__ void load_table(float* tab, const float* __restrict__ tabs,
                                           int steps, int o, int H, int h, int parity) {
  for (int j = threadIdx.x; j < 4 * steps; j += blockDim.x) {
    const int u = j >> 2, k = j & 3;
    tab[j] = tabs[(size_t)(parity * o + u) * (4 * H) + k * H + h];
  }
  __syncthreads();
}

template <bool OVERLAP>
__global__ void w40_window(const float* __restrict__ chunk, const float* __restrict__ tabs,
                           const uint32_t* __restrict__ h1_in,
                           const uint32_t* __restrict__ r1_in,
                           const uint32_t* __restrict__ i1_in,
                           const uint32_t* __restrict__ h2_in,
                           const uint32_t* __restrict__ r2_in,
                           const uint32_t* __restrict__ i2_in, uint32_t* __restrict__ h1_out,
                           uint32_t* __restrict__ r1_out, uint32_t* __restrict__ i1_out,
                           uint32_t* __restrict__ h2_out, uint32_t* __restrict__ r2_out,
                           uint32_t* __restrict__ i2_out, int steps, int o, int H, int N,
                           int e, int parity, int mirror) {
  extern __shared__ float tab[];
  const int h = blockIdx.y;
  load_table(tab, tabs, steps, o, H, h, parity);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t p = (size_t)h * N + n;

  uint32_t h1 = h1_in[p], r1 = r1_in[p], i1 = i1_in[p];
  uint32_t h2 = 0, r2 = 0, i2 = 0;
  if (OVERLAP) {
    h2 = h2_in[p];
    r2 = r2_in[p];
    i2 = i2_in[p];
  }
  // post-MAC float values of the last step: the mirror fixup encodes their sum
  float c1r = 0.f, c1i = 0.f, c2r = 0.f, c2i = 0.f;
  for (int u = 0; u < steps; ++u) {
    const float x = chunk[(size_t)u * N + n];
    const float t1r = tab[4 * u + 0], t1i = tab[4 * u + 1];
    const float t2r = tab[4 * u + 2], t2i = tab[4 * u + 3];
    step40<OVERLAP>(x, t1r, t1i, t2r, t2i, e, h1, r1, i1, h2, r2, i2, c1r, c1i, c2r, c2i);
  }
  if (OVERLAP && mirror) {
    // first frame: buf2 = encode(c2 + c1) at the saving step (IndexOutputStream.cpp:429-435)
    mirror40(c1r, c1i, c2r, c2i, e, h2, r2, i2);
  }
  h1_out[p] = h1;
  r1_out[p] = r1;
  i1_out[p] = i1;
  if (OVERLAP) {
    h2_out[p] = h2;
    r2_out[p] = r2;
    i2_out[p] = i2;
  }
}

template <bool OVERLAP>
__global__ void wfloat_window(const float* __restrict__ chunk, const float* __restrict__ tabs,
                              const float* __restrict__ a1r_in,
                              const float* __restrict__ a1i_in,
                              const float* __restrict__ a2r_in,
                              const float* __restrict__ a2i_in, float* __restrict__ a1r_out,
                              float* __restrict__ a1i_out, float* __restrict__ a2r_out,
                              float* __restrict__ a2i_out, int steps, int o, int H, int N,
                              int parity, int mirror) {
  extern __shared__ float tab[];
  const int h = blockIdx.y;
  load_table(tab, tabs, steps, o, H, h, parity);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t p = (size_t)h * N + n;

  float a1r = a1r_in[p], a1i = a1i_in[p];
  float a2r = 0.f, a2i = 0.f;
  if (OVERLAP) {
    a2r = a2r_in[p];
    a2i = a2i_in[p];
  }
  for (int u = 0; u < steps; ++u) {
    const float x = chunk[(size_t)u * N + n];
    const float t1r = tab[4 * u + 0], t1i = tab[4 * u + 1];
    const float t2r = tab[4 * u + 2], t2i = tab[4 * u + 3];
    stepf<OVERLAP>(x, t1r, t1i, t2r, t2i, a1r, a1i, a2r, a2i);
  }
  a1r_out[p] = a1r;
  a1i_out[p] = a1i;
  if (OVERLAP) {
    if (mirror) {  // first frame: a2 += a1 after the saving step
      a2r = __fadd_rn(a2r, a1r);
      a2i = __fadd_rn(a2i, a1i);
    }
    a2r_out[p] = a2r;
    a2i_out[p] = a2i;
  }
}

constexpr int kThreads = 256;

dim3 grid_for(int N, int H) { return dim3((N + kThreads - 1) / kThreads, H); }

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
int kw_encode_window_40b(const float* chunk, const float* tabs, const uint32_t* h1,
                         const uint32_t* r1, const uint32_t* i1, const uint32_t* h2,
                         const uint32_t* r2, const uint32_t* i2, uint32_t* h1_out,
                         uint32_t* r1_out, uint32_t* i1_out, uint32_t* h2_out,
                         uint32_t* r2_out, uint32_t* i2_out, int steps, int o, int H, int N,
                         int e, int parity, int mirror, int overlap, void* stream) {
  const size_t smem = (size_t)steps * 4 * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (overlap) {
    w40_window<true><<<grid_for(N, H), kThreads, smem, s>>>(
        chunk, tabs, h1, r1, i1, h2, r2, i2, h1_out, r1_out, i1_out, h2_out, r2_out, i2_out,
        steps, o, H, N, e, parity, mirror);
  } else {
    w40_window<false><<<grid_for(N, H), kThreads, smem, s>>>(
        chunk, tabs, h1, r1, i1, nullptr, nullptr, nullptr, h1_out, r1_out, i1_out, nullptr,
        nullptr, nullptr, steps, o, H, N, e, parity, mirror);
  }
  return (int)cudaGetLastError();
}

int kw_encode_window_float(const float* chunk, const float* tabs, const float* a1r,
                           const float* a1i, const float* a2r, const float* a2i,
                           float* a1r_out, float* a1i_out, float* a2r_out, float* a2i_out,
                           int steps, int o, int H, int N, int parity, int mirror, int overlap,
                           void* stream) {
  const size_t smem = (size_t)steps * 4 * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (overlap) {
    wfloat_window<true><<<grid_for(N, H), kThreads, smem, s>>>(
        chunk, tabs, a1r, a1i, a2r, a2i, a1r_out, a1i_out, a2r_out, a2i_out, steps, o, H, N,
        parity, mirror);
  } else {
    wfloat_window<false><<<grid_for(N, H), kThreads, smem, s>>>(
        chunk, tabs, a1r, a1i, nullptr, nullptr, a1r_out, a1i_out, nullptr, nullptr, steps, o,
        H, N, parity, mirror);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
