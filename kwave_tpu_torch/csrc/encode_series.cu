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
// accumulators in scratch memory from one grid step to the next. Here one thread owns one
// (harmonic h, sensor n): it keeps its accumulators in registers across all K windows and
// o steps, and writes one frame element per window. A block serves one harmonic and a
// tile of sensors and stages that harmonic's 4 table columns over both parities
// (2o x 4 floats) in shared memory once. Window k takes table rows (k % 2)*o + u; the
// mirror fires after window 0; frame k is buffer 1 when (k + 1) is even, else buffer 2,
// and the emitted buffer restarts from zero (encoder._emit). The ragged edge of N is
// masked, no padding. All offsets are 64-bit (the series holds T*N elements).
//
// What bounds it on the H100: the series is read once (T*N*4 B) and each frame written
// once, so by bytes it is memory-bound, but only H*N threads exist and each carries a
// serial chain of K*o dependent steps: latency, not bandwidth, sets its time. The
// per-step arithmetic is encode_step.cuh's, shared with encode_window.cu, so both give the
// same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_step.cuh"

namespace {

// Stage this block's harmonic columns over both parities: tab[r*4 + k], r in [0, 2o).
__device__ __forceinline__ void load_table2(float* tab, const float* __restrict__ tabs, int o,
                                            int H, int h) {
  for (int j = threadIdx.x; j < 8 * o; j += blockDim.x) {
    const int r = j >> 2, k = j & 3;
    tab[j] = tabs[(size_t)r * (4 * H) + k * H + h];
  }
  __syncthreads();
}

template <bool OVERLAP>
__global__ void series40(const float* __restrict__ series, const float* __restrict__ tabs,
                         uint32_t* __restrict__ fh, uint32_t* __restrict__ fr,
                         uint32_t* __restrict__ fi, uint32_t* __restrict__ h1_out,
                         uint32_t* __restrict__ r1_out, uint32_t* __restrict__ i1_out,
                         uint32_t* __restrict__ h2_out, uint32_t* __restrict__ r2_out,
                         uint32_t* __restrict__ i2_out, int K, int o, int H, int N, int e) {
  extern __shared__ float tab[];
  const int h = blockIdx.y;
  load_table2(tab, tabs, o, H, h);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;

  uint32_t h1 = 0, r1 = 0, i1 = 0, h2 = 0, r2 = 0, i2 = 0;
  const float* x_ptr = series + n;
  for (int k = 0; k < K; ++k) {
    const float* t = tab + 4 * o * (k & 1);
    float c1r = 0.f, c1i = 0.f, c2r = 0.f, c2i = 0.f;
    for (int u = 0; u < o; ++u) {
      const float x = *x_ptr;
      x_ptr += N;
      step40<OVERLAP>(x, t[4 * u + 0], t[4 * u + 1], t[4 * u + 2], t[4 * u + 3], e, h1, r1,
                      i1, h2, r2, i2, c1r, c1i, c2r, c2i);
    }
    const size_t f = ((size_t)k * H + h) * N + n;
    if (OVERLAP) {
      if (k == 0) mirror40(c1r, c1i, c2r, c2i, e, h2, r2, i2);
      if ((k + 1) % 2 == 0) {  // odd frame: buffer 1 is finished
        fh[f] = h1, fr[f] = r1, fi[f] = i1;
        h1 = r1 = i1 = 0;
      } else {
        fh[f] = h2, fr[f] = r2, fi[f] = i2;
        h2 = r2 = i2 = 0;
      }
    } else {
      fh[f] = h1, fr[f] = r1, fi[f] = i1;
      h1 = r1 = i1 = 0;
    }
  }
  const size_t p = (size_t)h * N + n;
  h1_out[p] = h1, r1_out[p] = r1, i1_out[p] = i1;
  if (OVERLAP) h2_out[p] = h2, r2_out[p] = r2, i2_out[p] = i2;
}

template <bool OVERLAP>
__global__ void seriesf(const float* __restrict__ series, const float* __restrict__ tabs,
                        float* __restrict__ f_re, float* __restrict__ f_im,
                        float* __restrict__ a1r_out, float* __restrict__ a1i_out,
                        float* __restrict__ a2r_out, float* __restrict__ a2i_out, int K, int o,
                        int H, int N) {
  extern __shared__ float tab[];
  const int h = blockIdx.y;
  load_table2(tab, tabs, o, H, h);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;

  float a1r = 0.f, a1i = 0.f, a2r = 0.f, a2i = 0.f;
  const float* x_ptr = series + n;
  for (int k = 0; k < K; ++k) {
    const float* t = tab + 4 * o * (k & 1);
    for (int u = 0; u < o; ++u) {
      const float x = *x_ptr;
      x_ptr += N;
      stepf<OVERLAP>(x, t[4 * u + 0], t[4 * u + 1], t[4 * u + 2], t[4 * u + 3], a1r, a1i,
                     a2r, a2i);
    }
    const size_t f = ((size_t)k * H + h) * N + n;
    if (OVERLAP) {
      if (k == 0) {  // first frame: a2 += a1 after the saving step
        a2r = __fadd_rn(a2r, a1r);
        a2i = __fadd_rn(a2i, a1i);
      }
      if ((k + 1) % 2 == 0) {
        f_re[f] = a1r, f_im[f] = a1i;
        a1r = a1i = 0.f;
      } else {
        f_re[f] = a2r, f_im[f] = a2i;
        a2r = a2i = 0.f;
      }
    } else {
      f_re[f] = a1r, f_im[f] = a1i;
      a1r = a1i = 0.f;
    }
  }
  const size_t p = (size_t)h * N + n;
  a1r_out[p] = a1r, a1i_out[p] = a1i;
  if (OVERLAP) a2r_out[p] = a2r, a2i_out[p] = a2i;
}

// 128 threads: at H*N = 32768 chains this still gives every SM a block or two
constexpr int kThreads = 128;

dim3 grid_for(int N, int H) { return dim3((N + kThreads - 1) / kThreads, H); }

}  // namespace

extern "C" {

// Both return cudaGetLastError() after the launch (0 = cudaSuccess). Without overlap the
// second set of state planes is not written (the caller holds zeros there).
int kw_encode_series_40b(const float* series, const float* tabs, uint32_t* fh, uint32_t* fr,
                         uint32_t* fi, uint32_t* h1, uint32_t* r1, uint32_t* i1, uint32_t* h2,
                         uint32_t* r2, uint32_t* i2, int K, int o, int H, int N, int e,
                         int overlap, void* stream) {
  const size_t smem = (size_t)o * 8 * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (overlap) {
    series40<true><<<grid_for(N, H), kThreads, smem, s>>>(series, tabs, fh, fr, fi, h1, r1, i1,
                                                          h2, r2, i2, K, o, H, N, e);
  } else {
    series40<false><<<grid_for(N, H), kThreads, smem, s>>>(series, tabs, fh, fr, fi, h1, r1,
                                                           i1, h2, r2, i2, K, o, H, N, e);
  }
  return (int)cudaGetLastError();
}

int kw_encode_series_float(const float* series, const float* tabs, float* f_re, float* f_im,
                           float* a1r, float* a1i, float* a2r, float* a2i, int K, int o, int H,
                           int N, int overlap, void* stream) {
  const size_t smem = (size_t)o * 8 * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (overlap) {
    seriesf<true><<<grid_for(N, H), kThreads, smem, s>>>(series, tabs, f_re, f_im, a1r, a1i,
                                                         a2r, a2i, K, o, H, N);
  } else {
    seriesf<false><<<grid_for(N, H), kThreads, smem, s>>>(series, tabs, f_re, f_im, a1r, a1i,
                                                          a2r, a2i, K, o, H, N);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
