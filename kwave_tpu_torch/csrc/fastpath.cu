// Fast-path codec kernels for Hopper (sm_90a): the whole-series windowed-projection
// encode and the overlap-add decode, each in one launch that reads its input once and
// writes its output once.
//
// Replaces the TPU kernels of kwave_tpu/ops/fastpath.py and kwave_tpu/ops/encode_pallas.py:
//   project_frames <- fastpath.py _enc_kernel_flat (encode_frames_flat) and _enc_kernel
//                     (encode_frames); with K = 1 and a carried P1, encode_pallas.py
//                     _float_kernel (encode_window_float)
//   synth_series   <- fastpath.py _dec_kernel_flat (reconstruct_series_flat) and
//                     _dec_kernel (reconstruct_series)
// The TPU kernels' flat and 3D forms differ only in how they tile the TPU's (8, 128)
// layout and its matrix unit; on this card one kernel serves both entries.
//
// Layout (kwave_tpu.encoder conventions): series [T, N] with sensors N fastest; frames
// [K, 2H, N] with rows [:H] = re, [H:] = im; tables time-major.
//
// Encode: frame[k] = P1[k-1] + P2[k], frame[0] = P1[0] + P2[0] (the mirror identity),
// where P = chunk_k^T . [tab_lo | tab_hi] is the [4H] projection of window k (o steps).
// One thread per (sensor n, block of KB consecutive windows), coalesced along n; its 4H
// projection sums stay in registers and the [o, 4H] table sits in shared memory. The TPU
// kernel carries P1 from window k-1 along its sequential grid; blocks here run in no
// order, so each thread recomputes P1 of the window just before its block (one extra
// window read per KB windows). In one-window mode (K = 1, the K6 entry) P1 of the
// previous window comes in from p1_in unless first_window, and P1 goes out to p1_out.
// Trailing T % o steps are never read; a ragged N is masked.
//
// Decode: x[k*o + r] = sum_j tab[r, j] * [F[k]; F[k+1]]_j with tab [o, 4H] =
// [bE_re[o:] | bE_im[o:] | bE_re[:o] | bE_im[:o]] (the o/2 normalisation is folded into
// tab by the wrapper). One thread per (sensor n, block of KB windows): it holds F[k] and
// F[k+1] (4H floats) in registers and writes o steps per window. Frames at or past k_total
// read as zero, so the wrapper pads nothing; steps at or past n_steps are not written.
// Offsets are 64-bit.
//
// What bounds it on the H100: bytes. Per element the encode does 4H multiply-adds and the
// decode 4H, far below the card's fp32 rate per byte of HBM traffic. At the full shape
// (T = 4096, N = 16384, H = 2, o = 20) one round trip moves 2S + 2F = 644 MB, a floor of
// about 0.19 ms at 3.35 TB/s (a prediction, not a measurement). The design reads each
// series byte once (plus 1/KB for the recomputed P1) and writes each output byte once;
// the frames, 1/5 of the series here, are read (KB+1)/KB times by the decode.
//
// Arithmetic is fp32 throughout (fmaf, in table order). It is not bit-identical to the
// plain PyTorch version (a matmul with its own summation order); both entries of each
// kernel, and K6 window by window against K5, are bit-identical to each other.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindowsPerThread = 8;  // KB

__device__ __forceinline__ void load_table(float* stab, const float* __restrict__ tab,
                                           int count) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) stab[j] = tab[j];
  __syncthreads();
}

// p[0:4H] = sum_u stab[u, :] * x[u*N], in u order (x points at window start + n).
template <int H4>
__device__ __forceinline__ void project(const float* __restrict__ x, const float* stab, int o,
                                        int N, float (&p)[H4]) {
#pragma unroll
  for (int j = 0; j < H4; ++j) p[j] = 0.f;
#pragma unroll 4
  for (int u = 0; u < o; ++u) {
    const float xv = x[(size_t)u * N];
#pragma unroll
    for (int j = 0; j < H4; ++j) p[j] = fmaf(stab[u * H4 + j], xv, p[j]);
  }
}

template <int H2>
__global__ void project_frames(const float* __restrict__ series, const float* __restrict__ tab,
                               const float* __restrict__ p1_in, float* __restrict__ frames,
                               float* __restrict__ p1_out, int K, int o, int N,
                               int first_window) {
  constexpr int H4 = 2 * H2;
  extern __shared__ float stab[];  // [o, 4H]
  load_table(stab, tab, o * H4);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int k0 = blockIdx.y * kWindowsPerThread;
  const int k1 = min(k0 + kWindowsPerThread, K);

  float p[H4];
  float prev[H2];
  if (k0 > 0) {  // P1 of the window before this block
    project<H4>(series + (size_t)(k0 - 1) * o * N + n, stab, o, N, p);
#pragma unroll
    for (int j = 0; j < H2; ++j) prev[j] = p[j];
  } else if (!first_window) {  // one-window mode: P1 carried in
#pragma unroll
    for (int j = 0; j < H2; ++j) prev[j] = p1_in[(size_t)j * N + n];
  }
  for (int k = k0; k < k1; ++k) {
    project<H4>(series + (size_t)k * o * N + n, stab, o, N, p);
    if (k == 0 && first_window) {  // mirror identity: the window's own P1
#pragma unroll
      for (int j = 0; j < H2; ++j) prev[j] = p[j];
    }
    float* out = frames + (size_t)k * H2 * N + n;
#pragma unroll
    for (int j = 0; j < H2; ++j) {
      out[(size_t)j * N] = __fadd_rn(prev[j], p[H2 + j]);
      prev[j] = p[j];
    }
  }
  if (p1_out != nullptr) {
#pragma unroll
    for (int j = 0; j < H2; ++j) p1_out[(size_t)j * N + n] = prev[j];
  }
}

template <int H2>
__device__ __forceinline__ void load_frame(const float* __restrict__ frames, int k, int k_total,
                                           int N, int n, float (&f)[H2]) {
  const float* src = frames + (size_t)k * H2 * N + n;
#pragma unroll
  for (int j = 0; j < H2; ++j) f[j] = k < k_total ? src[(size_t)j * N] : 0.f;
}

template <int H2>
__global__ void synth_series(const float* __restrict__ frames, const float* __restrict__ tab,
                             float* __restrict__ x, int k_total, int k_max, int o, int N,
                             int n_steps) {
  constexpr int H4 = 2 * H2;
  extern __shared__ float stab[];  // [o, 4H]
  load_table(stab, tab, o * H4);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int k0 = blockIdx.y * kWindowsPerThread;
  const int k1 = min(k0 + kWindowsPerThread, k_max);

  float late[H2], early[H2];
  load_frame<H2>(frames, k0, k_total, N, n, late);
  for (int k = k0; k < k1; ++k) {
    load_frame<H2>(frames, k + 1, k_total, N, n, early);
    const int r_end = min(o, n_steps - k * o);
    float* out = x + (size_t)k * o * N + n;
    for (int r = 0; r < r_end; ++r) {
      const float* t = stab + r * H4;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < H2; ++j) acc = fmaf(t[j], late[j], acc);
#pragma unroll
      for (int j = 0; j < H2; ++j) acc = fmaf(t[H2 + j], early[j], acc);
      out[(size_t)r * N] = acc;
    }
#pragma unroll
    for (int j = 0; j < H2; ++j) late[j] = early[j];
  }
}

dim3 grid_for(int N, int windows) {
  return dim3((N + kThreads - 1) / kThreads,
              (windows + kWindowsPerThread - 1) / kWindowsPerThread);
}

}  // namespace

// Largest harmonic count the kernels are instantiated for (2H rows per frame).
#define KW_FOR_EACH_H(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

extern "C" {

// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
int kw_project_frames(const float* series, const float* tab, const float* p1_in,
                      float* frames, float* p1_out, int K, int o, int H, int N,
                      int first_window, void* stream) {
  const size_t smem = (size_t)o * 4 * H * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
#define KW_CASE(h)                                                                   \
  case h:                                                                            \
    project_frames<2 * h><<<grid_for(N, K), kThreads, smem, s>>>(                    \
        series, tab, p1_in, frames, p1_out, K, o, N, first_window);                  \
    break;
    KW_FOR_EACH_H(KW_CASE)
#undef KW_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int kw_synth_series(const float* frames, const float* tab, float* x, int k_total, int o,
                    int H, int N, int n_steps, void* stream) {
  const size_t smem = (size_t)o * 4 * H * sizeof(float);
  const int k_max = (n_steps + o - 1) / o;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
#define KW_CASE(h)                                                                   \
  case h:                                                                            \
    synth_series<2 * h><<<grid_for(N, k_max), kThreads, smem, s>>>(                  \
        frames, tab, x, k_total, k_max, o, N, n_steps);                              \
    break;
    KW_FOR_EACH_H(KW_CASE)
#undef KW_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
