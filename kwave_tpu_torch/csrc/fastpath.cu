// Fast-path codec kernels for Hopper (sm_90a): the whole-series windowed-projection
// encode and the overlap-add decode, each in one launch that reads its input once and
// writes its output once.
//
// Replaces the TPU kernels of kwave_tpu/ops/fastpath.py and kwave_tpu/ops/encode_pallas.py:
//   project_frames <- fastpath.py _enc_kernel_flat (encode_frames_flat) and _enc_kernel
//                     (encode_frames)
//   project_window <- encode_pallas.py _float_kernel (encode_window_float): one window of
//                     project_frames, with the first-half projection P1 carried
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
// projection sums stay in registers and the [o, 4H] table sits in shared memory, staged
// from the two half tables as the caller holds them (no joined copy is made). The TPU
// kernel carries P1 from window k-1 along its sequential grid; blocks here run in no
// order, so each thread recomputes P1 of the window just before its block (one extra
// window read per KB windows). Trailing T % o steps are never read; a ragged N is masked.
//
// One window (project_window): P1 of the previous window comes in from p1_in unless
// first_window, and P1 goes out to p1_out. A window is 1.3 MB at the codec's shape, so the
// launch, one round trip to device memory and the instructions ahead of the first load are
// what it costs, not bytes. Each column of the two half tables is summed by one thread in
// u order with fmaf, as project_frames does, so a window has the bits of the whole-series
// frame. A thread issues the loads of a whole window (kWindowBatch samples, and the next
// batch before it works on this one) before its first multiply-add, with 32-bit offsets;
// the table is staged four loads a thread at a time; blocks are small, so a window of
// 16384 sensors covers the card. A thread sums all 2H coefficient rows (R >= 2H, the
// least instantiated R that holds them): with the rows spread over the grid every sample
// would be loaded 2H / R times, and on the H100 that cost more than the wider launch
// brought (PERF.md section 6, K6).
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
// kernel, and project_window window by window against project_frames, are bit-identical to
// each other.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindowsPerThread = 8;  // KB
constexpr int kWindowBatch = 16;      // samples a thread of project_window loads ahead
constexpr int kWindowThreads = 64;    // project_window's block

__device__ __forceinline__ void load_table(float* stab, const float* __restrict__ tab,
                                           int count) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) stab[j] = tab[j];
  __syncthreads();
}

// stab[o, 2*H2] = [tab_lo | tab_hi] from the two [o, H2] half tables.
__device__ __forceinline__ void load_half_tables(float* stab, const float* __restrict__ lo,
                                                 const float* __restrict__ hi, int o, int H2) {
  for (int j = threadIdx.x; j < o * 2 * H2; j += blockDim.x) {
    const int u = j / (2 * H2), c = j % (2 * H2);
    stab[j] = c < H2 ? lo[u * H2 + c] : hi[u * H2 + c - H2];
  }
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
__global__ void project_frames(const float* __restrict__ series,
                               const float* __restrict__ tab_lo,
                               const float* __restrict__ tab_hi, float* __restrict__ frames,
                               int K, int o, int N) {
  constexpr int H4 = 2 * H2;
  extern __shared__ float stab[];  // [o, 4H]
  load_half_tables(stab, tab_lo, tab_hi, o, H2);
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
  }
  for (int k = k0; k < k1; ++k) {
    project<H4>(series + (size_t)k * o * N + n, stab, o, N, p);
    if (k == 0) {  // mirror identity: the window's own P1
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
}

// xs[i] = x[(u0 + i) * N] for the steps of the batch that exist; the others are left as
// they are, and no multiply-add reads them.
__device__ __forceinline__ void load_window_batch(float (&xs)[kWindowBatch],
                                                  const float* __restrict__ x, int u0, int o,
                                                  int N) {
  const int first = u0 * N;  // o * N fits an int (kw_project_window)
#pragma unroll
  for (int i = 0; i < kWindowBatch; ++i) {
    if (u0 + i < o) xs[i] = x[first + i * N];
  }
}

// One window: thread n sums columns j < H2 of tab_lo (P1) and of tab_hi (P2), R >= H2.
template <int R>
__global__ void project_window(const float* __restrict__ chunk,
                               const float* __restrict__ tab_lo,
                               const float* __restrict__ tab_hi,
                               const float* __restrict__ p1_in, float* __restrict__ frame,
                               float* __restrict__ p1_out, int o, int H2, int N,
                               int first_window) {
  extern __shared__ float stab[];  // [o, 2R]: the columns of tab_lo, then of tab_hi
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int nn = min(n, N - 1);
  const float* x = chunk + nn;
  float xs[kWindowBatch];
  load_window_batch(xs, x, 0, o, N);
  float prev[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    prev[r] = !first_window && r < H2 ? p1_in[(size_t)r * N + nn] : 0.f;
  // four table loads a thread in flight before the first store: one round trip for a
  // table of up to 4 * blockDim.x entries
  for (int i0 = threadIdx.x; i0 < o * 2 * R; i0 += 4 * blockDim.x) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * blockDim.x;
      const int u = i / (2 * R), c = i % (2 * R), j = c % R;
      v[k] = i < o * 2 * R && j < H2 ? (c < R ? tab_lo : tab_hi)[u * H2 + j] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * blockDim.x;
      if (i < o * 2 * R) stab[i] = v[k];
    }
  }
  __syncthreads();

  float p1[R], p2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) p1[r] = p2[r] = 0.f;
  for (int u0 = 0; u0 < o; u0 += kWindowBatch) {
    float next[kWindowBatch];
    load_window_batch(next, x, u0 + kWindowBatch, o, N);
#pragma unroll
    for (int i = 0; i < kWindowBatch; ++i) {
      if (u0 + i < o) {
        const float* t = stab + (u0 + i) * 2 * R;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          p1[r] = fmaf(t[r], xs[i], p1[r]);
          p2[r] = fmaf(t[R + r], xs[i], p2[r]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kWindowBatch; ++i) xs[i] = next[i];
  }
  if (n >= N) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < H2) {
      // first window: the mirror identity, the window's own P1
      frame[(size_t)r * N + n] = __fadd_rn(first_window ? p1[r] : prev[r], p2[r]);
      p1_out[(size_t)r * N + n] = p1[r];
    }
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

// Each returns cudaGetLastError() after the launch (0 = cudaSuccess).
int kw_project_frames(const float* series, const float* tab_lo, const float* tab_hi,
                      float* frames, int K, int o, int H, int N, void* stream) {
  const size_t smem = (size_t)o * 4 * H * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
#define KW_CASE(h)                                                                   \
  case h:                                                                            \
    project_frames<2 * h><<<grid_for(N, K), kThreads, smem, s>>>(                    \
        series, tab_lo, tab_hi, frames, K, o, N);                                    \
    break;
    KW_FOR_EACH_H(KW_CASE)
#undef KW_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One window; one thread sums the 2H coefficient rows of a sensor (R, the least of 2, 4,
// 8 and 16 that holds them). p1_in is not read when first_window.
int kw_project_window(const float* chunk, const float* tab_lo, const float* tab_hi,
                      const float* p1_in, float* frame, float* p1_out, int o, int H, int N,
                      int first_window, void* stream) {
  if (o < 1 || H < 1 || H > 8 || N < 1 || (long long)o * N > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int rows = 2 * H <= 2 ? 2 : (2 * H <= 4 ? 4 : (2 * H <= 8 ? 8 : 16));
  const dim3 grid((N + kWindowThreads - 1) / kWindowThreads);
  const size_t smem = (size_t)o * 2 * rows * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
#define KW_CASE(r)                                                                         \
  case r:                                                                                  \
    project_window<r><<<grid, kWindowThreads, smem, s>>>(chunk, tab_lo, tab_hi, p1_in, frame, \
                                                         p1_out, o, 2 * H, N, first_window);  \
    break;
    KW_CASE(2) KW_CASE(4) KW_CASE(8) KW_CASE(16)
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
