// Fused compression-window encode for Hopper (sm_90a): the reference-exact per-step
// accumulate of one compressed output stream over one window of sampled steps.
//
// Replaces the TPU window kernels of kwave_tpu/ops/encode_pallas.py:
//   w40_window<true, 2>  <- _w40_kernel               (40-bit, overlap)
//   w40_window<false, 1> <- _w40_noov_kernel          (40-bit, no overlap)
//   wfloat_window<true>  <- _wfloat_exact_kernel      (float, overlap)
//   wfloat_window<false> <- _wfloat_exact_noov_kernel (float, no overlap)
//
// Layout (kwave_tpu.encoder conventions): samples chunk [steps, N] with sensors N fastest;
// stacked basis table tabs [2o, 4H] = [bE_re | bE_im | bE1_re | bE1_im] columns, time-major;
// coefficient planes [H, N]. The 40-bit planes are uint32 words (low 8/16/16 bits used).
//
// What bounds it on the H100: neither bytes nor the instruction rate. A window moves under
// 2 MB and a few million instructions; what it costs is the launch itself, one round trip
// to device memory, and the chain of `steps` dependent updates that every accumulator is
// (each 40-bit step waits for the requantised value of the one before). The design is
// about the length of that chain and about how many of the card's schedulers work on it:
// - the 40-bit accumulators stay unpacked between steps (quant40 of encode_step.cuh): the
//   words are unpacked once before the first step and packed once after the last;
// - with overlap (SPLIT = 2) the two buffers of a (harmonic, sensor) go to two lanes of one
//   warp (lanes 0-15 carry buffer 1 of 16 sensors, lanes 16-31 buffer 2 of the same ones);
//   both halves of the warp load the same sample addresses, which the hardware serves as
//   one request; the mirror takes the partner's last post-MAC floats by one shuffle;
// - blocks are small, so that a window of 16384 sensors covers all 132 SMs, and every
//   thread loads its first kBatch samples (a whole window, at the periods in use) before
//   the first step and the next batch before it works on this one.
// Each block serves one harmonic (blockIdx.y) and a tile of sensors, so it stages only the
// 4 table columns of that harmonic over the window's parity half (steps x 4 floats) in
// shared memory. parity and mirror are kernel arguments, so one build serves every window;
// steps may be shorter than o (the trailing partial window, with mirror off). The ragged
// edge of N is masked at the stores (a lane past the edge works on the last sensor, so
// that every lane takes part in the shuffle), no padding.
//
// Bit-exactness: the per-step arithmetic lives in encode_step.cuh (explicit
// round-to-nearest products and sums, no FMA contraction), shared with the whole-record
// kernels of encode_series.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_step.cuh"

namespace {

constexpr int kBatch = 16;  // samples a thread loads ahead of their use

// Stage this block's harmonic columns of the parity half: tab[u*4 + k], k = t1r,t1i,t2r,t2i.
// Four loads a thread are in flight before the first store, so a window of up to
// blockDim.x steps costs one round trip.
__device__ __forceinline__ void load_table(float* tab, const float* __restrict__ tabs,
                                           int steps, int o, int H, int h, int parity) {
  for (int j0 = threadIdx.x; j0 < 4 * steps; j0 += 4 * blockDim.x) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + k * blockDim.x;
      if (j < 4 * steps)
        v[k] = tabs[(size_t)(parity * o + (j >> 2)) * (4 * H) + (j & 3) * H + h];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + k * blockDim.x;
      if (j < 4 * steps) tab[j] = v[k];
    }
  }
  __syncthreads();
}

// xs[j] = x[(u0 + j) * N] for the steps of the batch that exist; the others are left as
// they are, and no step reads them.
__device__ __forceinline__ void load_batch(float (&xs)[kBatch], const float* __restrict__ x,
                                           int u0, int steps, int N) {
  const int first = u0 * N;  // steps * N fits an int (grid_for)
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (u0 + j < steps) xs[j] = x[first + j * N];
  }
}

// One lane per (harmonic, sensor, buffer) with overlap (SPLIT = 2), one thread per
// (harmonic, sensor) without (SPLIT = 1). blockDim.x is a multiple of 32.
template <bool OVERLAP, int SPLIT>
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
  static_assert(SPLIT == (OVERLAP ? 2 : 1), "the two buffers of a sensor on two lanes");
  constexpr int kSensors = 32 / SPLIT;  // sensors of one warp
  extern __shared__ float tab[];
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const bool second = SPLIT == 2 && lane >= kSensors;  // this lane owns buffer 2
  const int n = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * kSensors +
                (lane & (kSensors - 1));
  const bool live = n < N;
  const size_t p = (size_t)h * N + min(n, N - 1);
  const float* x = chunk + min(n, N - 1);

  // every load of the window's first batch is in flight before the table is staged
  uint32_t ah = (second ? h2_in : h1_in)[p];
  uint32_t ar = (second ? r2_in : r1_in)[p];
  uint32_t ai = (second ? i2_in : i1_in)[p];
  float xs[kBatch];
  load_batch(xs, x, 0, steps, N);
  load_table(tab, tabs, steps, o, H, h, parity);

  // this lane's buffer: q* the accumulator as floats, c* the post-MAC floats of the last
  // step
  float aqr, aqi, acr = 0.f, aci = 0.f;
  decode40(ah, ar, ai, e, aqr, aqi);
  const int ka = second ? 2 : 0;  // the buffer's table columns
  for (int u0 = 0; u0 < steps; u0 += kBatch) {
    float next[kBatch];
    load_batch(next, x, u0 + kBatch, steps, N);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (u0 + j < steps) {
        const float* t = tab + 4 * (u0 + j);
        if (OVERLAP) {
          step40_one(xs[j], t[ka], t[ka + 1], e, aqr, aqi, acr, aci);
        } else {
          step40_aliased(xs[j], t[0], t[1], t[2], t[3], e, aqr, aqi, acr, aci);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) xs[j] = next[j];
  }
  if (OVERLAP && mirror) {
    // first frame: buf2 = encode(c2 + c1) at the saving step (IndexOutputStream.cpp:429-435)
    const float pr = __shfl_xor_sync(0xffffffffu, acr, kSensors);
    const float pi = __shfl_xor_sync(0xffffffffu, aci, kSensors);
    if (second) acr = __fadd_rn(acr, pr), aci = __fadd_rn(aci, pi);
  }
  encode40(acr, aci, e, ah, ar, ai);
  if (!live) return;
  (second ? h2_out : h1_out)[p] = ah;
  (second ? r2_out : r1_out)[p] = ar;
  (second ? i2_out : i1_out)[p] = ai;
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
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t p = (size_t)h * N + min(n, N - 1);
  const float* x = chunk + min(n, N - 1);

  float a1r = a1r_in[p], a1i = a1i_in[p];
  float a2r = 0.f, a2i = 0.f;
  if (OVERLAP) a2r = a2r_in[p], a2i = a2i_in[p];
  float xs[kBatch];
  load_batch(xs, x, 0, steps, N);
  load_table(tab, tabs, steps, o, H, h, parity);
  for (int u0 = 0; u0 < steps; u0 += kBatch) {
    float next[kBatch];
    load_batch(next, x, u0 + kBatch, steps, N);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (u0 + j < steps) {
        const float* t = tab + 4 * (u0 + j);
        stepf<OVERLAP>(xs[j], t[0], t[1], t[2], t[3], a1r, a1i, a2r, a2i);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) xs[j] = next[j];
  }
  if (n >= N) return;
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

// Threads a block: small, so that one window of 16384 sensors covers the card's 132 SMs; a
// whole number of warps.
constexpr int kWindowThreads = 64;

// False for a window whose offsets do not fit an int. `split` lanes serve one sensor.
bool grid_for(int steps, int N, int H, int split, dim3& grid) {
  if (steps < 1 || N < 1 || H < 1 || H > 65535 || (long long)steps * N > 2147483647LL)
    return false;
  const int sensors = kWindowThreads / split;
  grid = dim3((N + sensors - 1) / sensors, H);
  return true;
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for a geometry it does not take. With overlap the two buffers of a
// sensor go to two lanes. e is in 0 .. kQuant40MaxE.
int kw_encode_window_40b(const float* chunk, const float* tabs, const uint32_t* h1,
                         const uint32_t* r1, const uint32_t* i1, const uint32_t* h2,
                         const uint32_t* r2, const uint32_t* i2, uint32_t* h1_out,
                         uint32_t* r1_out, uint32_t* i1_out, uint32_t* h2_out,
                         uint32_t* r2_out, uint32_t* i2_out, int steps, int o, int H, int N,
                         int e, int parity, int mirror, int overlap, void* stream) {
  dim3 grid;
  if (e < 0 || e > kQuant40MaxE || !grid_for(steps, N, H, overlap ? 2 : 1, grid))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)steps * 4 * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = overlap ? w40_window<true, 2> : w40_window<false, 1>;
  kernel<<<grid, kWindowThreads, smem, s>>>(chunk, tabs, h1, r1, i1, h2, r2, i2, h1_out,
                                            r1_out, i1_out, h2_out, r2_out, i2_out, steps, o,
                                            H, N, e, parity, mirror);
  return (int)cudaGetLastError();
}

int kw_encode_window_float(const float* chunk, const float* tabs, const float* a1r,
                           const float* a1i, const float* a2r, const float* a2i,
                           float* a1r_out, float* a1i_out, float* a2r_out, float* a2i_out,
                           int steps, int o, int H, int N, int parity, int mirror, int overlap,
                           void* stream) {
  dim3 grid;
  if (!grid_for(steps, N, H, 1, grid)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)steps * 4 * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (overlap) {
    wfloat_window<true><<<grid, kWindowThreads, smem, s>>>(
        chunk, tabs, a1r, a1i, a2r, a2i, a1r_out, a1i_out, a2r_out, a2i_out, steps, o, H, N,
        parity, mirror);
  } else {
    wfloat_window<false><<<grid, kWindowThreads, smem, s>>>(
        chunk, tabs, a1r, a1i, nullptr, nullptr, a1r_out, a1i_out, nullptr, nullptr, steps, o,
        H, N, parity, mirror);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
