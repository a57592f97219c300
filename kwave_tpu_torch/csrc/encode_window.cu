// Fused compression-window encode for Hopper (sm_90a): the reference-exact per-step
// accumulate of one compressed output stream over one window of sampled steps.
//
// Replaces the TPU window kernels of kwave_tpu/ops/encode_pallas.py:
//   w40_window<true, .>  <- _w40_kernel               (40-bit, overlap)
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
// - with SPLIT = 2 the two buffers of a (harmonic, sensor) go to two lanes of one warp
//   (lanes 0-15 carry buffer 1 of 16 sensors, lanes 16-31 buffer 2 of the same sensors);
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

// One thread per (harmonic, sensor) with SPLIT = 1, one lane per (harmonic, sensor, buffer)
// with SPLIT = 2 (overlap only). blockDim.x is a multiple of 32.
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
  static_assert(SPLIT == 1 || (SPLIT == 2 && OVERLAP), "only two buffers can be split");
  constexpr int kSensors = 32 / SPLIT;          // sensors of one warp
  constexpr bool kBoth = OVERLAP && SPLIT == 1;  // this thread carries both buffers
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
  uint32_t bh = 0, br = 0, bi = 0;
  if (kBoth) bh = h2_in[p], br = r2_in[p], bi = i2_in[p];
  float xs[kBatch];
  load_batch(xs, x, 0, steps, N);
  load_table(tab, tabs, steps, o, H, h, parity);

  // a: this thread's (first) buffer, b: buffer 2 beside it when the thread carries both.
  // q* the accumulators as floats, c* the post-MAC floats of the last step.
  float aqr, aqi, acr = 0.f, aci = 0.f;
  float bqr = 0.f, bqi = 0.f, bcr = 0.f, bci = 0.f;
  decode40(ah, ar, ai, e, aqr, aqi);
  if (kBoth) decode40(bh, br, bi, e, bqr, bqi);
  const int ka = second ? 2 : 0;  // a's table columns
  for (int u0 = 0; u0 < steps; u0 += kBatch) {
    float next[kBatch];
    load_batch(next, x, u0 + kBatch, steps, N);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (u0 + j < steps) {
        const float* t = tab + 4 * (u0 + j);
        if (OVERLAP) {
          step40_one(xs[j], t[ka], t[ka + 1], e, aqr, aqi, acr, aci);
          if (kBoth) step40_one(xs[j], t[2], t[3], e, bqr, bqi, bcr, bci);
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
    if (SPLIT == 2) {
      const float pr = __shfl_xor_sync(0xffffffffu, acr, kSensors);
      const float pi = __shfl_xor_sync(0xffffffffu, aci, kSensors);
      if (second) acr = __fadd_rn(acr, pr), aci = __fadd_rn(aci, pi);
    } else {
      bcr = __fadd_rn(bcr, acr), bci = __fadd_rn(bci, aci);
    }
  }
  encode40(acr, aci, e, ah, ar, ai);
  if (kBoth) encode40(bcr, bci, e, bh, br, bi);
  if (!live) return;
  (second ? h2_out : h1_out)[p] = ah;
  (second ? r2_out : r1_out)[p] = ar;
  (second ? i2_out : i1_out)[p] = ai;
  if (kBoth) h2_out[p] = bh, r2_out[p] = br, i2_out[p] = bi;
}

// The design before the fused step, kept as the baseline of `kwave_tpu_torch.sweeps`: one
// thread per (harmonic, sensor), the words packed and unpacked at every step, each sample
// loaded when its step needs it. No path of the package launches it.
template <bool OVERLAP>
__global__ void w40_window_packed(
    const float* __restrict__ chunk, const float* __restrict__ tabs,
    const uint32_t* __restrict__ h1_in, const uint32_t* __restrict__ r1_in,
    const uint32_t* __restrict__ i1_in, const uint32_t* __restrict__ h2_in,
    const uint32_t* __restrict__ r2_in, const uint32_t* __restrict__ i2_in,
    uint32_t* __restrict__ h1_out, uint32_t* __restrict__ r1_out,
    uint32_t* __restrict__ i1_out, uint32_t* __restrict__ h2_out,
    uint32_t* __restrict__ r2_out, uint32_t* __restrict__ i2_out, int steps, int o, int H,
    int N, int e, int parity, int mirror) {
  extern __shared__ float tab[];
  const int h = blockIdx.y;
  load_table(tab, tabs, steps, o, H, h, parity);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t p = (size_t)h * N + n;

  uint32_t h1 = h1_in[p], r1 = r1_in[p], i1 = i1_in[p];
  uint32_t h2 = 0, r2 = 0, i2 = 0;
  if (OVERLAP) h2 = h2_in[p], r2 = r2_in[p], i2 = i2_in[p];
  float c1r = 0.f, c1i = 0.f, c2r = 0.f, c2i = 0.f;
  for (int u = 0; u < steps; ++u) {
    const float x = chunk[(size_t)u * N + n];
    const float* t = tab + 4 * u;
    if (OVERLAP) {
      step40_packed_one(x, t[0], t[1], e, h1, r1, i1, c1r, c1i);
      step40_packed_one(x, t[2], t[3], e, h2, r2, i2, c2r, c2i);
    } else {
      decode40(h1, r1, i1, e, c1r, c1i);
      c1r = __fadd_rn(c1r, __fadd_rn(__fmul_rn(t[0], x), __fmul_rn(t[2], x)));
      c1i = __fadd_rn(c1i, __fadd_rn(__fmul_rn(t[1], x), __fmul_rn(t[3], x)));
      encode40(c1r, c1i, e, h1, r1, i1);
    }
  }
  if (OVERLAP && mirror) mirror40(c1r, c1i, c2r, c2i, e, h2, r2, i2);
  h1_out[p] = h1, r1_out[p] = r1, i1_out[p] = i1;
  if (OVERLAP) h2_out[p] = h2, r2_out[p] = r2, i2_out[p] = i2;
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

// The launch floor: nothing but the launch, at a window kernel's grid, block and shared
// memory.
__global__ void empty_window() {}

// False for a block that is no whole number of warps, or a window whose offsets do not fit
// an int. `split` lanes serve one sensor.
bool grid_for(int steps, int N, int H, int threads, int split, dim3& grid) {
  if (steps < 1 || N < 1 || H < 1 || H > 65535 || threads < 32 || threads > 1024 ||
      threads % 32 || (long long)steps * N > 2147483647LL)
    return false;
  const int sensors = threads / split;
  grid = dim3((N + sensors - 1) / sensors, H);
  return true;
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for a geometry it does not take. `threads` is the block size (a
// multiple of 32). `split` = 2 gives the two buffers of a sensor to two lanes (overlap
// only); `packed` takes the baseline kernel instead (split = 1). e is in 0 .. kQuant40MaxE.
int kw_encode_window_40b(const float* chunk, const float* tabs, const uint32_t* h1,
                         const uint32_t* r1, const uint32_t* i1, const uint32_t* h2,
                         const uint32_t* r2, const uint32_t* i2, uint32_t* h1_out,
                         uint32_t* r1_out, uint32_t* i1_out, uint32_t* h2_out,
                         uint32_t* r2_out, uint32_t* i2_out, int steps, int o, int H, int N,
                         int e, int parity, int mirror, int overlap, int threads, int split,
                         int packed, void* stream) {
  dim3 grid;
  if ((split != 1 && !(split == 2 && overlap && !packed)) ||
      (!packed && (e < 0 || e > kQuant40MaxE)) ||
      !grid_for(steps, N, H, threads, split, grid))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)steps * 4 * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = w40_window<false, 1>;
  if (packed) {
    kernel = overlap ? w40_window_packed<true> : w40_window_packed<false>;
  } else if (overlap) {
    kernel = split == 2 ? w40_window<true, 2> : w40_window<true, 1>;
  }
  kernel<<<grid, threads, smem, s>>>(chunk, tabs, h1, r1, i1, h2, r2, i2, h1_out, r1_out,
                                     i1_out, h2_out, r2_out, i2_out, steps, o, H, N, e, parity,
                                     mirror);
  return (int)cudaGetLastError();
}

int kw_encode_window_float(const float* chunk, const float* tabs, const float* a1r,
                           const float* a1i, const float* a2r, const float* a2i,
                           float* a1r_out, float* a1i_out, float* a2r_out, float* a2i_out,
                           int steps, int o, int H, int N, int parity, int mirror, int overlap,
                           int threads, void* stream) {
  dim3 grid;
  if (!grid_for(steps, N, H, threads, 1, grid)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)steps * 4 * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (overlap) {
    wfloat_window<true><<<grid, threads, smem, s>>>(
        chunk, tabs, a1r, a1i, a2r, a2i, a1r_out, a1i_out, a2r_out, a2i_out, steps, o, H, N,
        parity, mirror);
  } else {
    wfloat_window<false><<<grid, threads, smem, s>>>(
        chunk, tabs, a1r, a1i, nullptr, nullptr, a1r_out, a1i_out, nullptr, nullptr, steps, o,
        H, N, parity, mirror);
  }
  return (int)cudaGetLastError();
}

// An empty kernel at the grid, block and shared memory of a window of `steps` steps.
int kw_launch_floor(int steps, int H, int N, int threads, int split, void* stream) {
  dim3 grid;
  if (!grid_for(steps, N, H, threads, split, grid)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)steps * 4 * sizeof(float);
  empty_window<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
