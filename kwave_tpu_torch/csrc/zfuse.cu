// The fused z stage's radix kernel (see zfuse.cuh for the function and the layout).
//
// zfuse_radix_kernel<R0, R1, R2> (nz = R0*R1*R2 a power of two, 8..1024): a radix FFT in
// shared memory, 5 nz log2 nz flop a column instead of 8 nz^2, so it is bound by the
// bytes it moves (the spectrum in, one spectrum per op out). A block of 256 threads takes
// a tile of TC neighbouring columns (16 columns of complex64 are one 128-byte line); a
// thread keeps one radix-R butterfly of one column in registers, threads on neighbouring
// columns, so global loads coalesce and the exchange through shared memory (indexed with
// the column fastest) has no bank conflict. Forward is decimation in frequency: the first
// pass loads from global memory straight into registers, each pass multiplies its outputs
// by w_L^(q*j) from the nz roots staged in shared memory (no sincosf), and F is left in
// digit-reversed order: position p = q0*(nz/R0) + q1*(nz/(R0*R1)) + q2 holds bin
// k = q0 + R0*(q1 + R1*q2). The first inverse pass multiplies F by the operator looked up
// at that k (and by 1/nz); the inverse is decimation in time, the forward passes undone
// in reverse order with conjugate roots, which takes digit-reversed input and gives
// natural order, so there is no reordering pass; its last pass stores straight from
// registers. One op works in place in one tile; two or three keep F in a second tile.
// At nz = 256 that is 16 threads a column, two passes of radix 16, 34 or 66 KB a block.

#include "zfuse.cuh"

namespace {

// Columns of a tile: wide enough that every pass has a butterfly for each of the 256
// threads, narrow enough that two tiles leave room for several blocks an SM.
__host__ __device__ constexpr int radix_tc(int nz) {
  return nz <= 128 ? 32 : (nz <= 512 ? 16 : 8);
}

// The bin that position p holds after the forward passes (see the note at the top).
template <int R0, int R1, int R2>
__device__ __forceinline__ int bin_of(int p) {
  constexpr int NZ = R0 * R1 * R2;
  const int q0 = p / (NZ / R0);
  const int q1 = (p / R2) % R1;
  const int q2 = p % R2;
  return q0 + R0 * (q1 + R1 * q2);
}

// One forward pass (decimation in frequency) of radix R over sub-transforms of length L:
// butterfly (blk, j) takes positions blk*L + j + m*(L/R), m < R, and leaves output q,
// times w_L^(q*j), at blk*L + j + q*(L/R). The first pass reads the spectrum itself.
template <int NZ, int L, int R, int TC, bool FROM_GLOBAL>
__device__ __forceinline__ void forward_pass(const float2* __restrict__ S, size_t C, size_t c0,
                                             float2* tile, const float2* roots) {
  constexpr int LR = L / R;
  for (int b = threadIdx.x; b < (NZ / R) * TC; b += kThreads) {
    const int col = b % TC, t = b / TC;
    const int j = t % LR;
    const int p0 = (t / LR) * L + j;
    float2 v[R];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int p = p0 + m * LR;
      if (FROM_GLOBAL) {
        v[m] = c0 + col < C ? S[(size_t)p * C + c0 + col] : make_float2(0.f, 0.f);
      } else {
        v[m] = tile[p * TC + col];
      }
    }
    fft_reg<R, false>(v);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (LR > 1 && q > 0) v[q] = cmul(v[q], roots[q * j * (NZ / L)]);
      tile[(p0 + q * LR) * TC + col] = v[q];
    }
  }
}

// One inverse pass (decimation in time): the forward pass of the same (L, R) undone. The
// first one (L == R) reads F and multiplies by the operator at the bin each position
// holds, and by 1/nz; the last one (L == NZ) stores to the output, ragged edge masked.
template <int R0, int R1, int R2, int L, int R, int TC>
__device__ __forceinline__ void inverse_pass(const float2* src, float2* dst,
                                             float2* __restrict__ out, size_t C, size_t c0,
                                             const float2* roots, const ZOps& ops, int op,
                                             const float* __restrict__ k2z,
                                             const float* __restrict__ k2y,
                                             const float* __restrict__ k2x, int nxr,
                                             float c_ref_dt_2, int use_kappa) {
  constexpr int NZ = R0 * R1 * R2;
  constexpr int LR = L / R;
  constexpr bool FIRST = L == R, LAST = L == NZ;
  for (int b = threadIdx.x; b < (NZ / R) * TC; b += kThreads) {
    const int col = b % TC, t = b / TC;
    const int j = t % LR;
    const int p0 = (t / LR) * L + j;
    const bool live = c0 + col < C;
    float2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = src[(p0 + q * LR) * TC + col];
    if (FIRST && live) {
      const int y = (int)((c0 + col) / nxr);
      const int x = (int)((c0 + col) - (size_t)y * nxr);
      const float k2yx = k2y[y] + k2x[x];
      const float inv_nz = 1.0f / (float)NZ;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int k = bin_of<R0, R1, R2>(p0 + q * LR);
        float2 w = op_value(ops, op, k, y, x, k2z[k] + k2yx, c_ref_dt_2, use_kappa);
        w.x *= inv_nz;
        w.y *= inv_nz;
        v[q] = cmul(v[q], w);
      }
    }
#pragma unroll
    for (int q = 1; q < R; ++q) {
      if (LR > 1) {
        const float2 w = roots[q * j * (NZ / L)];
        v[q] = cmul(v[q], make_float2(w.x, -w.y));
      }
    }
    fft_reg<R, true>(v);
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int p = p0 + m * LR;
      if (LAST) {
        if (live) out[(size_t)p * C + c0 + col] = v[m];
      } else {
        dst[p * TC + col] = v[m];
      }
    }
  }
}

// nz = R0*R1*R2; R1 or R2 is 1 for a pass that is not taken (R2 > 1 needs R1 > 1).
template <int R0, int R1, int R2>
__global__ void __launch_bounds__(kThreads)
zfuse_radix_kernel(const float2* __restrict__ S, const float2* __restrict__ roots_g,
                   const float* __restrict__ k2z, const float* __restrict__ k2y,
                   const float* __restrict__ k2x, ZOps ops, int ny, int nxr, float c_ref_dt_2,
                   int use_kappa) {
  constexpr int NZ = R0 * R1 * R2;
  constexpr int TC = radix_tc(NZ);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the roots; tile F (the forward transform); with several ops a second tile to invert in
  float2* roots = reinterpret_cast<float2*>(smem_raw);
  float2* tile_f = roots + NZ;
  float2* tile_w = ops.n_ops > 1 ? tile_f + NZ * TC : tile_f;
  const size_t C = (size_t)ny * nxr;
  const size_t c0 = (size_t)blockIdx.x * TC;

  for (int j = threadIdx.x; j < NZ; j += kThreads) roots[j] = roots_g[j];
  if (R1 > 1) __syncthreads();  // a single pass multiplies by no root

  forward_pass<NZ, NZ, R0, TC, true>(S, C, c0, tile_f, roots);
  __syncthreads();
  if constexpr (R1 > 1) {
    forward_pass<NZ, NZ / R0, R1, TC, false>(S, C, c0, tile_f, roots);
    __syncthreads();
  }
  if constexpr (R2 > 1) {
    forward_pass<NZ, R2, R2, TC, false>(S, C, c0, tile_f, roots);
    __syncthreads();
  }

#define KW_INVERSE(L, R, SRC) \
  inverse_pass<R0, R1, R2, L, R, TC>(SRC, tile_w, out, C, c0, roots, ops, op, k2z, k2y, k2x, \
                                     nxr, c_ref_dt_2, use_kappa)
  for (int op = 0; op < ops.n_ops; ++op) {
    float2* __restrict__ out = ops.out[op];
    if constexpr (R2 > 1) {
      KW_INVERSE(R2, R2, tile_f);
      __syncthreads();
      KW_INVERSE(R1 * R2, R1, tile_w);
      __syncthreads();
      KW_INVERSE(NZ, R0, tile_w);
    } else if constexpr (R1 > 1) {
      KW_INVERSE(R1, R1, tile_f);
      __syncthreads();
      KW_INVERSE(NZ, R0, tile_w);
    } else {
      KW_INVERSE(NZ, R0, tile_f);
    }
    __syncthreads();  // the second tile is overwritten by the next operator
  }
#undef KW_INVERSE
}

template <int R0, int R1, int R2>
int launch_radix(const float2* S, const float2* roots, const float* k2z, const float* k2y,
                 const float* k2x, const ZOps& ops, int ny, int nxr, float c_ref_dt_2,
                 int use_kappa, cudaStream_t s) {
  constexpr int NZ = R0 * R1 * R2;
  constexpr int TC = radix_tc(NZ);
  const size_t tiles = ops.n_ops > 1 && R1 > 1 ? 2 : 1;
  const size_t smem = (tiles * NZ * TC + NZ) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(zfuse_radix_kernel<R0, R1, R2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t C = (size_t)ny * nxr;
  const unsigned blocks = (unsigned)((C + TC - 1) / TC);
  zfuse_radix_kernel<R0, R1, R2><<<blocks, kThreads, smem, s>>>(S, roots, k2z, k2y, k2x, ops,
                                                                ny, nxr, c_ref_dt_2, use_kappa);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError (0 = cudaSuccess): of the shared-memory opt-in, or
// cudaGetLastError() after the launch.

// The radix kernel, nz = r0*r1*r2 with the passes in the caller's order;
// cudaErrorInvalidValue for a pass plan that is not built here.
int kw_zfuse_radix(const void* spectrum, const void* roots, const float* k2z, const float* k2y,
                   const float* k2x, const void* dd0, const void* dd1, const void* dd2,
                   void* out0, void* out1, void* out2, int nz, int ny, int nxr, int n_ops,
                   int kind0, int kind1, int kind2, int axis0, int axis1, int axis2,
                   float power0, float power1, float power2, float c_ref_dt_2, int use_kappa,
                   int r0, int r1, int r2, void* stream) {
  if (n_ops < 1 || n_ops > kMaxOps || nz != r0 * r1 * r2) return (int)cudaErrorInvalidValue;
  const ZOps ops = make_ops(n_ops, dd0, dd1, dd2, out0, out1, out2, kind0, kind1, kind2, axis0,
                            axis1, axis2, power0, power1, power2);
  const float2* S = static_cast<const float2*>(spectrum);
  const float2* W = static_cast<const float2*>(roots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KW_PLAN(A, B, D)                                                                  \
  if (r0 == A && r1 == B && r2 == D)                                                      \
    return launch_radix<A, B, D>(S, W, k2z, k2y, k2x, ops, ny, nxr, c_ref_dt_2, use_kappa, s)
  KW_PLAN(8, 1, 1);     // nz = 8
  KW_PLAN(16, 1, 1);    // 16
  KW_PLAN(8, 4, 1);     // 32
  KW_PLAN(8, 8, 1);     // 64
  KW_PLAN(16, 8, 1);    // 128
  KW_PLAN(16, 16, 1);   // 256
  KW_PLAN(8, 8, 8);     // 512
  KW_PLAN(16, 8, 8);    // 1024
#undef KW_PLAN
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
