// Fused z stage of the solver's spectral multiplies for Hopper (sm_90a): z-DFT -> pointwise
// operator built in the kernel -> z-IDFT, for up to three operators off one forward
// transform.
//
// Replaces the TPU kernel of kwave_tpu/ops/zfuse.py (_kernel, entry apply).
//
// Layout: the spectrum S [nz, ny, nxr] complex64 (interleaved re/im), z in canonical bin
// order, after the x/y transforms. Every (y, x) pair is a column c = y*nxr + x of a
// row-major [nz, C] matrix, C = ny*nxr. For each column:
//   F = DFT_z . S;  k^2 = k2z[z] + (k2y[y] + k2x[x]);
//   kappa = sin(a)/a with a = c_ref_dt_2*sqrt(k^2), 1 at a == 0 (when use_kappa);
//   "grad" op:  G = F * kappa * dd[z | y | x]   (dd complex)
//   "nabla" op: G = F * |k|^power, 0 at k == 0
//   out = IDFT_z . G  (carries the 1/nz).
//
// The TPU version does each contraction as a three-pass bf16 split on its matrix unit,
// because that compiler has no fp32 matmul, and holds the [nz, nz] matrices in fast memory.
// This card has fp32 FMAs, 227 KB of shared memory a block and far less arithmetic than
// that unit per byte moved, so the three kernels here are:
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
//
// zfuse_mixed_kernel<TC> (every other nz from 8 to 1709 whose prime factors are 2, 3, 5 and
// 7: 192, 320, 384, 448, ...): the radix kernel's FFT with the pass plan a runtime argument
// (up to seven radices from 2, 3, 4, 5, 7, 8, 16; the power-of-two part first, then each
// odd factor a pass of its own), so one instantiation per tile width serves every such
// nz. Each pass switches, uniformly across the block, on its radix to a butterfly in
// registers: the radix kernel's for 2..16, and a DFT over the sums and differences of the
// pairs (m, R - m) with constant cos/sin for 3, 5 and 7. The first pass loads from global
// memory, the last stores to it, and the bin each position holds comes from the plan's
// int16 table (read through the cache, as k2z is, so that two tiles and the roots fit up
// to nz = 1709). Bound by bytes as the radix kernel; its registers are capped so that
// three blocks share an SM, and the tile is the widest (32, 16 or 8 columns) whose shared
// memory lets them.
//
// zfuse_kernel<TC> (the rest: nz below 8, a prime factor of 11 or more): the dense DFT in
// fp32 FMAs. A block stages S for a tile
// of TC columns as re/im planes [nz][TC]. The [nz, nz] matrix does not fit, so only the nz
// roots are staged and entry (k, z) is roots[(k*z) mod nz], the index advanced by k per z
// step. A thread accumulates 8 output bins x 4 columns in registers (128 FMAs per 10
// shared loads), writes F to a second tile, and then per operator: all threads form
// G = F * op into the first tile, and the same contraction with the conjugate roots writes
// the output. It is bound by operations: 16*nz^2 flop per column and op pair.
//
// All three zero-fill the ragged last tile on load and mask it on store, and need more
// than 48 KB of shared memory at the larger nz, so the launchers opt in to what they ask
// for.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOps = 3;
constexpr int KB = 8;  // output bins per thread
constexpr int CB = 4;  // columns per thread

struct ZOps {
  int n_ops;
  int kind[kMaxOps];  // 0 = grad, 1 = nabla
  int axis[kMaxOps];  // grad: 0 = z, 1 = y, 2 = x
  float power[kMaxOps];
  const float2* dd[kMaxOps];
  float2* out[kMaxOps];
};

// The multiplier of operator `op` at bin k of column (y, x), where k2 = |k|^2 there.
__device__ __forceinline__ float2 op_value(const ZOps& ops, int op, int k, int y, int x,
                                           float k2, float c_ref_dt_2, int use_kappa) {
  if (ops.kind[op] == 0) {
    const int at = ops.axis[op] == 0 ? k : (ops.axis[op] == 1 ? y : x);
    float2 d = ops.dd[op][at];
    if (use_kappa) {
      const float arg = c_ref_dt_2 * sqrtf(k2);
      const float kappa = arg == 0.f ? 1.f : sinf(arg) / arg;
      d.x *= kappa;
      d.y *= kappa;
    }
    return d;
  }
  const float kmag = sqrtf(k2);
  return make_float2(kmag == 0.f ? 0.f : powf(kmag, ops.power[op]), 0.f);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// acc[j][q] = sum_z roots[((k0 + j) * z) mod nz] (conjugated when INV) * a[z][col0 + q]
template <int TC, bool INV>
__device__ __forceinline__ void dft_bins(const float* __restrict__ a_re,
                                         const float* __restrict__ a_im,
                                         const float2* __restrict__ roots, int nz, int k0,
                                         int col0, float (&acc_r)[KB][CB],
                                         float (&acc_i)[KB][CB]) {
  int idx[KB], kk[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    kk[j] = (k0 + j < nz) ? k0 + j : 0;  // bins past nz are computed as bin 0 and dropped
    idx[j] = 0;
#pragma unroll
    for (int q = 0; q < CB; ++q) acc_r[j][q] = acc_i[j][q] = 0.f;
  }
  for (int z = 0; z < nz; ++z) {
    const float4 sr4 = *reinterpret_cast<const float4*>(a_re + z * TC + col0);
    const float4 si4 = *reinterpret_cast<const float4*>(a_im + z * TC + col0);
    const float sr[CB] = {sr4.x, sr4.y, sr4.z, sr4.w};
    const float si[CB] = {si4.x, si4.y, si4.z, si4.w};
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const float2 w = roots[idx[j]];
      const float wr = w.x, wi = INV ? -w.y : w.y;
#pragma unroll
      for (int q = 0; q < CB; ++q) {
        acc_r[j][q] = fmaf(wr, sr[q], acc_r[j][q]);
        acc_r[j][q] = fmaf(-wi, si[q], acc_r[j][q]);
        acc_i[j][q] = fmaf(wr, si[q], acc_i[j][q]);
        acc_i[j][q] = fmaf(wi, sr[q], acc_i[j][q]);
      }
      idx[j] += kk[j];
      if (idx[j] >= nz) idx[j] -= nz;
    }
  }
}

template <int TC>
__global__ void __launch_bounds__(kThreads)
zfuse_kernel(const float2* __restrict__ S, const float2* __restrict__ roots_g,
             const float* __restrict__ k2z, const float* __restrict__ k2y,
             const float* __restrict__ k2x, ZOps ops, int nz, int ny, int nxr,
             float c_ref_dt_2, int use_kappa) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // tile A: S, then each operator's G; tile B: F; then the roots
  float* a_re = reinterpret_cast<float*>(smem_raw);
  float* a_im = a_re + (size_t)nz * TC;
  float* b_re = a_im + (size_t)nz * TC;
  float* b_im = b_re + (size_t)nz * TC;
  float2* roots = reinterpret_cast<float2*>(b_im + (size_t)nz * TC);

  const int tid = threadIdx.x;
  const size_t C = (size_t)ny * nxr;
  const size_t c0 = (size_t)blockIdx.x * TC;
  constexpr int CG = TC / CB;        // column groups
  constexpr int KG = kThreads / CG;  // bin groups per pass
  const int col0 = (tid % CG) * CB;
  const int kg = tid / CG;

  for (int j = tid; j < nz; j += kThreads) roots[j] = roots_g[j];
  for (int e = tid; e < nz * TC; e += kThreads) {
    const int z = e / TC, c = e - z * TC;
    float2 v = make_float2(0.f, 0.f);
    if (c0 + c < C) v = S[(size_t)z * C + c0 + c];
    a_re[e] = v.x;
    a_im[e] = v.y;
  }
  __syncthreads();

  float acc_r[KB][CB], acc_i[KB][CB];
  // forward: F = DFT_z . S, into tile B
  for (int k0 = kg * KB; k0 < nz; k0 += KG * KB) {
    dft_bins<TC, false>(a_re, a_im, roots, nz, k0, col0, acc_r, acc_i);
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      if (k0 + j >= nz) break;
#pragma unroll
      for (int q = 0; q < CB; ++q) {
        b_re[(k0 + j) * TC + col0 + q] = acc_r[j][q];
        b_im[(k0 + j) * TC + col0 + q] = acc_i[j][q];
      }
    }
  }
  __syncthreads();

  const float inv_nz = 1.0f / (float)nz;
  for (int op = 0; op < ops.n_ops; ++op) {
    // pointwise: G = F * operator(k, y, x) / nz, into tile A
    for (int e = tid; e < nz * TC; e += kThreads) {
      const int k = e / TC, c = e - k * TC;
      float g_re = 0.f, g_im = 0.f;
      if (c0 + c < C) {
        const int y = (int)((c0 + c) / nxr);
        const int x = (int)((c0 + c) - (size_t)y * nxr);
        const float2 g = cmul(make_float2(b_re[e], b_im[e]),
                              op_value(ops, op, k, y, x, k2z[k] + (k2y[y] + k2x[x]),
                                       c_ref_dt_2, use_kappa));
        g_re = g.x;
        g_im = g.y;
      }
      a_re[e] = g_re * inv_nz;
      a_im[e] = g_im * inv_nz;
    }
    __syncthreads();
    // inverse: out = IDFT_z . G
    float2* __restrict__ out = ops.out[op];
    for (int k0 = kg * KB; k0 < nz; k0 += KG * KB) {
      dft_bins<TC, true>(a_re, a_im, roots, nz, k0, col0, acc_r, acc_i);
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        if (k0 + j >= nz) break;
#pragma unroll
        for (int q = 0; q < CB; ++q) {
          if (c0 + col0 + q < C)
            out[(size_t)(k0 + j) * C + c0 + col0 + q] = make_float2(acc_r[j][q], acc_i[j][q]);
        }
      }
    }
    __syncthreads();  // tile A is overwritten by the next operator
  }
}

template <int TC>
int launch(const float2* S, const float2* roots, const float* k2z, const float* k2y,
           const float* k2x, const ZOps& ops, int nz, int ny, int nxr, float c_ref_dt_2,
           int use_kappa, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(zfuse_kernel<TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t C = (size_t)ny * nxr;
  const unsigned blocks = (unsigned)((C + TC - 1) / TC);
  zfuse_kernel<TC><<<blocks, kThreads, smem, s>>>(S, roots, k2z, k2y, k2x, ops, nz, ny, nxr,
                                                  c_ref_dt_2, use_kappa);
  return (int)cudaGetLastError();
}

// Shared memory the kernel needs for a tile of `tc` columns.
size_t zfuse_smem(int nz, int tc) {
  return (size_t)nz * tc * 4 * sizeof(float) + (size_t)nz * sizeof(float2);
}

// ---------------------------------------------------------------------------
// The radix kernel
// ---------------------------------------------------------------------------

// cos and sin of 2*pi*J/16: the roots a butterfly of radix <= 16 needs beside 1 and -/+i
template <int J>
struct Root16;
#define KW_ROOT16(J, C, S)            \
  template <>                         \
  struct Root16<J> {                  \
    static constexpr float c = C;     \
    static constexpr float s = S;     \
  }
KW_ROOT16(1, 0.92387953251128674f, 0.38268343236508977f);
KW_ROOT16(2, 0.70710678118654752f, 0.70710678118654752f);
KW_ROOT16(3, 0.38268343236508977f, 0.92387953251128674f);
KW_ROOT16(5, -0.38268343236508977f, 0.92387953251128674f);
KW_ROOT16(6, -0.70710678118654752f, 0.70710678118654752f);
KW_ROOT16(7, -0.92387953251128674f, 0.38268343236508977f);
#undef KW_ROOT16

// a * exp(-/+ 2*pi*i*K/R) (forward / inverse), 0 <= K < R/2, R <= 16
template <int K, int R, bool INV>
__device__ __forceinline__ float2 mul_root(float2 a) {
  if constexpr (K == 0) {
    return a;
  } else if constexpr (4 * K == R) {  // -i forward, +i inverse
    return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
  } else {
    constexpr float c = Root16<K * 16 / R>::c;
    constexpr float si = INV ? Root16<K * 16 / R>::s : -Root16<K * 16 / R>::s;
    return make_float2(a.x * c - a.y * si, a.x * si + a.y * c);
  }
}

template <int R, bool INV>
__device__ __forceinline__ void fft_reg(float2 (&v)[R]);

// v[K] = e[K] + w^K o[K], v[K + R/2] = e[K] - w^K o[K], for K, K+1, ..., R/2 - 1
template <int K, int R, bool INV>
__device__ __forceinline__ void combine(float2 (&v)[R], const float2 (&e)[R / 2],
                                        const float2 (&o)[R / 2]) {
  const float2 t = mul_root<K, R, INV>(o[K]);
  v[K] = make_float2(e[K].x + t.x, e[K].y + t.y);
  v[K + R / 2] = make_float2(e[K].x - t.x, e[K].y - t.y);
  if constexpr (K + 1 < R / 2) combine<K + 1, R, INV>(v, e, o);
}

// In registers, natural order in and out: v[q] <- sum_m v[m] exp(-/+ 2*pi*i*q*m/R).
template <int R, bool INV>
__device__ __forceinline__ void fft_reg(float2 (&v)[R]) {
  if constexpr (R == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = make_float2(a.x + b.x, a.y + b.y);
    v[1] = make_float2(a.x - b.x, a.y - b.y);
  } else if constexpr (R > 2) {
    float2 e[R / 2], o[R / 2];
#pragma unroll
    for (int k = 0; k < R / 2; ++k) {
      e[k] = v[2 * k];
      o[k] = v[2 * k + 1];
    }
    fft_reg<R / 2, INV>(e);
    fft_reg<R / 2, INV>(o);
    combine<0, R, INV>(v, e, o);
  }
}

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

// ---------------------------------------------------------------------------
// The mixed-radix kernel
// ---------------------------------------------------------------------------

constexpr int kMaxPasses = 7;  // 1458 = 2 * 3^6 takes seven
// Blocks of the mixed kernel an SM holds at once: its registers are capped for three, and
// its tile width is chosen so that their shared memory fits too (`mixed_tc`).
constexpr int kMixedBlocks = 3;

// The forward passes, first pass first; the inverse takes them in reverse order.
struct MixedPlan {
  int n;
  int r[kMaxPasses];
};

// cos and sin of 2*pi*K/R for the odd radices, 1 <= K <= (R - 1)/2
__host__ __device__ constexpr float odd_cos(int r, int k) {
  return r == 3   ? -0.5f
         : r == 5 ? (k == 1 ? 0.30901699437494745f : -0.80901699437494730f)
                  : (k == 1 ? 0.62348980185873360f
                            : (k == 2 ? -0.22252093395631434f : -0.90096886790241900f));
}
__host__ __device__ constexpr float odd_sin(int r, int k) {
  return r == 3   ? 0.86602540378443870f
         : r == 5 ? (k == 1 ? 0.95105651629515350f : 0.58778525229247320f)
                  : (k == 1 ? 0.78183148246802980f
                            : (k == 2 ? 0.97492791218182360f : 0.43388373911755823f));
}

// In registers, natural order in and out, R = 3, 5 or 7: v[q] <- sum_m v[m] w^(q*m) with
// w = exp(-/+ 2*pi*i/R), from the sums s and differences d of the pairs (m, R - m):
// v[q], v[R - q] = a -/+ i*b (forward; +/- inverse), a = v[0] + sum_m cos(2*pi*q*m/R) s[m],
// b = sum_m sin(2*pi*q*m/R) d[m].
template <int R, bool INV>
__device__ __forceinline__ void fft_odd(float2 (&v)[R]) {
  constexpr int H = (R - 1) / 2;
  float2 s[H], d[H];
  float2 x0 = v[0];
#pragma unroll
  for (int m = 1; m <= H; ++m) {
    s[m - 1] = make_float2(v[m].x + v[R - m].x, v[m].y + v[R - m].y);
    d[m - 1] = make_float2(v[m].x - v[R - m].x, v[m].y - v[R - m].y);
    x0.x += s[m - 1].x;
    x0.y += s[m - 1].y;
  }
#pragma unroll
  for (int q = 1; q <= H; ++q) {
    float2 a = v[0], b = make_float2(0.f, 0.f);
#pragma unroll
    for (int m = 1; m <= H; ++m) {
      const int k = (q * m) % R;
      const float c = k <= H ? odd_cos(R, k) : odd_cos(R, R - k);
      const float sn = k <= H ? odd_sin(R, k) : -odd_sin(R, R - k);
      a.x = fmaf(c, s[m - 1].x, a.x);
      a.y = fmaf(c, s[m - 1].y, a.y);
      b.x = fmaf(sn, d[m - 1].x, b.x);
      b.y = fmaf(sn, d[m - 1].y, b.y);
    }
    const float2 minus = make_float2(a.x + b.y, a.y - b.x);  // a - i*b
    const float2 plus = make_float2(a.x - b.y, a.y + b.x);   // a + i*b
    v[q] = INV ? plus : minus;
    v[R - q] = INV ? minus : plus;
  }
  v[0] = x0;
}

template <int R, bool INV>
__device__ __forceinline__ void fft_any(float2 (&v)[R]) {
  if constexpr (R % 2 == 1) {
    fft_odd<R, INV>(v);
  } else {
    fft_reg<R, INV>(v);
  }
}

// forward_pass with the radix a template argument and nz, L and whether the pass reads
// the spectrum itself arguments at run time.
template <int R, int TC>
__device__ __forceinline__ void mixed_forward_pass(const float2* __restrict__ S, size_t C,
                                                   size_t c0, float2* tile,
                                                   const float2* roots, int nz, int L,
                                                   bool from_global) {
  const int LR = L / R, stride = nz / L;
  for (int b = threadIdx.x; b < (nz / R) * TC; b += kThreads) {
    const int col = b % TC, t = b / TC;
    const int j = t % LR;
    const int p0 = (t - j) * R + j;  // (t / LR) * L + j
    float2 v[R];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int p = p0 + m * LR;
      if (from_global) {
        v[m] = c0 + col < C ? S[(size_t)p * C + c0 + col] : make_float2(0.f, 0.f);
      } else {
        v[m] = tile[p * TC + col];
      }
    }
    fft_any<R, false>(v);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (LR > 1 && q > 0) v[q] = cmul(v[q], roots[q * j * stride]);
      tile[(p0 + q * LR) * TC + col] = v[q];
    }
  }
}

// inverse_pass likewise; the bin each position holds comes from the plan's table.
template <int R, int TC>
__device__ __forceinline__ void mixed_inverse_pass(
    const float2* src, float2* dst, float2* __restrict__ out, size_t C, size_t c0,
    const float2* roots, const short* __restrict__ bins, const ZOps& ops, int op,
    const float* __restrict__ k2z, const float* __restrict__ k2y,
    const float* __restrict__ k2x, int nxr, float c_ref_dt_2, int use_kappa, int nz, int L,
    bool first, bool last) {
  const int LR = L / R, stride = nz / L;
  const float inv_nz = 1.0f / (float)nz;
  for (int b = threadIdx.x; b < (nz / R) * TC; b += kThreads) {
    const int col = b % TC, t = b / TC;
    const int j = t % LR;
    const int p0 = (t - j) * R + j;
    const bool live = c0 + col < C;
    float2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = src[(p0 + q * LR) * TC + col];
    if (first && live) {
      const int y = (int)((c0 + col) / nxr);
      const int x = (int)((c0 + col) - (size_t)y * nxr);
      const float k2yx = k2y[y] + k2x[x];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int k = bins[p0 + q * LR];
        float2 w = op_value(ops, op, k, y, x, k2z[k] + k2yx, c_ref_dt_2, use_kappa);
        w.x *= inv_nz;
        w.y *= inv_nz;
        v[q] = cmul(v[q], w);
      }
    }
    if (LR > 1) {
#pragma unroll
      for (int q = 1; q < R; ++q) {
        const float2 w = roots[q * j * stride];
        v[q] = cmul(v[q], make_float2(w.x, -w.y));
      }
    }
    fft_any<R, true>(v);
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int p = p0 + m * LR;
      if (last) {
        if (live) out[(size_t)p * C + c0 + col] = v[m];
      } else {
        dst[p * TC + col] = v[m];
      }
    }
  }
}

// One call of CALL(R) for the pass's radix r (uniform across the block).
#define KW_BY_RADIX(CALL) \
  switch (r) {            \
    case 2: CALL(2); break; \
    case 3: CALL(3); break; \
    case 4: CALL(4); break; \
    case 5: CALL(5); break; \
    case 7: CALL(7); break; \
    case 8: CALL(8); break; \
    default: CALL(16); break; \
  }

// Any nz whose plan the host checked: radices from 2, 3, 4, 5, 7, 8, 16.
template <int TC>
__global__ void __launch_bounds__(kThreads, kMixedBlocks)
zfuse_mixed_kernel(const float2* __restrict__ S, const float2* __restrict__ roots_g,
                   const short* __restrict__ bins, const float* __restrict__ k2z,
                   const float* __restrict__ k2y, const float* __restrict__ k2x, ZOps ops,
                   MixedPlan plan, int nz, int ny, int nxr, float c_ref_dt_2, int use_kappa) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the roots; tile F (the forward transform); with several ops a second tile to invert in
  float2* roots = reinterpret_cast<float2*>(smem_raw);
  float2* tile_f = roots + nz;
  float2* tile_w = ops.n_ops > 1 ? tile_f + (size_t)nz * TC : tile_f;
  const size_t C = (size_t)ny * nxr;
  const size_t c0 = (size_t)blockIdx.x * TC;

  for (int j = threadIdx.x; j < nz; j += kThreads) roots[j] = roots_g[j];
  __syncthreads();

  int L = nz;
  for (int i = 0; i < plan.n; ++i) {
    const int r = plan.r[i];
#define KW_FORWARD(R) mixed_forward_pass<R, TC>(S, C, c0, tile_f, roots, nz, L, i == 0)
    KW_BY_RADIX(KW_FORWARD)
#undef KW_FORWARD
    __syncthreads();
    L /= r;
  }

  for (int op = 0; op < ops.n_ops; ++op) {
    float2* __restrict__ out = ops.out[op];
    L = plan.r[plan.n - 1];
    for (int i = plan.n - 1; i >= 0; --i) {
      const int r = plan.r[i];
      const bool first = i == plan.n - 1;
#define KW_INVERSE(R)                                                                       \
  mixed_inverse_pass<R, TC>(first ? tile_f : tile_w, tile_w, out, C, c0, roots, bins, ops, op, \
                            k2z, k2y, k2x, nxr, c_ref_dt_2, use_kappa, nz, L, first, i == 0)
      KW_BY_RADIX(KW_INVERSE)
#undef KW_INVERSE
      if (i > 0) {
        __syncthreads();
        L *= plan.r[i - 1];
      }
    }
    __syncthreads();  // the second tile is overwritten by the next operator
  }
}
#undef KW_BY_RADIX

// Shared memory of the mixed kernel: the roots and one tile, two with several ops.
size_t mixed_smem(int nz, int tc, int n_ops, int n_passes) {
  const size_t tiles = n_ops > 1 && n_passes > 1 ? 2 : 1;
  return (tiles * nz * tc + nz) * sizeof(float2);
}

// Columns of a tile: the widest of 32, 16 and 8 whose shared memory lets kMixedBlocks
// blocks share an SM's 228 KB (1 KB of it reserved a block), else 8.
int mixed_tc(int nz, int n_ops, int n_passes) {
  for (int tc = 32; tc > 8; tc /= 2)
    if (kMixedBlocks * (mixed_smem(nz, tc, n_ops, n_passes) + 1024) <= 228 * 1024) return tc;
  return 8;
}

template <int TC>
int launch_mixed(const float2* S, const float2* roots, const short* bins, const float* k2z,
                 const float* k2y, const float* k2x, const ZOps& ops, const MixedPlan& plan,
                 int nz, int ny, int nxr, float c_ref_dt_2, int use_kappa, cudaStream_t s) {
  const size_t smem = mixed_smem(nz, TC, ops.n_ops, plan.n);
  cudaError_t err = cudaFuncSetAttribute(zfuse_mixed_kernel<TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t C = (size_t)ny * nxr;
  const unsigned blocks = (unsigned)((C + TC - 1) / TC);
  zfuse_mixed_kernel<TC><<<blocks, kThreads, smem, s>>>(S, roots, bins, k2z, k2y, k2x, ops, plan,
                                                        nz, ny, nxr, c_ref_dt_2, use_kappa);
  return (int)cudaGetLastError();
}

ZOps make_ops(int n_ops, const void* dd0, const void* dd1, const void* dd2, void* out0,
              void* out1, void* out2, int kind0, int kind1, int kind2, int axis0, int axis1,
              int axis2, float power0, float power1, float power2) {
  ZOps ops;
  ops.n_ops = n_ops;
  const int kinds[kMaxOps] = {kind0, kind1, kind2};
  const int axes[kMaxOps] = {axis0, axis1, axis2};
  const float powers[kMaxOps] = {power0, power1, power2};
  const void* dds[kMaxOps] = {dd0, dd1, dd2};
  void* outs[kMaxOps] = {out0, out1, out2};
  for (int i = 0; i < kMaxOps; ++i) {
    ops.kind[i] = kinds[i];
    ops.axis[i] = axes[i];
    ops.power[i] = powers[i];
    ops.dd[i] = static_cast<const float2*>(dds[i]);
    ops.out[i] = static_cast<float2*>(outs[i]);
  }
  return ops;
}

}  // namespace

extern "C" {

// Each returns a cudaError (0 = cudaSuccess): of the shared-memory opt-in, or
// cudaGetLastError() after the launch.

// The dense kernel, any nz; cudaErrorInvalidValue when no tile width fits.
int kw_zfuse(const void* spectrum, const void* roots, const float* k2z, const float* k2y,
             const float* k2x, const void* dd0, const void* dd1, const void* dd2, void* out0,
             void* out1, void* out2, int nz, int ny, int nxr, int n_ops, int kind0, int kind1,
             int kind2, int axis0, int axis1, int axis2, float power0, float power1,
             float power2, float c_ref_dt_2, int use_kappa, void* stream) {
  if (n_ops < 1 || n_ops > kMaxOps || nz < 1) return (int)cudaErrorInvalidValue;
  const ZOps ops = make_ops(n_ops, dd0, dd1, dd2, out0, out1, out2, kind0, kind1, kind2, axis0,
                            axis1, axis2, power0, power1, power2);
  const float2* S = static_cast<const float2*>(spectrum);
  const float2* W = static_cast<const float2*>(roots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t limit = 227 * 1024;  // what one block may opt in to on sm_90
  if (zfuse_smem(nz, 32) <= limit)
    return launch<32>(S, W, k2z, k2y, k2x, ops, nz, ny, nxr, c_ref_dt_2, use_kappa,
                      zfuse_smem(nz, 32), s);
  if (zfuse_smem(nz, 16) <= limit)
    return launch<16>(S, W, k2z, k2y, k2x, ops, nz, ny, nxr, c_ref_dt_2, use_kappa,
                      zfuse_smem(nz, 16), s);
  if (zfuse_smem(nz, 8) <= limit)
    return launch<8>(S, W, k2z, k2y, k2x, ops, nz, ny, nxr, c_ref_dt_2, use_kappa,
                     zfuse_smem(nz, 8), s);
  return (int)cudaErrorInvalidValue;
}

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

// The mixed-radix kernel: n_passes radices r0.. (the rest ignored), each 2, 3, 4, 5, 7, 8
// or 16, whose product is nz; bins[p] (int16) the bin position p holds after the forward
// passes. cudaErrorInvalidValue for any other plan, or where the tiles do not fit.
int kw_zfuse_mixed(const void* spectrum, const void* roots, const void* bins, const float* k2z,
                   const float* k2y, const float* k2x, const void* dd0, const void* dd1,
                   const void* dd2, void* out0, void* out1, void* out2, int nz, int ny, int nxr,
                   int n_ops, int kind0, int kind1, int kind2, int axis0, int axis1, int axis2,
                   float power0, float power1, float power2, float c_ref_dt_2, int use_kappa,
                   int n_passes, int r0, int r1, int r2, int r3, int r4, int r5, int r6,
                   void* stream) {
  if (n_ops < 1 || n_ops > kMaxOps || n_passes < 1 || n_passes > kMaxPasses)
    return (int)cudaErrorInvalidValue;
  MixedPlan plan;
  plan.n = n_passes;
  const int radices[kMaxPasses] = {r0, r1, r2, r3, r4, r5, r6};
  int product = 1;
  for (int i = 0; i < kMaxPasses; ++i) {
    plan.r[i] = radices[i];
    if (i >= n_passes) continue;
    const int r = radices[i];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8 && r != 16)
      return (int)cudaErrorInvalidValue;
    product *= r;
  }
  const int tc = mixed_tc(nz, n_ops, n_passes);
  if (product != nz || mixed_smem(nz, tc, n_ops, n_passes) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const ZOps ops = make_ops(n_ops, dd0, dd1, dd2, out0, out1, out2, kind0, kind1, kind2, axis0,
                            axis1, axis2, power0, power1, power2);
  const float2* S = static_cast<const float2*>(spectrum);
  const float2* W = static_cast<const float2*>(roots);
  const short* B = static_cast<const short*>(bins);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc == 32)
    return launch_mixed<32>(S, W, B, k2z, k2y, k2x, ops, plan, nz, ny, nxr, c_ref_dt_2,
                            use_kappa, s);
  if (tc == 16)
    return launch_mixed<16>(S, W, B, k2z, k2y, k2x, ops, plan, nz, ny, nxr, c_ref_dt_2,
                            use_kappa, s);
  return launch_mixed<8>(S, W, B, k2z, k2y, k2x, ops, plan, nz, ny, nxr, c_ref_dt_2, use_kappa,
                         s);
}

}  // extern "C"
