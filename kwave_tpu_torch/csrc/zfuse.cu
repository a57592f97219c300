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
// Design: the TPU version does each contraction as a three-pass bf16 split on its matrix
// unit, because that compiler has no fp32 matmul, and holds the [nz, nz] matrices in fast
// memory. Here the contraction is a dense DFT in fp32 FMAs. A block of 256 threads takes a
// tile of TC columns and stages S for it in shared memory as re/im planes [nz][TC]. The
// [nz, nz] matrix (512 KB at nz = 256) does not fit, so only the nz roots of unity are
// staged and entry (k, z) is roots[(k*z) mod nz], the index advanced by k per z step. A
// thread accumulates 8 output bins x 4 columns in registers (128 FMAs per 10 shared loads),
// writes F to a second tile, and then per operator: all threads form G = F * op into the
// first tile (S is no longer needed), and the same contraction with the conjugate roots
// writes the output. Any nz (it is a DFT, not a radix FFT); the ragged last tile is
// zero-filled on load and masked on store. Two tiles of nz*TC complex need more than
// 48 KB, so the launcher opts in to the dynamic shared memory it asks for.
//
// What bounds it on the H100: operations. One forward and one inverse are 16*nz^2*C flop
// (35 GFLOP at 256^3) against 2*nz*C*8 B moved (135 MB), so it is compute-bound in
// fp32 outside the tensor cores; an FFT of the same columns would be memory-bound.

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
        const float k2 = k2z[k] + (k2y[y] + k2x[x]);
        const float f_re = b_re[e], f_im = b_im[e];
        if (ops.kind[op] == 0) {
          const int at = ops.axis[op] == 0 ? k : (ops.axis[op] == 1 ? y : x);
          float2 d = ops.dd[op][at];
          if (use_kappa) {
            const float arg = c_ref_dt_2 * sqrtf(k2);
            const float kappa = arg == 0.f ? 1.f : sinf(arg) / arg;
            d.x *= kappa;
            d.y *= kappa;
          }
          g_re = f_re * d.x - f_im * d.y;
          g_im = f_re * d.y + f_im * d.x;
        } else {
          const float kmag = sqrtf(k2);
          const float o = kmag == 0.f ? 0.f : powf(kmag, ops.power[op]);
          g_re = f_re * o;
          g_im = f_im * o;
        }
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

}  // namespace

extern "C" {

// Returns a cudaError (0 = cudaSuccess): of the shared-memory opt-in, or
// cudaGetLastError() after the launch; cudaErrorInvalidValue when no tile width fits.
int kw_zfuse(const void* spectrum, const void* roots, const float* k2z, const float* k2y,
             const float* k2x, const void* dd0, const void* dd1, const void* dd2, void* out0,
             void* out1, void* out2, int nz, int ny, int nxr, int n_ops, int kind0, int kind1,
             int kind2, int axis0, int axis1, int axis2, float power0, float power1,
             float power2, float c_ref_dt_2, int use_kappa, void* stream) {
  if (n_ops < 1 || n_ops > kMaxOps || nz < 1) return (int)cudaErrorInvalidValue;
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

}  // extern "C"
