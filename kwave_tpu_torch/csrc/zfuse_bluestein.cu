// The fused z stage's Bluestein kernel (see zfuse.cuh for the function and the layout),
// for every nz that the radix and mixed kernels do not take (127, 251, 1009, 1709, ...).

#include "zfuse.cuh"

namespace {

// Every nz (prime factors the mixed kernel does not take: 127, 251, 1009, 1709, ...), with
// w_n = exp(-i*pi*(n^2 mod 2nz)/nz) from the host's float64 table (pi*n^2/nz in fp32 would
// lose the digits at n ~ 1700):
//   F_k = w_k * sum_n (S_n w_n) conj(w_(k-n));
//   out_n = conj(w_n) * sum_k (G_k conj(w_k)) w_(n-k),  G = F * op / nz.
// Each sum is a circular convolution of length M >= 2nz - 1 whose plan the mixed passes
// take (radices in registers only): the input zero-padded to M in an M x TC tile, the
// mixed forward passes (digit-reversed order), a multiply by the filter's transform at the
// bin each position holds (filt = FFT_M(c)/M, c_j = c_(M-j) = w_j for j < nz: the 1/M is
// in the table; conj(filt) for the forward sum, since c is even), the mixed inverse passes
// (natural order), the first nz kept. F stays in an nz x TC tile while each op runs its
// own convolution in the M tile. The chirp, the filter and the bin table are read through
// the cache from device memory, as k2z is; only the M roots are staged. A pass of the loop
// below is the forward transform (ph == 0) or one op's inverse, so that each pass of the
// FFT appears once in the code. Four FFTs of M a column for one op, two more an op: bound
// by the bytes it moves as the mixed kernel is, at about twice its shared-memory traffic.
template <int TC>
__global__ void __launch_bounds__(kThreads, kMixedBlocks)
zfuse_bluestein_kernel(const float2* __restrict__ S, const float2* __restrict__ roots_g,
                       const short* __restrict__ bins, const float2* __restrict__ chirp,
                       const float2* __restrict__ filt, const float* __restrict__ k2z,
                       const float* __restrict__ k2y, const float* __restrict__ k2x, ZOps ops,
                       MixedPlan plan, int nz, int m, int ny, int nxr, float c_ref_dt_2,
                       int use_kappa) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the M roots; the M x TC convolution tile; the nz x TC tile of F
  float2* roots = reinterpret_cast<float2*>(smem_raw);
  float2* tile_m = roots + m;
  float2* tile_x = tile_m + (size_t)m * TC;
  const size_t C = (size_t)ny * nxr;
  const size_t c0 = (size_t)blockIdx.x * TC;
  const float inv_nz = 1.0f / (float)nz;

  for (int j = threadIdx.x; j < m; j += kThreads) roots[j] = roots_g[j];
  // every element a thread takes in the steps between the passes is of one column
  // (kThreads is a multiple of TC): row n of the tiles at n0, n0 + rows, ...
  const int col = threadIdx.x % TC, n0 = threadIdx.x / TC, rows = kThreads / TC;
  const bool live = c0 + col < C;
  int y = 0, x = 0;
  float k2yx = 0.f;
  if (live) {
    column_yx(c0 + col, nxr, y, x);
    k2yx = k2y[y] + k2x[x];
  }
  for (int ph = 0; ph <= ops.n_ops; ++ph) {
    const int op = ph - 1;
    // the convolution's input: S_n w_n, or G_k conj(w_k); 0 from nz on and past the edge
    for (int n = n0; n < m; n += rows) {
      float2 v = make_float2(0.f, 0.f);
      if (n < nz && live) {
        const float2 w = chirp[n];
        if (ph == 0) {
          v = cmul(S[(size_t)n * C + c0 + col], w);
        } else {
          float2 g = op_value(ops, op, n, y, x, k2z[n] + k2yx, c_ref_dt_2, use_kappa);
          g.x *= inv_nz;
          g.y *= inv_nz;
          v = cmul(cmul(tile_x[n * TC + col], g), make_float2(w.x, -w.y));
        }
      }
      tile_m[n * TC + col] = v;
    }
    __syncthreads();
    int L = m;
    for (int i = 0; i < plan.n; ++i) {
      const int r = plan.r[i];
#define KW_FORWARD(R) mixed_forward_pass<R, TC>(S, C, c0, tile_m, roots, m, L, false)
      KW_BY_RADIX(KW_FORWARD)
#undef KW_FORWARD
      __syncthreads();
      L /= r;
    }
    for (int n = n0; n < m; n += rows) {
      float2 f = filt[bins[n]];
      if (ph == 0) f.y = -f.y;
      tile_m[n * TC + col] = cmul(tile_m[n * TC + col], f);
    }
    __syncthreads();
    L = plan.r[plan.n - 1];
    for (int i = plan.n - 1; i >= 0; --i) {
      const int r = plan.r[i];
#define KW_INVERSE(R) \
  mixed_inverse_pass<R, TC>(tile_m, tile_m, nullptr, C, c0, roots, m, L, false, false, PassOp{})
      KW_BY_RADIX(KW_INVERSE)
#undef KW_INVERSE
      __syncthreads();
      if (i > 0) L *= plan.r[i - 1];
    }
    // F_k = w_k * conv_k into its tile, or out_n = conj(w_n) * conv_n to the output
    for (int n = n0; n < nz; n += rows) {
      const float2 w = chirp[n];
      if (ph == 0) {
        tile_x[n * TC + col] = cmul(tile_m[n * TC + col], w);
      } else if (live) {
        ops.out[op][(size_t)n * C + c0 + col] = cmul(tile_m[n * TC + col], make_float2(w.x, -w.y));
      }
    }
    __syncthreads();
  }
}
#undef KW_BY_RADIX

// Shared memory of the Bluestein kernel: the M roots, the M tile and the nz tile.
size_t bluestein_smem(int nz, int m, int tc) {
  return ((size_t)(m + nz) * tc + m) * sizeof(float2);
}

// Columns of a tile: the widest of 32, 16, 8 and 4 whose shared memory lets kMixedBlocks
// blocks share an SM, else two, else one; 0 where not even 4 columns fit.
int bluestein_tc(int nz, int m) {
  for (int blocks = kMixedBlocks; blocks >= 1; --blocks)
    for (int tc = 32; tc >= 4; tc /= 2)
      if (blocks * (bluestein_smem(nz, m, tc) + 1024) <= 228 * 1024) return tc;
  return 0;
}

template <int TC>
int launch_bluestein(const float2* S, const float2* roots, const short* bins, const float2* chirp,
                     const float2* filt, const float* k2z, const float* k2y, const float* k2x,
                     const ZOps& ops, const MixedPlan& plan, int nz, int m, int ny, int nxr,
                     float c_ref_dt_2, int use_kappa, cudaStream_t s) {
  const size_t smem = bluestein_smem(nz, m, TC);
  cudaError_t err = cudaFuncSetAttribute(zfuse_bluestein_kernel<TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t C = (size_t)ny * nxr;
  const unsigned blocks = (unsigned)((C + TC - 1) / TC);
  zfuse_bluestein_kernel<TC><<<blocks, kThreads, smem, s>>>(S, roots, bins, chirp, filt, k2z, k2y,
                                                            k2x, ops, plan, nz, m, ny, nxr,
                                                            c_ref_dt_2, use_kappa);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError (0 = cudaSuccess): of the shared-memory opt-in, or
// cudaGetLastError() after the launch.

// The Bluestein kernel: m >= 2nz - 1 and its n_passes radices r0.. (the rest ignored), each
// 2, 3, 4, 5, 7, 8, 11, 13 or 16, whose product is m; m_roots [m], bins [m] (int16) and filt
// [m] of the plan of m, chirp [nz] (see the kernel). cudaErrorInvalidValue for any other
// plan, or where not even a tile of 4 columns fits.
int kw_zfuse_bluestein(const void* spectrum, const void* m_roots, const void* bins,
                       const void* chirp, const void* filt, const float* k2z, const float* k2y,
                       const float* k2x, const void* dd0, const void* dd1, const void* dd2,
                       void* out0, void* out1, void* out2, int nz, int ny, int nxr, int n_ops,
                       int kind0, int kind1, int kind2, int axis0, int axis1, int axis2,
                       float power0, float power1, float power2, float c_ref_dt_2,
                       int use_kappa, int m, int n_passes, int r0, int r1, int r2, int r3,
                       int r4, int r5, int r6, void* stream) {
  const int radices[kMaxPasses] = {r0, r1, r2, r3, r4, r5, r6};
  MixedPlan plan;
  if (n_ops < 1 || n_ops > kMaxOps || nz < 1 || m < 2 * nz - 1 ||
      !make_mixed_plan(n_passes, radices, m, false, &plan))
    return (int)cudaErrorInvalidValue;
  const int tc = bluestein_tc(nz, m);
  if (tc == 0) return (int)cudaErrorInvalidValue;
  const ZOps ops = make_ops(n_ops, dd0, dd1, dd2, out0, out1, out2, kind0, kind1, kind2, axis0,
                            axis1, axis2, power0, power1, power2);
  const float2* S = static_cast<const float2*>(spectrum);
  const float2* W = static_cast<const float2*>(m_roots);
  const short* B = static_cast<const short*>(bins);
  const float2* Wn = static_cast<const float2*>(chirp);
  const float2* Fm = static_cast<const float2*>(filt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KW_LAUNCH(T)                                                                          \
  if (tc == T)                                                                                \
  return launch_bluestein<T>(S, W, B, Wn, Fm, k2z, k2y, k2x, ops, plan, nz, m, ny, nxr,      \
                             c_ref_dt_2, use_kappa, s)
  KW_LAUNCH(32);
  KW_LAUNCH(16);
  KW_LAUNCH(8);
#undef KW_LAUNCH
  return launch_bluestein<4>(S, W, B, Wn, Fm, k2z, k2y, k2x, ops, plan, nz, m, ny, nxr,
                             c_ref_dt_2, use_kappa, s);
}

}  // extern "C"
