// The fused z stage's column kernel (see zfuse.cuh for the function and the layout).
//
// zfuse_column_kernel<NZ> (the short z lengths of ops.zfuse.COLUMN_NZ; built for every nz
// from 1 to 16): one thread a column. It loads the column's nz values (a warp's loads of
// one z are 32 adjacent columns), transforms them in registers (the butterflies of
// zfuse.cuh where nz is one of their radices, else two of them with the twiddles between,
// from the plan's roots), multiplies by each op's operator at the natural bin (kappa
// computed once a bin for all ops), transforms back and stores: no shared memory and no
// barrier. The mixed kernel's tiles keep (nz/R) x 32 of a block's 256 threads busy in a
// pass of radix R, 32 at nz = 4, and cross two or more barriers for ~2 KB of data; here
// every thread works from its first load. Bound by bytes: nz x (1 + ops) x 8 B a column.
// At nz = 1 (a grid of one z plane) both transforms are the identity.

#include "zfuse.cuh"

namespace {

constexpr int kColumnThreads = 64;

__host__ __device__ constexpr bool column_radix(int n) {
  return n == 2 || n == 3 || n == 4 || n == 5 || n == 7 || n == 8 || n == 11 || n == 13 ||
         n == 16;
}

// In registers, natural order in and out: v[k] <- sum_n v[n] w^(k*n), w = exp(-/+ 2*pi*i/N)
// (forward / inverse). N = 1 (nothing to do), one of the butterflies' radices, or A x B of
// two of them: with n = B*n1 + n2 and k = k1 + A*k2, a DFT of length A over n1 for each
// n2, the twiddle w^(n2*k1) (roots[j] = exp(-2*pi*i*j/N)), a DFT of length B over n2 for
// each k1.
template <int N, bool INV>
__device__ __forceinline__ void column_fft(float2 (&v)[N], const float2* __restrict__ roots) {
  if constexpr (N == 1) {
    return;
  } else if constexpr (column_radix(N)) {
    fft_any<N, INV>(v);
  } else {
    constexpr int A = N % 4 == 0 ? 4 : (N % 2 == 0 ? 2 : 3);
    constexpr int B = N / A;
    static_assert(column_radix(A) && column_radix(B), "a z length the column kernel lacks");
    float2 u[A][B];
#pragma unroll
    for (int n2 = 0; n2 < B; ++n2) {
      float2 t[A];
#pragma unroll
      for (int n1 = 0; n1 < A; ++n1) t[n1] = v[B * n1 + n2];
      fft_any<A, INV>(t);
#pragma unroll
      for (int k1 = 0; k1 < A; ++k1) {
        if (n2 * k1 == 0) {
          u[k1][n2] = t[k1];
        } else {
          const float2 w = __ldg(roots + n2 * k1);
          u[k1][n2] = cmul(t[k1], make_float2(w.x, INV ? -w.y : w.y));
        }
      }
    }
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) {
      fft_any<B, INV>(u[k1]);
#pragma unroll
      for (int k2 = 0; k2 < B; ++k2) v[k1 + A * k2] = u[k1][k2];
    }
  }
}

template <int NZ>
__global__ void __launch_bounds__(kColumnThreads)
zfuse_column_kernel(const float2* __restrict__ S, const float2* __restrict__ roots,
                    const float* __restrict__ k2z, const float* __restrict__ k2y,
                    const float* __restrict__ k2x, ZOps ops, int ny, int nxr, float c_ref_dt_2,
                    int use_kappa) {
  const size_t C = (size_t)ny * nxr;
  const size_t c = (size_t)blockIdx.x * kColumnThreads + threadIdx.x;
  if (c >= C) return;
  float2 f[NZ];
#pragma unroll
  for (int z = 0; z < NZ; ++z) f[z] = S[(size_t)z * C + c];
  column_fft<NZ, false>(f, roots);

  int y, x;
  column_yx(c, nxr, y, x);
  const float k2yx = k2y[y] + k2x[x];
  bool grad = false;
  for (int op = 0; op < ops.n_ops; ++op) grad = grad || ops.kind[op] == 0;
  float k2[NZ], kappa[NZ];  // |k|^2 and kappa at each bin, kappa once for all ops
#pragma unroll
  for (int k = 0; k < NZ; ++k) {
    k2[k] = k2z[k] + k2yx;
    kappa[k] = use_kappa && grad ? kappa_at(k2[k], c_ref_dt_2) : 1.f;
  }
  const float inv_nz = 1.0f / (float)NZ;
  for (int op = 0; op < ops.n_ops; ++op) {
    float2 g[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      float2 w = op_value_by(ops, op, k, y, x, k2[k], use_kappa, [&] { return kappa[k]; });
      w.x *= inv_nz;
      w.y *= inv_nz;
      g[k] = cmul(f[k], w);
    }
    column_fft<NZ, true>(g, roots);
    float2* __restrict__ out = ops.out[op];
#pragma unroll
    for (int z = 0; z < NZ; ++z) out[(size_t)z * C + c] = g[z];
  }
}

template <int NZ>
int launch_column(const float2* S, const float2* roots, const float* k2z, const float* k2y,
                  const float* k2x, const ZOps& ops, int ny, int nxr, float c_ref_dt_2,
                  int use_kappa, cudaStream_t s) {
  const size_t C = (size_t)ny * nxr;
  const unsigned blocks = (unsigned)((C + kColumnThreads - 1) / kColumnThreads);
  zfuse_column_kernel<NZ><<<blocks, kColumnThreads, 0, s>>>(S, roots, k2z, k2y, k2x, ops, ny,
                                                            nxr, c_ref_dt_2, use_kappa);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The column kernel: nz from 1 to 16 (cudaErrorInvalidValue for any other, or for n_ops
// outside 1..3); the arguments as kw_zfuse_radix's without the radices. Returns
// cudaGetLastError() after the launch.
int kw_zfuse_column(const void* spectrum, const void* roots, const float* k2z, const float* k2y,
                    const float* k2x, const void* dd0, const void* dd1, const void* dd2,
                    void* out0, void* out1, void* out2, int nz, int ny, int nxr, int n_ops,
                    int kind0, int kind1, int kind2, int axis0, int axis1, int axis2,
                    float power0, float power1, float power2, float c_ref_dt_2, int use_kappa,
                    void* stream) {
  if (n_ops < 1 || n_ops > kMaxOps) return (int)cudaErrorInvalidValue;
  const ZOps ops = make_ops(n_ops, dd0, dd1, dd2, out0, out1, out2, kind0, kind1, kind2, axis0,
                            axis1, axis2, power0, power1, power2);
  const float2* S = static_cast<const float2*>(spectrum);
  const float2* W = static_cast<const float2*>(roots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nz) {
#define KW_COLUMN(N) \
  case N:            \
    return launch_column<N>(S, W, k2z, k2y, k2x, ops, ny, nxr, c_ref_dt_2, use_kappa, s);
    KW_COLUMN(1) KW_COLUMN(2) KW_COLUMN(3) KW_COLUMN(4) KW_COLUMN(5) KW_COLUMN(6)
    KW_COLUMN(7) KW_COLUMN(8) KW_COLUMN(9) KW_COLUMN(10) KW_COLUMN(11) KW_COLUMN(12)
    KW_COLUMN(13) KW_COLUMN(14) KW_COLUMN(15) KW_COLUMN(16)
#undef KW_COLUMN
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
