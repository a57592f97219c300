// The fused z stage's Bluestein kernel (zfuse_bluestein.cuh): its entry, and its tiles of 32
// columns.

#include "zfuse_bluestein.cuh"

int kw_blue::launch_tc32(const kw_blue::Args& a) { return launch_bluestein<32>(a); }

extern "C" {

// Returns a cudaError (0 = cudaSuccess): of the shared-memory opt-in, or
// cudaGetLastError() after the launch.
//
// The Bluestein kernel: an even m >= 2nz and its n_passes >= 2 radices r0.. (the rest
// ignored), each 2, 3, 4, 5, 7, 8, 11, 13 or 16 and r0 a power of two, whose product is
// m; m_roots [m] and filt [m] (position order) of the plan of m, chirp [nz] (see the
// kernel); tc columns a tile (32, 16, 8, 4 or 2) and the staged tables (bits: 1 filter,
// 2 chirp, 4 k2z) as ops.zfuse.bluestein_tile gives them. cudaErrorInvalidValue for any
// other plan, or where its shared memory exceeds a block's 227 KB.
int kw_zfuse_bluestein(const void* spectrum, const void* m_roots, const void* chirp,
                       const void* filt, const float* k2z, const float* k2y, const float* k2x,
                       const void* dd0, const void* dd1, const void* dd2, void* out0,
                       void* out1, void* out2, int nz, int ny, int nxr, int n_ops, int kind0,
                       int kind1, int kind2, int axis0, int axis1, int axis2, float power0,
                       float power1, float power2, float c_ref_dt_2, int use_kappa, int m,
                       int n_passes, int r0, int r1, int r2, int r3, int r4, int r5, int r6,
                       int tc, int staged, void* stream) {
  const int radices[kMaxPasses] = {r0, r1, r2, r3, r4, r5, r6};
  MixedPlan plan;
  if (n_ops < 1 || n_ops > kMaxOps || nz < 1 || m < 2 * nz || m % 2 || n_passes < 2 ||
      !(r0 == 2 || r0 == 4 || r0 == 8 || r0 == 16) || staged < 0 || staged > 7 ||
      !make_mixed_plan(n_passes, radices, m, false, &plan))
    return (int)cudaErrorInvalidValue;
  BluePlan bp;
  bp.n = n_passes;
  bp.m = m;
  bp.nz = nz;
  for (int i = 0, L = m; i < kMaxPasses; ++i) {
    bp.r[i] = plan.r[i];
    bp.lr[i] = bp.stride[i] = 1;
    if (i >= n_passes) continue;
    bp.stride[i] = m / L;
    L /= plan.r[i];
    bp.lr[i] = L;
  }
  // the rows' swizzle where a 128-byte line holds several rows and the last radix is a
  // power of two (then so is M, as ops.zfuse orders the passes)
  const int r_last = plan.r[n_passes - 1];
  bp.swz_shift = 0;
  bp.swz_mask = 0;
  if (tc < 16 && r_last % 2 == 0 && m % (16 / tc) == 0) {
    while ((1 << bp.swz_shift) < r_last) ++bp.swz_shift;
    bp.swz_mask = 16 / tc - 1;
  }
  kw_blue::Args a{static_cast<const float2*>(spectrum), static_cast<const float2*>(m_roots),
                  static_cast<const float2*>(chirp), static_cast<const float2*>(filt), k2z, k2y,
                  k2x, {dd0, dd1, dd2}, {out0, out1, out2}, {kind0, kind1, kind2},
                  {axis0, axis1, axis2}, {power0, power1, power2}, n_ops, ny, nxr, use_kappa,
                  staged, c_ref_dt_2, bp, static_cast<cudaStream_t>(stream)};
  switch (tc) {
    case 32: return kw_blue::launch_tc32(a);
    case 16: return kw_blue::launch_tc16(a);
    case 8: return kw_blue::launch_tc8(a);
    case 4: return kw_blue::launch_tc4(a);
    case 2: return kw_blue::launch_tc2(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
