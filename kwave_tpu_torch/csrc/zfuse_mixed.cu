// The fused z stage's mixed-radix kernel (see zfuse.cuh for the function and the layout).
//
// zfuse_mixed_kernel<TC> (every nz from 2 to 1709 but the radix kernel's whose prime factors
// are at most 13, or all but one prime from 17 to ops.zfuse.PRIME_MAX: 6, 176, 192, 230,
// 384, ...): the radix kernel's FFT with the pass plan a runtime argument (up to seven
// radices from 2, 3, 4, 5, 7, 8, 11, 13, 16; the power-of-two part first, then each odd
// factor a pass of its own; the one larger prime a generic pass first), so one
// instantiation per tile width serves every such nz. Each pass switches, uniformly across
// the block, on its radix to a butterfly in registers: the radix kernel's for 2..16, and a
// DFT over the sums and differences of the pairs (m, R - m) with constant cos/sin for 3, 5,
// 7, 11 and 13. The generic pass takes its prime at run time and reads its roots from the
// staged ones. The first pass loads from global memory, the last stores to it, and the bin
// each position holds comes from the plan's int16 table (read through the cache, as k2z
// is, so that two tiles and the roots fit up to nz = 1709). The first inverse pass builds
// each op's operator as it reads, as the radix kernel does, where its radix is at most 7;
// a wider one gets F times the operator from a step of its own (built inside butterflies
// of radix 8 to 16 the operator made the kernel spill under its register cap and this
// source the build's longest). Bound by bytes as the radix kernel; its registers are
// capped so that three blocks share an SM, and the tile is the widest (32, 16 or 8
// columns) whose shared memory lets them.

#include "zfuse.cuh"

namespace {

// The generic pass of an odd prime p as the first forward pass (L = nz, LR = nz/p):
// butterfly j takes positions j + m*LR of src and leaves output q, times w_nz^(q*j), at
// j + q*LR of dst. It cannot work in place, since every output reads all p inputs. A
// thread takes one column of one butterfly and either output 0 or the pair (q, p - q), from
// the sums and differences of the input pairs (m, p - m) as fft_odd does; the root of q*m
// is read from the staged roots at the exact index ((q*m) mod p)*LR (no sincosf).
template <int TC>
__device__ __forceinline__ void generic_forward_pass(const float2* src, float2* dst,
                                                     const float2* roots, int nz, int p) {
  const int LR = nz / p, H = (p - 1) / 2;
  for (int b = threadIdx.x; b < LR * (H + 1) * TC; b += kThreads) {
    const int col = b % TC, t = b / TC;
    const int j = t % LR, q = t / LR;
    const float2* in = src + j * TC + col;  // input m at in[m * LR * TC]
    if (q == 0) {
      float2 sum = in[0];
      for (int m = 1; m < p; ++m) {
        const float2 v = in[m * LR * TC];
        sum.x += v.x;
        sum.y += v.y;
      }
      dst[j * TC + col] = sum;
      continue;
    }
    float2 a = in[0], d = make_float2(0.f, 0.f);
    for (int m = 1, k = q; m <= H; ++m, k = k + q >= p ? k + q - p : k + q) {
      const float2 u = in[m * LR * TC], w = in[(p - m) * LR * TC];
      const float2 root = roots[k * LR];  // cos and -sin of 2*pi*k/p
      a.x = fmaf(root.x, u.x + w.x, a.x);
      a.y = fmaf(root.x, u.y + w.y, a.y);
      d.x = fmaf(-root.y, u.x - w.x, d.x);
      d.y = fmaf(-root.y, u.y - w.y, d.y);
    }
    // output q = a - i*d, output p - q = a + i*d, each times its twiddle
    const float2 lo = cmul(make_float2(a.x + d.y, a.y - d.x), roots[q * j]);
    const float2 hi = cmul(make_float2(a.x - d.y, a.y + d.x), roots[(p - q) * j]);
    dst[(j + q * LR) * TC + col] = lo;
    dst[(j + (p - q) * LR) * TC + col] = hi;
  }
}

// Input m of butterfly j of the generic inverse pass: src times conj(w_nz^(m*j)).
__device__ __forceinline__ float2 untwiddled(const float2* in, int m, int j, int LR, int TC,
                                             const float2* roots) {
  const float2 w = roots[m * j];
  return cmul(in[m * LR * TC], make_float2(w.x, -w.y));
}

// The generic forward pass undone, as the last inverse pass: each input times its conjugate
// twiddle as it is read, the conjugate butterfly, the outputs stored to out, ragged edge
// masked.
template <int TC>
__device__ __forceinline__ void generic_inverse_pass(const float2* src, float2* __restrict__ out,
                                                     size_t C, size_t c0, const float2* roots,
                                                     int nz, int p) {
  const int LR = nz / p, H = (p - 1) / 2;
  for (int b = threadIdx.x; b < LR * (H + 1) * TC; b += kThreads) {
    const int col = b % TC, t = b / TC;
    const int j = t % LR, q = t / LR;
    if (c0 + col >= C) continue;
    const float2* in = src + j * TC + col;
    float2* to = out + c0 + col;
    if (q == 0) {
      float2 sum = in[0];
      for (int m = 1; m < p; ++m) {
        const float2 v = untwiddled(in, m, j, LR, TC, roots);
        sum.x += v.x;
        sum.y += v.y;
      }
      to[(size_t)j * C] = sum;
      continue;
    }
    float2 a = in[0], d = make_float2(0.f, 0.f);
    for (int m = 1, k = q; m <= H; ++m, k = k + q >= p ? k + q - p : k + q) {
      const float2 u = untwiddled(in, m, j, LR, TC, roots);
      const float2 w = untwiddled(in, p - m, j, LR, TC, roots);
      const float2 root = roots[k * LR];
      a.x = fmaf(root.x, u.x + w.x, a.x);
      a.y = fmaf(root.x, u.y + w.y, a.y);
      d.x = fmaf(-root.y, u.x - w.x, d.x);
      d.y = fmaf(-root.y, u.y - w.y, d.y);
    }
    to[(size_t)(j + q * LR) * C] = make_float2(a.x - d.y, a.y + d.x);        // a + i*d
    to[(size_t)(j + (p - q) * LR) * C] = make_float2(a.x + d.y, a.y - d.x);  // a - i*d
  }
}

// The spectrum's tile of TC columns into shared memory, the ragged last tile zero-filled.
template <int TC>
__device__ __forceinline__ void load_tile(const float2* __restrict__ S, size_t C, size_t c0,
                                          float2* tile, int nz) {
  for (int e = threadIdx.x; e < nz * TC; e += kThreads) {
    const int z = e / TC, col = e - z * TC;
    tile[e] = c0 + col < C ? S[(size_t)z * C + c0 + col] : make_float2(0.f, 0.f);
  }
}

// Any nz whose plan the host checked: radices from 2, 3, 4, 5, 7, 8, 11, 13, 16, and
// perhaps a generic pass of an odd prime first.
//
// Without a generic pass, tile F (the forward transform) is worked in place, the first
// pass reading the spectrum. Each op's inverse runs in the second tile (F's own with one
// op and no generic pass): its first pass reads F and the operator, or a step writes F
// times the operator there first; the last pass stores the output. With a generic pass
// the spectrum is staged in the second tile, the generic pass writes F to the first, and
// the generic pass is undone last, from the second tile to the output.
template <int TC>
__global__ void __launch_bounds__(kThreads, kMixedBlocks)
zfuse_mixed_kernel(const float2* __restrict__ S, const float2* __restrict__ roots_g,
                   const short* __restrict__ bins, const float* __restrict__ k2z,
                   const float* __restrict__ k2y, const float* __restrict__ k2x, ZOps ops,
                   MixedPlan plan, int nz, int ny, int nxr, float c_ref_dt_2, int use_kappa) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bool generic = !in_registers(plan.r[0]);
  // the roots; tile F; a second tile with a generic pass or several ops
  float2* roots = reinterpret_cast<float2*>(smem_raw);
  float2* tile_f = roots + nz;
  float2* tile_w = generic || ops.n_ops > 1 ? tile_f + (size_t)nz * TC : tile_f;
  const size_t C = (size_t)ny * nxr;
  const size_t c0 = (size_t)blockIdx.x * TC;

  for (int j = threadIdx.x; j < nz; j += kThreads) roots[j] = roots_g[j];
  const int i0 = generic ? 1 : 0;  // the first pass in registers
  int L = nz;
  if (generic) {
    load_tile<TC>(S, C, c0, tile_w, nz);
    __syncthreads();
    generic_forward_pass<TC>(tile_w, tile_f, roots, nz, plan.r[0]);
    L /= plan.r[0];
  }
  __syncthreads();
  for (int i = i0; i < plan.n; ++i) {
    const int r = plan.r[i];
#define KW_FORWARD(R) mixed_forward_pass<R, TC>(S, C, c0, tile_f, roots, nz, L, i == 0)
    KW_BY_RADIX(KW_FORWARD)
#undef KW_FORWARD
    __syncthreads();
    L /= r;
  }

  // every element a thread takes below is of one column: kThreads is a multiple of TC
  const int col = threadIdx.x % TC;
  const bool live = c0 + col < C;
  int y = 0, x = 0;
  float k2yx = 0.f;
  if (live) {
    column_yx(c0 + col, nxr, y, x);
    k2yx = k2y[y] + k2x[x];
  }
  const float inv_nz = 1.0f / (float)nz;
  // the operator in the first inverse pass where its radix lets it (see PassOp), else in a
  // step of its own
  const int r_first = plan.r[plan.n - 1];
  const bool op_in_pass = plan.n > i0 && r_first <= kOpInPassMax;
  PassOp pass_op{&ops, 0, nxr, bins, k2z, k2y, k2x, c_ref_dt_2, inv_nz, use_kappa};
  for (int op = 0; op < ops.n_ops; ++op) {
    float2* __restrict__ out = ops.out[op];
    pass_op.op = op;
    if (!op_in_pass) {  // G = F * op / nz into the second tile (in place with one tile)
      for (int z = threadIdx.x / TC; z < nz; z += kThreads / TC) {
        float2 g = make_float2(0.f, 0.f);
        if (live)
          g = cmul(tile_f[z * TC + col], op_over_nz(ops, op, bins[z], y, x, k2z, k2yx,
                                                    c_ref_dt_2, use_kappa, inv_nz));
        tile_w[z * TC + col] = g;
      }
      __syncthreads();
    }
    L = r_first;
    for (int i = plan.n - 1; i >= i0; --i) {
      const int r = plan.r[i];
      const bool first = i == plan.n - 1;
#define KW_INVERSE(R)                                                                       \
  mixed_inverse_pass<R, TC>(first && op_in_pass ? tile_f : tile_w, tile_w, out, C, c0, roots, nz, \
                            L, i == 0, first && op_in_pass, pass_op)
      KW_BY_RADIX(KW_INVERSE)
#undef KW_INVERSE
      if (i > 0) {
        __syncthreads();
        L *= plan.r[i - 1];
      }
    }
    if (generic) generic_inverse_pass<TC>(tile_w, out, C, c0, roots, nz, plan.r[0]);
    __syncthreads();  // the second tile is overwritten by the next operator
  }
}

// Shared memory of the mixed kernel: the roots and one tile, two with a generic pass or
// several ops.
size_t mixed_smem(int nz, int tc, int n_ops, bool generic) {
  const size_t tiles = generic || n_ops > 1 ? 2 : 1;
  return (tiles * nz * tc + nz) * sizeof(float2);
}

// Columns of a tile: the widest of 32, 16 and 8 whose shared memory lets kMixedBlocks
// blocks share an SM's 228 KB (1 KB of it reserved a block), else 8.
int mixed_tc(int nz, int n_ops, bool generic) {
  for (int tc = 32; tc > 8; tc /= 2)
    if (kMixedBlocks * (mixed_smem(nz, tc, n_ops, generic) + 1024) <= 228 * 1024)
      return tc;
  return 8;
}

template <int TC>
int launch_mixed(const float2* S, const float2* roots, const short* bins, const float* k2z,
                 const float* k2y, const float* k2x, const ZOps& ops, const MixedPlan& plan,
                 int nz, int ny, int nxr, float c_ref_dt_2, int use_kappa, size_t smem,
                 cudaStream_t s) {
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

}  // namespace

extern "C" {

// Each returns a cudaError (0 = cudaSuccess): of the shared-memory opt-in, or
// cudaGetLastError() after the launch.

// The mixed-radix kernel: n_passes radices r0.. (the rest ignored), each 2, 3, 4, 5, 7, 8,
// 11, 13 or 16 but r0, which may be an odd prime from 17 (the generic pass), whose product
// is nz; bins[p] (int16) the bin position p holds after the forward passes.
// cudaErrorInvalidValue for any other plan, or where the tiles do not fit.
int kw_zfuse_mixed(const void* spectrum, const void* roots, const void* bins, const float* k2z,
                   const float* k2y, const float* k2x, const void* dd0, const void* dd1,
                   const void* dd2, void* out0, void* out1, void* out2, int nz, int ny, int nxr,
                   int n_ops, int kind0, int kind1, int kind2, int axis0, int axis1, int axis2,
                   float power0, float power1, float power2, float c_ref_dt_2, int use_kappa,
                   int n_passes, int r0, int r1, int r2, int r3, int r4, int r5, int r6,
                   void* stream) {
  const int radices[kMaxPasses] = {r0, r1, r2, r3, r4, r5, r6};
  MixedPlan plan;
  if (n_ops < 1 || n_ops > kMaxOps || !make_mixed_plan(n_passes, radices, nz, true, &plan))
    return (int)cudaErrorInvalidValue;
  const bool generic = !in_registers(r0);
  const int tc = mixed_tc(nz, n_ops, generic);
  const size_t smem = mixed_smem(nz, tc, n_ops, generic);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const ZOps ops = make_ops(n_ops, dd0, dd1, dd2, out0, out1, out2, kind0, kind1, kind2, axis0,
                            axis1, axis2, power0, power1, power2);
  const float2* S = static_cast<const float2*>(spectrum);
  const float2* W = static_cast<const float2*>(roots);
  const short* B = static_cast<const short*>(bins);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc == 32)
    return launch_mixed<32>(S, W, B, k2z, k2y, k2x, ops, plan, nz, ny, nxr, c_ref_dt_2,
                            use_kappa, smem, s);
  if (tc == 16)
    return launch_mixed<16>(S, W, B, k2z, k2y, k2x, ops, plan, nz, ny, nxr, c_ref_dt_2,
                            use_kappa, smem, s);
  return launch_mixed<8>(S, W, B, k2z, k2y, k2x, ops, plan, nz, ny, nxr, c_ref_dt_2, use_kappa,
                         smem, s);
}

}  // extern "C"
