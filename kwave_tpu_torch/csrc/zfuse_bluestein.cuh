// The fused z stage's Bluestein kernel (see zfuse.cuh for the function and the layout),
// for every nz that the radix and mixed kernels do not take (127, 251, 1009, 1709, ...).
// Its entry is in zfuse_bluestein.cu; each tile width is instantiated in a source of its
// own (zfuse_bluestein.cu: 32 columns, zfuse_bluestein_tc16.cu ... _tc2.cu), so that nvcc
// builds the five side by side: as one source the five made it the build's longest nvcc
// by far.
//
// Every nz (prime factors the mixed kernel does not take), with the chirp
// w_n = exp(-i*pi*(n^2 mod 2nz)/nz) from the host's float64 table (pi*n^2/nz in fp32 would
// lose the digits at n ~ 1700):
//   F_k = w_k conv_k,  conv_k = sum_n (S_n w_n) conj(w_(k-n));
//   out_n = conj(w_n) * sum_k (G_k conj(w_k)) w_(n-k),  G = F * op / nz,
// and G_k conj(w_k) = conv_k op_k / nz, so F is never formed. Each sum is a circular
// convolution of an even length M >= 2 nz (ops.zfuse.bluestein_length picks it by cost:
// 512 = 8*8*8 at nz = 251, 2048 = 16*16*8 at 1009) whose passes are butterflies in
// registers: the input zero-padded to M, the mixed forward passes (digit-reversed order),
// times the filter's transform at each position (filt = FFT_M(c)/M, c_j = c_(M-j) = w_j for
// j < nz, put in position order on the host; conj(filt) for the forward sum, since c is
// even), the mixed inverse passes (natural order), the first nz kept.
//
// The pointwise steps live inside the passes, so that a convolution of P passes is 2P - 1
// sweeps of the M x TC tile, each followed by one barrier:
// - the first forward pass (of the power-of-two radix r0, since M is even and its passes
//   take the power of two first) loads its inputs straight from the spectrum times the
//   chirp, or from the forward convolution's nz tile times the operator and 1/nz; inputs
//   r0/2 .. r0-1 of each butterfly lie at M/2 >= nz and up, so it loads half and runs a
//   butterfly with its upper half zero (`fwd_half`);
// - the last forward pass (LR = 1) and the first inverse one take the same r positions:
//   one pass runs both butterflies with the filter in between (`turn_pass`);
// - the last inverse pass computes only the lower half of each butterfly's outputs (the
//   upper half lies at M/2 and up, never kept: `inv_lower`), and stores the output times
//   conj(chirp) straight to the output, or the convolution to the nz tile; with one op it
//   runs on into the next convolution's first pass with the operator in between
//   (the bridge), in place, so one op needs neither the nz tile nor its sweeps.
// One op: 4P - 3 sweeps (9 at M = 512 and 2048); three ops: 4 (2P - 1).
//
// Shared memory: the M roots, the M x TC tile, the nz x TC tile of the forward convolution
// (several ops only) and, where they fit without costing a block an SM, the filter, the
// chirp and k2z (the rest are read through the cache); the host picks TC and the staged
// tables (ops.zfuse.bluestein_tile). Where TC < 16 a 128-byte line of the tile holds
// K = 16/TC rows, and the butterflies of the LR = 1 pass, R rows apart, would fall in one
// bank: row p is stored at p ^ ((p >> log2 R) & (K - 1)) when the last radix R is even, a
// permutation inside each line that spreads them. Each block walks over column tiles
// (grid = tiles or the blocks the card holds at once, the fewer), so the tables are staged
// once a block. Bound by the bytes of shared memory it moves: about (2P - 1) sweeps of M a
// convolution against the mixed kernel's 2P of nz, at fp32 throughout (no tensor cores:
// K7 stays within 2e-6 of a float64 FFT's peak).

#pragma once

#include "zfuse.cuh"

namespace kw_blue {

struct BluePlan {
  int n;                    // passes
  int r[kMaxPasses];        // radices, first pass first
  int lr[kMaxPasses];       // L / r of each pass (L = M / (r0 ... r_(i-1)))
  int stride[kMaxPasses];   // M / L: the roots' stride of each pass
  int m, nz;
  int swz_shift, swz_mask;  // the rows' swizzle (mask 0: none)
};

// One call's arguments, as kw_zfuse_bluestein checked them.
struct Args {
  const float2 *S, *roots, *chirp, *filt;
  const float *k2z, *k2y, *k2x;
  const void* dd[kMaxOps];
  void* out[kMaxOps];
  int kind[kMaxOps], axis[kMaxOps];
  float power[kMaxOps];
  int n_ops, ny, nxr, use_kappa, staged;
  float c_ref_dt_2;
  BluePlan bp;
  cudaStream_t stream;
};

// The launch at each tile width, each defined in its own source.
int launch_tc32(const Args& a);
int launch_tc16(const Args& a);
int launch_tc8(const Args& a);
int launch_tc4(const Args& a);
int launch_tc2(const Args& a);

}  // namespace kw_blue

namespace {

// Blocks an SM the registers are capped for (ops/zfuse.py BLUESTEIN_BLOCKS, which
// bluestein_tile reads).
constexpr int kBlueBlocks = 3;
constexpr int kStageFilt = 1, kStageChirp = 2, kStageK2z = 4;

using kw_blue::BluePlan;

// Row p of the M tile in shared memory (BluePlan's swizzle).
__device__ __forceinline__ int tile_row(int p, const BluePlan& bp) {
  return p ^ ((p >> bp.swz_shift) & bp.swz_mask);
}

// a * conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// o[K] *= exp(-/+ 2*pi*i*K/R) for K = 1 .. R/2 - 1
template <int K, int R, bool INV>
__device__ __forceinline__ void twiddle_half(float2 (&o)[R / 2]) {
  if constexpr (K < R / 2) {
    o[K] = mul_root<K, R, INV>(o[K]);
    twiddle_half<K + 1, R, INV>(o);
  }
}

// The forward DFT of R points whose upper half is zero, R a power of two: v[0 .. R/2 - 1]
// in, all R outputs out (natural order). Even outputs are the DFT of R/2 of the inputs, odd
// ones that of the inputs times w_R^m.
template <int R>
__device__ __forceinline__ void fwd_half(float2 (&v)[R]) {
  float2 e[R / 2], o[R / 2];
#pragma unroll
  for (int m = 0; m < R / 2; ++m) e[m] = o[m] = v[m];
  twiddle_half<1, R, false>(o);
  fft_reg<R / 2, false>(e);
  fft_reg<R / 2, false>(o);
#pragma unroll
  for (int q = 0; q < R / 2; ++q) {
    v[2 * q] = e[q];
    v[2 * q + 1] = o[q];
  }
}

// The lower half of the inverse DFT of R points, R a power of two: all R inputs in,
// outputs 0 .. R/2 - 1 in v[0 .. R/2 - 1].
template <int R>
__device__ __forceinline__ void inv_lower(float2 (&v)[R]) {
  float2 e[R / 2], o[R / 2];
#pragma unroll
  for (int k = 0; k < R / 2; ++k) {
    e[k] = v[2 * k];
    o[k] = v[2 * k + 1];
  }
  fft_reg<R / 2, true>(e);
  fft_reg<R / 2, true>(o);
  twiddle_half<1, R, true>(o);
#pragma unroll
  for (int m = 0; m < R / 2; ++m) v[m] = make_float2(e[m].x + o[m].x, e[m].y + o[m].y);
}

// What a thread's column of the current tile needs in the first and last passes.
struct BlueCol {
  const float2* S;       // the spectrum
  const float2* chirp;   // staged or global
  const float* k2z;      // staged or global
  float2* tile_x;        // the forward convolution's nz tile (several ops)
  float2* out;           // the op's output
  size_t C, c0;
  int col, y, x, op;
  bool live;
  float k2yx, inv_nz;
};

// The op's multiplier at the natural bin n, times 1/nz (0 past the edge).
__device__ __forceinline__ float2 op_over_nz_at(const ZOps& ops, const BlueCol& c, int n,
                                                float c_ref_dt_2, int use_kappa) {
  if (!c.live) return make_float2(0.f, 0.f);
  const float2 g = op_value(ops, c.op, n, c.y, c.x, c.k2z[n] + c.k2yx, c_ref_dt_2, use_kappa);
  return make_float2(g.x * c.inv_nz, g.y * c.inv_nz);
}

// Where a first pass reads, and where a last pass leaves its outputs.
enum BlueFirst { kFromSpectrum, kFromTileX };
enum BlueLast { kToTileX, kToOutput, kBridge };

// The first forward pass (L = M, LR = M/R, j = the butterfly): inputs m < R/2 at rows
// j + m*LR (0 from nz on): S_n w_n, or conv_n op_n / nz from the nz tile; the butterfly
// with its upper half zero; outputs times w_M^(q*j) to rows j + q*LR.
template <int R, int TC, BlueFirst FROM>
__device__ __forceinline__ void first_pass(float2* tile, const float2* roots, const BluePlan& bp,
                                           const ZOps& ops, const BlueCol& c, float c_ref_dt_2,
                                           int use_kappa) {
  const int LR = bp.m / R;
  for (int b = threadIdx.x; b < LR * TC; b += kThreads) {
    const int j = b / TC;
    float2 v[R];
#pragma unroll
    for (int m = 0; m < R / 2; ++m) {
      const int n = j + m * LR;
      float2 u = make_float2(0.f, 0.f);
      if (n < bp.nz) {
        if constexpr (FROM == kFromSpectrum) {
          if (c.live) u = cmul(c.S[(size_t)n * c.C + c.c0 + c.col], c.chirp[n]);
        } else {
          u = cmul(c.tile_x[n * TC + c.col], op_over_nz_at(ops, c, n, c_ref_dt_2, use_kappa));
        }
      }
      v[m] = u;
    }
    fwd_half<R>(v);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float2 w = q > 0 ? cmul(v[q], roots[q * j]) : v[q];
      tile[tile_row(j + q * LR, bp) * TC + c.col] = w;
    }
  }
}

// The last inverse pass (L = M): inputs at rows j + q*LR times conj(w_M^(q*j)), the lower
// half of the inverse butterfly (outputs n = j + m*LR, m < R/2), and for those n < nz:
// conv_n into the nz tile; or conj(w_n) conv_n to the output; or (the bridge, one op)
// conv_n op_n / nz (0 from nz on) on into the op's convolution: the forward butterfly
// with its upper half zero and the twiddles, back to the same rows, in place.
template <int R, int TC, BlueLast TO>
__device__ __forceinline__ void last_pass(float2* tile, const float2* roots, const BluePlan& bp,
                                          const ZOps& ops, const BlueCol& c, float c_ref_dt_2,
                                          int use_kappa) {
  const int LR = bp.m / R;
  for (int b = threadIdx.x; b < LR * TC; b += kThreads) {
    const int j = b / TC;
    float2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float2 u = tile[tile_row(j + q * LR, bp) * TC + c.col];
      v[q] = q > 0 ? cmulc(u, roots[q * j]) : u;
    }
    inv_lower<R>(v);
#pragma unroll
    for (int m = 0; m < R / 2; ++m) {
      const int n = j + m * LR;
      if constexpr (TO == kBridge) {
        v[m] = n < bp.nz ? cmul(v[m], op_over_nz_at(ops, c, n, c_ref_dt_2, use_kappa))
                         : make_float2(0.f, 0.f);
      } else if (n < bp.nz) {
        if constexpr (TO == kToTileX) {
          c.tile_x[n * TC + c.col] = v[m];
        } else if (c.live) {
          c.out[(size_t)n * c.C + c.c0 + c.col] = cmulc(v[m], c.chirp[n]);
        }
      }
    }
    if constexpr (TO == kBridge) {
      fwd_half<R>(v);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float2 w = q > 0 ? cmul(v[q], roots[q * j]) : v[q];
        tile[tile_row(j + q * LR, bp) * TC + c.col] = w;
      }
    }
  }
}

// A middle pass i (0 < i < n - 1) in place: forward (DIF, twiddles after) or inverse (DIT,
// conjugate twiddles before).
template <int R, int TC, bool INV>
__device__ __forceinline__ void mid_pass(float2* tile, const float2* roots, const BluePlan& bp,
                                         int i) {
  const int LR = bp.lr[i], stride = bp.stride[i];
  for (int b = threadIdx.x; b < (bp.m / R) * TC; b += kThreads) {
    const int col = b % TC, t = b / TC;
    const int j = t % LR;
    const int p0 = (t - j) * R + j;
    float2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float2 u = tile[tile_row(p0 + q * LR, bp) * TC + col];
      v[q] = INV && q > 0 ? cmulc(u, roots[q * j * stride]) : u;
    }
    fft_any<R, INV>(v);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float2 w = !INV && q > 0 ? cmul(v[q], roots[q * j * stride]) : v[q];
      tile[tile_row(p0 + q * LR, bp) * TC + col] = w;
    }
  }
}

// The last forward pass (LR = 1: rows t*R .. t*R + R - 1, no twiddles), the filter at each
// position (conjugated for the forward convolution), and the first inverse pass on the
// same rows, in place.
template <int R, int TC>
__device__ __forceinline__ void turn_pass(float2* tile, const float2* filt, const BluePlan& bp,
                                          bool conj_filt) {
  for (int b = threadIdx.x; b < (bp.m / R) * TC; b += kThreads) {
    const int col = b % TC, p0 = (b / TC) * R;
    float2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = tile[tile_row(p0 + q, bp) * TC + col];
    fft_any<R, false>(v);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float2 f = filt[p0 + q];
      v[q] = conj_filt ? cmulc(v[q], f) : cmul(v[q], f);
    }
    fft_any<R, true>(v);
#pragma unroll
    for (int q = 0; q < R; ++q) tile[tile_row(p0 + q, bp) * TC + col] = v[q];
  }
}

// One call of CALL(R) for a power-of-two radix r (the first and last passes').
#define KW_BY_EVEN_RADIX(CALL) \
  switch (r) {                 \
    case 2: CALL(2); break;    \
    case 4: CALL(4); break;    \
    case 8: CALL(8); break;    \
    case 16: CALL(16); break;  \
  }

// The passes between the first and the last of one convolution: the middle forward ones,
// the turn, the middle inverse ones, a barrier after each.
template <int TC>
__device__ __forceinline__ void middle(float2* tile, const float2* roots, const float2* filt,
                                       const BluePlan& bp, bool conj_filt) {
  for (int i = 1; i < bp.n - 1; ++i) {
    const int r = bp.r[i];
#define KW_FORWARD(R) mid_pass<R, TC, false>(tile, roots, bp, i)
    KW_BY_RADIX(KW_FORWARD)
#undef KW_FORWARD
    __syncthreads();
  }
  {
    const int r = bp.r[bp.n - 1];
#define KW_TURN(R) turn_pass<R, TC>(tile, filt, bp, conj_filt)
    KW_BY_RADIX(KW_TURN)
#undef KW_TURN
    __syncthreads();
  }
  for (int i = bp.n - 2; i >= 1; --i) {
    const int r = bp.r[i];
#define KW_INVERSE(R) mid_pass<R, TC, true>(tile, roots, bp, i)
    KW_BY_RADIX(KW_INVERSE)
#undef KW_INVERSE
    __syncthreads();
  }
}

template <int TC>
__global__ void __launch_bounds__(kThreads, kBlueBlocks)
zfuse_bluestein_kernel(const float2* __restrict__ S, const float2* __restrict__ roots_g,
                       const float2* __restrict__ chirp_g, const float2* __restrict__ filt_g,
                       const float* __restrict__ k2z_g, const float* __restrict__ k2y,
                       const float* __restrict__ k2x, ZOps ops, BluePlan bp, int ny, int nxr,
                       float c_ref_dt_2, int use_kappa, int staged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m = bp.m, nz = bp.nz;
  // the M roots; the M tile; the nz tile (several ops); the staged tables
  float2* roots = reinterpret_cast<float2*>(smem_raw);
  float2* tile = roots + m;
  float2* tile_x = tile + (size_t)m * TC;
  float2* next = ops.n_ops > 1 ? tile_x + (size_t)nz * TC : tile_x;
  const float2* filt = filt_g;
  const float2* chirp = chirp_g;
  const float* k2z = k2z_g;
  for (int j = threadIdx.x; j < m; j += kThreads) roots[j] = roots_g[j];
  if (staged & kStageFilt) {
    for (int j = threadIdx.x; j < m; j += kThreads) next[j] = filt_g[j];
    filt = next;
    next += m;
  }
  if (staged & kStageChirp) {
    for (int j = threadIdx.x; j < nz; j += kThreads) next[j] = chirp_g[j];
    chirp = next;
    next += nz;
  }
  if (staged & kStageK2z) {
    float* k2z_s = reinterpret_cast<float*>(next);
    for (int j = threadIdx.x; j < nz; j += kThreads) k2z_s[j] = k2z_g[j];
    k2z = k2z_s;
  }
  __syncthreads();

  const size_t C = (size_t)ny * nxr;
  const size_t tiles = (C + TC - 1) / TC;
  const int r0 = bp.r[0];
  // every element a thread takes is of one column: kThreads is a multiple of TC
  BlueCol c{S, chirp, k2z, tile_x, nullptr, C, 0, (int)(threadIdx.x % TC), 0, 0, 0, false, 0.f,
            1.0f / (float)nz};
  for (size_t tile_i = blockIdx.x; tile_i < tiles; tile_i += gridDim.x) {
    c.c0 = tile_i * TC;
    c.live = c.c0 + c.col < C;
    c.y = c.x = 0;
    c.k2yx = 0.f;
    if (c.live) {
      column_yx(c.c0 + c.col, nxr, c.y, c.x);
      c.k2yx = k2y[c.y] + k2x[c.x];
    }
    // phase 0 the forward convolution, phase 1 + op each op's: first pass, the middle
    // passes with the filter's turn, last pass; one op bridges from phase 0 into phase 1
    for (int ph = 0; ph <= ops.n_ops; ++ph) {
      const int r = r0;
      c.op = ph > 0 ? ph - 1 : 0;
      c.out = ops.out[c.op];
      if (ph == 0 || ops.n_ops > 1) {
#define KW_FIRST(R)                                                                      \
  if (ph == 0) first_pass<R, TC, kFromSpectrum>(tile, roots, bp, ops, c, c_ref_dt_2, use_kappa); \
  else first_pass<R, TC, kFromTileX>(tile, roots, bp, ops, c, c_ref_dt_2, use_kappa)
        KW_BY_EVEN_RADIX(KW_FIRST)
#undef KW_FIRST
        __syncthreads();
      }
      middle<TC>(tile, roots, filt, bp, ph == 0);
#define KW_LAST(R)                                                                       \
  if (ph > 0) last_pass<R, TC, kToOutput>(tile, roots, bp, ops, c, c_ref_dt_2, use_kappa);      \
  else if (ops.n_ops == 1) last_pass<R, TC, kBridge>(tile, roots, bp, ops, c, c_ref_dt_2,        \
                                                     use_kappa);                         \
  else last_pass<R, TC, kToTileX>(tile, roots, bp, ops, c, c_ref_dt_2, use_kappa)
      KW_BY_EVEN_RADIX(KW_LAST)
#undef KW_LAST
      __syncthreads();  // the tiles are the next phase's, or the next column tile's
    }
  }
}
#undef KW_BY_RADIX
#undef KW_BY_EVEN_RADIX

// Shared memory of a Bluestein call (ops.zfuse.bluestein_tile): the M roots, the M tile,
// the nz tile with several ops, and the staged tables.
size_t bluestein_smem(int nz, int m, int tc, int n_ops, int staged) {
  size_t floats2 = (size_t)m * (tc + 1) + (n_ops > 1 ? (size_t)nz * tc : 0);
  if (staged & kStageFilt) floats2 += m;
  if (staged & kStageChirp) floats2 += nz;
  return floats2 * sizeof(float2) + ((staged & kStageK2z) ? (size_t)nz * sizeof(float) : 0);
}

template <int TC>
int launch_bluestein(const kw_blue::Args& a) {
  const BluePlan& bp = a.bp;
  const ZOps ops = make_ops(a.n_ops, a.dd[0], a.dd[1], a.dd[2], a.out[0], a.out[1], a.out[2],
                            a.kind[0], a.kind[1], a.kind[2], a.axis[0], a.axis[1], a.axis[2],
                            a.power[0], a.power[1], a.power[2]);
  const size_t smem = bluestein_smem(bp.nz, bp.m, TC, a.n_ops, a.staged);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(zfuse_bluestein_kernel<TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, zfuse_bluestein_kernel<TC>,
                                                           kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const size_t C = (size_t)a.ny * a.nxr;
  const size_t tiles = (C + TC - 1) / TC;
  const unsigned blocks = (unsigned)(tiles < (size_t)sms * per_sm ? tiles : (size_t)sms * per_sm);
  zfuse_bluestein_kernel<TC><<<blocks, kThreads, smem, a.stream>>>(
      a.S, a.roots, a.chirp, a.filt, a.k2z, a.k2y, a.k2x, ops, bp, a.ny, a.nxr, a.c_ref_dt_2,
      a.use_kappa, a.staged);
  return (int)cudaGetLastError();
}

}  // namespace
