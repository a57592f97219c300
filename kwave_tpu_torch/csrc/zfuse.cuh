// Fused z stage of the solver's spectral multiplies for Hopper (sm_90a): z-DFT -> pointwise
// operator built in the kernel -> z-IDFT, for up to three operators off one forward
// transform. What its four kernels share: the operators, the butterflies in registers and
// the mixed-radix passes in shared memory. The kernels: zfuse.cu (the radix kernel),
// zfuse_mixed.cu (the mixed-radix kernel), zfuse_bluestein.cuh (the Bluestein kernel, one
// source a tile width), zfuse_column.cu (the short z lengths, a column a thread), each its
// own source so that nvcc builds them side by side.
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
// that unit per byte moved, so every z length takes an FFT: in shared memory, or in one
// thread's registers where a column is short. Every kernel with a tile zero-fills the
// ragged last tile on load and masks it on store, and needs more than 48 KB of shared
// memory at the larger nz, so the launchers opt in to what they ask for.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOps = 3;

struct ZOps {
  int n_ops;
  int kind[kMaxOps];  // 0 = grad, 1 = nabla
  int axis[kMaxOps];  // grad: 0 = z, 1 = y, 2 = x
  float power[kMaxOps];
  const float2* dd[kMaxOps];
  float2* out[kMaxOps];
};

// kappa at |k|^2 = k2 (sin(a)/a with a = c_ref_dt_2*sqrt(k2), 1 at a == 0)
__device__ __forceinline__ float kappa_at(float k2, float c_ref_dt_2) {
  const float arg = c_ref_dt_2 * sqrtf(k2);
  return arg == 0.f ? 1.f : sinf(arg) / arg;
}

// The multiplier of operator `op` at bin k of column (y, x), where k2 = |k|^2 there; a grad
// op times kappa() with use_kappa (called only then: multiplying every op by a kappa of 1
// instead made the radix kernel 5-13 % slower).
template <typename Kappa>
__device__ __forceinline__ float2 op_value_by(const ZOps& ops, int op, int k, int y, int x,
                                              float k2, int use_kappa, Kappa kappa) {
  if (ops.kind[op] == 0) {
    const int at = ops.axis[op] == 0 ? k : (ops.axis[op] == 1 ? y : x);
    float2 d = ops.dd[op][at];
    if (use_kappa) {
      const float f = kappa();
      d.x *= f;
      d.y *= f;
    }
    return d;
  }
  const float kmag = sqrtf(k2);
  return make_float2(kmag == 0.f ? 0.f : powf(kmag, ops.power[op]), 0.f);
}

// The same, kappa computed at the bin.
__device__ __forceinline__ float2 op_value(const ZOps& ops, int op, int k, int y, int x,
                                           float k2, float c_ref_dt_2, int use_kappa) {
  return op_value_by(ops, op, k, y, x, k2, use_kappa, [&] { return kappa_at(k2, c_ref_dt_2); });
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// y and x of the spectrum column c
__device__ __forceinline__ void column_yx(size_t c, int nxr, int& y, int& x) {
  y = (int)(c / nxr);
  x = (int)(c - (size_t)y * nxr);
}

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
         : r == 7 ? (k == 1 ? 0.62348980185873360f
                            : (k == 2 ? -0.22252093395631434f : -0.90096886790241900f))
         : r == 11
             ? (k == 1   ? 0.84125353283118121f
                : k == 2 ? 0.41541501300188644f
                : k == 3 ? -0.14231483827328500f
                : k == 4 ? -0.65486073394528499f
                         : -0.95949297361449737f)
             : (k == 1   ? 0.88545602565320991f
                : k == 2 ? 0.56806474673115592f
                : k == 3 ? 0.12053668025532301f
                : k == 4 ? -0.35460488704253545f
                : k == 5 ? -0.74851074817110119f
                         : -0.97094181742605201f);
}
__host__ __device__ constexpr float odd_sin(int r, int k) {
  return r == 3   ? 0.86602540378443870f
         : r == 5 ? (k == 1 ? 0.95105651629515350f : 0.58778525229247320f)
         : r == 7 ? (k == 1 ? 0.78183148246802980f
                            : (k == 2 ? 0.97492791218182360f : 0.43388373911755823f))
         : r == 11
             ? (k == 1   ? 0.54064081745559756f
                : k == 2 ? 0.90963199535451833f
                : k == 3 ? 0.98982144188093280f
                : k == 4 ? 0.75574957435425827f
                         : 0.28173255684142967f)
             : (k == 1   ? 0.46472317204376851f
                : k == 2 ? 0.82298386589365635f
                : k == 3 ? 0.99270887409805397f
                : k == 4 ? 0.93501624268541483f
                : k == 5 ? 0.66312265824079519f
                         : 0.23931566428755768f);
}

// In registers, natural order in and out, R = 3, 5, 7, 11 or 13: v[q] <- sum_m v[m]
// w^(q*m) with w = exp(-/+ 2*pi*i/R), from the sums s and differences d of the pairs
// (m, R - m):
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

// The radix kernel's forward_pass (zfuse.cu) with the radix a template argument and nz, L
// and whether the pass reads the spectrum itself arguments at run time.
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

// The operator's multiplier at bin k of the column (y, x) whose k2y[y] + k2x[x] is k2yx,
// times 1/nz.
__device__ __forceinline__ float2 op_over_nz(const ZOps& ops, int op, int k, int y, int x,
                                             const float* __restrict__ k2z, float k2yx,
                                             float c_ref_dt_2, int use_kappa, float inv_nz) {
  float2 w = op_value(ops, op, k, y, x, k2z[k] + k2yx, c_ref_dt_2, use_kappa);
  w.x *= inv_nz;
  w.y *= inv_nz;
  return w;
}

// The operator of a mixed plan, which the first inverse pass multiplies by as it reads
// (the radix kernel's way) where its radix is at most kOpInPassMax; a larger butterfly that
// also built R multipliers would spill under the mixed kernel's register cap, so there the
// kernel multiplies F by the operator in a step of its own before the passes. Timed on an
// H100 against 0 (every plan takes the step) and 16 (none does), each side of the fork won
// where 7 sends it (PERF.md section 6, K7 mixed).
constexpr int kOpInPassMax = 7;
struct PassOp {
  const ZOps* ops;
  int op, nxr;
  const short* bins;
  const float *k2z, *k2y, *k2x;
  float c_ref_dt_2, inv_nz;
  int use_kappa;
};

// One inverse pass (decimation in time): the forward pass of the same (L, R) undone, src
// to dst (or, for the last one, to out, ragged edge masked). With `with_op` (R at most
// kOpInPassMax) it multiplies its inputs by the operator `op` at the bin each position
// holds, and by 1/nz, first.
template <int R, int TC>
__device__ __forceinline__ void mixed_inverse_pass(const float2* src, float2* dst,
                                                   float2* __restrict__ out, size_t C,
                                                   size_t c0, const float2* roots, int nz,
                                                   int L, bool last, bool with_op,
                                                   const PassOp& op) {
  const int LR = L / R, stride = nz / L;
  for (int b = threadIdx.x; b < (nz / R) * TC; b += kThreads) {
    const int col = b % TC, t = b / TC;
    const int j = t % LR;
    const int p0 = (t - j) * R + j;
    float2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = src[(p0 + q * LR) * TC + col];
    if constexpr (R <= kOpInPassMax) {
      if (with_op && c0 + col < C) {
        int y, x;
        column_yx(c0 + col, op.nxr, y, x);
        const float k2yx = op.k2y[y] + op.k2x[x];
#pragma unroll
        for (int q = 0; q < R; ++q)
          v[q] = cmul(v[q], op_over_nz(*op.ops, op.op, op.bins[p0 + q * LR], y, x, op.k2z,
                                       k2yx, op.c_ref_dt_2, op.use_kappa, op.inv_nz));
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
        if (c0 + col < C) out[(size_t)p * C + c0 + col] = v[m];
      } else {
        dst[p * TC + col] = v[m];
      }
    }
  }
}

// One call of CALL(R) for the pass's radix r (uniform across the block), a radix of the
// butterflies in registers; the generic pass is called on its own.
#define KW_BY_RADIX(CALL)     \
  switch (r) {                \
    case 2: CALL(2); break;   \
    case 3: CALL(3); break;   \
    case 4: CALL(4); break;   \
    case 5: CALL(5); break;   \
    case 7: CALL(7); break;   \
    case 8: CALL(8); break;   \
    case 11: CALL(11); break; \
    case 13: CALL(13); break; \
    case 16: CALL(16); break; \
  }

__host__ __device__ constexpr bool in_registers(int r) {
  return r == 2 || r == 3 || r == 4 || r == 5 || r == 7 || r == 8 || r == 11 || r == 13 ||
         r == 16;
}

inline bool odd_prime(int p) {
  if (p < 3 || p % 2 == 0) return false;
  for (int d = 3; d * d <= p; d += 2)
    if (p % d == 0) return false;
  return true;
}

// The plan of the first n_passes radices, whose product must be n: radices in registers,
// and with generic_ok an odd prime as the first pass; false for any other.
inline bool make_mixed_plan(int n_passes, const int (&radices)[kMaxPasses], int n,
                            bool generic_ok, MixedPlan* plan) {
  if (n_passes < 1 || n_passes > kMaxPasses) return false;
  plan->n = n_passes;
  int product = 1;
  for (int i = 0; i < kMaxPasses; ++i) {
    plan->r[i] = radices[i];
    if (i >= n_passes) continue;
    const int r = radices[i];
    if (!in_registers(r) && !(generic_ok && i == 0 && odd_prime(r))) return false;
    product *= r;
  }
  return product == n;
}

inline ZOps make_ops(int n_ops, const void* dd0, const void* dd1, const void* dd2, void* out0,
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
