// The fused z stage's mixed-radix kernel (see zfuse.cuh for the function and the layout),
// instantiated in three sources built side by side: zfuse_mixed.cu for plans of radices in
// registers alone (and the entry), zfuse_mixed_generic.cu and zfuse_mixed_generic3.cu for
// plans with a generic pass, whose registers are capped for kGenericBlocks blocks an SM:
// 2 (114 registers: the generic pass's pairs held without spilling), or 3 (80, as the
// radix-only plans, spilling 4 B) where two or more radix passes follow the generic pass
// and the shared memory lets three blocks share an SM (230 = 23 x 2 x 5: 0.160 against
// 0.186 ms one op on an H100).
//
// zfuse_mixed_kernel<TC> (every nz from 17 to 1709 but the radix kernel's whose prime
// factors are at most 13, or all but one prime from 17 to ops.zfuse.PRIME_MAX: 176, 192,
// 230, 384, ...; the column kernel takes 1 to 16): the radix kernel's FFT with the pass plan
// a runtime argument (up to seven radices from 2, 3, 4, 5, 7, 8, 11, 13, 16; the
// power-of-two part first, then each odd factor a pass of its own; the one larger prime a
// generic pass first), so one instantiation per tile width serves every such nz. Each pass
// switches, uniformly across the block, on its radix to a butterfly in registers: the radix
// kernel's for 2..16, and a DFT over the sums and differences of the pairs (m, R - m) with
// constant cos/sin for 3, 5, 7, 11 and 13. The generic pass takes its prime at run time:
// its butterfly's pairs are dealt to a few lanes that hold them in registers and add their
// shares by warp shuffles, the roots read from the staged ones. The first pass (the generic
// one too) loads from global memory, the last stores to it, and the bin each position
// holds comes from the plan's int16 table (read through the cache, as k2z is, so that two
// tiles and the roots fit up to nz = 1709). The first inverse pass builds each op's
// operator as it reads, as the radix kernel does, where its radix is at most 7; a wider one
// gets F times the operator from a step of its own (built inside butterflies of radix 8 to
// 16 the operator made the kernel spill under its register cap and this source the
// build's longest). Bound by bytes as the radix kernel; its registers are capped so that
// three blocks share an SM, and the tile is the widest (32, 16 or 8 columns) whose shared
// memory lets them.

#pragma once

#include <type_traits>

#include "zfuse.cuh"

namespace {

// The generic pass of an odd prime p (17 .. ops.zfuse.PRIME_MAX): butterfly j of the first
// forward pass (L = nz, LR = nz/p) takes positions j + m*LR and leaves output q, times
// w_nz^(q*j), at j + q*LR; the last inverse pass undoes it. A butterfly is a DFT over the
// sums s_m and differences d_m of its input pairs (m, p - m), as fft_odd's, with the prime
// at run time, worked by G adjacent lanes of one warp: its H = (p - 1)/2 pairs are dealt
// to the lanes (`generic_lanes`: as few as leave each at most kGenericPairs), each of
// which reads its pairs' inputs once and holds their sums and differences in registers.
// For each output pair (q, p - q) each lane sums its pairs over the cos and sin of
// 2*pi*q*m/p, which a table in shared memory holds in the order the lane reads them
// (`generic_table`: one load at a fixed offset and four FMAs a pair and output), the G
// shares added across the lanes by __shfl_xor_sync. A lane's pairs are a template
// argument (`generic_by_pairs`): with their count known only at run time, each pair's
// loads and FMAs sat behind a branch of their own and the kernel ran up to 1.2x slower.
// At most 12 pairs a lane: 8 ran 1.35-1.47x slower (ops.zfuse.GENERIC_PAIRS is its copy,
// which the card tests hold to kw_zfuse_generic_table_size).
constexpr int kGenericPairs = 12;
// blocks of the generic plans' kernel an SM holds at once (its register cap and tile rule):
// 2, or 3 in the source that defines KW_GENERIC_BLOCKS so (zfuse_mixed_generic3.cu)
#ifndef KW_GENERIC_BLOCKS
#define KW_GENERIC_BLOCKS 2
#endif
constexpr int kGenericBlocks = KW_GENERIC_BLOCKS;

// The lanes of one butterfly of the prime p: the least power of two that leaves each at
// most kGenericPairs pairs (at most 32, a warp: p up to 32 * 2 * kGenericPairs + 1).
__host__ __device__ constexpr int generic_lanes(int p) {
  int g = 1;
  while (g < 32 && ((p - 1) / 2 + g - 1) / g > kGenericPairs) g *= 2;
  return g;
}

// The entries of the prime p's table: H rows (q = 1 .. H) of G lanes x K pairs.
__host__ __device__ constexpr int generic_table_size(int p) {
  const int h = (p - 1) / 2, g = generic_lanes(p);
  return h * g * ((h + g - 1) / g);
}

// The table of the generic pass (of the prime p, nz = p*LR): entry (q - 1)*G*K + g*K + i
// holds cos and sin of 2*pi*q*m/p for lane g's pair i, m = g + 1 + i*G (0 past H, where
// the lane's pair is zero), from the roots in device memory (root k*LR = cos - i sin of
// 2*pi*k/p).
__device__ __forceinline__ void generic_table(const float2* __restrict__ roots_g, float2* table,
                                              int nz, int p) {
  const int H = (p - 1) / 2, G = generic_lanes(p), K = (H + G - 1) / G, LR = nz / p;
  for (int e = threadIdx.x; e < generic_table_size(p); e += kThreads) {
    const int q = e / (G * K) + 1, g = (e / K) % G, m = g + 1 + (e % K) * G;
    float2 cs = make_float2(0.f, 0.f);
    if (m <= H) {
      const float2 r = roots_g[((q * m) % p) * LR];
      cs = make_float2(r.x, -r.y);
    }
    table[e] = cs;
  }
}

// v summed over the G adjacent lanes of a butterfly (every lane of the warp takes part;
// each of the G lanes gets the same sum: each step adds the same two values)
__device__ __forceinline__ float2 lanes_sum(float2 v, int G) {
  for (int o = 1; o < G; o <<= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// One lane of a butterfly: lane g of G, its pairs m = g + 1 + i*G (i < K) of the H.
struct GenericLane {
  int p, H, G, LR, g, j, col;
  bool active;  // the lane has a butterfly (the block's last sweep may have too few)
};

// The lanes of sweep b0 (items b0 .. b0 + kThreads - 1 of LR * TC * G; the lanes of a
// butterfly adjacent, so that they share a warp).
template <int TC>
__device__ __forceinline__ GenericLane generic_lane(int b0, int nz, int p) {
  GenericLane l;
  l.p = p;
  l.H = (p - 1) / 2;
  l.LR = nz / p;
  l.G = generic_lanes(p);
  const int b = b0 + threadIdx.x;
  l.active = b < l.LR * TC * l.G;
  l.g = b % l.G;
  const int t = b / l.G;
  l.col = t % TC;
  l.j = l.active ? t / TC : 0;
  return l;
}

// Lanes of a block's generic pass, and whether no lane of this thread's warp has a
// butterfly in sweep b0 (uniform in the warp).
template <int TC>
__device__ __forceinline__ int generic_items(int nz, int p) {
  return (nz / p) * TC * generic_lanes(p);
}
__device__ __forceinline__ bool warp_idle(int b0, int items) {
  return b0 + (int)(threadIdx.x & ~31u) >= items;
}

// The pairs a lane of the prime p's butterfly holds, K: from kGenericPairs / 2 + 1 to
// kGenericPairs at every prime from 17 (a lane's pairs are a template argument, so that
// its loads and FMAs are straight-line code; `generic_by_pairs` instantiates that range).
__host__ __device__ constexpr int generic_pairs(int p) {
  return ((p - 1) / 2 + generic_lanes(p) - 1) / generic_lanes(p);
}
constexpr int kGenericMinPairs = kGenericPairs / 2 + 1;

// The DFT of one butterfly from its lane's sums s and differences d (K pairs) and, in
// lane 0, input 0: for q = 0 .. H, a = [x0] + sum cos(2 pi q m / p) s_m and b = sum
// sin(2 pi q m / p) d_m over the lane's pairs, summed over the lanes, handed to
// emit(q, a, b) in lane 0 (b = 0 at q = 0).
template <int K, typename Emit>
__device__ __forceinline__ void generic_butterfly(const GenericLane& l, float2 x0,
                                                  const float2 (&s)[K], const float2 (&d)[K],
                                                  const float2* table, Emit emit) {
  float2 a = x0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    a.x += s[i].x;
    a.y += s[i].y;
  }
  a = lanes_sum(a, l.G);
  const bool lead = l.active && l.g == 0;
  if (lead) emit(0, a, make_float2(0.f, 0.f));
  const float2* row = table + l.g * K;  // this lane's pairs in row q - 1
  for (int q = 1; q <= l.H; ++q, row += l.G * K) {  // uniform: H is the prime's
    float2 c = x0, sn = make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float2 cs = row[i];  // cos and sin of 2*pi*q*m/p
      c.x = fmaf(cs.x, s[i].x, c.x);
      c.y = fmaf(cs.x, s[i].y, c.y);
      sn.x = fmaf(cs.y, d[i].x, sn.x);
      sn.y = fmaf(cs.y, d[i].y, sn.y);
    }
    c = lanes_sum(c, l.G);
    sn = lanes_sum(sn, l.G);
    if (lead) emit(q, c, sn);
  }
}

// The generic pass as the first forward pass, from the spectrum in device memory (ragged
// edge read as 0) to the tile: output q = a - i*b, output p - q = a + i*b, each times its
// twiddle.
template <int TC, int K>
__device__ __forceinline__ void generic_forward(const float2* __restrict__ S, size_t C,
                                                size_t c0, float2* tile, const float2* roots,
                                                const float2* table, int nz, int p) {
  const int items = generic_items<TC>(nz, p);
  for (int b0 = 0; b0 < items; b0 += kThreads) {
    if (warp_idle(b0, items)) continue;  // else every lane of the warp: they shuffle together
    const GenericLane l = generic_lane<TC>(b0, nz, p);
    const bool live = l.active && c0 + l.col < C;
    const float2* in = S + (size_t)l.j * C + c0 + l.col;  // input m at in[m * step]
    const size_t step = (size_t)l.LR * C;
    float2 s[K], d[K];
    float2 x0 = make_float2(0.f, 0.f);
    if (live && l.g == 0) x0 = in[0];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int m = l.g + 1 + i * l.G;  // past H in the last lanes: the pair is zero
      float2 u = make_float2(0.f, 0.f), w = u;
      if (live && m <= l.H) {
        u = in[m * step];
        w = in[(l.p - m) * step];
      }
      s[i] = make_float2(u.x + w.x, u.y + w.y);
      d[i] = make_float2(u.x - w.x, u.y - w.y);
    }
    float2* to = tile + l.j * TC + l.col;  // output q at to[q * LR * TC]
    generic_butterfly<K>(l, x0, s, d, table, [&](int q, float2 a, float2 b) {
      if (q == 0) {
        to[0] = a;
        return;
      }
      const float2 lo = make_float2(a.x + b.y, a.y - b.x);  // a - i*b
      const float2 hi = make_float2(a.x - b.y, a.y + b.x);  // a + i*b
      to[q * l.LR * TC] = cmul(lo, roots[q * l.j]);
      to[(l.p - q) * l.LR * TC] = cmul(hi, roots[(l.p - q) * l.j]);
    });
  }
}

// The generic forward pass undone, as the last inverse pass: each input read once and
// times its conjugate twiddle, the conjugate butterfly (output m = a + i*b, p - m =
// a - i*b), the outputs stored to out, ragged edge masked.
template <int TC, int K>
__device__ __forceinline__ void generic_inverse(const float2* src, float2* __restrict__ out,
                                                size_t C, size_t c0, const float2* roots,
                                                const float2* table, int nz, int p) {
  const int items = generic_items<TC>(nz, p);
  for (int b0 = 0; b0 < items; b0 += kThreads) {
    if (warp_idle(b0, items)) continue;
    const GenericLane l = generic_lane<TC>(b0, nz, p);
    const float2* in = src + l.j * TC + l.col;  // input q at in[q * LR * TC]
    float2 s[K], d[K];
    float2 x0 = make_float2(0.f, 0.f);
    if (l.active && l.g == 0) x0 = in[0];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int q = l.g + 1 + i * l.G;
      float2 u = make_float2(0.f, 0.f), w = u;
      if (l.active && q <= l.H) {
        const float2 ru = roots[q * l.j], rw = roots[(l.p - q) * l.j];
        u = cmul(in[q * l.LR * TC], make_float2(ru.x, -ru.y));
        w = cmul(in[(l.p - q) * l.LR * TC], make_float2(rw.x, -rw.y));
      }
      s[i] = make_float2(u.x + w.x, u.y + w.y);
      d[i] = make_float2(u.x - w.x, u.y - w.y);
    }
    const bool live = c0 + l.col < C;
    float2* to = out + (size_t)l.j * C + c0 + l.col;  // output m at to[m * LR * C]
    const size_t step = (size_t)l.LR * C;
    generic_butterfly<K>(l, x0, s, d, table, [&](int m, float2 a, float2 b) {
      if (!live) return;
      if (m == 0) {
        to[0] = a;
        return;
      }
      to[m * step] = make_float2(a.x - b.y, a.y + b.x);           // a + i*b
      to[(l.p - m) * step] = make_float2(a.x + b.y, a.y - b.x);  // a - i*b
    });
  }
}

// CALL<K>() for the pairs k of the prime's lanes, K from kGenericPairs down to
// kGenericMinPairs (the host refuses a prime whose k is outside).
template <int K, typename Call>
__device__ __forceinline__ void generic_by_pairs(int k, Call call) {
  if constexpr (K >= kGenericMinPairs) {
    if (k == K) {
      call(std::integral_constant<int, K>());
    } else {
      generic_by_pairs<K - 1>(k, call);
    }
  }
}

template <int TC>
__device__ __forceinline__ void generic_forward_pass(const float2* __restrict__ S, size_t C,
                                                     size_t c0, float2* tile,
                                                     const float2* roots, const float2* table,
                                                     int nz, int p) {
  generic_by_pairs<kGenericPairs>(generic_pairs(p), [&](auto k) {
    generic_forward<TC, decltype(k)::value>(S, C, c0, tile, roots, table, nz, p);
  });
}

template <int TC>
__device__ __forceinline__ void generic_inverse_pass(const float2* src, float2* __restrict__ out,
                                                     size_t C, size_t c0, const float2* roots,
                                                     const float2* table, int nz, int p) {
  generic_by_pairs<kGenericPairs>(generic_pairs(p), [&](auto k) {
    generic_inverse<TC, decltype(k)::value>(src, out, C, c0, roots, table, nz, p);
  });
}

// Any nz whose plan the host checked: radices from 2, 3, 4, 5, 7, 8, 11, 13, 16, and
// perhaps a generic pass of an odd prime first.
//
// Tile F (the forward transform) is worked in place, the first pass reading the spectrum
// (the generic pass too). Each op's inverse runs in the second tile (F's own with one op):
// its first pass reads F and the operator, or a step writes F times the operator there
// first; the last pass (the generic one where the plan has it) stores the output.
template <int TC, bool GENERIC>
__global__ void __launch_bounds__(kThreads, GENERIC ? kGenericBlocks : kMixedBlocks)
zfuse_mixed_kernel(const float2* __restrict__ S, const float2* __restrict__ roots_g,
                   const short* __restrict__ bins, const float* __restrict__ k2z,
                   const float* __restrict__ k2y, const float* __restrict__ k2x, ZOps ops,
                   MixedPlan plan, int nz, int ny, int nxr, float c_ref_dt_2, int use_kappa) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the roots; the generic pass's table; tile F; a second tile with several ops
  float2* roots = reinterpret_cast<float2*>(smem_raw);
  float2* table = roots + nz;
  float2* tile_f = table + (GENERIC ? generic_table_size(plan.r[0]) : 0);
  float2* tile_w = ops.n_ops > 1 ? tile_f + (size_t)nz * TC : tile_f;
  const size_t C = (size_t)ny * nxr;
  const size_t c0 = (size_t)blockIdx.x * TC;

  for (int j = threadIdx.x; j < nz; j += kThreads) roots[j] = roots_g[j];
  constexpr int i0 = GENERIC ? 1 : 0;  // the first pass in registers
  int L = nz;
  if constexpr (GENERIC) {
    generic_table(roots_g, table, nz, plan.r[0]);
    __syncthreads();  // the roots and the table
    generic_forward_pass<TC>(S, C, c0, tile_f, roots, table, nz, plan.r[0]);
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
    if constexpr (GENERIC)
      generic_inverse_pass<TC>(tile_w, out, C, c0, roots, table, nz, plan.r[0]);
    __syncthreads();  // the second tile is overwritten by the next operator
  }
}

// Shared memory of the mixed kernel: the roots, the generic pass's table (`table` entries)
// and one tile, two with several ops.
inline size_t mixed_smem(int nz, int tc, int n_ops, int table) {
  const size_t tiles = n_ops > 1 ? 2 : 1;
  return (tiles * nz * tc + nz + table) * sizeof(float2);
}

// Whether `blocks` blocks of tiles of tc columns share an SM's 228 KB (1 KB of it reserved
// a block).
inline bool mixed_fits(int nz, int tc, int n_ops, int table, int blocks) {
  return blocks * (mixed_smem(nz, tc, n_ops, table) + 1024) <= 228 * 1024;
}

// Columns of a tile: the widest of 32, 16 and 8 that lets `blocks` blocks share an SM,
// else 8.
inline int mixed_tc(int nz, int n_ops, int table, int blocks) {
  for (int tc = 32; tc > 8; tc /= 2)
    if (mixed_fits(nz, tc, n_ops, table, blocks)) return tc;
  return 8;
}

template <int TC, bool GENERIC>
int launch_mixed(const float2* S, const float2* roots, const short* bins, const float* k2z,
                 const float* k2y, const float* k2x, const ZOps& ops, const MixedPlan& plan,
                 int nz, int ny, int nxr, float c_ref_dt_2, int use_kappa, size_t smem,
                 cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(zfuse_mixed_kernel<TC, GENERIC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t C = (size_t)ny * nxr;
  const unsigned blocks = (unsigned)((C + TC - 1) / TC);
  zfuse_mixed_kernel<TC, GENERIC><<<blocks, kThreads, smem, s>>>(
      S, roots, bins, k2z, k2y, k2x, ops, plan, nz, ny, nxr, c_ref_dt_2, use_kappa);
  return (int)cudaGetLastError();
}

// The entry's work for plans with (GENERIC) or without a generic pass: the arguments of
// kw_zfuse_mixed (zfuse_mixed.cu), checked; cudaErrorInvalidValue for a plan or tile width
// the kernel does not take, or tiles that do not fit a block.
template <bool GENERIC>
int mixed_entry(const void* spectrum, const void* roots, const void* bins, const float* k2z,
                const float* k2y, const float* k2x, const void* dd0, const void* dd1,
                const void* dd2, void* out0, void* out1, void* out2, int nz, int ny, int nxr,
                int n_ops, int kind0, int kind1, int kind2, int axis0, int axis1, int axis2,
                float power0, float power1, float power2, float c_ref_dt_2, int use_kappa,
                int n_passes, const int (&radices)[kMaxPasses], int tc, void* stream) {
  MixedPlan plan;
  if (n_ops < 1 || n_ops > kMaxOps || !make_mixed_plan(n_passes, radices, nz, GENERIC, &plan) ||
      in_registers(radices[0]) == GENERIC)
    return (int)cudaErrorInvalidValue;
  int table = 0;
  if (GENERIC) {
    const int k = generic_pairs(radices[0]);
    if (k < kGenericMinPairs || k > kGenericPairs) return (int)cudaErrorInvalidValue;
    table = generic_table_size(radices[0]);
  }
  if (tc == 0) tc = mixed_tc(nz, n_ops, table, GENERIC ? kGenericBlocks : kMixedBlocks);
  const size_t smem = mixed_smem(nz, tc, n_ops, table);
  if ((tc != 32 && tc != 16 && tc != 8) || smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const ZOps ops = make_ops(n_ops, dd0, dd1, dd2, out0, out1, out2, kind0, kind1, kind2, axis0,
                            axis1, axis2, power0, power1, power2);
  const float2* S = static_cast<const float2*>(spectrum);
  const float2* W = static_cast<const float2*>(roots);
  const short* B = static_cast<const short*>(bins);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc == 32)
    return launch_mixed<32, GENERIC>(S, W, B, k2z, k2y, k2x, ops, plan, nz, ny, nxr,
                                     c_ref_dt_2, use_kappa, smem, s);
  if (tc == 16)
    return launch_mixed<16, GENERIC>(S, W, B, k2z, k2y, k2x, ops, plan, nz, ny, nxr,
                                     c_ref_dt_2, use_kappa, smem, s);
  return launch_mixed<8, GENERIC>(S, W, B, k2z, k2y, k2x, ops, plan, nz, ny, nxr, c_ref_dt_2,
                                  use_kappa, smem, s);
}

}  // namespace

// The C arguments of kw_zfuse_mixed, for the entry of either source.
#define KW_MIXED_PARAMS                                                                      \
  const void *spectrum, const void *roots, const void *bins, const float *k2z,               \
      const float *k2y, const float *k2x, const void *dd0, const void *dd1, const void *dd2, \
      void *out0, void *out1, void *out2, int nz, int ny, int nxr, int n_ops, int kind0,     \
      int kind1, int kind2, int axis0, int axis1, int axis2, float power0, float power1,     \
      float power2, float c_ref_dt_2, int use_kappa, int n_passes, int r0, int r1, int r2,   \
      int r3, int r4, int r5, int r6, int tc, void *stream
#define KW_MIXED_ARGS                                                                        \
  spectrum, roots, bins, k2z, k2y, k2x, dd0, dd1, dd2, out0, out1, out2, nz, ny, nxr, n_ops, \
      kind0, kind1, kind2, axis0, axis1, axis2, power0, power1, power2, c_ref_dt_2,          \
      use_kappa, n_passes
