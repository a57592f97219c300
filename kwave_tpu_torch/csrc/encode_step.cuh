// Per-step arithmetic of the reference-exact compressed-stream encoders, shared by the
// one-window kernels (encode_window.cu) and the whole-record kernels (encode_series.cu) so
// that their order of operations cannot drift apart: the 40-bit pack/unpack, and one
// sampled step of the 40-bit and the float accumulators, of both buffers or of one (the
// whole-record kernels recompute one buffer over the window before a chunk).
//
// Every fp32 product and sum is an explicit __fmul_rn/__fadd_rn, so nvcc cannot contract
// a + t*x into an FMA (the reference semantics round the product first); the order of
// operations follows the reference loop (IndexOutputStream.cpp:411-448).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// kwave_tpu.bitpack.encode40 (CompressHelper.cpp:292-389).
static __device__ __forceinline__ void encode40(float re, float im, int e, uint32_t& hdr,
                                                uint32_t& mr, uint32_t& mi) {
  const uint32_t br = __float_as_uint(re);
  const uint32_t bi = __float_as_uint(im);
  const uint32_t s_r = br >> 31;
  const uint32_t s_i = bi >> 31;
  const int e_rs = (int)((br >> 23) & 0xFF) - e;
  const int e_is = (int)((bi >> 23) & 0xFF) - e;
  int e_s = max(e_rs, e_is);
  uint32_t m_r = br & 0x007FFFFFu;
  uint32_t m_i = bi & 0x007FFFFFu;
  // right-shift counts are uint8 in the reference: mod-256 wraparound at each update
  int rs_r = (6 + max(e_is - e_rs, 0)) & 0xFF;
  int rs_i = (6 + max(e_rs - e_is, 0)) & 0xFF;
  if (e_s < 0) {
    rs_r = (rs_r - e_s) & 0xFF;
    rs_i = (rs_i - e_s) & 0xFF;
    e_s = 0;
  }
  rs_r = min(rs_r, 23);
  rs_i = min(rs_i, 23);
  m_r >>= rs_r;
  m_i >>= rs_i;
  // round up unless at the truncated-field maximum (CompressHelper.cpp:353-367)
  if (m_r > 0u && m_r != (0x7FFFFFu >> rs_r)) m_r += 1u;
  if (m_i > 0u && m_i != (0x7FFFFFu >> rs_i)) m_i += 1u;
  // flag bit, then align to 17 bits
  m_r = (m_r | (1u << (23 - rs_r))) >> 1;
  m_i = (m_i | (1u << (23 - rs_i))) >> 1;
  if (e_s > 0xF) {  // exponent overflow saturates
    m_r = 0xFFFFu;
    m_i = 0xFFFFu;
    e_s = 0xF;
  }
  hdr = (s_r << 7) | (s_i << 6) | ((m_r & 0x10000u) >> 11) | ((m_i & 0x10000u) >> 12) |
        ((uint32_t)e_s & 0xFu);
  mr = m_r & 0xFFFFu;
  mi = m_i & 0xFFFFu;
}

// Normalise a decoded mantissa (<= 23 bits): a zero mantissa stays zero with exponent 0.
static __device__ __forceinline__ uint32_t norm_bits(uint32_t s, uint32_t m, int e_base) {
  if (m == 0u) return s << 31;
  const int idx = 31 - __clz(m);  // MSB index
  const uint32_t m2 = m << (23 - idx);
  const int ex = e_base - (22 - idx);
  return (s << 31) | ((uint32_t)ex << 23) | (m2 & 0x7FFFFFu);
}

// kwave_tpu.bitpack.decode40 (CompressHelper.cpp:224-284).
static __device__ __forceinline__ void decode40(uint32_t hdr, uint32_t mr, uint32_t mi, int e,
                                                float& re, float& im) {
  const uint32_t m_r = (((hdr & 0x20u) << 11) | (mr & 0xFFFFu)) << 6;
  const uint32_t m_i = (((hdr & 0x10u) << 12) | (mi & 0xFFFFu)) << 6;
  const uint32_t s_r = (hdr >> 7) & 1u;
  const uint32_t s_i = (hdr & 0x40u) >> 6;
  const int e_base = (int)(hdr & 0xFu) + e;
  re = __uint_as_float(norm_bits(s_r, m_r, e_base));
  im = __uint_as_float(norm_bits(s_i, m_i, e_base));
}

// One sampled step of one 40-bit accumulator: decode, add t*x, re-encode. cr/ci return the
// post-MAC floats. The two buffers of a window never read each other, so a buffer stepped
// alone gives the bits it gets beside the other one.
static __device__ __forceinline__ void step40_one(float x, float tr, float ti, int e,
                                                  uint32_t& h, uint32_t& r, uint32_t& i,
                                                  float& cr, float& ci) {
  decode40(h, r, i, e, cr, ci);
  cr = __fadd_rn(cr, __fmul_rn(tr, x));
  ci = __fadd_rn(ci, __fmul_rn(ti, x));
  encode40(cr, ci, e, h, r, i);
}

// One sampled step of the 40-bit accumulators: bE*x into buffer 1 and bE_1*x into buffer 2.
// c1*/c2* return the post-MAC floats, which the first window's mirror sums.
template <bool OVERLAP>
static __device__ __forceinline__ void step40(float x, float t1r, float t1i, float t2r,
                                              float t2i, int e, uint32_t& h1, uint32_t& r1,
                                              uint32_t& i1, uint32_t& h2, uint32_t& r2,
                                              uint32_t& i2, float& c1r, float& c1i,
                                              float& c2r, float& c2i) {
  if (OVERLAP) {
    step40_one(x, t1r, t1i, e, h1, r1, i1, c1r, c1i);
    step40_one(x, t2r, t2i, e, h2, r2, i2, c2r, c2i);
  } else {
    // cc += (bE*x + bE_1*x): both products rounded, summed, then one accumulate
    decode40(h1, r1, i1, e, c1r, c1i);
    c1r = __fadd_rn(c1r, __fadd_rn(__fmul_rn(t1r, x), __fmul_rn(t2r, x)));
    c1i = __fadd_rn(c1i, __fadd_rn(__fmul_rn(t1i, x), __fmul_rn(t2i, x)));
    encode40(c1r, c1i, e, h1, r1, i1);
  }
}

// First frame: buf2 = encode(c2 + c1) of the saving step's floats
// (IndexOutputStream.cpp:429-435).
static __device__ __forceinline__ void mirror40(float c1r, float c1i, float c2r, float c2i,
                                                int e, uint32_t& h2, uint32_t& r2,
                                                uint32_t& i2) {
  encode40(__fadd_rn(c2r, c1r), __fadd_rn(c2i, c1i), e, h2, r2, i2);
}

// One sampled step of one float accumulator.
static __device__ __forceinline__ void stepf_one(float x, float tr, float ti, float& ar,
                                                 float& ai) {
  ar = __fadd_rn(ar, __fmul_rn(tr, x));
  ai = __fadd_rn(ai, __fmul_rn(ti, x));
}

// One sampled step of the float accumulators. Without overlap the buffer is aliased: two
// sequential adds into the same accumulator.
template <bool OVERLAP>
static __device__ __forceinline__ void stepf(float x, float t1r, float t1i, float t2r,
                                             float t2i, float& a1r, float& a1i, float& a2r,
                                             float& a2i) {
  stepf_one(x, t1r, t1i, a1r, a1i);
  if (OVERLAP) {
    stepf_one(x, t2r, t2i, a2r, a2i);
  } else {
    stepf_one(x, t2r, t2i, a1r, a1i);
  }
}

}  // namespace
