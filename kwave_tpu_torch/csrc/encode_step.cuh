// Per-step arithmetic of the reference-exact compressed-stream encoders, shared by the
// one-window kernels (encode_window.cu) and the whole-record kernels (encode_series.cu) so
// that their order of operations cannot drift apart: the 40-bit pack/unpack, and one
// sampled step of the 40-bit and the float accumulators, of one buffer at a time (a lane of
// the one-window kernel owns one buffer; the whole-record kernels recompute one buffer over
// the window before a chunk). Between two steps a 40-bit accumulator is held as the floats
// its words decode to (quant40); the words are packed when a window ends.
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

// Exponent offsets e that quant40 takes: 0 .. kQuant40MaxE. Above it a shift count of the
// pack can reach 256 and wrap in the reference's uint8 (one half 250 binades below the
// other); below 0 the offset has no place in an exponent field.
constexpr int kQuant40MaxE = 234;

// One half of quant40. eb is b's exponent field in place (b & 0x7F800000), top the shared
// one; the half is shifted by rs = 6 + (top - eb) >> 23, at most 23. The pack cuts the
// mantissa m to t = m >> rs, adds one unless t is 0 or all ones, and its last shift drops
// the lowest bit: that is t rounded up to even, but an all-ones t rounded down. In place,
// the kept mantissa is the smaller of
//   (m + (1 << rs)) & (-2 << rs)   and   ((0x7FFFFF >> rs) - 1) << rs
// (the first passes 2^23 only where t is all ones; at rs = 23 the first is 0 and the
// second huge). rs = 23 leaves a signed zero; `over` gives the saturated word's value
// `sat`.
static __device__ __forceinline__ float quant40_half(uint32_t b, uint32_t eb, uint32_t top,
                                                     bool over, uint32_t sat) {
  const int rs = min((int)((top - eb) >> 23) + 6, 23);
  const uint32_t up = ((b & 0x007FFFFFu) + (1u << rs)) & (0xFFFFFFFEu << rs);
  const uint32_t cap = ((0x7FFFFFu >> rs) - 1u) << rs;
  const uint32_t kept = (b & (rs == 23 ? 0x80000000u : 0xFF800000u)) | min(up, cap);
  return __uint_as_float(over ? ((b & 0x80000000u) | sat) : kept);
}

// The accumulator between two steps: (re, im) -> decode40(encode40(re, im)), bit for bit
// for every pair of floats and every e from 0 to kQuant40MaxE, without the words in between
// and without a branch. With top = max(both exponents, e), a half with exponent e_x is
// shifted by rs = 6 + top - e_x; the flag bit that the pack sets above its mantissa is the
// leading one that the unpack's normalise looks for, so the half keeps its sign and
// exponent and loses the low rs + 1 bits of its mantissa. top - e > 15 saturates both
// halves to the word's largest value (norm_bits of 0xFFFF << 6 at exponent e + 15). The
// exponents are compared in place, as fields of the float's bits.
static __device__ __forceinline__ void quant40(float& re, float& im, int e) {
  const uint32_t br = __float_as_uint(re);
  const uint32_t bi = __float_as_uint(im);
  const uint32_t er = br & 0x7F800000u;
  const uint32_t ei = bi & 0x7F800000u;
  const uint32_t top = max(max(er, ei), (uint32_t)e << 23);
  const bool over = top > ((uint32_t)(e + 15) << 23);
  const uint32_t sat = ((uint32_t)(e + 14) << 23) | 0x7FFF00u;
  re = quant40_half(br, er, top, over, sat);
  im = quant40_half(bi, ei, top, over, sat);
}

// One sampled step of one 40-bit accumulator, held as the floats q that its words decode
// to: add t*x, requantise. cr/ci return the post-MAC floats, which encode40 packs into the
// accumulator's words when they are needed (after the last step of a window) and which the
// first window's mirror sums. The two buffers of a window never read each other, so a
// buffer stepped alone gives the bits it gets beside the other one.
static __device__ __forceinline__ void step40_one(float x, float tr, float ti, int e,
                                                  float& qr, float& qi, float& cr, float& ci) {
  cr = __fadd_rn(qr, __fmul_rn(tr, x));
  ci = __fadd_rn(qi, __fmul_rn(ti, x));
  qr = cr;
  qi = ci;
  quant40(qr, qi, e);
}

// One sampled step of the no-overlap accumulator: cc += (bE*x + bE_1*x), both products
// rounded, summed, then one accumulate.
static __device__ __forceinline__ void step40_aliased(float x, float t1r, float t1i,
                                                      float t2r, float t2i, int e, float& qr,
                                                      float& qi, float& cr, float& ci) {
  cr = __fadd_rn(qr, __fadd_rn(__fmul_rn(t1r, x), __fmul_rn(t2r, x)));
  ci = __fadd_rn(qi, __fadd_rn(__fmul_rn(t1i, x), __fmul_rn(t2i, x)));
  qr = cr;
  qi = ci;
  quant40(qr, qi, e);
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
