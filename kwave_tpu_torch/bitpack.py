"""40-bit and W-bit complex codecs as PyTorch integer ops (port of `kwave_tpu.bitpack`).

Planes are int32 tensors whose bits equal the reference's uint32 planes (``header`` low 8
bits, ``mr``/``mi`` low 16 bits): torch's uint32 lacks shifts and compares on the CPU, and
int32 left shifts wrap, so every bit pattern is the same. Right shifts of int32 are
arithmetic, so the sign bit is taken as ``(bits >> 31) & 1``; torch has no count-leading-
zeros, so the decode normalise reads the MSB index from the exponent of an exact
int -> float32 conversion (as `kwave_tpu.ops.encode_pallas._msb_index`).

Semantics are op-for-op those of the reference codec (CompressHelper.cpp:224-389); the
tests hold this module bit-for-bit against `kwave_tpu_torch.oracle.encode40/decode40`.
"""

from __future__ import annotations

import numpy as np
import torch

_I32 = torch.int32


def _shl1(shift: torch.Tensor) -> torch.Tensor:
    """``1 << shift`` element-wise."""
    return torch.ones_like(shift) << shift


def _fields(re: torch.Tensor, im: torch.Tensor, e: int, m_bits: int):
    """The reference's shared-exponent quantisation of fp32 complex (re, im) to M-bit
    mantissas (M incl. the flag bit; CompressHelper.cpp:292-389 at M = 17). Returns
    (s_r, s_i, e_s, m_r, m_i) with m_* of M bits (saturated on exponent overflow)."""
    rs0 = 23 - m_bits  # the 40-bit base shift of 6 (CompressHelper.cpp:330) at M = 17
    bits_r = re.to(torch.float32).contiguous().view(_I32)
    bits_i = im.to(torch.float32).contiguous().view(_I32)
    s_r = (bits_r >> 31) & 1
    s_i = (bits_i >> 31) & 1
    e_rs = ((bits_r >> 23) & 0xFF) - e
    e_is = ((bits_i >> 23) & 0xFF) - e
    e_s = torch.maximum(e_rs, e_is)
    m_r = bits_r & 0x007FFFFF
    m_i = bits_i & 0x007FFFFF

    # right-shift counts are uint8 in the reference: mod-256 wraparound at each update
    rs_r = (rs0 + torch.clamp(e_is - e_rs, min=0)) & 0xFF
    rs_i = (rs0 + torch.clamp(e_rs - e_is, min=0)) & 0xFF
    neg = e_s < 0
    rs_r = torch.where(neg, (rs_r - e_s) & 0xFF, rs_r)
    rs_i = torch.where(neg, (rs_i - e_s) & 0xFF, rs_i)
    e_s = torch.clamp(e_s, min=0)
    rs_r = torch.clamp(rs_r, max=23)
    rs_i = torch.clamp(rs_i, max=23)

    m_r = m_r >> rs_r
    m_i = m_i >> rs_i
    # round up unless at the truncated-field maximum (CompressHelper.cpp:353-367)
    max_r = torch.full_like(rs_r, 0x7FFFFF) >> rs_r
    max_i = torch.full_like(rs_i, 0x7FFFFF) >> rs_i
    m_r = torch.where((m_r > 0) & (m_r != max_r), m_r + 1, m_r)
    m_i = torch.where((m_i > 0) & (m_i != max_i), m_i + 1, m_i)
    # flag bit, then align to M bits
    m_r = (m_r | _shl1(23 - rs_r)) >> 1
    m_i = (m_i | _shl1(23 - rs_i)) >> 1

    sat = (1 << (m_bits - 1)) - 1  # 0xFFFF at M = 17
    over = e_s > 0xF
    m_r = torch.where(over, sat, m_r)
    m_i = torch.where(over, sat, m_i)
    e_s = torch.where(over, 0xF, e_s)
    return s_r, s_i, e_s, m_r, m_i


def encode40(re: torch.Tensor, im: torch.Tensor, e: int):
    """Pack fp32 complex (re, im) -> (header, mR, mI) int32 planes (low 8/16/16 bits)."""
    s_r, s_i, e_s, m_r, m_i = _fields(re, im, e, 17)
    header = (
        (s_r << 7)
        | (s_i << 6)
        | ((m_r & 0x10000) >> 11)
        | ((m_i & 0x10000) >> 12)
        | (e_s & 0xF)
    )
    return header, m_r & 0xFFFF, m_i & 0xFFFF


def msb_index(m: torch.Tensor) -> torch.Tensor:
    """Index of the most significant set bit of m (0 < m < 2^24): the exponent field of
    the exact int -> float32 conversion is 127 + msb_index."""
    f = m.to(torch.float32).view(_I32)
    return ((f >> 23) & 0xFF) - 127


def _norm(m: torch.Tensor, ex: torch.Tensor):
    nz = m != 0
    idx = msb_index(torch.where(nz, m, torch.ones_like(m)))
    m2 = torch.where(nz, m << (23 - idx), m)
    ex2 = torch.where(nz, ex - (22 - idx), torch.zeros_like(ex))
    return m2, ex2


def _unfields(header: torch.Tensor, m_r: torch.Tensor, m_i: torch.Tensor, e: int):
    """Signs and exponent from the header, mantissas aligned to 23 bits -> fp32."""
    s_r = (header >> 7) & 1
    s_i = (header & 0x40) >> 6
    e_base = (header & 0xF) + e
    m_r, e_r = _norm(m_r, e_base)
    m_i, e_i = _norm(m_i, e_base)
    bits_r = (s_r << 31) | (e_r << 23) | (m_r & 0x7FFFFF)
    bits_i = (s_i << 31) | (e_i << 23) | (m_i & 0x7FFFFF)
    return bits_r.view(torch.float32), bits_i.view(torch.float32)


def decode40(header: torch.Tensor, mr: torch.Tensor, mi: torch.Tensor, e: int):
    """Unpack (header, mR, mI) int32 planes -> fp32 (re, im)."""
    m_r = (((header & 0x20) << 11) | (mr & 0xFFFF)) << 6
    m_i = (((header & 0x10) << 12) | (mi & 0xFFFF)) << 6
    return _unfields(header, m_r, m_i, e)


def _to_int32(value: int) -> int:
    """A 32-bit pattern as the Python int that an int32 tensor holds for it."""
    return ((value + (1 << 31)) % (1 << 32)) - (1 << 31)


def quantize40(re: torch.Tensor, im: torch.Tensor, e: int):
    """``decode40(*encode40(re, im, e), e)`` bit for bit, without the words in between: the
    value that a 40-bit accumulator holds after a step, as the CUDA kernels carry it from
    one step to the next (``quant40`` in ``csrc/encode_step.cuh``).

    With ``top = max(both exponents, e)`` a half with exponent ``e_x`` is shifted by
    ``rs = 6 + top - e_x``; the flag bit that `encode40` sets above its mantissa is the
    leading one that `decode40` normalises to, so the half keeps its sign and exponent and
    loses the low ``rs + 1`` bits of its mantissa (after `encode40`'s rounding); ``rs >=
    23`` leaves a signed zero. ``top - e > 15`` saturates both halves to the word's largest
    value. Where a shift count reaches 256 it wraps in the reference's uint8 (one half 250
    binades below the other, with ``e`` above 234): those elements take the pack and the
    unpack as they are."""
    bits_r = re.to(torch.float32).contiguous().view(_I32)
    bits_i = im.to(torch.float32).contiguous().view(_I32)
    e_r = (bits_r >> 23) & 0xFF
    e_i = (bits_i >> 23) & 0xFF
    top = torch.clamp(torch.maximum(e_r, e_i), min=e)
    over = top - e > 0xF
    wrap = ~over & (top - torch.minimum(e_r, e_i) >= 250)
    sign, keep = _to_int32(0x80000000), _to_int32(0xFF800000)
    sat = _to_int32(((e + 14) << 23) & 0xFFFFFFFF | 0x7FFF00)  # _norm of 0xFFFF << 6

    def half(b, e_x):
        rs = torch.clamp(6 + top - e_x, max=23)
        t = (b & 0x7FFFFF) >> rs
        up = (t > 0) & (t != (torch.full_like(rs, 0x7FFFFF) >> rs))
        kept = (b & keep) | (((t + up.to(_I32)) & -2) << rs)
        out = torch.where(rs == 23, b & sign, kept)
        return torch.where(over, (b & sign) | sat, out)

    out_r, out_i = half(bits_r, e_r), half(bits_i, e_i)
    if bool(wrap.any()):
        slow_r, slow_i = decode40(*encode40(re, im, e), e)
        out_r = torch.where(wrap, slow_r.view(_I32), out_r)
        out_i = torch.where(wrap, slow_i.view(_I32), out_i)
    return out_r.view(torch.float32), out_i.view(torch.float32)


# ---------------------------------------------------------------------------
# W-bit complex packing (port of kwave_tpu.bitpack.encode_packed/decode_packed)
# ---------------------------------------------------------------------------
#
# W = 2 sign bits + 2*M mantissa bits + 4 shared-exponent bits, M incl. the flag bit:
# M=17 is the reference's 40-bit layout (encode40/decode40 above), M=13 -> 32-bit,
# M=9 -> 24-bit, M=5 -> 16-bit, M=1 -> 8-bit, all with the reference's arithmetic.

SUPPORTED_MANT_BITS = {8: 1, 16: 5, 24: 9, 32: 13, 40: 17}


def _mant_bits(total_bits: int) -> int:
    if total_bits not in SUPPORTED_MANT_BITS:
        raise ValueError(f"packed width {total_bits!r} is not one of "
                         f"{sorted(SUPPORTED_MANT_BITS)}")
    return SUPPORTED_MANT_BITS[total_bits]


def encode_packed(re: torch.Tensor, im: torch.Tensor, e: int, total_bits: int = 40):
    """Pack fp32 complex -> (header, mR, mI) int32 planes at the given field width.
    header: low byte = [s_r | s_i | mantissa carry bits (40-bit only) | e(4)]; mr/mi:
    low M bits (M = SUPPORTED_MANT_BITS[total_bits])."""
    m_bits = _mant_bits(total_bits)
    if total_bits == 40:
        return encode40(re, im, e)
    s_r, s_i, e_s, m_r, m_i = _fields(re, im, e, m_bits)
    mask = (1 << m_bits) - 1
    return (s_r << 7) | (s_i << 6) | (e_s & 0xF), m_r & mask, m_i & mask


def decode_packed(header: torch.Tensor, mr: torch.Tensor, mi: torch.Tensor, e: int,
                  total_bits: int = 40):
    """Unpack W-bit planes -> fp32 (re, im); inverse of `encode_packed`."""
    m_bits = _mant_bits(total_bits)
    if total_bits == 40:
        return decode40(header, mr, mi, e)
    mask, rs0 = (1 << m_bits) - 1, 23 - m_bits
    return _unfields(header, (mr & mask) << rs0, (mi & mask) << rs0, e)


def pack_words(header: torch.Tensor, mr: torch.Tensor, mi: torch.Tensor) -> torch.Tensor:
    """Pack the SoA planes into int32 words whose little-endian bytes ARE the 5-byte wire
    format (4 coefficients = 20 bytes = 5 words per group). The trailing axis length must
    be a multiple of 4. ``g3 << 24`` wraps in int32; the bit pattern is still right."""
    h = header & 0xFF
    r = mr & 0xFFFF
    i = mi & 0xFFFF
    # bytes per coeff k: [h_k, r_k lo, r_k hi, i_k lo, i_k hi]
    flat = torch.stack([h, r & 0xFF, r >> 8, i & 0xFF, i >> 8], dim=-1)
    flat = flat.reshape(*header.shape[:-1], -1)
    g = flat.reshape(*flat.shape[:-1], -1, 4)
    return g[..., 0] | (g[..., 1] << 8) | (g[..., 2] << 16) | (g[..., 3] << 24)


def words_to_bytes(words) -> bytes:
    """Host side: packed words (a tensor or an array, int32 or uint32) as the wire byte
    stream, little-endian."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    words = np.asarray(words)
    return words.astype(f"<{words.dtype.kind}4", copy=False).tobytes()


def pack_frame_wire(hdr: torch.Tensor, mr: torch.Tensor, mi: torch.Tensor) -> torch.Tensor:
    """One coefficient frame's ``[H, N]`` planes -> wire-format int32 words, on the device,
    in the writer's point-major order pH = i*H + ih, padded to the 4-coefficient group of
    `pack_words`. The true payload is the first ``5*N*H`` bytes (`frame_wire_bytes`)."""
    if hdr.ndim != 2:
        raise ValueError(
            f"pack_frame_wire packs ONE [H, N] frame; got ndim={hdr.ndim}"
        )
    planes = [a.t().reshape(-1) for a in (hdr, mr, mi)]  # [N*H] point-major
    pad = (-planes[0].shape[0]) % 4
    if pad:
        planes = [torch.nn.functional.pad(a, (0, pad)) for a in planes]
    return pack_words(*planes)


def frame_wire_bytes(words, n_coeffs: int) -> np.ndarray:
    """Host-side inverse of `pack_frame_wire`: words -> the frame's 5-byte/coeff stream
    (numpy uint8 of length ``5*n_coeffs``). Fails loudly when the payload does not cover
    the expected coefficient count."""
    raw = np.frombuffer(words_to_bytes(words), np.uint8)
    need = 5 * n_coeffs
    if raw.size < need or raw.size >= need + 20:  # 20 B = one 4-coeff pad group
        raise ValueError(
            f"packed frame holds {raw.size} bytes but the writer expects "
            f"{need} (= 5 x {n_coeffs} coefficients): emission/writer config mismatch"
        )
    return raw[:need]
