"""Frozen copy of the compression codec's specification, for the benchmark's reference.

`generate_basis` and the basis tables are `kwave_tpu_torch/basis.py` as of the commit that
added this benchmark; `encode40`, `decode40`, `soa_to_bytes`, `bytes_to_soa`, `OracleEncoder`
and `reconstruct` are `kwave_tpu_torch/oracle.py` of the same commit (the reference CPU
codec, CompressHelper.cpp and IndexOutputStream.cpp, op for op in fp32/uint32). The copy
imports nothing of the port, so a later change to the port's codec cannot move the
yardstick it is held to.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# fp32 value of float(M_PI), as used by the reference (CompressHelper.cpp:739).
_PI_F32 = np.float32(np.pi)

# Exponent bias constants (CompressHelper.h:91-92): pressure / velocity packing ranges.
MAX_EXP_P = 138
MAX_EXP_U = 114

# Dataset-name suffix for compressed streams (CompressHelper.h:65).
COMPRESS_SUFFIX = "_c"


def overlap_size(period: float, mos: int) -> int:
    """oSize = trunc(fp32(period) * mos)  (CompressHelper.cpp:50)."""
    return int(np.float32(np.float32(period) * np.float32(mos)))


@dataclasses.dataclass(frozen=True)
class CompressionBasis:
    """The full set of basis tables for one (period, mos, harmonics) configuration.

    Mirrors the table set held by the reference's CompressHelper singleton
    (CompressHelper.h:146-158), with both plain and shifted (staggered-grid half-sample phase)
    variants. ``bSize = 2*oSize + 1``; only indices ``[0, 2*oSize)`` are ever addressed by the
    streaming encoder (stepLocal = t mod (bSize-1)).

    All complex tables are ``(re, im)`` pairs of float32 arrays of shape ``[harmonics, bSize]``.
    """

    period: float
    mos: int
    harmonics: int
    o_size: int
    b_size: int
    normalized: bool
    # Real triangular window, shape [bSize].
    b: np.ndarray
    # Complex exponentials e and the windowed bases bE (current) / bE_1 (half-frame rotated).
    e_re: np.ndarray
    e_im: np.ndarray
    be_re: np.ndarray
    be_im: np.ndarray
    be1_re: np.ndarray
    be1_im: np.ndarray
    # Shifted variants (velocity streams on the non-staggered grid use these).
    e_sh_re: np.ndarray
    e_sh_im: np.ndarray
    be_sh_re: np.ndarray
    be_sh_im: np.ndarray
    be1_sh_re: np.ndarray
    be1_sh_im: np.ndarray

    @property
    def be(self) -> np.ndarray:
        return self.be_re + 1j * self.be_im

    @property
    def be1(self) -> np.ndarray:
        return self.be1_re + 1j * self.be1_im

    @property
    def be_shifted(self) -> np.ndarray:
        return self.be_sh_re + 1j * self.be_sh_im

    @property
    def be1_shifted(self) -> np.ndarray:
        return self.be1_sh_re + 1j * self.be1_sh_im

    def tables(self, shifted: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(bE_re, bE_im, bE_1_re, bE_1_im) for the plain or shifted basis.

        Stream-to-table wiring follows BaseOutputStream.cpp:68-83: non-staggered velocity
        streams get the shifted tables, everything else the plain ones.
        """
        if shifted:
            return (self.be_sh_re, self.be_sh_im, self.be1_sh_re, self.be1_sh_im)
        return (self.be_re, self.be_im, self.be1_re, self.be1_im)


def triangular_window(o_size: int) -> np.ndarray:
    """Triangular window, rising x/oSize then falling 2-x/oSize (CompressHelper.cpp:700-710)."""
    x = np.arange(2 * o_size + 1, dtype=np.float32)
    o = np.float32(o_size)
    return np.where(x < o_size, x / o, np.float32(2.0) - x / o).astype(np.float32)


def hann_window(o_size: int) -> np.ndarray:
    """Hann window (CompressHelper.cpp:717-723). Dead code in the reference; kept for parity."""
    x = np.arange(2 * o_size + 1, dtype=np.float32)
    return np.square(
        np.sin(np.float64(_PI_F32) * x.astype(np.float64) / (2.0 * o_size))
    ).astype(np.float32)


def _exp_minus_i_theta(theta_f32: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(cos(theta), -sin(theta)) in fp32, evaluated in float64 on the fp32 angle."""
    th = theta_f32.astype(np.float64)
    return np.cos(th).astype(np.float32), (-np.sin(th)).astype(np.float32)


def _generate_e(period: float, harmonics: int, b_size: int, shift: bool):
    """Complex exponential basis e[h, x] = exp(-i * 2*pi*(h+1)/period * x).

    Reference: CompressHelper.cpp:733-745. The fp32 chain is
    ``k = (2.0f * float(M_PI)) / (period / float(h))``; angle = ``k * float(x)``. The shifted
    variant multiplies by ``exp(+i * pi / (period / h))`` with a textbook fp32 complex multiply.
    """
    e_re = np.empty((harmonics, b_size), dtype=np.float32)
    e_im = np.empty((harmonics, b_size), dtype=np.float32)
    x = np.arange(b_size, dtype=np.float32)
    two_pi = np.float32(np.float32(2.0) * _PI_F32)
    for ih in range(harmonics):
        h = np.float32(ih + 1)
        per_h = np.float32(np.float32(period) / h)
        k = np.float32(two_pi / per_h)
        theta = (k * x).astype(np.float32)  # fp32 multiply per element
        re, im = _exp_minus_i_theta(theta)
        if shift:
            phi = np.float32(_PI_F32 / per_h)
            s_re = np.float32(np.cos(np.float64(phi)))
            s_im = np.float32(np.sin(np.float64(phi)))
            # fp32 textbook complex multiply (a+bi)(c+di), each op rounded.
            re2 = np.float32(re * s_re) - np.float32(im * s_im)
            im2 = np.float32(re * s_im) + np.float32(im * s_re)
            re, im = re2.astype(np.float32), im2.astype(np.float32)
        e_re[ih], e_im[ih] = re, im
    return e_re, e_im


def _generate_be(o_size: int, b: np.ndarray, e_re: np.ndarray, e_im: np.ndarray, normalize: bool):
    """bE[h,x] = b[x]*e[h,x]; bE_1[h,x] = b[(x+o)%(bSize-1)] * e[h,(x+o)%(bSize-1)].

    Reference: CompressHelper.cpp:758-778. With normalize, both scaled by fp32(2/oSize).
    """
    b_size = b.shape[-1]
    idx1 = (np.arange(b_size) + o_size) % (b_size - 1)
    be_re = (b[None, :] * e_re).astype(np.float32)
    be_im = (b[None, :] * e_im).astype(np.float32)
    be1_re = (b[idx1][None, :] * e_re[:, idx1]).astype(np.float32)
    be1_im = (b[idx1][None, :] * e_im[:, idx1]).astype(np.float32)
    if normalize:
        n = np.float32(np.float32(2.0) / np.float32(o_size))
        be_re = (be_re * n).astype(np.float32)
        be_im = (be_im * n).astype(np.float32)
        be1_re = (be1_re * n).astype(np.float32)
        be1_im = (be1_im * n).astype(np.float32)
    return be_re, be_im, be1_re, be1_im


def generate_basis(
    period: float, mos: int = 1, harmonics: int = 1, normalize: bool = True
) -> CompressionBasis:
    """Build the full basis-table set (CompressHelper::init, CompressHelper.cpp:48-65).

    The solver always passes normalize=True (Parameters.cpp:549-551).
    """
    o_size = overlap_size(period, mos)
    if o_size < 1:
        raise ValueError(f"period*mos must be >= 1, got period={period} mos={mos}")
    b_size = 2 * o_size + 1
    b = triangular_window(o_size)
    e_re, e_im = _generate_e(period, harmonics, b_size, shift=False)
    es_re, es_im = _generate_e(period, harmonics, b_size, shift=True)
    be = _generate_be(o_size, b, e_re, e_im, normalize)
    be_sh = _generate_be(o_size, b, es_re, es_im, normalize)
    return CompressionBasis(
        period=float(period),
        mos=int(mos),
        harmonics=int(harmonics),
        o_size=o_size,
        b_size=b_size,
        normalized=normalize,
        b=b,
        e_re=e_re,
        e_im=e_im,
        be_re=be[0],
        be_im=be[1],
        be1_re=be[2],
        be1_im=be[3],
        e_sh_re=es_re,
        e_sh_im=es_im,
        be_sh_re=be_sh[0],
        be_sh_im=be_sh[1],
        be1_sh_re=be_sh[2],
        be1_sh_im=be_sh[3],
    )



# ---------------------------------------------------------------------------
# 40-bit codec
# ---------------------------------------------------------------------------


def encode40(re: np.ndarray, im: np.ndarray, e: int):
    """Pack fp32 complex (re, im) into the 40-bit SoA fields (header, mR, mI).

    Bit layout (CompressHelper.cpp:382-388):
    ``| 1 sign-R | 1 sign-I | 17 mantissa-R | 17 mantissa-I | 4 shared exponent |``
    header byte = sR<<7 | sI<<6 | mR[16]<<5 | mI[16]<<4 | eS; the two uint16s hold mR[15:0],
    mI[15:0]. Mantissas carry a flag bit whose position encodes a per-part exponent decrement.
    """
    re = np.asarray(re, dtype=np.float32)
    im = np.asarray(im, dtype=np.float32)
    bits_r = re.view(np.uint32).astype(np.int64)
    bits_i = im.view(np.uint32).astype(np.int64)

    s_r = bits_r >> 31
    s_i = bits_i >> 31
    # Biased exponents minus the stream constant e (138 for p, 114 for u).
    e_rs = ((bits_r & 0x7F800000) >> 23) - e
    e_is = ((bits_i & 0x7F800000) >> 23) - e
    e_s = np.maximum(e_rs, e_is)

    m_r = bits_r & 0x007FFFFF
    m_i = bits_i & 0x007FFFFF

    # Right-shift counts are uint8 in the reference; reproduce the mod-256 wraparound.
    rs_r = (6 + np.maximum(e_is - e_rs, 0)) & 0xFF
    rs_i = (6 + np.maximum(e_rs - e_is, 0)) & 0xFF
    neg = e_s < 0
    rs_r = np.where(neg, (rs_r - e_s) & 0xFF, rs_r)
    rs_i = np.where(neg, (rs_i - e_s) & 0xFF, rs_i)
    e_s = np.maximum(e_s, 0)
    rs_r = np.minimum(rs_r, 23)
    rs_i = np.minimum(rs_i, 23)

    m_r = m_r >> rs_r
    m_i = m_i >> rs_i
    # Round up unless it would overflow the truncated field (CompressHelper.cpp:353-367).
    m_r = np.where((m_r > 0) & (m_r != (0x7FFFFF >> rs_r)), m_r + 1, m_r)
    m_i = np.where((m_i > 0) & (m_i != (0x7FFFFF >> rs_i)), m_i + 1, m_i)
    # Insert the flag bit and align to 17 bits.
    m_r = (m_r | (np.int64(1) << (23 - rs_r))) >> 1
    m_i = (m_i | (np.int64(1) << (23 - rs_i))) >> 1

    # Exponent overflow saturates (CompressHelper.cpp:376-381).
    over = e_s > 0xF
    m_r = np.where(over, 0xFFFF, m_r)
    m_i = np.where(over, 0xFFFF, m_i)
    e_s = np.where(over, 0xF, e_s)

    header = (
        (s_r << 7) | (s_i << 6) | ((m_r & 0x10000) >> 11) | ((m_i & 0x10000) >> 12) | (e_s & 0xF)
    ).astype(np.uint8)
    return header, (m_r & 0xFFFF).astype(np.uint16), (m_i & 0xFFFF).astype(np.uint16)


def decode40(header: np.ndarray, mr: np.ndarray, mi: np.ndarray, e: int):
    """Unpack 40-bit SoA fields back to fp32 complex (re, im).

    Reference: CompressHelper::convert40bToFloatC (CompressHelper.cpp:224-284). The position of
    the mantissa flag bit (found via count-leading-zeros) restores the per-part exponent.
    """
    header = np.asarray(header, dtype=np.uint8).astype(np.int64)
    m_r = ((header & 0x20) << 11) | np.asarray(mr, dtype=np.uint16).astype(np.int64)
    m_i = ((header & 0x10) << 12) | np.asarray(mi, dtype=np.uint16).astype(np.int64)
    s_r = header >> 7
    s_i = (header & 0x40) >> 6
    e_s = header & 0xF
    m_r <<= 6
    m_i <<= 6
    e_r = e_s + e
    e_i = e_s + e

    def _norm(m, ex):
        # index of the most significant set bit; m has <= 23 bits here.
        nz = m != 0
        safe = np.where(nz, m, 1)
        idx = 63 - _clz64(safe)
        m2 = np.where(nz, m << (23 - idx), m)
        ex2 = np.where(nz, ex - (22 - idx), 0)
        return m2, ex2

    m_r, e_r = _norm(m_r, e_r)
    m_i, e_i = _norm(m_i, e_i)
    bits_r = ((s_r << 31) | (e_r << 23) | (m_r & 0x7FFFFF)).astype(np.uint32)
    bits_i = ((s_i << 31) | (e_i << 23) | (m_i & 0x7FFFFF)).astype(np.uint32)
    return bits_r.view(np.float32), bits_i.view(np.float32)


def _clz64(x: np.ndarray) -> np.ndarray:
    """Count leading zeros of positive int64 values (shift cascade; exact near powers of two)."""
    x = x.astype(np.uint64)
    n = np.full(x.shape, 64, dtype=np.int64)
    for shift in (32, 16, 8, 4, 2, 1):
        big = x >= (np.uint64(1) << np.uint64(shift))
        n = np.where(big, n - shift, n)
        x = np.where(big, x >> np.uint64(shift), x)
    # x ends at 1 for any nonzero input; the remaining bit accounts for the final -1.
    return n - 1


def soa_to_bytes(header: np.ndarray, mr: np.ndarray, mi: np.ndarray) -> np.ndarray:
    """Serialize SoA fields to the reference's interleaved 5-byte AoS layout (little-endian)."""
    flat_h = np.asarray(header, np.uint8).reshape(-1)
    flat_r = np.asarray(mr, np.uint16).reshape(-1)
    flat_i = np.asarray(mi, np.uint16).reshape(-1)
    out = np.empty(flat_h.size * 5, dtype=np.uint8)
    out[0::5] = flat_h
    out[1::5] = (flat_r & 0xFF).astype(np.uint8)
    out[2::5] = (flat_r >> 8).astype(np.uint8)
    out[3::5] = (flat_i & 0xFF).astype(np.uint8)
    out[4::5] = (flat_i >> 8).astype(np.uint8)
    return out


def bytes_to_soa(raw: np.ndarray):
    """Inverse of `soa_to_bytes`."""
    raw = np.asarray(raw, dtype=np.uint8)
    if raw.size % 5:
        raise ValueError("packed byte stream length must be a multiple of 5")
    header = raw[0::5].copy()
    mr = (raw[1::5].astype(np.uint16) | (raw[2::5].astype(np.uint16) << 8)).astype(np.uint16)
    mi = (raw[3::5].astype(np.uint16) | (raw[4::5].astype(np.uint16) << 8)).astype(np.uint16)
    return header, mr, mi


# ---------------------------------------------------------------------------
# Streaming frame encoder (the compressed-stream state machine)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OracleEncoder:
    """Reference-exact streaming encoder for one compressed stream (ReduceOperator::kC).

    State machine semantics from IndexOutputStream::flushRaw (IndexOutputStream.cpp:348-471):

    - ``stepLocal = sampledStep mod (bSize-1)``; a frame completes every ``oSize`` steps.
    - Two accumulators staggered by half a window; completed frames alternate buf2, buf1,
      buf2, ... (``oddFrameFlag = (compressedStep+1) % 2 == 0`` selects buf1).
    - On the very first completed frame (overlap mode), buf2 += buf1 ("mirror first half frame").
    - In 40-bit mode the accumulators themselves are packed: every step does
      decode -> complex MAC -> encode on both buffers (read-modify-write requantization).
    - After a frame is emitted the emitted buffer is zeroed (postSample2).
    - ``lastStep`` emits a partial frame only when the whole record fits inside one overlap
      (steps <= oSize), matching IndexOutputStream.cpp:455-456.
    """

    basis: CompressionBasis
    n_sensors: int
    shifted: bool = False  # velocity (non-staggered) streams use the shifted tables
    mode40: bool = False
    overlap: bool = True
    e_const: int | None = None  # defaults: MAX_EXP_U if shifted else MAX_EXP_P
    total_steps: int | None = None  # Nt - samplingStart; needed for the lastStep edge case

    def __post_init__(self):
        if self.e_const is None:
            self.e_const = MAX_EXP_U if self.shifted else MAX_EXP_P
        h = self.basis.harmonics
        shape = (self.n_sensors, h)
        self._be_re, self._be_im, self._be1_re, self._be1_im = self.basis.tables(self.shifted)
        self.sampled_step = 0
        self.compressed_step = 0
        if self.mode40:
            self.hdr1 = np.zeros(shape, np.uint8)
            self.mr1 = np.zeros(shape, np.uint16)
            self.mi1 = np.zeros(shape, np.uint16)
            if self.overlap:
                self.hdr2 = np.zeros(shape, np.uint8)
                self.mr2 = np.zeros(shape, np.uint16)
                self.mi2 = np.zeros(shape, np.uint16)
            else:
                self.hdr2, self.mr2, self.mi2 = self.hdr1, self.mr1, self.mi1
        else:
            self.acc1_re = np.zeros(shape, np.float32)
            self.acc1_im = np.zeros(shape, np.float32)
            if self.overlap:
                self.acc2_re = np.zeros(shape, np.float32)
                self.acc2_im = np.zeros(shape, np.float32)
            else:
                self.acc2_re, self.acc2_im = self.acc1_re, self.acc1_im

    # -- single step ---------------------------------------------------------

    def step(self, x: np.ndarray):
        """Feed one timestep of sampled data ``x[n_sensors]``; returns an emitted frame or None.

        Float mode returns (re, im) fp32 arrays [n_sensors, harmonics]; 40-bit mode returns
        (header, mr, mi) SoA arrays of the same shape.
        """
        x = np.asarray(x, dtype=np.float32)
        assert x.shape == (self.n_sensors,)
        b = self.basis
        step_local = self.sampled_step % (b.b_size - 1)
        saving = (step_local + 1) % b.o_size == 0
        odd_frame = (self.compressed_step + 1) % 2 == 0
        mirror = self.compressed_step == 0 and saving and self.overlap

        be_re = self._be_re[:, step_local][None, :]  # [1, H]
        be_im = self._be_im[:, step_local][None, :]
        be1_re = self._be1_re[:, step_local][None, :]
        be1_im = self._be1_im[:, step_local][None, :]
        xs = x[:, None]  # [N, 1]

        if self.mode40:
            self._step40(xs, be_re, be_im, be1_re, be1_im, mirror)
        else:
            # Correlation step: acc1 += bE*x ; acc2 += bE_1*x (fp32, component-wise).
            self.acc1_re += (be_re * xs).astype(np.float32)
            self.acc1_im += (be_im * xs).astype(np.float32)
            if self.overlap:
                self.acc2_re += (be1_re * xs).astype(np.float32)
                self.acc2_im += (be1_im * xs).astype(np.float32)
                if mirror:
                    self.acc2_re += self.acc1_re
                    self.acc2_im += self.acc1_im
            else:
                # Aliased buffer: two sequential adds into the same accumulator.
                self.acc1_re += (be1_re * xs).astype(np.float32)
                self.acc1_im += (be1_im * xs).astype(np.float32)

        emitted = None
        total = self.total_steps
        last_step = (
            total is not None
            and (total - self.sampled_step == 1)
            and total <= b.o_size
        )
        if saving or last_step:
            if self.mode40:
                if odd_frame:
                    emitted = (self.hdr1.copy(), self.mr1.copy(), self.mi1.copy())
                    self.hdr1[:] = 0
                    self.mr1[:] = 0
                    self.mi1[:] = 0
                else:
                    emitted = (self.hdr2.copy(), self.mr2.copy(), self.mi2.copy())
                    self.hdr2[:] = 0
                    self.mr2[:] = 0
                    self.mi2[:] = 0
            else:
                if odd_frame:
                    emitted = (self.acc1_re.copy(), self.acc1_im.copy())
                    self.acc1_re[:] = 0
                    self.acc1_im[:] = 0
                else:
                    emitted = (self.acc2_re.copy(), self.acc2_im.copy())
                    self.acc2_re[:] = 0
                    self.acc2_im[:] = 0
            self.compressed_step += 1
        self.sampled_step += 1
        return emitted

    def _step40(self, xs, be_re, be_im, be1_re, be1_im, mirror):
        e = self.e_const
        if not self.overlap:
            # cc1 += bE*x + bE_1*x  (sum formed first, then one accumulate; :419-421)
            c_re, c_im = decode40(self.hdr1, self.mr1, self.mi1, e)
            t_re = (be_re * xs).astype(np.float32) + (be1_re * xs).astype(np.float32)
            t_im = (be_im * xs).astype(np.float32) + (be1_im * xs).astype(np.float32)
            c_re = c_re + t_re
            c_im = c_im + t_im
            self.hdr1, self.mr1, self.mi1 = encode40(c_re, c_im, e)
            self.hdr2, self.mr2, self.mi2 = self.hdr1, self.mr1, self.mi1
            return
        # Overlap: decode both, MAC, encode both; mirror adds post-update cc1 (:424-436).
        c1_re, c1_im = decode40(self.hdr1, self.mr1, self.mi1, e)
        c2_re, c2_im = decode40(self.hdr2, self.mr2, self.mi2, e)
        c1_re = c1_re + (be_re * xs).astype(np.float32)
        c1_im = c1_im + (be_im * xs).astype(np.float32)
        c2_re = c2_re + (be1_re * xs).astype(np.float32)
        c2_im = c2_im + (be1_im * xs).astype(np.float32)
        self.hdr1, self.mr1, self.mi1 = encode40(c1_re, c1_im, e)
        self.hdr2, self.mr2, self.mi2 = encode40(c2_re, c2_im, e)
        if mirror:
            c2_re = c2_re + c1_re
            c2_im = c2_im + c1_im
            self.hdr2, self.mr2, self.mi2 = encode40(c2_re, c2_im, e)

    # -- whole series --------------------------------------------------------

    def encode_series(self, series: np.ndarray):
        """Encode ``series[steps, n_sensors]``; returns the list of emitted frames."""
        if self.total_steps is None:
            self.total_steps = series.shape[0]
        frames = []
        for t in range(series.shape[0]):
            out = self.step(series[t])
            if out is not None:
                frames.append(out)
        return frames


def reconstruct(
    frames_re: np.ndarray,
    frames_im: np.ndarray,
    basis: CompressionBasis,
    shifted: bool,
    n_steps: int,
) -> np.ndarray:
    """Decode a compressed stream back to the time series (inverse basis synthesis).

    Frame ``c`` is the windowed projection ``C_c = (2/o) * sum_u b[u] e^{-i w u} x(s_c + u)``
    over the window starting at ``s_c = (c-1)*o`` (frame 0 is the mirrored partial first
    half-window; see OracleEncoder). For a locally-harmonic signal ``C_c`` is the local complex
    amplitude, so overlap-add synthesis with the triangular window (which tiles to 1 at 50%
    overlap) reconstructs:

        x(t) = sum_{c in {floor(t/o), floor(t/o)+1}} sum_h
                   b[u_c] * Re( C_{c,h} * e^{+i w_h u_c} ),   u_c = t - (c-1)*o

    which in table form is ``(o/2) * Re(C . conj(bE_norm[u_c]))`` per covering frame. The C++
    reference never reconstructs (it consumes coefficients directly, e.g. average intensity at
    KSpaceFirstOrderSolver.cpp:1543-1775); this is the analytical inverse used by the wider
    k-Wave ecosystem and by our round-trip tests. Inputs are [Nc, N, H] fp32 planes.
    """
    if frames_re.ndim != 3 or frames_re.shape[2] != basis.harmonics:
        raise ValueError(
            f"reconstruct expects oracle-layout frames [Nc, N, H={basis.harmonics}], got "
            f"{frames_re.shape}; transpose device-layout [Nc, H, N] frames first"
        )
    n_c = frames_re.shape[0]
    n_sens = frames_re.shape[1]
    o = basis.o_size
    be_re, be_im, _, _ = basis.tables(shifted)
    scale = np.float32(o / 2.0) if basis.normalized else np.float32(1.0)
    out = np.zeros((n_steps, n_sens), np.float32)
    for t in range(n_steps):
        acc = np.zeros(n_sens, np.float32)
        base = t // o
        for c in (base, base + 1):
            if c < 0 or c >= n_c:
                continue
            u = t - (c - 1) * o  # offset within frame c's window, in [0, 2o)
            if not (0 <= u < 2 * o):
                continue
            # Re(C * conj(bE[u])) = C_re*bE_re + C_im*bE_im  (tables hold e^{-iwu}).
            acc += np.sum(
                frames_re[c] * be_re[:, u][None, :] + frames_im[c] * be_im[:, u][None, :],
                axis=1,
            ).astype(np.float32)
        out[t] = acc * scale
    return out
