"""NumPy golden reference ("oracle") for the compression codec and streaming encoder.

This module is the executable specification the TPU kernels are tested against. It reproduces,
op-for-op in fp32/uint32, the reference CPU path:

- 40-bit complex pack/unpack: `CompressHelper::convertFloatCTo40b` / `convert40bToFloatC`
  (Compression/CompressHelper.cpp:224-389), including the uint8 shift-count wraparound and the
  round-up-with-overflow-guard semantics.
- The streaming frame encoder of compressed output streams: `IndexOutputStream::flushRaw`
  (OutputStreams/IndexOutputStream.cpp:348-471) — dual overlapped accumulators, odd/even frame
  alternation, first-half-frame mirroring, no-overlap aliasing, per-step packed
  read-modify-write in 40-bit mode — and buffer zeroing (`BaseOutputStream::postSample2`,
  BaseOutputStream.cpp:117-132).
- Coefficient-space average intensity (`IndexOutputStream::postSample`, :299-342).

Everything is vectorized over (sensor, harmonic); element-wise fp32 op order matches the
reference's scalar loop, so results are bit-exact with the compiled C++ semantics
(no-FMA, round-to-nearest-even).

The packed stream is held SoA: ``header`` (uint8), ``mr``/``mi`` (uint16) per complex value;
`soa_to_bytes`/`bytes_to_soa` convert to/from the reference's interleaved little-endian 5-byte
AoS layout (header byte, mR lo, mR hi, mI lo, mI hi).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kwave_tpu_torch.basis import MAX_EXP_P, MAX_EXP_U, CompressionBasis  # noqa: F401


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


# ---------------------------------------------------------------------------
# Generalized W-bit wire format (BASELINE config #3; the reference only has 40-bit)
# ---------------------------------------------------------------------------


def pack_wire(header: np.ndarray, mr: np.ndarray, mi: np.ndarray,
              total_bits: int) -> np.ndarray:
    """SoA planes -> little-endian W-bit AoS byte stream.

    40-bit keeps the reference's 5-byte layout (`soa_to_bytes`). Other widths use the
    W-bit field (LSB first): e(4) | m_i(M) | m_r(M) | s_i(1) | s_r(1), serialized as
    W/8 little-endian bytes per coefficient."""
    if total_bits == 40:
        return soa_to_bytes(header, mr, mi)
    from kwave_tpu_torch.bitpack import SUPPORTED_MANT_BITS

    m = SUPPORTED_MANT_BITS[total_bits]
    h = np.asarray(header, np.uint64).reshape(-1)
    r = np.asarray(mr, np.uint64).reshape(-1)
    i = np.asarray(mi, np.uint64).reshape(-1)
    e = h & 0xF
    s_i = (h >> np.uint64(6)) & np.uint64(1)
    s_r = h >> np.uint64(7)
    val = (e | (i << np.uint64(4)) | (r << np.uint64(4 + m))
           | (s_i << np.uint64(4 + 2 * m)) | (s_r << np.uint64(5 + 2 * m)))
    nbytes = total_bits // 8
    out = np.empty((val.size, nbytes), np.uint8)
    for b in range(nbytes):
        out[:, b] = ((val >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint8)
    return out.reshape(-1)


def unpack_wire(raw: np.ndarray, total_bits: int):
    """Inverse of `pack_wire`: byte stream -> (header, mr, mi) SoA planes."""
    if total_bits == 40:
        return bytes_to_soa(raw)
    from kwave_tpu_torch.bitpack import SUPPORTED_MANT_BITS

    m = SUPPORTED_MANT_BITS[total_bits]
    nbytes = total_bits // 8
    raw = np.asarray(raw, np.uint8).reshape(-1, nbytes)
    val = np.zeros(raw.shape[0], np.uint64)
    for b in range(nbytes):
        val |= raw[:, b].astype(np.uint64) << np.uint64(8 * b)
    mask = np.uint64((1 << m) - 1)
    e = (val & np.uint64(0xF)).astype(np.uint32)
    mi = ((val >> np.uint64(4)) & mask).astype(np.uint32)
    mr = ((val >> np.uint64(4 + m)) & mask).astype(np.uint32)
    s_i = ((val >> np.uint64(4 + 2 * m)) & np.uint64(1)).astype(np.uint32)
    s_r = ((val >> np.uint64(5 + 2 * m)) & np.uint64(1)).astype(np.uint32)
    header = ((s_r << 7) | (s_i << 6) | e).astype(np.uint8)
    return header, mr, mi
