"""Compression basis tables and period detection.

Reimplements (fresh, TPU-first) the basis generation of the reference codec
(`Compression/CompressHelper.cpp:48-65` init, `:672-778` generateFunctions/triangular/
generateE/generateBE) and the period auto-detection (`CompressHelper.cpp:146-216` findPeriod,
`:549-572` findPeaks, `:580-658` diff/median).

All tables are float32 and stored SoA (separate re/im planes) with shape ``[harmonics, bSize]``.
Scalar sub-expressions follow the reference's fp32 evaluation chain exactly (see DESIGN.md
"Numerics"); cos/sin are evaluated in float64 on the fp32 angle and cast to fp32, which matches a
correctly-rounded libm within <=1 ulp. Codec bit-exactness gates always share one set of tables
between both sides, so this variance cannot affect them.
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


def find_peaks(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Strict-left / non-strict-right local maxima with parabolic sub-sample interpolation.

    Reference: CompressHelper.cpp:549-572. Returns (locations, peak_values); locations are
    ``i + d1/(d1+d2) - 0.5`` in fp32.
    """
    data = np.asarray(data, dtype=np.float32)
    n = data.shape[0]
    if n <= 2:
        return np.zeros(0, np.float32), np.zeros(0, np.float32)
    mid = data[1:-1]
    is_peak = (mid > data[:-2]) & (mid >= data[2:])
    i = np.nonzero(is_peak)[0] + 1
    d1 = (data[i] - data[i - 1]).astype(np.float32)
    d2 = (data[i] - data[i + 1]).astype(np.float32)
    locs = (
        i.astype(np.float32) + np.float32(d1 / (d1 + d2)) - np.float32(0.5)
    ).astype(np.float32)
    return locs, data[i]


def _median_ref(values: np.ndarray) -> float:
    """Reference median = sorted[length/2] (no midpoint averaging), CompressHelper.cpp:640-645."""
    v = np.sort(values)
    return float(v[len(v) // 2])


def find_period(data: np.ndarray) -> float:
    """Auto-detect the dominant period of a signal (CompressHelper::findPeriod, :146-216).

    Peak-pick with parabolic interpolation, drop peaks below 0.5*max, take the reference-style
    median of the location differences.
    """
    locs, peaks = find_peaks(np.asarray(data, dtype=np.float32))
    if len(peaks) < 2:
        raise ValueError("findPeriod needs at least two peaks in the signal")
    m = peaks.max()
    keep = locs[peaks > np.float32(0.5) * m]
    if len(keep) < 2:
        raise ValueError("findPeriod: fewer than two peaks above half maximum")
    diffs = np.diff(keep).astype(np.float32)
    return _median_ref(diffs)
