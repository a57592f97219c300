"""The numbers that decide `correct`: the program's outputs of one job against the
reference's, each a plain function of arrays that imports nothing of the program.

Kinds (a configuration's ``checks`` list names them, each with its dataset and limit):

- ``series``: a raw pressure dataset ([1, T, N]) against the reference's series: the
  largest gap over every sensor and step, over the reference's peak.
- ``coeff``: a 40-bit compressed pressure dataset ([1, Nc, 5 N H bytes] in float32 words)
  at the sampled sensors, decoded, against the codec oracle's 40-bit encoding of the
  reference's own series, decoded: the largest gap over the reference's largest
  coefficient.
- ``bytes``: the same dataset's bytes at the sampled sensors against the oracle's encoding
  of the program's own raw series (the encoder alone, exact): the count of bytes that
  differ.
- ``layout``: the datasets' names, shapes, types and compression attributes against
  what the configuration's ``layout`` says k-Wave's output file holds: the count of
  differences.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import codec


def gap(got: np.ndarray, want: np.ndarray) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    peak = float(np.abs(want).max())
    return float(np.abs(got - want).max() / peak) if peak > 0 else float("inf")


def rows_bytes(dataset: np.ndarray, n_sensors: int, harmonics: int) -> np.ndarray:
    """A 40-bit compressed dataset's rows as bytes [Nc, N, H, 5]."""
    rows = np.ascontiguousarray(np.asarray(dataset)[0])
    raw = rows.view(np.uint8)[:, : 5 * n_sensors * harmonics]
    return raw.reshape(rows.shape[0], n_sensors, harmonics, 5)


def _decode(raw: np.ndarray, e: int) -> np.ndarray:
    """Bytes [Nc, k, H, 5] -> complex coefficients [Nc, k, H]."""
    h, r, i = codec.bytes_to_soa(np.ascontiguousarray(raw).reshape(-1))
    re, im = codec.decode40(h, r, i, e)
    return (np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)).reshape(raw.shape[:3])


def _encode(series: np.ndarray, basis) -> np.ndarray:
    """The oracle's 40-bit encoding of the pressure ``series`` [T, k] as bytes
    [Nc, k, H, 5]."""
    x = np.ascontiguousarray(np.asarray(series, np.float32))
    enc = codec.OracleEncoder(basis, x.shape[1], shifted=False, mode40=True,
                              e_const=codec.MAX_EXP_P, total_steps=x.shape[0])
    frames = enc.encode_series(x)
    if not frames:
        return np.zeros((0, x.shape[1], basis.harmonics, 5), np.uint8)
    return np.stack([codec.soa_to_bytes(*f).reshape(x.shape[1], basis.harmonics, 5)
                     for f in frames])


class Codec:
    """The basis of a run's compressed pressure stream and the sampled sensors."""

    def __init__(self, period: float, harmonics: int, sample: np.ndarray, n_sensors: int):
        self.basis = codec.generate_basis(period, 1, harmonics, normalize=True)
        self.sample = sample
        self.n_sensors = n_sensors
        self._ref_frames = None

    def program_coeffs(self, dataset) -> np.ndarray:
        raw = rows_bytes(dataset, self.n_sensors, self.basis.harmonics)[:, self.sample]
        return _decode(raw, codec.MAX_EXP_P)

    def reference_coeffs(self, series: np.ndarray) -> np.ndarray:
        """The oracle's frames of the reference's series, decoded (kept: every job is
        held to one reference)."""
        if self._ref_frames is None:
            raw = _encode(series[:, self.sample], self.basis)
            self._ref_frames = _decode(raw, codec.MAX_EXP_P)
        return self._ref_frames

    def coeff_gap(self, dataset, ref_series: np.ndarray) -> float:
        got = self.program_coeffs(dataset)
        want = self.reference_coeffs(ref_series)
        if got.shape != want.shape:
            return float("inf")
        peak = float(np.abs(want).max())
        return float(np.abs(got - want).max() / peak) if peak > 0 else float("inf")

    def bytes_off(self, dataset, program_series: np.ndarray) -> int:
        """Bytes of the compressed dataset (sampled sensors) that are not the oracle's
        encoding of the program's own raw series."""
        got = rows_bytes(dataset, self.n_sensors, self.basis.harmonics)[:, self.sample]
        series = np.asarray(program_series)[0][:, self.sample]
        want = _encode(series, self.basis)
        if got.shape != want.shape:
            return int(max(got.size, want.size))
        return int(np.count_nonzero(got != want))


def layout_off(datasets: dict, layout: dict, sizes: dict) -> int:
    """``datasets``: name -> (shape, dtype name, attrs). ``layout``: name -> {"shape": [...]
    of ints or names in ``sizes``, "dtype": ..., "attrs": {name: value}}. Counts every
    dataset missing or extra, and every shape, type or attribute that differs."""
    off = len(set(datasets) ^ set(layout))
    for name, want in layout.items():
        if name not in datasets:
            continue
        shape, dtype, attrs = datasets[name]
        off += tuple(shape) != tuple(sizes.get(s, s) for s in want["shape"])
        off += dtype != want["dtype"]
        for k, v in want.get("attrs", {}).items():
            got = attrs.get(k)
            if isinstance(got, bytes):
                got = got.decode()
            if got is None:
                off += 1
            elif isinstance(v, str):
                off += got != v
            else:
                off += not np.isclose(float(got), float(v))
    return int(off)
