"""Whole-record reference-exact encode: every window of a recorded series in one launch,
from fresh state.

Replaces the TPU whole-series kernels of ``kwave_tpu/ops/encode_pallas.py``:

- `encode_series_40b`: ``_series40_kernel`` (overlap and no overlap), entry
  ``encode_series_40b``;
- `encode_series_float_exact`: ``_seriesf_kernel``, entry ``encode_series_float_exact``.

For window ``k = 0..K-1`` (``K = T // o``): ``o`` steps of the window op's per-step update
on table rows ``(k % 2)*o + u``; after window 0 the mirror; then the emit of
`kwave_tpu_torch.encoder`: frame ``k`` is buffer 1 when ``k + 1`` is even, else buffer 2,
and the emitted buffer restarts from zero. Without overlap there is one accumulator, and
it is the frame. Returns the frames ``[K, H, N]`` per plane and the six (40-bit) or four
(float) final state planes ``[H, N]``, post-emission; without overlap the second set is
zeros, as the JAX entries return it.

The kernels are CUDA C++ for sm_90a in ``kwave_tpu_torch/csrc/encode_series.cu``. The
emitted buffer restarts from zero, so every frame is a chain of its own over at most two
windows, and the record is split at window boundaries: one thread per (harmonic, sensor,
chunk of ``G`` consecutive windows). With overlap, a chunk that starts at window ``k0 > 0``
first recomputes from zero, over window ``k0 - 1`` alone, the buffer that is live at that
boundary (buffer 1 when ``k0`` is odd, buffer 2 when it is even); then it walks its windows
as the window loop does. The thread of the last chunk writes the final state. The float
body is bound by memory (``(1 + 1/G) * T*N*4`` B in), the 40-bit body by the integer
instructions of its decode and encode at every step. The per-step arithmetic is shared
with the one-window kernels (``csrc/encode_step.cuh``), so a record gives the same bits
whether it goes through this launch or through `encoder.encode_chunk` window by window.
`chunk_windows_for` gives ``G``; the frames and the state do not depend on it.

The plain versions run the plain window op window by window; with ``chunk_windows`` they
compute by the kernels' chunks, recompute included, and give the same bits. The wrapper
takes them only for tensors on the CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from kwave_tpu_torch.ops import encode_window

# Launches of each kernel variant by its wrapper (not by the plain versions).
LAUNCHES = {
    "series40_overlap": 0,
    "series40_no_overlap": 0,
    "seriesf_overlap": 0,
    "seriesf_no_overlap": 0,
}

# Largest window: both parities of the table (2o x 4 floats) in the 48 KB of shared memory
# a launch gets without opting in to more.
MAX_O = 48 * 1024 // 32

CHUNK_WINDOWS = 8  # the recompute reads 1/G of the series again: 12.5 % at 8
MAX_CHUNKS = 65535  # of one launch (a grid's second dimension)


def chunk_windows_for(k_total: int) -> int:
    """Windows per thread ``G``: ``CHUNK_WINDOWS``, and more only where the record would
    otherwise have more than ``MAX_CHUNKS`` chunks."""
    return max(CHUNK_WINDOWS, -(-k_total // MAX_CHUNKS))


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _chunk_plain(series, o_size: int, overlap: bool, per_buf: int, zero, window_plain,
                 k0: int, k1: int):
    """Windows ``k0 .. k1-1`` from the accumulators the record has at boundary ``k0``:
    zeros, but for the one buffer that is live there, recomputed over window ``k0 - 1``
    (the window op updates both buffers independently; the other one was just emitted)."""
    planes = (zero,) * (per_buf * (2 if overlap else 1))
    if overlap and k0 > 0:
        before = window_plain(series[(k0 - 1) * o_size:k0 * o_size], planes, (k0 - 1) % 2, 0)
        live = slice(0, per_buf) if k0 % 2 else slice(per_buf, 2 * per_buf)
        planes = tuple(p if live.start <= j < live.stop else zero
                       for j, p in enumerate(before))
    frames = []
    for k in range(k0, k1):
        chunk = series[k * o_size:(k + 1) * o_size]
        planes = tuple(window_plain(chunk, planes, k % 2, int(overlap and k == 0)))
        first = (k + 1) % 2 == 0 or not overlap  # buffer 1 is the finished one
        done = slice(0, per_buf) if first else slice(per_buf, 2 * per_buf)
        frames.append(planes[done])
        planes = tuple(zero if done.start <= j < done.stop else p
                       for j, p in enumerate(planes))
    return frames, planes


def _series_plain(series, tabs, o_size: int, overlap: bool, dtype, window_plain,
                  chunk_windows: int | None = None):
    """The window loop both plain versions share: ``window_plain(chunk, planes, parity,
    mirror)`` is one window of the plain window op. ``chunk_windows`` cuts the record
    into the kernels' chunks, each computed on its own; None is the unsplit record."""
    h, n = tabs.shape[1] // 4, series.shape[1]
    k_total = series.shape[0] // o_size
    per_buf = 3 if dtype == torch.int32 else 2
    zero = torch.zeros((h, n), dtype=dtype, device=series.device)
    g = max(k_total, 1) if chunk_windows is None else int(chunk_windows)
    if g < 1:
        raise ValueError(f"chunk_windows must be at least 1; got {chunk_windows}")
    frames, planes = [], (zero,) * (per_buf * (2 if overlap else 1))
    for k0 in range(0, k_total, g):
        part, planes = _chunk_plain(series, o_size, overlap, per_buf, zero, window_plain,
                                    k0, min(k_total, k0 + g))
        frames += part
    stacked = tuple(torch.stack([f[j] for f in frames]) if frames else
                    zero.new_zeros((0, h, n)) for j in range(per_buf))
    return stacked, planes + (zero,) * (2 * per_buf - len(planes))


def encode_series_40b_plain(series, tabs, e_const: int, o_size: int, overlap: bool = True,
                            chunk_windows: int | None = None):
    return _series_plain(
        series, tabs, o_size, overlap, torch.int32,
        lambda chunk, planes, parity, mirror: encode_window.encode_window_40b_exact_plain(
            chunk, tabs, planes, e_const, parity, mirror, overlap), chunk_windows)


def encode_series_float_exact_plain(series, tabs, o_size: int, overlap: bool = True,
                                    chunk_windows: int | None = None):
    return _series_plain(
        series, tabs, o_size, overlap, torch.float32,
        lambda chunk, planes, parity, mirror: encode_window.encode_window_float_exact_plain(
            chunk, tabs, planes, parity, mirror, overlap), chunk_windows)


def _check(series, tabs, o_size: int) -> None:
    if series.ndim != 2 or series.dtype != torch.float32:
        raise ValueError(f"series must be float32 [T, N]; got {series.dtype} "
                         f"{tuple(series.shape)}")
    if tabs.ndim != 2 or tabs.dtype != torch.float32 or tabs.shape[1] % 4 \
            or tabs.shape[0] != 2 * o_size:
        raise ValueError(f"tabs must be float32 [2o, 4H] with o={o_size}; got {tabs.dtype} "
                         f"{tuple(tabs.shape)}")
    if not 1 <= o_size <= MAX_O:
        raise ValueError(f"o_size must be in 1..{MAX_O}; got {o_size}")
    if series.shape[0] < o_size:
        raise ValueError(f"the series holds {series.shape[0]} steps, less than one window "
                         f"of {o_size}")
    if tabs.device != series.device:
        raise ValueError(f"all tensors must be on {series.device}; got {tabs.device}")
    if not (series.is_contiguous() and tabs.is_contiguous()):
        raise ValueError("all tensors must be contiguous")
    if series.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {series.device}")


def _launch(name: str, series, tabs, o_size: int, overlap: bool, dtype, per_buf: int,
            extra: tuple, chunk_windows: int | None):
    """Launch one whole-record kernel. ``chunk_windows`` other than None overrides
    `chunk_windows_for`: for the card tests and `chip_smoke.py`, which reach chunk
    boundaries that a record of their size would not have."""
    from kwave_tpu_torch.ops import _build

    lib = _build.load_library()
    h, n = tabs.shape[1] // 4, series.shape[1]
    k_total = series.shape[0] // o_size
    g = chunk_windows_for(k_total) if chunk_windows is None else int(chunk_windows)
    if g < 1 or -(-k_total // g) > MAX_CHUNKS:
        raise ValueError(f"chunk_windows={g} cuts {k_total} windows into more than "
                         f"{MAX_CHUNKS} chunks, or is below 1")
    frames = tuple(torch.empty((k_total, h, n), dtype=dtype, device=series.device)
                   for _ in range(per_buf))
    state = tuple(torch.empty((h, n), dtype=dtype, device=series.device)
                  for _ in range(per_buf))
    # without overlap the kernel has no second buffer: its planes are zeros by contract
    make2 = torch.empty if overlap else torch.zeros
    state += tuple(make2((h, n), dtype=dtype, device=series.device) for _ in range(per_buf))
    with torch.cuda.device(series.device):
        err = getattr(lib, name)(
            series.data_ptr(), tabs.data_ptr(), *(t.data_ptr() for t in frames + state),
            k_total, o_size, h, n, *extra, int(bool(overlap)), g,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    return frames, state


def _kernel_40b(series, tabs, e_const: int, o_size: int, overlap: bool,
                chunk_windows: int | None = None):
    out = _launch("kw_encode_series_40b", series, tabs, o_size, overlap, torch.int32, 3,
                  (int(e_const),), chunk_windows)
    LAUNCHES["series40_overlap" if overlap else "series40_no_overlap"] += 1
    return out


def _kernel_float(series, tabs, o_size: int, overlap: bool,
                  chunk_windows: int | None = None):
    out = _launch("kw_encode_series_float", series, tabs, o_size, overlap, torch.float32, 2,
                  (), chunk_windows)
    LAUNCHES["seriesf_overlap" if overlap else "seriesf_no_overlap"] += 1
    return out


def encode_series_40b(series, tabs, e_const: int, o_size: int, overlap: bool = True):
    """Fresh-state whole-series 40-bit exact encode of ``series[T, N]`` over the
    ``K = T // o_size`` whole windows. Returns ((hdr, mr, mi) frames each ``[K, H, N]``,
    the final state planes (hdr1, mr1, mi1, hdr2, mr2, mi2) each ``[H, N]``,
    post-emission), as int32 bit views of the reference's uint32 words."""
    _check(series, tabs, o_size)
    encode_window.check_e_const(e_const)
    if series.device.type == "cpu":
        return encode_series_40b_plain(series, tabs, e_const, o_size, overlap)
    return _kernel_40b(series, tabs, e_const, o_size, overlap)


def encode_series_float_exact(series, tabs, o_size: int, overlap: bool = True):
    """Fresh-state whole-series float exact encode. Returns ((re, im) frames
    ``[K, H, N]``, the final state planes (a1r, a1i, a2r, a2i) each ``[H, N]``)."""
    _check(series, tabs, o_size)
    if series.device.type == "cpu":
        return encode_series_float_exact_plain(series, tabs, o_size, overlap)
    return _kernel_float(series, tabs, o_size, overlap)
