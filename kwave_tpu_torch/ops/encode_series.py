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

The kernels are CUDA C++ for sm_90a in ``kwave_tpu_torch/csrc/encode_series.cu``: one
thread per (harmonic, sensor) with its accumulators in registers across all ``K`` windows,
both parities of the table in shared memory, the series read once and each frame element
written once. By bytes they are memory-bound (``T*N*4`` B in), but ``H*N`` serial chains of
``K*o`` dependent steps make latency their limit. The per-step arithmetic is shared with
the one-window kernels (``csrc/encode_step.cuh``), so a record gives the same bits whether
it goes through this launch or through `encoder.encode_chunk` window by window.

The plain versions run the plain window op window by window. The wrapper takes them only
for tensors on the CPU; on a CUDA tensor it launches the kernel or raises.
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


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _series_plain(series, tabs, o_size: int, overlap: bool, dtype, window_plain):
    """The window loop both plain versions share: ``window_plain(chunk, planes, parity,
    mirror)`` is one window of the plain window op."""
    h, n = tabs.shape[1] // 4, series.shape[1]
    k_total = series.shape[0] // o_size
    per_buf = 3 if dtype == torch.int32 else 2
    zero = torch.zeros((h, n), dtype=dtype, device=series.device)
    planes = (zero,) * (per_buf * (2 if overlap else 1))
    frames = []
    for k in range(k_total):
        chunk = series[k * o_size:(k + 1) * o_size]
        planes = tuple(window_plain(chunk, planes, k % 2, int(overlap and k == 0)))
        first = (k + 1) % 2 == 0 or not overlap  # buffer 1 is the finished one
        done = slice(0, per_buf) if first else slice(per_buf, 2 * per_buf)
        frames.append(planes[done])
        planes = tuple(zero if done.start <= j < done.stop else p
                       for j, p in enumerate(planes))
    stacked = tuple(torch.stack([f[j] for f in frames]) if frames else
                    zero.new_zeros((0, h, n)) for j in range(per_buf))
    return stacked, planes + (zero,) * (2 * per_buf - len(planes))


def encode_series_40b_plain(series, tabs, e_const: int, o_size: int, overlap: bool = True):
    return _series_plain(
        series, tabs, o_size, overlap, torch.int32,
        lambda chunk, planes, parity, mirror: encode_window.encode_window_40b_exact_plain(
            chunk, tabs, planes, e_const, parity, mirror, overlap))


def encode_series_float_exact_plain(series, tabs, o_size: int, overlap: bool = True):
    return _series_plain(
        series, tabs, o_size, overlap, torch.float32,
        lambda chunk, planes, parity, mirror: encode_window.encode_window_float_exact_plain(
            chunk, tabs, planes, parity, mirror, overlap))


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
            extra: tuple):
    from kwave_tpu_torch.ops import _build

    lib = _build.load_library()
    h, n = tabs.shape[1] // 4, series.shape[1]
    k_total = series.shape[0] // o_size
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
            k_total, o_size, h, n, *extra, int(bool(overlap)),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    return frames, state


def encode_series_40b(series, tabs, e_const: int, o_size: int, overlap: bool = True):
    """Fresh-state whole-series 40-bit exact encode of ``series[T, N]`` over the
    ``K = T // o_size`` whole windows. Returns ((hdr, mr, mi) frames each ``[K, H, N]``,
    the final state planes (hdr1, mr1, mi1, hdr2, mr2, mi2) each ``[H, N]``,
    post-emission), as int32 bit views of the reference's uint32 words."""
    _check(series, tabs, o_size)
    if series.device.type == "cpu":
        return encode_series_40b_plain(series, tabs, e_const, o_size, overlap)
    out = _launch("kw_encode_series_40b", series, tabs, o_size, overlap, torch.int32, 3,
                  (int(e_const),))
    LAUNCHES["series40_overlap" if overlap else "series40_no_overlap"] += 1
    return out


def encode_series_float_exact(series, tabs, o_size: int, overlap: bool = True):
    """Fresh-state whole-series float exact encode. Returns ((re, im) frames
    ``[K, H, N]``, the final state planes (a1r, a1i, a2r, a2i) each ``[H, N]``)."""
    _check(series, tabs, o_size)
    if series.device.type == "cpu":
        return encode_series_float_exact_plain(series, tabs, o_size, overlap)
    out = _launch("kw_encode_series_float", series, tabs, o_size, overlap, torch.float32, 2,
                  ())
    LAUNCHES["seriesf_overlap" if overlap else "seriesf_no_overlap"] += 1
    return out
