"""Fast-path codec kernels: the whole-series windowed-projection encode and the
overlap-add decode, each one launch that reads its input once and writes its output once.

Replaces the TPU kernels of ``kwave_tpu/ops/fastpath.py``:

- `encode_frames_flat` / `encode_frames`: ``_enc_kernel_flat`` and ``_enc_kernel``.
  frames ``[K, 2H, N]`` from series ``[T, N]`` (K = T // o, trailing steps dropped):
  ``frame[k] = P1[k-1] + P2[k]``, ``frame[0] = P1[0] + P2[0]``, with ``P1``/``P2`` the
  projections of window k on the first/second half tables ``tab_lo``/``tab_hi`` ``[o, 2H]``.
- `reconstruct_series_flat` / `reconstruct_series`: ``_dec_kernel_flat`` and
  ``_dec_kernel``. ``x[k*o + r] = sum_j tab[r, j] * [F[k]; F[k+1]]_j`` with tab ``[o, 4H]``
  = ``[bE_re[o:] | bE_im[o:] | bE_re[:o] | bE_im[:o]]``, frames past the last read as
  zero, and the ``o/2`` normalisation folded into tab (as the TPU wrappers do).

The TPU's flat and 3D forms differ only in how they tile the TPU; here each pair is one
CUDA kernel in ``kwave_tpu_torch/csrc/fastpath.cu`` (sm_90a), so the two entries are
bit-identical. ``encode_window.encode_window_float`` (K6) is a kernel of its own in the same
file (``project_window``): one thread per sensor and coefficient row, the same sums in the
same order, so a window has the bits of the whole-series frame. A call of an encode entry
does nothing on the device besides its kernel: the kernels take the two half tables as the
caller holds them. The kernels are fp32 throughout: the TPU's matrix-unit knobs do not
carry over, so every ``compute`` value takes the one kernel and a ``precision`` other than
``"highest"`` is refused. The kernels are bound by bytes; the source says how.

Beside each kernel sits its plain PyTorch version with the same signature (``*_plain``):
the projection as an einsum and the synthesis as one contraction, as the JAX package's
jnp paths do. The wrapper takes the plain version only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

# Launches of each entry's kernel by its wrapper (not by the plain versions).
LAUNCHES = {
    "encode_frames_flat": 0,
    "encode_frames": 0,
    "reconstruct_series_flat": 0,
    "reconstruct_series": 0,
}

# The kernels are instantiated for H = 1..MAX_HARMONICS (their sums live in registers),
# and stage the [o, 4H] table in the 48 KB of shared memory a launch gets by default.
MAX_HARMONICS = 8
MAX_TABLE_FLOATS = 48 * 1024 // 4
# Windows per thread (kWindowsPerThread in csrc/fastpath.cu); blocks of them on grid y.
WINDOWS_PER_THREAD = 8
MAX_WINDOWS = WINDOWS_PER_THREAD * 65535
# Every compute value of the JAX 3D entries; all of them take the one fp32 kernel here.
COMPUTES = ("vpu", "mxu_highest", "mxu_default")


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def project_windows_plain(chunks: torch.Tensor, tab4: torch.Tensor) -> torch.Tensor:
    """[K, o, N] windows x [o, 4H] table -> [K, 4H, N] projections (one einsum)."""
    return torch.einsum("kun,uj->kjn", chunks, tab4)


def encode_frames_plain(series, tab_lo, tab_hi, o_size: int) -> torch.Tensor:
    k_frames, h2 = series.shape[0] // o_size, tab_lo.shape[1]
    chunks = series[: k_frames * o_size].reshape(k_frames, o_size, -1)
    p = project_windows_plain(chunks, torch.cat([tab_lo, tab_hi], dim=1))
    p1, p2 = p[:, :h2], p[:, h2:]
    # frame[0] = P1[0] + P2[0] (mirror identity); frame[k>=1] = P1[k-1] + P2[k]
    return torch.cat([p1[:1], p1[:-1]], dim=0) + p2


def _fold(tab: torch.Tensor, o_size: int, normalized: bool) -> torch.Tensor:
    """The normalisation undo folded into the (tiny) table, as the TPU wrappers do."""
    return tab * (o_size / 2.0) if normalized else tab


def reconstruct_series_plain(frames, tab, o_size: int, n_steps: int,
                             normalized: bool = True) -> torch.Tensor:
    k_total, h2, n = frames.shape
    k_max = (n_steps + o_size - 1) // o_size
    pad_to = max(k_max, k_total) + 1
    f = torch.cat([frames, frames.new_zeros((pad_to - k_total, h2, n))], dim=0)
    g = torch.cat([f[:k_max], f[1 : k_max + 1]], dim=1)  # [k_max, 4H, N]
    x = torch.einsum("kjn,rj->krn", g, _fold(tab, o_size, normalized))
    return x.reshape(k_max * o_size, n)[:n_steps]


# ---------------------------------------------------------------------------
# Wrappers: checks, then the kernel (CUDA) or the plain version (CPU)
# ---------------------------------------------------------------------------


def check_tensors(tensors, n_harm: int, o_size: int) -> torch.device:
    """The device of the float32 tensors, all on one CPU or CUDA device; on CUDA, H and
    the table within what the kernels take."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"expected float32 tensors; got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"all tensors must be on {dev}; got {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not 1 <= n_harm <= MAX_HARMONICS:
            raise ValueError(f"the CUDA kernels take 1..{MAX_HARMONICS} harmonics; "
                             f"got {n_harm}")
        if o_size * 4 * n_harm > MAX_TABLE_FLOATS:
            raise ValueError(f"table [o={o_size}, 4H={4 * n_harm}] exceeds the kernels' "
                             f"{MAX_TABLE_FLOATS} floats of shared memory")
    return dev


def check_compute(compute: str) -> None:
    if compute not in COMPUTES:
        raise ValueError(f"compute={compute!r} is not one of {COMPUTES}")


def check_precision(precision) -> None:
    if precision != "highest":
        raise ValueError(f"precision={precision!r}: the port computes in fp32 only "
                         "(\"highest\"); the TPU's bf16 passes do not carry over")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def as_contiguous(*tensors):
    """The tensors as they are when contiguous (no device work), else contiguous copies."""
    return tuple(t if t.is_contiguous() else t.contiguous() for t in tensors)


def launch_projection(series, tab_lo, tab_hi, o_size: int, k_frames: int):
    """Launch the whole-series projection kernel on contiguous CUDA tensors: the one piece
    of device work of `encode_frames*` (the kernel stages the table from the two half
    tables, and the frames are allocated, not filled). Returns frames [K, 2H, N]."""
    from kwave_tpu_torch.ops import _build

    h2, n = tab_lo.shape[1], series.shape[1]
    if not 1 <= k_frames <= MAX_WINDOWS:
        raise ValueError(f"{k_frames} windows: the kernel takes 1..{MAX_WINDOWS}")
    frames = torch.empty((k_frames, h2, n), dtype=torch.float32, device=series.device)
    lib = _build.load_library()
    with torch.cuda.device(series.device):
        err = lib.kw_project_frames(
            series.data_ptr(), tab_lo.data_ptr(), tab_hi.data_ptr(), frames.data_ptr(),
            k_frames, o_size, h2 // 2, n, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "project_frames")
    return frames


def launch_window_projection(chunk, tab_lo, tab_hi, p1_prev, first_window: bool):
    """Launch the one-window projection kernel (`encode_window.encode_window_float`) on
    contiguous CUDA tensors. Returns (frame [2H, N], p1 [2H, N])."""
    from kwave_tpu_torch.ops import _build

    (o_size, h2), n = tab_lo.shape, chunk.shape[1]
    frame = torch.empty((h2, n), dtype=torch.float32, device=chunk.device)
    p1 = torch.empty_like(frame)
    lib = _build.load_library()
    with torch.cuda.device(chunk.device):
        err = lib.kw_project_window(
            chunk.data_ptr(), tab_lo.data_ptr(), tab_hi.data_ptr(),
            None if first_window else p1_prev.data_ptr(), frame.data_ptr(), p1.data_ptr(),
            o_size, h2 // 2, n, int(bool(first_window)),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "project_window")
    return frame, p1


def _encode(series, tab_lo, tab_hi, o_size: int, key: str) -> torch.Tensor:
    if series.ndim != 2 or tab_lo.ndim != 2 or tab_lo.shape != tab_hi.shape \
            or tab_lo.shape[0] != o_size or tab_lo.shape[1] % 2:
        raise ValueError(f"series must be [T, N] and tab_lo/tab_hi [o={o_size}, 2H]; got "
                         f"{tuple(series.shape)}, {tuple(tab_lo.shape)}, "
                         f"{tuple(tab_hi.shape)}")
    dev = check_tensors((series, tab_lo, tab_hi), tab_lo.shape[1] // 2, o_size)
    k_frames = series.shape[0] // o_size
    if k_frames < 1:
        raise ValueError(f"series of {series.shape[0]} steps holds no window of {o_size}")
    if dev.type == "cpu":
        return encode_frames_plain(series, tab_lo, tab_hi, o_size)
    frames = launch_projection(*as_contiguous(series, tab_lo, tab_hi), o_size, k_frames)
    LAUNCHES[key] += 1
    return frames


def encode_frames_flat(series, tab_lo, tab_hi, o_size: int, precision: str = "highest"):
    """Whole-series fast encode: frames [T // o, 2H, N]. One read of the series."""
    check_precision(precision)
    return _encode(series, tab_lo, tab_hi, o_size, "encode_frames_flat")


def encode_frames(series, tab_lo, tab_hi, o_size: int, compute: str = "vpu"):
    """`encode_frames_flat` semantics through the 3D entry (the same kernel here)."""
    check_compute(compute)
    return _encode(series, tab_lo, tab_hi, o_size, "encode_frames")


def _reconstruct(frames, tab, o_size: int, n_steps: int, normalized: bool, key: str):
    if frames.ndim != 3 or frames.shape[1] % 2 or tab.ndim != 2 \
            or tuple(tab.shape) != (o_size, 2 * frames.shape[1]):
        raise ValueError(f"frames must be [K, 2H, N] and tab [o={o_size}, 4H]; got "
                         f"{tuple(frames.shape)}, {tuple(tab.shape)}")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1; got {n_steps}")
    dev = check_tensors((frames, tab), frames.shape[1] // 2, o_size)
    if dev.type == "cpu":
        return reconstruct_series_plain(frames, tab, o_size, n_steps, normalized)
    from kwave_tpu_torch.ops import _build

    k_total, h2, n = frames.shape
    k_max = (n_steps + o_size - 1) // o_size
    if k_max > MAX_WINDOWS:
        raise ValueError(f"{k_max} windows: the kernel takes 1..{MAX_WINDOWS}")
    frames = frames.contiguous()
    tab = _fold(tab, o_size, normalized).contiguous()
    x = torch.empty((n_steps, n), dtype=torch.float32, device=frames.device)
    lib = _build.load_library()
    with torch.cuda.device(frames.device):
        err = lib.kw_synth_series(
            frames.data_ptr(), tab.data_ptr(), x.data_ptr(), k_total, o_size, h2 // 2, n,
            n_steps, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "synth_series")
    LAUNCHES[key] += 1
    return x


def reconstruct_series_flat(frames, tab, o_size: int, n_steps: int,
                            normalized: bool = True, precision: str = "highest"):
    """Overlap-add synthesis writing the series [n_steps, N] once."""
    check_precision(precision)
    return _reconstruct(frames, tab, o_size, n_steps, normalized,
                        "reconstruct_series_flat")


def reconstruct_series(frames, tab, o_size: int, n_steps: int, normalized: bool = True,
                       compute: str = "vpu"):
    """`reconstruct_series_flat` semantics through the 3D entry (the same kernel here)."""
    check_compute(compute)
    return _reconstruct(frames, tab, o_size, n_steps, normalized, "reconstruct_series")
