"""Frame encoder for compressed output streams (port of `kwave_tpu.encoder`): the
reference-exact streaming path, and the fast whole-series windowed projection.

Reproduces the reference's per-step fp32 complex MAC order (and, in 40-bit mode, the
per-step decode -> add -> encode requantization) bit for bit
(`IndexOutputStream::flushRaw`, OutputStreams/IndexOutputStream.cpp:348-471). Each window
of oSize sampled steps goes through one launch of the window-encode op
(`kwave_tpu_torch.ops.encode_window`: a CUDA kernel on the card, its plain version on the
CPU) and emits exactly one frame; a trailing partial window accumulates through the same
op without emitting. A recorded series goes through `encode_series_exact`: all its whole
windows in one launch of the whole-record op (`kwave_tpu_torch.ops.encode_series`), then
the trailing steps through the window op.

State is a dict: the ``[H, N]`` accumulator planes as tensors (int32 bit views of the
reference's uint32 planes in 40-bit mode) and the ``sampled_step``/``compressed_step``
counters as host integers, so the per-window parity and mirror never wait on the device.
Tables are time-major ``[2o, H]``; the window op takes them stacked ``[2o, 4H]``.

The fast path (`encode_series_frames`, `encode_series_fast`) is fp32-accurate, not
bit-identical: the whole series goes through one launch of the projection kernel
(`kwave_tpu_torch.ops.fastpath`; its plain einsum on the CPU), and the packed widths
quantise each finished frame once (`bitpack.encode_packed`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from kwave_tpu_torch import bitpack
from kwave_tpu_torch.basis import MAX_EXP_P, MAX_EXP_U, CompressionBasis
from kwave_tpu_torch.ops import encode_series, encode_window, fastpath


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Static configuration of one compressed stream."""

    o_size: int
    harmonics: int
    e_const: int = MAX_EXP_P
    overlap: bool = True
    mode40: bool = False

    @staticmethod
    def for_stream(basis: CompressionBasis, shifted: bool, mode40: bool, overlap: bool = True):
        return EncoderConfig(
            o_size=basis.o_size,
            harmonics=basis.harmonics,
            e_const=MAX_EXP_U if shifted else MAX_EXP_P,
            overlap=overlap,
            mode40=mode40,
        )


def make_tables(basis: CompressionBasis, shifted: bool,
                device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Basis tables as time-major [2o, H] tensors (column bSize-1 is never addressed),
    and under "stacked" the four joined as the window op takes them."""
    be_re, be_im, be1_re, be1_im = basis.tables(shifted)
    n = 2 * basis.o_size

    def t(a):
        # non_blocking: PyTorch's blocking upload would wait for the stream to drain
        return torch.from_numpy(a[:, :n].T.astype(np.float32)).to(device, non_blocking=True)

    tables = {"be_re": t(be_re), "be_im": t(be_im), "be1_re": t(be1_re), "be1_im": t(be1_im)}
    # joined once here, so that a window's call does nothing on the device but its kernel
    tables["stacked"] = stacked_tables(tables)
    return tables


def stacked_tables(tables: dict[str, torch.Tensor]) -> torch.Tensor:
    """[2o, 4H] = [bE_re | bE_im | bE1_re | bE1_im] columns (the window op's layout): the
    one `make_tables` joined, or joined now for a dict of the four tables alone."""
    if "stacked" in tables:
        return tables["stacked"]
    return torch.cat(
        [tables["be_re"], tables["be_im"], tables["be1_re"], tables["be1_im"]], dim=1
    ).contiguous()


def _plane_keys(cfg: EncoderConfig) -> tuple[str, ...]:
    if cfg.mode40:
        return ("hdr1", "mr1", "mi1") + (("hdr2", "mr2", "mi2") if cfg.overlap else ())
    return ("acc1_re", "acc1_im") + (("acc2_re", "acc2_im") if cfg.overlap else ())


def init_state(cfg: EncoderConfig, n_sensors: int,
               device: torch.device | str = "cpu") -> dict[str, Any]:
    """Fresh encoder state: zero planes, each its own tensor."""
    dtype = torch.int32 if cfg.mode40 else torch.float32
    state: dict[str, Any] = {"sampled_step": 0, "compressed_step": 0}
    for k in _plane_keys(cfg):
        state[k] = torch.zeros((cfg.harmonics, n_sensors), dtype=dtype, device=device)
    return state


def _window_op(state, x_chunk: torch.Tensor, cfg: EncoderConfig, tabs: torch.Tensor,
               parity: int, mirror: bool) -> dict[str, Any]:
    """One launch of the window op over ``x_chunk[steps, N]`` on table rows
    ``parity*o + u`` of ``tabs``; advances ``sampled_step``."""
    keys = _plane_keys(cfg)
    planes = tuple(state[k] for k in keys)
    x = x_chunk.to(torch.float32).contiguous()
    if cfg.mode40:
        new = encode_window.encode_window_40b_exact(
            x, tabs, planes, cfg.e_const, parity, int(mirror), overlap=cfg.overlap
        )
    else:
        new = encode_window.encode_window_float_exact(
            x, tabs, planes, parity, int(mirror), overlap=cfg.overlap
        )
    out = dict(state, **dict(zip(keys, new)))
    out["sampled_step"] = state["sampled_step"] + x.shape[0]
    return out


def _accumulate(state, x_chunk: torch.Tensor, cfg: EncoderConfig, tabs: torch.Tensor,
                mirror: bool) -> dict[str, Any]:
    """Run the window op over ``x_chunk[steps, N]`` starting at a window boundary."""
    o = cfg.o_size
    if state["sampled_step"] % o:
        raise ValueError(
            f"window must start at a multiple of oSize={o}; "
            f"sampled_step={state['sampled_step']}"
        )
    return _window_op(state, x_chunk, cfg, tabs, (state["sampled_step"] // o) % 2, mirror)


def _emit(state, cfg: EncoderConfig):
    """Select the finished buffer, zero it, bump compressed_step. Returns (state, frame)."""
    c = state["compressed_step"]
    odd = (c + 1) % 2 == 0
    keys = _plane_keys(cfg)
    half = len(keys) // 2 if cfg.overlap else len(keys)
    # odd frames come from buffer 1, even frames from buffer 2 (buffer 1 without overlap)
    done = keys[:half] if (odd or not cfg.overlap) else keys[half:]
    frame = tuple(state[k] for k in done)
    out = dict(state, **{k: torch.zeros_like(state[k]) for k in done})
    out["compressed_step"] = c + 1
    return out, frame


def encode_chunk(state, x_chunk: torch.Tensor, cfg: EncoderConfig, tables):
    """Process one aligned oSize-step chunk ``[o, N]``; emits exactly one frame.
    Returns (state, frame): float mode (re, im) planes, 40-bit mode (hdr, mr, mi)."""
    if x_chunk.shape[0] != cfg.o_size:
        raise ValueError(f"encode_chunk takes {cfg.o_size} steps; got {x_chunk.shape[0]}")
    # the mirror fires at the saving step of the very first frame (overlap mode)
    mirror = state["compressed_step"] == 0 and cfg.overlap
    state = _accumulate(state, x_chunk, cfg, stacked_tables(tables), mirror)
    return _emit(state, cfg)


def encode_chunks(state, chunks: torch.Tensor, cfg: EncoderConfig, tables):
    """`encode_chunk` over ``chunks[C, o, N]`` in order: one launch of the window op a
    chunk (K1 in 40-bit mode, K2 in float, on a CUDA tensor). Returns (state, frames):
    the frame planes each stacked to ``[C, H, N]``."""
    frames = []
    for c in range(chunks.shape[0]):
        state, frame = encode_chunk(state, chunks[c], cfg, tables)
        frames.append(frame)
    return state, tuple(torch.stack(planes) for planes in zip(*frames))


def accumulate_chunk(state, x_chunk: torch.Tensor, cfg: EncoderConfig, tables):
    """Accumulate a partial trailing window (fewer than oSize steps) with NO emission.

    The reference runs the correlation step on every sampled timestep
    (IndexOutputStream.cpp:397-450); trailing steps of a record not divisible by oSize
    accumulate into the live buffers and are flushed only by the next saving boundary
    (which never comes) or the tiny-record lastStep rule (:455-456, see `emit_partial`).
    Requires a window-aligned start, so no saving boundary falls inside the chunk."""
    if not 0 < x_chunk.shape[0] < cfg.o_size:
        raise ValueError(
            f"accumulate_chunk takes 1..{cfg.o_size - 1} steps; got {x_chunk.shape[0]}"
        )
    return _accumulate(state, x_chunk, cfg, stacked_tables(tables), mirror=False)


def emit_partial(state, cfg: EncoderConfig):
    """Force-emit the current buffer (the reference's tiny-record lastStep edge,
    IndexOutputStream.cpp:455-456: fires when the whole record fits inside one overlap)."""
    return _emit(state, cfg)


def encode_steps(state, x_steps: torch.Tensor, cfg: EncoderConfig, tables):
    """Process ``x_steps[S, N]`` one step at a time from any ``sampled_step`` (the
    unaligned lead-in after a resume, or trailing steps that cross a saving boundary).
    Each step is a one-step window of the window op on its own table row; the mirror
    fires only at the saving step of the very first frame. Returns (state, frames): the
    list of frames emitted on the way (at most ceil(S / o))."""
    o = cfg.o_size
    tabs = stacked_tables(tables)
    frames = []
    for s in range(x_steps.shape[0]):
        sl = state["sampled_step"] % (2 * o)
        saving = (sl + 1) % o == 0
        mirror = state["compressed_step"] == 0 and saving and cfg.overlap
        # a [2, 4H] table whose window (o = 1, parity 0) is the one row sl
        row = tabs[sl:sl + 1].expand(2, -1).contiguous()
        state = _window_op(state, x_steps[s:s + 1], cfg, row, 0, mirror)
        if saving:
            state, frame = _emit(state, cfg)
            frames.append(frame)
    return state, frames


def encode_series_exact(series, basis: CompressionBasis, shifted=False, mode40=False,
                        overlap=True, total_steps=None):
    """Encode ``series[T, N]`` with reference-exact semantics, on the series' device.
    Returns (frames, state).

    frames: float mode (re, im) each ``[Nc, H, N]``; 40-bit mode (hdr, mr, mi) int32 planes
    of the same shape. ``Nc = T // oSize`` (or 1 for tiny records ``T <= oSize``, per the
    lastStep rule). All whole windows go through one launch of the whole-record op; the
    trailing ``T % oSize`` steps accumulate into the state through the window op."""
    series = torch.as_tensor(series, dtype=torch.float32)
    t_total, n = series.shape
    cfg = EncoderConfig.for_stream(basis, shifted, mode40, overlap)
    tables = make_tables(basis, shifted, series.device)
    state = init_state(cfg, n, series.device)
    o = cfg.o_size
    total = total_steps if total_steps is not None else t_total

    if total <= o:
        # Tiny record: accumulate everything, then the lastStep flush emits one partial
        # frame (IndexOutputStream.cpp:455-456)
        if t_total >= o:  # the record is exactly one window: the saving boundary emits
            state, frame = encode_chunk(state, series[:o], cfg, tables)
        else:
            state = accumulate_chunk(state, series, cfg, tables)
            state, frame = _emit(state, cfg)
        return tuple(f[None] for f in frame), state

    n_chunks = t_total // o
    keys = _plane_keys(cfg)
    if n_chunks >= 1:
        tabs = stacked_tables(tables)
        x = series.contiguous()
        if mode40:
            frames, planes = encode_series.encode_series_40b(x, tabs, cfg.e_const, o,
                                                             overlap=cfg.overlap)
        else:
            frames, planes = encode_series.encode_series_float_exact(x, tabs, o,
                                                                     overlap=cfg.overlap)
        state.update(zip(keys, planes))  # without overlap: the first set only
        state["sampled_step"] = n_chunks * o
        state["compressed_step"] = n_chunks
    else:  # fewer steps than one window of a longer record: no frame yet
        frames = tuple(state[k].new_zeros((0, cfg.harmonics, n))
                       for k in keys[: 3 if mode40 else 2])
    # trailing partial window: accumulates, emits nothing
    if t_total - n_chunks * o:
        state = accumulate_chunk(state, series[n_chunks * o:], cfg, tables)
    return frames, state


# ---------------------------------------------------------------------------
# Fast path: whole-series windowed projection
# ---------------------------------------------------------------------------


def encode_series_frames(series, basis: CompressionBasis, shifted=False,
                         precision: str = "highest", compute: str = "flat"):
    """Packed-frame fast encode: frames ``[T // o, 2H, N]`` with rows ``[:H]`` = re,
    ``[H:]`` = im, on the series' device. Every ``compute`` value takes the one fp32
    kernel ("flat" its flat entry, the others its 3D entry); a ``precision`` other than
    "highest" is refused."""
    fastpath.check_precision(precision)
    series = torch.as_tensor(series, dtype=torch.float32)
    o, h = basis.o_size, basis.harmonics
    if series.shape[0] < o:  # no whole window
        return series.new_zeros((0, 2 * h, series.shape[1]))
    tables = make_tables(basis, shifted, series.device)
    tab = torch.cat([tables["be_re"], tables["be_im"]], dim=1)  # [2o, 2H]
    if compute == "flat":
        return fastpath.encode_frames_flat(series, tab[:o], tab[o:], o)
    return fastpath.encode_frames(series, tab[:o], tab[o:], o, compute=compute)


def encode_series_fast(series, basis: CompressionBasis, shifted=False, mode40=False,
                       overlap=True, precision: str = "highest",
                       bits: Optional[int] = None, compute: str = "flat"):
    """Fast windowed-projection encoder (fp32-accurate, not bit-identical).

    Float mode returns (re, im) ``[Nc, H, N]``; packed modes quantise each frame once and
    return int32 planes (the bits of the JAX package's uint32 planes). ``bits`` selects
    the packed width (8/16/24/32/40, `bitpack.SUPPORTED_MANT_BITS`); ``mode40`` is the
    bits=40 shorthand. No-overlap mode projects each window on the summed half-tables
    bE + bE_1 (one einsum, as the JAX package leaves it to XLA)."""
    if bits is None and mode40:
        bits = 40
    series = torch.as_tensor(series, dtype=torch.float32)
    o, h = basis.o_size, basis.harmonics
    if overlap:
        frames = encode_series_frames(series, basis, shifted, precision, compute)
        f_re, f_im = frames[:, :h], frames[:, h:]
    else:
        fastpath.check_precision(precision)
        tables = make_tables(basis, shifted, series.device)
        tab_re = tables["be_re"][:o] + tables["be1_re"][:o]
        tab_im = tables["be_im"][:o] + tables["be1_im"][:o]
        n_frames = series.shape[0] // o
        chunks = series[: n_frames * o].reshape(n_frames, o, -1)
        f_re = torch.einsum("kun,uh->khn", chunks, tab_re)
        f_im = torch.einsum("kun,uh->khn", chunks, tab_im)
    if bits is None:
        return f_re, f_im
    return bitpack.encode_packed(f_re, f_im, MAX_EXP_U if shifted else MAX_EXP_P, bits)


# ---------------------------------------------------------------------------
# Host-edge layout: device [.., H, N] -> reference sensor-major flat buffers
# ---------------------------------------------------------------------------


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def frames_to_flat_float(f_re, f_im) -> np.ndarray:
    """[C?, H, N] complex planes -> reference float buffer layout [..., N*H*2]
    (pH = i*H + ih, interleaved re/im; IndexOutputStream.cpp:438-443)."""
    stacked = np.stack([_numpy(f_re), _numpy(f_im)], axis=-1)  # [..., H, N, 2]
    moved = np.moveaxis(stacked, -3, -2)  # [..., N, H, 2]
    return moved.reshape(*moved.shape[:-3], -1)


def frames_to_flat_40b(hdr, mr, mi) -> np.ndarray:
    """[C?, H, N] 40-bit planes -> packed 5-byte AoS stream in pH = i*H + ih order."""
    from kwave_tpu_torch import oracle

    h, r, i = (np.moveaxis(_numpy(a), -2, -1) for a in (hdr, mr, mi))  # [..., N, H]
    lead = h.shape[:-2]
    flat = oracle.soa_to_bytes(
        h.reshape(*lead, -1).astype(np.uint8),
        r.reshape(*lead, -1).astype(np.uint16),
        i.reshape(*lead, -1).astype(np.uint16),
    )
    return flat.reshape(*lead, -1) if lead else flat
