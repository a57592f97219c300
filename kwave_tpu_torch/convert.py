"""Carry state between the JAX reference package and this port as NumPy arrays, so both
can be run on identical inputs.

The functions read the JAX objects' fields by name and convert each through
``numpy.asarray``; this module imports neither jax nor `kwave_tpu`.

- `operators_from_jax`: a `kwave_tpu.solver.Operators` -> `Operators` (its packed float
  ``[n, 2]`` re/im planes become complex64);
- `sim_state_from_jax` / `sim_state_to_numpy`: `SimState` both ways;
- `sources_from_jax`: `kwave_tpu.solver.Sources` -> `Sources`;
- `encoder_state_from_jax` / `encoder_state_to_numpy`: encoder state dicts both ways
  (uint32 planes <-> int32 bit views, device counters <-> host integers);
- `stream_states_from_jax` / `stream_states_to_numpy`: the driver's per-stream state dict
  both ways (encoder states of compressed streams, reduce buffers, the ``iavg_c``
  intensity accumulators, None for raw / final streams). A checkpoint itself needs no
  conversion: both packages read and write the same file;
- `frames_from_jax` / `frames_to_numpy`: coefficient frames both ways (float ``[K, 2H, N]``
  or ``[K, H, N]`` frames stay float32; uint32 packed planes <-> int32 bit views).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from kwave_tpu_torch.solver.operators import Operators
from kwave_tpu_torch.solver.step import SimState, Sources

# Operators fields the JAX package ships as packed float32 (re, im) planes
_PACKED = ("ddx_pos", "ddx_neg", "ddy_pos", "ddy_neg", "ddz_pos", "ddz_neg",
           "shift_x_neg", "shift_y_neg", "shift_z_neg")
_ENCODER_COUNTERS = ("sampled_step", "compressed_step")


def _tensor(a, device, dtype=None) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def operators_from_jax(ops, device: torch.device | str = "cpu") -> Operators:
    """JAX `Operators` (numpy or jax leaves) -> this port's `Operators` on ``device``,
    full or compact (``kappa is None``, with the k^2 vectors, c0 and alpha2 instead)."""
    out = {}
    for f in dataclasses.fields(Operators):
        v = getattr(ops, f.name)
        if f.name in ("dt", "c_ref_dt_2", "alpha_power"):
            out[f.name] = float(v)
        elif v is None:
            out[f.name] = None
        elif f.name in _PACKED:
            planes = np.asarray(v, np.float32)
            out[f.name] = _tensor(planes[..., 0] + 1j * planes[..., 1], device,
                                  torch.complex64)
        else:
            out[f.name] = _tensor(v, device, torch.float32)
    return Operators(**out)


def sim_state_from_jax(state, device: torch.device | str = "cpu") -> SimState:
    return SimState(**{
        f.name: _tensor(getattr(state, f.name), device, torch.float32)
        for f in dataclasses.fields(SimState)
    })


def sim_state_to_numpy(state: SimState) -> dict[str, Optional[np.ndarray]]:
    """`SimState` -> field name -> numpy array (the keyword arguments of the JAX
    `SimState`)."""
    return {
        f.name: None if getattr(state, f.name) is None
        else getattr(state, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(SimState)
    }


def sources_from_jax(src, device: torch.device | str = "cpu") -> Sources:
    index_fields = ("p_index", "u_index", "transducer_index", "delay_mask")
    return Sources(**{
        f.name: _tensor(getattr(src, f.name), device,
                        torch.int64 if f.name in index_fields else torch.float32)
        for f in dataclasses.fields(Sources)
    })


def _plane_from_jax(a, device) -> torch.Tensor:
    """A JAX plane -> tensor: uint32 becomes its int32 bit view, float stays float32."""
    a = np.asarray(a)
    return _tensor(a.view(np.int32) if a.dtype == np.uint32 else a, device)


def _plane_to_numpy(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def frames_from_jax(frames, device: torch.device | str = "cpu"):
    """JAX coefficient frames -> port tensors: one array, or a tuple of planes (such as
    the (hdr, mr, mi) uint32 planes of `encode_series_fast` with ``bits``), which comes
    back as a tuple."""
    if isinstance(frames, (tuple, list)):
        return tuple(_plane_from_jax(f, device) for f in frames)
    return _plane_from_jax(frames, device)


def frames_to_numpy(frames):
    """Port frames -> the JAX layout as numpy (int32 planes back to uint32)."""
    if isinstance(frames, (tuple, list)):
        return tuple(_plane_to_numpy(f) for f in frames)
    return _plane_to_numpy(frames)


def encoder_state_from_jax(state: dict[str, Any],
                           device: torch.device | str = "cpu") -> dict[str, Any]:
    """JAX encoder state -> port state: uint32 planes become int32 bit views, float
    planes stay float32, the counters become host integers."""
    out: dict[str, Any] = {}
    for k, v in state.items():
        if k in _ENCODER_COUNTERS:
            out[k] = int(np.asarray(v))
        else:
            out[k] = _plane_from_jax(v, device)
    return out


def encoder_state_to_numpy(state: dict[str, Any]) -> dict[str, Any]:
    """Port encoder state -> the JAX layout as numpy: int32 planes as uint32, the
    counters as int32 scalars."""
    out: dict[str, Any] = {}
    for k, v in state.items():
        out[k] = np.int32(v) if k in _ENCODER_COUNTERS else _plane_to_numpy(v)
    return out


def stream_states_from_jax(states: dict[str, Any],
                           device: torch.device | str = "cpu") -> dict[str, Any]:
    """JAX `streams.init_stream_states`-shaped dict -> the port's: encoder state dicts
    through `encoder_state_from_jax`, aggregate and intensity buffers as float32 tensors,
    None (raw / final streams) as None."""
    return {
        name: encoder_state_from_jax(st, device) if isinstance(st, dict)
        else _tensor(st, device, torch.float32)
        for name, st in states.items()
    }


def stream_states_to_numpy(states: dict[str, Any]) -> dict[str, Any]:
    """The port's stream states -> the JAX layout as numpy (the inverse of
    `stream_states_from_jax`)."""
    return {
        name: encoder_state_to_numpy(st) if isinstance(st, dict)
        else None if st is None else st.detach().cpu().numpy()
        for name, st in states.items()
    }
