"""Checkpoint file: the 7 field matrices + t_index + grid dims + per-stream coefficient
accumulators (port of `kwave_tpu.io.checkpoint`).

Contract from KSpaceFirstOrderSolver::saveCheckpointData (KSpaceFirstOrderSolver.cpp:
1176-1232) and BaseOutputStream::checkpoint (BaseOutputStream.cpp:551-606):

- file_type = "checkpoint"; scalars t_index, Nx, Ny, Nz
- matrices p, rhox, rhoy, rhoz, ux_sgx, uy_sgy, uz_sgz as [nz, ny, nx] float32
  (MatrixContainer.cpp:29-42)
- compressed-stream state: `Temp_<dataset>_1` / `Temp_<dataset>_2` coefficient buffers
  as [1, 1, n] (reloaded by loadCheckpointCompressionCoefficients,
  BaseOutputStream.cpp:528-544)

Both functions take the checkpoint's path or an open group-like object (see
`kwave_tpu_torch.io.hdf5.open_group`), so a checkpoint can also be held in memory.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from kwave_tpu_torch.io import names
from kwave_tpu_torch.io.hdf5 import (
    create_dataset,
    open_group,
    read_scalar,
    write_file_header,
    write_scalar,
)

# SimState field -> dataset name
_FIELD_NAMES = (
    ("p", names.P),
    ("rho_x", names.RHOX),
    ("rho_y", names.RHOY),
    ("rho_z", names.RHOZ),
    ("ux_sgx", names.UX_SGX),
    ("uy_sgy", names.UY_SGY),
    ("uz_sgz", names.UZ_SGZ),
)


def _host(v) -> np.ndarray:
    if hasattr(v, "detach"):  # a tensor, on any device
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def write_checkpoint(
    target,
    state,
    t_index: int,
    grid_shape: tuple[int, int, int],  # (nx, ny, nz)
    stream_coeffs: Optional[dict[str, tuple[np.ndarray, Optional[np.ndarray]]]] = None,
) -> None:
    """``state`` is a `SimState` of tensors or numpy arrays (None fields are skipped, as
    in 2D). ``stream_coeffs``: dataset name -> (buffer1, buffer2|None), flat float arrays
    in the reference's interleaved layout (`streams.stream_states_to_checkpoint`)."""
    nx, ny, nz = grid_shape
    with open_group(target, "w") as f:
        write_file_header(f, names.FILE_TYPE_CHECKPOINT)
        write_scalar(f, names.T_INDEX, int(t_index))
        write_scalar(f, names.NX, nx)
        write_scalar(f, names.NY, ny)
        write_scalar(f, names.NZ, nz)
        for attr, dname in _FIELD_NAMES:
            v = getattr(state, attr)
            if v is None:
                continue
            ds = create_dataset(f, dname, (nz, ny, nx))
            ds[...] = _host(v).reshape((nz, ny, nx))
        for sname, bufs in (stream_coeffs or {}).items():
            for i, buf in enumerate(bufs, start=1):
                if buf is None:
                    continue
                flat = np.asarray(buf, np.float32).reshape(-1)
                ds = create_dataset(f, f"Temp_{sname}_{i}", (1, 1, flat.size))
                ds[...] = flat.reshape(1, 1, -1)


def read_checkpoint(target) -> dict[str, Any]:
    """Returns {'t_index', 'grid_shape', 'fields': {dataset name: array}, 'stream_coeffs':
    {stream: (buf1, buf2|None)}} as numpy (recovery path,
    KSpaceFirstOrderSolver.cpp:186-228)."""
    with open_group(target, "r") as f:
        out: dict[str, Any] = {
            "t_index": read_scalar(f, names.T_INDEX),
            "grid_shape": (read_scalar(f, names.NX), read_scalar(f, names.NY),
                           read_scalar(f, names.NZ)),
            "fields": {},
            "stream_coeffs": {},
        }
        for _, dname in _FIELD_NAMES:
            if dname in f:
                out["fields"][dname] = np.array(f[dname][...], np.float32)
        for k in f.keys():
            if k.startswith("Temp_") and k.endswith("_1"):
                sname = k[len("Temp_"):-2]
                k2 = f"Temp_{sname}_2"
                out["stream_coeffs"][sname] = (
                    np.array(f[k][...], np.float32).reshape(-1),
                    np.array(f[k2][...], np.float32).reshape(-1) if k2 in f else None,
                )
        return out
