"""The mesh and the sharding rules for solver fields, operators and codec streams (port of
`kwave_tpu.parallel.mesh`).

- A `Mesh` is the ordered list of this process's shards' devices plus a communicator
  (`parallel.comm`): all S shards in one process (`InProcess`), or one shard a rank of a
  `torch.distributed` process group (`ProcessGroup`).
- Solver fields ``[nz, ny, nx]`` are split over z (the leading, non-reduced axis) into S
  slabs; spectral arrays live y-sharded (`parallel.fft`); codec sensor blocks split the
  sensor axis. Per-axis vectors and static scalars replicate, one tensor per device.
- A sharded value is a `Sharded`: this process's shards, in shard order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from kwave_tpu_torch.parallel.comm import InProcess, ProcessGroup
from kwave_tpu_torch.parallel.sharded import Sharded
from kwave_tpu_torch.sampling import split_sensors


@dataclasses.dataclass
class Mesh:
    """S shards: ``devices`` and ``shard_ids`` are this process's (in shard order),
    ``size`` is S over all processes."""

    devices: list[torch.device]
    comm: object  # InProcess | ProcessGroup
    size: int
    shard_ids: list[int]

    @property
    def is_writer(self) -> bool:
        """This process owns the output file (process 0)."""
        return self.comm.rank == 0

    def __str__(self) -> str:
        kind = "in one process" if isinstance(self.comm, InProcess) else \
            f"{self.comm.n_processes} processes"
        return f"{self.size} shards ({kind}) on {', '.join(map(str, self.devices))}"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence[torch.device | str]] = None) -> Mesh:
    """A 1-axis mesh of ``n_devices`` shards.

    Under an initialized `torch.distributed` process group the mesh is one shard a rank
    (``n_devices``, when given, must equal the world size) on this rank's device: the
    current card for NCCL, the CPU for gloo. Otherwise all shards live in this process, on
    ``devices`` when given (a device may be listed more than once: its shards then share
    it) or on ``cuda:0`` .. ``cuda:n-1``, which must exist; nothing falls back to the CPU
    or stacks shards on one card unasked."""
    import torch.distributed as dist

    in_group = dist.is_available() and dist.is_initialized()
    if in_group and (dist.get_world_size() > 1
                     or (devices is None and n_devices in (None, 1))):
        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"a mesh of {n_devices} shards under a process group of "
                             f"{world} ranks: one shard a rank")
        if dist.get_backend() == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device("cpu")
        return Mesh([device], ProcessGroup(), world, [dist.get_rank()])
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"make_mesh({n_devices}) with {len(devices)} devices listed")
    else:
        if n_devices is None:
            n_devices = torch.cuda.device_count()
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_devices < 1 or n_devices > have:
            raise RuntimeError(f"a mesh of {n_devices} CUDA devices asked for, {have} "
                               "present; list the devices to share one "
                               "(make_mesh(n, devices=[...]))")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    return Mesh(devices, InProcess(len(devices)), len(devices), list(range(len(devices))))


def _split(mesh: Mesh, x, dim: int, what: str) -> Sharded:
    """This process's equal blocks of ``x`` along ``dim``, each on its shard's device."""
    x = torch.as_tensor(x)
    if x.shape[dim] % mesh.size:
        raise ValueError(f"{what} = {x.shape[dim]} does not divide by the mesh's "
                         f"{mesh.size} shards")
    b = x.shape[dim] // mesh.size
    return Sharded([x.narrow(dim, i * b, b).contiguous().to(d)
                    for i, d in zip(mesh.shard_ids, mesh.devices)],
                   ids=mesh.shard_ids, axis=dim)


def replicated(mesh: Mesh, x) -> Sharded:
    """``x`` whole on every shard's device (one tensor a device)."""
    x = torch.as_tensor(x)
    return Sharded([x.to(d) for d in mesh.devices])


def field_sharding(mesh: Mesh, x) -> Sharded:
    """A field's z-slabs (its leading axis split into S equal blocks)."""
    return _split(mesh, x, 0, "nz")


def codec_sharding(mesh: Mesh, x) -> Sharded:
    """Codec arrays ``[..., N]``: the trailing sensor axis in S blocks as
    `torch.tensor_split` cuts it (the first N % S blocks one longer)."""
    x = torch.as_tensor(x)
    parts = torch.tensor_split(x, mesh.size, dim=-1)
    return Sharded([parts[i].contiguous().to(d) for i, d in zip(mesh.shard_ids,
                                                                mesh.devices)],
                   ids=mesh.shard_ids, axis=-1)


def shard_state(state, mesh: Mesh):
    """Every field of a `SimState` z-sharded (None stays None)."""
    return dataclasses.replace(state, **{
        f.name: None if getattr(state, f.name) is None
        else field_sharding(mesh, getattr(state, f.name))
        for f in dataclasses.fields(state)})


# per-axis vectors whose axis is sharded in the layout they are used in: the y-axis
# vectors of the spectral layout (y-sharded), the z-axis vectors of the real one
_SPECTRAL_Y = frozenset({"ddy_pos", "ddy_neg", "k2_y"})
_REAL_Z = frozenset({"pml_z", "pml_z_sgz", "dzudzn"})


def shard_operators(ops, grid_ndim: int, mesh: Mesh, grid):
    """The operator set on the mesh, laid out for the pencil FFT: full-grid real arrays
    follow the z-slabs; arrays of the rfft-reduced spectral shape go y-sharded (so every
    spectral multiply stays local); the y vectors of the spectral layout and the z vectors
    of the real one go in blocks; every other vector and 0-d tensor replicates; static
    floats stay floats. ``grid`` gives the real and spectral shapes."""
    if grid_ndim != 3:
        raise ValueError("meshes need a 3D grid (z-sharded fields, pencil FFT)")
    from kwave_tpu_torch.parallel.fft import spectral_sharding

    spec_shape = (grid.nz, grid.ny, grid.nx // 2 + 1)

    def put(name, x):
        if x is None or not isinstance(x, torch.Tensor):
            return x
        if tuple(x.shape) == spec_shape:
            return spectral_sharding(mesh, x)
        if x.ndim == grid_ndim and x.shape[0] == grid.nz > 1:
            # full-grid fields and the [nz, 1, 1] broadcasts of the nonuniform z maps
            # follow the slabs; [1, ny, 1] and [1, 1, nx] broadcasts replicate
            return field_sharding(mesh, x)
        if name in _SPECTRAL_Y:
            return _split(mesh, x, 0, "ny")
        if name in _REAL_Z:
            return _split(mesh, x, 0, "nz")
        return replicated(mesh, x)

    return dataclasses.replace(ops, **{f.name: put(f.name, getattr(ops, f.name))
                                       for f in dataclasses.fields(ops)})


def pencil_fft(mesh: Mesh, nx: int):
    """`solver.step.FftOps` bound to this mesh's pencil FFT (`parallel.fft`): pass it as
    the step's ``fft`` beside `shard_operators`' operators."""
    from kwave_tpu_torch.parallel import fft as dfft
    from kwave_tpu_torch.solver.step import FftOps

    return FftOps(
        rfftn=lambda x: dfft.dist_rfftn(x, mesh),
        irfftn=lambda xk, shape: dfft.dist_irfftn(xk, shape[-1], mesh),
        z_lines=lambda fn, x: dfft.along_z(fn, x, mesh),
    )


def split_points(mesh: Mesh, index, grid_shape, *rows) -> tuple:
    """Point sources on the z-slabs: ``index`` (flat indices into the grid) -> each
    shard's local indices of the points in its slab (in the index's order), and for each
    array of ``rows`` (``[n_points, ...]``, e.g. one signal a point; None passes through)
    the rows of those points. Returns (local index, *rows) as `Sharded` values."""
    split = split_sensors(index, grid_shape, mesh.size)
    local, parts = [], [[] for _ in rows]
    for k, d in zip(mesh.shard_ids, mesh.devices):
        local.append(torch.as_tensor(split.local[k], dtype=torch.int64, device=d))
        for r, arr in enumerate(rows):
            if arr is not None:
                parts[r].append(torch.as_tensor(np.asarray(arr)[split.select[k]]).to(d))
    return (Sharded(local),) + tuple(Sharded(p) if rows[r] is not None else None
                                     for r, p in enumerate(parts))
