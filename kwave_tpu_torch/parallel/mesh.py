"""The mesh and the sharding rules for solver fields, operators and codec streams (port of
`kwave_tpu.parallel.mesh`).

- A `Mesh` is the ordered list of this process's shards' devices plus a communicator
  (`parallel.comm`): all S shards in one process (`InProcess`), or C shards on each of
  the P ranks of a `torch.distributed` process group (`ProcessGroup`, S = P·C).
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

    @property
    def graph_devices(self) -> tuple[torch.device, ...]:
        """The devices of this process's shards, in shard order, where its windows and
        its lead-in are captured as CUDA graphs (`kwave_tpu_torch.graphs`): every shard
        on a CUDA card, trading by tensor copies (`InProcess`: on one card, or across
        several, whose peer copies the one graph then holds) or over NCCL (a
        `ProcessGroup`: the graph holds the rank's C shards, their peer copies and one
        NCCL all-to-all a card). Empty for a mesh on the CPU and under gloo, whose windows
        run eagerly."""
        if any(d.type != "cuda" for d in self.devices):
            return ()
        if isinstance(self.comm, InProcess) or getattr(self.comm, "backend", None) == "nccl":
            return tuple(self.devices)
        return ()

    def __str__(self) -> str:
        where = ", ".join(map(str, self.devices))
        if isinstance(self.comm, InProcess):
            return f"{self.size} shards (in one process) on {where}"
        p = self.comm.n_processes
        return (f"{self.size} shards ({p} process{'es' if p > 1 else ''} x "
                f"{len(self.devices)}; rank {self.comm.rank}'s on {where})")


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence[torch.device | str]] = None) -> Mesh:
    """A 1-axis mesh of ``n_devices`` shards.

    Under an initialized `torch.distributed` process group of P ranks the mesh spans
    every rank, as the JAX package's spans every process's local devices
    (`kwave_tpu/parallel/mesh.py:29-35`): rank r holds shards r·C .. r·C + C - 1 on C
    devices of its own, ``devices`` when given (a device may be listed more than once),
    else C = ``n_devices`` / P (1 by default; ``n_devices`` must be a multiple of P) on
    the current card and the C - 1 after it for NCCL (those that
    `parallel.distributed.initialize(..., cards=C)` took), or C times the CPU for gloo.
    Otherwise all shards live in this process, on ``devices`` when given or on
    ``cuda:0`` .. ``cuda:n-1``, which must exist; nothing falls back to the CPU or stacks
    shards on one card unasked."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        if devices is not None:
            devices = [torch.device(d) for d in devices]
            if n_devices is not None and n_devices != world * len(devices):
                raise ValueError(f"a mesh of {n_devices} shards under a process group of "
                                 f"{world} ranks with {len(devices)} devices a rank")
        else:
            n = world if n_devices is None else n_devices
            if n < world or n % world:
                raise ValueError(f"a mesh of {n} shards under a process group of {world} "
                                 f"ranks: each rank takes the same number of shards")
            if kind == "cuda":
                first = torch.cuda.current_device()
                if first + n // world > torch.cuda.device_count():
                    raise RuntimeError(f"{n // world} cards a rank from cuda:{first}; "
                                       f"{torch.cuda.device_count()} present")
                devices = [torch.device("cuda", first + k) for k in range(n // world)]
            else:
                devices = [torch.device("cpu")] * (n // world)
        if any(d.type != kind for d in devices):
            raise ValueError(f"a {dist.get_backend()} process group trades {kind} "
                             f"tensors; shards listed on {', '.join(map(str, devices))}")
        c = len(devices)
        return Mesh(devices, ProcessGroup(devices), world * c,
                    [rank * c + k for k in range(c)])
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
