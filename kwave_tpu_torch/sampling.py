"""Sensor sampling and reduce operators (port of `kwave_tpu.sampling`).

The field is flattened x-fastest (``flat = x + nx*(y + ny*z)``), matching the reference's
layout (Utils/CudaUtils.cuh:82-125); sensor indices are 0-based (MATLAB 1-based masks are
rebased at load, IndexMatrix.h:115-117). Gathers are `torch.index_select` and slicing;
the reduces are the reference's templated kRms / kMax / kMin updates
(OutputStreamsCudaKernels.cu).
"""

from __future__ import annotations

import dataclasses

import torch


def sample_index(field_flat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """kNone: gather ``field[mask]`` (raw time series row; cudaSampleIndex,
    OutputStreamsCudaKernels.cu:83-107)."""
    return torch.index_select(field_flat, -1, mask)


def post_rms(buf: torch.Tensor, n_sampled_steps: int) -> torch.Tensor:
    """RMS finalization ``sqrt(buf * 1/(Nt - s))`` (cudaPostProcessingRms :359-365)."""
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        float(n_sampled_steps), dtype=torch.float32
    )
    return torch.sqrt(buf * inv.to(buf.device))


def init_reduce_buffer(op: str, n: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """Fresh aggregate buffer; max/min seed with -inf/+inf (equivalent to the reference's
    first-sample seeding under maximum/minimum)."""
    if op == "rms":
        return torch.zeros(n, dtype=torch.float32, device=device)
    if op == "max":
        return torch.full((n,), -torch.inf, dtype=torch.float32, device=device)
    if op == "min":
        return torch.full((n,), torch.inf, dtype=torch.float32, device=device)
    raise ValueError(f"unknown reduce op {op!r}")


# -- index-mask reduces (cudaSampleIndex :83-107) ---------------------------------------------


def sample_index_rms(buf: torch.Tensor, field_flat: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """kRms accumulate: ``buf += x*x`` at the masked points."""
    x = sample_index(field_flat, mask)
    return buf + x * x


def sample_index_max(buf: torch.Tensor, field_flat: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    return torch.maximum(buf, sample_index(field_flat, mask))


def sample_index_min(buf: torch.Tensor, field_flat: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    return torch.minimum(buf, sample_index(field_flat, mask))


# -- cuboid sampling (cudaSampleCuboid :202-230, transformCoordinates :164-188) ---------------


@dataclasses.dataclass(frozen=True)
class Cuboid:
    """Half-open cuboid [lo, hi) in (x, y, z), 0-based (the reference stores inclusive
    1-based corners, IndexMatrix.h:106-112)."""

    lo: tuple[int, int, int]
    hi: tuple[int, int, int]

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(h - l for l, h in zip(self.lo, self.hi))

    @property
    def size(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz


def sample_cuboid(field_3d: torch.Tensor, cuboid: Cuboid) -> torch.Tensor:
    """kNone: one cuboid as a [cz, cy, cx] block of ``field_3d[nz, ny, nx]`` (a view)."""
    (x0, y0, z0), (x1, y1, z1) = cuboid.lo, cuboid.hi
    return field_3d[z0:z1, y0:y1, x0:x1]


def sample_cuboid_flat(field_3d: torch.Tensor, cuboid: Cuboid) -> torch.Tensor:
    """The cuboid flattened x-fastest: the reference's linear cuboid buffer order (slab
    z, row y, x contiguous)."""
    return sample_cuboid(field_3d, cuboid).reshape(-1)


def sample_cuboid_rms(buf, field_3d, cuboid: Cuboid):
    x = sample_cuboid_flat(field_3d, cuboid)
    return buf + x * x


def sample_cuboid_max(buf, field_3d, cuboid: Cuboid):
    return torch.maximum(buf, sample_cuboid_flat(field_3d, cuboid))


def sample_cuboid_min(buf, field_3d, cuboid: Cuboid):
    return torch.minimum(buf, sample_cuboid_flat(field_3d, cuboid))


# -- whole-domain sampling (cudaSampleAll :297-316) --------------------------------------------


def sample_all_rms(buf: torch.Tensor, field_flat: torch.Tensor) -> torch.Tensor:
    return buf + field_flat * field_flat


def sample_all_max(buf: torch.Tensor, field_flat: torch.Tensor) -> torch.Tensor:
    return torch.maximum(buf, field_flat)


def sample_all_min(buf: torch.Tensor, field_flat: torch.Tensor) -> torch.Tensor:
    return torch.minimum(buf, field_flat)
