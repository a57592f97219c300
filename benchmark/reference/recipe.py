"""Inputs made from a seed, as a configuration file describes them.

Both sides are handed the same arrays: the harness turns them into the program's input
(an `InputData`, or a file written by the program's own writer) and the reference reads
them as they are. Everything large is drawn on ``device`` by a `torch.Generator` there, in a
few whole-array calls; the same seed on the same kind of device gives the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch


def f32(x: float) -> float:
    """A scalar as the input file stores it (float32), so that the in-memory and the file
    entries see one value."""
    return float(np.float32(x))


def generator(seed: int, device, stream: int) -> torch.Generator:
    """The generator of one independent draw (``stream``) of a run's ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def medium(config: dict, seed: int, device) -> dict:
    """The grid and a heterogeneous absorbing medium: c0 and rho0 uniform at random in
    the configuration's ranges, point by point, float32 on ``device``."""
    nz, ny, nx = config["grid"]
    dx = f32(config["dx"])
    lo_c, hi_c = config["c0_range"]
    lo_r, hi_r = config["rho0_range"]
    shape = (nz, ny, nx)
    c0 = torch.rand(shape, generator=generator(seed, device, 1), device=device)
    c0 = (lo_c + (hi_c - lo_c) * c0).to(torch.float32)
    rho0 = torch.rand(shape, generator=generator(seed, device, 2), device=device)
    rho0 = (lo_r + (hi_r - lo_r) * rho0).to(torch.float32)
    pml = int(config["pml_size"])
    return {
        "shape": shape, "dx": dx, "dt": f32(config["cfl"] * dx / config["c_dt"]),
        "c0": c0, "rho0": rho0,
        "alpha_coeff": f32(config["alpha_coeff"]), "alpha_power": f32(config["alpha_power"]),
        "pml_size": (pml, pml, pml), "pml_alpha": (f32(config["pml_alpha"]),) * 3,
    }


def random_sensors(n_points: int, count: int, seed: int, device) -> torch.Tensor:
    """``count`` distinct flat indices of the grid, sorted, on the host."""
    pick = torch.randperm(n_points, generator=generator(seed, device, 3), device=device)
    return torch.sort(pick[:count]).values.cpu()


def centre_p0(shape, amplitude: float, device) -> torch.Tensor:
    nz, ny, nx = shape
    p0 = torch.zeros(shape, dtype=torch.float32, device=device)
    p0[nz // 2, ny // 2, nx // 2] = amplitude
    return p0


def oracle_sample(n_sensors: int, count: int, seed: int) -> np.ndarray:
    """The sensors (positions in the mask) whose compressed streams the codec's oracle
    encodes again: ``count`` of them drawn from the seed, sorted."""
    rng = np.random.default_rng([int(seed) & 0xFFFF_FFFF, int(seed) >> 32, 7])
    return np.sort(rng.choice(n_sensors, size=min(count, n_sensors), replace=False))
