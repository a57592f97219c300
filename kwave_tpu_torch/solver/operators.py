"""Spectral / PML / absorption operators for the k-space solver (port of
`kwave_tpu.solver.operators`).

The operators are generated once on the host in float64 NumPy with the reference's
formulas (`preProcessing`, KSpaceFirstOrderSolver.cpp:784-861) and cast to float32 /
complex64 tensors on the run's device. Spectral arrays use the rfft-reduced last (x) axis
of size nx//2+1. Scalar (homogeneous) media stay 0-d tensors and broadcast.

Fields are ``[nz, ny, nx]`` (``[ny, nx]`` in 2D), x fastest, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from kwave_tpu_torch.utils.observability import span


@dataclasses.dataclass(frozen=True)
class Grid:
    """Spatial/temporal discretization. 2D when nz == 1."""

    nx: int
    ny: int
    nz: int  # 1 => 2D
    dx: float
    dy: float
    dz: float
    dt: float
    nt: int

    @property
    def dim(self) -> int:
        return 2 if self.nz == 1 else 3

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.ny, self.nx) if self.dim == 2 else (self.nz, self.ny, self.nx)

    @property
    def n_elements(self) -> int:
        return self.nx * self.ny * self.nz


@dataclasses.dataclass
class Medium:
    """Material properties; scalars (floats) mean homogeneous. Heterogeneous arrays are
    full-grid float32. ``rho0_sg*`` may be given; when None and rho0 is an array, the
    staggered values are interpolated."""

    c0: Any
    rho0: Any
    rho0_sgx: Optional[Any] = None
    rho0_sgy: Optional[Any] = None
    rho0_sgz: Optional[Any] = None
    bona: Optional[Any] = None  # B/A nonlinearity parameter
    alpha_coeff: Optional[Any] = None  # absorption [dB/(MHz^y cm)]
    alpha_power: float = 1.5
    c_ref: Optional[float] = None  # reference sound speed for kappa; default max(c0)


@dataclasses.dataclass
class Operators:
    """Precomputed operator set: float32 tensors, complex64 for the spectral per-axis
    operators (i*k*exp(+-i*k*d/2) and the half-cell shifts)."""

    kappa: Optional[torch.Tensor]  # [*, nxR]; None in compact mode
    ddx_pos: torch.Tensor  # [nxR] complex64
    ddx_neg: torch.Tensor
    ddy_pos: torch.Tensor  # [ny]
    ddy_neg: torch.Tensor
    ddz_pos: Optional[torch.Tensor]  # [nz] (3D only)
    ddz_neg: Optional[torch.Tensor]
    pml_x: torch.Tensor  # [nx]
    pml_y: torch.Tensor
    pml_z: Optional[torch.Tensor]
    pml_x_sgx: torch.Tensor
    pml_y_sgy: torch.Tensor
    pml_z_sgz: Optional[torch.Tensor]
    dt_rho0_sgx: torch.Tensor  # scalar or full: dt / rho0_sgx
    dt_rho0_sgy: torch.Tensor
    dt_rho0_sgz: Optional[torch.Tensor]
    rho0: torch.Tensor  # scalar or full
    c2: Optional[torch.Tensor]  # scalar or full; None in compact mode
    bona: Optional[torch.Tensor]
    absorb_nabla1: Optional[torch.Tensor]  # [*, nxR]
    absorb_nabla2: Optional[torch.Tensor]
    absorb_tau: Optional[torch.Tensor]  # scalar or full
    absorb_eta: Optional[torch.Tensor]
    source_kappa: Optional[torch.Tensor]  # [*, nxR] (additive sources only)
    # half-cell backward shifts exp(-i*k*d/2), rfft-reduced on x (complex64)
    shift_x_neg: Optional[torch.Tensor] = None
    shift_y_neg: Optional[torch.Tensor] = None
    shift_z_neg: Optional[torch.Tensor] = None
    # non-uniform grid stretch maps (regular points)
    dxudxn: Optional[torch.Tensor] = None
    dyudyn: Optional[torch.Tensor] = None
    dzudzn: Optional[torch.Tensor] = None
    # compact mode (make_operators(compact=True)): kappa, source_kappa, absorb_nabla1/2,
    # c2 and absorb_tau/eta stay None, and the step rebuilds them from these per-axis
    # squared-wavenumber vectors and c0 (step._kappa and the accessors beside it)
    k2_x: Optional[torch.Tensor] = None  # [nxR] kx^2 (rfft-reduced)
    k2_y: Optional[torch.Tensor] = None  # [ny]
    k2_z: Optional[torch.Tensor] = None  # [nz] (3D only)
    c0: Optional[torch.Tensor] = None  # scalar or full
    alpha2: Optional[torch.Tensor] = None  # 2*alpha_coeff*alpha_np (tau/eta prefactor)
    dt: float = 0.0
    c_ref_dt_2: float = 0.0
    alpha_power: float = 1.5


def _k_components(n: int, d: float) -> np.ndarray:
    """Wavenumber magnitude per FFT bin: 2*pi/d * (0.5 - |0.5 - i/n|) (generateKappa,
    KSpaceFirstOrderSolver.cpp:2425-2440)."""
    i = np.arange(n, dtype=np.float64)
    return 2.0 * np.pi / d * (0.5 - np.abs(0.5 - i / n))


def _k_grid(grid: Grid) -> np.ndarray:
    """|k| over the reduced spectral grid, float64."""
    kx = _k_components(grid.nx, grid.dx)[: grid.nx // 2 + 1]
    ky = _k_components(grid.ny, grid.dy)
    if grid.dim == 2:
        return np.sqrt(kx[None, :] ** 2 + ky[:, None] ** 2)
    kz = _k_components(grid.nz, grid.dz)
    return np.sqrt(
        kx[None, None, :] ** 2 + ky[None, :, None] ** 2 + kz[:, None, None] ** 2
    )


def make_kappa(grid: Grid, c_ref: float) -> np.ndarray:
    """sinc k-space correction, 1 at k=0 (generateKappa :2404-2452)."""
    arg = (c_ref * grid.dt / 2.0) * _k_grid(grid)
    with np.errstate(invalid="ignore"):
        kap = np.where(arg == 0.0, 1.0, np.sin(arg) / np.where(arg == 0, 1.0, arg))
    return kap.astype(np.float32)


def make_source_kappa(grid: Grid, c_ref: float) -> np.ndarray:
    """cos(c_ref*dt*k/2) for additive-source correction (generateSourceKappa :2460-2506)."""
    return np.cos((c_ref * grid.dt / 2.0) * _k_grid(grid)).astype(np.float32)


def make_absorb_nablas(grid: Grid, alpha_power: float):
    """|k|^(y-2), |k|^(y-1) with inf -> 0 (generateKappaAndNablas :2568-2576)."""
    k = _k_grid(grid)
    with np.errstate(divide="ignore"):
        n1 = k ** (alpha_power - 2.0)
        n2 = k ** (alpha_power - 1.0)
    n1[~np.isfinite(n1)] = 0.0
    n2[~np.isfinite(n2)] = 0.0
    return n1.astype(np.float32), n2.astype(np.float32)


def make_tau_eta(alpha_coeff, c0, alpha_power: float):
    """Power-law absorption tau/eta (generateTauAndEta :2587-2652)."""
    alpha_np = (100.0 * (1.0e-6 / (2.0 * np.pi)) ** alpha_power) / (
        20.0 * math.log10(math.e)
    )
    a2 = 2.0 * np.asarray(alpha_coeff, np.float64) * alpha_np
    c = np.asarray(c0, np.float64)
    tau = (-a2) * c ** (alpha_power - 1.0)
    eta = a2 * (c**alpha_power) * math.tan(math.pi / 2.0 * alpha_power)
    return tau.astype(np.float32), eta.astype(np.float32)


def _signed_k(n: int, d: float, reduced: bool) -> np.ndarray:
    """Signed wavenumbers 2*pi*fftfreq(n, d); on the rfft half-axis bins 0..n/2 are
    non-negative except the Nyquist bin of even n, which keeps its negative sign."""
    k = 2.0 * np.pi * np.fft.fftfreq(n, d)
    if reduced:
        kr = np.abs(k[: n // 2 + 1])
        if n % 2 == 0:
            kr[-1] = k[n // 2]
        k = kr
    return k


def make_ddk_shift(n: int, d: float, reduced: bool):
    """Spectral derivative with half-grid shift: (pos, neg) = i*k*exp(+-i*k*d/2)."""
    k = _signed_k(n, d, reduced)
    pos = 1j * k * np.exp(1j * k * d / 2.0)
    neg = 1j * k * np.exp(-1j * k * d / 2.0)
    return pos.astype(np.complex64), neg.astype(np.complex64)


def make_shift_neg(n: int, d: float, reduced: bool) -> np.ndarray:
    """Half-cell backward shift exp(-i*k*d/2) (x_shift_neg_r etc.,
    MatrixContainer.cpp:377-388)."""
    return np.exp(-1j * _signed_k(n, d, reduced) * d / 2.0).astype(np.complex64)


def make_pml(n: int, size: int, alpha_max: float, c_ref: float, d: float, dt: float,
             staggered: bool):
    """Exponential PML damping profile over one axis (k-Wave getPML): ramp
    alpha_max*(x/L)^4 inside the layer, applied as exp(-alpha*c_ref*dt/(2*dx))."""
    x = np.arange(n, dtype=np.float64)
    if staggered:
        x = x + 0.5
    d_left = np.clip(size - x, 0.0, None) if size > 0 else np.zeros(n)
    d_right = np.clip(x - (n - 1 - size), 0.0, None) if size > 0 else np.zeros(n)
    ramp = np.maximum(d_left, d_right) / max(size, 1)
    alpha = alpha_max * ramp**4
    pml = np.exp(-alpha * c_ref * dt / (2.0 * d))
    pml[ramp == 0.0] = 1.0
    return pml.astype(np.float32)


def _stagger(rho: np.ndarray, axis: int) -> np.ndarray:
    """Half-grid-forward linear interpolation with edge replication."""
    fwd = np.roll(rho, -1, axis=axis)
    idx = [slice(None)] * rho.ndim
    idx[axis] = -1
    fwd[tuple(idx)] = np.take(rho, -1, axis=axis)
    return 0.5 * (rho + fwd)


def make_operators(
    grid: Grid,
    medium: Medium,
    pml_size: tuple[int, ...] = (20, 20, 20),
    pml_alpha: tuple[float, ...] = (2.0, 2.0, 2.0),
    absorbing: bool = False,
    need_source_kappa: bool = False,
    need_shift: bool = False,
    nonuniform: Optional[dict] = None,
    device: torch.device | str = "cpu",
    compact: bool = False,
) -> Operators:
    """Build the full operator set for one simulation (reference preProcessing,
    KSpaceFirstOrderSolver.cpp:784-861): float64 NumPy on the host, then float32 /
    complex64 tensors on ``device``.

    ``compact=True`` leaves the radially symmetric spectral arrays (kappa, source_kappa,
    absorb_nabla1/2) and the c0-derived media fields (c2, absorb_tau/eta) out: the step
    rebuilds them on the device from the per-axis k^2 vectors and c0. The results agree
    to fp32 rounding."""
    with span("kwave.operators"):
        with span("kwave.operators.build"):
            host, c_ref = _host_operators(grid, medium, pml_size, pml_alpha, absorbing,
                                          need_source_kappa, need_shift, nonuniform,
                                          compact)
        with span("kwave.operators.to_device"):
            return Operators(
                **{k: None if v is None else torch.as_tensor(np.asarray(v)).to(device)
                   for k, v in host.items()},
                dt=float(grid.dt),
                c_ref_dt_2=float(c_ref * grid.dt / 2.0),
                alpha_power=float(medium.alpha_power),
            )


def _host_operators(grid: Grid, medium: Medium, pml_size, pml_alpha, absorbing: bool,
                    need_source_kappa: bool, need_shift: bool, nonuniform: Optional[dict],
                    compact: bool) -> tuple[dict[str, Any], float]:
    """`make_operators`' arrays on the host (None where the run needs none), by field
    name, and the reference sound speed."""
    c0 = np.asarray(medium.c0, np.float64)
    c_ref = float(medium.c_ref) if medium.c_ref is not None else float(c0.max())
    dim = grid.dim

    kappa = nabla1 = nabla2 = tau = eta = None
    k2_x = k2_y = k2_z = alpha2 = None
    if compact:
        k2_x = (_k_components(grid.nx, grid.dx)[: grid.nx // 2 + 1] ** 2).astype(np.float32)
        k2_y = (_k_components(grid.ny, grid.dy) ** 2).astype(np.float32)
        if dim == 3:
            k2_z = (_k_components(grid.nz, grid.dz) ** 2).astype(np.float32)
        if absorbing:
            alpha_np = (100.0 * (1.0e-6 / (2.0 * np.pi)) ** medium.alpha_power) / (
                20.0 * math.log10(math.e)
            )
            alpha2 = np.asarray(
                2.0 * np.asarray(medium.alpha_coeff, np.float64) * alpha_np, np.float32
            )
    else:
        kappa = make_kappa(grid, c_ref)
        if absorbing:
            nabla1, nabla2 = make_absorb_nablas(grid, medium.alpha_power)
            tau, eta = make_tau_eta(medium.alpha_coeff, medium.c0, medium.alpha_power)

    ddx_pos, ddx_neg = make_ddk_shift(grid.nx, grid.dx, reduced=True)
    ddy_pos, ddy_neg = make_ddk_shift(grid.ny, grid.dy, reduced=False)
    ddz_pos = ddz_neg = None
    if dim == 3:
        ddz_pos, ddz_neg = make_ddk_shift(grid.nz, grid.dz, reduced=False)

    psz = tuple(pml_size) + (0,) * (3 - len(tuple(pml_size)))
    pal = tuple(pml_alpha) + (0.0,) * (3 - len(tuple(pml_alpha)))
    pml = {
        "pml_x": make_pml(grid.nx, psz[0], pal[0], c_ref, grid.dx, grid.dt, False),
        "pml_y": make_pml(grid.ny, psz[1], pal[1], c_ref, grid.dy, grid.dt, False),
        "pml_x_sgx": make_pml(grid.nx, psz[0], pal[0], c_ref, grid.dx, grid.dt, True),
        "pml_y_sgy": make_pml(grid.ny, psz[1], pal[1], c_ref, grid.dy, grid.dt, True),
        "pml_z": None,
        "pml_z_sgz": None,
    }
    if dim == 3:
        pml["pml_z"] = make_pml(grid.nz, psz[2], pal[2], c_ref, grid.dz, grid.dt, False)
        pml["pml_z_sgz"] = make_pml(grid.nz, psz[2], pal[2], c_ref, grid.dz, grid.dt, True)

    rho0 = np.asarray(medium.rho0, np.float32)

    def sg(given, axis):
        if given is not None:
            return np.asarray(given, np.float32)
        if rho0.ndim == 0:
            return rho0
        return _stagger(rho0.astype(np.float64), axis).astype(np.float32)

    # axis order [z, y, x] (or [y, x] in 2D): x is the last axis
    ax_x, ax_y, ax_z = (dim - 1, dim - 2, 0)
    dt = np.float32(grid.dt)
    dt_rho0_sgx = (dt / sg(medium.rho0_sgx, ax_x)).astype(np.float32)
    dt_rho0_sgy = (dt / sg(medium.rho0_sgy, ax_y)).astype(np.float32)
    dt_rho0_sgz = (dt / sg(medium.rho0_sgz, ax_z)).astype(np.float32) if dim == 3 else None

    dxudxn = dyudyn = dzudzn = None
    if nonuniform:
        # staggered stretch maps fold into dt/rho0_sg (generateInitialDenisty :2685-2694);
        # regular maps scale the velocity gradients
        def vec(name, n):
            v = nonuniform.get(name)
            return None if v is None else np.asarray(v, np.float32).reshape(n)

        sgx = vec("dxudxn_sgx", grid.nx)
        sgy = vec("dyudyn_sgy", grid.ny)
        sgz = vec("dzudzn_sgz", grid.nz) if dim == 3 else None
        bx = (1,) * (dim - 1) + (grid.nx,)
        by = (1,) * (dim - 2) + (grid.ny,) + (1,)
        if sgx is not None:
            dt_rho0_sgx = (dt_rho0_sgx * sgx.reshape(bx)).astype(np.float32)
        if sgy is not None:
            dt_rho0_sgy = (dt_rho0_sgy * sgy.reshape(by)).astype(np.float32)
        if dim == 3 and sgz is not None:
            dt_rho0_sgz = (dt_rho0_sgz * sgz.reshape(grid.nz, 1, 1)).astype(np.float32)
        dxudxn = vec("dxudxn", grid.nx)
        dyudyn = vec("dyudyn", grid.ny)
        dzudzn = vec("dzudzn", grid.nz) if dim == 3 else None

    host = dict(
        kappa=kappa,
        ddx_pos=ddx_pos, ddx_neg=ddx_neg,
        ddy_pos=ddy_pos, ddy_neg=ddy_neg,
        ddz_pos=ddz_pos, ddz_neg=ddz_neg,
        **pml,
        dt_rho0_sgx=dt_rho0_sgx, dt_rho0_sgy=dt_rho0_sgy, dt_rho0_sgz=dt_rho0_sgz,
        rho0=rho0,
        c2=None if compact else (c0 * c0).astype(np.float32),
        bona=None if medium.bona is None else np.asarray(medium.bona, np.float32),
        absorb_nabla1=nabla1, absorb_nabla2=nabla2,
        absorb_tau=tau, absorb_eta=eta,
        source_kappa=(make_source_kappa(grid, c_ref)
                      if need_source_kappa and not compact else None),
        # each shift is a 1D rfft along its own axis, so all three are rfft-reduced
        shift_x_neg=make_shift_neg(grid.nx, grid.dx, True) if need_shift else None,
        shift_y_neg=make_shift_neg(grid.ny, grid.dy, True) if need_shift else None,
        shift_z_neg=(make_shift_neg(grid.nz, grid.dz, True)
                     if need_shift and dim == 3 else None),
        dxudxn=dxudxn, dyudyn=dyudyn, dzudzn=dzudzn,
        k2_x=k2_x, k2_y=k2_y, k2_z=k2_z,
        c0=c0.astype(np.float32) if compact else None, alpha2=alpha2,
    )
    return host, c_ref
