"""Spectral / PML / absorption operators for the k-space solver (port of
`kwave_tpu.solver.operators`).

The operators are built once a run, on the run's device, with the reference's formulas
(`preProcessing`, KSpaceFirstOrderSolver.cpp:784-861): the medium's arrays go to the
device as the host holds them, the full-grid and spectral arrays are computed there in
float64 torch and cast to float32, and the per-axis vectors (wavenumbers, derivative
shifts, PML profiles) come from float64 NumPy on the host. Spectral arrays use the
rfft-reduced last (x) axis of size nx//2+1. Scalar (homogeneous) media stay 0-d tensors
and broadcast.

Fields are ``[nz, ny, nx]`` (``[ny, nx]`` in 2D), x fastest, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from kwave_tpu_torch.utils.observability import span

# `make_operators` calls by the type of the device that built them ("cuda", "cpu")
BUILDS: dict[str, int] = {}


def reset_build_counts() -> None:
    BUILDS.clear()


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


def _k2_axes(grid: Grid) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Squared wavenumbers of each axis, float64 on the host: x rfft-reduced, y, and z
    (None in 2D)."""
    kx2 = _k_components(grid.nx, grid.dx)[: grid.nx // 2 + 1] ** 2
    ky2 = _k_components(grid.ny, grid.dy) ** 2
    kz2 = _k_components(grid.nz, grid.dz) ** 2 if grid.dim == 3 else None
    return kx2, ky2, kz2


# the largest block that the CUDA caching allocator serves from its pool of small blocks
_SMALL_BLOCK = 1 << 20


def _spectral(grid: Grid, device, fn) -> torch.Tensor:
    """``fn(|k|)`` over the reduced spectral grid, float32 on ``device``: ``fn`` takes
    |k| in float64 and may change it, and runs on a slab of leading-axis planes at a
    time. A slab's float64 temporaries fit the caching allocator's small blocks, so the
    build leaves no freed float64 spectral array in its pool of large blocks: a float32
    field of the grid placed there later would count the array's extra bytes
    (nz * ny * 8) in the run's peak memory."""
    kx2, ky2, kz2 = (None if v is None else torch.from_numpy(v).to(device)
                     for v in _k2_axes(grid))
    if grid.dim == 2:
        base, lead = kx2[None, :], ky2[:, None]
    else:
        base, lead = kx2[None, None, :] + ky2[None, :, None], kz2[:, None, None]
    shape = (lead.shape[0],) + tuple(base.shape[1:])
    out = torch.empty(shape, dtype=torch.float32, device=device)
    rows = max(1, _SMALL_BLOCK // (8 * math.prod(shape[1:])))
    for r in range(0, shape[0], rows):
        out[r:r + rows] = fn((base + lead[r:r + rows]).sqrt_())
    return out


def _power(e: float, device):
    """``x -> x ** e`` on float64 ``x`` as NumPy's ``**`` computes it: a square root at
    e = 0.5, its general power otherwise. The exponent is a tensor on ``device``, which
    keeps torch's scalar special cases (rsqrt at -0.5, reciprocals, cubes) out."""
    if e == 0.5:
        return torch.sqrt
    exponent = torch.tensor(float(e), dtype=torch.float64, device=device)
    return lambda x: torch.pow(x, exponent)


def make_kappa(grid: Grid, c_ref: float, device="cpu") -> torch.Tensor:
    """sinc k-space correction, 1 at k=0 (generateKappa :2404-2452)."""

    def kappa(k):
        arg = k.mul_(c_ref * grid.dt / 2.0)
        zero = arg == 0.0
        return torch.sin(arg).div_(arg.masked_fill_(zero, 1.0)).masked_fill_(zero, 1.0)

    return _spectral(grid, device, kappa)


def make_source_kappa(grid: Grid, c_ref: float, device="cpu") -> torch.Tensor:
    """cos(c_ref*dt*k/2) for additive-source correction (generateSourceKappa :2460-2506)."""
    return _spectral(grid, device, lambda k: k.mul_(c_ref * grid.dt / 2.0).cos_())


def make_absorb_nablas(grid: Grid, alpha_power: float, device="cpu"):
    """|k|^(y-2), |k|^(y-1) with inf -> 0 (generateKappaAndNablas :2568-2576)."""

    def nabla(e):
        power = _power(e, device)

        def fn(k):
            n = power(k)
            return n.masked_fill_(~torch.isfinite(n), 0.0)
        return fn

    return tuple(_spectral(grid, device, nabla(e))
                 for e in (alpha_power - 2.0, alpha_power - 1.0))


def _alpha2(alpha_coeff: torch.Tensor, alpha_power: float) -> torch.Tensor:
    """2 * alpha_coeff * alpha_np in float64, the prefactor of tau and eta, with
    alpha_np = 100 * (1e-6 / (2*pi))^y / (20 * log10(e))."""
    alpha_np = (100.0 * (1.0e-6 / (2.0 * np.pi)) ** alpha_power) / (
        20.0 * math.log10(math.e)
    )
    return alpha_coeff.double().mul(2.0).mul_(alpha_np)


def make_tau_eta(alpha_coeff: torch.Tensor, c0: torch.Tensor, alpha_power: float):
    """Power-law absorption tau/eta (generateTauAndEta :2587-2652) from ``alpha_coeff``
    and ``c0``, 0-d or full tensors on the run's device."""
    a2 = _alpha2(alpha_coeff, alpha_power)
    c = c0.double()
    tau = torch.mul(_power(alpha_power - 1.0, c.device)(c), a2).neg_().float()
    eta = torch.mul(_power(alpha_power, c.device)(c), a2)
    eta.mul_(math.tan(math.pi / 2.0 * alpha_power))
    return tau, eta.float()


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


def _stagger(rho: torch.Tensor, axis: int) -> torch.Tensor:
    """Half-grid-forward linear interpolation with edge replication, in float64 (float32
    in and out)."""
    n = rho.shape[axis]
    fwd = torch.cat([rho.narrow(axis, 1, n - 1), rho.narrow(axis, n - 1, 1)], axis)
    return fwd.double().add_(rho).mul_(0.5).float()


def _upload(x, device, dtype=None) -> torch.Tensor:
    """A host input on ``device``, as ``dtype`` or else as the host holds it: float32
    stays float32, anything else goes as float64, so that the float64 formulas read the
    host's value."""
    a = np.asarray(x)
    if dtype is None:
        dtype = np.float32 if a.dtype == np.float32 else np.float64
    return torch.from_numpy(np.asarray(a, dtype, order="C")).to(device)


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
    KSpaceFirstOrderSolver.cpp:784-861) on ``device``: the medium's arrays go there
    first, and the full-grid and spectral arrays are computed there in float64 and cast
    to float32 (complex64 for the per-axis spectral vectors, made on the host).

    ``compact=True`` leaves the radially symmetric spectral arrays (kappa, source_kappa,
    absorb_nabla1/2) and the c0-derived media fields (c2, absorb_tau/eta) out: the step
    rebuilds them on the device from the per-axis k^2 vectors and c0. The results agree
    to fp32 rounding."""
    device = torch.device(device)
    with span("kwave.operators"):
        with span("kwave.operators.to_device"):
            inputs = _inputs(grid, medium, absorbing, nonuniform, device)
        with span("kwave.operators.build"):
            fields, c_ref = _build(grid, medium, inputs, pml_size, pml_alpha, absorbing,
                                   need_source_kappa, need_shift, compact, device)
        BUILDS[device.type] = BUILDS.get(device.type, 0) + 1
        return Operators(**fields, dt=float(grid.dt),
                         c_ref_dt_2=float(c_ref * grid.dt / 2.0),
                         alpha_power=float(medium.alpha_power))


def _inputs(grid: Grid, medium: Medium, absorbing: bool, nonuniform: Optional[dict],
            device: torch.device) -> dict[str, Optional[torch.Tensor]]:
    """The medium's host inputs on ``device``, each once (None where absent): c0 and
    alpha_coeff as the host holds them, rho0, the rho0_sg*, bona and the stretch maps as
    float32 (the maps reshaped to their axis)."""
    f32 = np.float32
    up = {
        "c0": _upload(medium.c0, device),
        "rho0": _upload(medium.rho0, device, f32),
        "alpha_coeff": _upload(medium.alpha_coeff, device) if absorbing else None,
        "bona": None if medium.bona is None else _upload(medium.bona, device, f32),
    }
    for name in ("rho0_sgx", "rho0_sgy", "rho0_sgz"):
        given = getattr(medium, name)
        up[name] = None if given is None else _upload(given, device, f32)
    sizes = {"x": grid.nx, "y": grid.ny, "z": grid.nz}
    for a in "xyz" if nonuniform else ():
        for name in (f"d{a}ud{a}n", f"d{a}ud{a}n_sg{a}"):
            v = nonuniform.get(name)
            if v is not None and (a != "z" or grid.dim == 3):
                up[name] = _upload(np.asarray(v, f32).reshape(sizes[a]), device)
    return up


def _build(grid: Grid, medium: Medium, up: dict, pml_size, pml_alpha, absorbing: bool,
           need_source_kappa: bool, need_shift: bool, compact: bool,
           device: torch.device) -> tuple[dict[str, Any], float]:
    """`make_operators`' arrays on ``device`` (None where the run needs none), by field
    name, and the reference sound speed. One float64 array at a time: each temporary is
    gone before the next array starts."""
    c0 = up["c0"]
    c_ref = float(medium.c_ref) if medium.c_ref is not None else float(c0.max())
    dim = grid.dim

    def vec(v, dtype=None):
        return None if v is None else torch.from_numpy(np.asarray(v, dtype)).to(device)

    out: dict[str, Any] = {f.name: None for f in dataclasses.fields(Operators)
                           if f.name not in ("dt", "c_ref_dt_2", "alpha_power")}
    if compact:
        for name, k2 in zip(("k2_x", "k2_y", "k2_z"), _k2_axes(grid)):
            out[name] = vec(k2, np.float32)
        if absorbing:
            out["alpha2"] = _alpha2(up["alpha_coeff"], medium.alpha_power).float()
        out["c0"] = c0.float()
    else:
        out["kappa"] = make_kappa(grid, c_ref, device)
        if absorbing:
            out["absorb_nabla1"], out["absorb_nabla2"] = make_absorb_nablas(
                grid, medium.alpha_power, device)
            out["absorb_tau"], out["absorb_eta"] = make_tau_eta(
                up["alpha_coeff"], c0, medium.alpha_power)
        c = c0.double()
        out["c2"] = torch.mul(c, c).float()
        del c
        if need_source_kappa:
            out["source_kappa"] = make_source_kappa(grid, c_ref, device)

    out["ddx_pos"], out["ddx_neg"] = map(vec, make_ddk_shift(grid.nx, grid.dx, True))
    out["ddy_pos"], out["ddy_neg"] = map(vec, make_ddk_shift(grid.ny, grid.dy, False))
    if dim == 3:
        out["ddz_pos"], out["ddz_neg"] = map(vec, make_ddk_shift(grid.nz, grid.dz, False))

    psz = tuple(pml_size) + (0,) * (3 - len(tuple(pml_size)))
    pal = tuple(pml_alpha) + (0.0,) * (3 - len(tuple(pml_alpha)))
    for i, (a, n, d) in enumerate(zip("xyz"[:dim], (grid.nx, grid.ny, grid.nz),
                                      (grid.dx, grid.dy, grid.dz))):
        out[f"pml_{a}"] = vec(make_pml(n, psz[i], pal[i], c_ref, d, grid.dt, False))
        out[f"pml_{a}_sg{a}"] = vec(make_pml(n, psz[i], pal[i], c_ref, d, grid.dt, True))

    # dt / rho0_sg in float32, the staggered densities interpolated in float64 where the
    # input gives none; the staggered stretch maps fold in (generateInitialDenisty
    # :2685-2694). Axis order [z, y, x] (or [y, x] in 2D): x is the last axis.
    rho0 = up["rho0"]
    dt = torch.tensor(np.float32(grid.dt), device=device)
    for a, axis, bshape in (("x", dim - 1, (1,) * (dim - 1) + (grid.nx,)),
                            ("y", dim - 2, (1,) * (dim - 2) + (grid.ny, 1)),
                            ("z", 0, (grid.nz, 1, 1)))[:dim]:
        sg = up[f"rho0_sg{a}"]
        if sg is None:
            sg = rho0 if rho0.ndim == 0 else _stagger(rho0, axis)
        dt_rho0 = torch.div(dt, sg)
        del sg
        stretch = up.get(f"d{a}ud{a}n_sg{a}")
        if stretch is not None:
            dt_rho0 = dt_rho0 * stretch.reshape(bshape)
        out[f"dt_rho0_sg{a}"] = dt_rho0
        out[f"d{a}ud{a}n"] = up.get(f"d{a}ud{a}n")

    out["rho0"] = rho0
    out["bona"] = up["bona"]
    if need_shift:
        # each shift is a 1D rfft along its own axis, so all three are rfft-reduced
        for a, n, d in zip("xyz"[:dim], (grid.nx, grid.ny, grid.nz),
                           (grid.dx, grid.dy, grid.dz)):
            out[f"shift_{a}_neg"] = vec(make_shift_neg(n, d, True))
    return out, c_ref
