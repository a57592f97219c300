"""The k-space first-order timestep in PyTorch (port of `kwave_tpu.solver.step`).

One `step` call reproduces one iteration of the reference main loop
(KSpaceFirstOrderSolver::computeMainLoop, KSpaceFirstOrderSolver.cpp:864-943):

  velocity update -> velocity source -> transducer source -> velocity gradient ->
  density update (linear|nonlinear) -> pressure source -> pressure update
  (lossless|absorbing x linear|nonlinear) -> [t==0: initial pressure source].

The spectral work goes through an `FftOps` pair: `LOCAL_FFT` (``torch.fft.rfftn``/``irfftn``
over the last ``ndim`` axes, cuFFT on the card) by default, the mesh's pencil FFT
(`kwave_tpu_torch.parallel.pencil_fft`) on z-sharded fields; or, when the caller passes a
``spectral_multi`` pipeline (`kwave_tpu_torch.ops.zfuse.make_pipeline`), that pipeline
for every transform of the step: x/y transforms around one kernel that does z-DFT,
operator and z-IDFT. The elementwise updates are plain tensor expressions in the JAX
package's order; on a mesh they run shard by shard (`kwave_tpu_torch.parallel.Sharded`).
Fields are float32 ``[nz, ny, nx]`` (``[ny, nx]`` in 2D), x fastest. The time index ``t``
is a host integer, so source gating is a host branch. No tensor is updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from kwave_tpu_torch.ops.zfuse import OpSpec
from kwave_tpu_torch.solver.operators import Grid, Operators

# Source modes (Parameters.h:73-81).
DIRICHLET = 0
ADDITIVE_NO_CORRECTION = 1
ADDITIVE = 2


@dataclasses.dataclass
class SimState:
    """The time-marched fields (the 7 checkpointed matrices, MatrixContainer.cpp:29-42)."""

    p: torch.Tensor
    ux_sgx: torch.Tensor
    uy_sgy: torch.Tensor
    uz_sgz: Optional[torch.Tensor]
    rho_x: torch.Tensor
    rho_y: torch.Tensor
    rho_z: Optional[torch.Tensor]


@dataclasses.dataclass
class Sources:
    """Source terms; any member may be None (the flags live in SolverConfig).

    Signals are ``[T]`` (many=False) or ``[n_idx, T]`` (many=True). Indices are 0-based
    flat int64 indices into the x-fastest flattened grid."""

    p0: Optional[torch.Tensor] = None  # initial pressure [grid]
    p_index: Optional[torch.Tensor] = None  # [n]
    p_signal: Optional[torch.Tensor] = None  # [T] or [n, T]
    u_index: Optional[torch.Tensor] = None
    ux_signal: Optional[torch.Tensor] = None
    uy_signal: Optional[torch.Tensor] = None
    uz_signal: Optional[torch.Tensor] = None
    transducer_index: Optional[torch.Tensor] = None  # [n]
    transducer_signal: Optional[torch.Tensor] = None  # [T_sig]
    delay_mask: Optional[torch.Tensor] = None  # [n] per-element delays


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver switches: the reference's Parameters flag surface."""

    nonlinear: bool = False
    absorbing: bool = False
    p0_source_flag: bool = False
    p_source_flag: int = 0  # #steps the source is active (0 = off)
    p_source_mode: int = DIRICHLET
    p_source_many: bool = False
    u_source_flag: int = 0
    u_source_mode: int = DIRICHLET
    u_source_many: bool = False
    transducer_source_flag: int = 0
    sampling_start_index: int = 0  # -s flag, 0-based here


def init_state(grid: Grid, device: torch.device | str = "cpu") -> SimState:
    """All-zero fields, each its own tensor."""
    def z():
        return torch.zeros(grid.shape, dtype=torch.float32, device=device)

    is3d = grid.dim == 3
    return SimState(p=z(), ux_sgx=z(), uy_sgy=z(), uz_sgz=z() if is3d else None,
                    rho_x=z(), rho_y=z(), rho_z=z() if is3d else None)


# ---------------------------------------------------------------------------
# Spectral helpers
# ---------------------------------------------------------------------------


def _bc(vec: torch.Tensor, axis_from_end: int, ndim: int) -> torch.Tensor:
    """Reshape a per-axis operator vector for broadcasting over an ndim-D array."""
    shape = [1] * ndim
    shape[ndim - 1 - axis_from_end] = vec.shape[0]
    return vec.reshape(shape)


def _rfftn(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.rfftn(x, dim=tuple(range(-x.ndim, 0)))


def _irfftn(xk: torch.Tensor, shape) -> torch.Tensor:
    return torch.fft.irfftn(xk, s=tuple(shape), dim=tuple(range(-len(shape), 0)))


class FftOps(NamedTuple):
    """The spectral transform pair of the step: `LOCAL_FFT` on one device, the pencil FFT
    (`kwave_tpu_torch.parallel.pencil_fft`) on a mesh. ``irfftn`` takes the real shape
    (of a shard, on a mesh). The JAX package's hooks for its matmul FFT (``shift_axis``,
    ``batched``) are left out with that FFT. ``z_lines(fn, u)``, when set, applies ``fn``
    along z of a z-sharded field (the mesh trades it to y-blocks and back): the z
    half-cell shift of `shifted_velocity`."""

    rfftn: Callable[[Any], Any]
    irfftn: Callable[[Any, tuple[int, ...]], Any]
    z_lines: Optional[Callable] = None


LOCAL_FFT = FftOps(rfftn=_rfftn, irfftn=_irfftn)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on ``like``'s device (rounded to float32 as in the reference)."""
    return like.new_full((), value, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Compact-operator accessors: when make_operators(compact=True) left the radially
# symmetric spectral arrays and the c0-derived media fields as None, rebuild them on the
# device from the per-axis k^2 vectors (and c0). The host-built arrays
# (KSpaceFirstOrderSolver.cpp:2404-2652) are taken when present.
# ---------------------------------------------------------------------------


def _k_mag(ops: Operators, ndim: int) -> torch.Tensor:
    """|k| over the reduced spectral grid from the compact per-axis k^2 vectors."""
    k2 = _bc(ops.k2_x, 0, ndim) + _bc(ops.k2_y, 1, ndim)
    if ndim == 3:
        k2 = k2 + _bc(ops.k2_z, 2, ndim)
    return torch.sqrt(k2)


def _kappa(ops: Operators, ndim: int) -> torch.Tensor:
    """sinc k-space correction (generateKappa :2404-2452), lazy in compact mode."""
    if ops.kappa is not None:
        return ops.kappa
    arg = ops.c_ref_dt_2 * _k_mag(ops, ndim)
    one = torch.ones_like(arg)
    return torch.where(arg == 0, one, torch.sin(arg) / torch.where(arg == 0, one, arg))


def _source_kappa_op(ops: Operators, ndim: int) -> torch.Tensor:
    """cos(c_ref*dt*k/2) (generateSourceKappa :2460-2506), lazy in compact mode."""
    if ops.source_kappa is not None:
        return ops.source_kappa
    return torch.cos(ops.c_ref_dt_2 * _k_mag(ops, ndim))


def _absorb_nablas(ops: Operators, ndim: int):
    """|k|^(y-2), |k|^(y-1) with the k=0 pole zeroed (generateKappaAndNablas
    :2568-2576), lazy in compact mode."""
    if ops.absorb_nabla1 is not None:
        return ops.absorb_nabla1, ops.absorb_nabla2
    k = _k_mag(ops, ndim)
    safe = torch.where(k == 0, torch.ones_like(k), k)
    zero = torch.zeros_like(k)
    n1 = torch.where(k == 0, zero, safe ** (ops.alpha_power - 2.0))
    n2 = torch.where(k == 0, zero, safe ** (ops.alpha_power - 1.0))
    return n1, n2


def _c2_op(ops: Operators) -> torch.Tensor:
    """c^2 (computeC2 :2707-2725): derived from c0 in compact mode."""
    return ops.c2 if ops.c2 is not None else ops.c0 * ops.c0


def _tau_eta_op(ops: Operators):
    """Power-law absorption tau/eta (generateTauAndEta :2587-2652), lazy from
    (alpha2 = 2*alpha_coeff*alpha_np, c0) in compact mode."""
    if ops.absorb_tau is not None:
        return ops.absorb_tau, ops.absorb_eta
    ap = float(ops.alpha_power)
    tau = -ops.alpha2 * ops.c0 ** (ap - 1.0)
    eta = ops.alpha2 * (ops.c0 ** ap) * _f32(math.tan(math.pi / 2.0 * ap), ops.c0)
    return tau, eta


def _grad_fields(field: torch.Tensor, ops: Operators, ddx, ddy, ddz, shape,
                 spectral_multi: Optional[Callable] = None, fft: FftOps = LOCAL_FFT):
    """ifftn(dd*_k_shift * kappa * fftn(field)) for each axis: computePressureGradient
    (SolverCudaKernels.cu:1139-1199) and the shared pattern of the velocity gradient.
    With ``spectral_multi`` the three outputs come off one forward transform."""
    ndim = field.ndim
    if spectral_multi is not None:
        specs = [OpSpec("grad", axis=ndim - 1), OpSpec("grad", axis=ndim - 2)]
        dds = [ddx, ddy]
        if ddz is not None:
            specs.append(OpSpec("grad", axis=0))
            dds.append(ddz)
        outs = spectral_multi(field, tuple(specs), tuple(dds), True)
        return outs[0], outs[1], (outs[2] if ddz is not None else None)
    fk = fft.rfftn(field) * _kappa(ops, ndim)
    gx = fft.irfftn(fk * _bc(ddx, 0, ndim), shape)
    gy = fft.irfftn(fk * _bc(ddy, 1, ndim), shape)
    gz = fft.irfftn(fk * _bc(ddz, 2, ndim), shape) if ddz is not None else None
    return gx, gy, gz


def _source_value(signal: torch.Tensor, t: int, many: bool,
                  index: torch.Tensor) -> torch.Tensor:
    """Signal sample(s) at timestep t (clamped to the signal, as a JAX dynamic index):
    scalar broadcast over ``index``'s points or per-point column."""
    t = min(t, signal.size(-1) - 1)
    if many:
        return signal[:, t]
    return signal[t].expand_as(index)


def _apply_point_source(field, index, value, mode: int):
    """Dirichlet replaces, additive modes add (addPressureSource / addVelocitySource
    kernels; mode semantics Parameters.h:73-81)."""
    flat = field.reshape(-1).clone()
    if mode == DIRICHLET:
        flat[index] = value
    else:
        flat.index_add_(0, index, value)
    return flat.reshape(field.shape)


def _scale_additive_source(index, value, ops: Operators, shape, fft: FftOps = LOCAL_FFT):
    """Additive-mode source correction: scatter to the full grid, multiply by source_kappa
    in k-space, inverse transform (scaleSource, KSpaceFirstOrderSolver.cpp:2339-2354)."""
    n = 1
    for s in shape:
        n *= s
    scaled = value.new_zeros(n, dtype=torch.float32)
    scaled[index] = value
    return fft.irfftn(fft.rfftn(scaled.reshape(shape)) * _source_kappa_op(ops, len(shape)),
                      shape)


# ---------------------------------------------------------------------------
# The timestep
# ---------------------------------------------------------------------------


def step(state: SimState, t: int, ops: Operators, src: Sources, cfg: SolverConfig,
         spectral_multi: Optional[Callable] = None, fft: FftOps = LOCAL_FFT) -> SimState:
    """One main-loop iteration (computeMainLoop body, KSpaceFirstOrderSolver.cpp:885-935).
    ``spectral_multi`` (3D only; `kwave_tpu_torch.ops.zfuse.make_pipeline`), when given,
    takes every spectral multiply of the step: ``(field, op_specs, dd_vectors, use_kappa)
    -> [real fields]``. Otherwise ``fft`` does every transform: on a mesh, the pencil FFT
    (`kwave_tpu_torch.parallel.pencil_fft`) with z-sharded fields and operators."""
    is3d = state.uz_sgz is not None
    shape = state.p.shape
    ndim = state.p.ndim

    # -- velocity update (computeVelocity :2087-2119):
    # u = pml_sg * (pml_sg * u - dt/rho0_sg * ifft(ddk_pos * kappa * fft(p)))
    dpx, dpy, dpz = _grad_fields(state.p, ops, ops.ddx_pos, ops.ddy_pos, ops.ddz_pos,
                                 shape, spectral_multi, fft)
    pml_x_sg = _bc(ops.pml_x_sgx, 0, ndim)
    pml_y_sg = _bc(ops.pml_y_sgy, 1, ndim)
    ux = (state.ux_sgx * pml_x_sg - ops.dt_rho0_sgx * dpx) * pml_x_sg
    uy = (state.uy_sgy * pml_y_sg - ops.dt_rho0_sgy * dpy) * pml_y_sg
    uz = None
    if is3d:
        pml_z_sg = _bc(ops.pml_z_sgz, 2, ndim)
        uz = (state.uz_sgz * pml_z_sg - ops.dt_rho0_sgz * dpz) * pml_z_sg

    # -- velocity source (addVelocitySource :2252-2303)
    if cfg.u_source_flag > 0 and t < cfg.u_source_flag:
        def add_u(u, signal):
            val = _source_value(signal, t, cfg.u_source_many, src.u_index)
            if cfg.u_source_mode == ADDITIVE:
                return u + _scale_additive_source(src.u_index, val, ops, shape, fft)
            return _apply_point_source(u, src.u_index, val, cfg.u_source_mode)

        if src.ux_signal is not None:
            ux = add_u(ux, src.ux_signal)
        if src.uy_signal is not None:
            uy = add_u(uy, src.uy_signal)
        if is3d and src.uz_signal is not None:
            uz = add_u(uz, src.uz_signal)

    # -- transducer source (addTransducerSource; delay mask per element)
    if cfg.transducer_source_flag > 0 and t < cfg.transducer_source_flag:
        sig = src.transducer_signal
        at = torch.clamp(src.delay_mask + t, max=sig.shape[0] - 1)
        ux = _apply_point_source(ux, src.transducer_index, sig[at], ADDITIVE_NO_CORRECTION)

    # -- velocity gradient (computeVelocityGradient :2126-2150)
    if spectral_multi is not None:
        duxdx = spectral_multi(ux, (OpSpec("grad", axis=ndim - 1),), (ops.ddx_neg,), True)[0]
        duydy = spectral_multi(uy, (OpSpec("grad", axis=ndim - 2),), (ops.ddy_neg,), True)[0]
        duzdz = spectral_multi(uz, (OpSpec("grad", axis=0),), (ops.ddz_neg,),
                               True)[0] if is3d else None
    else:
        kap = _kappa(ops, ndim)
        duxdx = fft.irfftn(fft.rfftn(ux) * kap * _bc(ops.ddx_neg, 0, ndim), shape)
        duydy = fft.irfftn(fft.rfftn(uy) * kap * _bc(ops.ddy_neg, 1, ndim), shape)
        duzdz = fft.irfftn(fft.rfftn(uz) * kap * _bc(ops.ddz_neg, 2, ndim),
                           shape) if is3d else None
    # non-uniform grid: scale gradients by the stretch maps
    if ops.dxudxn is not None:
        duxdx = duxdx * _bc(ops.dxudxn, 0, ndim)
    if ops.dyudyn is not None:
        duydy = duydy * _bc(ops.dyudyn, 1, ndim)
    if is3d and ops.dzudzn is not None:
        duzdz = duzdz * _bc(ops.dzudzn, 2, ndim)

    # -- density update (computeDensityNonliner/Linear :2157-2173)
    pml_x = _bc(ops.pml_x, 0, ndim)
    pml_y = _bc(ops.pml_y, 1, ndim)
    pml_z = _bc(ops.pml_z, 2, ndim) if is3d else None
    dt_f = _f32(ops.dt, state.p)
    if cfg.nonlinear:
        rho_sum_old = state.rho_x + state.rho_y
        if is3d:
            rho_sum_old = rho_sum_old + state.rho_z
        rho0_x = 2.0 * rho_sum_old + ops.rho0
    else:
        rho0_x = ops.rho0
    rx = pml_x * (pml_x * state.rho_x - dt_f * rho0_x * duxdx)
    ry = pml_y * (pml_y * state.rho_y - dt_f * rho0_x * duydy)
    rz = pml_z * (pml_z * state.rho_z - dt_f * rho0_x * duzdz) if is3d else None

    # -- pressure source (addPressureSource :2310-2333): applied to the split densities
    if cfg.p_source_flag > 0 and t < cfg.p_source_flag:
        val = _source_value(src.p_signal, t, cfg.p_source_many, src.p_index)
        if cfg.p_source_mode == ADDITIVE:
            scaled = _scale_additive_source(src.p_index, val, ops, shape, fft)
            rx = rx + scaled
            ry = ry + scaled
            if is3d:
                rz = rz + scaled
        else:
            rx = _apply_point_source(rx, src.p_index, val, cfg.p_source_mode)
            ry = _apply_point_source(ry, src.p_index, val, cfg.p_source_mode)
            if is3d:
                rz = _apply_point_source(rz, src.p_index, val, cfg.p_source_mode)

    # -- pressure update (computePressureNonlinear/Linear :2180-2245)
    rho_sum = rx + ry + rz if is3d else rx + ry
    du_sum = duxdx + duydy + duzdz if is3d else duxdx + duydy
    c2 = _c2_op(ops)
    if cfg.absorbing:
        tau, eta = _tau_eta_op(ops)
        vel_grad_sum = ops.rho0 * du_sum
        if spectral_multi is not None:
            ap = float(ops.alpha_power)
            tau_term = spectral_multi(vel_grad_sum, (OpSpec("nabla", power=ap - 2.0),), (),
                                      False)[0]
            eta_term = spectral_multi(rho_sum, (OpSpec("nabla", power=ap - 1.0),), (),
                                      False)[0]
        else:
            nabla1, nabla2 = _absorb_nablas(ops, ndim)
            tau_term = fft.irfftn(fft.rfftn(vel_grad_sum) * nabla1, shape)
            eta_term = fft.irfftn(fft.rfftn(rho_sum) * nabla2, shape)
        if cfg.nonlinear:
            nonlin = (ops.bona * rho_sum * rho_sum) / (2.0 * ops.rho0) + rho_sum
            p = c2 * (nonlin + tau * tau_term - eta * eta_term)
        else:
            p = c2 * (rho_sum + tau * tau_term - eta * eta_term)
    elif cfg.nonlinear:
        p = c2 * (rho_sum + ops.bona * rho_sum * rho_sum / (2.0 * ops.rho0))
    else:
        p = c2 * rho_sum

    new = SimState(p=p, ux_sgx=ux, uy_sgy=uy, uz_sgz=uz, rho_x=rx, rho_y=ry, rho_z=rz)
    # -- initial pressure at t==0 (addInitialPressureSource :2359-2400); the driver peels
    # this out of its window loop and passes p0_source_flag=False
    if cfg.p0_source_flag and t == 0:
        new = add_initial_pressure(new, ops, src.p0, spectral_multi, fft)
    return new


def real_at_nyquist(op: torch.Tensor, n: int) -> torch.Tensor:
    """A complex multiplier for the rfft bins of a length-``n`` real axis, with its
    imaginary part zeroed at the Nyquist bin (the last one, for even ``n``).

    That bin of a real field is real, and what a multiplier adds to its imaginary part
    belongs to no real field: the CPU's c2r transform drops it, cuFFT's does not (the
    half-cell shift's table is exp(i*pi/2) = i there, and `postproc`'s derivative and
    time-shift tables are imaginary there too). Zeroed, both devices compute what the CPU
    always did, bit for bit on the CPU."""
    if n % 2:
        return op
    return torch.cat([op[:-1], op[-1:].real.to(op.dtype)])


def shifted_velocity(state: SimState, ops: Operators, fft: FftOps = LOCAL_FFT):
    """Velocities shifted back onto the regular grid via per-axis spectral half-cell
    shifts (computeShiftedVelocity, KSpaceFirstOrderSolver.cpp:2714-2735). Returns
    (ux_shifted, uy_shifted, uz_shifted|None). On z-sharded fields ``fft.z_lines`` makes
    every z line whole for the z shift."""
    ndim = state.p.ndim

    def shift(u, op, axis):
        n = u.shape[axis]
        shape = [1] * ndim
        shape[axis] = op.shape[0]
        uk = torch.fft.rfft(u, dim=axis)
        return torch.fft.irfft(uk * real_at_nyquist(op, n).reshape(shape), n=n, dim=axis)

    ux = shift(state.ux_sgx, ops.shift_x_neg, ndim - 1)
    uy = shift(state.uy_sgy, ops.shift_y_neg, ndim - 2)
    uz = None
    if state.uz_sgz is not None and ops.shift_z_neg is not None:
        if fft.z_lines is None:
            uz = shift(state.uz_sgz, ops.shift_z_neg, 0)
        else:
            uz = fft.z_lines(lambda u: shift(u, ops.shift_z_neg, 0), state.uz_sgz)
    return ux, uy, uz


def add_initial_pressure(state: SimState, ops: Operators, p0: torch.Tensor,
                         spectral_multi: Optional[Callable] = None,
                         fft: FftOps = LOCAL_FFT) -> SimState:
    """p = p0; rho_i = p0/(dim*c^2); u_sg = 0.5 * dt/rho0_sg * ifft(ddk_pos*kappa*fft(p0))
    (addInitialPressureSource, KSpaceFirstOrderSolver.cpp:2359-2400). The result does not
    depend on ``state`` beyond its dimensionality."""
    is3d = state.uz_sgz is not None
    shape = p0.shape
    rho_part = p0 / (_f32(3.0 if is3d else 2.0, p0) * _c2_op(ops))
    gx, gy, gz = _grad_fields(p0, ops, ops.ddx_pos, ops.ddy_pos, ops.ddz_pos, shape,
                              spectral_multi, fft)
    half = _f32(0.5, p0)
    return SimState(
        p=p0.clone(),
        ux_sgx=half * ops.dt_rho0_sgx * gx,
        uy_sgy=half * ops.dt_rho0_sgy * gy,
        uz_sgz=half * ops.dt_rho0_sgz * gz if is3d else None,
        rho_x=rho_part,
        rho_y=rho_part.clone(),
        rho_z=rho_part.clone() if is3d else None,
    )


def make_p0_init(grid: Grid, ops: Operators, p0,
                 spectral_multi: Optional[Callable] = None,
                 fft: FftOps = LOCAL_FFT) -> SimState:
    """The peeled t==0 state: addInitialPressureSource's result does not depend on the
    running state, so the full state after step 0 is exactly this, and the loop steps on
    from t0 = 1 with ``p0_source_flag=False`` (the driver's peel). ``p0`` (a tensor or an
    array) goes to the operators' device; a sharded ``p0`` (z-slabs, with the mesh's
    operators and ``fft``) is on its shards' devices already. No two leaves share
    storage."""
    if not hasattr(p0, "shards"):
        p0 = torch.as_tensor(p0, dtype=torch.float32).to(ops.ddx_pos.device)
    # only the state's dimensionality is read: a shape-only stand-in on the CPU
    return add_initial_pressure(init_state(grid, "meta"), ops, p0, spectral_multi, fft)


# ---------------------------------------------------------------------------
# Main loop
# ---------------------------------------------------------------------------


def _stack(rows: list):
    """The per-step outputs of ``sample_fn`` stacked along a new leading axis: a tensor,
    or a tuple or list of them (as ``lax.scan`` stacks a pytree)."""
    if isinstance(rows[0], (tuple, list)):
        return type(rows[0])(torch.stack(col) for col in zip(*rows))
    return torch.stack(rows)


def make_simulate_fn(ops: Operators, src: Sources, cfg: SolverConfig, n_steps: int,
                     sample_fn: Optional[Callable[[SimState], Any]] = None,
                     spectral_multi: Optional[Callable] = None, fft: FftOps = LOCAL_FFT):
    """The main loop as a function ``run(state, t0) -> (state, samples)``: ``n_steps``
    calls of `step` from time index ``t0`` (a host integer, so a checkpoint leg or a
    lead-in resumes anywhere). ``sample_fn(state)`` runs after every step and its
    outputs are stacked (`_stack`); ``samples`` is None without it. ``spectral_multi``
    (`kwave_tpu_torch.ops.zfuse.make_pipeline`) takes every spectral multiply, as in
    `step`; ``fft`` likewise (the pencil FFT on a mesh). The fields stay on the
    operators' device throughout."""

    def run(state: SimState, t0: int = 0):
        rows = []
        for i in range(n_steps):
            state = step(state, int(t0) + i, ops, src, cfg, spectral_multi, fft)
            if sample_fn is not None:
                rows.append(sample_fn(state))
        return state, (_stack(rows) if rows else None)

    return run


def simulate(state: SimState, ops: Operators, src: Sources, cfg: SolverConfig,
             n_steps: int, sample_fn: Optional[Callable[[SimState], Any]] = None,
             t0: int = 0, spectral_multi: Optional[Callable] = None,
             fft: FftOps = LOCAL_FFT):
    """Run ``n_steps`` iterations from time index ``t0``; returns (state, samples).

    ``sample_fn(state)`` is evaluated after every step and its outputs are stacked, one
    row a step from ``t0`` on (the reference skips storage before the sampling start,
    KSpaceFirstOrderSolver.cpp:1060-1068: callers slice ``[cfg.sampling_start_index -
    t0:]``). Checkpoint / restart is a second call with the carried state and ``t0`` =
    the steps done (main.cpp:147-169)."""
    return make_simulate_fn(ops, src, cfg, n_steps, sample_fn, spectral_multi,
                            fft)(state, t0)
