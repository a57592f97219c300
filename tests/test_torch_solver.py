"""kwave_tpu_torch.solver against kwave_tpu.solver (its CPU path, LOCAL_FFT): operators
bit for bit, and 100 steps of a heterogeneous absorbing medium with an initial pressure
and an additive pressure source, linear and nonlinear, in 2D and 3D.

Tolerance: rel L2 <= 1e-4 on p after 100 steps. Both packages run fp32 FFTs, but from
two libraries (XLA's and PyTorch's CPU FFT), and XLA:CPU contracts mul+add where eager
torch does not. Measured rel L2 on p: 2D 9.6e-7 (linear) and 9.1e-7 (nonlinear), 3D
1.88e-6 and 1.92e-6, so 1e-4 leaves room for other FFT libraries and thread counts.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kwave_tpu import solver as jsolver
from kwave_tpu_torch import convert, solver

N_STEPS = 100


def _setup(dim, nonlinear):
    n = 32 if dim == 2 else 24
    nz = 1 if dim == 2 else n
    kw = dict(nx=n, ny=n, nz=nz, dx=1e-4, dy=1e-4, dz=1e-4 if dim == 3 else 0.0,
              dt=2e-8, nt=N_STEPS)
    rng = np.random.default_rng(dim * 10 + int(nonlinear))
    shape = (n, n) if dim == 2 else (n, n, n)
    medium = dict(
        c0=(1500.0 + 100.0 * rng.random(shape)).astype(np.float32),
        rho0=(1000.0 + 50.0 * rng.random(shape)).astype(np.float32),
        alpha_coeff=0.75, alpha_power=1.5,
        bona=6.0 if nonlinear else None,
    )
    p0 = np.zeros(shape, np.float32)
    p0[(n // 2,) * dim] = 1e5
    n_elem = n ** dim
    p_index = np.sort(rng.choice(n_elem, 5, replace=False)).astype(np.int64)
    t = np.arange(N_STEPS, dtype=np.float32)
    # additive sources act on the density: 2e-2 kg/m^3 is ~5e4 Pa at c0 ~ 1550 m/s
    p_signal = (2e-2 * np.sin(2 * np.pi * t / 12.0)).astype(np.float32)
    cfg = dict(nonlinear=nonlinear, absorbing=True, p0_source_flag=True,
               p_source_flag=60, p_source_mode=2)
    pml = ((4, 4, 4) if dim == 3 else (4, 4), (2.0,) * dim)
    return kw, medium, pml, cfg, dict(p0=p0, p_index=p_index, p_signal=p_signal)


def _jax_ops(kw, medium, pml):
    return jsolver.make_operators(jsolver.Grid(**kw), jsolver.Medium(**medium), *pml,
                                  absorbing=True, need_source_kappa=True, need_shift=True)


def _medium_case(dim, *, compact=False, scalar=False, given_sg=False, stretched=False,
                 fields=False, float64=False, alpha_power=1.5, lossless=False):
    """The build's inputs for one branch of `make_operators`: the test's heterogeneous
    medium, or scalar c0 / rho0, given rho0_sg*, nonuniform stretch maps, a
    heterogeneous alpha_coeff and bona, float64 host arrays, another power law, or no
    absorption; 2D or 3D, full or compact. Returns (grid kwargs, medium kwargs, pml,
    make_operators kwargs)."""
    kw, medium, pml, _, _ = _setup(dim, nonlinear=True)
    shape = (kw["ny"], kw["nx"]) if dim == 2 else (kw["nz"], kw["ny"], kw["nx"])
    rng = np.random.default_rng(100 + dim)
    medium["alpha_power"] = alpha_power
    if scalar:
        medium.update(c0=1512.5, rho0=1021.25)
    if given_sg:
        for a in "xyz"[:dim]:
            medium[f"rho0_sg{a}"] = (1000.0 + 50.0 * rng.random(shape)).astype(np.float32)
    if fields:
        medium["alpha_coeff"] = (0.5 + rng.random(shape)).astype(np.float32)
        medium["bona"] = (5.0 + rng.random(shape)).astype(np.float32)
    if float64:
        medium.update(c0=medium["c0"].astype(np.float64) + 1e-9 * rng.random(shape),
                      alpha_coeff=np.float64(0.7512345678))
    options = dict(absorbing=not lossless, need_source_kappa=not lossless,
                   need_shift=not lossless, compact=compact)
    if stretched:
        maps = {}
        for a, n in zip("xyz", (kw["nx"], kw["ny"], kw["nz"])):
            maps[f"d{a}ud{a}n"] = (1.0 + 0.1 * rng.random(n)).astype(np.float32)
            maps[f"d{a}ud{a}n_sg{a}"] = (1.0 + 0.1 * rng.random(n)).astype(np.float32)
        options["nonuniform"] = maps
    return kw, medium, pml, options


OPERATOR_CASES = {
    "2": dict(dim=2),
    "3": dict(dim=3),
    "2-compact": dict(dim=2, compact=True),
    "3-compact": dict(dim=3, compact=True),
    "2-scalar": dict(dim=2, scalar=True),
    "3-scalar": dict(dim=3, scalar=True),
    "3-scalar-compact": dict(dim=3, scalar=True, compact=True),
    "2-given-sg": dict(dim=2, given_sg=True),
    "3-given-sg": dict(dim=3, given_sg=True),
    "2-stretched": dict(dim=2, stretched=True),
    "3-stretched": dict(dim=3, stretched=True),
    "3-stretched-scalar": dict(dim=3, stretched=True, scalar=True),
    "3-stretched-compact": dict(dim=3, stretched=True, compact=True),
    "3-alpha-and-bona-fields": dict(dim=3, fields=True),
    "3-alpha-field-compact": dict(dim=3, fields=True, compact=True),
    "3-float64-host": dict(dim=3, float64=True),
    "3-power-1.2": dict(dim=3, alpha_power=1.2),
    "3-power-2": dict(dim=3, alpha_power=2.0),
    "3-lossless": dict(dim=3, lossless=True),
    # the spectral arrays in slabs of 5 planes (the last one short) instead of one
    "2-slabs": dict(dim=2, slab_planes=5),
    "3-slabs": dict(dim=3, slab_planes=5),
}


@pytest.mark.parametrize("case", list(OPERATOR_CASES))
def test_operators_match_the_jax_package(case, monkeypatch):
    """Every field of the build, on each of its branches, bit for bit against the JAX
    package's float64 NumPy build."""
    from kwave_tpu_torch.solver import operators

    case = dict(OPERATOR_CASES[case])
    planes = case.pop("slab_planes", None)
    kw, medium, pml, options = _medium_case(**case)
    if planes is not None:
        plane = kw["nx"] // 2 + 1 if case["dim"] == 2 else kw["ny"] * (kw["nx"] // 2 + 1)
        monkeypatch.setattr(operators, "_SMALL_BLOCK", planes * 8 * plane)
    mine = solver.make_operators(solver.Grid(**kw), solver.Medium(**medium), *pml,
                                 **options)
    carried = convert.operators_from_jax(jsolver.make_operators(
        jsolver.Grid(**kw), jsolver.Medium(**medium), *pml, **options))
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(carried, f.name)
        if not isinstance(a, torch.Tensor):  # None, or dt and the other host floats
            assert a == b, f.name
            continue
        assert a.dtype == b.dtype, f.name
        assert torch.equal(a, b), f.name
    if case.get("compact"):
        assert mine.kappa is None and mine.k2_x is not None
    else:
        assert mine.kappa is not None and mine.k2_x is None


def test_operators_count_their_builds_by_device_type():
    """`operators.BUILDS` counts each `make_operators` call under its device's type, and
    `reset_build_counts` empties it."""
    from kwave_tpu_torch.solver import operators

    kw, medium, pml, options = _medium_case(2)
    operators.reset_build_counts()
    assert operators.BUILDS == {}
    for device in ("cpu", torch.device("cpu")):
        solver.make_operators(solver.Grid(**kw), solver.Medium(**medium), *pml,
                              device=device, **options)
    assert operators.BUILDS == {"cpu": 2}
    operators.reset_build_counts()
    assert operators.BUILDS == {}


@pytest.mark.parametrize("nonlinear", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_step_matches_jax_over_100_steps(dim, nonlinear):
    kw, medium, pml, cfg, srcs = _setup(dim, nonlinear)
    jops = _jax_ops(kw, medium, pml)
    jcfg = jsolver.SolverConfig(**cfg)
    jsrc = jsolver.Sources(**{k: jnp.asarray(v) for k, v in srcs.items()})
    jgrid = jsolver.Grid(**kw)
    run = jsolver.make_simulate_fn(jops, jsrc, jcfg, N_STEPS)
    jstate, _ = run(jsolver.init_state(jgrid), jnp.int32(0))

    ops = convert.operators_from_jax(jops)
    src = convert.sources_from_jax(jsrc)
    state = convert.sim_state_from_jax(jsolver.init_state(jgrid))
    tcfg = solver.SolverConfig(**cfg)
    for t in range(N_STEPS):
        state = solver.step(state, t, ops, src, tcfg)

    ref = np.asarray(jstate.p)
    got = state.p.numpy()
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    assert rel <= 1e-4, f"rel L2 on p after {N_STEPS} steps: {rel:.3e}"
    for name in ("ux_sgx", "rho_x"):
        r = np.asarray(getattr(jstate, name))
        g = getattr(state, name).numpy()
        assert np.linalg.norm(g - r) <= 1e-4 * np.linalg.norm(r), name


def test_shifted_velocity_and_initial_pressure_match_jax():
    kw, medium, pml, _, srcs = _setup(3, nonlinear=False)
    jops = _jax_ops(kw, medium, pml)
    jst = jsolver.add_initial_pressure(jsolver.init_state(jsolver.Grid(**kw)), jops,
                                       jnp.asarray(srcs["p0"]))
    ops = convert.operators_from_jax(jops)
    st = solver.add_initial_pressure(solver.init_state(solver.Grid(**kw)), ops,
                                    torch.from_numpy(srcs["p0"]))
    back = convert.sim_state_to_numpy(st)
    for name, want in back.items():
        r = np.asarray(getattr(jst, name))
        assert np.linalg.norm(want - r) <= 1e-6 * np.linalg.norm(r), name
    for a, b in zip(solver.shifted_velocity(st, ops), jsolver.shifted_velocity(jst, jops)):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) <= 1e-6 * np.linalg.norm(b)


@pytest.mark.parametrize("n", [7, 8, 15, 16, 33])
def test_shift_multiplier_is_real_at_the_nyquist_bin_of_even_axes_only(n):
    """`real_at_nyquist` zeroes the imaginary part of the last rfft bin for even n and
    leaves every other entry, and every odd-n table, as it was."""
    from kwave_tpu_torch.solver.operators import make_shift_neg
    from kwave_tpu_torch.solver.step import real_at_nyquist

    op = torch.from_numpy(make_shift_neg(n, 1e-4, True))
    got = real_at_nyquist(op, n)
    assert got.dtype == op.dtype and got.shape == op.shape
    if n % 2 == 0:
        assert op[-1].imag != 0 and got[-1].imag == 0 and got[-1].real == op[-1].real
        assert torch.equal(got[:-1], op[:-1])
    else:
        assert torch.equal(got, op)


@pytest.mark.parametrize("shape", [(16, 24, 32), (15, 21, 27), (24, 32), (21, 27)])
def test_shifted_velocity_on_the_cpu_is_unchanged_by_the_nyquist_table(shape):
    """On the CPU the c2r transform drops the Nyquist bin's imaginary part, so the shift
    with the repaired table equals the shift with the table as built, bit for bit."""
    grid = solver.Grid(nx=shape[-1], ny=shape[-2], nz=shape[0] if len(shape) == 3 else 1,
                       dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=8)
    ops = solver.make_operators(grid, solver.Medium(c0=1500.0, rho0=1000.0), (4, 4, 4),
                                (2.0,) * 3, need_shift=True)
    p0 = np.zeros(shape, np.float32)
    p0[tuple(s // 2 for s in shape)] = 1e5
    state, _ = solver.simulate(solver.init_state(grid), ops,
                               solver.Sources(p0=torch.from_numpy(p0)),
                               solver.SolverConfig(p0_source_flag=True), 3)
    fields = (state.ux_sgx, state.uy_sgy, state.uz_sgz)
    tables = (ops.shift_x_neg, ops.shift_y_neg, ops.shift_z_neg)
    axes = (len(shape) - 1, len(shape) - 2, 0)
    for got, u, op, axis in zip(solver.shifted_velocity(state, ops), fields, tables, axes):
        if u is None:
            assert got is None
            continue
        bshape = [1] * len(shape)
        bshape[axis] = op.shape[0]
        as_built = torch.fft.irfft(torch.fft.rfft(u, dim=axis) * op.reshape(bshape),
                                   n=u.shape[axis], dim=axis)
        assert torch.equal(got, as_built)
