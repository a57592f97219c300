"""The JAX suite's physics tests on the port's solver (copies of tests/test_solver.py's
tests that run through `simulate`, and tests/test_driver.py's cuboid-vs-index invariant),
with the same tolerances: the standing wave against its closed form (2D, 3D, and 3D
through the fused z stage), PML absorption, resume equivalence, nonuniform maps that
reduce to the uniform grid, the t==0 peel, velocity-source axis symmetry and acoustic
reciprocity. The port runs here on the CPU; `chip_smoke.py` phase 10 runs the standing
wave and reciprocity on the card."""

import numpy as np
import pytest
import torch

from acceptance_cases import reciprocity_error, standing_wave_error
from kwave_tpu_torch import solver
from kwave_tpu_torch.solver import (
    Grid,
    Medium,
    SolverConfig,
    Sources,
    init_state,
    make_operators,
    make_p0_init,
    simulate,
    step,
)
from torch_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("dim,fused", [(2, False), (3, False), (3, True)])
def test_standing_wave_exact(dim, fused):
    """p along x follows cos(w t) cos(kx x) to 5e-3 (of the unit amplitude) over 40
    steps: 2D, 3D, and 3D through the fused z stage (`acceptance_cases`)."""
    assert standing_wave_error(dim, fused) <= 5e-3


def _mini_grid(dim, n=16, nt=20):
    dx = 1e-4
    dt = 0.2 * dx / 1500.0
    return Grid(nx=n, ny=n, nz=1 if dim == 2 else n, dx=dx, dy=dx, dz=dx, dt=dt, nt=nt)


def _point(shape, value=1e5):
    p0 = np.zeros(shape, np.float32)
    p0[tuple(s // 2 for s in shape)] = value
    return torch.from_numpy(p0)


def test_pml_absorbs_outgoing_wave():
    """With a PML the field energy decays once the wavefront reaches the boundary; with
    pml_alpha = 0 (periodic wrap) it does not."""
    grid = _mini_grid(2, n=32, nt=120)
    src = Sources(p0=_point(grid.shape))
    cfg = SolverConfig(p0_source_flag=True)

    def total_e(pml_alpha):
        ops = make_operators(grid, Medium(c0=1500.0, rho0=1000.0), pml_size=(8, 8),
                             pml_alpha=(pml_alpha,) * 2)
        final, _ = simulate(init_state(grid), ops, src, cfg, 110)
        return float((final.p.double() ** 2).sum())

    assert total_e(2.0) < 0.2 * total_e(0.0)


def test_checkpoint_resume_equivalence():
    """simulate(N) == simulate(k) then simulate(N-k) from the carried state, bit for bit
    (main.cpp:147-169)."""
    grid = _mini_grid(2, n=16, nt=20)
    ops = make_operators(grid, Medium(c0=1500.0, rho0=1000.0), (4, 4), (2.0, 2.0))
    src = Sources(p0=_point(grid.shape))
    cfg = SolverConfig(p0_source_flag=True)
    full, _ = simulate(init_state(grid), ops, src, cfg, 17)
    mid, _ = simulate(init_state(grid), ops, src, cfg, 9)
    resumed, _ = simulate(mid, ops, src, cfg, 8, t0=9)
    assert torch.equal(full.p, resumed.p)
    assert torch.equal(full.ux_sgx, resumed.ux_sgx)


def test_make_simulate_fn_runs_twice_and_stacks_a_tuple():
    """The loop function of `make_simulate_fn` is reusable, and the per-step outputs of a
    ``sample_fn`` that returns a tuple stack as a tuple, one row a step."""
    grid = _mini_grid(2)
    ops = make_operators(grid, Medium(c0=1500.0, rho0=1000.0), (4, 4), (2.0, 2.0))
    run = solver.make_simulate_fn(ops, Sources(p0=_point(grid.shape)),
                                  SolverConfig(p0_source_flag=True), 5,
                                  sample_fn=lambda s: (s.p[8], s.ux_sgx.sum()))
    a, (rows, sums) = run(init_state(grid), 0)
    b, (rows_b, _) = run(init_state(grid), 0)
    assert rows.shape == (5, 16) and sums.shape == (5,)
    assert torch.equal(a.p, b.p) and torch.equal(rows, rows_b)
    _, none = simulate(init_state(grid), ops, Sources(p0=_point(grid.shape)),
                       SolverConfig(p0_source_flag=True), 2)
    assert none is None


def test_nonuniform_grid_reduces_to_uniform():
    """Identity stretch maps equal the uniform path bit for bit; other maps change the
    answer, and it stays finite."""
    grid = _mini_grid(3)
    medium = Medium(c0=1500.0, rho0=1000.0)
    src = Sources(p0=_point(grid.shape))
    cfg = SolverConfig(p0_source_flag=True)
    ident = {k: np.ones(n, np.float32) for k, n in (
        ("dxudxn", grid.nx), ("dyudyn", grid.ny), ("dzudzn", grid.nz),
        ("dxudxn_sgx", grid.nx), ("dyudyn_sgy", grid.ny), ("dzudzn_sgz", grid.nz))}
    ops_u = make_operators(grid, medium, (4,) * 3, (2.0,) * 3)
    ops_i = make_operators(grid, medium, (4,) * 3, (2.0,) * 3, nonuniform=ident)
    fu, _ = simulate(init_state(grid), ops_u, src, cfg, 10)
    fi, _ = simulate(init_state(grid), ops_i, src, cfg, 10)
    assert torch.equal(fu.p, fi.p)
    stretched = dict(ident)
    stretched["dxudxn"] = (1.0 + 0.1 * np.sin(np.arange(grid.nx))).astype(np.float32)
    stretched["dxudxn_sgx"] = stretched["dxudxn"]
    ops_s = make_operators(grid, medium, (4,) * 3, (2.0,) * 3, nonuniform=stretched)
    fs, _ = simulate(init_state(grid), ops_s, src, cfg, 10)
    assert torch.isfinite(fs.p).all()
    assert (fs.p - fu.p).abs().max() > 0


def test_p0_peel_matches_the_step_path():
    """`make_p0_init` equals the state after step 0 with p0_source_flag bit for bit, and
    the two stay equal over the next steps (the identity the driver's peel relies on);
    no two leaves of the peeled state share storage."""
    n = 16
    grid = Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=8)
    ops = make_operators(grid, Medium(c0=1500.0, rho0=1000.0), (4, 4, 4), (2.0,) * 3)
    p0 = _point(grid.shape)
    src = Sources(p0=p0)
    cfg, cfg_peeled = SolverConfig(p0_source_flag=True), SolverConfig(p0_source_flag=False)
    s_step = step(init_state(grid), 0, ops, src, cfg)
    s_peel = make_p0_init(grid, ops, p0.numpy())
    leaves = [v for v in vars(s_peel).values() if v is not None]
    assert len({v.untyped_storage().data_ptr() for v in leaves}) == len(leaves)
    assert s_peel.p.data_ptr() != p0.data_ptr()
    for t in range(1, 3):
        for f in ("p", "ux_sgx", "uy_sgy", "uz_sgz", "rho_x", "rho_y", "rho_z"):
            assert torch.equal(getattr(s_step, f), getattr(s_peel, f)), f"{f} before t={t}"
        s_step = step(s_step, t, ops, src, cfg)
        s_peel = step(s_peel, t, ops, src, cfg_peeled)


def test_velocity_source_axis_symmetry():
    """On a uniform cubic medium a uy (uz) point source at the centre gives the x<->y
    (x<->z) transposed field of the ux run, to 1e-5 of the peak."""
    n = 24
    grid = Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=30)
    ops = make_operators(grid, Medium(c0=1500.0, rho0=1000.0), (4, 4, 4), (2.0,) * 3)
    c = n // 2
    idx = torch.tensor([(c * n + c) * n + c])
    sig = torch.from_numpy((0.01 * np.sin(2 * np.pi * np.arange(30) / 8)).astype(np.float32))

    def run(axis):
        src = Sources(u_index=idx, **{f"u{axis}_signal": sig})
        st, _ = simulate(init_state(grid), ops, src,
                         SolverConfig(u_source_flag=30, u_source_mode=1), 30)
        return st.p.numpy()

    px, py, pz = run("x"), run("y"), run("z")
    scale = np.abs(px).max()
    assert scale > 0
    assert np.abs(py - px.transpose(0, 2, 1)).max() / scale < 1e-5
    assert np.abs(pz - px.transpose(2, 1, 0)).max() / scale < 1e-5


def test_acoustic_reciprocity():
    """In a lossless homogeneous medium the recorded pressure is invariant under
    source <-> receiver exchange, G(A->B) = G(B->A), to 1e-4 of the peak over 60 steps of
    an additive source (the JAX package reaches 2.6e-5)."""
    assert reciprocity_error() < 1e-4


def test_cuboid_equals_index_mask_same_points(tmp_path):
    """A cuboid mask and an index mask over the same points (in cuboid scan order) give
    bit-identical raw, aggregate and coefficient streams through the port's driver; only
    the HDF5 layout differs (IndexOutputStream vs CuboidOutputStream)."""
    import h5py

    from kwave_tpu_torch.driver import RunConfig, _corners_to_indices, run_simulation
    from kwave_tpu_torch.io.input_file import InputData

    grid = Grid(nx=16, ny=16, nz=16, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=30)
    corners = np.array([[2, 3, 4, 6, 7, 8]])  # one 5x5x5 cuboid
    idx = _corners_to_indices(corners, grid).astype(np.int64)
    base = dict(grid=grid, medium=Medium(c0=1500.0, rho0=1000.0), pml_size=(4, 4, 4),
                pml_alpha=(2.0,) * 3, p0=_point(grid.shape).numpy())
    run = RunConfig(flags=dict(p_raw=True, p_rms=True, p_c=True), period=10.0,
                    harmonics=2)
    cub, ind = str(tmp_path / "cub.h5"), str(tmp_path / "idx.h5")
    run_simulation(InputData(**base, sensor_mask_corners=corners), run, cub, device="cpu")
    run_simulation(InputData(**base, sensor_mask_index=idx), run, ind, device="cpu")
    h = 2
    with h5py.File(cub) as fc, h5py.File(ind) as fi:
        np.testing.assert_array_equal(np.asarray(fc["p"]["1"]).reshape(30, -1),
                                      np.asarray(fi["p"])[0])
        np.testing.assert_array_equal(np.asarray(fc["p_rms"]["1"]).reshape(-1),
                                      np.asarray(fi["p_rms"]).reshape(-1))
        cc, ci = np.asarray(fc["p_c"]["1"]), np.asarray(fi["p_c"])[0]
        np.testing.assert_array_equal(cc.reshape(cc.shape[0], -1, 2 * h),
                                      ci.reshape(ci.shape[0], -1, 2 * h))


@pytest.mark.parametrize("fused", [False, True])
def test_simulate_matches_jax_with_a_sensor_gather(fused):
    """The port's `simulate` and `make_p0_init` against kwave_tpu's on one heterogeneous
    absorbing 3D input, sampled through `sample_index` every step from t0 = 1 (the
    driver's reference run, tests/test_driver.py): rel L2 <= 1e-4 (two FFT libraries).
    ``fused``: the port through compact operators and the fused z stage."""
    import jax.numpy as jnp

    from kwave_tpu import sampling as jsam
    from kwave_tpu import solver as jsolver
    from kwave_tpu_torch import sampling

    n, steps = 16, 24
    kw = dict(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=steps)
    rng = np.random.default_rng(3)
    c0 = (1500 + 100 * rng.random((n, n, n))).astype(np.float32)
    rho0 = (1000 + 50 * rng.random((n, n, n))).astype(np.float32)
    p0 = _point((n, n, n)).numpy()
    mask = np.sort(rng.choice(n ** 3, 40, replace=False)).astype(np.int64)
    med = dict(c0=c0, rho0=rho0, alpha_coeff=0.75, alpha_power=1.5)
    jops = jsolver.make_operators(jsolver.Grid(**kw), jsolver.Medium(**med), (4,) * 3,
                                  (2.0,) * 3, absorbing=True)
    jcfg = jsolver.SolverConfig(absorbing=True)
    jm = jnp.asarray(mask.astype(np.int32))
    js0 = jsolver.make_p0_init(jsolver.Grid(**kw), jops, p0)
    _, jrows = jsolver.simulate(js0, jops, jsolver.Sources(p0=jnp.asarray(p0)), jcfg,
                                steps - 1, sample_fn=lambda s: jsam.sample_index(
                                    s.p.reshape(-1), jm), t0=1)
    grid = Grid(**kw)
    ops = make_operators(grid, Medium(**med), (4,) * 3, (2.0,) * 3, absorbing=True,
                         compact=fused)
    multi = None
    if fused:
        from kwave_tpu_torch.ops import zfuse

        multi = zfuse.make_pipeline(grid.shape, ops.k2_z, ops.k2_y, ops.k2_x,
                                    ops.c_ref_dt_2)
    m = torch.from_numpy(mask)
    s0 = make_p0_init(grid, ops, p0, multi)
    _, rows = simulate(s0, ops, Sources(p0=torch.from_numpy(p0)),
                       SolverConfig(absorbing=True), steps - 1,
                       sample_fn=lambda s: sampling.sample_index(s.p.reshape(-1), m), t0=1,
                       spectral_multi=multi)
    want = np.asarray(jrows)
    assert rows.shape == want.shape == (steps - 1, 40)
    rel = np.linalg.norm(rows.numpy() - want) / np.linalg.norm(want)
    assert rel <= 1e-4, f"rel L2 {rel:.3e}"
