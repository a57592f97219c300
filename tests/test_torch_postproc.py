"""Post-processing of the port: the time shift, the raw and coefficient-space intensity,
the Q term, the outputs of a run (`--I_avg[_c]`, `--Q_term[_c]`) and the `--post` path
on a file, index and cuboid masks.

Every case of tests/test_postproc.py on the port, and each function against its
kwave_tpu counterpart on the same seeded numpy inputs, within 1e-6 of the result's peak
(two fp32 FFT libraries). Whole runs of the two packages are held to 1e-4 of the peak
(their raw series differ at 1e-6, tests/test_torch_driver.py), intensities from 40-bit
coefficients to 1e-3.
"""

import math
import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kwave_tpu import cli as jcli
from kwave_tpu import driver as jdriver
from kwave_tpu import postproc as jpost
from kwave_tpu.io import input_file as jin
from kwave_tpu.solver import Grid as JGrid
from kwave_tpu.solver import Medium as JMedium
from kwave_tpu_torch import cli, encoder, postproc
from kwave_tpu_torch.basis import MAX_EXP_P, MAX_EXP_U, generate_basis
from kwave_tpu_torch.decoder import avg_intensity_40b, avg_intensity_frames
from kwave_tpu_torch.driver import RunConfig, _corners_to_indices, run_simulation
from kwave_tpu_torch.io.input_file import InputData
from kwave_tpu_torch.solver import Grid, Medium

FUNC_TOL = 1e-6  # a function of the port vs kwave_tpu's, of the peak
RUN_TOL = 1e-4  # a run of the port vs kwave_tpu's, of the peak
RUN_TOL_40 = 1e-3  # ... where 40-bit coefficients are multiplied


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    peak = float(np.abs(want).max())
    assert peak > 0, what
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert np.isfinite(got).all() and err <= tol * peak, \
        f"{what}: {err / peak:.3e} of the peak"


def _run(data, run, out, **kw):
    return run_simulation(data, run, out, device="cpu", **kw)


def _post(*args, **kw):
    """The port's file-level post-processing, asked for the CPU as `_run` is."""
    return postproc.post_process_output_file(*args, device="cpu", **kw)


def _flat(obj):
    if isinstance(obj, h5py.Group):
        return np.concatenate([np.asarray(obj[k]).reshape(-1)
                               for k in sorted(obj.keys(), key=int)])
    return np.asarray(obj).reshape(-1)


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------


def test_time_shift_half_step_analytic():
    """Shifting a sampled sinusoid by dt/2 must match the analytic half-step advance."""
    t_steps = 64
    t = np.arange(t_steps)
    for m in (1, 3, 7):  # integer-period tones are exactly representable
        w = 2 * np.pi * m / t_steps
        x = np.cos(w * t).astype(np.float32)[:, None]
        shifted = postproc.time_shift_half_step(torch.from_numpy(x)).numpy()[:, 0]
        np.testing.assert_allclose(shifted, np.cos(w * (t + 0.5)), atol=2e-5)


@pytest.mark.parametrize("t_steps", [60, 37])
def test_time_shift_and_raw_intensity_against_kwave_tpu(t_steps):
    rng = np.random.default_rng(11)
    p = (1e5 * rng.standard_normal((t_steps, 9))).astype(np.float32)
    u = rng.standard_normal((t_steps, 9)).astype(np.float32)
    _close(postproc.time_shift_half_step(torch.from_numpy(u)).numpy(),
           jpost.time_shift_half_step(jnp.asarray(u)), FUNC_TOL, "time shift")
    u3 = rng.standard_normal((t_steps, 3, 4)).astype(np.float32)  # trailing dims
    _close(postproc.time_shift_half_step(torch.from_numpy(u3)).numpy(),
           jpost.time_shift_half_step(jnp.asarray(u3)), FUNC_TOL, "time shift 3D")
    _close(postproc.avg_intensity_raw(torch.from_numpy(p), torch.from_numpy(u)).numpy(),
           jpost.avg_intensity_raw(jnp.asarray(p), jnp.asarray(u)), 2e-6, "I raw")


@pytest.mark.parametrize("n", [16, 17])
def test_spectral_tables_leave_the_nyquist_bin_real(n):
    """For an even length the multiplier's imaginary part at the Nyquist bin is zero (a
    c2r transform may or may not drop what it would add), and the result is what the
    unzeroed table gives where the transform drops it: float64 numpy's."""
    arg = np.pi * postproc._signed_freq_index(n // 2 + 1, n) / n
    table = postproc._complex(np.cos(arg), np.sin(arg), n, "cpu")
    assert (table.imag[-1].item() == 0.0) == (n % 2 == 0)
    np.testing.assert_array_equal(table.real.numpy(), np.cos(arg).astype(np.float32))
    u = np.random.default_rng(n).standard_normal((n, 5)).astype(np.float32)
    want = np.fft.irfft(np.fft.rfft(u.astype(np.float64), axis=0)
                        * np.exp(1j * arg)[:, None], n=n, axis=0)
    got = postproc.time_shift_half_step(torch.from_numpy(u)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_avg_intensity_raw_plane_wave():
    """For p = A cos(wt), u = (A/(rho c)) cos(w(t - 1/2)) the intensity is A^2/(2 rho c)."""
    t_steps, n = 60, 5
    w = 2 * np.pi * 6 / t_steps
    t = np.arange(t_steps)[:, None]
    a, rho_c = 1e5, 1.5e6
    p = (a * np.cos(w * t)).astype(np.float32) * np.ones((1, n), np.float32)
    # u sampled half a step EARLY (staggered)
    u = (a / rho_c * np.cos(w * (t - 0.5))).astype(np.float32) * np.ones((1, n), np.float32)
    i_avg = postproc.avg_intensity_raw(torch.from_numpy(p), torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(i_avg, a**2 / (2 * rho_c) * np.ones(n), rtol=1e-5)


def test_q_term_analytic():
    """Q = -dIx/dx for Ix = sin(kx x): Q = -k cos(kx x)."""
    n, dx = 32, 0.5
    kx = 2 * np.pi * 3 / (n * dx)
    x = np.arange(n) * dx
    ix = np.broadcast_to(np.sin(kx * x).astype(np.float32), (n, n)).copy()
    q = postproc.q_term(torch.from_numpy(ix), torch.zeros(n, n), None, dx, dx, dx).numpy()
    np.testing.assert_allclose(q[0], -kx * np.cos(kx * x), atol=1e-3)


@pytest.mark.parametrize("shape", [(12, 10), (6, 10, 9)], ids=["2D", "3D"])
def test_q_term_scatter_and_coeff_intensity_against_kwave_tpu(shape):
    rng = np.random.default_rng(4)
    fields = [rng.standard_normal(shape).astype(np.float32) for _ in shape]
    d = (1e-4, 2e-4, 3e-4)
    iz = fields[2] if len(shape) == 3 else None
    _close(postproc.q_term(torch.from_numpy(fields[0]), torch.from_numpy(fields[1]),
                           None if iz is None else torch.from_numpy(iz), *d).numpy(),
           jpost.q_term(jnp.asarray(fields[0]), jnp.asarray(fields[1]),
                        None if iz is None else jnp.asarray(iz), *d), FUNC_TOL, "q_term")
    n_grid = int(np.prod(shape))
    mask = np.sort(rng.choice(n_grid, 17, replace=False))
    vals = rng.standard_normal(17).astype(np.float32)
    got = postproc.scatter_to_grid(torch.from_numpy(vals), torch.from_numpy(mask), shape)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpost.scatter_to_grid(jnp.asarray(vals),
                                                      jnp.asarray(mask), shape)))
    c = [rng.standard_normal((5, 2, 17)).astype(np.float32) for _ in range(4)]
    _close(postproc.avg_intensity_coeffs(*(torch.from_numpy(a) for a in c)).numpy(),
           jpost.avg_intensity_coeffs(*(jnp.asarray(a) for a in c)), FUNC_TOL, "I coeffs")


def test_auto_block_size_computation():
    """Block size from available memory (KSpaceFirstOrderSolver.cpp:1283-1307): 1/8 of
    the host's, /4 per concurrent buffer, 2 GB cap, 8M-element floor, bounded by 1/4 of
    the device's free memory; the same numbers as kwave_tpu's."""
    gib = 1 << 30
    cases = [dict(avail_bytes=64 * gib), dict(avail_bytes=8 * gib), dict(avail_bytes=0),
             dict(avail_bytes=64 * gib, device_bytes=4 * gib),
             dict(avail_bytes=64 * gib, device_bytes=0)]
    want = [(2 * gib) // 4, gib // 4, 8 << 20, gib // 4, 8 << 20]
    for kw, w in zip(cases, want):
        assert postproc._auto_block_size(**kw) == w == jpost._auto_block_size(**kw), kw
    assert postproc._auto_block_size() >= 8 << 20  # the default probes
    assert postproc._free_device_bytes("cpu") is None


def test_cuboid_cx_inverse():
    """_cuboid_cx_from_row inverts ceil(cx*complex_size)*h for every cx/h/width combo."""
    for cs in (1.25, 2.0):
        for h in (1, 2, 4):
            for cx in range(1, 70):
                row = math.ceil(cx * cs) * h
                assert postproc._cuboid_cx_from_row(row, h, cs) == cx, (cs, h, cx)


# ---------------------------------------------------------------------------
# runs
# ---------------------------------------------------------------------------


def _grid(cls, nt=60, n=16):
    return cls(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=nt)


def _p0(n=16):
    p0 = np.zeros((n, n, n), np.float32)
    p0[n // 2, n // 2, n // 2] = 1e5
    return p0


def _sim_input(nt=60, n=16, jax=False, **mask):
    """The same input for either package; 48 random index sensors unless a mask is
    given."""
    if not mask:
        mask = dict(sensor_mask_index=np.sort(np.random.default_rng(5).choice(
            n**3, 48, replace=False)))
    if jax:
        return jin.InputData(grid=_grid(JGrid, nt, n), medium=JMedium(c0=1500.0, rho0=1000.0),
                             pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3, p0=_p0(n), **mask)
    return InputData(grid=_grid(Grid, nt, n), medium=Medium(c0=1500.0, rho0=1000.0),
                     pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3, p0=_p0(n), **mask)


def test_i_avg_and_q_term_end_to_end(tmp_path):
    out = str(tmp_path / "out.h5")
    kw = dict(flags={}, i_avg=True, q_term=True, i_avg_c=True, q_term_c=True,
              period=10.0, harmonics=2)
    _run(_sim_input(), RunConfig(**kw), out)
    out_j = str(tmp_path / "jax.h5")
    jdriver.run_simulation(_sim_input(jax=True), jdriver.RunConfig(**kw), out_j)
    with h5py.File(out, "r") as f, h5py.File(out_j, "r") as fj:
        # raw dependency streams are stored (read back by the post pass); the coefficient
        # dependencies run hidden (doNotSave, OutputStreamContainer.cpp:269-325)
        assert "p" in f and "ux_non_staggered" in f
        assert "p_c" not in f and "ux_non_staggered_c" not in f
        assert set(f.keys()) == set(fj.keys())
        for name in ("Ix_avg", "Iy_avg", "Iz_avg", "Q_term", "Ix_avg_c", "Iy_avg_c",
                     "Iz_avg_c", "Q_term_c"):
            assert f[name].shape == (1, 1, 48) and f[name].dtype == np.float32
            assert dict(f[name].attrs).keys() == dict(fj[name].attrs).keys()
            _close(f[name], fj[name], RUN_TOL, name)
        # raw-series and coefficient-space intensity agree (coeffs capture the harmonic
        # content; tolerance loose because of windowing/transients)
        ix = np.asarray(f["Ix_avg"]).reshape(-1)
        ixc = np.asarray(f["Ix_avg_c"]).reshape(-1)
        assert np.median(np.abs(ixc - ix)) < 0.5 * np.abs(ix).max()


def test_i_avg_c_40bit(tmp_path):
    """On-the-fly coefficient intensity from packed 40-bit frames."""
    data = _sim_input()
    out = str(tmp_path / "out40.h5")
    kw = dict(flags={}, i_avg_c=True, period=10.0, harmonics=1, mode40=True)
    _run(data, RunConfig(**kw), out)
    out_j = str(tmp_path / "jax40.h5")
    jdriver.run_simulation(_sim_input(jax=True), jdriver.RunConfig(**kw), out_j)
    with h5py.File(out, "r") as f, h5py.File(out_j, "r") as fj:
        assert "p_c" not in f  # hidden dependency stream
        assert set(f.keys()) == set(fj.keys()) == {"Ix_avg_c", "Iy_avg_c", "Iz_avg_c"}
        ixc = np.asarray(f["Ix_avg_c"])
        for a in "xyz":
            _close(f[f"I{a}_avg_c"], fj[f"I{a}_avg_c"], RUN_TOL_40, a)

    # explicit --p_c keeps the dependency visible AND the on-the-fly intensity equal
    out2 = str(tmp_path / "out40b.h5")
    run2 = RunConfig(flags=dict(p_c=True, u_non_staggered_c=True), i_avg_c=True,
                     period=10.0, harmonics=1, mode40=True)
    _run(data, run2, out2)
    with h5py.File(out2, "r") as f:
        assert f["p_c"].attrs["c_complex_size"] == np.float32(1.25)
        np.testing.assert_array_equal(np.asarray(f["Ix_avg_c"]), ixc)


@pytest.mark.parametrize("mode40", [False, True], ids=["float", "40bit"])
def test_one_window_iavg_c_boundary(tmp_path, mode40):
    """period=10, mos=2, nt == oSize == 20, p_c + I_avg_c: the one frame feeds the
    intensity once (the tiny-record branch must not feed it again). Ix_avg_c equals one
    frame's sum_h Re(cP conj(cU))/2 of the run's own raw series, and kwave_tpu's run."""
    out = str(tmp_path / "out.h5")
    kw = dict(flags=dict(p_c=True, p_raw=True, u_non_staggered_raw=True), i_avg_c=True,
              period=10.0, mos=2, harmonics=1, mode40=mode40)
    _run(_sim_input(nt=20), RunConfig(**kw), out)
    with h5py.File(out, "r") as f:
        got = np.asarray(f["Ix_avg_c"]).reshape(-1)
        p_series = torch.from_numpy(np.asarray(f["p"])[0])
        ux_series = torch.from_numpy(np.asarray(f["ux_non_staggered"])[0])
        assert f["p_c"].shape[1] == 1
    cb = generate_basis(10.0, 2, 1, normalize=True)
    pf, _ = encoder.encode_series_exact(p_series, cb, mode40=mode40)
    uf, _ = encoder.encode_series_exact(ux_series, cb, shifted=True, mode40=mode40)
    if mode40:
        expect = avg_intensity_40b(pf, uf, MAX_EXP_P, MAX_EXP_U).numpy()
    else:
        expect = avg_intensity_frames(*pf, *uf).numpy()
    scale = np.abs(expect).max()
    assert scale > 0
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6 * scale)
    out_j = str(tmp_path / "jax.h5")
    jdriver.run_simulation(_sim_input(nt=20, jax=True), jdriver.RunConfig(**kw), out_j)
    with h5py.File(out_j, "r") as fj:
        _close(got, np.asarray(fj["Ix_avg_c"]).reshape(-1),
               RUN_TOL_40 if mode40 else RUN_TOL, "Ix_avg_c")


def test_block_size_matches_unblocked(tmp_path):
    """--block_size bounded hyperslab streaming reproduces the in-memory result
    (KSpaceFirstOrderSolver.cpp:1283-1307)."""
    data = _sim_input()
    out = str(tmp_path / "out.h5")
    # the coefficient streams are stored so that the --post reader can re-derive the
    # intensity from the file
    run = RunConfig(flags=dict(p_c=True, u_non_staggered_c=True),
                    i_avg=True, q_term=True, i_avg_c=True, period=10.0, harmonics=2)
    _run(data, run, out)
    with h5py.File(out, "r") as f:
        ref = {k: np.asarray(f[k]) for k in
               ("Ix_avg", "Iy_avg", "Iz_avg", "Q_term", "Ix_avg_c")}
    mask = data.sensor_mask_index
    # tiny blocks: raw mode -> a handful of sensors per read; coeff mode -> 1 frame
    _post(out, data.grid, mask, want_i_avg=True,
          want_q_term=True, from_coeffs=False, block_size=500)
    _post(out, data.grid, mask, want_i_avg=True,
          want_q_term=False, from_coeffs=True, block_size=100)
    with h5py.File(out, "r") as f:
        for k, v in ref.items():
            np.testing.assert_allclose(np.asarray(f[k]), v, rtol=1e-5, atol=1e-8,
                                       err_msg=k)


def _cuboid_base(corners):
    return _sim_input(sensor_mask_corners=corners), _corners_to_indices(corners,
                                                                        _grid(Grid))


def test_i_avg_c_post_cuboid_40bit(tmp_path):
    """--post coefficient-space intensity from CUBOID-layout 40-bit streams agrees with
    the equivalent index-mask 40-bit post run on the same points."""
    corners = np.array([[2, 3, 4, 6, 6, 7], [9, 9, 9, 12, 10, 9]])  # cx=5 pads 40-bit rows
    data_c, mask = _cuboid_base(corners)
    run = RunConfig(flags=dict(p_c=True, u_non_staggered_c=True),
                    period=10.0, harmonics=2, mode40=True)
    out_c, out_i = str(tmp_path / "cuboid.h5"), str(tmp_path / "index.h5")
    _run(data_c, run, out_c)
    _run(_sim_input(sensor_mask_index=mask), run, out_i)
    grid = data_c.grid
    _post(out_c, grid, mask, want_i_avg=True,
          want_q_term=False, from_coeffs=True)
    _post(out_i, grid, mask, want_i_avg=True,
          want_q_term=False, from_coeffs=True,
          block_size=100)  # tiny blocks too
    # kwave_tpu post-processes the port's cuboid file to the same values
    out_cj = str(tmp_path / "cuboid_j.h5")
    with h5py.File(out_c) as src, h5py.File(out_cj, "w") as dst:
        for k in ("p_c", "ux_non_staggered_c", "uy_non_staggered_c", "uz_non_staggered_c"):
            src.copy(k, dst)
    jpost.post_process_output_file(out_cj, _grid(JGrid), mask, want_i_avg=True,
                                   want_q_term=False, from_coeffs=True)
    with h5py.File(out_c) as fc, h5py.File(out_i) as fi, h5py.File(out_cj) as fj:
        for a in ("x", "y", "z"):
            grp = fc[f"I{a}_avg_c"]
            assert isinstance(grp, h5py.Group)
            assert [grp[k].shape for k in ("1", "2")] == [(1, 4, 4, 5), (1, 1, 2, 4)]
            want = np.asarray(fi[f"I{a}_avg_c"]).reshape(-1)
            assert np.abs(want).max() > 0
            np.testing.assert_array_equal(_flat(grp), want, err_msg=a)
            _close(_flat(grp), _flat(fj[f"I{a}_avg_c"]), FUNC_TOL, a)


def test_i_avg_post_cuboid_blocked_raw(tmp_path):
    """Raw-mode cuboid --post with a tiny block_size (z-slab hyperslab reads) equals the
    unblocked result."""
    corners = np.array([[2, 3, 4, 6, 6, 9], [9, 9, 9, 12, 10, 9]])
    data, mask = _cuboid_base(corners)
    out = str(tmp_path / "cuboid.h5")
    _run(data, RunConfig(flags=dict(p_raw=True, u_non_staggered_raw=True)), out)
    _post(out, data.grid, mask, want_i_avg=True,
          want_q_term=False)
    with h5py.File(out) as f:
        ref = {a: _flat(f[f"I{a}_avg"]) for a in ("x", "y", "z")}
    # force 1-z-slab blocks: block_size < T*cy*cx of the smallest cuboid
    _post(out, data.grid, mask, want_i_avg=True,
          want_q_term=False, block_size=200)
    with h5py.File(out) as f:
        for a in ("x", "y", "z"):
            assert np.abs(ref[a]).max() > 0
            np.testing.assert_array_equal(_flat(f[f"I{a}_avg"]), ref[a], err_msg=a)


def test_i_avg_and_q_term_cuboid_layout(tmp_path):
    """A cuboid-mask run: series live in per-cuboid groups; intensity and Q-term results
    come back in the same per-cuboid layout and agree with an equivalent index-mask run
    (same points), and with kwave_tpu's cuboid run."""
    corners = np.array([[2, 3, 4, 5, 6, 7], [9, 9, 9, 12, 10, 9]])  # two cuboids
    data_c, mask = _cuboid_base(corners)
    kw = dict(flags={}, i_avg=True, q_term=True, i_avg_c=True, q_term_c=True,
              period=10.0, harmonics=2)
    out_c, out_i = str(tmp_path / "cuboid.h5"), str(tmp_path / "index.h5")
    _run(data_c, RunConfig(**kw), out_c)
    _run(_sim_input(sensor_mask_index=mask), RunConfig(**kw), out_i)
    out_j = str(tmp_path / "cuboid_j.h5")
    jdriver.run_simulation(_sim_input(jax=True, sensor_mask_corners=corners),
                           jdriver.RunConfig(**kw), out_j)
    with h5py.File(out_c) as fc, h5py.File(out_i) as fi, h5py.File(out_j) as fj:
        assert set(fc.keys()) == set(fj.keys())
        for name in ("Ix_avg", "Iy_avg", "Iz_avg", "Q_term", "Ix_avg_c", "Q_term_c"):
            grp = fc[name]
            assert isinstance(grp, h5py.Group), name
            assert [grp[k].shape for k in grp] == [fj[name][k].shape for k in fj[name]]
            np.testing.assert_allclose(_flat(grp), np.asarray(fi[name]).reshape(-1),
                                       rtol=1e-5, atol=1e-9, err_msg=name)
            _close(_flat(grp), _flat(fj[name]), RUN_TOL, name)


def test_post_missing_streams_clear_error(tmp_path):
    """--post on a file lacking the u_non_staggered_c datasets raises an actionable
    ValueError, not a KeyError from deep inside h5py."""
    data = _sim_input(nt=30)
    out = str(tmp_path / "out.h5")
    _run(data, RunConfig(flags=dict(p_c=True), period=10.0, harmonics=2), out)
    with pytest.raises(ValueError, match="u_non_staggered"):
        _post(out, data.grid, data.sensor_mask_index,
              want_i_avg=True, from_coeffs=True)


def test_file_functions_run_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """`post_process_output_file` and `q_term_from_intensity` default to the card, as
    `run_simulation` does, and where there is none they refuse before they open the file
    (no silent fall back to the CPU)."""
    import inspect

    for fn in (postproc.post_process_output_file, postproc.q_term_from_intensity):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    if torch.cuda.is_available():
        return
    data = _sim_input(nt=30)
    missing = str(tmp_path / "never_opened.h5")
    with pytest.raises(RuntimeError, match="cuda"):
        postproc.post_process_output_file(missing, data.grid, data.sensor_mask_index)
    with pytest.raises(RuntimeError, match="cuda"):
        postproc.q_term_from_intensity(missing, data.grid, data.sensor_mask_index)


# ---------------------------------------------------------------------------
# the CLI: --post, and each package on the other's output file
# ---------------------------------------------------------------------------


def _write_cli_input(path, nt=40):
    mask = np.sort(np.random.default_rng(1).choice(16**3, 24, replace=False))
    jin.write_input_file(path, _sim_input(nt=nt, jax=True, sensor_mask_index=mask))


def _port_cli(argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(cli.DEVICE_ENV, "cpu")
        return cli.main(argv)


def test_cli_post_mode_and_copy_mask(tmp_path):
    """--copy_sensor_mask embeds the mask; --post computes I_avg on the existing output."""
    inp, out = str(tmp_path / "in.h5"), str(tmp_path / "out.h5")
    _write_cli_input(inp)
    assert _port_cli(["-i", inp, "-o", out, "--p_raw", "--u_non_staggered_raw",
                      "--copy_sensor_mask"]) == 0
    with h5py.File(out, "r") as f:
        assert "sensor_mask_index" in f
        assert np.asarray(f["sensor_mask_index"]).min() >= 1
        assert "Ix_avg" not in f
    assert _port_cli(["-i", inp, "-o", out, "--post", "--I_avg", "--Q_term",
                      "--block_size", "300"]) == 0
    with h5py.File(out, "r") as f:
        for name in ("Ix_avg", "Iy_avg", "Iz_avg", "Q_term"):
            assert name in f and np.isfinite(np.asarray(f[name])).all()
            assert np.abs(np.asarray(f[name])).max() > 0


def test_cli_intensity_flags_alone_store_no_p_by_default(tmp_path):
    """The p_raw default applies only when no output of any kind was asked for:
    --I_avg_c alone stores the three intensities and nothing else."""
    inp, out = str(tmp_path / "in.h5"), str(tmp_path / "out.h5")
    _write_cli_input(inp)
    assert _port_cli(["-i", inp, "-o", out, "--I_avg_c", "--period", "10"]) == 0
    with h5py.File(out, "r") as f:
        assert set(f.keys()) == {"Ix_avg_c", "Iy_avg_c", "Iz_avg_c"}
    assert _port_cli(["-i", inp, "-o", out]) == 0
    with h5py.File(out, "r") as f:
        assert set(f.keys()) == {"p"}


@pytest.mark.parametrize("mode40", [False, True], ids=["float", "40bit"])
@pytest.mark.parametrize("writer", ["kwave_tpu", "kwave_tpu_torch"])
def test_each_package_post_processes_the_other_s_output(tmp_path, writer, mode40):
    """One package runs the simulation and stores the raw and coefficient series; then
    both packages' ``--post`` run on copies of that file. Same datasets; values within
    1e-6 of the peak (the same stored numbers through two FFT libraries)."""
    inp = str(tmp_path / "in.h5")
    _write_cli_input(inp)
    run_cli, _ = (jcli.main, _port_cli) if writer == "kwave_tpu" else (_port_cli, jcli.main)
    base = str(tmp_path / "base.h5")
    flags = ["--p_raw", "--u_non_staggered_raw", "--p_c", "--u_non_staggered_c",
             "--period", "10", "--harmonics", "2"] + (["--40-bit_complex"] if mode40 else [])
    assert run_cli(["-i", inp, "-o", base, *flags]) == 0
    outs = {}
    for name, post in (("kwave_tpu", jcli.main), ("kwave_tpu_torch", _port_cli)):
        outs[name] = str(tmp_path / f"post_{name}.h5")
        with open(base, "rb") as src, open(outs[name], "wb") as dst:
            dst.write(src.read())
        assert post(["-i", inp, "-o", outs[name], "--post", "--I_avg", "--Q_term",
                     "--I_avg_c", "--Q_term_c"]) == 0
    with h5py.File(outs["kwave_tpu"]) as fj, h5py.File(outs["kwave_tpu_torch"]) as ft:
        assert set(fj.keys()) == set(ft.keys())
        new = {"Ix_avg", "Iy_avg", "Iz_avg", "Q_term", "Ix_avg_c", "Iy_avg_c", "Iz_avg_c",
               "Q_term_c"}
        assert new <= set(ft.keys())
        for name in sorted(new):
            assert dict(ft[name].attrs).keys() == dict(fj[name].attrs).keys(), name
            _close(ft[name], fj[name], 2e-6, name)
    assert os.path.getsize(outs["kwave_tpu_torch"]) > os.path.getsize(base)
