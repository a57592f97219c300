"""Checkpoint legs of the port: the checkpoint file, the stream state's checkpoint forms,
a run split into legs, and legs that change package half way.

Tolerances. Within one package on the CPU a run in legs equals the single run bit for
bit (the state crosses the file as float32 and loses nothing). Across the packages the
solvers' fp32 FFTs differ in the last bits (rel L2 1.7e-6 on raw p,
tests/test_torch_driver.py), so a run that changes package is held to the single run of
either: float datasets to rel L2 <= 1e-4, 40-bit rows decoded with `oracle.decode40` to
1e-3 of the coefficient peak. Fed the same stream state, the two packages'
``Temp_<stream>_1/_2`` buffers are equal bit for bit.
"""

import dataclasses
import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kwave_tpu import driver as jdriver
from kwave_tpu import encoder as jenc
from kwave_tpu import oracle
from kwave_tpu import streams as jstreams
from kwave_tpu.basis import generate_basis as jgenerate_basis
from kwave_tpu.io import input_file as jin
from kwave_tpu.solver import Grid as JGrid
from kwave_tpu.solver import Medium as JMedium
from kwave_tpu_torch import convert, encoder, streams
from kwave_tpu_torch.basis import generate_basis
from kwave_tpu_torch.driver import RunConfig, run_simulation
from kwave_tpu_torch.io import checkpoint as ckpt_io
from kwave_tpu_torch.io import input_file as tin
from kwave_tpu_torch.io import names
from kwave_tpu_torch.io.hdf5 import read_attr
from kwave_tpu_torch.io.output_file import create_output_file
from kwave_tpu_torch.solver import Grid, Medium, SimState
from kwave_tpu_torch.streams import StreamSpec, StreamWriter

from torch_helpers import bits, real_series


def _input(nt=60, n=16, sensors=40):
    grid = Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=nt)
    p0 = np.zeros(grid.shape, np.float32)
    p0[n // 2, n // 2, n // 2] = 1e5
    mask = np.sort(np.random.default_rng(9).choice(grid.n_elements, sensors,
                                                   replace=False)).astype(np.int64)
    return tin.InputData(grid=grid, medium=Medium(c0=1500.0, rho0=1000.0),
                         pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3,
                         sensor_mask_index=mask, p0=p0)


def _flags():
    return dict(p_raw=True, p_c=True, p_rms=True, p_max=True)


def _run(data, run, out, **kw):
    return run_simulation(data, run, out, device="cpu", **kw)


def _datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = np.asarray(obj)
        f.visititems(visit)
    return out


def _assert_files_bitwise_equal(a, b, only=None):
    da, db = _datasets(a), _datasets(b)
    assert da.keys() == db.keys()
    for name in only or da:
        assert da[name].dtype == db[name].dtype and da[name].shape == db[name].shape, name
        np.testing.assert_array_equal(bits(da[name]), bits(db[name]), err_msg=name)


# ---------------------------------------------------------------------------
# (a) the stream state's checkpoint form against kwave_tpu's, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_sensors", [16, 37])  # 37: ceil(1.25 N) rounds up
@pytest.mark.parametrize("harmonics", [1, 2])
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "no_overlap"])
@pytest.mark.parametrize("mode40", [False, True], ids=["float", "40bit"])
def test_temp_buffers_equal_the_reference_s_and_restore_inverts(mode40, overlap,
                                                               harmonics, n_sensors):
    """JAX stream states (after 3 windows and a 4-step tail of a seeded series, so both
    accumulators are live) through `convert` into the port: the port's ``Temp_`` buffers
    equal kwave_tpu's bit for bit, and `restore_stream_states` gives the planes back."""
    period, steps = 10, 34
    jbasis = jgenerate_basis(float(period), 1, harmonics, normalize=True)
    basis = generate_basis(float(period), 1, harmonics, normalize=True)
    specs_kw = [("p_c", "p", False), ("ux_non_staggered_c", "ux_shifted", True)]
    jstates = {}
    for i, (name, _, shifted) in enumerate(specs_kw):
        x = real_series(steps, n_sensors, period, seed=3 + i,
                        scale=1e2 if shifted else 1e5)
        _, jstates[name] = jenc.encode_series_exact(jnp.asarray(x), jbasis, shifted=shifted,
                                                    mode40=mode40, overlap=overlap)
    jstates["p_max"] = jnp.asarray(np.arange(n_sensors, dtype=np.float32))
    jstates["p"] = None
    jspecs = [jstreams.StreamSpec(n, s, "c", mode40=mode40, shifted_basis=sh,
                                  overlap=overlap) for n, s, sh in specs_kw]
    specs = [StreamSpec(n, s, "c", mode40=mode40, shifted_basis=sh, overlap=overlap)
             for n, s, sh in specs_kw]
    want = jstreams.stream_states_to_checkpoint(jstates, jspecs, n_sensors)

    states = convert.stream_states_from_jax(jstates)
    assert states["p"] is None and states["p_max"].dtype == torch.float32
    got = streams.stream_states_to_checkpoint(states, specs, n_sensors)
    assert got.keys() == want.keys() == {"p_c", "ux_non_staggered_c"}
    for name in want:
        assert (got[name][1] is None) == (want[name][1] is None) == (not overlap), name
        for g, w in zip(got[name], want[name]):
            if w is None:
                continue
            assert g.dtype == np.float32 and g.shape == np.asarray(w).shape
            if mode40:
                assert g.size == int(np.ceil(1.25 * n_sensors)) * harmonics
            np.testing.assert_array_equal(bits(g), bits(np.asarray(w)), err_msg=name)
        assert float(np.abs(bits(got[name][0]).astype(np.float64)).max()) > 0

    fresh = streams.init_stream_states(specs, n_sensors, 0, basis)
    back = streams.restore_stream_states(fresh, got, specs, steps, period)
    for name in want:
        st = back[name]
        assert st["sampled_step"] == steps and st["compressed_step"] == steps // period
        keys = [k for k in states[name] if k not in ("sampled_step", "compressed_step")]
        assert sorted(keys) == sorted(k for k in st if k not in
                                      ("sampled_step", "compressed_step"))
        for k in keys:
            assert st[k].dtype == states[name][k].dtype and st[k].shape == \
                (harmonics, n_sensors)
            assert torch.equal(st[k], states[name][k]), (name, k)
    # and back to the JAX layout: what kwave_tpu's restore gives from its own buffers
    jback = jstreams.restore_stream_states(
        jstreams.init_stream_states(jspecs, n_sensors, 0, jbasis), want, jspecs, steps,
        period)
    mine = convert.stream_states_to_numpy(back)
    for name in want:
        for k, v in jback[name].items():
            np.testing.assert_array_equal(np.asarray(v), mine[name][k], err_msg=(name, k))


# ---------------------------------------------------------------------------
# (b) the port's counterparts of the reference's checkpoint tests
# ---------------------------------------------------------------------------


def test_multi_leg_bitwise_equal(tmp_path):
    """Three legs of 20 steps through checkpoint interrupts == the single run."""
    data = _input()
    out1 = str(tmp_path / "single.h5")
    _run(data, RunConfig(flags=_flags(), period=10.0, harmonics=2), out1)

    out2, ckpt = str(tmp_path / "legs.h5"), str(tmp_path / "ckpt.h5")
    run = RunConfig(flags=_flags(), period=10.0, harmonics=2,
                    checkpoint_file=ckpt, checkpoint_interval_steps=20)
    s1 = _run(data, run, out2)
    assert s1["__checkpointed_at__"] == (20,)
    with h5py.File(ckpt) as f:
        assert read_attr(f, names.FILE_TYPE) == "checkpoint"
        assert f["p"].shape == (16, 16, 16) and f["Temp_p_c_1"].shape == (1, 1, 160)
    s2 = _run(data, run, out2, resume_from=ckpt)
    assert s2["__checkpointed_at__"] == (40,)
    s3 = _run(data, run, out2, resume_from=ckpt)
    assert "__checkpointed_at__" not in s3
    _assert_files_bitwise_equal(out1, out2)
    # phase times add up over the legs
    with h5py.File(out2) as f:
        total = float(f.attrs[names.TOTAL_EXECUTION_TIME])
        assert total >= float(f.attrs[names.SIMULATION_TIME]) > 0


def test_multi_leg_40bit(tmp_path):
    """40-bit packed accumulators survive the checkpoint round trip bit for bit."""
    data = _input(nt=40)
    out1 = str(tmp_path / "single.h5")
    _run(data, RunConfig(flags=dict(p_c=True), period=10.0, mode40=True), out1)
    out2, ckpt = str(tmp_path / "legs.h5"), str(tmp_path / "ckpt.h5")
    run = RunConfig(flags=dict(p_c=True), period=10.0, mode40=True,
                    checkpoint_file=ckpt, checkpoint_interval_steps=10)
    for leg in range(4):
        _run(data, run, out2, resume_from=ckpt if leg else None)
    _assert_files_bitwise_equal(out1, out2)


@pytest.mark.parametrize("mode40", [False, True], ids=["float", "40bit"])
def test_multi_leg_intensity_and_q_term(tmp_path, mode40):
    """All eight outputs of the slice over three legs: the hidden u*_non_staggered_c
    streams and the iavg_c accumulators cross the leg boundary; I_avg / Q_term are
    computed by the last leg from the raw rows of all three."""
    data = _input()
    kw = dict(flags=dict(p_c=True, p_max_all=True), i_avg=True, q_term=True, i_avg_c=True,
              q_term_c=True, period=10.0, harmonics=2, mode40=mode40)
    out1 = str(tmp_path / "single.h5")
    _run(data, RunConfig(**kw), out1)
    out2, ckpt = str(tmp_path / "legs.h5"), str(tmp_path / "ckpt.h5")
    run = RunConfig(**kw, checkpoint_file=ckpt, checkpoint_interval_steps=20)
    legs = 1
    summary = _run(data, run, out2)
    while "__checkpointed_at__" in summary:
        with h5py.File(out2) as f:  # nothing of the post pass before the last leg
            assert "Ix_avg" not in f and "Q_term_c" not in f
        summary = _run(data, run, out2, resume_from=ckpt)
        legs += 1
    assert legs == 3
    with h5py.File(out2) as f:
        assert {"Ix_avg", "Iy_avg", "Iz_avg", "Q_term", "Ix_avg_c", "Iz_avg_c", "Q_term_c",
                "p", "ux_non_staggered", "p_c", "p_max_all"} <= set(f.keys())
        assert "ux_non_staggered_c" not in f  # hidden dependency stream
        with h5py.File(ckpt) as c:  # ... whose accumulators are checkpointed all the same
            assert "Temp_ux_non_staggered_c_1" in c
        assert float(np.abs(np.asarray(f["Ix_avg_c"])).max()) > 0
    _assert_files_bitwise_equal(out1, out2)


def test_wall_time_checkpoint_trigger(tmp_path):
    """checkpoint_interval_seconds interrupts the run at the next window boundary; the
    resumed legs still give the single run's output bit for bit."""
    data = _input()
    out1 = str(tmp_path / "single.h5")
    _run(data, RunConfig(flags=_flags(), period=10.0, harmonics=2), out1)
    out2, ckpt = str(tmp_path / "legs.h5"), str(tmp_path / "ckpt.h5")
    run = RunConfig(flags=_flags(), period=10.0, harmonics=2,
                    checkpoint_file=ckpt, checkpoint_interval_seconds=0.0)
    # interval 0 -> a checkpoint after every window (oSize = 10 steps): 6 legs
    legs = 0
    summary = _run(data, run, out2)
    while "__checkpointed_at__" in summary:
        legs += 1
        assert legs < 20
        summary = _run(data, run, out2, resume_from=ckpt)
    assert legs == 5
    _assert_files_bitwise_equal(out1, out2)


@pytest.mark.parametrize("target", ["file", "group"])
def test_checkpoint_roundtrip(tmp_path, target):
    """write_checkpoint / read_checkpoint on a path and on an open group; tensors or
    numpy fields; a 2D state (no z fields)."""
    nx, ny, nz = 6, 5, 4
    rng = np.random.default_rng(0)

    def mk():
        return torch.from_numpy(rng.standard_normal((nz, ny, nx)).astype(np.float32))

    state = SimState(p=mk(), ux_sgx=mk(), uy_sgy=mk(), uz_sgz=mk(),
                     rho_x=mk(), rho_y=mk(), rho_z=mk())
    coeffs = {"p_c": (rng.standard_normal(24).astype(np.float32),
                      rng.standard_normal(24).astype(np.float32)),
              "ux_c": (rng.standard_normal(12).astype(np.float32), None)}
    path = str(tmp_path / "ckpt.h5")
    if target == "file":
        ckpt_io.write_checkpoint(path, state, t_index=42, grid_shape=(nx, ny, nz),
                                 stream_coeffs=coeffs)
        back = ckpt_io.read_checkpoint(path)
    else:
        with h5py.File(path, "w") as f:
            f.create_dataset("stale", data=np.zeros(3))  # "w" empties an open group too
            ckpt_io.write_checkpoint(f, state, t_index=42, grid_shape=(nx, ny, nz),
                                     stream_coeffs=coeffs)
            assert "stale" not in f
            back = ckpt_io.read_checkpoint(f)
    assert back["t_index"] == 42 and back["grid_shape"] == (nx, ny, nz)
    for attr, dname in ckpt_io._FIELD_NAMES:
        np.testing.assert_array_equal(back["fields"][dname], getattr(state, attr).numpy())
    np.testing.assert_array_equal(back["stream_coeffs"]["p_c"][0], coeffs["p_c"][0])
    np.testing.assert_array_equal(back["stream_coeffs"]["p_c"][1], coeffs["p_c"][1])
    assert back["stream_coeffs"]["ux_c"][1] is None
    with h5py.File(path, "r") as f:
        assert read_attr(f, names.FILE_TYPE) == "checkpoint"
        assert "Temp_p_c_1" in f and "Temp_p_c_2" in f and "Temp_ux_c_2" not in f
        assert f["p"].dtype == np.float32 and f["Temp_p_c_1"].shape == (1, 1, 24)
    # kwave_tpu reads the same file to the same values
    from kwave_tpu.io.checkpoint import read_checkpoint as jread

    theirs = jread(path)
    assert theirs["t_index"] == 42 and tuple(theirs["grid_shape"]) == (nx, ny, nz)
    for dname, v in back["fields"].items():
        np.testing.assert_array_equal(theirs["fields"][dname], v)
    # 2D: the z fields are None and are left out
    flat = SimState(p=mk()[:1], ux_sgx=mk()[:1], uy_sgy=mk()[:1], uz_sgz=None,
                    rho_x=mk()[:1], rho_y=mk()[:1], rho_z=None)
    path2 = str(tmp_path / "ckpt2d.h5")
    ckpt_io.write_checkpoint(path2, flat, 3, (nx, ny, 1))
    assert set(ckpt_io.read_checkpoint(path2)["fields"]) == {"p", "ux_sgx", "uy_sgy",
                                                             "rhox", "rhoy"}


def test_checkpoint_grid_mismatch_rejected(tmp_path):
    """A checkpoint written for another grid, or with a t_index outside the record,
    raises instead of corrupting the output."""
    data = _input(nt=20)
    z = np.zeros((8, 8, 8), np.float32)
    bad = str(tmp_path / "bad_ck.h5")
    ckpt_io.write_checkpoint(
        bad, SimState(p=z, ux_sgx=z, uy_sgy=z, uz_sgz=z, rho_x=z, rho_y=z, rho_z=z),
        t_index=10, grid_shape=(8, 8, 8))
    out = str(tmp_path / "out.h5")
    with pytest.raises(ValueError, match="grid"):
        _run(data, RunConfig(flags=dict(p_raw=True)), out, resume_from=bad)
    z = np.zeros((16, 16, 16), np.float32)
    late = str(tmp_path / "late_ck.h5")
    ckpt_io.write_checkpoint(
        late, SimState(p=z, ux_sgx=z, uy_sgy=z, uz_sgz=z, rho_x=z, rho_y=z, rho_z=z),
        t_index=21, grid_shape=(16, 16, 16))
    with pytest.raises(ValueError, match="t_index"):
        _run(data, RunConfig(flags=dict(p_raw=True)), out, resume_from=late)


def test_output_that_is_not_the_checkpointed_run_s_is_rejected(tmp_path):
    """The row check: an output file sized for another record length is refused."""
    out, ckpt = str(tmp_path / "out.h5"), str(tmp_path / "ck.h5")
    run = RunConfig(flags=dict(p_raw=True, p_c=True), period=10.0, checkpoint_file=ckpt,
                    checkpoint_interval_steps=20)
    assert _run(_input(nt=60), run, out)["__checkpointed_at__"] == (20,)
    with pytest.raises(ValueError, match="mismatch"):
        _run(_input(nt=50), run, out, resume_from=ckpt)
    other = str(tmp_path / "other.h5")
    _run(_input(nt=60), RunConfig(flags=dict(p_max=True)), other)
    with pytest.raises(ValueError, match="lacks dataset"):
        _run(_input(nt=60), run, other, resume_from=ckpt)


# ---------------------------------------------------------------------------
# (c) a run that changes package at a leg boundary, on real HDF5 files
# ---------------------------------------------------------------------------

CROSS = dict(period=10.0, harmonics=2, checkpoint_interval_steps=20)
CROSS_FLAGS = dict(p_raw=True, p_c=True, p_rms=True, p_max=True)


def _cross_inputs(tmp):
    """One input file, read by both packages."""
    path = os.path.join(tmp, "in.h5")
    d = _input()
    jin.write_input_file(path, jin.InputData(
        grid=JGrid(**dataclasses.asdict(d.grid)), medium=JMedium(c0=1500.0, rho0=1000.0),
        pml_size=d.pml_size, pml_alpha=d.pml_alpha,
        sensor_mask_index=d.sensor_mask_index, p0=d.p0))
    return jin.read_input_file(path), tin.read_input_file(path)


@pytest.fixture(scope="module", params=[False, True], ids=["float", "40bit"])
def cross(request, tmp_path_factory):
    """Single runs of both packages, and the two mixed runs: leg 1 in one package, legs 2
    and 3 in the other. I_avg_c rides along: its hidden u streams and its accumulators
    change package too."""
    mode40 = request.param
    tmp = str(tmp_path_factory.mktemp("cross"))
    jdata, tdata = _cross_inputs(tmp)
    kw = dict(flags=dict(CROSS_FLAGS), i_avg_c=True, mode40=mode40, period=CROSS["period"],
              harmonics=CROSS["harmonics"])
    paths = {k: os.path.join(tmp, k + ".h5")
             for k in ("jax", "port", "jax_then_port", "port_then_jax")}
    jdriver.run_simulation(jdata, jdriver.RunConfig(**kw), paths["jax"])
    _run(tdata, RunConfig(**kw), paths["port"])

    def legs(first, out):
        ck = out + ".ckpt"
        kw_l = dict(kw, checkpoint_file=ck,
                    checkpoint_interval_steps=CROSS["checkpoint_interval_steps"])

        def jax_leg(resume):
            return jdriver.run_simulation(jdata, jdriver.RunConfig(**kw_l), out,
                                          resume_from=resume)

        def port_leg(resume):
            return _run(tdata, RunConfig(**kw_l), out, resume_from=resume)

        a, b = (jax_leg, port_leg) if first == "jax" else (port_leg, jax_leg)
        s = a(None)
        assert s["__checkpointed_at__"] == (20,)
        s = b(ck)
        assert s["__checkpointed_at__"] == (40,)
        s = b(ck)
        assert "__checkpointed_at__" not in s

    legs("jax", paths["jax_then_port"])
    legs("port", paths["port_then_jax"])
    return mode40, paths, len(tdata.sensor_mask_index)


def _inventory(path):
    with h5py.File(path, "r") as f:
        return {k: (ds.shape, ds.dtype, ds.chunks, dict(ds.attrs)) for k, ds in f.items()}


def _decode_rows(rows, n, h, e):
    raw = np.ascontiguousarray(rows).view(np.uint8)[:, : 5 * n * h]
    planes = oracle.bytes_to_soa(np.ascontiguousarray(raw).reshape(-1))
    return oracle.decode40(*(p.reshape(rows.shape[0], n, h) for p in planes), e)


@pytest.mark.parametrize("mixed", ["jax_then_port", "port_then_jax"])
def test_a_checkpoint_of_one_package_resumes_in_the_other(cross, mixed):
    mode40, paths, n = cross
    inv = _inventory(paths[mixed])
    for single in ("jax", "port"):
        ref = _inventory(paths[single])
        assert inv.keys() == ref.keys()
        for k, (shape, dtype, chunks, attrs) in ref.items():
            assert inv[k][:3] == (shape, dtype, chunks), k
            assert inv[k][3].keys() == attrs.keys(), k
            for a, v in attrs.items():
                assert np.array_equal(inv[k][3][a], v) and type(inv[k][3][a]) is type(v)
    got, ref = _datasets(paths[mixed]), _datasets(paths["jax"])
    assert {"p", "p_c", "p_rms", "p_max", "Ix_avg_c", "Iy_avg_c", "Iz_avg_c"} == set(got)
    for name, want in ref.items():
        if name == "p_c" and mode40:
            h = CROSS["harmonics"]
            g = _decode_rows(got[name][0], n, h, oracle.MAX_EXP_P)
            w = _decode_rows(want[0], n, h, oracle.MAX_EXP_P)
            peak = max(float(np.abs(w[0]).max()), float(np.abs(w[1]).max()))
            assert peak > 0
            for a, b in zip(g, w):
                assert float(np.abs(a - b).max()) <= 1e-3 * peak
            continue
        assert np.isfinite(got[name]).all(), name
        rel = np.linalg.norm(got[name] - want) / np.linalg.norm(want)
        # the intensity is a sum of products of 40-bit coefficients that the two
        # solvers' last bits can round to different quanta
        tol = 1e-3 if (mode40 and name.endswith("_avg_c")) else 1e-4
        assert rel <= tol, f"{name}: rel L2 {rel:.3e}"
    # all 6 frames were written, none twice: every row of p_c is live
    assert got["p_c"].shape[1] == 6 and all(np.abs(bits(r)).max() > 0
                                            for r in got["p_c"][0])


# ---------------------------------------------------------------------------
# (d) legs that resume before sampling starts, and inside a window
# ---------------------------------------------------------------------------


def test_resume_before_sampling_start(tmp_path):
    """A checkpoint at t = 10 of a run that samples from step 25 on: the resumed leg
    finishes the lead-in from step 10 (no second p0, no step of it again) and equals the
    single run. No leg of this driver stops before sampling starts, so the leg is put
    together here: the fields of a 10-step run, and an output file with its datasets
    created and no row written."""
    s = 25
    flags = dict(p_raw=True, p_c=True, p_rms=True)
    run = RunConfig(flags=flags, period=10.0, harmonics=2, sampling_start=s)
    data = _input(nt=s + 33)
    single = str(tmp_path / "single.h5")
    _run(data, run, single)

    ckpt = str(tmp_path / "ck.h5")
    _run(_input(nt=10), RunConfig(flags=dict(p_raw=True), checkpoint_file=ckpt),
         str(tmp_path / "lead.h5"))
    assert ckpt_io.read_checkpoint(ckpt)["t_index"] == 10
    out = str(tmp_path / "legs.h5")
    basis = generate_basis(10.0, 1, 2, normalize=True)
    with create_output_file(out) as f:
        StreamWriter(f, StreamSpec.from_flags(flags, True), 40, data.grid.nt - s, basis)
    summary = _run(data, run, out, resume_from=ckpt)
    assert summary["p"] == (1, 33, 40) and summary["p_c"][1] == 3
    _assert_files_bitwise_equal(single, out)


@pytest.mark.parametrize("mode40", [False, True], ids=["float", "40bit"])
def test_resume_inside_a_window_goes_through_encode_steps(tmp_path, monkeypatch, mode40):
    """A checkpoint at step 25 of a record with oSize = 10: the first 5 steps of the
    resumed leg go one by one through `encoder.encode_steps` up to the window's
    boundary, where that window's frame comes out; then whole windows. The leg is put
    together from a 25-step run's end-of-run checkpoint (fields, and accumulators that
    hold 5 steps of the third window) and the output of a run that stopped at step 20,
    with the 25-step run's rows 20..24 and p_max copied in."""
    flags = dict(p_raw=True, p_c=True, p_max=True)
    kw = dict(flags=flags, period=10.0, harmonics=2, mode40=mode40)
    data = _input(nt=60)
    single = str(tmp_path / "single.h5")
    _run(data, RunConfig(**kw), single)

    out, ck20 = str(tmp_path / "legs.h5"), str(tmp_path / "ck20.h5")
    s = _run(data, RunConfig(**kw, checkpoint_file=ck20, checkpoint_interval_steps=20), out)
    assert s["__checkpointed_at__"] == (20,)
    short, ck25 = str(tmp_path / "short.h5"), str(tmp_path / "ck25.h5")
    _run(_input(nt=25), RunConfig(**kw, checkpoint_file=ck25), short)
    assert ckpt_io.read_checkpoint(ck25)["t_index"] == 25
    with h5py.File(short) as fs, h5py.File(out, "r+") as fo:
        fo["p"][0, 20:25] = fs["p"][0, 20:25]
        fo["p_max"][...] = fs["p_max"][...]

    calls = []
    real = encoder.encode_steps

    def counted(state, x_steps, cfg, tables):
        calls.append((state["sampled_step"], x_steps.shape[0]))
        return real(state, x_steps, cfg, tables)

    monkeypatch.setattr(encoder, "encode_steps", counted)
    summary = _run(data, RunConfig(**kw), out, resume_from=ck25)
    assert "__checkpointed_at__" not in summary
    assert calls == [(25, 5)]
    _assert_files_bitwise_equal(single, out)
