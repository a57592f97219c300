"""The port on in-process CPU meshes of 2, 4 and 8 shards (z-sharded fields, the pencil
FFT, each shard's sensors encoded on it, the writer's assembly in the mask's order),
held to the port on one device and to `kwave_tpu.driver.run_simulation` on the JAX
package's 8-device mesh: every case of `tests/test_dist_step.py` but `mxfft`, with its
tolerances (raw series rtol 2e-5 and atol 2e-6 of the peak; 40-bit `p_c` decoded to 1e-3
of its peak). Beyond them: empty shards, an unsorted mask, the per-shard encode bit for
bit, `FftOps` / `LOCAL_FFT` leaving the one-device step unchanged, checkpoints between a
mesh and one device in both packages."""

import dataclasses
import functools

import h5py
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kwave_tpu import driver as jdriver
from kwave_tpu.io.input_file import InputData as JInputData
from kwave_tpu.parallel import make_mesh as jmake_mesh
from kwave_tpu.parallel import pencil_fft as jpencil_fft
from kwave_tpu.parallel import shard_operators as jshard_operators
from kwave_tpu.parallel import shard_state as jshard_state
from kwave_tpu import solver as jsolver
from kwave_tpu_torch import encoder, sampling
from kwave_tpu_torch.basis import generate_basis
from kwave_tpu_torch.decoder import decode_40bit_rows
from kwave_tpu_torch.driver import RunConfig, run_simulation
from kwave_tpu_torch.io.input_file import InputData
from kwave_tpu_torch.parallel import (field_sharding, make_mesh, pencil_fft,
                                      shard_operators, shard_state)
from kwave_tpu_torch.parallel.distributed import encode_sharded, gather_frames
from kwave_tpu_torch.solver import (LOCAL_FFT, FftOps, Grid, Medium, SolverConfig,
                                    Sources, init_state, make_operators, simulate)
from torch_helpers import one_torch_thread  # noqa: F401

SHARDS = (2, 4, 8)
RTOL, ATOL = 2e-5, 2e-6  # of the peak: tests/test_dist_step.py's
DECODED_TOL = 1e-3


def _mesh(s):
    return make_mesh(s, devices=["cpu"] * s)


def _grid(nt, **kw):
    return dict(nx=16, ny=16, nz=16, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=nt, **kw)


def _port_input(jdata) -> InputData:
    """The port's InputData of a kwave_tpu InputData (the same fields)."""
    kw = {f.name: getattr(jdata, f.name) for f in dataclasses.fields(InputData)}
    kw["grid"] = Grid(**dataclasses.asdict(jdata.grid))
    kw["medium"] = Medium(**dataclasses.asdict(jdata.medium))
    return InputData(**kw)


def _datasets(path) -> dict:
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (np.asarray(obj), dict(obj.attrs))
        f.visititems(visit)
    return out


def _hold(got: dict, want: dict, names, what: str) -> None:
    """Raw datasets to rtol/atol of the peak; 40-bit coefficient rows decoded first."""
    for name in names:
        for key in sorted(k for k in want if k == name or k.startswith(name + "/")):
            a, attrs = want[key]
            b = got[key][0]
            assert a.shape == b.shape, (what, key)
            if float(attrs.get("c_complex_size", 0)) == 1.25:
                h, e = int(attrs["c_harmonics"]), int(attrs["c_max_exp"])
                ca = np.stack(decode_40bit_rows(a.reshape(-1, a.shape[-1]), h, e))
                cb = np.stack(decode_40bit_rows(b.reshape(-1, b.shape[-1]), h, e))
                assert np.abs(ca).max() > 0, (what, key)
                err = np.abs(ca - cb).max() / np.abs(ca).max()
                assert err < DECODED_TOL, (what, key, err)
                continue
            assert np.isfinite(b).all(), (what, key)
            scale = max(np.abs(a).max(), 1e-30)
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL * scale,
                                       err_msg=f"{what}: {key}")


def _run_port(data, run_kw, path, mesh=None, **kw):
    run_simulation(_port_input(data), RunConfig(**run_kw), path, device="cpu",
                   mesh=mesh, **kw)
    return _datasets(path)


@functools.lru_cache(maxsize=None)
def _jax_mesh_run(case: str, tmp: str):
    """kwave_tpu's run of a case on its 8-device mesh (once per case and module)."""
    data, run_kw, _ = CASES[case]()
    path = f"{tmp}/jax_{case}.h5"
    jdriver.run_simulation(data, jdriver.RunConfig(**run_kw), path, mesh=jmake_mesh(8))
    return _datasets(path)


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("jax_mesh"))


def _p0_case(nt=40, n_sensors=40, seed=4, sort=True):
    grid = jsolver.Grid(**_grid(nt))
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8] = 1e5
    mask = np.random.default_rng(seed).choice(grid.n_elements, n_sensors, replace=False)
    if sort:
        mask = np.sort(mask)
    return JInputData(grid=grid, medium=jsolver.Medium(c0=1500.0, rho0=1000.0),
                      pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3,
                      sensor_mask_index=mask.astype(np.int64), p0=p0)


def case_main():
    return (_p0_case(), dict(flags=dict(p_raw=True, p_c=True, p_rms=True, p_max_all=True),
                             period=10.0, harmonics=2), ("p", "p_c", "p_rms", "p_max_all"))


def case_cuboid_40bit():
    from tests.mp_driver_worker import build_input_cuboid

    return (build_input_cuboid(), dict(flags=dict(p_raw=True, p_c=True, p_rms=True),
                                       period=10.0, harmonics=2, mode40=True),
            ("p", "p_c", "p_rms"))


def case_nonlinear_all_sources():
    grid = jsolver.Grid(**_grid(40))
    rng = np.random.default_rng(5)
    medium = jsolver.Medium(
        c0=(1500.0 + 50.0 * rng.random(grid.shape)).astype(np.float32),
        rho0=(1000.0 + 20.0 * rng.random(grid.shape)).astype(np.float32),
        bona=6.0, alpha_coeff=0.5, alpha_power=1.5)
    t = np.arange(40, dtype=np.float32)
    mask = np.sort(rng.choice(grid.n_elements, 48, replace=False)).astype(np.int64)
    data = JInputData(
        grid=grid, medium=medium, nonlinear=True, absorbing=True,
        pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3, sensor_mask_index=mask,
        p_source_flag=40, p_source_mode=2, p_source_index=np.array([1000, 2000, 3000]),
        p_source_input=(4e-3 * np.sin(2 * np.pi * t / 10)).astype(np.float32),
        u_source_index=np.array([1500, 2500]),
        ux_source_input=(0.005 * np.sin(2 * np.pi * t / 10)).astype(np.float32),
        ux_source_flag=40, u_source_mode=1, transducer_source_flag=40,
        transducer_source_input=(0.05 * np.sin(2 * np.pi * t / 8)).astype(np.float32),
        delay_mask=np.array([0, 3]))
    return (data, dict(flags=dict(p_raw=True, p_c=True, u_raw=True), period=10.0,
                       harmonics=2), ("p", "p_c", "ux", "uy", "uz"))


def case_nonuniform():
    from kwave_tpu.io import names

    data = _p0_case(nt=30, seed=9)

    def stretch(n, seed):
        x = np.linspace(0, 2 * np.pi, n, dtype=np.float32)
        return (1.0 + 0.05 * np.sin(x + seed)).astype(np.float32)

    maps = {names.DXUDXN: stretch(16, 0.0), names.DXUDXN_SGX: stretch(16, 0.3),
            names.DYUDYN: stretch(16, 1.0), names.DYUDYN_SGY: stretch(16, 1.3),
            names.DZUDZN: stretch(16, 2.0), names.DZUDZN_SGZ: stretch(16, 2.3)}
    data = dataclasses.replace(data, nonuniform=True, nonuniform_maps=maps)
    return data, dict(flags=dict(p_raw=True, p_rms=True)), ("p", "p_rms")


def case_sampling_start():
    return (_p0_case(), dict(flags=dict(p_raw=True, p_c=True), period=10.0, harmonics=2,
                             sampling_start=7), ("p", "p_c"))


def case_many_signals():
    grid = jsolver.Grid(**_grid(40))
    rng = np.random.default_rng(2)
    mask = np.sort(rng.choice(grid.n_elements, 40, replace=False)).astype(np.int64)
    t = np.arange(40, dtype=np.float32)
    sig = (4e-3 * np.sin(2 * np.pi * t / 10)).astype(np.float32)
    sigs = np.stack([sig, 0.5 * sig, (4e-3 * np.cos(2 * np.pi * t / 10)).astype(np.float32)])
    data = JInputData(grid=grid, medium=jsolver.Medium(c0=1500.0, rho0=1000.0),
                      pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3, sensor_mask_index=mask,
                      p_source_flag=40, p_source_mode=2,
                      p_source_index=np.array([1000, 2000, 3000]), p_source_input=sigs,
                      p_source_many=True)
    return data, dict(flags=dict(p_raw=True)), ("p",)


def case_streams_shifted():
    """Aggregates, whole-domain and final fields, the shifted velocity (the z shift's
    trade) and u_c; an unsorted mask."""
    data = _p0_case(nt=35, n_sensors=50, seed=6, sort=False)
    flags = dict(p_raw=True, p_c=True, p_max=True, p_min=True, p_min_all=True,
                 p_final=True, u_non_staggered_raw=True, u_c=True, u_final=True)
    return (data, dict(flags=flags, period=10.0, harmonics=1),
            ("p", "p_c", "p_max", "p_min", "p_min_all", "p_final", "ux_non_staggered",
             "uy_non_staggered", "uz_non_staggered", "ux_c", "uz_c", "uz_final"))


CASES = {f.__name__[5:]: f for f in (case_main, case_cuboid_40bit,
                                      case_nonlinear_all_sources, case_nonuniform,
                                      case_sampling_start, case_many_signals,
                                      case_streams_shifted)}


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_driver_on_a_mesh_matches_one_device_and_kwave_tpu(case, s, tmp_path, jax_dir):
    """`run_simulation(mesh=...)` writes what the port writes on one device and what
    `kwave_tpu` writes on its 8-device mesh (the driver on a mesh, cuboid 40-bit, the
    nonlinear run with every source, nonuniform maps, sampling_start, many-signal
    sources, and the other streams with an unsorted mask)."""
    data, run_kw, names = CASES[case]()
    single = _run_port(data, run_kw, str(tmp_path / "one.h5"))
    meshed = _run_port(data, run_kw, str(tmp_path / "mesh.h5"), mesh=_mesh(s))
    assert meshed.keys() == single.keys()
    for key, (a, attrs) in single.items():
        assert meshed[key][1].keys() == attrs.keys(), key
        assert meshed[key][0].shape == a.shape and meshed[key][0].dtype == a.dtype, key
    _hold(meshed, single, names, f"{case} S={s} vs one device")
    _hold(meshed, _jax_mesh_run(case, jax_dir), names, f"{case} S={s} vs kwave_tpu mesh")


def test_mesh_runs_of_2_4_and_8_shards_are_bit_equal(tmp_path):
    """On the CPU every shard count runs the same 1D and 2D legs: the files are equal
    bit for bit (the card may plan batched legs differently)."""
    data, run_kw, _ = case_streams_shifted()
    outs = [_run_port(data, run_kw, str(tmp_path / f"m{s}.h5"), mesh=_mesh(s))
            for s in SHARDS]
    for other in outs[1:]:
        for key, (a, _) in outs[0].items():
            np.testing.assert_array_equal(other[key][0].view(np.uint8), a.view(np.uint8),
                                          err_msg=key)


@pytest.mark.parametrize("s", SHARDS)
def test_sensors_all_in_one_slab_leave_the_other_shards_empty(s, tmp_path):
    """Every sensor in the source's slab: the other shards sample and encode nothing (no
    window kernel for them) and the file equals the one-device file within tolerance,
    the 40-bit p_c decoded."""
    mask = 8 * 16 * 16 + np.arange(20, dtype=np.int64) * 7  # the z = 8 plane, the source's
    data = dataclasses.replace(_p0_case(), sensor_mask_index=mask)
    run_kw = dict(flags=dict(p_raw=True, p_c=True, p_rms=True), period=10.0, mode40=True)
    split = sampling.split_sensors(mask, (16, 16, 16), s)
    assert split.counts[8 * s // 16] == 20 and sum(split.counts) == 20
    single = _run_port(data, run_kw, str(tmp_path / "one.h5"))
    meshed = _run_port(data, run_kw, str(tmp_path / "mesh.h5"), mesh=_mesh(s))
    _hold(meshed, single, ("p", "p_c", "p_rms"), f"one slab S={s}")


def test_split_sensors_puts_rows_back_in_the_mask_order():
    rng = np.random.default_rng(0)
    mask = rng.choice(16 ** 3, 100, replace=False)  # unsorted
    split = sampling.split_sensors(mask, (16, 16, 16), 4)
    slab = 4 * 16 * 16
    for k, (sel, local) in enumerate(zip(split.select, split.local)):
        assert (mask[sel] // slab == k).all() and (local == mask[sel] - k * slab).all()
        assert (np.diff(sel) > 0).all()  # mask order inside a shard
    rows = np.arange(100) * 10.0
    gathered = np.concatenate([rows[sel] for sel in split.select])
    np.testing.assert_array_equal(sampling.in_mask_order(gathered, split), rows)
    assert sampling.split_sensors(np.sort(mask), (16, 16, 16), 4).perm is None


@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("mode40", [True, False])
def test_per_shard_encode_is_bit_equal_to_the_one_device_encode(mode40, overlap, h):
    """The codec is per sensor: one sampled series encoded on each shard's sensors and
    put back in the mask's order gives the one-device encode's bits (40-bit p_c bytes,
    float p_c bits), window after window."""
    basis = generate_basis(10.0, 1, h, normalize=True)
    o = basis.o_size
    rng = np.random.default_rng(h)
    n = 96
    series = torch.from_numpy((1e5 * rng.standard_normal((4 * o, n))).astype(np.float32))
    mask = rng.choice(16 ** 3, n, replace=False)
    split = sampling.split_sensors(mask, (16, 16, 16), 4)
    cfg = encoder.EncoderConfig.for_stream(basis, False, mode40, overlap)
    tables = encoder.make_tables(basis, False, "cpu")
    whole = encoder.init_state(cfg, n)
    parts = [encoder.init_state(cfg, len(sel)) for sel in split.select]
    for w in range(4):
        chunk = series[w * o:(w + 1) * o]
        whole, frame = encoder.encode_chunk(whole, chunk, cfg, tables)
        pieces = []
        for k, sel in enumerate(split.select):
            parts[k], fr = encoder.encode_chunk(parts[k], chunk[:, sel], cfg, tables)
            pieces.append(fr)
        for plane, got in zip(frame, zip(*pieces)):
            joined = sampling.in_mask_order(torch.cat(got, dim=-1).numpy(), split)
            np.testing.assert_array_equal(joined.view(np.uint32),
                                          plane.numpy().view(np.uint32))


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_encode_matches_unsharded(s):
    """`encode_sharded` (the fast encode on each shard's sensor block) and `gather_frames`
    give the one-device frames in sensor order, and kwave_tpu's on its mesh."""
    from kwave_tpu.basis import generate_basis as jgenerate_basis
    from kwave_tpu.parallel.distributed import encode_sharded as jencode_sharded
    from kwave_tpu.parallel.distributed import gather_frames as jgather_frames

    cb = generate_basis(10.0, 1, 2, normalize=True)
    x = (1e5 * np.random.default_rng(0).standard_normal((40, 64))).astype(np.float32)
    ref_re, ref_im = encoder.encode_series_fast(torch.from_numpy(x), cb)
    got_re, got_im = gather_frames(encode_sharded(x, cb, _mesh(s)), _mesh(s))
    np.testing.assert_array_equal(got_re, ref_re.numpy())
    np.testing.assert_array_equal(got_im, ref_im.numpy())
    jmesh = jmake_mesh(8)
    j_re, j_im = jgather_frames(jencode_sharded(x, jgenerate_basis(10.0, 1, 2,
                                                                   normalize=True), jmesh),
                                jmesh)
    np.testing.assert_allclose(got_re, j_re, rtol=1e-6, atol=1e-2)
    np.testing.assert_allclose(got_im, j_im, rtol=1e-6, atol=1e-2)


def _medium_ops(compact, grid):
    rng = np.random.default_rng(1)
    c0 = (1500.0 + 50.0 * rng.random((grid.nz, grid.ny, grid.nx))).astype(np.float32)
    medium = Medium(c0=c0, rho0=1000.0, alpha_coeff=0.5, alpha_power=1.5)
    return make_operators(grid, medium, (4, 4, 4), (2.0,) * 3, absorbing=True,
                          compact=compact), c0


@pytest.mark.parametrize("s", SHARDS)
def test_pencil_step_matches_local(s):
    """`simulate` on z-sharded fields with the pencil FFT against the one-device port
    and against kwave_tpu's pencil on its 8 devices (test_dist_step.py's tolerances)."""
    grid = Grid(**_grid(12))
    ops, c0 = _medium_ops(False, grid)
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8] = 1e5
    cfg = SolverConfig(p0_source_flag=True, absorbing=True)
    ref, _ = simulate(init_state(grid), ops, Sources(p0=torch.from_numpy(p0)), cfg, 10)
    mesh = _mesh(s)
    got, _ = simulate(shard_state(init_state(grid), mesh),
                      shard_operators(ops, 3, mesh, grid),
                      Sources(p0=field_sharding(mesh, p0)), cfg, 10,
                      fft=pencil_fft(mesh, grid.nx))
    p, ux = (torch.cat(v.shards).numpy() for v in (got.p, got.ux_sgx))
    np.testing.assert_allclose(p, ref.p.numpy(), rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(ux, ref.ux_sgx.numpy(), rtol=1e-5, atol=1e-8)

    jgrid = jsolver.Grid(**_grid(12))
    jops = jsolver.make_operators(jgrid, jsolver.Medium(c0=c0, rho0=1000.0, alpha_coeff=0.5,
                                                        alpha_power=1.5),
                                  (4, 4, 4), (2.0,) * 3, absorbing=True)
    jmesh = jmake_mesh(8)
    jstate = jshard_state(jsolver.init_state(jgrid), jmesh)
    import jax

    with jmesh:
        jgot, _ = jsolver.simulate(
            jstate, jshard_operators(jops, 3, jmesh, grid=jgrid, pencil=True),
            jsolver.Sources(p0=jax.device_put(jnp.asarray(p0), jstate.p.sharding)),
            jsolver.SolverConfig(p0_source_flag=True, absorbing=True), 10,
            fft=jpencil_fft(jmesh, jgrid.nx))
    np.testing.assert_allclose(p, np.asarray(jgot.p), rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(ux, np.asarray(jgot.ux_sgx), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("s", SHARDS)
def test_compact_operators_on_mesh_match_full(s):
    """compact=True (kappa, nablas, tau / eta rebuilt each step from the per-axis vectors:
    the y vector in y-blocks, the z vectors of the real layout in z-blocks) on a mesh
    equals the precomputed operators on the mesh."""
    grid = Grid(**_grid(12))
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8] = 1e5
    cfg = SolverConfig(p0_source_flag=True, absorbing=True)
    mesh = _mesh(s)

    def run(compact):
        ops, _ = _medium_ops(compact, grid)
        st, _ = simulate(shard_state(init_state(grid), mesh),
                         shard_operators(ops, 3, mesh, grid),
                         Sources(p0=field_sharding(mesh, p0)), cfg, 10,
                         fft=pencil_fft(mesh, grid.nx))
        return torch.cat(st.p.shards).numpy()

    p_full = run(False)
    np.testing.assert_allclose(run(True), p_full, atol=3e-5 * np.abs(p_full).max())


def test_2d_grid_on_mesh_fails_actionably(tmp_path):
    grid = Grid(nx=32, ny=32, nz=1, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=10)
    p0 = np.zeros(grid.shape, np.float32)
    p0[16, 16] = 1e5
    data = InputData(grid=grid, medium=Medium(c0=1500.0, rho0=1000.0),
                     pml_size=(4, 4, 0), pml_alpha=(2.0, 2.0, 0.0),
                     sensor_mask_index=np.arange(10, dtype=np.int64), p0=p0)
    with pytest.raises(ValueError, match="3D grid.*2D"):
        run_simulation(data, RunConfig(flags=dict(p_raw=True)), str(tmp_path / "x.h5"),
                       mesh=_mesh(8))


def test_grid_that_does_not_divide_is_refused_naming_nz_and_ny(tmp_path):
    data = _port_input(_p0_case())
    data.grid = dataclasses.replace(data.grid, ny=12)
    data.p0 = np.zeros(data.grid.shape, np.float32)
    with pytest.raises(ValueError, match="nz and ny divisible by 8.*nz = 16, ny = 12"):
        run_simulation(data, RunConfig(flags=dict(p_raw=True)), str(tmp_path / "x.h5"),
                       mesh=_mesh(8))


def test_many_signals_with_identical_columns_equal_one_signal(tmp_path):
    """many=True with identical columns is bit-identical to the single-signal path, on
    one device and on a mesh."""
    data, run_kw, _ = case_many_signals()
    sig = data.p_source_input[0]
    one_sig = dataclasses.replace(data, p_source_input=sig, p_source_many=False)
    same = dataclasses.replace(data, p_source_input=np.stack([sig] * 3))
    for mesh in (None, _mesh(4)):
        a = _run_port(one_sig, run_kw, str(tmp_path / "a.h5"), mesh=mesh)["p"][0]
        b = _run_port(same, run_kw, str(tmp_path / "b.h5"), mesh=mesh)["p"][0]
        np.testing.assert_array_equal(a, b)
        assert np.abs(a).max() > 0


def test_fft_ops_leave_the_one_device_step_bit_identical():
    """The step's transforms go through `FftOps`: the default, `LOCAL_FFT` passed
    explicitly and the bare torch.fft calls give the same bits (step, the p0 peel, the
    shifted velocity and `simulate`, additive sources included)."""
    from kwave_tpu_torch.solver import add_initial_pressure, shifted_velocity, step

    bare = FftOps(rfftn=lambda x: torch.fft.rfftn(x, dim=(-3, -2, -1)),
                  irfftn=lambda xk, shape: torch.fft.irfftn(xk, s=shape, dim=(-3, -2, -1)))
    grid = Grid(**_grid(12))
    c0 = (1500.0 + 50.0 * np.random.default_rng(1).random(grid.shape)).astype(np.float32)
    ops = make_operators(grid, Medium(c0=c0, rho0=1000.0, alpha_coeff=0.5, alpha_power=1.5),
                         (4, 4, 4), (2.0,) * 3, absorbing=True, compact=True,
                         need_shift=True, need_source_kappa=True)
    t = np.arange(12, dtype=np.float32)
    src = Sources(p0=torch.zeros(grid.shape).index_fill_(0, torch.tensor([8]), 1e4),
                  p_index=torch.tensor([100, 2000]),
                  p_signal=torch.from_numpy((1e-3 * np.sin(t)).astype(np.float32)))
    cfg = SolverConfig(absorbing=True, p_source_flag=12, p_source_mode=2,
                       p0_source_flag=True)
    results = []
    for fft in (None, LOCAL_FFT, bare):
        kw = {} if fft is None else dict(fft=fft)
        st = add_initial_pressure(init_state(grid), ops, src.p0, **kw)
        st = step(st, 1, ops, src, cfg, **kw)
        sim, _ = simulate(init_state(grid), ops, src, cfg, 5, **kw)
        results.append([st.p, st.ux_sgx, st.rho_z, *shifted_velocity(st, ops, **kw),
                        sim.p, sim.uz_sgz])
    for other in results[1:]:
        for a, b in zip(results[0], other):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# checkpoints between a mesh and one device, in both packages
# ---------------------------------------------------------------------------


def test_mesh_checkpoint_resumes_on_one_device_and_in_kwave_tpu(tmp_path):
    """A leg on a 4-shard mesh stops at t = 20 and writes one global checkpoint; its
    legs on the mesh equal one mesh leg bit for bit; the checkpoint resumes on one device
    (the port) and in kwave_tpu (one device), each within tolerance of the one-device
    run."""
    import shutil

    data, run_kw, names = case_main()
    single = _run_port(data, run_kw, str(tmp_path / "one.h5"))
    one_leg = _run_port(data, run_kw, str(tmp_path / "mesh_one_leg.h5"), mesh=_mesh(4))
    out, ckpt = str(tmp_path / "mesh_legs.h5"), str(tmp_path / "mesh.ckpt.h5")
    summary = run_simulation(_port_input(data), RunConfig(**run_kw, checkpoint_file=ckpt,
                                                          checkpoint_interval_steps=20),
                             out, device="cpu", mesh=_mesh(4))
    assert summary["__checkpointed_at__"] == (20,)
    shutil.copy(out, tmp_path / "to_port.h5")
    shutil.copy(out, tmp_path / "to_jax.h5")
    shutil.copy(ckpt, tmp_path / "mesh_at_20.ckpt.h5")
    run_simulation(_port_input(data), RunConfig(**run_kw), out, device="cpu",
                   mesh=_mesh(4), resume_from=ckpt)
    legs = _datasets(out)
    for key, (a, _) in one_leg.items():
        np.testing.assert_array_equal(legs[key][0].view(np.uint8), a.view(np.uint8),
                                      err_msg=key)
    run_simulation(_port_input(data), RunConfig(**run_kw), str(tmp_path / "to_port.h5"),
                   device="cpu", resume_from=str(tmp_path / "mesh_at_20.ckpt.h5"))
    _hold(_datasets(str(tmp_path / "to_port.h5")), single, names, "mesh -> one device")
    jdriver.run_simulation(data, jdriver.RunConfig(**run_kw), str(tmp_path / "to_jax.h5"),
                           resume_from=str(tmp_path / "mesh_at_20.ckpt.h5"))
    _hold(_datasets(str(tmp_path / "to_jax.h5")), single, names, "mesh -> kwave_tpu")


@pytest.mark.parametrize("writer", ["port", "kwave_tpu"])
def test_one_device_checkpoint_resumes_on_a_mesh(writer, tmp_path):
    """A leg on one device (the port's, or kwave_tpu's) stops at t = 20; the port resumes
    it on a 4-shard mesh, within tolerance of the one-device run."""
    data, run_kw, names = case_main()
    single = _run_port(data, run_kw, str(tmp_path / "one.h5"))
    out, ckpt = str(tmp_path / "legs.h5"), str(tmp_path / "legs.ckpt.h5")
    leg = dict(run_kw, checkpoint_file=ckpt, checkpoint_interval_steps=20)
    if writer == "port":
        summary = run_simulation(_port_input(data), RunConfig(**leg), out, device="cpu")
    else:
        summary = jdriver.run_simulation(data, jdriver.RunConfig(**leg), out)
    assert summary["__checkpointed_at__"] == (20,)
    run_simulation(_port_input(data), RunConfig(**run_kw), out, device="cpu",
                   mesh=_mesh(4), resume_from=ckpt)
    _hold(_datasets(out), single, names, f"{writer} one device -> mesh")
