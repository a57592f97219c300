"""The port's main path as a whole: kwave_tpu.cli and kwave_tpu_torch.cli on the same input
file (written by kwave_tpu), 24^3 heterogeneous absorbing medium, 64 index sensors,
period 8, 5 windows plus a 3-step tail.

Tolerances: raw p to rel L2 <= 1e-4 (fp32 FFTs of two libraries; measured 1.7e-6);
decoded p_c of the two packages to 1e-3 of the series peak (their p series differ at the
1e-6 level, which the codec's 17-bit mantissas can round to a different quantum). Fed the
same sampled series, the 40-bit p_c bytes are identical; the float p_c bytes equal the
oracle's (the JAX file's float frames carry XLA:CPU's FMA contraction).
"""

import dataclasses
import os

import h5py
import numpy as np
import pytest
import torch

from kwave_tpu import cli as jcli
from kwave_tpu import oracle
from kwave_tpu.basis import generate_basis
from kwave_tpu.io import input_file as jin
from kwave_tpu.solver import Grid, Medium
from kwave_tpu_torch import bitpack, cli, encoder, streams
from kwave_tpu_torch.io import input_file as tin
from kwave_tpu_torch.params import UNPORTED
from kwave_tpu_torch.streams import StreamSpec

PERIOD, N_SENSORS, TAIL = 8, 64, 3
RUNS = {
    "40bit": ["--p_raw", "--p_c", "--40-bit_complex"],
    "float_noov": ["--p_c", "--no_overlap"],
}


def _write_input(path, nt, seed=5):
    n = 24
    grid = Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=nt)
    rng = np.random.default_rng(seed)
    medium = Medium(c0=(1500 + 100 * rng.random(grid.shape)).astype(np.float32),
                    rho0=(1000 + 50 * rng.random(grid.shape)).astype(np.float32),
                    alpha_coeff=0.75, alpha_power=1.5)
    p0 = np.zeros(grid.shape, np.float32)
    p0[12, 12, 12] = 1e5
    p0[10, 13, 11] = -5e4
    mask = np.sort(rng.choice(grid.n_elements, N_SENSORS, replace=False)).astype(np.int64)
    jin.write_input_file(path, jin.InputData(
        grid=grid, medium=medium, pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3,
        absorbing=True, sensor_mask_index=mask, p0=p0))


def _run_both(tmp, nt, flags):
    """Run both CLIs on one kwave_tpu-written input; returns (jax_file, port_file)."""
    os.makedirs(tmp, exist_ok=True)
    inp = os.path.join(tmp, "in.h5")
    if not os.path.exists(inp):
        _write_input(inp, nt)
    out_j, out_t = os.path.join(tmp, "jax.h5"), os.path.join(tmp, "port.h5")
    args = ["-i", inp, "--period", str(PERIOD), *flags]
    assert jcli.main(["-o", out_j, *args]) == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(cli.DEVICE_ENV, "cpu")
        assert cli.main(["-o", out_t, *args]) == 0
    return out_j, out_t


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("driver"))
    nt = 5 * PERIOD + TAIL
    return {k: _run_both(os.path.join(tmp, k), nt, f) for k, f in RUNS.items()}


def _inventory(path):
    out = {}
    with h5py.File(path, "r") as f:
        for k, ds in f.items():
            out[k] = (ds.shape, ds.dtype, ds.chunks, dict(ds.attrs))
    return out


def _decoded_series(path, n_steps):
    """p_c -> oracle decode (40-bit) -> oracle.reconstruct, as [n_steps, N]."""
    with h5py.File(path, "r") as f:
        ds = f["p_c"]
        rows = np.asarray(ds)[0]
        h = int(ds.attrs["c_harmonics"])
        mode40 = float(ds.attrs["c_complex_size"]) == 1.25
    if mode40:
        raw = np.ascontiguousarray(rows).view(np.uint8)[:, : 5 * N_SENSORS * h]
        planes = oracle.bytes_to_soa(raw.reshape(-1))
        re, im = oracle.decode40(*(p.reshape(rows.shape[0], N_SENSORS, h)
                                   for p in planes), oracle.MAX_EXP_P)
    else:
        c = rows.reshape(rows.shape[0], N_SENSORS, h, 2)
        re, im = c[..., 0], c[..., 1]
    basis = generate_basis(float(PERIOD), 1, h, normalize=True)
    return oracle.reconstruct(re, im, basis, False, n_steps), rows


@pytest.mark.parametrize("run", list(RUNS))
def test_same_datasets_dtypes_chunks_and_attributes(outputs, run):
    inv_j, inv_t = (_inventory(p) for p in outputs[run])
    assert inv_j.keys() == inv_t.keys()
    for k in inv_j:
        shape, dtype, chunks, attrs = inv_t[k]
        assert (shape, dtype, chunks) == inv_j[k][:3], k
        assert attrs.keys() == inv_j[k][3].keys(), k
        for a, v in inv_j[k][3].items():
            assert np.array_equal(attrs[a], v) and type(attrs[a]) is type(v), (k, a)


def test_raw_p_agrees(outputs):
    with h5py.File(outputs["40bit"][0]) as fj, h5py.File(outputs["40bit"][1]) as ft:
        pj, pt = np.asarray(fj["p"]), np.asarray(ft["p"])
    assert pt.shape == (1, 5 * PERIOD + TAIL, N_SENSORS)
    rel = np.linalg.norm(pt - pj) / np.linalg.norm(pj)
    assert rel <= 1e-4, f"rel L2 {rel:.3e}"


@pytest.mark.parametrize("run", list(RUNS))
def test_decoded_p_c_agrees_and_has_steps_over_o_frames(outputs, run):
    steps = 5 * PERIOD + TAIL
    with h5py.File(outputs["40bit"][0]) as f:
        peak = float(np.abs(np.asarray(f["p"])).max())
    xj, rows_j = _decoded_series(outputs[run][0], steps)
    xt, rows_t = _decoded_series(outputs[run][1], steps)
    assert rows_t.shape[0] == rows_j.shape[0] == steps // PERIOD  # Nc
    assert np.isfinite(xt).all()
    err = float(np.abs(xt - xj).max())
    assert err <= 1e-3 * peak, f"max |decoded diff| {err:.3e} vs peak {peak:.3e}"


@pytest.mark.parametrize("run", list(RUNS))
def test_process_chunk_fed_the_jax_series_writes_the_same_bytes(outputs, run):
    """The JAX run's own p series through the port's streams.process_chunk."""
    flags = RUNS[run]
    mode40, overlap = "--40-bit_complex" in flags, "--no_overlap" not in flags
    with h5py.File(outputs["40bit"][0]) as f:
        p = np.asarray(f["p"])[0]
    with h5py.File(outputs[run][0]) as f:
        jax_rows = np.asarray(f["p_c"])[0]
    basis = generate_basis(float(PERIOD), 1, 1, normalize=True)
    specs = [StreamSpec("p_c", "p", "c", mode40=mode40, overlap=overlap)]
    states = streams.init_stream_states(specs, N_SENSORS, 24**3, basis)
    tables = streams.encoder_tables(basis)
    rows = []
    for w in range(p.shape[0] // PERIOD):
        states, em = streams.process_chunk(
            states, {"p": torch.from_numpy(p[w * PERIOD : (w + 1) * PERIOD])}, specs,
            basis, tables)
        if mode40:
            rows.append(bitpack.frame_wire_bytes(em["p_c"], N_SENSORS))
        else:
            rows.append(encoder.frames_to_flat_float(*em["p_c"]).view(np.uint8))
    mine = np.stack(rows)
    theirs = np.ascontiguousarray(jax_rows).view(np.uint8)[:, : mine.shape[1]]
    frames_o = oracle.OracleEncoder(basis, N_SENSORS, mode40=mode40, overlap=overlap,
                                    total_steps=p.shape[0]).encode_series(p)
    if mode40:
        np.testing.assert_array_equal(mine, theirs)
        want = np.stack([oracle.soa_to_bytes(*fr) for fr in frames_o])
    else:
        want = np.stack([np.stack(fr, -1).reshape(-1).view(np.uint8) for fr in frames_o])
        np.testing.assert_allclose(mine.view(np.float32), theirs.view(np.float32),
                                   rtol=1e-5, atol=1e-5 * np.abs(p).max())
    np.testing.assert_array_equal(mine, want)


@pytest.mark.parametrize("writer", ["kwave_tpu", "kwave_tpu_torch"])
def test_each_package_reads_the_other_s_input_file(outputs, tmp_path, writer):
    """The port reads the kwave_tpu-written input; kwave_tpu reads one that the port
    rewrote from it. Both give the same InputData as kwave_tpu's own read."""
    path = os.path.join(os.path.dirname(outputs["40bit"][0]), "in.h5")
    ref = jin.read_input_file(path)
    if writer == "kwave_tpu":
        mine = tin.read_input_file(path)
    else:
        path2 = str(tmp_path / "rewritten.h5")
        tin.write_input_file(path2, tin.read_input_file(path))
        mine = jin.read_input_file(path2)
    for f in dataclasses.fields(ref):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if f.name in ("grid", "medium"):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        elif f.name == "source_path":
            continue
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_tiny_record_emits_one_partial_frame(tmp_path):
    """nt < oSize: no window runs, the tail accumulates, the lastStep rule emits Nc=1
    (and no-overlap is forced, since period >= Nt)."""
    out_j, out_t = _run_both(str(tmp_path), PERIOD - 3,
                             ["--p_raw", "--p_c", "--40-bit_complex"])
    with h5py.File(out_j) as f:
        p = np.asarray(f["p"])[0]
    xj, rows_j = _decoded_series(out_j, p.shape[0])
    xt, rows_t = _decoded_series(out_t, p.shape[0])
    assert rows_t.shape == rows_j.shape and rows_t.shape[0] == 1
    assert float(np.abs(xt - xj).max()) <= 1e-3 * float(np.abs(p).max())
    # the port's frame is the oracle's encoding of the port's own raw series
    basis = generate_basis(float(PERIOD), 1, 1, normalize=True)
    with h5py.File(out_t) as f:
        pt = np.asarray(f["p"])[0]
    frames_t = oracle.OracleEncoder(basis, N_SENSORS, mode40=True, overlap=False,
                                    total_steps=pt.shape[0]).encode_series(pt)
    assert len(frames_t) == 1
    np.testing.assert_array_equal(
        np.ascontiguousarray(rows_t).view(np.uint8)[0, : 5 * N_SENSORS],
        oracle.soa_to_bytes(*frames_t[0]))


def test_unported_flags_are_refused_with_their_roadmap_item(tmp_path, capsys):
    """Every flag of the reference's parser is ported now: none is on `UNPORTED`, and
    `unported_flags` refuses none of the five mesh flags it used to."""
    from kwave_tpu_torch.params import build_parser, unported_flags

    assert UNPORTED == {}
    args = build_parser().parse_args(["-i", "in.h5", "-o", "out.h5", "--devices", "2",
                                      "--distributed", "--coordinator", "h:1",
                                      "--num_processes", "2", "--process_id", "0"])
    assert unported_flags(args) == []


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("flag", ["devices", "distributed", "coordinator", "num_processes",
                                  "process_id"])
def test_mesh_flags_are_accepted_and_routed(flag, tmp_path, capsys, monkeypatch):
    """Each mesh flag reaches its route: ``--devices 2`` an in-process mesh of two CPU
    shards whose file equals `run_simulation(mesh=make_mesh(2, ...))`'s;
    ``--distributed`` torchrun's environment and ``--coordinator`` (with
    ``--num_processes 1 --process_id 0``) a process group of one rank, which the run ends;
    ``--num_processes 2`` without ``--coordinator``, and without ``--process_id``, the
    reference CLI's refusal."""
    import torch.distributed as dist

    from kwave_tpu_torch.driver import run_simulation
    from kwave_tpu_torch.io.input_file import read_input_file
    from kwave_tpu_torch.parallel import Mesh, make_mesh
    from kwave_tpu_torch.params import args_to_run_config, build_parser

    monkeypatch.setenv(cli.DEVICE_ENV, "cpu")
    inp, out = str(tmp_path / "in.h5"), str(tmp_path / "out.h5")
    base = ["-i", inp, "-o", out, "--p_raw", "--p_c", "--period", str(PERIOD)]
    if flag == "num_processes":
        with pytest.raises(SystemExit):
            cli.main(base + ["--num_processes", "2", "--process_id", "0"])
        assert "--num_processes requires --coordinator" in capsys.readouterr().err
        return
    if flag == "process_id":
        with pytest.raises(SystemExit):
            cli.main(base + ["--num_processes", "2", "--coordinator", "localhost:1"])
        assert "--process_id R" in capsys.readouterr().err
        return
    _write_input(inp, PERIOD + 3)
    if flag == "devices":
        args = build_parser().parse_args(base + ["--devices", "2"])
        mesh = cli.mesh_from_args(build_parser(), args, torch.device("cpu"))
        assert isinstance(mesh, Mesh) and mesh.size == 2 and mesh.devices == [
            torch.device("cpu")] * 2
        assert cli.main(base + ["--devices", "2"]) == 0
        assert "2 shards (in one process) on cpu, cpu" in capsys.readouterr().out
        ref = str(tmp_path / "ref.h5")
        run_simulation(read_input_file(inp), args_to_run_config(args, dt=2e-8), ref,
                       mesh=make_mesh(2, devices=["cpu", "cpu"]))
        with h5py.File(out) as fa, h5py.File(ref) as fb:
            for name in ("p", "p_c"):
                np.testing.assert_array_equal(np.asarray(fa[name]), np.asarray(fb[name]))
        return
    port = str(_free_port())
    if flag == "distributed":
        for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                         MASTER_PORT=port).items():
            monkeypatch.setenv(k, v)
        extra = ["--distributed"]
    else:
        extra = ["--coordinator", f"localhost:{port}", "--num_processes", "1",
                 "--process_id", "0"]
    seen = []
    monkeypatch.setattr(cli, "_run", lambda *a: seen.append(
        (dist.is_initialized() and dist.get_world_size(), dist.get_backend())) or 0)
    assert cli.main(base + extra) == 0
    assert seen == [(1, "gloo")] and not dist.is_initialized()


def test_cli_fft_knobs_are_accepted_and_high_precision_is_refused(tmp_path, capsys):
    """The reference's spectral-engine flags parse: ``auto`` / ``highest`` and the mxfft
    switches change nothing here (cuFFT in full fp32), and a run with them equals the
    run without; ``--fft_precision high`` is refused with the reason. Every other flag
    of `kwave_tpu.params.build_parser` is known to the port's parser too."""
    from kwave_tpu.params import build_parser as jbuild
    from kwave_tpu_torch.params import args_to_run_config, build_parser

    p = build_parser()
    base = ["-i", "x.h5", "-o", "y.h5", "--p_raw"]
    plain = args_to_run_config(p.parse_args(base))
    for extra in (["--fft_precision", "highest", "--mxfft", "--fft_direct_base", "256"],
                  ["--no-mxfft"], ["--fft_precision", "auto"]):
        assert args_to_run_config(p.parse_args(base + extra)) == plain, extra
    assert p.parse_args(base + ["--mxfft"]).matmul_fft is True
    assert p.parse_args(base + ["--no-mxfft"]).matmul_fft is False
    with pytest.raises(SystemExit):
        cli.main(base + ["--fft_precision", "high"])
    err = capsys.readouterr().err
    assert "Not ported, on purpose" in err and "ROADMAP" in err, err
    with pytest.raises(SystemExit):
        p.parse_args(base + ["--fft_precision", "low"])
    capsys.readouterr()

    def options(parser):
        return {o for a in parser._actions for o in a.option_strings}

    assert options(jbuild()) <= options(p)
    # and they reach a run: the same output with and without them
    inp = str(tmp_path / "in.h5")
    _write_input(inp, PERIOD + 2)
    outs = [str(tmp_path / "a.h5"), str(tmp_path / "b.h5")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(cli.DEVICE_ENV, "cpu")
        assert cli.main(["-i", inp, "-o", outs[0], "--p_raw"]) == 0
        assert cli.main(["-i", inp, "-o", outs[1], "--p_raw", "--fft_precision", "highest",
                         "--no-mxfft", "--fft_direct_base", "128"]) == 0
    with h5py.File(outs[0]) as fa, h5py.File(outs[1]) as fb:
        np.testing.assert_array_equal(np.asarray(fa["p"]), np.asarray(fb["p"]))


def test_cuda_device_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    monkeypatch.setenv(cli.DEVICE_ENV, "cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        cli.device_from_env()
    monkeypatch.delenv(cli.DEVICE_ENV)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.device_from_env()


def _all_datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = np.asarray(obj)
        f.visititems(visit)
    return out


@pytest.mark.parametrize("case", ["streams", "cuboid"])
def test_other_streams_lead_in_and_cuboid_mask_agree(tmp_path, case):
    """Beyond the main path: aggregates, whole-domain and final streams, staggered and
    non-staggered (shifted) velocity streams, a lead-in (-s) and two harmonics; and a
    cuboid sensor mask with its per-cuboid group layout. Datasets match the JAX run's in
    names and shapes; values to rel L2 <= 1e-4 (float) and, for 40-bit coefficient
    rows, decoded to 1e-3 of the row's peak."""
    nt = 4 * PERIOD + 2
    inp = str(tmp_path / "in.h5")
    corners = np.array([[2, 3, 4, 6, 5, 7], [10, 10, 10, 12, 13, 11]])  # 0-based x1..z2
    _write_input(inp, nt)
    if case == "streams":
        flags = ["--p_raw", "--p_rms", "--p_max", "--p_min", "--p_max_all", "--p_final",
                 "-u", "--u_non_staggered_raw", "--u_non_staggered_c", "--u_max",
                 "--p_c", "-s", "6", "--harmonics", "2"]
    else:
        data = jin.read_input_file(inp)
        data.sensor_mask_index = None
        data.sensor_mask_corners = corners
        jin.write_input_file(inp, data)
        flags = ["--p_raw", "--p_c", "--40-bit_complex", "--p_rms"]
    out_j, out_t = str(tmp_path / "j.h5"), str(tmp_path / "t.h5")
    args = ["-i", inp, "--period", str(PERIOD), *flags]
    assert jcli.main(["-o", out_j, *args]) == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(cli.DEVICE_ENV, "cpu")
        assert cli.main(["-o", out_t, *args]) == 0
    dj, dt = _all_datasets(out_j), _all_datasets(out_t)
    assert dj.keys() == dt.keys()
    for name, ref in dj.items():
        got = dt[name]
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        if case == "cuboid" and name.startswith("p_c/"):
            # each (z, y) row holds 5*cx bytes of coefficients, then float padding
            x1, _, _, x2, _, _ = corners[int(name.split("/")[1]) - 1]
            used = 5 * (x2 - x1 + 1)
            pr, pg = (
                oracle.decode40(*oracle.bytes_to_soa(np.ascontiguousarray(
                    a.view(np.uint8).reshape(*a.shape[:3], -1)[..., :used]).reshape(-1)),
                    oracle.MAX_EXP_P)
                for a in (ref, got)
            )
            peak = max(float(np.abs(pr[0]).max()), float(np.abs(pr[1]).max()))
            for a, b in zip(pg, pr):
                assert float(np.abs(a - b).max()) <= 1e-3 * peak, name
            continue
        denom = np.linalg.norm(ref)
        assert np.isfinite(got).all(), name
        assert np.linalg.norm(got - ref) <= 1e-4 * max(denom, 1e-30), name
