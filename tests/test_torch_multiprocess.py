"""The port across processes on the CPU (gloo): `python -m kwave_tpu_torch.cli` as 2 and 4
ranks (``--coordinator --num_processes --process_id``, one z-slab a rank, the pencil's
trades over `all_to_all_single`, every emission through `WriterGather` to rank 0, which
alone writes the file), held to the in-process mesh of the same shard count; a
checkpointed two-process run; the cuboid 40-bit run; the sharded encode; `WriterGather`
in one process; and a dead peer named by the writer. The ports of
`tests/test_multiprocess.py`'s cases. Each spawned process gets one torch thread and a
time limit of its own."""

import os
import socket
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from kwave_tpu.io.input_file import write_input_file
from kwave_tpu_torch.cli import DEVICE_ENV
from kwave_tpu_torch.driver import RunConfig, run_simulation
from kwave_tpu_torch.io.input_file import read_input_file
from kwave_tpu_torch.parallel import make_mesh
from kwave_tpu_torch.parallel.distributed import WriterGather
from torch_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mp_worker.py")
FLAGS = ["--p_raw", "--p_c", "--p_rms", "--p_max_all", "--period", "10", "--harmonics", "2"]
RUN = dict(flags=dict(p_raw=True, p_c=True, p_rms=True, p_max_all=True), period=10.0,
           harmonics=2)
LIMIT_S = 60  # each test's own limit on its processes


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    return dict(os.environ, **{DEVICE_ENV: "cpu", "OMP_NUM_THREADS": "1"}, **extra)


def _spawn(argvs, env, timeout=LIMIT_S):
    """Start every rank's argv, wait for all; kill all on the time limit."""
    procs = [subprocess.Popen(argv, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for argv in argvs]
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            outs.append((p.returncode, so, se))
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
            q.communicate()
        pytest.fail(f"{len(argvs)} processes did not finish within {timeout} s")
    return outs


def _cli_ranks(nprocs, args, env=None):
    port = _free_port()
    return _spawn([[sys.executable, "-m", "kwave_tpu_torch.cli", *args,
                    "--coordinator", f"localhost:{port}", "--num_processes", str(nprocs),
                    "--process_id", str(r)] for r in range(nprocs)], env or _env())


def _input(tmp_path, cuboid=False):
    """tests/mp_driver_worker.py's inputs (the JAX package's two-process tests), written
    by kwave_tpu; the port reads the same file."""
    from tests.mp_driver_worker import build_input, build_input_cuboid

    path = str(tmp_path / ("cuboid_in.h5" if cuboid else "in.h5"))
    write_input_file(path, build_input_cuboid() if cuboid else build_input())
    return path


def _in_process(inp, out, s, **run_kw):
    run_simulation(read_input_file(inp), RunConfig(**{**RUN, **run_kw}), out, device="cpu",
                   mesh=make_mesh(s, devices=["cpu"] * s))


def _datasets(path) -> dict:
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, np.asarray(obj))
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _bit_equal(a_path, b_path):
    a, b = _datasets(a_path), _datasets(b_path)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k].view(np.uint8), b[k].view(np.uint8), err_msg=k)


@pytest.mark.parametrize("nprocs", [2, 4])
def test_cli_ranks_write_one_file_equal_to_the_in_process_mesh(nprocs, tmp_path):
    """Every rank runs the CLI; rank 0 alone writes the file (the others print nothing of
    it), which equals the in-process mesh run of the same shard count bit for bit (and so
    within any tolerance)."""
    inp = _input(tmp_path)
    out = str(tmp_path / "mp.h5")
    outs = _cli_ranks(nprocs, ["-i", inp, "-o", out, *FLAGS, "--copy_sensor_mask"])
    for rc, so, se in outs:
        assert rc == 0, (so[-500:], se[-3000:])
    assert "p_c:" in outs[0][1] and all("p_c:" not in so for _, so, _ in outs[1:])
    ref = str(tmp_path / "ref.h5")
    _in_process(inp, ref, nprocs)
    a, b = _datasets(out), _datasets(ref)
    assert "sensor_mask_index" in a  # copied by the writer alone
    for k in b:
        np.testing.assert_array_equal(a[k].view(np.uint8), b[k].view(np.uint8), err_msg=k)


def test_two_process_checkpoint_resume(tmp_path):
    """Two ranks stop at t = 20 and rank 0 writes one checkpoint; two ranks started again
    resume from it (every rank reads it and keeps its slab): the file equals the
    uninterrupted in-process mesh run bit for bit."""
    inp = _input(tmp_path)
    out, ckpt = str(tmp_path / "legs.h5"), str(tmp_path / "legs.ckpt.h5")
    args = ["-i", inp, "-o", out, *FLAGS, "--checkpoint_file", ckpt,
            "--checkpoint_timesteps", "20"]
    for leg in range(2):
        for rc, so, se in _cli_ranks(2, args):
            assert rc == 0, (leg, so[-500:], se[-3000:])
        if leg == 0:
            with h5py.File(ckpt, "r") as f:
                assert int(np.asarray(f["t_index"]).reshape(-1)[0]) == 20
    ref = str(tmp_path / "ref.h5")
    _in_process(inp, ref, 2)
    a, b = _datasets(out), _datasets(ref)
    for k in b:
        np.testing.assert_array_equal(a[k].view(np.uint8), b[k].view(np.uint8), err_msg=k)


def test_two_process_cuboid_40bit(tmp_path):
    """A cuboid mask and the 40-bit stream across two ranks: the per-cuboid groups and
    padded rows assembled on rank 0 equal the in-process mesh's bytes."""
    inp = _input(tmp_path, cuboid=True)
    out = str(tmp_path / "cub.h5")
    for rc, so, se in _cli_ranks(2, ["-i", inp, "-o", out, *FLAGS, "--40-bit_complex"]):
        assert rc == 0, (so[-500:], se[-3000:])
    ref = str(tmp_path / "ref.h5")
    _in_process(inp, ref, 2, mode40=True)
    _bit_equal(out, ref)


def test_two_process_sharded_encode_gather():
    """`encode_sharded` over two ranks and `gather_frames` give the one-process frames."""
    from kwave_tpu_torch import encoder
    from kwave_tpu_torch.basis import generate_basis

    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "frames.npz")
        port = str(_free_port())
        outs = _spawn([[sys.executable, WORKER, "encode", str(r), "2", port, out]
                       for r in range(2)], _env())
        for rc, so, se in outs:
            assert rc == 0, (so[-500:], se[-3000:])
        got = np.load(out)
        sys.path.insert(0, os.path.dirname(WORKER))
        from torch_mp_worker import series

        f_re, f_im = encoder.encode_series_fast(torch.from_numpy(series(2)),
                                                generate_basis(20.0, 1, 2, normalize=True))
        np.testing.assert_array_equal(got["re"], f_re.numpy())
        np.testing.assert_array_equal(got["im"], f_im.numpy())


def test_peer_death_names_the_rank(tmp_path):
    """The highest rank exits hard as it enters its second gather: the writer fails fast
    (the TCP close, well inside the gather timeout) with an error naming it."""
    inp = _input(tmp_path)
    port = _free_port()
    argv = ["-i", inp, "-o", str(tmp_path / "die.h5"), *FLAGS, "--coordinator",
            f"localhost:{port}", "--num_processes", "2"]
    outs = _spawn([[sys.executable, WORKER, "die", str(r), "2", "--", *argv,
                    "--process_id", str(r)] for r in range(2)],
                  _env(KWAVE_GATHER_TIMEOUT_S="30"))
    (rc0, _, se0), (rc1, _, _) = outs
    assert rc1 == 17  # the injected death
    assert rc0 != 0, "the writer must not report success after a peer died"
    assert "rank 1" in se0, se0[-3000:]
    assert "closed the connection" in se0 or "went silent" in se0, se0[-2000:]


def test_writer_gather_single_process_mixed_leaves():
    """One process: a tree of None, numpy, scalars, tensors and sharded values comes back
    as host numpy, the shards assembled in their order."""
    from kwave_tpu_torch.parallel import Sharded

    g = WriterGather()
    tree = {
        "none": None,
        "np": np.arange(4),
        "scalar": 3,
        "dev": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "tup": (torch.tensor(7, dtype=torch.int32), None),
        "sharded": Sharded([torch.ones(2, 1), torch.zeros(2, 3)], ids=[1, 0], axis=-1),
    }
    out = g.gather(tree)
    assert out["none"] is None
    np.testing.assert_array_equal(out["np"], np.arange(4))
    assert out["scalar"] == 3
    assert isinstance(out["dev"], np.ndarray)
    np.testing.assert_array_equal(out["dev"], np.arange(6).reshape(2, 3))
    assert out["tup"][0] == 7 and out["tup"][1] is None
    np.testing.assert_array_equal(out["sharded"], [[0, 0, 0, 1], [0, 0, 0, 1]])
    g.close()


def test_advertise_host_env_override(monkeypatch):
    monkeypatch.setenv("KWAVE_WRITER_HOST", "10.1.2.3")
    assert WriterGather._advertise_host() == "10.1.2.3"
    monkeypatch.delenv("KWAVE_WRITER_HOST")
    host = WriterGather._advertise_host()
    assert isinstance(host, str) and host


def test_writer_gather_context_manager():
    with WriterGather() as g:
        out = g.gather({"a": np.arange(3)})
        np.testing.assert_array_equal(out["a"], np.arange(3))
    assert g._sock is None and g._srv is None
