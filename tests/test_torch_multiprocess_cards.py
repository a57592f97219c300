"""The port's mesh of several shards a process on the CPU (gloo): P ranks with C CPU
shards each, S = P·C, shard r·C + c on rank r's c-th (the order of `jax.devices()`
across processes). The ports of `tests/test_multiprocess.py`'s P x 2 cases
(`tests/mp_driver_worker.py` forces 2 devices a process):

- the trade (`ProcessGroup.all_to_all`: copies into one buffer a slot, one
  `all_to_all_single` a slot group) and `all_reduce` over 2 ranks x 2 shards, and over
  1 rank x 2 (the card's one-card layout), bit for bit `InProcess(S)`'s;
- ``python -m kwave_tpu_torch.cli`` as 2 ranks with ``--devices 4``: its file equals the
  in-process mesh of 4 CPU shards bit for bit and `kwave_tpu`'s run on a mesh of 4
  devices within PERF.md §2's tolerances (p rel L2 1e-4, decoded p_c 1e-3 of the peak);
- the checkpointed two-leg 2 x 2 run against one leg, the cuboid 40-bit 2 x 2 run;
- the 2 x 2 run's windows and lead-in through `graphs.Graphs` with its CUDA steps
  replaced (what the card captures, rehearsed: every rank's plan alike, the file the
  eager run's);
- the card choice (`distributed.local_cards`) and the refusals.

Each spawned process gets one torch thread and a time limit of its own."""

import dataclasses
import os
import sys

import h5py
import numpy as np
import pytest
import torch

from kwave_tpu import driver as jdriver
from kwave_tpu.parallel import make_mesh as jmake_mesh
from kwave_tpu_torch import cli, oracle
from kwave_tpu_torch.basis import generate_basis
from kwave_tpu_torch.parallel.comm import InProcess
from kwave_tpu_torch.parallel.distributed import local_cards
from kwave_tpu_torch.params import build_parser
from test_torch_multiprocess import (FLAGS, WORKER, _bit_equal, _cli_ranks, _datasets,
                                     _env, _free_port, _in_process, _input, _spawn)
from torch_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

sys.path.insert(0, os.path.dirname(WORKER))
from torch_mp_worker import PAIRS, reduce_values, trade_parts  # noqa: E402

P, C = 2, 2
CARDS = ["--devices", str(P * C)]
P_REL_L2 = 1e-4  # PERF.md §2: raw p against kwave_tpu
DECODED_TOL = 1e-3  # PERF.md §2: decoded p_c, of the series' peak


@pytest.mark.parametrize("nprocs", [P, 1])
def test_the_trade_and_the_reductions_equal_one_process(nprocs, tmp_path):
    """``nprocs`` ranks x C CPU shards: every shard's result of both pencil trades, real
    and complex, is `InProcess(S)`'s bit for bit; ``all_reduce`` of one value a shard
    equals `InProcess(S)`'s over the S values, and of one value a process the reduce of
    the processes' values."""
    out = str(tmp_path / "trade")
    port = str(_free_port())
    outs = _spawn([[sys.executable, WORKER, "trade", str(r), str(nprocs), port, str(C), out]
                   for r in range(nprocs)], _env())
    for rc, so, se in outs:
        assert rc == 0, (so[-500:], se[-3000:])
    got = {}
    for r in range(nprocs):
        with np.load(f"{out}.{r}.npz") as f:
            got.update({k: f[k] for k in f.files if k != "str"})
            assert str(f["str"]) == (f"{nprocs * C} shards ({nprocs} process"
                                     f"{'es' if nprocs > 1 else ''} x {C}; rank {r}'s on "
                                     "cpu, cpu)")
    s = nprocs * C
    one = InProcess(s)
    for split, concat in PAIRS:
        for dtype in ("float32", "complex64"):
            want = one.all_to_all([trade_parts(g, s, split, dtype) for g in range(s)],
                                  split, concat)
            for g in range(s):
                a, b = got[f"trade/{split}{concat}/{dtype}/{g}"], want[g].numpy()
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    for op in ("sum", "max", "min"):
        want = one.all_reduce([reduce_values(g, op) for g in range(s)], op)
        for g in range(s):
            np.testing.assert_array_equal(got[f"shards/{op}/{g}"], want[g].numpy())
        want = InProcess(nprocs).all_reduce([reduce_values(100 + r, op)
                                             for r in range(nprocs)], op)[0].numpy()
        for r in range(nprocs):
            np.testing.assert_array_equal(got[f"process/{op}/{r}"], want)


@pytest.fixture(scope="module")
def two_by_two(tmp_path_factory):
    """The CLI as 2 ranks x 2 CPU shards on tests/mp_driver_worker.py's input, one leg:
    (input, output, the in-process mesh of 4 shards' output, the ranks' outputs)."""
    tmp = tmp_path_factory.mktemp("cards")
    inp, out = _input(tmp), str(tmp / "mp.h5")
    outs = _cli_ranks(P, ["-i", inp, "-o", out, *FLAGS, "--copy_sensor_mask", *CARDS])
    ref = str(tmp / "ref.h5")
    _in_process(inp, ref, P * C)
    return inp, out, ref, outs


def _decoded(path) -> np.ndarray:
    """The file's float p_c, reconstructed by the oracle: ``[steps, sensors]``."""
    with h5py.File(path, "r") as f:
        ds, steps = f["p_c"], int(f["p"].shape[1])
        rows, h = np.asarray(ds)[0], int(ds.attrs["c_harmonics"])
        period = float(ds.attrs["c_period"])
    c = rows.reshape(rows.shape[0], -1, h, 2)
    return oracle.reconstruct(c[..., 0], c[..., 1], generate_basis(period, 1, h,
                                                                   normalize=True),
                              False, steps)


def test_cli_two_ranks_of_two_shards_equal_the_in_process_mesh_and_kwave_tpu(two_by_two,
                                                                            tmp_path):
    """Rank 0 alone writes the file (and the copied mask); it equals the in-process mesh
    of 4 CPU shards bit for bit, and `kwave_tpu`'s run on its mesh of 4 devices within
    PERF.md §2's tolerances."""
    from tests.mp_driver_worker import build_input

    inp, out, ref, outs = two_by_two
    for rc, so, se in outs:
        assert rc == 0, (so[-500:], se[-3000:])
    assert "p_c:" in outs[0][1] and "p_c:" not in outs[1][1]
    assert "4 shards (2 processes x 2; rank 0's on cpu, cpu)" in outs[0][1]
    a, b = _datasets(out), _datasets(ref)
    assert "sensor_mask_index" in a
    for k in b:
        np.testing.assert_array_equal(a[k].view(np.uint8), b[k].view(np.uint8), err_msg=k)
    jpath = str(tmp_path / "jax.h5")
    jdriver.run_simulation(build_input(), jdriver.RunConfig(
        flags=dict(p_raw=True, p_c=True, p_rms=True, p_max_all=True), period=10.0,
        harmonics=2), jpath, mesh=jmake_mesh(P * C))
    j = _datasets(jpath)
    for name in ("p", "p_rms", "p_max_all"):
        x, y = j[name].astype(np.float64), a[name].astype(np.float64)
        assert np.linalg.norm(y - x) <= P_REL_L2 * np.linalg.norm(x), name
    dj, dp = _decoded(jpath), _decoded(out)
    assert np.abs(dp - dj).max() <= DECODED_TOL * np.abs(dj).max()


def test_two_ranks_of_two_shards_in_two_legs_equal_one_leg(two_by_two, tmp_path):
    """2 x 2 stops at t = 20, rank 0 writes one checkpoint; 2 x 2 started again resumes
    from it: the file equals the one-leg 2 x 2 run bit for bit."""
    inp, one_leg, _, _ = two_by_two
    out, ckpt = str(tmp_path / "legs.h5"), str(tmp_path / "legs.ckpt.h5")
    args = ["-i", inp, "-o", out, *FLAGS, *CARDS, "--checkpoint_file", ckpt,
            "--checkpoint_timesteps", "20"]
    for leg in range(2):
        for rc, so, se in _cli_ranks(P, args):
            assert rc == 0, (leg, so[-500:], se[-3000:])
        if leg == 0:
            with h5py.File(ckpt, "r") as f:
                assert int(np.asarray(f["t_index"]).reshape(-1)[0]) == 20
    a, b = _datasets(out), _datasets(one_leg)
    for k in a:
        np.testing.assert_array_equal(a[k].view(np.uint8), b[k].view(np.uint8), err_msg=k)


def test_two_ranks_of_two_shards_cuboid_40bit(tmp_path):
    """A cuboid mask and the 40-bit stream over 2 x 2: rank 0's per-cuboid groups and
    padded rows equal the in-process mesh of 4 shards' bytes."""
    inp = _input(tmp_path, cuboid=True)
    out = str(tmp_path / "cub.h5")
    for rc, so, se in _cli_ranks(P, ["-i", inp, "-o", out, *FLAGS, "--40-bit_complex",
                                     *CARDS]):
        assert rc == 0, (so[-500:], se[-3000:])
    ref = str(tmp_path / "ref.h5")
    _in_process(inp, ref, P * C, mode40=True)
    _bit_equal(out, ref)


def test_two_ranks_of_two_shards_replay_their_windows_as_the_eager_run(tmp_path):
    """2 x 2 with every shard declared on a card: each rank's windows and lead-in go
    through the real `graphs.Graphs` (its CUDA steps replaced, `torch_helpers.EagerCards`)
    as `driver.plan_windows` says, every rank alike (`check_plans_agree`), each of its
    shards' time index set to the launch's first step; the file equals the eager run's
    and the in-process mesh of 4 shards' bit for bit."""
    from kwave_tpu_torch import driver, solver
    from kwave_tpu_torch.driver import RunConfig, run_simulation
    from kwave_tpu_torch.io.input_file import read_input_file
    from kwave_tpu_torch.parallel import make_mesh
    from torch_mp_worker import GRAPHS_NT, GRAPHS_RUN, GRAPHS_START

    inp, out = _input(tmp_path), str(tmp_path / "g")
    port = str(_free_port())
    outs = _spawn([[sys.executable, WORKER, "graphs", str(r), str(P), port, str(C), inp, out]
                   for r in range(P)], _env())
    for rc, so, se in outs:
        assert rc == 0, (so[-500:], se[-3000:])
    o = 10
    plan = driver.plan_windows(solver.SolverConfig(sampling_start_index=GRAPHS_START), o,
                               GRAPHS_START, (GRAPHS_NT - GRAPHS_START) // o)
    replayed = [t for t, _, a in plan if a == "replay"]
    assert replayed == [51, 61, 71]
    for r in range(P):
        with np.load(f"{out}.{r}.npz", allow_pickle=True) as f:
            assert [tuple(x) for x in f["actions"]] == [(t, a) for t, _, a in plan]
            assert f["launches"].tolist() == [[t] * C for t in [11] + replayed]
    _bit_equal(f"{out}.graphs.h5", f"{out}.eager.h5")
    data = read_input_file(inp)
    data.grid = dataclasses.replace(data.grid, nt=GRAPHS_NT)
    ref = str(tmp_path / "ref.h5")
    run_simulation(data, RunConfig(**GRAPHS_RUN), ref, device="cpu",
                   mesh=make_mesh(P * C, devices=["cpu"] * P * C))
    _bit_equal(f"{out}.graphs.h5", ref)


def test_the_cards_a_process_takes():
    """Local rank l takes cards l·C .. l·C + C - 1, or every card where it sees exactly
    C; too few cards are refused, naming the count."""
    assert local_cards(0, 1, 1) == [0]
    assert local_cards(2, 1, 4) == [2]
    assert local_cards(0, 2, 4) == [0, 1]
    assert local_cards(1, 2, 4) == [2, 3]
    assert local_cards(3, 2, 2) == [0, 1]  # CUDA_VISIBLE_DEVICES set a process
    with pytest.raises(RuntimeError, match=r"takes 2 card\(s\) a process .* sees 1"):
        local_cards(0, 2, 1)
    with pytest.raises(RuntimeError, match=r"cards 2\.\.3.* sees 3"):
        local_cards(1, 2, 3)
    with pytest.raises(ValueError, match="at least one card"):
        local_cards(0, 0, 4)


def test_devices_not_a_multiple_of_the_ranks_is_refused(capsys):
    """``--devices 3`` under 2 ranks: refused with the JAX package's reason (the global
    device count), before any process group starts."""
    import torch.distributed as dist

    parser = build_parser()
    args = parser.parse_args(["-i", "in.h5", "-o", "out.h5", "--devices", "3",
                              "--num_processes", "2", "--coordinator",
                              f"localhost:{_free_port()}", "--process_id", "0"])
    with pytest.raises(SystemExit):
        cli.mesh_from_args(parser, args, torch.device("cpu"))
    err = capsys.readouterr().err
    assert "--devices 3 under a multi-process launch must equal the global device count" \
        in err and "a multiple of 2" in err
    assert not dist.is_initialized()


def test_a_group_mesh_refuses_devices_of_another_kind():
    """Under gloo the shards are CPU shards: a card listed is refused; the mesh's C
    shards take ids r·C + c."""
    import torch.distributed as dist

    from kwave_tpu_torch.parallel import make_mesh
    from kwave_tpu_torch.parallel.distributed import initialize

    initialize(f"localhost:{_free_port()}", 1, 0, "cpu")
    try:
        with pytest.raises(ValueError, match="gloo process group trades cpu tensors"):
            make_mesh(devices=["cuda:0", "cuda:0"])
        with pytest.raises(ValueError, match="with 2 devices a rank"):
            make_mesh(3, devices=["cpu", "cpu"])
        mesh = make_mesh(3)
        assert mesh.shard_ids == [0, 1, 2] and mesh.devices == [torch.device("cpu")] * 3
        assert mesh.comm.local == 3 and mesh.graph_devices == ()
    finally:
        dist.destroy_process_group()
