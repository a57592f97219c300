"""The mesh's window as one device program: the sharded form of
`kwave_tpu_torch.driver.make_window_fn`, and the rules and plumbing that replay it (and the
lead-in) as CUDA graphs on a mesh whose shards share one card.

(a) The port's sharded window (4 shards on the CPU: `Sharded` operators, sources and
mask, the pencil FFT) against `kwave_tpu.driver.make_window_fn` on a mesh of 4 of the
conftest's virtual CPU devices, called as `kwave_tpu/driver.py:817-822` calls it: the
same numpy inputs (a 16^3 heterogeneous absorbing medium, p0 and an additive p source, 48
sensors, period 8), two windows, the first with the p0 peel. Tolerances of
`tests/test_torch_dist_step.py`: rtol 2e-5 / atol 2e-6 of each field's peak; the port's
p_c bytes equal the oracle's encoding of the port's own p series.
(b) The replay plumbing on a 4-shard in-process mesh through the `EagerGraphs` stand-in
of `tests/test_torch_window.py` (the captured Python replayed eagerly): replayed windows
and a replayed lead-in equal eager ones bit for bit, in the fields, every shard's counters
and emissions and p_max_all, a shard without sensors included.
(c) `Mesh.graph_devices` for each kind of mesh, and a mesh without them running eagerly.
(d) The ranks' plans held equal. (e) `state_tensors` round-tripping a `Sharded` state,
and a tensor time index on sharded fields giving the integer path's bits.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kwave_tpu import driver as jdriver
from kwave_tpu import oracle
from kwave_tpu import solver as jsolver
from kwave_tpu import streams as jstreams
from kwave_tpu.basis import generate_basis as jbasis
from kwave_tpu.parallel import field_sharding as jfield_sharding
from kwave_tpu.parallel import make_mesh as jmake_mesh
from kwave_tpu.parallel import pencil_fft as jpencil_fft
from kwave_tpu.parallel import replicated as jreplicated
from kwave_tpu.parallel import shard_operators as jshard_operators
from kwave_tpu.parallel import shard_state as jshard_state
from kwave_tpu_torch import bitpack, convert, driver, graphs, sampling, solver, streams
from kwave_tpu_torch.basis import generate_basis
from kwave_tpu_torch.parallel import (Mesh, Sharded, field_sharding, make_mesh,
                                      pencil_fft, replicated, shard_operators, shard_state)
from kwave_tpu_torch.parallel.comm import InProcess, ProcessGroup
from kwave_tpu_torch.parallel.mesh import split_points
from kwave_tpu_torch.solver.step import source_phase, state_tensors, with_state_tensors
from test_torch_window import EagerGraphs
from torch_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

N, O, N_SENSORS, S = 16, 8, 48, 4
RTOL, ATOL = 2e-5, 2e-6  # of each field's peak: tests/test_dist_step.py's
FIELDS = ("p", "ux_sgx", "uy_sgy", "uz_sgz", "rho_x", "rho_y", "rho_z")
FLAGS = {"p_raw": True, "p_c": True, "p_max_all": True}


def _case(windows=2, mask_z=N):
    """The medium, the sources and ``N_SENSORS`` sorted sensors in the planes z < mask_z,
    from seed 11."""
    grid = dict(nx=N, ny=N, nz=N, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=windows * O)
    rng = np.random.default_rng(11)
    shape = (N, N, N)
    medium = dict(c0=(1500.0 + 100.0 * rng.random(shape)).astype(np.float32),
                  rho0=(1000.0 + 50.0 * rng.random(shape)).astype(np.float32),
                  alpha_coeff=0.75, alpha_power=1.5)
    p0 = np.zeros(shape, np.float32)
    p0[8, 8, 8] = 1e5
    p0[6, 9, 7] = -4e4
    mask = np.sort(rng.choice(mask_z * N * N, N_SENSORS, replace=False)).astype(np.int64)
    t = np.arange(windows * O, dtype=np.float32)
    srcs = dict(p0=p0, p_index=np.array([5 + N * (7 + N * 9)], np.int64),
                p_signal=(2e-2 * np.sin(2 * np.pi * t / 8.0)).astype(np.float32))
    cfg = dict(absorbing=True, p_source_flag=windows * O, p_source_mode=2)
    return grid, medium, mask, srcs, cfg


def _specs(pkg, mode40):
    return pkg.StreamSpec.from_flags(FLAGS, True, mode40)


def _jax_windows(mode40):
    """`kwave_tpu.driver.make_window_fn` on 4 virtual devices, as its run_simulation calls
    it on a mesh: two windows from t = 0, the first with the p0 peel."""
    grid, medium, mask, srcs, cfg = _case()
    g = jsolver.Grid(**grid)
    ops = jsolver.make_operators(g, jsolver.Medium(**medium), (4, 4, 4), (2.0,) * 3,
                                 absorbing=True, need_source_kappa=True)
    mesh = jmake_mesh(S)
    sharded_ops = jshard_operators(ops, 3, mesh, grid=g, pencil=True)

    def put(x):
        x = jnp.asarray(x)
        if x.shape == g.shape:
            return jax.device_put(x, jfield_sharding(mesh, 3))
        return jax.device_put(x, jreplicated(mesh))

    src = jsolver.Sources(**{k: put(v) for k, v in srcs.items()})
    specs = _specs(jstreams, mode40)
    basis = jbasis(float(O), 1, 1, normalize=True)
    kw = dict(ops=sharded_ops, src=src, mask=jax.device_put(jnp.asarray(mask),
                                                           jreplicated(mesh)),
              fft=jpencil_fft(mesh, N))
    jcfg = jsolver.SolverConfig(**cfg)
    first = jdriver.make_window_fn(specs, basis, jcfg, O, N_SENSORS, peel_p0=True, **kw)
    rest = jdriver.make_window_fn(specs, basis, jcfg, O, N_SENSORS, **kw)
    state = jshard_state(jsolver.init_state(g), mesh)
    states = jstreams.init_stream_states(specs, N_SENSORS, N ** 3, basis)
    ems = []
    with mesh:
        for w in range(2):
            state, states, em = (first if w == 0 else rest)(state, states, jnp.int32(w * O))
            ems.append(em)
    return ops, ems, state, states


def _port_setup(jops, mode40, mask_z=N, windows=2):
    """The port's sharded window pair on 4 CPU shards, from the JAX operators (the same
    numbers), and its initial state: (first, rest, sim_state, stream states, split)."""
    grid, _, mask, srcs, cfg = _case(windows, mask_z)
    mesh = make_mesh(S, devices=["cpu"] * S)
    pgrid = solver.Grid(**grid)
    ops = shard_operators(convert.operators_from_jax(jops), 3, mesh, pgrid)
    p_index, = split_points(mesh, srcs["p_index"], pgrid.shape)
    src = solver.Sources(p0=field_sharding(mesh, srcs["p0"]), p_index=p_index,
                         p_signal=replicated(mesh, srcs["p_signal"]))
    split = sampling.split_sensors(mask, pgrid.shape, S)
    tmask = Sharded([torch.as_tensor(m) for m in split.local])
    specs = _specs(streams, mode40)
    basis = generate_basis(float(O), 1, 1, normalize=True)
    kw = dict(ops=ops, src=src, mask=tmask, fft=pencil_fft(mesh, N), mesh=mesh)
    pcfg = solver.SolverConfig(**cfg)
    first = driver.make_window_fn(specs, basis, pcfg, O, N_SENSORS, peel_p0=True, **kw)
    rest = driver.make_window_fn(specs, basis, pcfg, O, N_SENSORS, **kw)
    state = shard_state(solver.init_state(pgrid), mesh)
    states = [streams.init_stream_states(specs, len(sel), N ** 3 // S, basis)
              for sel in split.select]
    return first, rest, state, states, split


def _whole(x: Sharded, dim: int = 0) -> np.ndarray:
    return torch.cat(x.shards, dim).numpy()


def _hold(got, want, what):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("mode40", [True, False], ids=["40bit", "float"])
def test_sharded_window_matches_the_jax_window_on_its_mesh(mode40):
    jops, jems, jstate, jstates = _jax_windows(mode40)
    first, rest, state, states, split = _port_setup(jops, mode40)
    assert first.graphs is None and rest.graphs is None  # a CPU mesh: no graph_devices
    ems = []
    for w in range(2):
        state, states, em = (first if w == 0 else rest)(state, states, w * O)
        assert isinstance(states, list) and len(em) == S
        ems.append(em)
    rows = np.concatenate([sampling.in_mask_order(
        torch.cat([e["p"] for e in em], dim=-1).numpy(), split) for em in ems])
    _hold(rows, np.concatenate([np.asarray(e["p"]) for e in jems]), "p rows")
    for name in FIELDS:
        _hold(_whole(getattr(state, name)), getattr(jstate, name), name)
    _hold(torch.cat([st["p_max_all"] for st in states]).numpy(), jstates["p_max_all"],
          "p_max_all")
    assert [st["p_c"]["sampled_step"] for st in states] == [2 * O] * S
    assert [st["p_c"]["compressed_step"] for st in states] == [2] * S
    # the p_c frames: the oracle's encoding of the port's own p series, byte for byte
    frames = oracle.OracleEncoder(jbasis(float(O), 1, 1, normalize=True), N_SENSORS,
                                  mode40=mode40, total_steps=2 * O).encode_series(rows)
    counts = [len(sel) for sel in split.select]
    for w, em in enumerate(ems):
        if mode40:
            mine = np.concatenate([np.asarray(bitpack.frame_wire_bytes(e["p_c"], n))
                                   .reshape(n, 5) for e, n in zip(em, counts)])
            want = oracle.soa_to_bytes(*frames[w]).reshape(N_SENSORS, 5)
        else:
            mine = np.stack([torch.cat([e["p_c"][k] for e in em], -1).numpy().reshape(-1)
                             for k in (0, 1)], -1)
            want = np.stack(frames[w], -1).reshape(N_SENSORS, 2)
        np.testing.assert_array_equal(sampling.in_mask_order(mine, split, axis=0), want)


# ---------------------------------------------------------------------------
# (b) the replay plumbing on 4 shards
# ---------------------------------------------------------------------------


def _equal(a, b) -> bool:
    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.fixture(scope="module")
def jax_ops():
    grid, medium, *_ = _case()
    return jsolver.make_operators(jsolver.Grid(**grid), jsolver.Medium(**medium),
                                  (4, 4, 4), (2.0,) * 3, absorbing=True,
                                  need_source_kappa=True)


@pytest.mark.parametrize("mode40", [True, False], ids=["40bit", "float"])
def test_replayed_mesh_windows_give_the_eager_windows_bits(mode40, jax_ops, monkeypatch):
    """Windows 8 and 16 of a 4-shard mesh run eagerly and are captured; the window at 24
    replays the key of 8 through the stand-in. Its fields, every shard's counters and
    emissions and p_max_all equal an eager window's from the same state bit for bit. The
    sensors lie in z < 12, so shard 3 holds none: its encode is skipped by a host test of
    a static shape (capture-safe), and its empty tensors ride in the static buffers."""
    first, eager, state, states, split = _port_setup(jax_ops, mode40, mask_z=12,
                                                     windows=5)
    assert len(split.select[3]) == 0 and all(len(s) for s in split.select[:3])
    monkeypatch.setattr(driver, "Graphs", EagerGraphs)
    window = driver._Window(eager.r, O, O, True, False, torch.device("cpu"), graphs=True)
    state, states, _ = first(state, states, 0)
    ref_state, ref_states = state, states
    for t in (O, 2 * O):
        state, states, em = window(state, states, t)
        ref_state, ref_states, ref_em = eager(ref_state, ref_states, t)
        assert all(_equal(a[k], b[k]) for a, b in zip(em, ref_em) for k in a)
    assert window.actions == [(O, "capture"), (2 * O, "capture")]
    t = 3 * O
    state2, states2, em2 = window(state, states, t)
    assert window.actions[-1] == (t, "replay")
    state3, states3, em3 = eager(state, states, t)
    for name in FIELDS:
        assert all(torch.equal(a, b) for a, b in zip(getattr(state2, name).shards,
                                                      getattr(state3, name).shards)), name
    assert len(states2) == len(em2) == S
    for shard2, shard3, e2, e3 in zip(states2, states3, em2, em3):
        assert shard2["p_c"]["sampled_step"] == shard3["p_c"]["sampled_step"] == t + O
        assert shard2["p_c"]["compressed_step"] == shard3["p_c"]["compressed_step"] == 4
        assert all(_equal(shard2["p_c"][k], v) for k, v in shard3["p_c"].items()
                   if isinstance(v, torch.Tensor))
        assert torch.equal(shard2["p_max_all"], shard3["p_max_all"])
        assert e2.keys() == e3.keys() and all(_equal(e2[k], v) for k, v in e3.items())
    with pytest.raises(ValueError, match="has sampled"):  # counters of t + o at t + 2o
        window(state2, states2, t + 2 * O)


class CountingGraphs(EagerGraphs):
    """The stand-in, counting its replays by key."""

    replays: dict = {}

    def replay(self, key, state, t):
        CountingGraphs.replays[key] = CountingGraphs.replays.get(key, 0) + 1
        return super().replay(key, state, t)


def test_a_mesh_run_replays_its_windows_and_lead_in_as_eager_ones(jax_ops, monkeypatch,
                                                                  tmp_path):
    """`run_simulation` on a 4-shard mesh whose `graph_devices` are made the CPU, with the
    stand-in for the graphs: a lead-in of 24 steps (-s 25, its runs of 8 replayed from
    the third on) and 6 windows (p_max_all folded in replayed ones) give the file of the
    run with every window eager, bit for bit, and the windows run as planned."""
    import h5py

    from kwave_tpu_torch.driver import RunConfig, run_simulation
    from kwave_tpu_torch.io.input_file import InputData
    step_mod = sys.modules["kwave_tpu_torch.solver.step"]  # the module, not `step`

    grid, medium, mask, srcs, _ = _case()
    data = InputData(grid=solver.Grid(**dict(grid, nt=25 + 6 * O + 3)),
                     medium=solver.Medium(**medium), pml_size=(4, 4, 4),
                     pml_alpha=(2.0,) * 3, absorbing=True, sensor_mask_index=mask,
                     p0=srcs["p0"])
    run_kw = dict(flags=dict(FLAGS), period=float(O), mode40=True, sampling_start=25)

    def run(graphs_on, path):
        log = []
        run_simulation(data, RunConfig(**run_kw, cuda_graphs=graphs_on), str(path),
                       device="cpu", mesh=make_mesh(S, devices=["cpu"] * S),
                       window_log=log)
        with h5py.File(path) as f:
            out = {k: np.asarray(f[k]) for k in ("p", "p_c", "p_max_all")}
        return out, [a for w in log for a in w.actions]

    eager, eager_acts = run(True, tmp_path / "eager.h5")  # no graph_devices: eager
    assert all(a == "eager" for _, a in eager_acts)
    monkeypatch.setattr(Mesh, "graph_devices", property(lambda self: tuple(self.devices)))
    monkeypatch.setattr(step_mod, "graph_devices", lambda state: torch.device("cpu"))
    monkeypatch.setattr(driver, "Graphs", CountingGraphs)
    monkeypatch.setattr(graphs, "Graphs", CountingGraphs)
    CountingGraphs.replays = {}
    got, acts = run(True, tmp_path / "graphs.h5")
    for name, a in eager.items():
        np.testing.assert_array_equal(got[name].view(np.uint8), a.view(np.uint8), name)
    cfg = solver.SolverConfig(sampling_start_index=25)
    assert acts == [(t, a) for t, _, a in driver.plan_windows(cfg, O, 25, 6)]
    lead_key = source_phase(cfg, 1, 8)
    assert CountingGraphs.replays.pop(lead_key) == 2  # steps 1-8 capture, 9-16 and 17-24
    assert sum(CountingGraphs.replays.values()) == 3  # windows 3-5
    off, _ = run(False, tmp_path / "off.h5")  # cuda_graphs=False: eager by the flag
    for name, a in eager.items():
        np.testing.assert_array_equal(off[name].view(np.uint8), a.view(np.uint8), name)


# ---------------------------------------------------------------------------
# (c) Mesh.graph_devices, (d) the ranks' plans, (e) sharded state tensors
# ---------------------------------------------------------------------------


def _process_group(backend, devices):
    comm = object.__new__(ProcessGroup)  # a communicator's attributes, without a group
    comm.rank, comm.n_processes, comm.size, comm.backend = 0, 4, 4, backend
    return Mesh([torch.device(d) for d in devices], comm, 4, [0])


def test_graph_device_of_each_kind_of_mesh():
    """Every in-process mesh on cards, over one card or several, and an NCCL rank are
    graphed on their shards' devices (in shard order); the CPU and gloo run eagerly."""
    cuda0 = torch.device("cuda", 0)
    assert make_mesh(S, devices=["cpu"] * S).graph_devices == ()
    assert Mesh([cuda0] * 4, InProcess(4), 4, [0, 1, 2, 3]).graph_devices == (cuda0,) * 4
    assert Mesh([cuda0], InProcess(1), 1, [0]).graph_devices == (cuda0,)
    two_cards = [cuda0, torch.device("cuda", 1)]
    assert Mesh(two_cards, InProcess(2), 2, [0, 1]).graph_devices == tuple(two_cards)
    assert Mesh(two_cards * 2, InProcess(4), 4, [0, 1, 2, 3]).graph_devices == \
        tuple(two_cards * 2)
    assert _process_group("nccl", ["cuda:0"]).graph_devices == (cuda0,)
    assert _process_group("gloo", ["cpu"]).graph_devices == ()


def test_a_gloo_process_group_mesh_has_no_graph_device():
    import socket

    import torch.distributed as dist

    from kwave_tpu_torch.parallel.distributed import initialize

    probe = socket.socket()
    probe.bind(("localhost", 0))
    port = probe.getsockname()[1]
    probe.close()
    initialize(f"localhost:{port}", 1, 0, "cpu")
    try:
        mesh = make_mesh()
        assert isinstance(mesh.comm, ProcessGroup) and mesh.comm.backend == "gloo"
        assert mesh.graph_devices == ()
        graphs.check_plans_agree(mesh.comm.all_gather(driver.plan_windows(
            solver.SolverConfig(), O, 0, 6)))
    finally:
        dist.destroy_process_group()


def test_the_ranks_plans_are_held_equal():
    plan = driver.plan_windows(solver.SolverConfig(), O, 0, 6)
    graphs.check_plans_agree([plan, list(plan), plan])
    other = driver.plan_windows(solver.SolverConfig(p_source_flag=20), O, 0, 6)
    with pytest.raises(RuntimeError, match="rank 2 plans"):
        graphs.check_plans_agree([plan, plan, other])
    with pytest.raises(RuntimeError, match="rank 1 plans"):
        graphs.check_plans_agree([plan, driver.plan_windows(solver.SolverConfig(), O, 0,
                                                            7)])


def test_state_tensors_round_trip_a_sharded_state():
    mesh = make_mesh(S, devices=["cpu"] * S)
    rng = np.random.default_rng(1)
    whole = solver.SimState(*(torch.as_tensor(rng.standard_normal((N, N, N))
                                              .astype(np.float32)) for _ in range(7)))
    state = shard_state(whole, mesh)
    flat = state_tensors(state)
    assert len(flat) == 7 * S
    assert all(a is b for a, b in zip(flat, [x for f in FIELDS
                                              for x in getattr(state, f).shards]))
    again = with_state_tensors(state, [x.clone() for x in flat])
    for name in FIELDS:
        got, want = getattr(again, name), getattr(state, name)
        assert isinstance(got, Sharded) and (got.ids, got.axis) == (want.ids, want.axis)
        assert all(torch.equal(a, b) for a, b in zip(got.shards, want.shards))
    flat2d = state_tensors(dataclasses.replace(state, uz_sgz=None, rho_z=None))
    assert len(flat2d) == 5 * S


@pytest.mark.parametrize("case", ["p_additive", "u_dirichlet_many", "transducer"])
def test_a_tensor_time_index_on_sharded_fields_gives_the_integer_bits(case):
    """`solver.step` on 4 z-slabs with the pencil FFT: a 0-d tensor ``t`` (with the
    steps' source phase) gives the integer path's bits, past each signal's end too."""
    n = 12
    grid = solver.Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=8)
    rng = np.random.default_rng(3)
    medium = solver.Medium(c0=(1500.0 + 100.0 * rng.random(grid.shape)).astype(np.float32),
                           rho0=1000.0, alpha_coeff=0.75, alpha_power=1.5)
    ops = solver.make_operators(grid, medium, (3, 3, 3), (2.0,) * 3, absorbing=True,
                                need_source_kappa=True)
    cfg = solver.SolverConfig(absorbing=True, **{
        "p_additive": dict(p_source_flag=6, p_source_mode=2),
        "u_dirichlet_many": dict(u_source_flag=6, u_source_mode=0, u_source_many=True),
        "transducer": dict(transducer_source_flag=6)}[case])
    mesh = make_mesh(S, devices=["cpu"] * S)
    idx = np.sort(rng.choice(n ** 3, 6, replace=False))
    sig = (1e-2 * rng.standard_normal(3)).astype(np.float32)  # shorter than the steps
    many = (1e-2 * rng.standard_normal((6, 3))).astype(np.float32)
    local, ux, uy, uz = split_points(mesh, idx, grid.shape, many, many, many)
    t_index, delays = split_points(mesh, idx, grid.shape, np.array([0, 1, 3, 2, 0, 1]))
    src = solver.Sources(p_index=local, p_signal=replicated(mesh, sig), u_index=local,
                         ux_signal=ux, uy_signal=uy, uz_signal=uz, transducer_index=t_index,
                         transducer_signal=replicated(mesh, (1e-2 * rng.standard_normal(7))
                                                      .astype(np.float32)),
                         delay_mask=delays)
    state = shard_state(solver.SimState(*(torch.as_tensor(
        rng.standard_normal(grid.shape).astype(np.float32)) for _ in range(7))), mesh)
    sops, fft = shard_operators(ops, 3, mesh, grid), pencil_fft(mesh, n)
    a = b = state
    for t in range(8):
        a = solver.step(a, t, sops, src, cfg, fft=fft)
        b = solver.step(b, torch.tensor(t), sops, src, cfg, fft=fft,
                        phase=source_phase(cfg, t, t))
        for name in FIELDS:
            assert all(torch.equal(x, y) for x, y in zip(getattr(a, name).shards,
                                                          getattr(b, name).shards)), \
                (case, t, name)
    off = solver.step(state, 0, sops, src, solver.SolverConfig(absorbing=True), fft=fft)
    on = solver.step(state, 0, sops, src, cfg, fft=fft)
    assert not all(torch.equal(x, y) for x, y in zip(on.ux_sgx.shards + on.p.shards,
                                                      off.ux_sgx.shards + off.p.shards))
