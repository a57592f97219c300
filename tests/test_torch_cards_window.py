"""An in-process mesh over several cards as one device program, rehearsed on the CPU.

(a) `parallel.Mesh.graph_devices`, the one rule for which mesh is graphed, on every kind
of mesh, and `solver.step.graph_devices` on every kind of state (shards on several cards
give each shard's card). (b) A time index of one 0-d tensor a shard (what `graphs.Graphs`
hands a program over several cards) gives `solver.step` the integer path's bits. (c)
`run_simulation` on a 4-shard CPU mesh whose shards are declared to lie on cards, its
windows and lead-in through the real `graphs.Graphs` with only its CUDA steps replaced
(`EagerCards`: no memory pools; the capture runs the program once, a launch runs it
eagerly into the recorded outputs): the file equals the eager run's bit for bit, every
shard's time index is set to the run's step before each launch, and the run is held to
`kwave_tpu.driver.run_simulation` on 4 virtual devices (the JAX package's ``--devices
4``) with `tests/test_torch_dist_step.py`'s tolerances. A capture that fails raises
through `run_simulation`; nothing falls back to the eager window.
"""

import sys
import types

import numpy as np
import pytest
import torch

from kwave_tpu import driver as jdriver
from kwave_tpu import solver as jsolver
from kwave_tpu.io.input_file import InputData as JInputData
from kwave_tpu.parallel import make_mesh as jmake_mesh
from kwave_tpu_torch import driver, graphs, solver
from kwave_tpu_torch.driver import RunConfig, run_simulation
from kwave_tpu_torch.parallel import (Mesh, Sharded, make_mesh, pencil_fft, replicated,
                                      shard_operators, shard_state)
from kwave_tpu_torch.parallel.comm import InProcess, ProcessGroup
from kwave_tpu_torch.parallel.mesh import split_points
from kwave_tpu_torch.solver.step import graph_devices, source_phase
from test_torch_dist_step import _datasets, _hold, _port_input
from torch_helpers import EagerCards, one_torch_thread  # noqa: F401 (an autouse fixture)

S, O, LEAD, WINDOWS, TAIL = 4, 8, 25, 6, 3
FIELDS = ("p", "ux_sgx", "uy_sgy", "uz_sgz", "rho_x", "rho_y", "rho_z")


# ---------------------------------------------------------------------------
# (a) the graph rule
# ---------------------------------------------------------------------------

def _cards(*ks):
    return [torch.device("cuda", k) for k in ks]


def _group(backend, device):
    comm = object.__new__(ProcessGroup)  # a communicator's attributes, without a group
    comm.rank, comm.n_processes, comm.size, comm.backend = 2, 4, 4, backend
    return Mesh([torch.device(device)], comm, 4, [2])


MESHES = {  # kind -> (mesh, graph_devices)
    "cpu in one process": (lambda: make_mesh(S, devices=["cpu"] * S), ()),
    "4 shards of one card": (lambda: Mesh(_cards(0, 0, 0, 0), InProcess(4), 4,
                                          [0, 1, 2, 3]), tuple(_cards(0, 0, 0, 0))),
    "4 cards": (lambda: Mesh(_cards(0, 1, 2, 3), InProcess(4), 4, [0, 1, 2, 3]),
                tuple(_cards(0, 1, 2, 3))),
    "2 cards, 2 shards each": (lambda: Mesh(_cards(0, 0, 1, 1), InProcess(4), 4,
                                            [0, 1, 2, 3]), tuple(_cards(0, 0, 1, 1))),
    "a card and the cpu": (lambda: Mesh([torch.device("cuda", 0), torch.device("cpu")],
                                        InProcess(2), 2, [0, 1]), ()),
    "nccl rank": (lambda: _group("nccl", "cuda:2"), tuple(_cards(2))),
    "gloo rank": (lambda: _group("gloo", "cpu"), ()),
}


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_the_graph_rule_of_each_kind_of_mesh(kind):
    """An in-process mesh whose shards all lie on cards, on one or on several, and an
    NCCL rank are graphed on their shards' devices in shard order; a mesh with a shard
    on the CPU, and gloo, run eagerly (an empty tuple)."""
    make, want = MESHES[kind]
    assert make().graph_devices == want


def _state(p):
    return solver.SimState(p=p, ux_sgx=None, uy_sgy=None, uz_sgz=None, rho_x=None,
                           rho_y=None, rho_z=None)


def _on(device):
    return types.SimpleNamespace(device=torch.device(device))  # a tensor's device alone


STATES = {  # kind -> (state, graph_devices)
    "one cpu tensor": (_state(torch.zeros(2)), None),
    "one card": (_state(_on("cuda:1")), torch.device("cuda", 1)),
    "cpu shards": (_state(Sharded([torch.zeros(2)] * S)), None),
    "shards of one card": (_state(Sharded([_on("cuda:0")] * S)), tuple(_cards(0, 0, 0, 0))),
    "shards over 4 cards": (_state(Sharded([_on(f"cuda:{k}") for k in range(S)])),
                            tuple(_cards(0, 1, 2, 3))),
}


@pytest.mark.parametrize("kind", sorted(STATES))
def test_step_graph_devices_of_each_kind_of_state(kind):
    """`solver.step.graph_devices`: the one card of plain fields, each shard's card of
    sharded ones (several cards: one graph spans them), None on the CPU."""
    state, want = STATES[kind]
    assert graph_devices(state) == want


def test_step_graph_devices_refuse_shards_on_a_card_and_the_cpu():
    with pytest.raises(ValueError, match="every shard on a card"):
        graph_devices(_state(Sharded([_on("cuda:0"), torch.zeros(2)])))


# ---------------------------------------------------------------------------
# (b) a time index a shard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["p_additive", "u_dirichlet_many", "transducer"])
def test_a_time_index_a_shard_gives_the_integer_bits(case):
    """`solver.step` on 4 z-slabs with the pencil FFT: a `Sharded` time index, one 0-d
    tensor a shard (each shard's own, as a graph over several cards holds them), gives
    the integer path's bits, past each signal's end too."""
    n = 12
    grid = solver.Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=8)
    rng = np.random.default_rng(8)
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
        t_shards = Sharded([torch.tensor(t) for _ in range(S)])
        b = solver.step(b, t_shards, sops, src, cfg, fft=fft, phase=source_phase(cfg, t, t))
        for name in FIELDS:
            assert all(torch.equal(x, y) for x, y in zip(getattr(a, name).shards,
                                                          getattr(b, name).shards)), \
                (case, t, name)
    with pytest.raises(ValueError, match="source phase"):
        solver.step(state, Sharded([torch.tensor(0)] * S), sops, src, cfg, fft=fft)


# ---------------------------------------------------------------------------
# (c) run_simulation through the real Graphs, its CUDA steps replaced
# ---------------------------------------------------------------------------

class FailingCapture(EagerCards):
    def _record(self, program):
        raise RuntimeError("the capture failed")


def _case():
    """16^3 heterogeneous absorbing medium, p0 and an additive p source acting on every
    step (its signal is read at the graphs' time index), 48 sensors, period 8: a
    lead-in of 24 steps (-s 25), 6 windows and a 3-step tail."""
    nt = LEAD + WINDOWS * O + TAIL
    grid = jsolver.Grid(nx=16, ny=16, nz=16, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=nt)
    rng = np.random.default_rng(12)
    medium = jsolver.Medium(c0=(1500.0 + 100.0 * rng.random(grid.shape)).astype(np.float32),
                            rho0=(1000.0 + 50.0 * rng.random(grid.shape)).astype(np.float32),
                            alpha_coeff=0.75, alpha_power=1.5)
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8] = 1e5
    t = np.arange(nt, dtype=np.float32)
    data = JInputData(
        grid=grid, medium=medium, absorbing=True, pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3,
        sensor_mask_index=np.sort(rng.choice(grid.n_elements, 48, replace=False)).astype(
            np.int64), p0=p0, p_source_flag=nt, p_source_mode=2,
        p_source_index=np.array([5 + 16 * (7 + 16 * 9)]),
        p_source_input=(2e-2 * np.sin(2 * np.pi * t / 8.0)).astype(np.float32))
    run_kw = dict(flags=dict(p_raw=True, p_c=True, p_max_all=True, p_final=True),
                  period=float(O), mode40=True, sampling_start=LEAD)
    return data, run_kw


def _declare_cards(monkeypatch, graphs_class):
    """The mesh and the step graph their shards as if each lay on a card, through
    ``graphs_class`` in place of `graphs.Graphs`."""
    step_mod = sys.modules["kwave_tpu_torch.solver.step"]  # the module, not `step`
    monkeypatch.setattr(Mesh, "graph_devices", property(lambda self: tuple(self.devices)))
    monkeypatch.setattr(step_mod, "graph_devices",
                        lambda state: tuple(x.device for x in state.p.shards))
    monkeypatch.setattr(driver, "Graphs", graphs_class)
    monkeypatch.setattr(graphs, "Graphs", graphs_class)


def test_a_cards_run_replays_its_windows_and_lead_in_as_eager_ones(monkeypatch, tmp_path):
    """The 4-shard run with graphs gives the eager file bit for bit; its lead-in's runs
    of 8 steps replay from the second (steps 9 and 17), its windows as `plan_windows`
    says (49, 57 and 65 replayed), and before each launch every shard's time index holds
    the launch's first step. The file is held to kwave_tpu's run on 4 devices."""
    data, run_kw = _case()
    port = _port_input(data)

    def run(cuda_graphs, name):
        log = []
        run_simulation(port, RunConfig(**run_kw, cuda_graphs=cuda_graphs),
                       str(tmp_path / name), device="cpu",
                       mesh=make_mesh(S, devices=["cpu"] * S), window_log=log)
        return _datasets(str(tmp_path / name)), [a for w in log for a in w.actions]

    eager, acts = run(True, "eager.h5")  # a CPU mesh: no graph_devices, every window eager
    assert all(a == "eager" for _, a in acts)
    _declare_cards(monkeypatch, EagerCards)
    EagerCards.launches = []
    got, acts = run(True, "cards.h5")
    assert got.keys() == eager.keys()
    for key, (a, _) in eager.items():
        np.testing.assert_array_equal(got[key][0].view(np.uint8), a.view(np.uint8), key)
    cfg = solver.SolverConfig(p_source_flag=data.p_source_flag, p_source_mode=2,
                              sampling_start_index=LEAD)
    plan = driver.plan_windows(cfg, O, LEAD, WINDOWS)
    assert acts == [(t, a) for t, _, a in plan]
    replayed = [t for t, a in acts if a == "replay"]
    assert replayed == [LEAD + 3 * O, LEAD + 4 * O, LEAD + 5 * O]
    assert EagerCards.launches == [[t] * S for t in [9, 17] + replayed]
    off, acts = run(False, "off.h5")  # cuda_graphs=False: eager by the flag
    assert all(a == "eager" for _, a in acts)
    for key, (a, _) in eager.items():
        np.testing.assert_array_equal(off[key][0].view(np.uint8), a.view(np.uint8), key)
    jpath = str(tmp_path / "jax.h5")
    jdriver.run_simulation(data, jdriver.RunConfig(**run_kw), jpath, mesh=jmake_mesh(S))
    _hold(got, _datasets(jpath), ("p", "p_c", "p_max_all", "p_final"),
          "4 shards graphed as cards vs kwave_tpu on 4 devices")


def test_a_failed_capture_raises_through_the_run(monkeypatch, tmp_path):
    """No window or lead-in falls back to eager ops when its capture fails."""
    data, run_kw = _case()
    _declare_cards(monkeypatch, FailingCapture)
    with pytest.raises(RuntimeError, match="the capture failed"):
        run_simulation(_port_input(data), RunConfig(**run_kw), str(tmp_path / "x.h5"),
                       device="cpu", mesh=make_mesh(S, devices=["cpu"] * S))


def test_graphs_keep_a_time_index_a_shard():
    """One device: one 0-d time index; a list of shard devices: one a shard, as a
    `Sharded` in shard order, each filled by every replay."""
    one = EagerCards("cpu")
    assert isinstance(one.t, torch.Tensor) and one.t.ndim == 0
    four = EagerCards(["cpu"] * S)
    assert isinstance(four.t, Sharded) and len(four.t.shards) == S
    assert len({id(x) for x in four.t.shards}) == S
    state = [torch.arange(3.0), torch.ones(2)]

    def body(static, t):
        return [static[0] + 1, static[1] * 2], {"seen": torch.stack(t.shards)}

    four.capture("k", state, body)
    EagerCards.launches = []
    static, extra = four.replay("k", state, 11)
    assert EagerCards.launches == [[11] * S]
    assert torch.equal(extra["seen"], torch.full((S,), 11))
    assert torch.equal(static[0], torch.arange(3.0) + 1)
    static, extra = four.replay("k", static, 12)
    assert torch.equal(extra["seen"], torch.full((S,), 12))
    assert torch.equal(static[1], torch.full((2,), 4.0))
