"""The window program: `kwave_tpu_torch.driver.make_window_fn` against
`kwave_tpu.driver.make_window_fn`, both on the CPU, and the rules that decide which
windows the port replays as CUDA graphs on a card.

(a) A 16^3 heterogeneous absorbing medium with p0 and an additive p source, 48 index
sensors, period 8, three windows (the first peels p0 and mirrors; a p source's flag falls
inside the second in one case), four variants (40-bit / float, overlap on / off), from
the same numpy-seeded input through both packages' window functions. Tolerances: the raw
rows and every field of the state within rel L2 1e-4, p_max_all too (fp32 FFTs of two
libraries, and XLA:CPU contracts mul+add), the p_c frames decoded by the oracle within
1e-3 of the series peak (PERF.md section 2; the codec's 17-bit mantissas may round the
two packages' series to different quanta).
(b) `solver.step` with a 0-d tensor time index equals `step` with the int bit for bit,
for every source kind and mode, past the end of each signal (the clamp) too.
(c) The key rule as plain Python (`plan_windows`, `window_key`, `chunk_keys`,
`graph_actions`), and the capture / replay plumbing of `driver._Window` rehearsed on the
CPU with a stand-in for `graphs.Graphs` that replays the captured Python eagerly: the
same bits as the eager windows, the encoder's counters advanced on the host.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kwave_tpu import driver as jdriver
from kwave_tpu import oracle
from kwave_tpu import solver as jsolver
from kwave_tpu import streams as jstreams
from kwave_tpu.basis import generate_basis as jbasis
from kwave_tpu_torch import convert, driver, graphs, solver, streams
from kwave_tpu_torch.basis import generate_basis
from kwave_tpu_torch.solver.step import SourcePhase as P
from kwave_tpu_torch.solver.step import chunk_keys, source_phase
from torch_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

N, O, N_SENSORS, WINDOWS = 16, 8, 48, 3
VARIANTS = {"40bit": (True, True), "40bit_noov": (True, False),
            "float": (False, True), "float_noov": (False, False)}


def _case(p_flag):
    grid = dict(nx=N, ny=N, nz=N, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=WINDOWS * O)
    rng = np.random.default_rng(11)
    shape = (N, N, N)
    medium = dict(c0=(1500.0 + 100.0 * rng.random(shape)).astype(np.float32),
                  rho0=(1000.0 + 50.0 * rng.random(shape)).astype(np.float32),
                  alpha_coeff=0.75, alpha_power=1.5)
    p0 = np.zeros(shape, np.float32)
    p0[8, 8, 8] = 1e5
    p0[6, 9, 7] = -4e4
    mask = np.sort(rng.choice(N ** 3, N_SENSORS, replace=False)).astype(np.int64)
    t = np.arange(WINDOWS * O, dtype=np.float32)
    srcs = dict(p0=p0, p_index=np.array([5 + N * (7 + N * 9)], np.int64),
                p_signal=(2e-2 * np.sin(2 * np.pi * t / 8.0)).astype(np.float32))
    cfg = dict(absorbing=True, p_source_flag=p_flag, p_source_mode=2)
    return grid, medium, mask, srcs, cfg


def _jax_windows(mode40, overlap, p_flag):
    grid, medium, mask, srcs, cfg = _case(p_flag)
    g = jsolver.Grid(**grid)
    ops = jsolver.make_operators(g, jsolver.Medium(**medium), (4, 4, 4), (2.0,) * 3,
                                 absorbing=True, need_source_kappa=True)
    src = jsolver.Sources(**{k: jnp.asarray(v) for k, v in srcs.items()})
    jcfg = jsolver.SolverConfig(**cfg)
    flags = {"p_raw": True, "p_c": True, "p_max_all": True}
    specs = jstreams.StreamSpec.from_flags(flags, True, mode40)
    if not overlap:
        specs = [dataclasses.replace(s, overlap=False) if s.op == "c" else s for s in specs]
    basis = jbasis(float(O), 1, 1, normalize=True)
    kw = dict(ops=ops, src=src, mask=jnp.asarray(mask))
    first = jdriver.make_window_fn(specs, basis, jcfg, O, N_SENSORS, peel_p0=True, **kw)
    rest = jdriver.make_window_fn(specs, basis, jcfg, O, N_SENSORS, **kw)
    state = jsolver.init_state(g)
    states = jstreams.init_stream_states(specs, N_SENSORS, N ** 3, basis)
    out = []
    for w in range(WINDOWS):
        state, states, em = (first if w == 0 else rest)(state, states, jnp.int32(w * O))
        out.append(em)
    return ops, src, out, state, states


def _port_windows(ops, src, mode40, overlap, p_flag, window_cls=None):
    grid, _, mask, _, cfg = _case(p_flag)
    pcfg = solver.SolverConfig(**cfg)
    specs = streams.StreamSpec.from_flags({"p_raw": True, "p_c": True, "p_max_all": True},
                                          True, mode40)
    if not overlap:
        specs = [dataclasses.replace(s, overlap=False) if s.op == "c" else s for s in specs]
    basis = generate_basis(float(O), 1, 1, normalize=True)
    tops, tsrc = convert.operators_from_jax(ops), convert.sources_from_jax(src)
    tmask = torch.as_tensor(mask)
    kw = dict(ops=tops, src=tsrc, mask=tmask)
    first = driver.make_window_fn(specs, basis, pcfg, O, N_SENSORS, peel_p0=True, **kw)
    rest = driver.make_window_fn(specs, basis, pcfg, O, N_SENSORS, **kw)
    if window_cls is not None:
        rest = window_cls(rest.r, O, O, True, False, tmask.device, graphs=True)
    state = solver.init_state(solver.Grid(**grid))
    states = streams.init_stream_states(specs, N_SENSORS, N ** 3, basis)
    out = []
    for w in range(WINDOWS):
        state, states, em = (first if w == 0 else rest)(state, states, w * O)
        out.append(em)
    return out, state, states, rest


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _frames(ems, mode40):
    """The p_c frames of every window, decoded by the oracle: (re, im) [Nc, N, 1]."""
    re, im = [], []
    for em in ems:
        f = em["p_c"]
        if mode40:
            words = np.asarray(f.numpy() if isinstance(f, torch.Tensor) else f)
            raw = words.view(np.uint8)[: 5 * N_SENSORS]
            h, r, i = oracle.bytes_to_soa(np.ascontiguousarray(raw))
            a, b = oracle.decode40(h, r, i, oracle.MAX_EXP_P)
        else:
            a, b = (np.asarray(x).reshape(-1) for x in f)
        re.append(np.asarray(a).reshape(N_SENSORS, 1))
        im.append(np.asarray(b).reshape(N_SENSORS, 1))
    return np.stack(re), np.stack(im)


@pytest.fixture(scope="module")
def jax_runs():
    return {}


@pytest.mark.parametrize("p_flag", [WINDOWS * O, 12], ids=["p_source_throughout",
                                                         "p_flag_inside_window_2"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_port_window_matches_the_jax_window(variant, p_flag, jax_runs):
    mode40, overlap = VARIANTS[variant]
    key = (variant, p_flag)
    if key not in jax_runs:
        jax_runs[key] = _jax_windows(mode40, overlap, p_flag)
    ops, src, jems, jstate, jstates = jax_runs[key]
    tems, tstate, tstates, _ = _port_windows(ops, src, mode40, overlap, p_flag)
    rows_j = np.concatenate([np.asarray(e["p"]) for e in jems])
    rows_t = np.concatenate([e["p"].numpy() for e in tems])
    assert rows_t.shape == (WINDOWS * O, N_SENSORS)
    assert _rel(rows_t, rows_j) <= 1e-4
    for name, value in convert.sim_state_to_numpy(tstate).items():
        assert _rel(value, np.asarray(getattr(jstate, name))) <= 1e-4, name
    assert _rel(tstates["p_max_all"].numpy(), jstates["p_max_all"]) <= 1e-4
    assert tstates["p_c"]["sampled_step"] == WINDOWS * O == \
        int(jstates["p_c"]["sampled_step"])
    assert tstates["p_c"]["compressed_step"] == WINDOWS
    basis = generate_basis(float(O), 1, 1, normalize=True)
    x = [oracle.reconstruct(*_frames(ems, mode40), basis, False, WINDOWS * O)
         for ems in (tems, jems)]
    peak = float(np.abs(rows_j).max())
    assert np.isfinite(x[0]).all()
    assert float(np.abs(x[0] - x[1]).max()) <= 1e-3 * peak


# ---------------------------------------------------------------------------
# (b) step with a tensor time index
# ---------------------------------------------------------------------------

SOURCE_CASES = {
    "u_dirichlet": dict(u_source_flag=5, u_source_mode=0),
    "u_additive_nocorrection_many": dict(u_source_flag=5, u_source_mode=1,
                                         u_source_many=True),
    "u_additive": dict(u_source_flag=5, u_source_mode=2),
    "transducer": dict(transducer_source_flag=6),
    "p_dirichlet_many": dict(p_source_flag=5, p_source_mode=0, p_source_many=True),
    "p_additive_nocorrection": dict(p_source_flag=5, p_source_mode=1),
    "p_additive": dict(p_source_flag=5, p_source_mode=2),
    "p0": dict(p0_source_flag=True),
}


def _step_setup(case):
    n = 12
    grid = solver.Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=8)
    rng = np.random.default_rng(3)
    medium = solver.Medium(c0=(1500.0 + 100.0 * rng.random(grid.shape)).astype(np.float32),
                           rho0=1000.0, alpha_coeff=0.75, alpha_power=1.5)
    ops = solver.make_operators(grid, medium, (3, 3, 3), (2.0,) * 3, absorbing=True,
                                need_source_kappa=True)
    cfg = solver.SolverConfig(absorbing=True, **SOURCE_CASES[case])
    idx = torch.as_tensor(np.sort(rng.choice(n ** 3, 4, replace=False)))
    sig_len = 3  # shorter than the steps: the read clamps to the last sample

    def sig(many):
        shape = (4, sig_len) if many else (sig_len,)
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * 1e-2)

    p0 = torch.zeros(grid.shape)
    p0[6, 6, 6] = 1e5
    src = solver.Sources(
        p0=p0, p_index=idx, p_signal=sig(cfg.p_source_many), u_index=idx,
        ux_signal=sig(cfg.u_source_many), uy_signal=sig(cfg.u_source_many),
        uz_signal=sig(cfg.u_source_many), transducer_index=idx,
        transducer_signal=torch.as_tensor(rng.standard_normal(7).astype(np.float32)),
        delay_mask=torch.as_tensor([0, 1, 3, 2]))
    state = solver.SimState(*(torch.as_tensor(rng.standard_normal(grid.shape)
                                              .astype(np.float32)) for _ in range(7)))
    return grid, ops, cfg, src, state


@pytest.mark.parametrize("case", list(SOURCE_CASES))
def test_step_with_a_tensor_time_index_gives_the_same_bits(case):
    _, ops, cfg, src, state = _step_setup(case)
    a = b = state
    for t in range(8):
        a = solver.step(a, t, ops, src, cfg)
        b = solver.step(b, torch.tensor(t), ops, src, cfg, phase=source_phase(cfg, t, t))
        for name in ("p", "ux_sgx", "uy_sgy", "uz_sgz", "rho_x", "rho_y", "rho_z"):
            assert torch.equal(getattr(a, name), getattr(b, name)), (case, t, name)
    off = solver.step(state, 0, ops, src, solver.SolverConfig(absorbing=True))
    assert not torch.equal(solver.step(state, 0, ops, src, cfg).p, off.p)  # it acted


def test_a_tensor_time_index_needs_the_phase():
    _, ops, cfg, src, state = _step_setup("p_additive")
    with pytest.raises(ValueError, match="source phase"):
        solver.step(state, torch.tensor(2), ops, src, cfg)


# ---------------------------------------------------------------------------
# (c) the key rule, and the capture / replay plumbing on the CPU
# ---------------------------------------------------------------------------


def test_source_phase_names_the_sources_of_a_run_of_steps():
    cfg = solver.SolverConfig(u_source_flag=10, transducer_source_flag=4, p_source_flag=20,
                              p0_source_flag=True)
    assert source_phase(cfg, 0, 0) == P(True, True, True, True)
    assert source_phase(cfg, 0, 3) is None  # p0 acts at t == 0 alone
    assert source_phase(cfg, 1, 3) == P(True, True, True, False)
    assert source_phase(cfg, 2, 5) is None  # the transducer stops at 4
    assert source_phase(cfg, 4, 9) == P(True, False, True, False)
    assert source_phase(cfg, 10, 19) == P(False, False, True, False)
    assert source_phase(cfg, 16, 23) is None
    assert source_phase(cfg, 20, 1000) == P(False, False, False, False)
    assert source_phase(solver.SolverConfig(), 0, 7) == P(False, False, False, False)


def test_plan_windows_replays_after_one_capture_of_each_parity():
    cfg = solver.SolverConfig()
    plan = driver.plan_windows(cfg, 8, 0, 6)
    assert [t for t, _, _ in plan] == [0, 8, 16, 24, 32, 40]
    assert [a for _, _, a in plan] == ["eager", "capture", "capture", "replay", "replay",
                                       "replay"]
    assert plan[0][1] is None  # the first window peels p0 and mirrors the first frame
    assert [k[1] for _, k, _ in plan[1:]] == [1, 0, 1, 0, 1]
    # two windows: nothing is taken again, so nothing is captured
    assert [a for _, _, a in driver.plan_windows(cfg, 8, 0, 2)] == ["eager", "eager"]
    assert [a for _, _, a in driver.plan_windows(cfg, 8, 0, 3)] == ["eager"] * 3
    assert [a for _, _, a in driver.plan_windows(cfg, 8, 0, 4)] == \
        ["eager", "capture", "eager", "replay"]


def test_plan_windows_runs_a_window_where_a_source_stops_eagerly():
    cfg = solver.SolverConfig(p_source_flag=20)
    plan = driver.plan_windows(cfg, 8, 0, 7)
    # 8: the source acts (the only such window of parity 1); 16: it stops at 20
    assert [a for _, _, a in plan] == ["eager", "eager", "eager", "capture", "capture",
                                       "replay", "replay"]
    assert plan[2][1] is None
    assert plan[3][1] == plan[5][1] and plan[4][1] == plan[6][1] != plan[3][1]


def test_plan_windows_after_a_resumed_leg_and_a_sampling_start():
    # a leg resumed at sampled step 13 steps to 16 eagerly (stepwise), then windows from
    # 16: no first-window rule, the parity from the sampled steps
    plan = driver.plan_windows(solver.SolverConfig(), 8, 16, 4)
    assert [a for _, _, a in plan] == ["capture", "capture", "replay", "replay"]
    assert [k[1] for _, k, _ in plan] == [0, 1, 0, 1]
    plan = driver.plan_windows(solver.SolverConfig(sampling_start_index=5), 8, 5, 4)
    assert [a for _, _, a in plan] == ["eager", "capture", "eager", "replay"]
    assert [k[1] for _, k, _ in plan[1:]] == [1, 0, 1]
    with pytest.raises(ValueError, match="multiple of o"):
        driver.window_key(solver.SolverConfig(), 8, 12)


def test_chunk_keys_and_graph_actions_of_the_lead_in():
    cfg = solver.SolverConfig(p_source_flag=10)
    runs = chunk_keys(cfg, 1, 30, 8)
    assert [(t, n) for t, n, _ in runs] == [(1, 8), (9, 8), (17, 8), (25, 6)]
    assert runs[0][2].p and runs[1][2] is None and not runs[2][2].p and runs[3][2] is None
    assert graphs.graph_actions([k for *_, k in runs]) == ["eager"] * 4
    assert graphs.graph_actions(["a", "b", "a", None, "b", "c"]) == \
        ["capture", "capture", "replay", "eager", "replay", "eager"]


def test_graphs_need_a_cuda_device_and_the_cpu_window_runs_eagerly():
    with pytest.raises(ValueError, match="CUDA"):
        graphs.Graphs("cpu")
    grid, _, mask, srcs, cfg = _case(WINDOWS * O)
    window = driver.make_window_fn([streams.StreamSpec("p", "p", "raw")], None,
                                   solver.SolverConfig(), O, N_SENSORS, ops=None, src=None,
                                   mask=torch.as_tensor(mask))
    assert window.graphs is None


class EagerGraphs:
    """`graphs.Graphs` on the CPU: capture runs the Python body once, as a recording pass
    does (on static buffers of NaN, its results dropped), and keeps it; replay runs it
    eagerly on the static buffers with a tensor time index and copies the new state in."""

    def __init__(self, device):
        self.static, self._bodies, self.capture_seconds = None, {}, {}

    def __contains__(self, key):
        return key in self._bodies

    def capture(self, key, state, body):
        if self.static is None:
            self.static = [torch.full_like(x, float("nan")) if x.is_floating_point()
                           else torch.full_like(x, -7) for x in state]
        body(self.static, torch.tensor(0))  # the recording pass runs the Python once
        self._bodies[key] = body
        self.capture_seconds[key] = 0.0

    def replay(self, key, state, t):
        for s, x in zip(self.static, state):
            if x is not s:
                s.copy_(x)
        new, extra = self._bodies[key](self.static, torch.tensor(int(t)))
        for s, x in zip(self.static, new):
            if x is not s:
                s.copy_(x)
        return self.static, extra


def _equal(a, b) -> bool:
    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("variant", ["40bit", "float_noov"])
def test_the_replay_plumbing_gives_the_eager_windows_bits(variant, monkeypatch):
    """Windows 8 and 16 run eagerly and are captured; a fourth window at 24 replays the
    key of 8 through the stand-in: the state, the counters and the emissions of an eager
    window from the same state, bit for bit."""
    mode40, overlap = VARIANTS[variant]
    grid, medium, _, srcs, _ = _case(4)
    ops = jsolver.make_operators(jsolver.Grid(**grid), jsolver.Medium(**medium),
                                 (4, 4, 4), (2.0,) * 3, absorbing=True,
                                 need_source_kappa=True)
    src = jsolver.Sources(**{k: jnp.asarray(v) for k, v in srcs.items()})
    eager = _port_windows(ops, src, mode40, overlap, 4)
    monkeypatch.setattr(driver, "Graphs", EagerGraphs)
    ems, state, states, window = _port_windows(ops, src, mode40, overlap, 4, driver._Window)
    assert window.actions == [(8, "capture"), (16, "capture")]
    assert all(_equal(a[k], b[k]) for a, b in zip(eager[0], ems) for k in a)
    t = WINDOWS * O
    state2, states2, em2 = window(state, states, t)
    assert window.actions[-1] == (t, "replay")
    ref = driver._Window(window.r, O, O, True, False, torch.device("cpu"), graphs=False)
    state3, states3, em3 = ref(state, states, t)
    for name in ("p", "ux_sgx", "uy_sgy", "uz_sgz", "rho_x", "rho_y", "rho_z"):
        assert torch.equal(getattr(state2, name), getattr(state3, name)), name
    assert states2["p_c"]["sampled_step"] == states3["p_c"]["sampled_step"] == t + O
    assert states2["p_c"]["compressed_step"] == states3["p_c"]["compressed_step"] == 4
    assert all(_equal(states2["p_c"][k], v) for k, v in states3["p_c"].items()
               if isinstance(v, torch.Tensor))
    assert torch.equal(states2["p_max_all"], states3["p_max_all"])
    assert all(_equal(em2[k], v) for k, v in em3.items())
    with pytest.raises(ValueError, match="has sampled"):  # counters of t + o at t + 2o
        window(state2, states2, t + 2 * O)
