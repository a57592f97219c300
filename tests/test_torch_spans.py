"""The program's spans (`utils.observability.span`): under `torch.profiler` every layer
of a job names its host work (``kwave.*`` ``user_annotation`` events, on the clock of
the profiler's device events), nested as the layers are; without a profiler no span is
entered.

A 16^3 index-sensor ``--p_raw --p_c --40-bit_complex`` job of 6 windows and a 3-step
tail runs on the CPU, once through `driver.run_simulation` into memory and once through
`cli.main` on files. The single device is declared a card (`torch_helpers.EagerCards` in
place of `graphs.Graphs`), so that the windows capture and replay as on the H100: the
card's own case is in `tests/test_torch_cuda.py`."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kwave_tpu_torch import cli, driver, params, solver
from kwave_tpu_torch.io.input_file import InputData, write_input_file
from kwave_tpu_torch.solver import Grid, Medium
from kwave_tpu_torch.utils import observability
from torch_helpers import EagerCards, one_torch_thread  # noqa: F401 (an autouse fixture)

O = 8  # --period 8: o = 8
WINDOWS = 6
FLAGS = ["--period", str(O), "--p_raw", "--p_c", "--40-bit_complex"]

# each span of a job -> the innermost kwave.* span that holds it (None: none)
PARENTS = {
    "kwave.total": {None},
    "kwave.preprocessing": {"kwave.total"},
    "kwave.simulation": {"kwave.total"},
    "kwave.postprocessing": {"kwave.total"},
    "kwave.operators": {"kwave.preprocessing"},
    "kwave.operators.build": {"kwave.operators"},
    "kwave.operators.to_device": {"kwave.operators"},
    "kwave.sources": {"kwave.preprocessing"},
    "kwave.output_create": {"kwave.preprocessing"},
    "kwave.window.eager": {"kwave.simulation"},
    "kwave.window.capture": {"kwave.simulation"},
    "kwave.window.replay": {"kwave.simulation"},
    "kwave.graph.capture": {"kwave.window.capture"},
    "kwave.graph.launch": {"kwave.window.replay"},
    "kwave.flush.to_host": {"kwave.simulation", "kwave.tail"},
    "kwave.flush.write": {"kwave.simulation", "kwave.tail"},
    "kwave.tail": {"kwave.simulation"},
}
# and those of a job on files alone: the CLI's read, and the writer's bytes (the last
# at `File.close`, after the run's phases)
FILE_PARENTS = {
    "kwave.data_load": {None},
    "kwave.input.read": {"kwave.data_load"},
    "kwave.h5.write": {"kwave.output_create", "kwave.flush.write", None},
}


def _input() -> InputData:
    shape = (16, 16, 16)
    grid = Grid(nx=16, ny=16, nz=16, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8,
                nt=WINDOWS * O + 3)
    rng = np.random.default_rng(7)
    medium = Medium(c0=(1500.0 + 100.0 * rng.random(shape)).astype(np.float32),
                    rho0=(1000.0 + 50.0 * rng.random(shape)).astype(np.float32),
                    alpha_coeff=0.75, alpha_power=1.5)
    p0 = np.zeros(shape, np.float32)
    p0[8, 8, 8] = 1e5
    mask = np.sort(rng.choice(grid.n_elements, 64, replace=False)).astype(np.int64)
    return InputData(grid=grid, medium=medium, pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3,
                     absorbing=True, sensor_mask_index=mask, p0=p0)


@pytest.fixture
def cards(monkeypatch):
    """The CPU declared a card: the run's windows capture and replay (`EagerCards`)."""
    monkeypatch.setattr(driver, "state_graph_devices", lambda state: state.p.device)
    monkeypatch.setattr(driver, "Graphs", EagerCards)
    monkeypatch.setenv(cli.DEVICE_ENV, "cpu")


class _Attrs(dict):
    def create(self, name, value):
        self[name] = value


class _Dataset:
    """A dataset in host memory, with what the run's writers use of one."""

    def __init__(self, shape, dtype, data=None):
        self.data = np.array(data) if data is not None else np.zeros(shape, dtype)
        self.shape, self.dtype, self.attrs = self.data.shape, self.data.dtype, _Attrs()

    def __getitem__(self, key):
        return self.data[key]

    def __setitem__(self, key, value):
        self.data[key] = value


class _Group(dict):
    """An output group in host memory, with what the run's writers use of one."""

    def __init__(self):
        super().__init__()
        self.attrs = _Attrs()

    def create_dataset(self, name, shape=None, dtype=None, data=None, **_):
        self[name] = _Dataset(shape, dtype, data)
        return self[name]


def _memory_job():
    args = params.build_parser().parse_args(["-i", "-", "-o", "-", *FLAGS])
    log = []
    data = _input()
    driver.run_simulation(data, params.args_to_run_config(args, dt=data.grid.dt),
                          _Group(), device="cpu", window_log=log)
    return [a for w in log for a in w.actions]


def _file_job(tmp_path):
    path = str(tmp_path / "in.h5")
    write_input_file(path, _input())
    assert cli.main(["-i", path, "-o", str(tmp_path / "out.h5"), *FLAGS]) == 0


def _spans(job) -> tuple:
    """``job()`` under the profiler: (its result, each kwave.* span's count, and the set
    of its innermost kwave.* parents)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = job()
    counts, parents = collections.Counter(), collections.defaultdict(set)
    for e in prof.events():
        if not e.name.startswith("kwave."):
            continue
        counts[e.name] += 1
        p = e.cpu_parent
        while p is not None and not p.name.startswith("kwave."):
            p = p.cpu_parent
        parents[e.name].add(None if p is None else p.name)
    return result, counts, parents


def _plan() -> collections.Counter:
    return collections.Counter(a for *_, a in driver.plan_windows(solver.SolverConfig(), O,
                                                                   0, WINDOWS))


def _hold_windows_to_the_plan(counts):
    plan = _plan()
    assert plan == {"eager": 1, "capture": 2, "replay": 3}
    for action in ("eager", "capture", "replay"):
        assert counts[f"kwave.window.{action}"] == plan[action], action
    assert counts["kwave.graph.capture"] == plan["capture"]
    assert counts["kwave.graph.launch"] == plan["replay"]
    # the first window's emissions are flushed after the second, the last window's
    # after the loop; the tail's rows after it
    assert counts["kwave.flush.to_host"] == counts["kwave.flush.write"] == WINDOWS + 1


def test_a_job_in_memory_names_every_layer(cards):
    actions, counts, parents = _spans(_memory_job)
    assert [a for _, a in actions] == ["eager", "capture", "capture"] + ["replay"] * 3
    assert set(counts) == set(PARENTS)  # no file edge: no kwave.h5.write, no data load
    for name, want in PARENTS.items():
        assert parents[name] <= want, (name, parents[name])
    for phase in ("total", "preprocessing", "simulation", "postprocessing"):
        assert counts[f"kwave.{phase}"] == 1
    assert counts["kwave.output_create"] == 1  # the writer's datasets
    _hold_windows_to_the_plan(counts)


def test_a_job_on_files_names_the_read_and_the_writer(cards, tmp_path):
    _, counts, parents = _spans(lambda: _file_job(tmp_path))
    assert set(counts) == set(PARENTS) | set(FILE_PARENTS)
    for name, want in {**PARENTS, **FILE_PARENTS}.items():
        assert parents[name] <= want, (name, parents[name])
    assert "kwave.flush.write" in parents["kwave.h5.write"]
    assert counts["kwave.output_create"] == 2  # the file, then the writer's datasets
    assert counts["kwave.data_load"] == counts["kwave.input.read"] == 1
    _hold_windows_to_the_plan(counts)


@pytest.mark.parametrize("entry", ["memory", "files"])
def test_no_span_is_entered_without_a_profiler(cards, tmp_path, monkeypatch, entry):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    job = _memory_job if entry == "memory" else lambda: _file_job(tmp_path)
    assert not torch.autograd._profiler_enabled()
    job()
    assert entered == []
    assert observability.span("kwave.x") is observability.span("kwave.y")
    _spans(job)  # the same helper under a profiler enters every span
    assert "kwave.window.replay" in entered and "kwave.total" in entered
    assert ("kwave.h5.write" in entered) == (entry == "files")


def test_phase_timers_time_on_perf_counter_and_span_each_phase(monkeypatch):
    ticks = iter([10.0, 10.25, 20.0, 20.5])
    monkeypatch.setattr(observability.time, "perf_counter", lambda: next(ticks))
    timers = observability.PhaseTimers()
    timers.start("simulation")
    assert timers.stop("simulation") == 0.25
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        timers.start("data_load")
        timers.stop("data_load")
    assert [e.name for e in prof.events() if e.name.startswith("kwave.")] == \
        ["kwave.data_load"]
    assert timers.elapsed("simulation") == 0.25 and timers.elapsed("data_load") == 0.5
    timers.add_iterations(0.5, 16, sampled=True)
    timers.add_iterations(0.25, 3, sampled=False)
    timers.add_iterations(0.5, 16, sampled=True)
    assert (timers.sampling_time, timers.sampling_iters) == (1.0, 32)
    assert (timers.non_sampling_time, timers.non_sampling_iters) == (0.25, 3)
