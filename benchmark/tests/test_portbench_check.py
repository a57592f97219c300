"""The check that decides ``correct``, at a size the CPU runs: the program's CPU path
agrees with the plain reference; the reference in bfloat16 put in its place (the
control) fails; and a run whose timed path is broken underneath fails, once for each
fault a cell can have."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.portbench_helpers import SEED, cells, run_tiny, tiny


@pytest.mark.parametrize("name", cells())
def test_the_program_agrees_with_the_reference(name):
    res = run_tiny(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    for k, c in res["checks"].items():
        assert c["value"] <= c["limit"], (k, c)


@pytest.mark.parametrize("name", cells())
def test_the_control_fails(name):
    """bfloat16 in the program's place breaks at least one limit of the cell."""
    cell = tiny(harness.load_cell(name))
    got = control.control_numbers(cell, SEED, torch.device("cpu"))
    lim = harness.limits(cell)
    assert any(got[k] > lim[k] for k in got), got


def test_step_ms_is_one_ratio_over_the_whole_window(monkeypatch):
    """Jobs of uneven length: step_ms is the window's wall time over all its steps (the
    jobs' seconds summed, back to back), not a median of jobs."""
    import io
    import json
    import statistics
    import time

    lengths = iter([0.02, 0.2, 0.03, 0.01] + [0.01] * 50)
    real = harness.Program.job

    def job(self, k, warm=False):
        done = real(self, k, warm)
        if not warm:
            time.sleep(next(lengths))
        return done

    monkeypatch.setattr(harness.Program, "job", job)
    cell = tiny(harness.load_cell("het128-p40-long"))
    log = io.StringIO()
    res = harness.run_cell(cell, SEED, 1.0, False, [torch.device("cpu")], time.time(),
                           log=log)
    line = next(x for x in log.getvalue().splitlines() if x.startswith("jobs: "))
    jobs = json.loads(line[len("jobs: "):])
    steps = cell.steps * res["attempted"]
    got = res["metrics"]["step_ms"]["value"]
    assert len(jobs) == res["attempted"] >= 3
    # each job's own clock leaves out the sleep: the window's wall time holds it
    assert got * steps / 1e3 >= sum(jobs) + 0.25
    assert got != pytest.approx(statistics.median(jobs) / cell.steps * 1e3, rel=0.2)


# --- faults planted under the timed path -----------------------------------------------


def _state_unchanged(monkeypatch):
    from kwave_tpu_torch import driver

    monkeypatch.setattr(driver, "step", lambda state, *a, **k: state)


def _half_the_sensors(monkeypatch):
    """The gather leaves the second half of the sensors out (zeros)."""
    from kwave_tpu_torch import driver

    real = driver._gather_sources

    def gather(*a, **k):
        out = real(*a, **k)
        for v in out.values():
            v[v.shape[0] // 2:] = 0
        return out

    monkeypatch.setattr(driver, "_gather_sources", gather)


def _one_answer_altered(monkeypatch):
    """One sample of the pressure, where the gather produces it, off by a tenth of the
    field's peak."""
    from kwave_tpu_torch import driver

    real = driver._gather_sources
    def gather(*a, **k):
        out = real(*a, **k)
        if "p" in out:
            out["p"][3] += 0.1 * float(out["p"].abs().max())
        return out

    monkeypatch.setattr(driver, "_gather_sources", gather)


def _one_word_altered(monkeypatch):
    """Every coefficient's header byte flipped where the writer receives the frame."""
    from kwave_tpu_torch import streams

    real = streams.StreamWriter.flush_emissions

    def flush(self, emissions):
        for name, em in emissions.items():
            if name.endswith("_c") and em is not None and not isinstance(em, tuple):
                em = torch.as_tensor(em).clone()
                em.view(torch.uint8).reshape(-1)[::5] ^= 0x40
                emissions = dict(emissions, **{name: em})
        return real(self, emissions)

    monkeypatch.setattr(streams.StreamWriter, "flush_emissions", flush)


FAULTS = {"state_unchanged": _state_unchanged, "half_the_sensors": _half_the_sensors,
          "one_answer_altered": _one_answer_altered, "one_word_altered": _one_word_altered}


def _cell_faults():
    """(cell, fault) for each fault the cell can have: an altered answer is a raw
    sample where the cell writes raw series, else a compressed word."""
    out = []
    for name in cells():
        config = harness.load_cell(name).config
        raw = any(c["kind"] == "series" for c in config["checks"])
        for fault in FAULTS:
            if fault == "one_answer_altered" and not raw:
                continue
            out.append((name, fault))
    return out


@pytest.mark.parametrize("name,fault", _cell_faults())
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run_tiny(name)
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1


@pytest.mark.parametrize("name", cells())
def test_the_warm_job_captures_and_replays_every_key_of_the_window(name):
    """Set-up's short job plans, on the card, a capture and a replay of each window graph
    key that the window's jobs replay."""
    from types import SimpleNamespace

    from kwave_tpu_torch import driver

    cell = harness.load_cell(name)
    o = int(cell.config["period"])
    cfg = SimpleNamespace(sampling_start_index=0, p0_source_flag=1, u_source_flag=0,
                          transducer_source_flag=0, p_source_flag=0)

    def plan(steps):
        return driver.plan_windows(cfg, o, 0, steps // o)

    window = {key for _, key, action in plan(cell.steps) if action == "replay"}
    warm = plan(cell.warm_steps)
    assert window
    for action in ("capture", "replay"):
        assert {key for _, key, a in warm if a == action} == window
    assert cell.warm_steps % o == cell.steps % o  # the same tail
    assert cell.warm_steps < cell.steps / 5
