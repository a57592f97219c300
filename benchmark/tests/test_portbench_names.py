"""BENCHMARK.json keeps to the benchmark's contract: its keys, names, units and the
files every cell, configuration, traffic mix and metric needs, found by name."""

import json
import re

import pytest

from benchmark.tests.portbench_helpers import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_plain_and_unique(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert LINE.match(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_pairs_are_unique_and_four_card_cells_few():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_every_cell_reports_setup_an_end_to_end_metric_and_a_layer():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for w in BENCH["workloads"]:
        mine = {m["name"] for m in BENCH["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in mine and len(mine) >= 2
        layers = [m for m in BENCH["per_layer"]
                  if w["name"] in m.get("workloads", [w["name"]])]
        assert layers and all(m["moves"] in mine for m in layers)


def test_every_config_is_used_and_its_file_lies_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files_by_name(w):
    assert (ROOT / "benchmark" / "configs" / f"{w['config']}.json").is_file()
    assert (ROOT / "benchmark" / "reference" / f"{w['config']}.py").is_file()
    assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in BENCH["per_layer"]:
        if w["name"] in m.get("workloads", [w["name"]]):
            assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_the_job_length_is_k_waves_make_time_default(c):
    """Nt as kWaveGrid.makeTime sets it at CFL 0.3: the grid's diagonal crossed at the
    slowest sound speed, in steps of dt = cfl dx / c_max; floor + 1."""
    import math

    cfg = json.loads((ROOT / c["file"]).read_text())
    if "Nt" in c["reduced"]:
        return
    diagonal = math.sqrt(sum((n * cfg["dx"]) ** 2 for n in cfg["grid"]))
    t_end = diagonal / min(cfg["c0_range"])
    dt = cfg["cfl"] * cfg["dx"] / max(cfg["c0_range"])
    assert cfg["c_dt"] == max(cfg["c0_range"])
    assert cfg["Nt"] == math.floor(t_end / dt) + 1
