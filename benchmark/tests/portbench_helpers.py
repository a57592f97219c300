"""Shared pieces of the benchmark's CPU tests: a cell cut to a size the CPU runs in a
second, and a run of it through the harness on the CPU (the harness's look for a card is
`benchmark/run.py`'s, which these runs skip)."""

from __future__ import annotations

import contextlib
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

os.environ.setdefault("KWAVE_TPU_TORCH_DEVICE", "cpu")  # cli.main's device, on files

from benchmark import harness  # noqa: E402

# several test workers share the machine's cores: one thread each, or their thread pools
# starve one another (a one-second run took minutes)
torch.set_num_threads(1)

SEED = 2**31 + 977  # larger than 32 signed bits hold, as the driver's seeds are


def tiny(cell: harness.Cell, windows: int = 4) -> harness.Cell:
    """``cell`` on a 16^3 grid with 200 sensors and jobs of ``windows`` windows and a tail
    of 5 steps: every other setting as the cell has it."""
    c = cell.config
    c["grid"] = [16, 16, 16]
    c["pml_size"] = 4
    c["sensors"] = 200
    c["oracle_sensors"] = 50
    c["Nt"] = windows * int(c["period"]) + 5
    return cell


def cells() -> list:
    import json

    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def run_tiny(name: str, trace: bool = False, seconds: float = 0.2, **kw) -> dict:
    cell = tiny(harness.load_cell(name), **kw)
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        return harness.run_cell(cell, SEED, seconds, trace, [torch.device("cpu")],
                                time.time(), log=open(os.devnull, "w"))
