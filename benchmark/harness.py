"""One run of one cell: set-up, the timed window of whole jobs, the traced job, the
check against the reference, and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The configuration
(``configs/<name>.json``, with ``reference/<name>.py`` beside it) says what a job
simulates: grid, medium, source, sensors, its length ``Nt``, the program's flags, and the
checks that decide ``correct`` with their limits. The traffic mix
(``traffic/<name>.json``) says how a job enters the program:

- ``entry: "memory"``: `kwave_tpu_torch.driver.run_simulation` on the `InputData` made
  in set-up, into a fresh in-memory group, as ``cli.main`` calls it after reading a file;
- ``entry: "files"``: ``kwave_tpu_torch.cli.main(["-i", in.h5, "-o", out.h5, ...])``,
  on an input file that set-up writes with the program's own writer;
- ``keep``: how many of the window's jobs, drawn from the seed, are checked;
- ``flags``: more command-line flags of the entry.

Set-up draws the inputs from the seed and runs one short job of the same grid, flags and
entry (`WARM_WINDOWS` windows and the same tail), so that every kernel, plan and graph
code path of the window is warm. The window runs jobs back to back, each a fresh call of
the entry, until ``seconds`` have passed; the job that is running then runs to its end.
Nothing passes from one job to the next but what the program keeps by itself: each job
captures its own window graphs, as every run of the program does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import random
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kwave_tpu")  # top-level module names, compared whole
# the set-up's job: the window keys alternate in parity (`driver.window_key`), so five
# windows (eager, two captures, two replays) are the fewest that capture and replay both
WARM_WINDOWS = 5


class CellError(Exception):
    """The cell cannot be run as described (a missing file, a bad entry)."""


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # BENCHMARK.json metrics this cell reports with --trace 0
    per_layer: list  # and with --trace 1

    @property
    def steps(self) -> int:
        return int(self.config["Nt"])

    @property
    def warm_steps(self) -> int:
        period = int(self.config["period"])
        return min(self.steps, WARM_WINDOWS * period + self.steps % period)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration and traffic."""
    try:
        bench = json.loads((root / "BENCHMARK.json").read_text())
    except OSError as e:
        raise CellError(f"no BENCHMARK.json at {root}: {e}") from None
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    config = json.loads((HERE / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name) and m["moves"] in moved]
    return Cell(name, config, traffic, int(w["chips"]), e2e, per_layer)


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is one the benchmark may not
    load (the JAX package, JAX and its kin)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------------------
# The program's side
# ---------------------------------------------------------------------------------------


@dataclasses.dataclass
class Job:
    seconds: float
    out: Any = None  # the output: an in-memory group, or a file's path
    log: list = dataclasses.field(default_factory=list)  # run_simulation's window objects
    attrs: dict = dataclasses.field(default_factory=dict)
    h5_write_s: float = 0.0
    capture_s: float = 0.0
    error: Optional[str] = None


def _input_data(inputs: dict, nt: int):
    """The program's `InputData` of the inputs made from the seed (host arrays), ``nt``
    steps long."""
    from kwave_tpu_torch.io.input_file import InputData
    from kwave_tpu_torch.solver import Grid, Medium

    nz, ny, nx = inputs["shape"]
    dx = inputs["dx"]
    grid = Grid(nx=nx, ny=ny, nz=nz, dx=dx, dy=dx, dz=dx, dt=inputs["dt"], nt=nt)

    def host(t):
        return t.detach().cpu().numpy()

    medium = Medium(c0=host(inputs["c0"]), rho0=host(inputs["rho0"]),
                    alpha_coeff=inputs["alpha_coeff"], alpha_power=inputs["alpha_power"])
    return InputData(grid=grid, medium=medium, pml_size=tuple(inputs["pml_size"]),
                     pml_alpha=tuple(inputs["pml_alpha"]), absorbing=True,
                     sensor_mask_index=host(inputs["sensors"]), p0=host(inputs["p0"]))


class Program:
    """The program under test, driven through one cell's entry."""

    def __init__(self, cell: Cell, inputs: dict, devices: list, tmpdir: Path):
        import torch

        from kwave_tpu_torch import params

        self.cell, self.devices, self.tmpdir = cell, devices, tmpdir
        self.entry = cell.traffic["entry"]
        if self.entry not in ("memory", "files"):
            raise CellError(f"traffic entry {self.entry!r}: memory or files")
        self.flags = list(cell.config["flags"]) + list(cell.traffic.get("flags", []))
        # the window's jobs and set-up's shorter one: an InputData, or an input file
        # written by the program's own writer
        self.data = {n: _input_data(inputs, n) for n in (cell.steps, cell.warm_steps)}
        args = params.build_parser().parse_args(["-i", "-", "-o", "-", *self.flags])
        self.run_config = params.args_to_run_config(args, dt=self.data[cell.steps].grid.dt)
        self.input_path = {}
        if self.entry == "files":
            from kwave_tpu_torch.io.input_file import write_input_file

            for n, data in self.data.items():
                self.input_path[n] = str(tmpdir / f"input_{n}.h5")
                write_input_file(self.input_path[n], data)
        self.torch = torch

    def sync(self) -> None:
        for d in self.devices:
            if d.type == "cuda":
                self.torch.cuda.synchronize(d)

    def job(self, k: int, warm: bool = False) -> Job:
        """One whole job (``warm``: set-up's short one, which writes to a name of its
        own); returns when its output is complete and every card is idle."""
        nt = self.cell.warm_steps if warm else self.cell.steps
        t0 = time.perf_counter()
        if self.entry == "memory":
            from kwave_tpu_torch.driver import run_simulation

            from benchmark.memgroup import MemGroup

            out, log = MemGroup(), []
            run_simulation(self.data[nt], dataclasses.replace(self.run_config), out,
                           device=self.devices[0], window_log=log)
        else:
            from kwave_tpu_torch import cli

            out, log = str(self.tmpdir / f"out_{'warm' if warm else k}.h5"), []
            argv = ["-i", self.input_path[nt], "-o", out, *self.flags]
            if cli.main(argv) != 0:
                raise RuntimeError(f"cli.main returned non-zero for {argv}")
        self.sync()
        return Job(time.perf_counter() - t0, out, log)


def _job_attrs(job: Job) -> dict:
    """The phase times the program wrote onto the job's output."""
    names = ("data_loading_phase_execution_time", "pre-processing_phase_execution_time",
             "simulation_phase_execution_time", "post-processing_phase_execution_time")
    if isinstance(job.out, str):
        from benchmark.reference import h5read

        with h5read.File(job.out, "r") as f:
            attrs = {k: f.attrs[k] for k in names if k in f.attrs}
    else:
        attrs = {k: job.out.attrs[k] for k in names if k in job.out.attrs}
    return {k: float(np.asarray(v).reshape(-1)[0]) for k, v in attrs.items()}


def _capture_seconds(log: list) -> float:
    return float(sum(sum(w.graphs.capture_seconds.values()) for w in log
                     if getattr(w, "graphs", None) is not None))


# ---------------------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------------------


@dataclasses.dataclass
class Context:
    """What a per-layer metric reads (`benchmark.metrics`)."""

    cell: Cell
    jobs: list  # the window's jobs (`Job`), attrs and times filled
    trace: Any = None  # `benchmark.trace.Trace` of the traced job
    traced_steps: int = 0
    cards: list = dataclasses.field(default_factory=list)


def _peak_bytes(devices: list) -> int:
    import torch

    return max((int(torch.cuda.max_memory_allocated(d)) for d in devices
                if d.type == "cuda"), default=0)


def _reset_peaks(devices: list) -> None:
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)


def _load_reference(cell: Cell):
    return importlib.import_module(f"benchmark.reference.{cell.config['name']}")


def make_inputs(cell: Cell, seed: int, device) -> dict:
    return _load_reference(cell).make_inputs(cell.config, seed, device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, devices: list,
             t_start: float, log=sys.stderr) -> dict:
    """One run of ``cell``; returns the result line's object (``checks`` last)."""
    import torch

    from benchmark.codec_clock import CodecClock

    tmpdir = Path(tempfile.mkdtemp(prefix="kwave_bench_"))
    try:
        if devices[0].type == "cuda":
            from kwave_tpu_torch.ops import _build

            _build.load_library()  # the first run of a checkout compiles here
        inputs = make_inputs(cell, seed, devices[0])
        program = Program(cell, inputs, devices, tmpdir)
        # the reference reads them after the window, from the host: held on the card,
        # they would count in the program's peak
        inputs = {k: v.cpu() if hasattr(v, "cpu") else v for k, v in inputs.items()}
        warm = program.job(0, warm=True)  # every kernel and code path of the window
        if isinstance(warm.out, str):
            Path(warm.out).unlink()
        del warm
        gc.collect()
        gc.freeze()  # set-up's objects: no collection in the window walks them again

        # the window: whole jobs until `seconds` have passed
        keep = int(cell.traffic.get("keep", 3))
        rng = random.Random(int(seed))
        kept: list = []  # (job index, Job), a reservoir drawn from the seed
        jobs: list = []
        dropped: list = []  # the files of the jobs that are not checked
        _reset_peaks(devices)
        clock = CodecClock() if trace else None
        setup_s = time.time() - t_start
        t0 = time.perf_counter()
        with clock if clock is not None else contextlib.nullcontext():
            while True:
                before = clock.total() if clock is not None else 0.0
                try:
                    job = program.job(len(jobs))
                except Exception:  # a job that raises fails the run; the window ends
                    job = Job(0.0, error=traceback.format_exc())
                    print(job.error, file=log)
                if clock is not None:
                    job.h5_write_s = clock.total() - before
                job.capture_s = _capture_seconds(job.log)
                job.log = []  # the window objects hold the job's device state
                if trace and job.error is None:
                    job.attrs = _job_attrs(job)
                jobs.append(job)
                k, out = len(jobs) - 1, None
                if job.error is None:
                    if len(kept) < keep:
                        kept.append((k, job))
                    else:
                        j = rng.randrange(k + 1)
                        out = job
                        if j < keep:
                            out, kept[j] = kept[j][1], (k, job)
                if out is not None:
                    if isinstance(out.out, str):
                        dropped.append(out.out)
                    out.out = None
                if job.error is not None or time.perf_counter() - t0 >= seconds:
                    break
        window_s = time.perf_counter() - t0
        peak = _peak_bytes(devices)
        for path in dropped:
            Path(path).unlink(missing_ok=True)
        print("jobs: " + json.dumps([j.seconds for j in jobs]), file=log)

        result: dict = {}
        n_steps = cell.steps * len(jobs)
        if trace:
            from benchmark import trace as tracing

            (traced, tr) = tracing.profile(lambda: program.job(len(jobs)), str(tmpdir))
            if isinstance(traced.out, str):
                Path(traced.out).unlink(missing_ok=True)
            cards = sorted({d.index or 0 for d in devices}) if devices[0].type == "cuda" \
                else [0]
            ctx = Context(cell, jobs, tr, cell.steps, cards)
            metrics = {}
            for m in cell.per_layer:
                reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
                value = reader.read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
            result["metrics"] = metrics
            busy = [tr.busy_s(c) for c in cards]
            result["device_trace"] = {"busy_s": sum(busy) / len(busy),
                                      "window_s": tr.window_s}
            result["breakdown"] = tracing.breakdown(tr, cards)
            del traced, tr, ctx
        else:
            values = {"setup_s": setup_s,
                      "step_ms": window_s / max(n_steps, 1) * 1e3,
                      "peak_mem_GiB": peak / float(1 << 30)}
            result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                                 for m in cell.end_to_end}
        del program
        gc.unfreeze()
        gc.collect()
        if devices[0].type == "cuda":
            torch.cuda.empty_cache()

        raised = sum(j.error is not None for j in jobs)
        checks, wrong = check(cell, inputs, seed, [j for _, j in kept], devices[0])
        result.update(correct=raised == 0 and wrong == 0 and len(kept) > 0,
                      attempted=len(jobs), failed=raised + wrong,
                      memory_peak_bytes=peak, checks=checks)
        return result
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


# ---------------------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------------------


def _datasets(out) -> dict:
    """name -> (array, dtype name, attrs) of a job's output (a group, or a file's path)."""
    if isinstance(out, str):
        from benchmark.reference import h5read

        with h5read.File(out, "r") as f:
            return {k: (f[k][...], str(f[k].dtype), dict(f[k].attrs.items()))
                    for k in f.keys()}
    return {k: (out[k].data, str(out[k].data.dtype), dict(out[k].attrs))
            for k in out.keys()}


def reference_outputs(cell: Cell, inputs: dict, device, precision: str = "float64"):
    """The reference's pressure at the sensors, [Nt, N] float64 on the host."""
    from benchmark.reference import kspace

    return kspace.simulate(inputs, cell.steps, inputs["sensors"], device, precision)


def numbers(cell: Cell, inputs: dict, seed: int, outputs: list, ref) -> list:
    """Each check of the configuration on each of ``outputs`` (a job's datasets, as
    `_datasets` gives them) against the reference's series ``ref``: one dict of numbers
    a job."""
    from benchmark.reference import compare, recipe

    n = int(inputs["sensors"].numel())
    harmonics = int(cell.config.get("harmonics", 1))
    codec = compare.Codec(float(cell.config["period"]), harmonics,
                          recipe.oracle_sample(n, int(cell.config["oracle_sensors"]), seed), n)
    checks = list(cell.config["checks"])
    if cell.traffic["entry"] == "files":
        checks.append({"name": "layout_off", "kind": "layout"})
    sizes = {"nt": cell.steps, "N": n, "Nc": cell.steps // int(cell.config["period"]),
             "words": -(-5 * n // 4) * harmonics}  # k-Wave's mSize: ceil(1.25 N) H
    series = ref.numpy()
    per_job = []
    for ds in outputs:
        got = {}
        for c in checks:
            kind = c["kind"]
            if kind != "layout" and c["dataset"] not in ds:
                v = float("inf")
            elif kind == "series":
                v = compare.gap(ds[c["dataset"]][0][0], series)
            elif kind == "coeff":
                v = codec.coeff_gap(ds[c["dataset"]][0], series)
            elif kind == "bytes":
                raw = ds.get(c["raw"])
                v = float("inf") if raw is None else codec.bytes_off(ds[c["dataset"]][0],
                                                                      raw[0])
            elif kind == "layout":
                v = compare.layout_off({k: (a.shape, d, at) for k, (a, d, at) in ds.items()},
                                       cell.config["layout"], sizes)
            else:
                raise CellError(f"check {c['name']!r}: unknown kind {kind!r}")
            got[c["name"]] = float(v)
        per_job.append(got)
    return per_job


def limits(cell: Cell) -> dict:
    out = {k: float(v) for k, v in cell.config["limits"].items()}
    if cell.traffic["entry"] == "files":
        out.setdefault("layout_off", 0.0)
    return out


def check(cell: Cell, inputs: dict, seed: int, jobs: list, device) -> tuple:
    """The kept jobs' numbers against the reference run on ``device``: each number's worst
    job beside its limit, and how many jobs broke a limit."""
    lim = limits(cell)
    if not jobs:
        return {k: {"value": float("inf"), "limit": v} for k, v in lim.items()}, 0
    ref = reference_outputs(cell, inputs, device)
    per_job = numbers(cell, inputs, seed, [_datasets(j.out) for j in jobs], ref)
    worst = {k: {"value": max(p[k] for p in per_job), "limit": lim[k]} for k in lim}
    wrong = sum(any(not p[k] <= lim[k] for k in lim) for p in per_job)
    return worst, wrong
