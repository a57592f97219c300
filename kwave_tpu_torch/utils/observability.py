"""Logging, phase timers and output-file run metadata (port of
`kwave_tpu.utils.observability`).

- `Logger`: 3 verbosity levels (Logger/Logger.h:57-126).
- `span`: a `torch.profiler.record_function` range where a profiler is recording, else
  a shared null context: the program's host work on the clock of the profiler's device
  trace, at the cost of one flag check when no profiler runs.
- `PhaseTimers`: wall-clock phase timing (Utils/TimeMeasure.h:54-140), each phase also a
  `span` named ``kwave.<phase>``, split into sampling vs non-sampling iteration buckets
  (printStatistics :2742-2780).
- `write_run_info`: the output-file attribute block the reference writes per run
  (writeOutputDataInfo, KSpaceFirstOrderSolver.cpp:1100-1169); phase times are cumulated
  over checkpoint legs (`read_cumulated_times` + `PhaseTimers.restore_cumulated`).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Optional

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` on the host timeline of a recording `torch.profiler`
    (a ``user_annotation`` event, on the clock of its device events); without a
    profiler, a shared null context, so that a span costs one flag check."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class Logger:
    """Static logger with Basic/Advanced/Full levels (Logger.h:57-63)."""

    BASIC, ADVANCED, FULL = 0, 1, 2
    level = BASIC
    _out = sys.stdout

    @classmethod
    def log(cls, level: int, fmt: str, *args) -> None:
        if level <= cls.level:
            cls._out.write((fmt % args if args else fmt) + "\n")
            cls._out.flush()

    @classmethod
    def progress(cls, t: int, nt: int, t_start: float, interval_pct: int = 5) -> None:
        """Progress line with ETA from elapsed wall time (KSpaceFirstOrderSolver.cpp:
        2763-2775)."""
        if nt <= 0:
            return
        stride = max(nt * interval_pct // 100, 1)
        if t % stride and t != nt:
            return
        elapsed = time.time() - t_start
        eta = elapsed / max(t, 1) * (nt - t)
        cls.log(cls.BASIC, "  progress %5.1f%%  elapsed %7.2fs  eta %7.2fs",
                100.0 * t / nt, elapsed, eta)


class PhaseTimers:
    """Named phase stopwatches (TimeMeasure.h:126-140) on `time.perf_counter`; a running
    phase is also the span ``kwave.<phase>``."""

    PHASES = ("data_load", "preprocessing", "simulation", "postprocessing", "total")

    def __init__(self):
        self._start: dict[str, float] = {}
        self._spans: dict[str, contextlib.AbstractContextManager] = {}
        self._elapsed: dict[str, float] = {p: 0.0 for p in self.PHASES}
        self._cumulated: dict[str, float] = {p: 0.0 for p in self.PHASES}
        self.sampling_time = 0.0
        self.sampling_iters = 0
        self.non_sampling_time = 0.0
        self.non_sampling_iters = 0

    def start(self, phase: str) -> None:
        self._spans[phase] = span(f"kwave.{phase}")
        self._spans[phase].__enter__()
        self._start[phase] = time.perf_counter()

    def stop(self, phase: str) -> float:
        dt = time.perf_counter() - self._start.pop(phase)
        self._spans.pop(phase).__exit__(None, None, None)
        self._elapsed[phase] += dt
        return dt

    def set_elapsed(self, phase: str, seconds: float) -> None:
        """Record a phase measured outside the driver (the CLI's data load)."""
        self._elapsed[phase] = float(seconds)

    def elapsed(self, phase: str) -> float:
        return self._elapsed[phase]

    def cumulated(self, phase: str) -> float:
        """This leg + previous legs (restored via `restore_cumulated`)."""
        return self._cumulated[phase] + self._elapsed[phase]

    def restore_cumulated(self, values: dict[str, float]) -> None:
        for k, v in values.items():
            if k in self._cumulated:
                self._cumulated[k] = float(v)

    def add_iterations(self, seconds: float, count: int, sampled: bool) -> None:
        """``count`` time steps that took ``seconds`` together."""
        if sampled:
            self.sampling_time += seconds
            self.sampling_iters += count
        else:
            self.non_sampling_time += seconds
            self.non_sampling_iters += count


def _peak_rss_mb() -> Optional[float]:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return None


def write_run_info(h5file, timers: PhaseTimers, device: torch.device,
                   file_path: Optional[str] = None) -> None:
    """Write the reference's execution-statistics attribute block onto the output file
    root (writeOutputDataInfo, KSpaceFirstOrderSolver.cpp:1100-1169)."""
    from kwave_tpu_torch.io import names
    from kwave_tpu_torch.io.hdf5 import write_attr

    write_attr(h5file, names.TOTAL_EXECUTION_TIME, timers.cumulated("total"))
    write_attr(h5file, names.DATA_LOAD_TIME, timers.cumulated("data_load"))
    write_attr(h5file, names.PREPROCESSING_TIME, timers.cumulated("preprocessing"))
    write_attr(h5file, names.SIMULATION_TIME, timers.cumulated("simulation"))
    write_attr(h5file, names.POSTPROCESSING_TIME, timers.cumulated("postprocessing"))
    if timers.sampling_iters:
        write_attr(h5file, "average_sampling_iteration_time",
                   timers.sampling_time / timers.sampling_iters)
        write_attr(h5file, "sampling_time", timers.sampling_time)
    if timers.non_sampling_iters:
        write_attr(h5file, "average_non-sampling_iteration_time",
                   timers.non_sampling_time / timers.non_sampling_iters)
        write_attr(h5file, "non-sampling_time", timers.non_sampling_time)
    peak = _peak_rss_mb()
    if peak is not None:
        write_attr(h5file, names.PEAK_MEMORY, peak)
        write_attr(h5file, "simulation_peak_host_memory_in_use", peak)
    if device.type == "cuda":
        write_attr(h5file, names.PEAK_DEVICE_MEMORY,
                   torch.cuda.max_memory_allocated(device) / float(1 << 20))
    write_attr(h5file, names.NUMBER_OF_CORES, os.cpu_count() or 1)
    if file_path is not None and os.path.exists(file_path):
        write_attr(h5file, "output_file_size_MB", os.path.getsize(file_path) / (1 << 20))


def read_cumulated_times(h5file) -> dict[str, float]:
    """Reload previous legs' cumulated phase times from an output file
    (loadElapsedTimeFromOutputFile, KSpaceFirstOrderSolver.cpp:2898)."""
    from kwave_tpu_torch.io import names

    mapping = {
        "total": names.TOTAL_EXECUTION_TIME,
        "data_load": names.DATA_LOAD_TIME,
        "preprocessing": names.PREPROCESSING_TIME,
        "simulation": names.SIMULATION_TIME,
        "postprocessing": names.POSTPROCESSING_TIME,
    }
    return {phase: float(h5file.attrs[attr]) for phase, attr in mapping.items()
            if attr in h5file.attrs}
