"""One job under `torch.profiler`, with host spans around the calls into the program's
layers, read back from the profiler's trace: every device operation (kernels, copies,
fills) with its card, start and length, and every span.

The spans are the benchmark's own: `record_function` ranges put around the program's
functions while the traced job runs (`spans`), so that an idle gap on the card can be
named by what the host was doing in it.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import importlib
import json
import os
import tempfile
from typing import Optional

# (module, attribute path, span): the calls into each layer that a span covers
SPANS = (
    ("kwave_tpu_torch.cli", "read_input_file", "input_read"),
    ("kwave_tpu_torch.cli", "run_simulation", "job"),
    ("kwave_tpu_torch.driver", "make_operators", "operators"),
    ("kwave_tpu_torch.driver", "StreamWriter.__init__", "output_create"),
    ("kwave_tpu_torch.driver", "_Window.__call__", "window"),
    ("kwave_tpu_torch.graphs", "Graphs.capture", "capture"),
    ("kwave_tpu_torch.driver", "StreamWriter.flush_emissions", "flush"),
    ("kwave_tpu_torch.driver", "StreamWriter.flush_aggregates", "aggregates"),
    ("kwave_tpu_torch.driver", "write_run_info", "run_info"),
    ("kwave_tpu_torch.io.h5file", "File.close", "h5_close"),
)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    """``ops``: (name, card, start us, length us) of every device operation; ``spans``:
    (name, start us, end us) of the benchmark's host spans; ``cpu_ops``: the same of the
    profiler's host operations; ``start``/``end``: the traced job's own span."""

    ops: list
    spans: list
    cpu_ops: list
    start: float
    end: float
    _starts: Optional[tuple] = None

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_s(self, card: int) -> float:
        """Seconds in which some operation ran on ``card`` inside the window."""
        total, last = 0.0, self.start
        for begin, stop in sorted((max(s, self.start), min(s + d, self.end))
                                  for _, c, s, d in self.ops if c == card):
            if stop <= last:
                continue
            total += stop - max(begin, last)
            last = stop
        return total / 1e6

    def gaps(self, card: int) -> list:
        """(start us, end us) of every interval in the window in which ``card`` ran
        nothing."""
        out, last = [], self.start
        for begin, stop in sorted((s, s + d) for _, c, s, d in self.ops if c == card):
            if begin > last and begin <= self.end:
                out.append((last, begin))
            last = max(last, stop)
        if last < self.end:
            out.append((last, self.end))
        return out

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost span, and the innermost host
        operation among the last few that began before it, that cover it."""
        def innermost(events, starts, reach):
            best = None
            i = bisect.bisect_right(starts, t)
            for name, s, e in events[max(0, i - reach):i]:
                if t < e and (best is None or e - s < best[2] - best[1]):
                    best = (name, s, e)
            return best[0] if best else None

        if self._starts is None:
            self.spans.sort(key=lambda e: e[1])
            self.cpu_ops.sort(key=lambda e: e[1])
            self._starts = ([e[1] for e in self.spans], [e[1] for e in self.cpu_ops])
        span = innermost(self.spans, self._starts[0], len(self.spans))
        op = innermost(self.cpu_ops, self._starts[1], 64)
        span = span or "outside the job's spans"
        return span if op is None else f"{span}: {op}"


def _patch(module: str, path: str, name: str, stack: contextlib.ExitStack) -> None:
    from torch.profiler import record_function

    owner = importlib.import_module(module)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    fn = getattr(owner, parts[-1])

    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    setattr(owner, parts[-1], spanned)
    stack.callback(setattr, owner, parts[-1], fn)


def profile(job, tmpdir: str) -> tuple:
    """Run ``job()`` under the profiler, the spans installed; returns its result and the
    `Trace`."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    with contextlib.ExitStack() as stack:
        for module, path, name in SPANS:
            _patch(module, path, name, stack)
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("traced_job"):
                result = job()
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    ops, spans, cpu_ops = [], [], []
    start = end = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATEGORIES:
            ops.append((e["name"], int(e.get("args", {}).get("device", 0)), ts, dur))
        elif cat == "user_annotation":
            if e["name"] == "traced_job":
                start, end = ts, ts + dur
            else:
                spans.append((e["name"], ts, ts + dur))
        elif cat == "cpu_op":
            cpu_ops.append((e["name"], ts, ts + dur))
    if start is None:
        raise RuntimeError("the profiler's trace holds no span of the traced job")
    return result, Trace(ops, spans, cpu_ops, start, end)


def breakdown(trace: Trace, cards: list, top: int = 10) -> dict:
    """The device operations that took most time (seconds over the cards), and the
    longest idle time of card ``cards[0]`` by what the host was doing."""
    by_op: dict = {}
    for name, card, _, dur in trace.ops:
        if card in cards:
            by_op[name] = by_op.get(name, 0.0) + dur / 1e6
    by_host: dict = {}
    for begin, stop in trace.gaps(cards[0]):
        what = trace.host_at(0.5 * (begin + stop))
        by_host[what] = by_host.get(what, 0.0) + (stop - begin) / 1e6
    def head(d):
        return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": head(by_op), "idle_gaps": head(by_host)}
