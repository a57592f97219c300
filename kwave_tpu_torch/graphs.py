"""CUDA graphs of the solver's state-carrying programs: the port's counterpart of a jitted
JAX program with donated state (`kwave_tpu.driver.make_window_fn`, the lead-in of
`kwave_tpu.solver.make_simulate_fn`).

A program (an o-step window, or a chunk of lead-in steps) launches some 150 kernels a
step from the host. Captured once into a `torch.cuda.CUDAGraph`, it is replayed with one
host call. Each kind of program (its key: the host branches it takes) gets its own graph;
all of them read the carried state from one set of static buffers, write the new state
back into those buffers as their last nodes (the counterpart of donation), and share one
memory pool. The time index is a static 0-d device tensor set before each replay.

The host decides which runs of steps replay (`graph_actions`): a run whose key is None
runs eagerly, as does the first run of a key that no later run takes; the first run of a
key that a later run takes runs eagerly too, as the capture's warm-up (cuFFT plans, K7's
tables, the kernels' libraries), and is captured after it. A capture or a replay that
fails raises; nothing falls back to the eager program.

The kernels' launch counters (`LAUNCHES` of the ops modules) are host increments, which a
replay does not run: each graph's increments are taken back after its capture and added
again at every replay, so that the counters go on counting launches on the device.

On a mesh whose shards in this process all lie on one card (`parallel.Mesh.graph_device`)
the carried state is the flat list of every shard's tensors, and a graph holds the S
shards' steps with the pencil FFT's trades: tensor copies in one process, or NCCL's
all-to-all across processes. Then every rank must capture and replay the same keys in
the same order, since a rank that replays while another runs eagerly (or captures alone)
leaves its trades unmatched; the plans are pure functions of the run's configuration, and
`check_plans_agree` holds them equal once a run, on the host.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Hashable, Optional, Sequence

import torch

from kwave_tpu_torch.ops import encode_series, encode_window, fastpath, zfuse


def _counters() -> tuple[dict[str, int], ...]:
    return (encode_window.LAUNCHES, fastpath.LAUNCHES, encode_series.LAUNCHES,
            zfuse.LAUNCHES, zfuse.KERNEL_LAUNCHES)


def graph_actions(keys: Sequence[Optional[Hashable]]) -> list[str]:
    """What each of a sequence of runs (their keys, in order; None: no graph) runs as:
    "replay" (a key captured before), "capture" (the first run of a key that a later run
    takes: eager, then captured) or "eager"."""
    seen: set = set()
    out = []
    for i, key in enumerate(keys):
        if key is not None and key in seen:
            out.append("replay")
        elif key is not None and key in keys[i + 1:]:
            seen.add(key)
            out.append("capture")
        else:
            out.append("eager")
    return out


def check_plans_agree(plans: Sequence[Any]) -> None:
    """Raise unless every rank's plan (gathered on the host, outside any capture, in rank
    order) equals rank 0's."""
    for rank, plan in enumerate(plans[1:], 1):
        if plan != plans[0]:
            raise RuntimeError(f"rank {rank} plans its graphs as {plan}, rank 0 as "
                               f"{plans[0]}: the ranks' captures and replays would not "
                               "match")


class Graphs:
    """The captured programs of one carried state on one CUDA device.

    ``capture(key, state, body)`` records ``body(static, t) -> (new_state, extra)``, where
    ``static`` is the list of static state buffers (made at the first capture, like
    ``state``) and ``t`` the static time index; ``new_state`` is copied into ``static`` at
    the end of the graph, and ``extra`` (any objects, e.g. the window's emissions) is
    kept: its tensors live in the graph's pool and are rewritten by each replay.
    ``replay(key, state, t)`` copies ``state`` into the static buffers where it is not
    them already, sets ``t``, replays and returns ``(static, extra)``."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device; got {self.device}")
        self.pool = torch.cuda.graph_pool_handle()
        self.static: Optional[list[torch.Tensor]] = None
        self.t: Optional[torch.Tensor] = None
        self._graphs: dict[Hashable, tuple] = {}
        self.capture_seconds: dict[Hashable, float] = {}  # capture + instantiate, by key

    def __contains__(self, key: Hashable) -> bool:
        return key in self._graphs

    def capture(self, key: Hashable, state: Sequence[torch.Tensor],
                body: Callable[[list[torch.Tensor], torch.Tensor], tuple[list, Any]]):
        if key in self._graphs:
            raise ValueError(f"graph {key!r} is captured already")
        if self.static is None:
            self.static = [torch.empty_like(x) for x in state]
            self.t = torch.zeros((), dtype=torch.int64, device=self.device)
        before = [dict(c) for c in _counters()]
        graph = torch.cuda.CUDAGraph()
        start = time.perf_counter()
        # capture_begin/end on a side stream rather than the torch.cuda.graph context,
        # which empties the allocator's cache before every capture (the eager windows
        # around it would pay fresh device allocations)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=self.pool)
                try:
                    new, extra = body(self.static, self.t)
                    if len(new) != len(self.static):
                        raise ValueError(f"the program returned {len(new)} state tensors "
                                         f"for {len(self.static)}")
                    for s, x in zip(self.static, new):
                        if x is not s:
                            s.copy_(x)
                finally:
                    graph.capture_end()  # instantiates the graph
            torch.cuda.current_stream(self.device).wait_stream(stream)
            self.capture_seconds[key] = time.perf_counter() - start
        finally:
            deltas = []
            for counts, was in zip(_counters(), before):
                deltas.append({k: counts[k] - was.get(k, 0) for k in counts})
                counts.update(was)  # a capture launches nothing
        self._graphs[key] = (graph, extra, deltas)

    def replay(self, key: Hashable, state: Sequence[torch.Tensor], t: int):
        graph, extra, deltas = self._graphs[key]
        for s, x in zip(self.static, state):
            if x is not s:
                s.copy_(x)
        self.t.fill_(int(t))
        graph.replay()
        for counts, delta in zip(_counters(), deltas):
            for k, n in delta.items():
                counts[k] += n
        return self.static, extra
