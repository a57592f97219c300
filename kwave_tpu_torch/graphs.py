"""CUDA graphs of the solver's state-carrying programs: the port's counterpart of a jitted
JAX program with donated state (`kwave_tpu.driver.make_window_fn`, the lead-in of
`kwave_tpu.solver.make_simulate_fn`).

A program (an o-step window, or a chunk of lead-in steps) launches some 150 kernels a
step from the host. Captured once into a `torch.cuda.CUDAGraph`, it is replayed with one
host call. Each kind of program (its key: the host branches it takes) gets its own graph;
all of them read the carried state from one set of static buffers, write the new state
back into those buffers as their last nodes (the counterpart of donation), and share one
memory. The time index is a static 0-d device tensor (one a shard on a mesh) set before
each replay.

The host decides which runs of steps replay (`graph_actions`): a run whose key is None
runs eagerly, as does the first run of a key that no later run takes; the first run of a
key that a later run takes runs eagerly too, as the capture's warm-up (cuFFT plans, K7's
tables, the kernels' libraries), and is captured after it. A capture or a replay that
fails raises; nothing falls back to the eager program.

The kernels' launch counters (`LAUNCHES` of the ops modules) are host increments, which a
replay does not run: each graph's increments are taken back after its capture and added
again at every replay, so that the counters go on counting launches on the device.

On a mesh whose shards in this process lie on CUDA cards (`parallel.Mesh.graph_devices`)
the carried state is the flat list of every shard's tensors, and a graph holds the S
shards' steps with the pencil FFT's trades: tensor copies in one process (peer copies
where the shards lie on several cards, all in the one graph), and across processes one
NCCL all-to-all a card of this process (`parallel.comm.ProcessGroup`, each on its
card's capturing stream). Then every rank must capture and replay the same keys in
the same order, since a rank that replays while another runs eagerly (or captures alone)
leaves its trades unmatched; the plans are pure functions of the run's configuration, and
`check_plans_agree` holds them equal once a run, on the host.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Hashable, Optional, Sequence

import torch

from kwave_tpu_torch.ops import encode_series, encode_window, fastpath, zfuse
from kwave_tpu_torch.parallel.sharded import Sharded
from kwave_tpu_torch.utils.observability import span


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
    """The captured programs of one carried state, on one CUDA device or on the cards of
    a mesh's shards.

    ``devices`` is one device, or the device of each shard of a sharded state (in shard
    order; several shards may share a card). ``capture(key, state, body)`` records
    ``body(static, t) -> (new_state, extra)``, where ``static`` is the list of static
    state buffers (made at the first capture, like ``state``, each on its tensor's
    device) and ``t`` the static time index: a 0-d tensor on the one device, or a
    `Sharded` of one 0-d tensor a shard, on its card. ``new_state`` is copied into
    ``static`` at the end of the graph, and ``extra`` (any objects, e.g. the window's
    emissions) is kept: its tensors live in the graph's memory and are rewritten by each
    replay. ``replay(key, state, t)`` copies ``state`` into the static buffers where it
    is not them already, sets every time index, replays and returns ``(static,
    extra)``.

    Over several cards one graph holds them all: the capture begins on a side stream of
    the first card, each other card's side stream joins it by an event (and is that
    card's current stream while the body runs, so its shards' ops, the peer copies of
    the trades and an NCCL all-to-all on its buffer land in the graph, ordered by their
    own events), and joins back
    before the capture ends. The first card's allocations during a capture come from
    the graphs' private pool, each other card's from a `torch.cuda.MemPool` of its own
    that lives as long as this object, so that no eager allocation reuses the graphs'
    memory. A replay is launched on the first card's current stream after every other
    card's current stream, which in turn waits for it."""

    def __init__(self, devices):
        sharded = not isinstance(devices, (str, torch.device))
        shard_devices = [torch.device(d) for d in devices] if sharded \
            else [torch.device(devices)]
        self.cards = tuple(dict.fromkeys(shard_devices))
        self.device = self.cards[0]  # the card that captures and launches
        self._times = [torch.zeros((), dtype=torch.int64, device=d) for d in shard_devices]
        self.t = Sharded(self._times) if sharded else self._times[0]
        self.static: Optional[list[torch.Tensor]] = None
        self._graphs: dict[Hashable, tuple] = {}
        self.capture_seconds: dict[Hashable, float] = {}  # capture + instantiate, by key
        self._memory()  # last: the pools go after the graphs and their outputs

    def _memory(self) -> None:
        """The graphs' memory: the private pool of the first card, a `MemPool` of each
        other card's."""
        if any(d.type != "cuda" for d in self.cards):
            raise ValueError(f"CUDA graphs need CUDA devices; got "
                             f"{', '.join(map(str, self.cards))}")
        self.pool = torch.cuda.graph_pool_handle()
        self._pools = []
        for d in self.cards[1:]:
            with torch.cuda.device(d):  # a MemPool belongs to the card current at birth
                self._pools.append(torch.cuda.MemPool())

    def __contains__(self, key: Hashable) -> bool:
        return key in self._graphs

    def capture(self, key: Hashable, state: Sequence[torch.Tensor],
                body: Callable[[list[torch.Tensor], Any], tuple[list, Any]]):
        if key in self._graphs:
            raise ValueError(f"graph {key!r} is captured already")
        if self.static is None:
            self.static = [torch.empty_like(x) for x in state]
        before = [dict(c) for c in _counters()]

        def program():
            new, extra = body(self.static, self.t)
            if len(new) != len(self.static):
                raise ValueError(f"the program returned {len(new)} state tensors for "
                                 f"{len(self.static)}")
            for s, x in zip(self.static, new):
                if x is not s:
                    s.copy_(x)
            return extra

        start = time.perf_counter()
        try:
            with span("kwave.graph.capture"):
                graph, extra = self._record(program)
            self.capture_seconds[key] = time.perf_counter() - start
        finally:
            deltas = []
            for counts, was in zip(_counters(), before):
                deltas.append({k: counts[k] - was.get(k, 0) for k in counts})
                counts.update(was)  # a capture launches nothing
        self._graphs[key] = (graph, extra, deltas)

    def _record(self, program: Callable[[], Any]) -> tuple:
        """``program`` captured as one CUDA graph over every card (see the class):
        (the graph, what the program returned)."""
        graph = torch.cuda.CUDAGraph()
        # capture_begin/end on side streams rather than the torch.cuda.graph context,
        # which empties the allocator's cache before every capture (the eager windows
        # around it would pay fresh device allocations)
        streams = [torch.cuda.Stream(d) for d in self.cards]
        for s, d in zip(streams, self.cards):
            s.wait_stream(torch.cuda.current_stream(d))
        with contextlib.ExitStack() as stack:
            for s in reversed(streams):  # the first card's last: it is then current
                stack.enter_context(torch.cuda.stream(s))
            for pool, d in zip(self._pools, self.cards[1:]):
                stack.enter_context(torch.cuda.use_mem_pool(pool, d))
            graph.capture_begin(pool=self.pool)
            try:
                for s in streams[1:]:
                    s.wait_stream(streams[0])  # joins the capture
                extra = program()
                for s in streams[1:]:
                    streams[0].wait_stream(s)  # and joins back
            finally:
                graph.capture_end()  # instantiates the graph
        for s, d in zip(streams, self.cards):
            torch.cuda.current_stream(d).wait_stream(s)
        return graph, extra

    def replay(self, key: Hashable, state: Sequence[torch.Tensor], t: int):
        graph, extra, deltas = self._graphs[key]
        for s, x in zip(self.static, state):
            if x is not s:
                s.copy_(x)
        for t_dev in self._times:
            t_dev.fill_(int(t))
        with span("kwave.graph.launch"):
            self._launch(graph)
        for counts, delta in zip(_counters(), deltas):
            for k, n in delta.items():
                counts[k] += n
        return self.static, extra

    def _launch(self, graph) -> None:
        main = torch.cuda.current_stream(self.device)
        for d in self.cards[1:]:
            main.wait_stream(torch.cuda.current_stream(d))
        with torch.cuda.device(self.device):
            graph.replay()
        for d in self.cards[1:]:
            torch.cuda.current_stream(d).wait_stream(main)
