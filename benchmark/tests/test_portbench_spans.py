"""The readers of the program's own spans (`metrics/program_spans.py` and the metrics
that read it) against a hand-made trace whose answers are known, and against the same
trace without the program's spans, as an older commit's traced job gives it."""

import importlib

import pytest

from benchmark import harness
from benchmark.trace import Trace

# a job of 10 steps from 0 to 1000 us. The card (0) runs 0-100, 300-400 and 700-1000;
# card 1 runs throughout, and is not read
OPS = [("k", 0, 0.0, 100.0), ("k", 0, 300.0, 100.0), ("k", 0, 700.0, 300.0),
       ("k", 1, 0.0, 1000.0)]
SPANS = [("job", 0.0, 1000.0), ("window", 150.0, 650.0),  # the benchmark's own
         ("kwave.simulation", 50.0, 950.0),  # idle in it: 100-300, 400-700
         ("kwave.window.replay", 150.0, 250.0), ("kwave.window.replay", 450.0, 650.0),
         ("kwave.graph.capture", 120.0, 130.0), ("kwave.graph.capture", 500.0, 540.0),
         ("kwave.flush.to_host", 260.0, 290.0), ("kwave.flush.to_host", 660.0, 670.0),
         ("kwave.flush.write", 290.0, 300.0),
         ("kwave.h5.write", 290.0, 295.0), ("kwave.h5.write", 292.0, 299.0),  # nested
         ("kwave.h5.write", 960.0, 980.0)]
WANT = {
    "loop_idle_ms": (200.0 + 300.0) / 1e3 / 10,
    "flush_wait_ms": (30.0 + 10.0 + 10.0) / 1e3,  # card 0's idle inside the flushes
    "replay_host_us": 150.0,
    "graph_capture_ms": 50.0 / 1e3,
    "h5_span_ms": (9.0 + 20.0) / 1e3,
}


def _ctx(spans: list) -> harness.Context:
    trace = Trace(ops=list(OPS), spans=list(spans), cpu_ops=[], start=0.0, end=1000.0)
    return harness.Context(cell=None, jobs=[], trace=trace, traced_steps=10, cards=[0])


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_gives_the_known_value(name):
    reader = importlib.import_module(f"benchmark.metrics.{name}")
    assert reader.read(_ctx(SPANS)) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_without_the_programs_spans_each_reader_gives_none(name):
    reader = importlib.import_module(f"benchmark.metrics.{name}")
    older = [s for s in SPANS if not s[0].startswith("kwave.")]
    assert reader.read(_ctx(older)) is None
    assert reader.read(harness.Context(cell=None, jobs=[])) is None  # no traced job


def test_the_idle_time_outside_the_loop_is_not_the_loops():
    """Idle before and after ``kwave.simulation`` (0-50 and 950-1000 hold no gap of card
    0; a loop span moved to 400-1000 keeps 400-700 alone)."""
    from benchmark.metrics import loop_idle_ms

    moved = [("kwave.simulation", 400.0, 1000.0)]
    assert loop_idle_ms.read(_ctx(moved)) == pytest.approx(300.0 / 1e3 / 10)


def test_a_flush_holds_the_card_only_after_the_work_it_waited_for():
    """A ``kwave.flush.to_host`` span over card 0's work (300-400, 700-1000) is the wait for
    the window queued before it, not idle; idle in the span before that work starts (the
    card waiting for the graph's execution, 100-300) is not the flush's either. Only the
    part of a span past the last operation that starts in it counts."""
    from benchmark.metrics import flush_wait_ms

    assert flush_wait_ms.read(_ctx([("kwave.flush.to_host", 300.0, 400.0)])) == 0.0
    assert flush_wait_ms.read(_ctx([("kwave.flush.to_host", 700.0, 1000.0),
                                    ("kwave.flush.write", 380.0, 420.0)])) == \
        pytest.approx(20.0 / 1e3)
    assert flush_wait_ms.read(_ctx([("kwave.flush.to_host", 100.0, 450.0)])) == \
        pytest.approx(50.0 / 1e3)


def test_the_benchmark_finds_every_function_it_wraps():
    """The benchmark's own spans and its codec clock wrap the program's functions by name:
    each still resolves, and no benchmark span takes a name of the program's (``kwave.*``),
    which the readers above sum by exact name."""
    from benchmark import codec_clock, trace

    for module, path, name in trace.SPANS:
        owner = importlib.import_module(module)
        for part in path.split("."):
            owner = getattr(owner, part)
        assert callable(owner), (module, path)
        assert not name.startswith("kwave."), name
    with codec_clock.CodecClock():  # looks up and wraps each of its functions
        pass
