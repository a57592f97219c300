"""The host's time a replayed window: the program's ``kwave.window.replay`` spans
(`driver._Window` from the state's hand-over through the graph's launch to the
emissions' copies) averaged over the traced job's replays, in us."""

from benchmark.metrics.program_spans import intervals


def read(ctx):
    spans = intervals(ctx, "kwave.window.replay")
    return sum(e - s for s, e in spans) / len(spans) if spans else None
