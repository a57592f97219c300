"""The mesh's host edge a job: the time covered by the program's ``kwave.edge`` spans
(`driver._Edge` on a mesh: each window's emissions, the stream states, the aggregates and
the final fields gathered from the shards to the writer, as wire bytes, and put back in
the mask's order; the wait for the card's work that the copies hold counts in it) over
the traced job, in ms. None without those spans (one card, or an older commit)."""

from benchmark.metrics.program_spans import intervals, union_us


def read(ctx):
    spans = intervals(ctx, "kwave.edge")
    return union_us(spans) / 1e3 if spans else None
