"""The flush's hold on the card a job: the first card's idle time inside the program's
``kwave.flush.*`` spans (`streams.StreamWriter.flush_emissions` taking each stream's
emission to the host, then writing it) after the last device operation that starts in the
span, summed over the traced job, in ms. What counts is the card waiting on the copies'
host side and the writes once the work the flush waited for is done; idle before that work
runs (a graph whose execution starts late under the profiler) is not the flush's."""

from benchmark.metrics.program_spans import intervals, union_us


def read(ctx):
    flushes = intervals(ctx, "kwave.flush.to_host") + intervals(ctx, "kwave.flush.write")
    if not flushes:
        return None
    card = ctx.cards[0]
    ops = [(s, s + d) for _, c, s, d in ctx.trace.ops if c == card]
    gaps = ctx.trace.gaps(card)
    idle = []
    for fs, fe in flushes:
        done = min(fe, max([e for s, e in ops if fs <= s < fe], default=fs))
        idle += [(max(gs, done), min(ge, fe)) for gs, ge in gaps
                 if min(ge, fe) > max(gs, done)]
    return union_us(idle) / 1e3
