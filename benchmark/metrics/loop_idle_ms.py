"""The card's idle time in the window loop a step: the first card's gaps (no kernel, copy
or fill running) inside the program's ``kwave.simulation`` span of the traced job, over
its steps, in ms. The host's hold between windows: what graph launches, flushes and the
loop leave the card waiting for."""

from benchmark.metrics.program_spans import intervals


def read(ctx):
    loops = intervals(ctx, "kwave.simulation")
    if not loops or not ctx.traced_steps:
        return None
    idle = sum(max(0.0, min(ge, le) - max(gs, ls))
               for gs, ge in ctx.trace.gaps(ctx.cards[0]) for ls, le in loops)
    return idle / 1e3 / ctx.traced_steps
