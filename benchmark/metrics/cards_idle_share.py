"""The share of the traced job in which a card ran nothing, in %, as a mean over the
cell's cards: for each card one minus the union of its device operations' intervals
(kernels, copies, fills) over the job's wall time, from the profiler's trace
(`idle_share` reads the first card alone)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or not ctx.cards:
        return None
    shares = [1.0 - ctx.trace.busy_s(c) / ctx.trace.window_s for c in ctx.cards]
    return 100.0 * sum(shares) / len(shares)
