"""The share of the traced job in which the first card ran nothing, in %: one minus the
union of its device operations' intervals (kernels, copies, fills) over the job's wall
time, from the profiler's trace."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    card = ctx.cards[0]
    return 100.0 * (1.0 - ctx.trace.busy_s(card) / ctx.trace.window_s)
