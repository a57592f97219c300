"""Capturing the window graphs a job: the sum of ``graphs.capture_seconds`` (capture and
instantiate, by key) over the window objects that `run_simulation` hands to its
``window_log``, averaged over the window's jobs, in s. Only the memory entry passes a
log; a job that captured nothing has none."""


def read(ctx):
    if ctx.cell.traffic["entry"] != "memory" or not ctx.jobs:
        return None
    values = [j.capture_s for j in ctx.jobs]
    return sum(values) / len(values) if any(values) else None
