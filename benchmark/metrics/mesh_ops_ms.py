"""The operators a job on a mesh: the time covered by the program's ``kwave.operators``
spans and those under that name (``.to_device``, ``.build``:
`solver.operators.make_operators` on the host; ``.shard``: `parallel.shard_operators`
putting them on the cards) over the traced job, in ms. None without such spans."""

from benchmark.metrics.program_spans import union_us


def read(ctx):
    if ctx.trace is None:
        return None
    spans = [(s, e) for n, s, e in ctx.trace.spans
             if n == "kwave.operators" or n.startswith("kwave.operators.")]
    return union_us(spans) / 1e3 if spans else None
