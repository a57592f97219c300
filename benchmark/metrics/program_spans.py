"""The program's own spans in the traced job: the ``kwave.*`` ranges that
`kwave_tpu_torch.utils.observability.span` opens while a profiler runs, which reach
`benchmark.trace.Trace.spans` beside the benchmark's. A program without them (an older
commit) gives no interval, and each reader that reads them then gives None."""


def intervals(ctx, name: str) -> list:
    """(start us, end us) of every span called ``name`` in the traced job."""
    if ctx.trace is None:
        return []
    return [(s, e) for n, s, e in ctx.trace.spans if n == name]


def union_us(spans: list) -> float:
    """Microseconds that some of ``spans`` covers: a span inside another counts once."""
    total, last = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > last:
            total += e - max(s, last)
            last = e
    return total


def summed_ms(ctx, name: str):
    """The spans called ``name`` over the traced job, in ms (None where there are
    none)."""
    spans = intervals(ctx, name)
    return sum(e - s for s, e in spans) / 1e3 if spans else None
