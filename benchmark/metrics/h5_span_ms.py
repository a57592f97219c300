"""The program's HDF5 writer a job: the time covered by its ``kwave.h5.write`` spans
(`io.h5file` putting bytes in the file: dataset writes and the flush at ``File.close``;
a span inside another counts once) over the traced job, in ms. Only a job that writes a
file has them."""

from benchmark.metrics.program_spans import intervals, union_us


def read(ctx):
    spans = intervals(ctx, "kwave.h5.write")
    return union_us(spans) / 1e3 if spans else None
