"""Capturing the window graphs a job: the program's ``kwave.graph.capture`` spans
(`graphs.Graphs.capture` recording and instantiating each graph) summed over the traced
job, in ms; through either entry, `cli.main` included."""

from benchmark.metrics.program_spans import summed_ms


def read(ctx):
    return summed_ms(ctx, "kwave.graph.capture")
