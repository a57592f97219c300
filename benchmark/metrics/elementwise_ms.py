"""PyTorch's elementwise, reduction and indexing kernels a step (the solver's updates,
the compact operators rebuilt each step, the sensor gather): device ms over the traced
job, on the first card, by the names in `kernel_classes.ELEMENTWISE`."""

from benchmark.metrics.kernel_classes import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "elementwise")
