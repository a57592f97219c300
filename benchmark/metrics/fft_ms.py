"""cuFFT's kernels a step (`torch.fft` in `solver/step.py`): device ms over the traced job,
on the first card, by the names in `kernel_classes.FFT`."""

from benchmark.metrics.kernel_classes import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "fft")
