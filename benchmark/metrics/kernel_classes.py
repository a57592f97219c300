"""Kernel names by kind, as the card's profiler names them: what ``fft_ms`` and
``elementwise_ms`` sum. A kernel is counted in the first kind whose fragments its name
holds (lower case)."""

# cuFFT's kernels (torch.fft on the card)
FFT = ("fft", "radix", "bluestein", "postprocessc2c", "preprocessc2c", "postprocessr2c",
       "preprocessc2r", "real_data", "fftw")
# PyTorch's elementwise, reduction, copy and indexing kernels
ELEMENTWISE = ("elementwise", "reduce_kernel", "catarraybatchedcopy", "index", "scatter",
               "gather", "copy_kernel", "fill", "where", "pow", "sqrt", "sin", "cos",
               "tensoriterator")


def kind(name: str):
    low = name.lower()
    for label, frags in (("fft", FFT), ("elementwise", ELEMENTWISE)):
        if any(f in low for f in frags):
            return label
    return None


def ms_per_step(ctx, label: str):
    """Device ms a step of the kernels of ``label`` over the traced job, on the cell's
    first card."""
    if ctx.trace is None:
        return None
    card = ctx.cards[0]
    total = sum(d for name, c, _, d in ctx.trace.ops
                if c == card and kind(name) == label)
    return total / 1e3 / ctx.traced_steps if total > 0 else None
