"""The card's published peaks and the least time a piece of work can take on it.

NVIDIA H100 SXM data sheet, dense rates at the full 700 W: HBM3 at 3.35 TB/s, float32
outside the tensor cores at 67 TFLOP/s. A share of either is stated with the card's power
limit beside it (the harness prints it)."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound_s(n_bytes: float, flops: float) -> float:
    """Every input byte read once and every output byte written once at the HBM rate, or
    the float32 operations at the peak rate, whichever takes longer (a frozen copy of
    ``chip_smoke._bound``)."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)
