"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

- `encode_window_float_exact` / `encode_window_40b_exact`: the reference-exact window
  encodes (float and 40-bit accumulators), `encode_window`.
- `encode_window_float`: one window of the fast projection with a carried P1,
  served by the projection kernel of `fastpath`.
- `fastpath`: the whole-series projection encode and the overlap-add decode.
- `encode_series`: the whole-record reference-exact encodes (float and 40-bit), every
  window of a record in one launch.
- `zfuse`: the solver's fused z stage (z-DFT, operator built in the kernel, z-IDFT).

Importing this package builds nothing: the kernels are compiled by `_build` at their
first launch on a CUDA tensor."""

from kwave_tpu_torch.ops.encode_window import (
    LAUNCHES,
    encode_window_40b_exact,
    encode_window_40b_exact_plain,
    encode_window_float,
    encode_window_float_exact,
    encode_window_float_exact_plain,
    encode_window_float_plain,
    reset_launch_counts,
)

__all__ = [
    "LAUNCHES",
    "encode_window_40b_exact",
    "encode_window_40b_exact_plain",
    "encode_window_float",
    "encode_window_float_exact",
    "encode_window_float_exact_plain",
    "encode_window_float_plain",
    "reset_launch_counts",
]
