"""kwave_tpu_torch: the k-Wave fluid simulator and compressed-stream codec on PyTorch and
CUDA, a port of `kwave_tpu` (the JAX reference, which stays unchanged beside it).

The package imports torch, never jax and nothing of `kwave_tpu`: it keeps its own copies
of the NumPy spec modules (`basis`, `oracle`). The compressed-stream encoders, the codec
round trip and the solver's fused z stage run as hand-written CUDA kernels for sm_90a
(``ops/``, ``csrc/``), built with nvcc at first use on a CUDA tensor; on CPU tensors every
op takes its plain PyTorch version.

The CLI (`kwave_tpu_torch.cli`) takes its device from ``KWAVE_TPU_TORCH_DEVICE``
(default ``cuda``; it raises when CUDA is not available and never falls back to the CPU).
"""

__version__ = "0.1.0"

from kwave_tpu_torch.basis import CompressionBasis, find_period, generate_basis  # noqa: F401
