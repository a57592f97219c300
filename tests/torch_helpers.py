"""Shared inputs of the port's tests (tests/test_torch_*.py), made with numpy from seeds.

Dyadic-exact data makes every fp32 product exact, so results do not depend on whether a
backend contracts mul+add into an FMA (XLA:CPU does; the reference semantics and the
port do not): the JAX package's CPU paths can then be held bit-for-bit. Real-valued data
is held bit-for-bit against the NumPy oracle, which rounds every product.
"""

import numpy as np
import pytest
import torch

from kwave_tpu_torch.basis import CompressionBasis
from kwave_tpu_torch.graphs import Graphs


def dyadic_basis(o=8, harmonics=2) -> CompressionBasis:
    """A synthetic basis whose table entries are k/32 (|k| <= 7), with the real bases'
    rotation identity bE_1[sl] = bE[(sl+o) mod 2o]."""
    b_size = 2 * o + 1

    def tab(seed):
        k = np.random.default_rng(seed).integers(-7, 8, (harmonics, b_size))
        return (k / 32.0).astype(np.float32)

    be_re, be_im, es_re, es_im = tab(0), tab(1), tab(2), tab(3)
    idx = (np.arange(b_size) + o) % (b_size - 1)
    return CompressionBasis(
        period=float(2 * o), mos=1, harmonics=harmonics, o_size=o, b_size=b_size,
        normalized=False, b=np.zeros(b_size, np.float32),
        e_re=be_re, e_im=be_im,
        be_re=be_re, be_im=be_im, be1_re=be_re[:, idx], be1_im=be_im[:, idx],
        e_sh_re=es_re, e_sh_im=es_im,
        be_sh_re=es_re, be_sh_im=es_im, be1_sh_re=es_re[:, idx], be1_sh_im=es_im[:, idx],
    )


def dyadic_series(steps, n, seed=0, scale=1.0):
    """Integer-valued samples (exact products against dyadic tables)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 9, (steps, n)) * scale).astype(np.float32)


def real_series(steps, n, period, seed=0, scale=1e5):
    """Pressure-scale sinusoids with noise."""
    rng = np.random.default_rng(seed)
    amp = rng.uniform(0.5, 2.0, n) * scale
    ph = rng.uniform(0, 2 * np.pi, n)
    t = np.arange(steps)[:, None]
    base = amp[None] * np.sin(2 * np.pi * t / period + ph[None])
    return (base + rng.normal(0, 0.01 * scale, (steps, n))).astype(np.float32)


def stacked_tables(basis: CompressionBasis, shifted: bool = False) -> np.ndarray:
    """[2o, 4H] = [bE_re | bE_im | bE1_re | bE1_im] columns."""
    o = basis.o_size
    return np.concatenate([a[:, : 2 * o].T for a in basis.tables(shifted)],
                          axis=1).astype(np.float32)


def bits(a) -> np.ndarray:
    """uint32 view of a float32 or 32-bit integer array (or tensor)."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32)


def require_cuda() -> torch.device:
    """The card, or a skip with the reason (decided inside the test, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's tests on one torch thread: its tensors are small, and with several
    test workers on one machine, idle intra-op threads spinning on every core cost more
    than they give. A module opts in by importing this fixture."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _copy_into(dst, src):
    """``src``'s tensors written into ``dst``'s (the same structure), as a replay
    rewrites a graph's outputs."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for a, b in zip(dst, src):
            _copy_into(a, b)


class EagerCards(Graphs):
    """`graphs.Graphs` with its CUDA steps replaced and all else its own (the static
    buffers, the time index a shard, the counters): no memory pools; `_record` runs the
    program once, as the capture's recording pass, and keeps it; `_launch` notes every
    shard's time index, runs the program eagerly and writes what it returns into the
    recorded outputs."""

    launches: list = []

    def _memory(self):
        self._recorded = {}

    def _record(self, program):
        extra = program()
        self._recorded[program] = extra
        return program, extra

    def _launch(self, program):
        EagerCards.launches.append([int(t) for t in self._times])
        _copy_into(self._recorded[program], program())
