"""kwave_tpu_torch.sampling against kwave_tpu.sampling on the same numpy inputs: the
gathers, max and min bit for bit; the rms accumulates within 1 ulp (XLA:CPU may fuse
``buf + x*x`` into one rounding); index, cuboid and whole-domain forms, 3D fields and 2D
ones (nz = 1) for the cuboids."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kwave_tpu import sampling as jsam
from kwave_tpu_torch import sampling
from torch_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

SHAPES = [(6, 7, 9), (1, 10, 12)]  # [nz, ny, nx]; the second a 2D field
# (shape, lo, hi): the whole field, a block, a single point, and 2D blocks
CUBOIDS = [((6, 7, 9), (0, 0, 0), (9, 7, 6)), ((6, 7, 9), (2, 1, 3), (7, 5, 6)),
           ((6, 7, 9), (3, 4, 2), (4, 5, 3)), ((1, 10, 12), (2, 1, 0), (7, 5, 1)),
           ((1, 10, 12), (0, 9, 0), (12, 10, 1))]


def _field(shape, seed):
    return (1e5 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _within_ulp(got: torch.Tensor, want, ulps: int = 1) -> None:
    want = np.asarray(want)
    gap = np.abs(got.numpy().astype(np.float64) - want.astype(np.float64))
    assert (gap <= ulps * np.spacing(np.abs(want))).all(), float(gap.max())


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES)
def test_index_gather_and_reduces_match_jax(shape):
    flat = _field(shape, 1).reshape(-1)
    mask = np.sort(np.random.default_rng(2).choice(flat.size, 23, replace=False))
    buf = _field((23,), 3)
    f_t, m_t, b_t = torch.from_numpy(flat), torch.from_numpy(mask), torch.from_numpy(buf)
    f_j, m_j, b_j = jnp.asarray(flat), jnp.asarray(mask.astype(np.int32)), jnp.asarray(buf)
    _same(sampling.sample_index(f_t, m_t), jsam.sample_index(f_j, m_j))
    _same(sampling.sample_index_max(b_t, f_t, m_t), jsam.sample_index_max(b_j, f_j, m_j))
    _same(sampling.sample_index_min(b_t, f_t, m_t), jsam.sample_index_min(b_j, f_j, m_j))
    _within_ulp(sampling.sample_index_rms(b_t.abs(), f_t, m_t),
                jsam.sample_index_rms(jnp.abs(b_j), f_j, m_j))


@pytest.mark.parametrize("shape,lo,hi", CUBOIDS)
def test_cuboid_samplers_match_jax(shape, lo, hi):
    field = _field(shape, 4)
    cub, jcub = sampling.Cuboid(lo, hi), jsam.Cuboid(lo, hi)
    assert cub.shape == jcub.shape and cub.size == jcub.size
    f_t, f_j = torch.from_numpy(field), jnp.asarray(field)
    block = sampling.sample_cuboid(f_t, cub)
    _same(block, jsam.sample_cuboid(f_j, jcub))
    flat = sampling.sample_cuboid_flat(f_t, cub)
    _same(flat, jsam.sample_cuboid_flat(f_j, jcub))
    # x fastest: the reference's cuboid buffer order
    x0, y0, z0 = lo
    assert flat[0] == field[z0, y0, x0] and flat.numel() == cub.size
    if cub.shape[0] > 1:
        assert flat[1] == field[z0, y0, x0 + 1]
    buf = _field((cub.size,), 5)
    b_t, b_j = torch.from_numpy(buf), jnp.asarray(buf)
    _same(sampling.sample_cuboid_max(b_t, f_t, cub), jsam.sample_cuboid_max(b_j, f_j, jcub))
    _same(sampling.sample_cuboid_min(b_t, f_t, cub), jsam.sample_cuboid_min(b_j, f_j, jcub))
    _within_ulp(sampling.sample_cuboid_rms(b_t.abs(), f_t, cub),
                jsam.sample_cuboid_rms(jnp.abs(b_j), f_j, jcub))


@pytest.mark.parametrize("shape", SHAPES)
def test_whole_domain_reduces_match_jax(shape):
    flat = _field(shape, 6).reshape(-1)
    buf = _field(flat.shape, 7)
    f_t, b_t, f_j, b_j = (torch.from_numpy(flat), torch.from_numpy(buf), jnp.asarray(flat),
                          jnp.asarray(buf))
    _same(sampling.sample_all_max(b_t, f_t), jsam.sample_all_max(b_j, f_j))
    _same(sampling.sample_all_min(b_t, f_t), jsam.sample_all_min(b_j, f_j))
    _within_ulp(sampling.sample_all_rms(b_t.abs(), f_t), jsam.sample_all_rms(jnp.abs(b_j), f_j))


def test_a_run_of_reduces_matches_jax():
    """Ten steps of every reduce folded into one buffer each, as a stream does, with the
    buffers seeded by `init_reduce_buffer`: max and min exact, rms and its finish within
    1 ulp."""
    shape = SHAPES[0]
    cub, jcub = sampling.Cuboid((1, 2, 1), (8, 6, 5)), jsam.Cuboid((1, 2, 1), (8, 6, 5))
    bufs = {op: sampling.init_reduce_buffer(op, cub.size) for op in ("rms", "max", "min")}
    jbufs = {op: jsam.init_reduce_buffer(op, cub.size) for op in ("rms", "max", "min")}
    for t in range(10):
        field = _field(shape, 100 + t)
        f_t, f_j = torch.from_numpy(field), jnp.asarray(field)
        for op in bufs:
            bufs[op] = getattr(sampling, f"sample_cuboid_{op}")(bufs[op], f_t, cub)
            jbufs[op] = getattr(jsam, f"sample_cuboid_{op}")(jbufs[op], f_j, jcub)
    _same(bufs["max"], jbufs["max"])
    _same(bufs["min"], jbufs["min"])
    _within_ulp(bufs["rms"], jbufs["rms"])
    _within_ulp(sampling.post_rms(bufs["rms"], 10), jsam.post_rms(jbufs["rms"], 10))
