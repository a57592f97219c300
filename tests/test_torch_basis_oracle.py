"""The port's own NumPy spec modules (`kwave_tpu_torch.basis`, `kwave_tpu_torch.oracle`)
against the JAX package's originals on seeded inputs, bit for bit: both are NumPy with the
same operation order, so any difference is a copying fault and the tolerance is zero."""

import dataclasses

import numpy as np
import pytest

from kwave_tpu import basis as jbasis
from kwave_tpu import oracle as joracle
from kwave_tpu_torch import basis as pbasis
from kwave_tpu_torch import oracle as poracle
from torch_helpers import bits, real_series


def _same(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("period,mos,harmonics,normalize", [
    (16.0, 1, 1, True), (20.0, 1, 2, True), (11.3, 2, 4, True), (7.0, 1, 3, False)])
def test_generate_basis_is_the_originals(period, mos, harmonics, normalize):
    mine = pbasis.generate_basis(period, mos, harmonics, normalize)
    ref = jbasis.generate_basis(period, mos, harmonics, normalize)
    assert [f.name for f in dataclasses.fields(mine)] == \
        [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            _same(a, b)
        else:
            assert a == b, f.name
    for shifted in (False, True):
        for a, b in zip(mine.tables(shifted), ref.tables(shifted)):
            _same(a, b)
    assert pbasis.overlap_size(period, mos) == jbasis.overlap_size(period, mos)
    assert (pbasis.MAX_EXP_P, pbasis.MAX_EXP_U, pbasis.COMPRESS_SUFFIX) == \
        (jbasis.MAX_EXP_P, jbasis.MAX_EXP_U, jbasis.COMPRESS_SUFFIX)


@pytest.mark.parametrize("period,seed", [(16.0, 0), (20.5, 1), (9.25, 2)])
def test_find_period_is_the_originals(period, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(500)
    sig = (np.sin(2 * np.pi * t / period + 0.3) + 0.01 * rng.standard_normal(500)).astype(
        np.float32)
    assert pbasis.find_period(sig) == jbasis.find_period(sig)
    for a, b in zip(pbasis.find_peaks(sig), jbasis.find_peaks(sig)):
        _same(a, b)


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("mode40", [True, False])
def test_oracle_encoder_is_the_originals(mode40, overlap):
    """encode_series with a trailing partial window, and the tiny record's lastStep
    frame, in all four variants, with the shifted tables once."""
    for period, h, steps, shifted in ((11.0, 2, 4 * 11 + 3, False), (16.0, 1, 9, False),
                                      (8.0, 3, 3 * 8, True)):
        n = 37
        x = real_series(steps, n, period, seed=int(period))
        mine = poracle.OracleEncoder(pbasis.generate_basis(period, 1, h), n, shifted=shifted,
                                     mode40=mode40, overlap=overlap, total_steps=steps)
        ref = joracle.OracleEncoder(jbasis.generate_basis(period, 1, h), n, shifted=shifted,
                                    mode40=mode40, overlap=overlap, total_steps=steps)
        fm, fr = mine.encode_series(x), ref.encode_series(x)
        assert len(fm) == len(fr) == max(steps // mine.basis.o_size, 1)
        for a, b in zip(fm, fr):
            for pa, pb in zip(a, b):
                _same(pa, pb)
        keys = ("hdr1", "mr1", "mi1", "hdr2", "mr2", "mi2") if mode40 else \
            ("acc1_re", "acc1_im", "acc2_re", "acc2_im")
        for k in keys:
            _same(getattr(mine, k), getattr(ref, k))
        assert (mine.sampled_step, mine.compressed_step) == \
            (ref.sampled_step, ref.compressed_step)


@pytest.mark.parametrize("e", [jbasis.MAX_EXP_P, jbasis.MAX_EXP_U])
def test_encode40_decode40_and_wire_are_the_originals(e):
    rng = np.random.default_rng(e)
    re = (rng.standard_normal(4000) * 10.0 ** rng.integers(-8, 8, 4000)).astype(np.float32)
    im = (rng.standard_normal(4000) * 10.0 ** rng.integers(-8, 8, 4000)).astype(np.float32)
    re[:3], im[:3] = (0.0, -0.0, np.float32(3e38)), (np.float32(1e-30), 0.0, -1.0)
    mine, ref = poracle.encode40(re, im, e), joracle.encode40(re, im, e)
    for a, b in zip(mine, ref):
        _same(a, b)
    for a, b in zip(poracle.decode40(*mine, e), joracle.decode40(*ref, e)):
        np.testing.assert_array_equal(bits(a), bits(b))
    raw_m, raw_r = poracle.soa_to_bytes(*mine), joracle.soa_to_bytes(*ref)
    _same(raw_m, raw_r)
    for a, b, c in zip(poracle.bytes_to_soa(raw_m), joracle.bytes_to_soa(raw_r), ref):
        _same(a, b)
        _same(a, c)
    for width in (8, 16, 24, 32, 40):
        m_bits = {8: 1, 16: 5, 24: 9, 32: 13, 40: 17}[width] - (1 if width == 40 else 0)
        h = mine[0]
        r = (mine[1].astype(np.uint32) & ((1 << m_bits) - 1))
        i = (mine[2].astype(np.uint32) & ((1 << m_bits) - 1))
        wm, wr = poracle.pack_wire(h, r, i, width), joracle.pack_wire(h, r, i, width)
        _same(wm, wr)
        for a, b in zip(poracle.unpack_wire(wm, width), joracle.unpack_wire(wr, width)):
            _same(a, b)


@pytest.mark.parametrize("n_steps", [9 * 20, 9 * 20 - 7, 3 * 20, 1])
def test_reconstruct_is_the_originals(n_steps):
    period, h, n = 20.0, 2, 23
    bm, br = pbasis.generate_basis(period, 1, h), jbasis.generate_basis(period, 1, h)
    x = real_series(9 * 20, n, period, seed=5)
    frames = joracle.OracleEncoder(br, n, total_steps=x.shape[0]).encode_series(x)
    f_re = np.stack([f[0] for f in frames])
    f_im = np.stack([f[1] for f in frames])
    for shifted in (False, True):
        got = poracle.reconstruct(f_re, f_im, bm, shifted, n_steps)
        want = joracle.reconstruct(f_re, f_im, br, shifted, n_steps)
        np.testing.assert_array_equal(bits(got), bits(want))
    with pytest.raises(ValueError):
        poracle.reconstruct(np.swapaxes(f_re, 1, 2), np.swapaxes(f_im, 1, 2), bm, False, 4)
