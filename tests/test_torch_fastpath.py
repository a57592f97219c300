"""kwave_tpu_torch.ops.fastpath (the plain versions of K4/K5, which the CPU path runs) and
ops.encode_window.encode_window_float (K6) against kwave_tpu.ops.fastpath and
encode_pallas.encode_window_float, run in interpret mode as the JAX package's own tests
run them.

Tolerances: dyadic data (table entries k/32, integer samples) is bit-exact, since every
partial sum is exact in fp32; real data at amplitude 1e5 within the JAX suite's own
bounds: frames rtol 1e-6 / atol 1e-2, reconstructions rtol 1e-5 / atol 1e-2
(tests/test_fastpath_ops.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kwave_tpu.basis import generate_basis
from kwave_tpu.ops import encode_pallas as jep
from kwave_tpu.ops import fastpath as jfp
from kwave_tpu_torch.ops import encode_window as ew
from kwave_tpu_torch.ops import fastpath as fp
from torch_helpers import bits, real_series

# (period, H, windows, extra steps, N): the shapes of tests/test_fastpath_ops.py
SHAPES = [(20.0, 2, 10, 0, 300), (20.0, 1, 7, 0, 128), (14.0, 4, 7, 1, 200),
          (17.0, 5, 6, 2, 144), (20.0, 6, 5, 0, 130)]
# (frames kept, steps reconstructed = windows * o + extra): tests/test_fastpath_ops.py:192-198
BOUNDARY = [
    (12, 12, -7),  # partial tail window
    (12, 5, 0),  # many more frames than reconstructed steps
    (4, 6, 0),  # coverage beyond the frames: a zero tail
    (1, 1, 0),  # single window
    (12, 0, 1),  # single step
]


def _tables(basis):
    """tab [2o, 2H] = [bE_re | bE_im] and tab4 [o, 4H] = [late re|im | early re|im]."""
    o = basis.o_size
    be_re, be_im, _, _ = basis.tables(False)
    tab_re, tab_im = be_re[:, : 2 * o].T, be_im[:, : 2 * o].T
    tab = np.concatenate([tab_re, tab_im], axis=1).astype(np.float32)
    tab4 = np.concatenate([tab_re[o:], tab_im[o:], tab_re[:o], tab_im[:o]],
                          axis=1).astype(np.float32)
    return tab, tab4


def _dyadic(shape, seed, lo=-8, hi=9, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.integers(lo, hi, shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("period,h,windows,extra,n", SHAPES)
def test_encode_frames_matches_jax_kernels(period, h, windows, extra, n):
    basis = generate_basis(period, 1, h, normalize=True)
    o = basis.o_size
    tab, _ = _tables(basis)
    x = real_series(o * windows + extra, n, period, seed=3)
    flat = fp.encode_frames_flat(_t(x), _t(tab[:o]), _t(tab[o:]), o)
    assert flat.shape == (windows, 2 * h, n)
    np.testing.assert_array_equal(
        bits(flat), bits(fp.encode_frames(_t(x), _t(tab[:o]), _t(tab[o:]), o)))
    args = (jnp.asarray(x), jnp.asarray(tab[:o]), jnp.asarray(tab[o:]), o)
    for want in (jfp.encode_frames_flat(*args), jfp.encode_frames(*args,
                                                                  compute="mxu_highest")):
        np.testing.assert_allclose(flat.numpy(), np.asarray(want), rtol=1e-6, atol=1e-2)


@pytest.mark.parametrize("period,h,windows,extra,n", SHAPES)
def test_encode_frames_bit_exact_on_dyadic_data(period, h, windows, extra, n):
    o = int(period) // 2
    x = _dyadic((o * windows + extra, n), seed=h)
    lo, hi = _dyadic((o, 2 * h), 1, -7, 8, 1 / 32), _dyadic((o, 2 * h), 2, -7, 8, 1 / 32)
    mine = fp.encode_frames_flat(_t(x), _t(lo), _t(hi), o)
    theirs = jfp.encode_frames_flat(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi), o)
    np.testing.assert_array_equal(bits(mine), bits(np.asarray(theirs)))


@pytest.mark.parametrize("period,h,windows,extra,n", SHAPES)
def test_reconstruct_series_matches_jax_kernels(period, h, windows, extra, n):
    basis = generate_basis(period, 1, h, normalize=True)
    o = basis.o_size
    tab, tab4 = _tables(basis)
    x = real_series(o * windows + extra, n, period, seed=4)
    frames = np.asarray(jfp.encode_frames_flat(jnp.asarray(x), jnp.asarray(tab[:o]),
                                               jnp.asarray(tab[o:]), o))
    n_steps = o * windows + extra
    mine = fp.reconstruct_series_flat(_t(frames), _t(tab4), o, n_steps)
    np.testing.assert_array_equal(
        bits(mine), bits(fp.reconstruct_series(_t(frames), _t(tab4), o, n_steps)))
    args = (jnp.asarray(frames), jnp.asarray(tab4), o, n_steps)
    for want in (jfp.reconstruct_series_flat(*args),
                 jfp.reconstruct_series(*args, compute="mxu_highest")):
        np.testing.assert_allclose(mine.numpy(), np.asarray(want), rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("k_frames,windows,extra", BOUNDARY)
def test_decode_boundary_cases_match_jax(k_frames, windows, extra):
    """Partial tail window, many more frames than steps, coverage past the frames (a zero
    tail), a single window and a single step: real data within tolerance, dyadic data
    bit for bit (normalized off, so the folded scale is exact too)."""
    basis = generate_basis(20.0, 1, 2, normalize=True)
    o = basis.o_size
    n_steps = windows * o + extra
    tab, tab4 = _tables(basis)
    x = real_series(o * 12, 160, 20.0, seed=11)
    frames = np.asarray(jfp.encode_frames(jnp.asarray(x), jnp.asarray(tab[:o]),
                                          jnp.asarray(tab[o:]), o))[:k_frames]
    mine = fp.reconstruct_series_flat(_t(frames), _t(tab4), o, n_steps)
    assert mine.shape == (n_steps, 160)
    want = jfp.reconstruct_series_flat(jnp.asarray(frames), jnp.asarray(tab4), o, n_steps)
    np.testing.assert_allclose(mine.numpy(), np.asarray(want), rtol=1e-5, atol=1e-2)

    fd, td = _dyadic((k_frames, 4, 160), 5, -64, 65), _dyadic((o, 8), 6, -7, 8, 1 / 32)
    mine = fp.reconstruct_series_flat(_t(fd), _t(td), o, n_steps, normalized=False)
    want = jfp.reconstruct_series_flat(jnp.asarray(fd), jnp.asarray(td), o, n_steps,
                                       normalized=False)
    np.testing.assert_array_equal(bits(mine), bits(np.asarray(want)))


@pytest.mark.parametrize("h,n", [(2, 200), (3, 130)])
def test_encode_window_float_matches_jax_kernel_and_k5(h, n):
    """K6 window by window against the JAX kernel (real data within tolerance), and on
    dyadic data bit for bit against both the JAX kernel and the port's K5 frames."""
    basis = generate_basis(20.0, 1, h, normalize=True)
    o, windows = basis.o_size, 5
    tab, _ = _tables(basis)
    for x, lo, hi, exact in (
            (real_series(o * windows, n, 20.0, seed=7), tab[:o], tab[o:], False),
            (_dyadic((o * windows, n), 8), _dyadic((o, 2 * h), 9, -7, 8, 1 / 32),
             _dyadic((o, 2 * h), 10, -7, 8, 1 / 32), True)):
        whole = fp.encode_frames_flat(_t(x), _t(lo), _t(hi), o)
        p1, jp1 = torch.zeros((2 * h, n)), jnp.zeros((2 * h, n), jnp.float32)
        for w in range(windows):
            chunk = x[w * o:(w + 1) * o]
            frame, p1 = ew.encode_window_float(_t(chunk), _t(lo), _t(hi), p1,
                                               first_window=(w == 0))
            jframe, jp1 = jep.encode_window_float(jnp.asarray(chunk), jnp.asarray(lo),
                                                  jnp.asarray(hi), jp1,
                                                  first_window=(w == 0))
            if exact:
                np.testing.assert_array_equal(bits(frame), bits(np.asarray(jframe)))
                np.testing.assert_array_equal(bits(p1), bits(np.asarray(jp1)))
                np.testing.assert_array_equal(bits(frame), bits(whole[w]))
            else:
                np.testing.assert_allclose(frame.numpy(), np.asarray(jframe), rtol=1e-6,
                                           atol=1e-2)
                np.testing.assert_allclose(frame.numpy(), whole[w].numpy(), rtol=1e-6,
                                           atol=1e-2)


@pytest.mark.parametrize("h,n", [(1, 128), (2, 131), (3, 77)])
def test_encode_window_float_within_1e6_of_the_frame_peak(h, n):
    """K6 window by window against the JAX kernel (interpret mode) and against the port's
    whole-series frames, each within 1e-6 of the frame peak; P1 carried between windows
    the same way."""
    basis = generate_basis(16.0, 1, h, normalize=True)
    o, windows = basis.o_size, 4
    tab, _ = _tables(basis)
    lo, hi = tab[:o], tab[o:]
    x = real_series(o * windows, n, 16.0, seed=h)
    whole = fp.encode_frames_flat(_t(x), _t(lo), _t(hi), o).numpy()
    p1, jp1 = torch.zeros((2 * h, n)), jnp.zeros((2 * h, n), jnp.float32)
    for w in range(windows):
        chunk = x[w * o:(w + 1) * o]
        frame, p1 = ew.encode_window_float(_t(chunk), _t(lo), _t(hi), p1,
                                           first_window=(w == 0))
        jframe, jp1 = jep.encode_window_float(jnp.asarray(chunk), jnp.asarray(lo),
                                              jnp.asarray(hi), jp1, first_window=(w == 0))
        peak = float(np.abs(np.asarray(jframe)).max())
        assert float(np.abs(frame.numpy() - np.asarray(jframe)).max()) <= 1e-6 * peak
        assert float(np.abs(frame.numpy() - whole[w]).max()) <= 1e-6 * peak
        assert float(np.abs(p1.numpy() - np.asarray(jp1)).max()) <= 1e-6 * peak


def test_non_contiguous_half_tables_give_the_same_frames():
    """Column slices of a joined table (not contiguous) against contiguous copies."""
    basis = generate_basis(20.0, 1, 2, normalize=True)
    o = basis.o_size
    tab, _ = _tables(basis)
    joined = _t(np.concatenate([tab[:o], tab[o:]], axis=1))  # [o, 4H]
    lo, hi = joined[:, :4], joined[:, 4:]
    assert not lo.is_contiguous()
    x = _t(real_series(o * 3, 40, 20.0, seed=2))
    np.testing.assert_array_equal(
        bits(fp.encode_frames_flat(x, lo, hi, o)),
        bits(fp.encode_frames_flat(x, lo.contiguous(), hi.contiguous(), o)))
    for t in fp.as_contiguous(lo, hi, x):
        assert t.is_contiguous()
    assert fp.as_contiguous(x)[0] is x


def test_wrappers_refuse_what_the_kernels_do_not_take():
    o = 10
    x, lo = torch.zeros((3 * o, 8)), torch.zeros((o, 4))
    with pytest.raises(ValueError, match="split3"):
        fp.encode_frames_flat(x, lo, lo, o, precision="split3")
    with pytest.raises(ValueError, match="default"):
        fp.reconstruct_series_flat(torch.zeros((3, 4, 8)), torch.zeros((o, 8)), o, 30,
                                   precision="default")
    with pytest.raises(ValueError, match="bogus"):
        fp.encode_frames(x, lo, lo, o, compute="bogus")
    with pytest.raises(ValueError, match="no window"):
        fp.encode_frames_flat(x[: o - 1], lo, lo, o)
    with pytest.raises(ValueError, match=r"tab_lo/tab_hi \[o=10, 2H\]"):
        fp.encode_frames_flat(x, lo[:, :3], lo[:, :3], o)
    with pytest.raises(ValueError, match="float32"):
        fp.encode_frames_flat(x.double(), lo, lo, o)
    with pytest.raises(ValueError, match="n_steps"):
        fp.reconstruct_series_flat(torch.zeros((3, 4, 8)), torch.zeros((o, 8)), o, 0)
    with pytest.raises(ValueError, match="p1_prev"):
        ew.encode_window_float(x[:o], lo, lo, torch.zeros((4, 7)))


def test_plain_versions_count_no_launches():
    before = (dict(fp.LAUNCHES), dict(ew.LAUNCHES))
    o = 10
    x, lo = torch.ones((3 * o, 8)), torch.ones((o, 4))
    frames = fp.encode_frames_flat(x, lo, lo, o)
    fp.reconstruct_series(frames, torch.ones((o, 8)), o, 3 * o)
    ew.encode_window_float(x[:o], lo, lo, torch.zeros((4, 8)), first_window=True)
    assert (dict(fp.LAUNCHES), dict(ew.LAUNCHES)) == before
