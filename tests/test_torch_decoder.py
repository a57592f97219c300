"""kwave_tpu_torch.decoder against kwave_tpu.decoder (both of its paths: the jnp einsum
and, with ``encoder.USE_PALLAS`` set, the Pallas kernels in interpret mode) and against
kwave_tpu.oracle.

Tolerances: the integer unpacks (`decode_frames_40b`, `decode_40bit_rows`) are bit-exact;
dyadic frames reconstruct bit for bit; real data at amplitude 1e5 within rtol 1e-5 /
atol 1e-2 of JAX (tests/test_fastpath_ops.py:57) and 1e-6 of the series peak of the
oracle (fp32 sums in another order); intensities within rtol 1e-6, or 1e-6 of their
peak where the products cancel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kwave_tpu import decoder as jdec
from kwave_tpu import encoder as jenc
from kwave_tpu import oracle
from kwave_tpu.basis import MAX_EXP_P, MAX_EXP_U, generate_basis
from kwave_tpu_torch import bitpack, decoder, encoder
from torch_helpers import bits, dyadic_basis, dyadic_series, real_series

N = 150


def _frames(basis, steps, seed, shifted=False):
    """Port fast-path frames [K, 2H, N] of a real series (torch, CPU)."""
    x = real_series(steps, N, basis.period, seed=seed)
    return encoder.encode_series_frames(torch.from_numpy(x), basis, shifted)


def _tables(basis, shifted=False):
    t = encoder.make_tables(basis, shifted)
    return t["be_re"], t["be_im"]


def test_decode_frames_40b_bit_exact():
    rng = np.random.default_rng(3)
    planes = [rng.integers(0, hi, (4, 2, 64)).astype(np.uint32)
              for hi in (256, 65536, 65536)]
    for e in (MAX_EXP_P, MAX_EXP_U):
        mine = decoder.decode_frames_40b(*(torch.from_numpy(p.view(np.int32))
                                           for p in planes), e)
        theirs = jdec.decode_frames_40b(*(jnp.asarray(p) for p in planes), e)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(bits(a), bits(np.asarray(b)))


@pytest.mark.parametrize("harmonics,n", [(2, 16), (1, 13), (3, 7)])
def test_decode_40bit_rows_bit_exact(harmonics, n):
    """Oracle-encoded frames serialised as the writer does (5-byte AoS rows padded to
    mSize floats), unpacked by both packages."""
    basis = generate_basis(10.0, 1, harmonics)
    x = real_series(40, n, 10.0, seed=harmonics)
    frames = oracle.OracleEncoder(basis, n, mode40=True, total_steps=40).encode_series(x)
    rows = np.zeros((len(frames), int(np.ceil(n * 1.25)) * harmonics), np.float32)
    for c, (hdr, mr, mi) in enumerate(frames):
        by = oracle.soa_to_bytes(hdr.reshape(-1), mr.reshape(-1), mi.reshape(-1))
        rows[c].view(np.uint8)[: by.size] = by
    mine = decoder.decode_40bit_rows(rows, harmonics, MAX_EXP_P)
    theirs = jdec.decode_40bit_rows(rows, harmonics, MAX_EXP_P)
    assert mine[0].shape == (len(frames), n, harmonics)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(bits(a), bits(b))
    re_o, im_o = oracle.decode40(*(np.stack(p) for p in zip(*frames)), MAX_EXP_P)
    np.testing.assert_array_equal(bits(mine[0]), bits(re_o))
    np.testing.assert_array_equal(bits(mine[1]), bits(im_o))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("n_steps_of", ["whole", "tail", "past"])
def test_reconstruct_frames_matches_jax(monkeypatch, use_pallas, n_steps_of):
    monkeypatch.setattr(jenc, "USE_PALLAS", use_pallas)
    basis = generate_basis(20.0, 1, 2, normalize=True)
    o = basis.o_size
    frames = _frames(basis, 8 * o + 3, seed=1)
    n_steps = {"whole": 8 * o + 3, "tail": 8 * o - 7, "past": 10 * o}[n_steps_of]
    be_re, be_im = _tables(basis)
    mine = decoder.reconstruct_frames(frames, be_re, be_im, o, n_steps)
    theirs = jdec.reconstruct_frames(jnp.asarray(frames.numpy()), jnp.asarray(be_re.numpy()),
                                     jnp.asarray(be_im.numpy()), o, n_steps)
    assert mine.shape == (n_steps, N)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-2)
    h = basis.harmonics
    split = decoder.reconstruct(frames[:, :h], frames[:, h:], be_re, be_im, o, n_steps)
    np.testing.assert_array_equal(bits(split), bits(mine))
    vpu = decoder.reconstruct_frames(frames, be_re, be_im, o, n_steps, compute="vpu")
    np.testing.assert_array_equal(bits(vpu), bits(mine))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("shifted", [False, True])
def test_reconstruct_bit_exact_on_dyadic_frames(monkeypatch, use_pallas, shifted):
    monkeypatch.setattr(jenc, "USE_PALLAS", use_pallas)
    basis = dyadic_basis(o=8, harmonics=2)  # normalized=False: no scale to round
    f_re, f_im = (dyadic_series(6 * 2, N, seed=s, scale=4.0).reshape(6, 2, N)
                  for s in (1, 2))
    be_re, be_im = _tables(basis, shifted)
    mine = decoder.reconstruct(torch.from_numpy(f_re), torch.from_numpy(f_im), be_re,
                               be_im, 8, 6 * 8 - 3, normalized=False)
    theirs = jdec.reconstruct(jnp.asarray(f_re), jnp.asarray(f_im),
                              jnp.asarray(be_re.numpy()), jnp.asarray(be_im.numpy()), 8,
                              6 * 8 - 3, normalized=False)
    np.testing.assert_array_equal(bits(mine), bits(np.asarray(theirs)))


@pytest.mark.parametrize("harmonics,period", [(1, 16.0), (2, 20.0), (3, 14.0)])
def test_reconstruct_series_matches_jax_and_oracle(harmonics, period):
    basis = generate_basis(period, 1, harmonics, normalize=True)
    o = basis.o_size
    steps = 9 * o + 2
    frames = _frames(basis, steps, seed=harmonics).numpy()
    f_re, f_im = frames[:, :harmonics], frames[:, harmonics:]
    mine = decoder.reconstruct_series(f_re, f_im, basis, False, steps)
    assert isinstance(mine, torch.Tensor) and mine.device.type == "cpu"
    theirs = jdec.reconstruct_series(f_re, f_im, basis, False, steps)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-2)
    want = oracle.reconstruct(np.swapaxes(f_re, 1, 2), np.swapaxes(f_im, 1, 2), basis,
                              False, steps)
    np.testing.assert_allclose(mine.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_round_trip_accuracy_mid_record():
    """Encode then decode a band-limited series: the interior comes back within 2 %
    (the guard of bench.py)."""
    basis = generate_basis(20.0, 1, 2, normalize=True)
    o = basis.o_size
    t = np.arange(12 * o, dtype=np.float32)[:, None]
    ph = np.random.default_rng(6).uniform(0, 2 * np.pi, N).astype(np.float32)
    x = (1e5 * np.sin(2 * np.pi * t / 20.0 + ph)
         + 1e4 * np.sin(4 * np.pi * t / 20.0 + 1.7 * ph)).astype(np.float32)
    frames = encoder.encode_series_frames(torch.from_numpy(x), basis)
    rec = decoder.reconstruct_frames(frames, *_tables(basis), o, 12 * o).numpy()
    mid = slice(2 * o, 10 * o)
    assert np.abs(rec[mid] - x[mid]).max() / np.abs(x).max() < 0.02


def test_avg_intensity_matches_jax():
    basis = generate_basis(16.0, 1, 3, normalize=True)
    o = basis.o_size
    p = _frames(basis, 8 * o, seed=1).numpy()
    u = (_frames(basis, 8 * o, seed=2, shifted=True) * 1e-6).numpy()
    h = basis.harmonics
    args = (p[:, :h], p[:, h:], u[:, :h], u[:, h:])
    mine = decoder.avg_intensity_frames(*map(torch.from_numpy, args))
    theirs = jdec.avg_intensity_frames(*map(jnp.asarray, args))
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-6)
    acc, jacc = torch.zeros(N), jnp.zeros(N, jnp.float32)
    for c in range(p.shape[0]):
        frame = [a[c] for a in args]
        acc = decoder.avg_intensity_update(acc, *map(torch.from_numpy, frame))
        jacc = jdec.avg_intensity_update(jacc, *map(jnp.asarray, frame))
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-6)
    np.testing.assert_allclose(acc.numpy() / p.shape[0], mine.numpy(), rtol=1e-5)


def test_avg_intensity_40b_matches_jax():
    rng = np.random.default_rng(9)
    p_f = [torch.from_numpy((1e5 * rng.standard_normal((5, 2, N))).astype(np.float32))
           for _ in range(2)]
    u_f = [torch.from_numpy((0.1 * rng.standard_normal((5, 2, N))).astype(np.float32))
           for _ in range(2)]
    p_planes = bitpack.encode40(*p_f, MAX_EXP_P)
    u_planes = bitpack.encode40(*u_f, MAX_EXP_U)
    mine = decoder.avg_intensity_40b(p_planes, u_planes)
    theirs = np.asarray(jdec.avg_intensity_40b(
        tuple(jnp.asarray(bits(a)) for a in p_planes),
        tuple(jnp.asarray(bits(a)) for a in u_planes)))
    # the decoded planes are bit-exact; the sums of cancelling products are not
    np.testing.assert_allclose(mine.numpy(), theirs, rtol=0,
                               atol=1e-6 * np.abs(theirs).max())
