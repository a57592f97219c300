"""The port's CUDA kernels on the card (each test skips, with its reason, without one).

This file imports no jax, so it also runs on a GPU machine without JAX; there, from the
repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from kwave_tpu import oracle
from kwave_tpu.basis import MAX_EXP_P, generate_basis
from kwave_tpu_torch import bitpack, encoder
from kwave_tpu_torch.ops import encode_window as ew
from torch_helpers import bits, real_series, require_cuda, stacked_tables

N = 200  # not a multiple of 32 or 128: the kernels mask the ragged edge


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("mode40", [True, False])
def test_kernel_matches_plain(mode40, overlap):
    """Each kernel equals its plain version bit for bit on the card, for both parities,
    the mirror on and off, H = 1 and 3, and a trailing partial window."""
    dev = require_cuda()
    rng = np.random.default_rng(17)
    for h in (1, 3):
        basis = generate_basis(16.0, 1, h, normalize=True)
        o = basis.o_size
        tabs = torch.from_numpy(stacked_tables(basis)).to(dev)
        for steps, parity, mirror in ((o, 0, 1), (o, 1, 1), (o, 1, 0), (o, 0, 0),
                                      (o - 5, 1, 0)):
            chunk = torch.from_numpy(real_series(steps, N, 16.0, seed=steps)).to(dev)
            vals = [torch.from_numpy((1e5 * rng.standard_normal((h, N))).astype(
                np.float32)).to(dev) for _ in range(4)]
            if mode40:
                planes = (bitpack.encode40(vals[0], vals[1], MAX_EXP_P)
                          + bitpack.encode40(vals[2], vals[3], MAX_EXP_P))
                planes = tuple(p.contiguous() for p in planes[: 6 if overlap else 3])
                args = (chunk, tabs, planes, MAX_EXP_P, parity, mirror, overlap)
                got = ew.encode_window_40b_exact(*args)
                want = ew.encode_window_40b_exact_plain(*args)
            else:
                planes = tuple(vals[: 4 if overlap else 2])
                args = (chunk, tabs, planes, parity, mirror, overlap)
                got = ew.encode_window_float_exact(*args)
                want = ew.encode_window_float_exact_plain(*args)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("mode40", [True, False])
def test_encoder_on_the_card_matches_oracle(mode40, overlap):
    """encode_chunk windows plus a tail through accumulate_chunk and the lastStep
    emit_partial, all on the card, against the oracle bit for bit."""
    dev = require_cuda()
    basis = generate_basis(11.0, 1, 2, normalize=True)
    o = basis.o_size
    x = real_series(4 * o + 3, N, 11.0, seed=4)
    cfg = encoder.EncoderConfig.for_stream(basis, False, mode40, overlap)
    tables = encoder.make_tables(basis, False, dev)
    st = encoder.init_state(cfg, N, dev)
    before = dict(ew.LAUNCHES)
    frames = []
    for w in range(4):
        st, fr = encoder.encode_chunk(st, torch.from_numpy(x[w * o:(w + 1) * o]).to(dev),
                                      cfg, tables)
        frames.append(fr)
    st = encoder.accumulate_chunk(st, torch.from_numpy(x[4 * o:]).to(dev), cfg, tables)
    key = ("w40" if mode40 else "wfloat") + ("_overlap" if overlap else "_no_overlap")
    assert ew.LAUNCHES[key] - before[key] == 5
    frames_o = oracle.OracleEncoder(basis, N, mode40=mode40, overlap=overlap,
                                    total_steps=x.shape[0]).encode_series(x)
    assert len(frames_o) == 4
    for fr, fo in zip(frames, frames_o):
        for a, b in zip(fr, fo):
            np.testing.assert_array_equal(bits(a.T.contiguous()),
                                          bits(b.astype(np.uint32) if mode40 else b))


# ---------------------------------------------------------------------------
# Fast-path codec kernels (csrc/fastpath.cu): K5 encode, K6 one-window, K4 decode
# ---------------------------------------------------------------------------

# (period, H, windows, extra steps, N): the shapes of tests/test_fastpath_ops.py, N ragged
FAST_SHAPES = [(20.0, 2, 10, 0, 300), (20.0, 1, 7, 0, 128), (14.0, 4, 7, 1, 200),
               (17.0, 5, 6, 2, 144), (20.0, 6, 5, 0, 130)]
# kernel vs plain: both fp32 with their own summation order; measured ~2e-7 of the peak
# against a float64 projection on the CPU
REL_TOL = 1e-6


def _half_tables(basis):
    o = basis.o_size
    be_re, be_im, _, _ = basis.tables(False)
    tab = np.concatenate([be_re[:, : 2 * o].T, be_im[:, : 2 * o].T], axis=1)  # [2o, 2H]
    tab4 = np.concatenate([tab[o:, :basis.harmonics], tab[o:, basis.harmonics:],
                           tab[:o, :basis.harmonics], tab[:o, basis.harmonics:]], axis=1)
    return tab.astype(np.float32), tab4.astype(np.float32)


def _close(got, want, rel=REL_TOL):
    got, want = got.double().cpu(), want.double().cpu()
    peak = float(want.abs().max())
    assert float((got - want).abs().max()) <= rel * peak


@pytest.mark.cuda
@pytest.mark.parametrize("period,h,windows,extra,n", FAST_SHAPES)
def test_projection_kernel_matches_plain(period, h, windows, extra, n):
    """K5 (both entries) against its plain version and a float64 projection; the flat
    and 3D entries bit-identical; K6 window by window equal to K5's frames bit for bit;
    dyadic data bit-exact against the plain version."""
    from kwave_tpu_torch.ops import fastpath

    dev = require_cuda()
    basis = generate_basis(period, 1, h, normalize=True)
    o = basis.o_size
    tab, _ = _half_tables(basis)
    lo, hi = (torch.from_numpy(t).to(dev) for t in (tab[:o], tab[o:]))
    x = torch.from_numpy(real_series(o * windows + extra, n, period, seed=3)).to(dev)
    before = dict(fastpath.LAUNCHES)
    flat = fastpath.encode_frames_flat(x, lo, hi, o)
    three_d = fastpath.encode_frames(x, lo, hi, o)
    assert fastpath.LAUNCHES["encode_frames_flat"] == before["encode_frames_flat"] + 1
    assert fastpath.LAUNCHES["encode_frames"] == before["encode_frames"] + 1
    np.testing.assert_array_equal(bits(flat), bits(three_d))
    _close(flat, fastpath.encode_frames_plain(x, lo, hi, o))
    ref64 = fastpath.encode_frames_plain(x.double(), lo.double(), hi.double(), o)
    _close(flat, ref64)

    p1 = torch.zeros((2 * h, n), device=dev)
    for w in range(windows):
        frame, p1 = ew.encode_window_float(x[w * o:(w + 1) * o], lo, hi, p1,
                                           first_window=(w == 0))
        np.testing.assert_array_equal(bits(frame), bits(flat[w]), err_msg=f"window {w}")

    xd = torch.from_numpy(np.random.default_rng(5).integers(
        -8, 9, (o * windows + extra, n)).astype(np.float32)).to(dev)
    lod, hid = (torch.from_numpy((np.random.default_rng(s).integers(
        -7, 8, (o, 2 * h)) / 32.0).astype(np.float32)).to(dev) for s in (0, 1))
    np.testing.assert_array_equal(bits(fastpath.encode_frames_flat(xd, lod, hid, o)),
                                  bits(fastpath.encode_frames_plain(xd, lod, hid, o)))


@pytest.mark.cuda
@pytest.mark.parametrize("k_frames,windows,extra", [
    (12, 12, -7), (12, 5, 0), (4, 6, 0), (1, 1, 0), (12, 0, 1), (10, 10, 0)])
def test_synthesis_kernel_matches_plain(k_frames, windows, extra):
    """K4 (both entries) on the decode boundary cases of tests/test_fastpath_ops.py
    (n_steps = windows * o + extra) and a ragged N: against its plain version and
    kwave_tpu.oracle.reconstruct, flat == 3D bit for bit, dyadic data bit-exact."""
    from kwave_tpu_torch.ops import fastpath

    dev = require_cuda()
    basis = generate_basis(20.0, 1, 2, normalize=True)
    o, h, n = basis.o_size, basis.harmonics, 160 + 37
    n_steps = windows * o + extra
    tab, tab4 = (torch.from_numpy(t).to(dev) for t in _half_tables(basis))
    x = torch.from_numpy(real_series(o * 12, n, 20.0, seed=11)).to(dev)
    frames = fastpath.encode_frames_plain(x, tab[:o], tab[o:], o)[:k_frames].contiguous()
    before = dict(fastpath.LAUNCHES)
    flat = fastpath.reconstruct_series_flat(frames, tab4, o, n_steps)
    three_d = fastpath.reconstruct_series(frames, tab4, o, n_steps)
    assert fastpath.LAUNCHES["reconstruct_series_flat"] == \
        before["reconstruct_series_flat"] + 1
    assert flat.shape == (n_steps, n)
    np.testing.assert_array_equal(bits(flat), bits(three_d))
    _close(flat, fastpath.reconstruct_series_plain(frames, tab4, o, n_steps))
    f = frames.cpu().numpy()
    want = oracle.reconstruct(np.swapaxes(f[:, :h], 1, 2), np.swapaxes(f[:, h:], 1, 2),
                              basis, False, n_steps)
    _close(flat, torch.from_numpy(want), rel=4 * REL_TOL)

    fd = torch.from_numpy(np.random.default_rng(2).integers(
        -64, 65, tuple(frames.shape)).astype(np.float32)).to(dev)
    td = torch.from_numpy((np.random.default_rng(3).integers(
        -7, 8, tuple(tab4.shape)) / 32.0).astype(np.float32)).to(dev)
    np.testing.assert_array_equal(
        bits(fastpath.reconstruct_series_flat(fd, td, o, n_steps, normalized=False)),
        bits(fastpath.reconstruct_series_plain(fd, td, o, n_steps, normalized=False)))


@pytest.mark.cuda
def test_codec_round_trip_on_the_card():
    """encoder.encode_series_frames -> decoder.reconstruct_frames on the card: one launch
    of each kernel, frames against the oracle's float encoder, the round-trip guard."""
    from kwave_tpu_torch import decoder
    from kwave_tpu_torch.ops import fastpath

    dev = require_cuda()
    basis = generate_basis(20.0, 1, 2, normalize=True)
    o, h = basis.o_size, basis.harmonics
    x = real_series(o * 9, N, 20.0, seed=6)
    before = dict(fastpath.LAUNCHES)
    frames = encoder.encode_series_frames(torch.from_numpy(x).to(dev), basis)
    tables = encoder.make_tables(basis, False, dev)
    rec = decoder.reconstruct_frames(frames, tables["be_re"], tables["be_im"], o, o * 9)
    assert fastpath.LAUNCHES["encode_frames_flat"] - before["encode_frames_flat"] == 1
    assert fastpath.LAUNCHES["reconstruct_series_flat"] - \
        before["reconstruct_series_flat"] == 1
    frames_o = oracle.OracleEncoder(basis, N, total_steps=x.shape[0]).encode_series(x)
    want = torch.from_numpy(np.stack([np.concatenate([fr.T, fi.T]) for fr, fi in frames_o]))
    _close(frames, want, rel=4 * REL_TOL)
    mid = slice(2 * o, 7 * o)
    xt = torch.from_numpy(x).to(dev)
    err = float((rec[mid] - xt[mid]).abs().max() / xt.abs().max())
    assert err < 0.05  # the noise term (1% of the amplitude) is not representable
