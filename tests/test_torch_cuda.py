"""The port's CUDA kernels on the card (each test skips, with its reason, without one).

This file imports no jax, so it also runs on a GPU machine without JAX; there, from the
repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports jax; the ``cuda`` marker it registers
is then unknown, which pytest only warns about.)
"""

import itertools
import types

import numpy as np
import pytest
import torch

from kwave_tpu_torch import oracle
from kwave_tpu_torch.basis import MAX_EXP_P, generate_basis
from kwave_tpu_torch import bitpack, encoder
from kwave_tpu_torch.ops import encode_window as ew
from kwave_tpu_torch.ops import zfuse as zfuse_mod
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


def _words(rng, h, n, n_acc, dev):
    """Accumulator words that hold large, small, zero and saturated values."""
    planes = []
    for _ in range(n_acc):
        scale = torch.from_numpy(10.0 ** rng.integers(-3, 9, (h, n))).float()
        re = torch.from_numpy(rng.standard_normal((h, n))).float() * scale
        im = torch.from_numpy(rng.standard_normal((h, n))).float() * scale.flip(1)
        re[:, ::7] = 0.0
        planes += [p.contiguous().to(dev) for p in bitpack.encode40(re, im, MAX_EXP_P)]
    return tuple(planes)


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [True, False])
def test_w40_kernel_matches_plain_and_the_reference_loop(overlap):
    """The 40-bit window kernel as the wrapper launches it (with overlap one lane a buffer,
    without one thread a sensor): bit-identical to the plain version and to the
    reference's loop as written, at H = 1..3, both parities, the mirror, a partial window,
    one step, and N ragged against the warp (16 or 32 sensors) and the block."""
    dev = require_cuda()
    rng = np.random.default_rng(23)
    for h in (1, 2, 3):
        basis = generate_basis(16.0, 1, h, normalize=True)
        o = basis.o_size
        tabs = torch.from_numpy(stacked_tables(basis)).to(dev)
        for n in (N, 16384 - 37, 17):
            planes = _words(rng, h, n, 2 if overlap else 1, dev)
            for steps, parity, mirror in ((o, 0, 1), (o, 1, 0), (o - 5, 1, 0), (1, 0, 0)):
                chunk = torch.from_numpy(real_series(steps, n, 16.0, seed=steps)).to(dev)
                args = (chunk, tabs, planes, MAX_EXP_P, parity, mirror, overlap)
                got = ew._kernel_40b(*args)
                torch.cuda.synchronize()
                want = ew.encode_window_40b_exact_plain(*args)
                unsplit = ew.encode_window_40b_exact_unsplit_plain(*args)
                for a, b, c in zip(got, want, unsplit):
                    np.testing.assert_array_equal(bits(a), bits(b))
                    np.testing.assert_array_equal(bits(a), bits(c))


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [True, False])
def test_w40_kernel_matches_plain_on_edge_values(overlap):
    """Samples over 100 binades (zeros and denormals among them) against table entries
    that put the two halves of an accumulator up to 30 binades apart: values far below the
    word's range, inside it and saturated, with the following steps adding to what the
    step between the words (quant40) left. Kernel == plain == the reference's loop."""
    dev = require_cuda()
    rng = np.random.default_rng(31)
    o, h, n = 6, 16, 4099
    gaps = 2.0 ** -rng.integers(0, 31, (2 * o, 4 * h))
    tabs = torch.from_numpy((rng.choice([-1.0, 1.0], gaps.shape) * gaps
                             * rng.uniform(0.5, 1.0, gaps.shape)).astype(np.float32)).to(dev)
    mag = 2.0 ** rng.integers(-60, 41, (o, n)) * rng.uniform(1.0, 2.0, (o, n))
    x = (rng.choice([-1.0, 1.0], mag.shape) * mag).astype(np.float32)
    x[:, ::11] = 0.0
    x[2, ::5] = 1e-40  # denormal
    chunk = torch.from_numpy(x).to(dev)
    planes = _words(rng, h, n, 2 if overlap else 1, dev)
    for parity, mirror in ((0, 1), (1, 0)):
        args = (chunk, tabs, planes, MAX_EXP_P, parity, mirror, overlap)
        got = ew.encode_window_40b_exact(*args)
        torch.cuda.synchronize()
        want = ew.encode_window_40b_exact_plain(*args)
        unsplit = ew.encode_window_40b_exact_unsplit_plain(*args)
        for a, b, c in zip(got, want, unsplit):
            np.testing.assert_array_equal(bits(a), bits(b))
            np.testing.assert_array_equal(bits(a), bits(c))


@pytest.mark.cuda
def test_w40_kernel_refuses_what_it_does_not_take():
    dev = require_cuda()
    basis = generate_basis(16.0, 1, 1, normalize=True)
    tabs = torch.from_numpy(stacked_tables(basis)).to(dev)
    chunk = torch.zeros((basis.o_size, N), device=dev)
    planes = tuple(torch.zeros((1, N), dtype=torch.int32, device=dev) for _ in range(6))
    with pytest.raises(RuntimeError, match="cudaError"):
        ew._kernel_40b(chunk, tabs, planes, ew.MAX_E_CONST + 1, 0, 0, True)
    torch.cuda.synchronize()


def _device_events(fn):
    """Name -> count of everything the device ran during one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")}


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["encode_frames_flat", "encode_frames",
                                   "encode_window_float"])
def test_encode_entries_launch_their_kernel_and_nothing_else(entry):
    """One call of an encode entry is one kernel on the device: no copy, no concatenation
    of the half tables, no memset (torch.profiler's device events of the call)."""
    from kwave_tpu_torch.ops import fastpath

    dev = require_cuda()
    basis = generate_basis(20.0, 1, 2, normalize=True)
    o = basis.o_size
    tab, _ = _half_tables(basis)
    lo, hi = (torch.from_numpy(t).to(dev) for t in (tab[:o], tab[o:]))
    x = torch.from_numpy(real_series(o * 6, 1000, 20.0, seed=1)).to(dev)
    p1 = torch.zeros((4, 1000), device=dev)
    call, kernel = {
        "encode_frames_flat": (lambda: fastpath.encode_frames_flat(x, lo, hi, o),
                               "project_frames"),
        "encode_frames": (lambda: fastpath.encode_frames(x, lo, hi, o), "project_frames"),
        "encode_window_float": (lambda: ew.encode_window_float(x[:o], lo, hi, p1),
                                "project_window"),
    }[entry]
    events = _device_events(call)
    assert sum(events.values()) == 1 and kernel in next(iter(events)), events


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
    # C order: np.concatenate of the transposed tables gives Fortran order, and a wrapper
    # copies a table that is not contiguous (one more kernel on the device)
    return (np.ascontiguousarray(tab, dtype=np.float32),
            np.ascontiguousarray(tab4, dtype=np.float32))


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
        chunk = x[w * o:(w + 1) * o]
        frame, p1 = ew.encode_window_float(chunk, lo, hi, p1, first_window=(w == 0))
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
    kwave_tpu_torch.oracle.reconstruct, flat == 3D bit for bit, dyadic data bit-exact."""
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


# ---------------------------------------------------------------------------
# Whole-record exact encode (csrc/encode_series.cu): K3a 40-bit, K3b float
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("mode40", [True, False])
def test_series_kernel_matches_plain_window_loop_and_oracle(mode40, overlap):
    """K3a/K3b on 256 sensors, K odd, even and 1: frames and final state bit-identical to
    the plain version, to the K1/K2 window loop on the card, and to the oracle."""
    from kwave_tpu_torch.ops import encode_series as es

    dev = require_cuda()
    n = 256
    key = ("series40" if mode40 else "seriesf") + ("_overlap" if overlap else "_no_overlap")
    for h, windows in ((2, 5), (1, 4), (3, 1)):
        basis = generate_basis(11.0, 1, h, normalize=True)
        o = basis.o_size
        x_host = real_series(windows * o + 3, n, 11.0, seed=h)
        x = torch.from_numpy(x_host).to(dev)
        tabs = torch.from_numpy(stacked_tables(basis)).to(dev)
        before = es.LAUNCHES[key]
        if mode40:
            frames, state = es.encode_series_40b(x, tabs, MAX_EXP_P, o, overlap)
            pf, ps = es.encode_series_40b_plain(x, tabs, MAX_EXP_P, o, overlap)
        else:
            frames, state = es.encode_series_float_exact(x, tabs, o, overlap)
            pf, ps = es.encode_series_float_exact_plain(x, tabs, o, overlap)
        torch.cuda.synchronize()
        assert es.LAUNCHES[key] == before + 1
        for a, b in zip(frames + state, pf + ps):
            np.testing.assert_array_equal(bits(a), bits(b))
        cfg = encoder.EncoderConfig.for_stream(basis, False, mode40, overlap)
        tables = encoder.make_tables(basis, False, dev)
        st = encoder.init_state(cfg, n, dev)
        for k in range(windows):
            st, fr = encoder.encode_chunk(st, x[k * o:(k + 1) * o], cfg, tables)
            for a, b in zip(fr, frames):
                np.testing.assert_array_equal(bits(a), bits(b[k]), err_msg=f"window {k}")
        frames_o = oracle.OracleEncoder(basis, n, mode40=mode40, overlap=overlap,
                                        total_steps=x_host.shape[0]).encode_series(x_host)
        assert len(frames_o) == windows
        for k, fo in enumerate(frames_o):
            for a, b in zip(frames, fo):
                np.testing.assert_array_equal(bits(a[k].T.contiguous()),
                                              bits(b.astype(np.uint32) if mode40 else b))


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("mode40", [True, False])
@pytest.mark.parametrize("windows,g", [(7, 4), (3, 8), (9, 2), (5, 1), (6, 3)])
def test_series_kernel_chunks_match_plain_and_window_loop(mode40, overlap, windows, g):
    """K3 split into chunks of G windows a thread: K odd, K < G, K a multiple of G and
    not, chunks that start on odd and on even windows, N ragged (not a multiple of the
    block's 128 sensors): frames and final state bit-identical to the unsplit plain
    version and to the K1/K2 window loop, one launch."""
    from kwave_tpu_torch.ops import encode_series as es

    dev = require_cuda()
    n, h = 333, 2
    key = ("series40" if mode40 else "seriesf") + ("_overlap" if overlap else "_no_overlap")
    basis = generate_basis(9.0, 1, h, normalize=True)
    o = basis.o_size
    x = torch.from_numpy(real_series(windows * o + 2, n, 9.0, seed=windows)).to(dev)
    tabs = torch.from_numpy(stacked_tables(basis)).to(dev)
    before = es.LAUNCHES[key]
    if mode40:
        frames, state = es._kernel_40b(x, tabs, MAX_EXP_P, o, overlap, chunk_windows=g)
        pf, ps = es.encode_series_40b_plain(x, tabs, MAX_EXP_P, o, overlap)
    else:
        frames, state = es._kernel_float(x, tabs, o, overlap, chunk_windows=g)
        pf, ps = es.encode_series_float_exact_plain(x, tabs, o, overlap)
    torch.cuda.synchronize()
    assert es.LAUNCHES[key] == before + 1
    assert all(tuple(f.shape) == (windows, h, n) for f in frames)
    for a, b in zip(frames + state, pf + ps):
        np.testing.assert_array_equal(bits(a), bits(b))
    cfg = encoder.EncoderConfig.for_stream(basis, False, mode40, overlap)
    tables = encoder.make_tables(basis, False, dev)
    st = encoder.init_state(cfg, n, dev)
    for k in range(windows):
        st, fr = encoder.encode_chunk(st, x[k * o:(k + 1) * o], cfg, tables)
        for a, b in zip(fr, frames):
            np.testing.assert_array_equal(bits(a), bits(b[k]), err_msg=f"window {k}")
    keys = [name for name in st if name not in ("sampled_step", "compressed_step")]
    for name, plane in zip(keys, state):
        np.testing.assert_array_equal(bits(st[name]), bits(plane), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("mode40", [True, False])
def test_encode_series_exact_on_the_card_matches_oracle(mode40, overlap):
    """encode_series_exact with a trailing remainder (one K3 launch, one K1/K2 partial
    window), then encode_steps across the next saving boundary, against the oracle."""
    from kwave_tpu_torch.ops import encode_series as es

    dev = require_cuda()
    basis = generate_basis(11.0, 1, 2, normalize=True)
    o = basis.o_size
    x_host = real_series(5 * o + 1, N, 11.0, seed=8)
    steps = 4 * o + 3
    x = torch.from_numpy(x_host).to(dev)
    es_before, ew_before = dict(es.LAUNCHES), dict(ew.LAUNCHES)
    frames, st = encoder.encode_series_exact(x[:steps], basis, mode40=mode40,
                                             overlap=overlap)
    assert sum(es.LAUNCHES.values()) - sum(es_before.values()) == 1
    assert sum(ew.LAUNCHES.values()) - sum(ew_before.values()) == 1
    cfg = encoder.EncoderConfig.for_stream(basis, False, mode40, overlap)
    st, extra = encoder.encode_steps(st, x[steps:], cfg, encoder.make_tables(basis, False,
                                                                              dev))
    frames_o = oracle.OracleEncoder(basis, N, mode40=mode40, overlap=overlap,
                                    total_steps=x_host.shape[0]).encode_series(x_host)
    assert len(frames_o) == 5 and len(extra) == 1 and frames[0].shape[0] == 4
    mine = [tuple(f[k] for f in frames) for k in range(4)] + extra
    for fr, fo in zip(mine, frames_o):
        for a, b in zip(fr, fo):
            np.testing.assert_array_equal(bits(a.T.contiguous()),
                                          bits(b.astype(np.uint32) if mode40 else b))


# ---------------------------------------------------------------------------
# Fused z stage (csrc/zfuse.cu): K7
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("nz,ny,nx", [(32, 16, 256), (100, 12, 260), (256, 8, 256),
                                      (176, 12, 260), (251, 12, 260)])
@pytest.mark.parametrize("n_ops", [1, 3])
def test_zfuse_kernel_matches_plain_and_float64(nz, ny, nx, n_ops):
    """K7 at nz = 32 and 256 (the radix kernel), 100 and 176 (the mixed kernel, 176 with a
    pass of radix 11) and 251 (a prime: the Bluestein kernel), nxr = 129 and 131, one op
    and three: within 2e-6 of the peak of `apply_plain` and of a float64
    ``ifft(fft(s, 0) * op, 0)`` (measured on an H100 at most 1.3e-6 and 6.5e-7), grad with
    and without kappa, and nabla."""
    from kwave_tpu_torch.ops import zfuse

    dev = require_cuda()
    rng = np.random.default_rng(nz + n_ops)
    nxr = nx // 2 + 1
    s_host = (rng.standard_normal((nz, ny, nxr))
              + 1j * rng.standard_normal((nz, ny, nxr))).astype(np.complex64)
    k2 = [(np.fft.fftfreq(nz) * 2 * np.pi * nz / 1e-2) ** 2,
          (np.fft.fftfreq(ny) * 2 * np.pi * ny / 1e-2) ** 2,
          (np.fft.rfftfreq(nx) * 2 * np.pi * nx / 1e-2) ** 2]
    plan = zfuse.make_plan((nz, ny, nx), *k2, 1e-5, dev)
    s = torch.from_numpy(s_host).to(dev)
    k = np.sqrt(k2[0][:, None, None] + k2[1][None, :, None] + k2[2][None, None, :])
    arg = 1e-5 * k
    kappa = np.where(arg == 0, 1.0, np.sin(arg) / np.where(arg == 0, 1.0, arg))
    dd_host = [rng.standard_normal(n) + 1j * rng.standard_normal(n) for n in (nz, ny, nxr)]
    dds = [torch.from_numpy(d.astype(np.complex64)).to(dev) for d in dd_host]
    shapes = [(nz, 1, 1), (1, ny, 1), (1, 1, nxr)]
    if n_ops == 3:
        cases = [(tuple(zfuse.OpSpec("grad", axis=a) for a in (2, 1, 0)),
                  (dds[2], dds[1], dds[0]), True,
                  [kappa * dd_host[a].astype(np.complex64).reshape(shapes[a])
                   for a in (2, 1, 0)])]
    else:
        nab = np.where(k == 0, 0.0, np.where(k == 0, 1.0, k) ** -0.5)
        cases = [((zfuse.OpSpec("grad", axis=0),), (dds[0],), True,
                  [kappa * dd_host[0].astype(np.complex64).reshape(shapes[0])]),
                 ((zfuse.OpSpec("grad", axis=2),), (dds[2],), False,
                  [dd_host[2].astype(np.complex64).reshape(shapes[2])]),
                 ((zfuse.OpSpec("nabla", power=-0.5),), (), False, [nab])]
    for specs, dd, use_kappa, ops64 in cases:
        before = zfuse.LAUNCHES[f"zfuse_{n_ops}op"]
        outs = zfuse.apply(plan, s, specs, dd, use_kappa=use_kappa)
        torch.cuda.synchronize()
        assert zfuse.LAUNCHES[f"zfuse_{n_ops}op"] == before + 1
        plain = zfuse.apply_plain(plan, s, specs, dd, use_kappa=use_kappa)
        f = np.fft.fft(s_host.astype(np.complex128), axis=0)
        for got, want, op64 in zip(outs, plain, ops64):
            ref = np.fft.ifft(f * op64, axis=0)
            peak = float(np.abs(ref).max())
            assert float((got - want).abs().max()) <= 2e-6 * peak
            assert float(np.abs(got.cpu().numpy() - ref).max()) <= 2e-6 * peak


@pytest.mark.cuda
@pytest.mark.parametrize("nx", [256, 260])
@pytest.mark.parametrize("nz", [8, 16, 32, 64, 128, 256, 512, 1024])
def test_zfuse_radix_kernel(nz, nx):
    """The radix kernel at every pass plan it is built for (one, two and three passes,
    equal and unequal radices; at 8 and 16, which `kernel_for` sends to the column kernel,
    through a plan that names it), nxr = 129 and 131 (131 leaves a ragged last tile), one op
    and three, grad on each axis with and without kappa, and nabla: within 2e-6 of the
    peak of a float64 FFT, 4e-6 of `apply_plain` (the dense fp32 sum, itself up to 1.3e-6
    off float64 where the radix passes are 2e-7 off: the sum of the two bounds) and of
    `apply_radix_plain`; every launch counted as the radix kernel's."""
    import dataclasses

    from kwave_tpu_torch.ops import zfuse

    dev = require_cuda()
    ny, nxr = 8, nx // 2 + 1
    rng = np.random.default_rng(nz + nx)
    sizes = (nz, ny, nxr)
    s = torch.from_numpy((rng.standard_normal(sizes) + 1j * rng.standard_normal(sizes))
                         .astype(np.complex64)).to(dev)
    k2 = [(np.fft.fftfreq(nz) * 2 * np.pi * nz / 1e-2) ** 2,
          (np.fft.fftfreq(ny) * 2 * np.pi * ny / 1e-2) ** 2,
          (np.fft.rfftfreq(nx) * 2 * np.pi * nx / 1e-2) ** 2]
    plan = zfuse.make_plan((nz, ny, nx), *k2, 1e-5, dev)
    assert zfuse.kernel_for(nz) == ("column" if nz in zfuse.COLUMN_NZ else "radix")
    plan = dataclasses.replace(plan, **zfuse.kernel_tables(nz, "radix", dev))
    assert plan.passes == zfuse.radix_passes(nz)
    dds = [torch.from_numpy((rng.standard_normal(m) + 1j * rng.standard_normal(m))
                            .astype(np.complex64)).to(dev) for m in sizes]
    f64 = torch.fft.fft(s.to(torch.complex128), dim=0)
    cases = [(tuple(zfuse.OpSpec("grad", axis=a) for a in (2, 1, 0)), dds[::-1], True),
             ((zfuse.OpSpec("grad", axis=0),), dds[:1], False),
             ((zfuse.OpSpec("grad", axis=1), zfuse.OpSpec("nabla", power=0.5)), dds[1:2],
              True),
             ((zfuse.OpSpec("nabla", power=-0.5),), (), False)]
    for specs, dd, use_kappa in cases:
        before = dict(zfuse.KERNEL_LAUNCHES)
        outs = zfuse.apply(plan, s, specs, dd, use_kappa=use_kappa)
        torch.cuda.synchronize()
        assert zfuse.KERNEL_LAUNCHES == {**before, "radix": before["radix"] + 1}
        dense = zfuse.apply_plain(plan, s, specs, dd, use_kappa=use_kappa)
        radix = zfuse.apply_radix_plain(plan, s, specs, dd, use_kappa=use_kappa)
        dd_iter = iter(dd)
        for spec, got, want_d, want_r in zip(specs, outs, dense, radix):
            op = zfuse.full_operator(plan, spec, next(dd_iter) if spec.kind == "grad"
                                     else None, use_kappa)
            ref = torch.fft.ifft(f64 * op, dim=0)
            peak = float(ref.abs().max())
            assert float((got - ref).abs().max()) <= 2e-6 * peak
            assert float((got - want_d).abs().max()) <= 4e-6 * peak
            assert float((got - want_r).abs().max()) <= 4e-6 * peak


@pytest.mark.cuda
@pytest.mark.parametrize("nx", [256, 260])
@pytest.mark.parametrize("nz", [12, 24, 60, 96, 100, 192, 448, 1000, 1536,
                                2, 6, 11, 13, 22, 26, 110, 176, 208, 1331,
                                17, 34, 230, 172, 1316, 1504])
def test_zfuse_mixed_kernel(nz, nx):
    """The mixed-radix kernel at plans of one to four passes with radices 3, 5 and 7 and
    every tile width (32, 16, 8); at nz = 2, 6, 11, 12 and 13 (one and two passes, through a
    plan that names it: `kernel_for` sends nz up to 16 to the column kernel); with radices 11
    and 13 (22, 26, 110, 176 = 16 x 11, 208 = 16 x 13, 1331 = 11^3); with the generic pass
    of a prime, alone (17) and first before others (34, 230 = 23 x 2 x 5, 172 = 43 x 4,
    1316 = 47 x 4 x 7, 1504 = 47 x 8 x 4, the largest prime); nxr = 129 and 131 (a ragged last
    tile), one op, two and three, grad on each axis with and without kappa, and a nabla
    with its pole: within 2e-6 of the peak of a float64 FFT, 4e-6 of `apply_radix_plain`
    and of `apply_plain`; every launch counted as the mixed kernel's."""
    import dataclasses

    from kwave_tpu_torch.ops import zfuse

    dev = require_cuda()
    ny, nxr = 8, nx // 2 + 1
    rng = np.random.default_rng(nz + nx)
    sizes = (nz, ny, nxr)
    s = torch.from_numpy((rng.standard_normal(sizes) + 1j * rng.standard_normal(sizes))
                         .astype(np.complex64)).to(dev)
    k2 = [(np.fft.fftfreq(n) * 2 * np.pi * n / 1e-2) ** 2 for n in (nz, ny)]
    k2.append((np.fft.rfftfreq(nx) * 2 * np.pi * nx / 1e-2) ** 2)
    plan = zfuse.make_plan((nz, ny, nx), *k2, 1e-5, dev)
    assert plan.kernel == zfuse.kernel_for(nz) == ("column" if nz <= 16 else "mixed")
    plan = dataclasses.replace(plan, **zfuse.kernel_tables(nz, "mixed", dev))
    dds = [torch.from_numpy((rng.standard_normal(m) + 1j * rng.standard_normal(m))
                            .astype(np.complex64)).to(dev) for m in sizes]
    f64 = torch.fft.fft(s.to(torch.complex128), dim=0)
    grad = [zfuse.OpSpec("grad", axis=a) for a in range(3)]
    cases = [(tuple(grad[::-1]), dds[::-1], True),
             ((grad[0],), dds[:1], False), ((grad[0],), dds[:1], True),
             ((grad[1], zfuse.OpSpec("nabla", power=0.5)), dds[1:2], True),
             ((grad[1],), dds[1:2], False), ((grad[2],), dds[2:], True),
             ((grad[2],), dds[2:], False),
             ((zfuse.OpSpec("nabla", power=-0.5),), (), False)]
    for specs, dd, use_kappa in cases:
        before = dict(zfuse.KERNEL_LAUNCHES)
        outs = zfuse.apply(plan, s, specs, dd, use_kappa=use_kappa)
        torch.cuda.synchronize()
        assert zfuse.KERNEL_LAUNCHES == {**before, "mixed": before["mixed"] + 1}
        dense = zfuse.apply_plain(plan, s, specs, dd, use_kappa=use_kappa)
        mixed = zfuse.apply_radix_plain(plan, s, specs, dd, use_kappa=use_kappa)
        dd_iter = iter(dd)
        for spec, got, want_d, want_m in zip(specs, outs, dense, mixed):
            op = zfuse.full_operator(plan, spec, next(dd_iter) if spec.kind == "grad"
                                     else None, use_kappa)
            ref = torch.fft.ifft(f64 * op, dim=0)
            peak = float(ref.abs().max())
            assert float((got - ref).abs().max()) <= 2e-6 * peak
            assert float((got - want_d).abs().max()) <= 4e-6 * peak
            assert float((got - want_m).abs().max()) <= 4e-6 * peak


def _zfuse_inputs(nz, ny, nx, seed, dev):
    """A random spectrum [nz, ny, nx/2 + 1], its plan (`make_plan`'s kernel), the three dd
    vectors (z, y, x) and the spectrum's float64 z-transform, on the card."""
    from kwave_tpu_torch.ops import zfuse

    rng = np.random.default_rng(seed)
    sizes = (nz, ny, nx // 2 + 1)
    s = torch.from_numpy((rng.standard_normal(sizes) + 1j * rng.standard_normal(sizes))
                         .astype(np.complex64)).to(dev)
    k2 = [(np.fft.fftfreq(n) * 2 * np.pi * n / 1e-2) ** 2 for n in (nz, ny)]
    k2.append((np.fft.rfftfreq(nx) * 2 * np.pi * nx / 1e-2) ** 2)
    plan = zfuse.make_plan((nz, ny, nx), *k2, 1e-5, dev)
    dds = [torch.from_numpy((rng.standard_normal(m) + 1j * rng.standard_normal(m))
                            .astype(np.complex64)).to(dev) for m in sizes]
    return s, plan, dds, torch.fft.fft(s.to(torch.complex128), dim=0)


def _hold_zfuse(plan, s, specs, dd, use_kappa, outs, f64, own_plain):
    """Each output within 2e-6 of a float64 FFT's peak, 4e-6 of `apply_plain` and of the
    kernel's own plain version."""
    from kwave_tpu_torch.ops import zfuse

    dense = zfuse.apply_plain(plan, s, specs, dd, use_kappa=use_kappa)
    own = own_plain(plan, s, specs, dd, use_kappa=use_kappa)
    dd_iter = iter(dd)
    for spec, got, want_d, want_o in zip(specs, outs, dense, own):
        op = zfuse.full_operator(plan, spec, next(dd_iter) if spec.kind == "grad" else None,
                                 use_kappa)
        ref = torch.fft.ifft(f64 * op, dim=0)
        peak = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= 2e-6 * peak
        assert float((got - want_d).abs().max()) <= 4e-6 * peak
        assert float((got - want_o).abs().max()) <= 4e-6 * peak


# the primes of the generic pass, from PRIME_MIN to PRIME_MAX (a fixed list: every worker
# collects the same tests)
GENERIC_PRIMES = [p for p in (17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71, 73, 79,
                              83, 89, 97, 101, 103, 107, 109, 113, 127)
                  if p <= zfuse_mod.PRIME_MAX]


@pytest.mark.cuda
@pytest.mark.parametrize("nx", [256, 260])
@pytest.mark.parametrize("k", [4, 8, 20])
@pytest.mark.parametrize("p", GENERIC_PRIMES)
def test_zfuse_generic_pass(p, k, nx):
    """The mixed kernel's generic pass at every prime it takes (17 to PRIME_MAX), at z
    lengths 4p and 8p (one radix pass after it: the build of 2 blocks an SM) and 20p (two:
    the build of 3 where three blocks fit an SM), at each tile width (32, 16, 8; one whose
    tiles and table do not fit a block refused before any launch) in both builds and the
    kernel's own choice, nxr = 129 and 131 (a
    ragged last tile), one op and three, grad with and without kappa, and a nabla: within
    2e-6 of the peak of a float64 FFT, 4e-6 of `apply_radix_plain` and of `apply_plain`;
    every launch through `apply` counted as the mixed kernel's. The host's
    `generic_table_size` equals the kernel's."""
    from kwave_tpu_torch.ops import _build, zfuse

    dev = require_cuda()
    nz = k * p
    s, plan, dds, f64 = _zfuse_inputs(nz, 4, nx, nz + nx, dev)
    assert plan.kernel == zfuse.kernel_for(nz) == "mixed" and plan.passes[0] == p
    grad = [zfuse.OpSpec("grad", axis=a) for a in range(3)]
    cases = [(tuple(grad[::-1]), dds[::-1], True), ((grad[0],), dds[:1], True),
             ((grad[2],), dds[2:], False), ((zfuse.OpSpec("nabla", power=-0.5),), (), False)]
    lib = _build.load_library()
    # the host's copy of the table's size, which decides the tile fit below and the routing
    assert lib.kw_zfuse_generic_table_size(p) == zfuse.generic_table_size(p)
    # the builds capped for 2 and for 3 blocks an SM, each as the library `_launch` calls
    builds = [types.SimpleNamespace(kw_zfuse_mixed=entry)
              for entry in (lib.kw_zfuse_mixed_generic, lib.kw_zfuse_mixed_generic3)]
    for specs, dd, use_kappa in cases:
        before = dict(zfuse.KERNEL_LAUNCHES)
        outs = zfuse.apply(plan, s, specs, dd, use_kappa=use_kappa)
        torch.cuda.synchronize()
        assert zfuse.KERNEL_LAUNCHES == {**before, "mixed": before["mixed"] + 1}
        _hold_zfuse(plan, s, specs, dd, use_kappa, outs, f64, zfuse.apply_radix_plain)
        for tc, build in itertools.product((32, 16, 8), builds):
            # the tiles, the roots and the table of roots
            tiles = 2 if len(specs) > 1 else 1
            if (tiles * nz * tc + nz + zfuse.generic_table_size(p)) * 8 > 227 * 1024:
                with pytest.raises(RuntimeError, match="cudaError"):
                    zfuse._launch(build, plan, s, specs, dd, use_kappa, tc)
                continue
            outs = zfuse._launch(build, plan, s, specs, dd, use_kappa, tc)
            torch.cuda.synchronize()
            _hold_zfuse(plan, s, specs, dd, use_kappa, outs, f64, zfuse.apply_radix_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("nx", [256, 260])
@pytest.mark.parametrize("nz", list(range(1, 17)))
def test_zfuse_column_kernel(nz, nx):
    """The column kernel at every z length it is built for (1 to COLUMN_MAX_NZ: at 1, a
    grid of one z plane, its transforms are the identity), nxr = 129 and 131,
    one op, two and three, grad on each axis with and without kappa, and a nabla with its
    pole: within 2e-6 of the peak of a float64 FFT and 4e-6 of `apply_plain` (its plain
    version); every launch counted as the column kernel's."""
    from kwave_tpu_torch.ops import zfuse

    dev = require_cuda()
    assert zfuse.COLUMN_MAX_NZ == 16
    s, plan, dds, f64 = _zfuse_inputs(nz, 8, nx, nz + nx, dev)
    assert plan.kernel == zfuse.kernel_for(nz) == "column"
    grad = [zfuse.OpSpec("grad", axis=a) for a in range(3)]
    cases = [(tuple(grad[::-1]), dds[::-1], True),
             ((grad[0],), dds[:1], False), ((grad[0],), dds[:1], True),
             ((grad[1], zfuse.OpSpec("nabla", power=0.5)), dds[1:2], True),
             ((grad[2],), dds[2:], False), ((zfuse.OpSpec("nabla", power=-0.5),), (), False)]
    for specs, dd, use_kappa in cases:
        before = dict(zfuse.KERNEL_LAUNCHES)
        outs = zfuse.apply(plan, s, specs, dd, use_kappa=use_kappa)
        torch.cuda.synchronize()
        assert zfuse.KERNEL_LAUNCHES == {**before, "column": before["column"] + 1}
        _hold_zfuse(plan, s, specs, dd, use_kappa, outs, f64, zfuse.apply_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("nx", [256, 260])
@pytest.mark.parametrize("nz,named", [(127, False), (251, False), (1009, False),
                                      (1709, False), (230, True), (6, True), (2, True)])
def test_zfuse_bluestein_kernel(nz, named, nx):
    """The Bluestein kernel at the z lengths it takes, at the M of `bluestein_length` (127:
    M = 256, tiles of 32 columns; 251: 512, 16; 1009: 2048, 4; 1709, the largest: 3584 = 8 x
    8 x 8 x 7, 2) and through a plan that names it at lengths of the
    mixed kernel (230, 6, 2), nxr = 129 and 131 (a ragged last tile), one op, two and three,
    grad on each axis with and without kappa, and a nabla with its pole: within 2e-6 of
    the peak of a float64 FFT, 4e-6 of `apply_bluestein_plain` and of `apply_plain`; every
    launch counted as the Bluestein kernel's."""
    import dataclasses

    from kwave_tpu_torch.ops import zfuse

    dev = require_cuda()
    ny, nxr = 8, nx // 2 + 1
    rng = np.random.default_rng(nz + nx)
    sizes = (nz, ny, nxr)
    s = torch.from_numpy((rng.standard_normal(sizes) + 1j * rng.standard_normal(sizes))
                         .astype(np.complex64)).to(dev)
    k2 = [(np.fft.fftfreq(n) * 2 * np.pi * n / 1e-2) ** 2 for n in (nz, ny)]
    k2.append((np.fft.rfftfreq(nx) * 2 * np.pi * nx / 1e-2) ** 2)
    plan = zfuse.make_plan((nz, ny, nx), *k2, 1e-5, dev)
    assert (zfuse.kernel_for(nz) == "bluestein") != named
    if named:
        plan = dataclasses.replace(plan, **zfuse.kernel_tables(nz, "bluestein", dev))
    assert plan.kernel == "bluestein" and plan.m == zfuse.bluestein_length(nz)
    dds = [torch.from_numpy((rng.standard_normal(m) + 1j * rng.standard_normal(m))
                            .astype(np.complex64)).to(dev) for m in sizes]
    f64 = torch.fft.fft(s.to(torch.complex128), dim=0)
    grad = [zfuse.OpSpec("grad", axis=a) for a in range(3)]
    cases = [(tuple(grad[::-1]), dds[::-1], True),
             ((grad[0],), dds[:1], False), ((grad[0],), dds[:1], True),
             ((grad[1], zfuse.OpSpec("nabla", power=0.5)), dds[1:2], True),
             ((grad[2],), dds[2:], False), ((zfuse.OpSpec("nabla", power=-0.5),), (), False)]
    for specs, dd, use_kappa in cases:
        before = dict(zfuse.KERNEL_LAUNCHES)
        outs = zfuse.apply(plan, s, specs, dd, use_kappa=use_kappa)
        torch.cuda.synchronize()
        assert zfuse.KERNEL_LAUNCHES == {**before, "bluestein": before["bluestein"] + 1}
        dense = zfuse.apply_plain(plan, s, specs, dd, use_kappa=use_kappa)
        blue = zfuse.apply_bluestein_plain(plan, s, specs, dd, use_kappa=use_kappa)
        dd_iter = iter(dd)
        for spec, got, want_d, want_b in zip(specs, outs, dense, blue):
            op = zfuse.full_operator(plan, spec, next(dd_iter) if spec.kind == "grad"
                                     else None, use_kappa)
            ref = torch.fft.ifft(f64 * op, dim=0)
            peak = float(ref.abs().max())
            assert float((got - ref).abs().max()) <= 2e-6 * peak
            assert float((got - want_d).abs().max()) <= 4e-6 * peak
            assert float((got - want_b).abs().max()) <= 4e-6 * peak


@pytest.mark.cuda
@pytest.mark.parametrize("nz,m", [(251, 512), (251, 504), (143, 286), (1009, 2048),
                                  (17, 64)])
@pytest.mark.parametrize("tc", [32, 16, 8, 4, 2])
def test_zfuse_bluestein_kernel_at_every_tile_width(nz, m, tc):
    """The Bluestein kernel at each tile width it is built for (the rows swizzled below 16
    columns where the last radix is a power of two: 512, 2048, 64; not at 504 = 8 x 3 x 3
    x 7 or 286 = 2 x 11 x 13), at lengths M other than the rule's, nxr = 131 (a ragged last
    tile), one op and three (with the nz tile), with and without kappa: within 2e-6 of a
    float64 FFT's peak and 4e-6 of `apply_bluestein_plain`. A width whose tile does not fit
    227 KB is refused before any launch."""
    import dataclasses

    from kwave_tpu_torch.ops import _build, zfuse

    dev = require_cuda()
    ny, nx = 4, 260
    rng = np.random.default_rng(nz + tc)
    sizes = (nz, ny, nx // 2 + 1)
    s = torch.from_numpy((rng.standard_normal(sizes) + 1j * rng.standard_normal(sizes))
                         .astype(np.complex64)).to(dev)
    k2 = [(np.fft.fftfreq(n) * 2 * np.pi * n / 1e-2) ** 2 for n in (nz, ny)]
    k2.append((np.fft.rfftfreq(nx) * 2 * np.pi * nx / 1e-2) ** 2)
    plan = dataclasses.replace(zfuse.make_plan((nz, ny, nx), *k2, 1e-5, dev),
                               **zfuse.bluestein_tables(nz, m, dev))
    dds = [torch.from_numpy((rng.standard_normal(k) + 1j * rng.standard_normal(k))
                            .astype(np.complex64)).to(dev) for k in sizes]
    f64 = torch.fft.fft(s.to(torch.complex128), dim=0)
    grad = [zfuse.OpSpec("grad", axis=a) for a in range(3)]
    lib = _build.load_library()
    for specs, dd, use_kappa in ((tuple(grad[::-1]), dds[::-1], True),
                                 ((grad[0],), dds[:1], False), ((grad[0],), dds[:1], True)):
        if zfuse.bluestein_tile(nz, m, len(specs), tc) is None:
            with pytest.raises(ValueError, match="no tile"):
                zfuse._launch(lib, plan, s, specs, dd, use_kappa, tc)
            continue
        outs = zfuse._launch(lib, plan, s, specs, dd, use_kappa, tc)
        torch.cuda.synchronize()
        blue = zfuse.apply_bluestein_plain(plan, s, specs, dd, use_kappa=use_kappa)
        dd_iter = iter(dd)
        for spec, got, want in zip(specs, outs, blue):
            op = zfuse.full_operator(plan, spec, next(dd_iter), use_kappa)
            ref = torch.fft.ifft(f64 * op, dim=0)
            peak = float(ref.abs().max())
            assert float((got - ref).abs().max()) <= 2e-6 * peak
            assert float((got - want).abs().max()) <= 4e-6 * peak


@pytest.mark.cuda
def test_zfuse_bluestein_kernel_at_every_z_length_it_takes():
    """The Bluestein kernel at each of the 1013 z lengths up to MAX_NZ that take it, at the
    M and the tile the rules give (every M, width, staging and swizzle a run can reach), a
    spectrum [nz, 2, 3], one grad op with kappa and three: within 2e-6 of a float64 FFT's
    peak; every launch counted as the Bluestein kernel's."""
    from kwave_tpu_torch.ops import zfuse

    dev = require_cuda()
    ny, nx = 2, 4
    lengths = [nz for nz in range(2, zfuse.MAX_NZ + 1) if zfuse.kernel_for(nz) == "bluestein"]
    assert len(lengths) == 1013
    before = zfuse.KERNEL_LAUNCHES["bluestein"]
    worst = 0.0
    for nz in lengths:
        rng = np.random.default_rng(nz)
        sizes = (nz, ny, nx // 2 + 1)
        s = torch.from_numpy((rng.standard_normal(sizes) + 1j * rng.standard_normal(sizes))
                             .astype(np.complex64)).to(dev)
        k2 = [(np.fft.fftfreq(n) * 2 * np.pi * n / 1e-2) ** 2 for n in (nz, ny)]
        k2.append((np.fft.rfftfreq(nx) * 2 * np.pi * nx / 1e-2) ** 2)
        plan = zfuse.make_plan((nz, ny, nx), *k2, 1e-5, dev)
        dds = [torch.from_numpy((rng.standard_normal(m) + 1j * rng.standard_normal(m))
                                .astype(np.complex64)).to(dev) for m in sizes]
        f64 = torch.fft.fft(s.to(torch.complex128), dim=0)
        grad = [zfuse.OpSpec("grad", axis=a) for a in range(3)]
        for specs, dd in (((grad[0],), dds[:1]), (tuple(grad[::-1]), dds[::-1])):
            outs = zfuse.apply(plan, s, specs, dd)
            for spec, got, d in zip(specs, outs, dd):
                ref = torch.fft.ifft(f64 * zfuse.full_operator(plan, spec, d, True), dim=0)
                err = float((got - ref).abs().max() / ref.abs().max())
                worst = max(worst, err)
                assert err <= 2e-6, (nz, len(specs), err)
    assert zfuse.KERNEL_LAUNCHES["bluestein"] - before == 2 * len(lengths)
    assert worst > 0


@pytest.mark.cuda
def test_zfuse_bluestein_plan_without_its_tables_is_refused():
    """A plan that names the Bluestein kernel without its tables (or with another length's)
    raises before any launch."""
    import dataclasses

    from kwave_tpu_torch.ops import zfuse

    dev = require_cuda()
    nz, ny, nx = 251, 4, 16
    k2 = [(np.fft.fftfreq(m) * 2 * np.pi * m / 1e-2) ** 2 for m in (nz, ny)]
    k2.append((np.fft.rfftfreq(nx) * 2 * np.pi * nx / 1e-2) ** 2)
    plan = zfuse.make_plan((nz, ny, nx), *k2, 1e-5, dev)
    s = torch.zeros((nz, ny, plan.nxr), dtype=torch.complex64, device=dev)
    other = zfuse.kernel_tables(127, "bluestein", dev)
    before = dict(zfuse.KERNEL_LAUNCHES)
    for bad in (dataclasses.replace(plan, chirp=None), dataclasses.replace(plan, filt=None),
                dataclasses.replace(plan, m_roots=None), dataclasses.replace(plan, m=None),
                dataclasses.replace(plan, **other),
                dataclasses.replace(plan, passes=None, m=None, chirp=None, filt=None,
                                    m_roots=None)):
        with pytest.raises(ValueError, match="bluestein kernel"):
            zfuse.apply(bad, s, (zfuse.OpSpec("nabla"),))
    assert zfuse.KERNEL_LAUNCHES == before


@pytest.mark.cuda
def test_fused_step_on_the_card_matches_unfused():
    """Six heterogeneous absorbing steps at 32^3 through `zfuse.make_pipeline` on the
    card against the unfused compact step: 2e-4 of the peak, as the CPU test."""
    from kwave_tpu_torch import solver
    from kwave_tpu_torch.ops import zfuse

    dev = require_cuda()
    n = 32
    grid = solver.Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=8)
    rng = np.random.default_rng(7)
    medium = solver.Medium(c0=(1500.0 + 100.0 * rng.random(grid.shape)).astype(np.float32),
                           rho0=1000.0, alpha_coeff=0.75, alpha_power=1.5)
    ops = solver.make_operators(grid, medium, (2, 2, 2), (2.0,) * 3, absorbing=True,
                                device=dev, compact=True)
    p0 = torch.zeros(grid.shape, device=dev)
    p0[n // 2, n // 2, n // 2] = 1e5
    cfg = solver.SolverConfig(absorbing=True)
    sm = zfuse.make_pipeline(grid.shape, ops.k2_z, ops.k2_y, ops.k2_x, ops.c_ref_dt_2, dev)
    out = []
    before = sum(zfuse.LAUNCHES.values())
    for pipeline in (None, sm):
        st = solver.add_initial_pressure(solver.init_state(grid, dev), ops, p0, pipeline)
        for t in range(1, 7):
            st = solver.step(st, t, ops, solver.Sources(), cfg, pipeline)
        out.append(st.p)
    assert sum(zfuse.LAUNCHES.values()) - before == 1 + 6 * 6
    assert float((out[1] - out[0]).abs().max()) <= 2e-4 * float(out[0].abs().max())


@pytest.mark.cuda
def test_operators_built_on_the_card_match_the_cpu_build():
    """The benchmark cell's build (128^3, heterogeneous c0 and rho0, absorbing, PML 10) on
    the card against the same build on the CPU: the per-axis vectors (made on the host)
    equal, every full-grid and spectral array within 1 float32 ulp (float64 sin, pow and
    their kin differ by an ulp or two between the card's and the CPU's libraries, which
    the cast to float32 hides nearly everywhere), and the build's peak memory below that
    of one eager step that follows it."""
    import dataclasses

    from kwave_tpu_torch import solver
    from kwave_tpu_torch.solver import operators

    dev = require_cuda()
    n = 128
    dt = float(np.float32(0.3 * 1e-4 / 1600.0))
    grid = solver.Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=dt, nt=8)
    rng = np.random.default_rng(128)
    medium = solver.Medium(c0=(1500.0 + 100.0 * rng.random(grid.shape)).astype(np.float32),
                           rho0=(1000.0 + 50.0 * rng.random(grid.shape)).astype(np.float32),
                           alpha_coeff=0.75, alpha_power=1.5)
    args = (grid, medium, (10, 10, 10), (2.0,) * 3)
    cpu = solver.make_operators(*args, absorbing=True, device="cpu")
    builds = operators.BUILDS.get("cuda", 0)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    card = solver.make_operators(*args, absorbing=True, device=dev)
    torch.cuda.synchronize(dev)
    build_peak = torch.cuda.max_memory_allocated(dev)
    assert operators.BUILDS["cuda"] == builds + 1

    differ = {}
    for f in dataclasses.fields(card):
        a, b = getattr(card, f.name), getattr(cpu, f.name)
        if not isinstance(a, torch.Tensor):
            assert a == b, f.name
            continue
        assert a.device.type == "cuda" and a.dtype == b.dtype and a.shape == b.shape, f.name
        a = a.cpu()
        if a.ndim <= 1:
            assert torch.equal(a, b), f.name
            continue
        ia, ib = (x.view(torch.int32).long() for x in (a, b))
        # the float32 order as integers: one ulp apart is 1 apart, across zero too
        ia, ib = (torch.where(x < 0, -(x & 0x7FFFFFFF), x) for x in (ia, ib))
        ulps = (ia - ib).abs()
        differ[f.name] = int((ulps > 0).sum())
        assert int(ulps.max()) <= 1, f"{f.name}: {int(ulps.max())} ulps"
    print(f"elements that differ by 1 ulp, card vs CPU: {differ}")

    p0 = torch.zeros(grid.shape, device=dev)
    p0[n // 2, n // 2, n // 2] = 1e5
    torch.cuda.reset_peak_memory_stats(dev)
    state = solver.add_initial_pressure(solver.init_state(grid, dev), card, p0)
    state = solver.step(state, 1, card, solver.Sources(), solver.SolverConfig(absorbing=True))
    torch.cuda.synchronize(dev)
    step_peak = torch.cuda.max_memory_allocated(dev)
    print(f"peak memory: build {build_peak / 2**20:.1f} MiB, with one eager step "
          f"{step_peak / 2**20:.1f} MiB")
    assert build_peak < step_peak


@pytest.mark.parametrize("n", [96, 101, 128])
def test_postproc_spectral_ops_on_the_card_match_the_cpu(n):
    """The half-step time shift and the Q term's derivative multiply the Nyquist bin (even
    lengths) by an imaginary factor; cuFFT's c2r transform does not drop that part as the
    CPU's does, so the tables zero it: card == CPU == float64 numpy to 1e-6 of the peak."""
    from kwave_tpu_torch import postproc

    dev = require_cuda()
    rng = np.random.default_rng(n)
    u = rng.standard_normal((n, 64)).astype(np.float32)
    shift = (np.arange(n // 2 + 1) + n // 2) % n - n // 2
    want = np.fft.irfft(np.fft.rfft(u.astype(np.float64), axis=0)
                        * np.exp(1j * np.pi * shift / n)[:, None], n=n, axis=0)
    for device in ("cpu", dev):
        got = postproc.time_shift_half_step(torch.from_numpy(u).to(device)).cpu().numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), device

    # spikes, as the scattered sensor intensities are: the spectrum is full up to Nyquist
    fields = [np.where(rng.random((8, n, n)) < 0.05,
                       rng.standard_normal((8, n, n)), 0.0).astype(np.float32)
              for _ in range(3)]
    on_cpu = postproc.q_term(*(torch.from_numpy(f) for f in fields), 1e-4, 1e-4, 1e-4)
    on_card = postproc.q_term(*(torch.from_numpy(f).to(dev) for f in fields),
                              1e-4, 1e-4, 1e-4).cpu()
    # of the size of the terms that the derivative sums: k_max |I|max
    assert (on_card - on_cpu).abs().max() <= 1e-6 * np.pi / 1e-4 * max(
        np.abs(f).max() for f in fields)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 24, 32), (15, 21, 27), (16, 21, 32), (128, 128, 128),
                                   (100, 127, 128), (24, 32), (21, 27), (24, 27),
                                   (256, 256), (255, 256)])
def test_shifted_velocity_on_the_card_matches_the_cpu(shape):
    """The half-cell shift's table is exp(i*pi/2) = i at the Nyquist bin of an even axis:
    the imaginary part it gives that real bin is dropped by the CPU's c2r transform and
    not by cuFFT's. With the table zeroed there (`step.real_at_nyquist`) the card equals
    the CPU port to rel L2 1e-5 on every axis: 3D and 2D, even, odd and mixed axes, the
    velocities of a point source a few steps on (a broadband field)."""
    from kwave_tpu_torch import solver

    dev = require_cuda()
    grid = solver.Grid(nx=shape[-1], ny=shape[-2], nz=shape[0] if len(shape) == 3 else 1,
                       dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=8)
    p0 = np.zeros(shape, np.float32)
    p0[tuple(s // 2 for s in shape)] = 1e5
    medium = solver.Medium(c0=1500.0, rho0=1000.0)
    ops = {d: solver.make_operators(grid, medium, (4, 4, 4), (2.0,) * 3, need_shift=True,
                                    device=d) for d in ("cpu", dev)}
    state = solver.add_initial_pressure(solver.init_state(grid), ops["cpu"],
                                        torch.from_numpy(p0))
    for t in range(1, 4):
        state = solver.step(state, t, ops["cpu"], solver.Sources(), solver.SolverConfig())
    on_card = solver.SimState(**{
        k: None if v is None else v.to(dev) for k, v in vars(state).items()})
    cpu = solver.shifted_velocity(state, ops["cpu"])
    card = solver.shifted_velocity(on_card, ops[dev])
    rel = [float(torch.linalg.norm(b.cpu() - a) / torch.linalg.norm(a))
           for a, b in zip(cpu, card) if a is not None]
    print(f"shifted velocity {shape}: rel L2 card vs CPU (x, y[, z]) {rel}")
    assert max(rel) <= 1e-5, f"rel L2 of (x, y[, z]) card vs CPU: {rel}"


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("shape", [(128, 128, 128), (64, 96, 100)])
def test_mesh_step_on_the_card_matches_one_device(shape, s):
    """A point source's state four steps on, stepped on with the pencil FFT on s shards
    of the card, and its shifted velocities (the z shift through a trade): the fields
    within rel L2 1e-5 of the one-device step on the card, every axis."""
    from kwave_tpu_torch import solver
    from kwave_tpu_torch.parallel import make_mesh, pencil_fft, shard_operators, shard_state

    dev = require_cuda()
    grid = solver.Grid(nx=shape[2], ny=shape[1], nz=shape[0], dx=1e-4, dy=1e-4, dz=1e-4,
                       dt=2e-8, nt=8)
    p0 = torch.zeros(shape, device=dev)
    p0[tuple(n // 2 for n in shape)] = 1e5
    medium = solver.Medium(c0=1500.0, rho0=1000.0, alpha_coeff=0.75, alpha_power=1.5)
    ops = solver.make_operators(grid, medium, (4, 4, 4), (2.0,) * 3, absorbing=True,
                                need_shift=True, device=dev)
    cfg = solver.SolverConfig(absorbing=True)
    state = solver.add_initial_pressure(solver.init_state(grid, dev), ops, p0)
    for t in range(1, 4):
        state = solver.step(state, t, ops, solver.Sources(), cfg)
    mesh = make_mesh(s, devices=[dev] * s)
    ops_s, fft = shard_operators(ops, 3, mesh, grid), pencil_fft(mesh, grid.nx)
    one = solver.step(state, 4, ops, solver.Sources(), cfg)
    many = solver.step(shard_state(state, mesh), 4, ops_s, solver.Sources(), cfg, fft=fft)
    pairs = [(getattr(one, k), getattr(many, k)) for k in ("p", "ux_sgx", "uy_sgy",
                                                          "uz_sgz")]
    pairs += list(zip(solver.shifted_velocity(one, ops),
                      solver.shifted_velocity(many, ops_s, fft)))
    rel = [float(torch.linalg.norm(torch.cat(b.shards) - a) / torch.linalg.norm(a))
           for a, b in pairs]
    print(f"mesh step {shape} S={s}: rel L2 (p, ux, uy, uz, shifted x, y, z) {rel}")
    assert max(rel) <= 1e-5, rel


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 4])
def test_pencil_fft_on_the_card_matches_torch_fft(s):
    from kwave_tpu_torch.parallel import field_sharding, make_mesh
    from kwave_tpu_torch.parallel import fft as dfft

    dev = require_cuda()
    x = torch.randn(64, 128, 96, device=dev, generator=torch.Generator(dev).manual_seed(s))
    mesh = make_mesh(s, devices=[dev] * s)
    k = dfft.dist_rfftn(field_sharding(mesh, x), mesh)
    ref = torch.fft.rfftn(x)
    assert float((torch.cat(k.shards, 1) - ref).abs().max() / ref.abs().max()) <= 1e-5
    back = torch.cat(dfft.dist_irfftn(k, 96, mesh).shards)
    assert float((back - x).abs().max() / x.abs().max()) <= 1e-5


# ---------------------------------------------------------------------------
# The window as one device program: run_simulation with its windows replayed as CUDA
# graphs against the same run with every window eager (RunConfig.cuda_graphs=False)
# ---------------------------------------------------------------------------

GRAPH_O = 8  # period 8: o = 8


def _graph_input(shape, nt, p_flag=0, n_sensors=256):
    """An nz x ny x nx heterogeneous absorbing medium with p0 at the centre (and, with
    ``p_flag``, an additive pressure source acting on the steps below it), index sensors
    from seed 7."""
    from kwave_tpu_torch.io.input_file import InputData
    from kwave_tpu_torch.solver import Grid, Medium

    nz, ny, nx = shape
    grid = Grid(nx=nx, ny=ny, nz=nz, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=nt)
    rng = np.random.default_rng(7)
    medium = Medium(c0=(1500.0 + 100.0 * rng.random(shape)).astype(np.float32),
                    rho0=(1000.0 + 50.0 * rng.random(shape)).astype(np.float32),
                    alpha_coeff=0.75, alpha_power=1.5)
    p0 = np.zeros(shape, np.float32)
    p0[nz // 2, ny // 2, nx // 2] = 1e5
    mask = np.sort(rng.choice(grid.n_elements, n_sensors, replace=False)).astype(np.int64)
    extra = {}
    if p_flag:
        t = np.arange(nt, dtype=np.float32)
        extra = dict(p_source_index=np.array([nx // 3 + nx * (ny // 3 + ny * (nz // 3))]),
                     p_source_input=(2e-2 * np.sin(2 * np.pi * t / 8.0)).astype(np.float32),
                     p_source_flag=p_flag, p_source_mode=2)
    return InputData(grid=grid, medium=medium,
                     pml_size=tuple(min(4, m // 4) for m in (nx, ny, nz)),
                     pml_alpha=(2.0, 2.0, 2.0), absorbing=True, sensor_mask_index=mask,
                     p0=p0, **extra)


def _counts():
    from kwave_tpu_torch.ops import zfuse

    return {**ew.LAUNCHES, **zfuse.LAUNCHES,
            **{f"kernel_{k}": v for k, v in zfuse.KERNEL_LAUNCHES.items()}}


def _graph_run(data, flags, graphs, out=None, resume_from=None, mesh=None, **run_fields):
    """One run on the card (on ``mesh`` where given) into an in-memory group: (group,
    launches, window actions)."""
    import dataclasses

    from chip_smoke import MemGroup
    from kwave_tpu_torch import params
    from kwave_tpu_torch.driver import run_simulation

    args = params.build_parser().parse_args(["-i", "-", "-o", "-", "--period",
                                             str(GRAPH_O), *flags])
    run = dataclasses.replace(params.args_to_run_config(args, dt=data.grid.dt),
                              cuda_graphs=graphs, **run_fields)
    out = MemGroup() if out is None else out
    before, log = _counts(), []
    summary = run_simulation(data, run, out, device="cuda", resume_from=resume_from,
                             mesh=mesh, window_log=log)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in _counts().items()}
    return out, launches, [a for w in log for a in w.actions], summary


def _same_outputs(a, b):
    from chip_smoke import _datasets, _same_bits

    assert dict(_datasets(a)).keys() == dict(_datasets(b)).keys()
    assert not _same_bits(a, b), _same_bits(a, b)


def _hold_graphs_to_eager(data, flags, min_replays=1, mesh=None, **run_fields):
    """The run with graphs equals the run without bit for bit, with the same launches;
    its windows ran as `driver.plan_windows` says, at least ``min_replays`` replayed."""
    eager, n_eager, acts_eager, _ = _graph_run(data, flags, False, mesh=mesh, **run_fields)
    graph, n_graph, acts, _ = _graph_run(data, flags, True, mesh=mesh, **run_fields)
    _same_outputs(eager, graph)
    assert n_graph == n_eager, (n_graph, n_eager)
    assert all(a == "eager" for _, a in acts_eager)
    assert sum(a == "replay" for _, a in acts) >= min_replays, acts
    return acts, n_graph


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [["--p_raw", "--p_c", "--40-bit_complex"],
                                   ["--p_raw", "--p_c", "--40-bit_complex", "--no_overlap"],
                                   ["--p_raw", "--p_c"],
                                   ["--p_raw", "--p_c", "--no_overlap"]],
                         ids=["w40_overlap", "w40_no_overlap", "wfloat_overlap",
                              "wfloat_no_overlap"])
def test_graph_windows_equal_eager_windows(flags):
    """The four window-encode variants at 24^3, 8 windows and a 3-step tail: windows 0
    eager (p0, the mirror), 1 and 2 eager and captured, 3-7 replayed."""
    from kwave_tpu_torch import driver, solver

    require_cuda()
    data = _graph_input((24, 24, 24), 8 * GRAPH_O + 3)
    acts, launches = _hold_graphs_to_eager(data, flags, min_replays=5)
    plan = driver.plan_windows(solver.SolverConfig(), GRAPH_O, 0, 8)
    assert acts == [(t, a) for t, _, a in plan]
    variant = ("w40" if "--40-bit_complex" in flags else "wfloat") + \
        ("_no_overlap" if "--no_overlap" in flags else "_overlap")
    assert launches[variant] == 9  # 8 windows and the tail, each one launch


@pytest.mark.cuda
def test_spans_count_the_windows_captures_and_replays_on_the_card():
    """Under the profiler, with graphs on: `kwave.graph.capture` and `kwave.window.capture`
    once a capture (2, as in the benchmark's jobs), `kwave.window.replay` and
    `kwave.graph.launch` once a replay, as `driver.plan_windows` says."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from kwave_tpu_torch import driver, solver

    require_cuda()
    data = _graph_input((24, 24, 24), 8 * GRAPH_O + 3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, acts, _ = _graph_run(data, ["--p_raw", "--p_c", "--40-bit_complex"], True)
    plan = driver.plan_windows(solver.SolverConfig(), GRAPH_O, 0, 8)
    assert acts == [(t, a) for t, _, a in plan]
    want = collections.Counter(a for *_, a in plan)
    assert want["capture"] == 2 and want["replay"] == 5
    # the host's spans; the profiler mirrors those that hold kernels on the device's
    # timeline under the same names
    got = collections.Counter(e.name for e in prof.events() if e.name.startswith("kwave.")
                              and e.device_type == torch.autograd.DeviceType.CPU)
    for action in ("eager", "capture", "replay"):
        assert got[f"kwave.window.{action}"] == want[action], (action, got)
    assert got["kwave.graph.capture"] == want["capture"]
    assert got["kwave.graph.launch"] == want["replay"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kernel", [((32, 24, 24), "radix"), ((24, 24, 24), "mixed"),
                                          ((46, 16, 16), "mixed"),  # 23 x 2: generic pass
                                          ((53, 16, 16), "bluestein"),
                                          ((12, 32, 32), "column")])
def test_graph_windows_of_fused_runs_equal_eager_windows(shape, kernel):
    """A fused run (compact operators, fuse_z) on each K7 kernel, 6 windows and a tail:
    bit for bit, every K7 launch of both the kernel's and counted as many times."""
    from kwave_tpu_torch.ops import zfuse

    require_cuda()
    assert zfuse.kernel_for(shape[0]) == kernel
    data = _graph_input(shape, 6 * GRAPH_O + 3)
    _, launches = _hold_graphs_to_eager(data, ["--p_raw", "--p_c", "--40-bit_complex"],
                                        min_replays=3, compact_operators=True, fuse_z=True)
    steps = 6 * GRAPH_O + 3
    assert launches[f"kernel_{kernel}"] == steps + 5 * (steps - 1)
    assert launches["zfuse_3op"] == steps and launches["zfuse_1op"] == 5 * (steps - 1)


@pytest.mark.cuda
def test_graph_windows_fold_the_whole_domain_and_replay_the_lead_in():
    """p_max_all, p_min_all and u_max_all folded in replayed windows, after a lead-in of
    20 steps (-s 21) whose runs of 8 steps replay too; the raw and rms streams beside."""
    require_cuda()
    data = _graph_input((24, 24, 24), 20 + 6 * GRAPH_O + 5)
    _hold_graphs_to_eager(data, ["--p_raw", "--p_c", "--p_max_all", "--p_min_all",
                                 "--u_max_all", "--p_rms", "-s", "21"], min_replays=3)


@pytest.mark.cuda
def test_graph_windows_around_a_pressure_source_that_stops():
    """An additive p source whose flag (29) falls inside the window 24-31: that window
    runs eagerly, as do the two before it (the source on; no later window takes their
    keys); the windows after it (off) replay their own graphs from 48 on."""
    from kwave_tpu_torch import driver, solver

    require_cuda()
    data = _graph_input((24, 24, 24), 12 * GRAPH_O, p_flag=29)
    acts, _ = _hold_graphs_to_eager(data, ["--p_raw", "--p_c", "--40-bit_complex"],
                                    min_replays=4)
    cfg = solver.SolverConfig(p_source_flag=29)
    assert acts == [(t, a) for t, _, a in driver.plan_windows(cfg, GRAPH_O, 0, 12)]
    assert dict(acts)[24] == "eager" and dict(acts)[32] == "capture"
    assert dict(acts)[48] == "replay"


@pytest.mark.cuda
def test_graph_windows_in_two_legs_equal_one_eager_run():
    """Two legs (a checkpoint after 48 steps), each with its windows replayed where the
    plan allows, equal one eager run of the whole record bit for bit; the launches too."""
    from chip_smoke import MemGroup

    require_cuda()
    flags = ["--p_raw", "--p_c", "--40-bit_complex", "--p_max_all"]
    data = _graph_input((24, 24, 24), 12 * GRAPH_O + 5)
    one, n_one, _, _ = _graph_run(data, flags, False)
    out, ckpt = MemGroup(), MemGroup()
    _, n1, acts1, s1 = _graph_run(data, flags, True, out=out, checkpoint_file=ckpt,
                                  checkpoint_interval_steps=6 * GRAPH_O)
    assert s1["__checkpointed_at__"] == (6 * GRAPH_O,)
    _, n2, acts2, s2 = _graph_run(data, flags, True, out=out, resume_from=ckpt,
                                  checkpoint_file=MemGroup())
    assert "__checkpointed_at__" not in s2
    _same_outputs(one, out)
    assert {k: n1[k] + n2[k] for k in n1} == n_one
    assert [a for _, a in acts1] == ["eager", "capture", "capture", "replay", "replay",
                                     "replay"]
    assert [a for _, a in acts2] == ["capture", "capture", "replay", "replay", "replay",
                                     "replay"]


# ---------------------------------------------------------------------------
# The mesh's window as one device program: S shards of cuda:0 in one process, and a
# process group of one over NCCL, with their windows and lead-in replayed as CUDA graphs
# ---------------------------------------------------------------------------

MESH_GRAPH_FLAGS = [["--p_raw", "--p_c", "--40-bit_complex"],
                    ["--p_raw", "--p_c", "--40-bit_complex", "--no_overlap"],
                    ["--p_raw", "--p_c"], ["--p_raw", "--p_c", "--no_overlap"]]
MESH_GRAPH_IDS = ["w40_overlap", "w40_no_overlap", "wfloat_overlap", "wfloat_no_overlap"]


def _cuda_mesh(s):
    from kwave_tpu_torch.parallel import make_mesh

    mesh = make_mesh(s, devices=["cuda:0"] * s)
    assert mesh.graph_devices == (torch.device("cuda", 0),) * s
    return mesh


@pytest.mark.cuda
@pytest.mark.parametrize("s", [4, 2])
@pytest.mark.parametrize("flags", MESH_GRAPH_FLAGS, ids=MESH_GRAPH_IDS)
def test_mesh_graph_windows_equal_eager_windows(flags, s):
    """The four window-encode variants on S shards of cuda:0 at 24^3, 8 windows and a
    3-step tail: the windows as planned (0 eager, 1 and 2 captured, 3-7 replayed), bit
    for bit the eager run, each shard's kernel launched once a window and for the tail."""
    from kwave_tpu_torch import driver, solver

    require_cuda()
    data = _graph_input((24, 24, 24), 8 * GRAPH_O + 3)
    acts, launches = _hold_graphs_to_eager(data, flags, min_replays=5, mesh=_cuda_mesh(s))
    plan = driver.plan_windows(solver.SolverConfig(), GRAPH_O, 0, 8)
    assert acts == [(t, a) for t, _, a in plan]
    variant = MESH_GRAPH_IDS[MESH_GRAPH_FLAGS.index(flags)]
    assert launches[variant] == 9 * s


@pytest.mark.cuda
def test_mesh_graph_windows_fold_the_whole_domain_and_replay_the_lead_in():
    """p_max_all, p_min_all and u_max_all folded on 4 shards in replayed windows, after a
    lead-in of 20 steps (-s 21) whose runs of 8 replay too."""
    require_cuda()
    data = _graph_input((24, 24, 24), 20 + 6 * GRAPH_O + 5)
    _hold_graphs_to_eager(data, ["--p_raw", "--p_c", "--p_max_all", "--p_min_all",
                                 "--u_max_all", "--p_rms", "-s", "21"], min_replays=3,
                          mesh=_cuda_mesh(4))


@pytest.mark.cuda
def test_mesh_graph_windows_of_a_shard_without_sensors():
    """Every sensor in shard 0's slab: the other three shards encode nothing in the
    captured windows either (the choice is the host's, from a static count), so the
    40-bit kernel runs once a window and for the tail, with graphs as without."""
    require_cuda()
    data = _graph_input((24, 24, 24), 8 * GRAPH_O + 3)
    data.sensor_mask_index = np.sort(np.random.default_rng(3).choice(
        6 * 24 * 24, 256, replace=False)).astype(np.int64)
    _, launches = _hold_graphs_to_eager(data, ["--p_raw", "--p_c", "--40-bit_complex"],
                                        min_replays=5, mesh=_cuda_mesh(4))
    assert launches["w40_overlap"] == 9


@pytest.mark.cuda
def test_mesh_graph_windows_in_two_legs_equal_one_eager_run():
    """Two legs on 4 shards (a checkpoint after 48 steps), each with its windows replayed
    where the plan allows, equal one eager run of the whole record bit for bit."""
    from chip_smoke import MemGroup

    require_cuda()
    flags = ["--p_raw", "--p_c", "--40-bit_complex", "--p_max_all"]
    data = _graph_input((24, 24, 24), 12 * GRAPH_O + 5)
    one, n_one, _, _ = _graph_run(data, flags, False, mesh=_cuda_mesh(4))
    out, ckpt = MemGroup(), MemGroup()
    _, n1, acts1, s1 = _graph_run(data, flags, True, out=out, checkpoint_file=ckpt,
                                  checkpoint_interval_steps=6 * GRAPH_O, mesh=_cuda_mesh(4))
    assert s1["__checkpointed_at__"] == (6 * GRAPH_O,)
    _, n2, acts2, _ = _graph_run(data, flags, True, out=out, resume_from=ckpt,
                                 checkpoint_file=MemGroup(), mesh=_cuda_mesh(4))
    _same_outputs(one, out)
    assert {k: n1[k] + n2[k] for k in n1} == n_one
    assert [a for _, a in acts1] == ["eager", "capture", "capture", "replay", "replay",
                                     "replay"]
    assert [a for _, a in acts2] == ["capture", "capture", "replay", "replay", "replay",
                                     "replay"]


@pytest.mark.cuda
def test_mesh_graph_windows_over_nccl_at_world_size_1():
    """A process group of one over NCCL (`initialize`, then `make_mesh()`): its windows
    replay graphs that hold NCCL's all-to-all, bit for bit the eager run, with the same
    launches; the lead-in too (-s 25: its runs of 8 steps from 9 on replay)."""
    import gc
    import socket

    import torch.distributed as dist

    from kwave_tpu_torch.parallel import make_mesh
    from kwave_tpu_torch.parallel.comm import ProcessGroup
    from kwave_tpu_torch.parallel.distributed import initialize

    require_cuda()
    probe = socket.socket()
    probe.bind(("localhost", 0))
    port = probe.getsockname()[1]
    probe.close()
    initialize(f"localhost:{port}", 1, 0, "cuda")
    try:
        mesh = make_mesh()
        assert isinstance(mesh.comm, ProcessGroup) and mesh.comm.backend == "nccl"
        assert mesh.graph_devices == (torch.device("cuda", 0),)
        data = _graph_input((24, 24, 24), 24 + 8 * GRAPH_O + 3)
        acts, launches = _hold_graphs_to_eager(
            data, ["--p_raw", "--p_c", "--40-bit_complex", "--p_max_all", "-s", "25"],
            min_replays=5, mesh=mesh)
        assert launches["w40_overlap"] == 9
    finally:
        gc.collect()  # the runs' graphs go before the communicator they hold
        torch.cuda.synchronize()
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("env", ["TORCH_NCCL_BLOCKING_WAIT=1",
                                 "TORCH_NCCL_ASYNC_ERROR_HANDLING=0"])
def test_mesh_graph_windows_over_nccl_under_the_watchdog_settings(env):
    """The NCCL test above in a process of its own under a blocking wait, and with the
    watchdog's error handling off: captures that hold NCCL's trades take neither."""
    import os
    import subprocess
    import sys

    require_cuda()
    key, value = env.split("=")
    done = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q",
         __file__, "-k", "test_mesh_graph_windows_over_nccl_at_world_size_1"],
        env=dict(os.environ, **{key: value}), capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert done.returncode == 0 and "1 passed" in done.stdout, done.stdout[-3000:]


# ---------------------------------------------------------------------------
# The in-process mesh over several cards (``--devices N``) as one device program: one
# CUDA graph a window spans the cards, the trades' peer copies inside it. Each test
# skips unless the machine has the cards it names.
# ---------------------------------------------------------------------------

CARDS_FLAGS = ["--p_raw", "--p_c", "--40-bit_complex", "--p_max_all", "--p_final"]


def _cards_mesh(n):
    """`make_mesh(n)`: one shard a card, on cuda:0 .. cuda:n-1 (or a skip)."""
    from kwave_tpu_torch.parallel import make_mesh

    require_cuda()
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards; {torch.cuda.device_count()} present")
    mesh = make_mesh(n)
    assert mesh.graph_devices == tuple(torch.device("cuda", k) for k in range(n))
    return mesh


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("flags", MESH_GRAPH_FLAGS, ids=MESH_GRAPH_IDS)
def test_cards_graph_windows_equal_eager_windows(flags, n):
    """The four window-encode variants on n cards at 24^3, 8 windows and a 3-step
    tail: the windows as planned (0 eager, 1 and 2 captured, 3-7 replayed), bit for bit
    the eager run, each card's kernel launched once a window and for the tail."""
    from kwave_tpu_torch import driver, solver

    data = _graph_input((24, 24, 24), 8 * GRAPH_O + 3)
    acts, launches = _hold_graphs_to_eager(data, flags, min_replays=5, mesh=_cards_mesh(n))
    plan = driver.plan_windows(solver.SolverConfig(), GRAPH_O, 0, 8)
    assert acts == [(t, a) for t, _, a in plan]
    variant = MESH_GRAPH_IDS[MESH_GRAPH_FLAGS.index(flags)]
    assert launches[variant] == 9 * n


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 2])
def test_cards_graph_windows_against_one_device_and_shards_of_one_card(n):
    """The graph run on n cards, 4 windows and a 5-step tail, equals the graph run on n
    shards of cuda:0 bit for bit (the same kernels on the same shapes; the trades are
    copies either way), launches too, and holds p, p_max_all and p_final of one device
    to the mesh's tolerance: rtol 2e-5, atol 2e-6 of each one's peak (p_final 5e-6)."""
    from kwave_tpu_torch import driver, solver

    data = _graph_input((24, 24, 24), 4 * GRAPH_O + 5)
    cards, n_cards, acts, _ = _graph_run(data, CARDS_FLAGS, True, mesh=_cards_mesh(n))
    plan = driver.plan_windows(solver.SolverConfig(), GRAPH_O, 0, 4)
    assert acts == [(t, a) for t, _, a in plan] and acts[-1][1] == "replay"
    shards, n_shards, _, _ = _graph_run(data, CARDS_FLAGS, True, mesh=_cuda_mesh(n))
    _same_outputs(cards, shards)
    assert n_cards == n_shards
    one, _, _, _ = _graph_run(data, CARDS_FLAGS, True)
    for name, atol in (("p", 2e-6), ("p_max_all", 2e-6), ("p_final", 5e-6)):
        a, b = (np.asarray(x[name].data, np.float64) for x in (one, cards))
        np.testing.assert_allclose(b, a, rtol=2e-5, atol=atol * np.abs(a).max(),
                                   err_msg=name)


@pytest.mark.cuda
def test_cards_graph_windows_fold_the_whole_domain_and_replay_the_lead_in():
    """p_max_all, p_min_all and u_max_all folded on 4 cards in replayed windows, after a
    lead-in of 20 steps (-s 21) whose runs of 8 replay too."""
    data = _graph_input((24, 24, 24), 20 + 6 * GRAPH_O + 5)
    _hold_graphs_to_eager(data, ["--p_raw", "--p_c", "--p_max_all", "--p_min_all",
                                 "--u_max_all", "--p_rms", "-s", "21"], min_replays=3,
                          mesh=_cards_mesh(4))


@pytest.mark.cuda
def test_cards_graph_windows_of_a_card_without_sensors():
    """Every sensor in card 0's slab: the other three cards encode nothing in the
    captured windows either, so the 40-bit kernel runs once a window and for the tail."""
    data = _graph_input((24, 24, 24), 8 * GRAPH_O + 3)
    data.sensor_mask_index = np.sort(np.random.default_rng(3).choice(
        6 * 24 * 24, 256, replace=False)).astype(np.int64)
    _, launches = _hold_graphs_to_eager(data, ["--p_raw", "--p_c", "--40-bit_complex"],
                                        min_replays=5, mesh=_cards_mesh(4))
    assert launches["w40_overlap"] == 9


@pytest.mark.cuda
def test_cards_graph_windows_in_two_legs_equal_one_eager_run():
    """Two legs on 4 cards (a checkpoint after 48 steps), each with its windows replayed
    where the plan allows, equal one eager run of the whole record bit for bit."""
    from chip_smoke import MemGroup

    flags = ["--p_raw", "--p_c", "--40-bit_complex", "--p_max_all"]
    data = _graph_input((24, 24, 24), 12 * GRAPH_O + 5)
    one, n_one, _, _ = _graph_run(data, flags, False, mesh=_cards_mesh(4))
    out, ckpt = MemGroup(), MemGroup()
    _, n1, acts1, s1 = _graph_run(data, flags, True, out=out, checkpoint_file=ckpt,
                                  checkpoint_interval_steps=6 * GRAPH_O, mesh=_cards_mesh(4))
    assert s1["__checkpointed_at__"] == (6 * GRAPH_O,)
    _, n2, acts2, _ = _graph_run(data, flags, True, out=out, resume_from=ckpt,
                                 checkpoint_file=MemGroup(), mesh=_cards_mesh(4))
    _same_outputs(one, out)
    assert {k: n1[k] + n2[k] for k in n1} == n_one
    assert [a for _, a in acts1] == ["eager", "capture", "capture", "replay", "replay",
                                     "replay"]
    assert [a for _, a in acts2] == ["capture", "capture", "replay", "replay", "replay",
                                     "replay"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 2])
def test_cards_graph_of_a_pencil_program_keeps_its_memory_apart(n):
    """`graphs.Graphs` over n cards on a state-carrying program of the pencil FFT (peer
    copies in both trades) and a signal read at the time index of each shard: five
    replays equal five eager steps bit for bit, and tensors made eagerly on every card
    after the capture keep their values through the replays, the allocator's cache
    emptied between them (each card's allocations during the capture lie in the graphs'
    own pools, which the graphs hold)."""
    from kwave_tpu_torch.graphs import Graphs
    from kwave_tpu_torch.parallel import Sharded, field_sharding, replicated
    from kwave_tpu_torch.parallel.fft import dist_irfftn, dist_rfftn, spectral_sharding

    mesh = _cards_mesh(n)
    m, steps = 32, 5
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((m, m, m)).astype(np.float32)
    kern = spectral_sharding(mesh, np.exp(-rng.random((m, m, m // 2 + 1))).astype(
        np.complex64))
    signal = replicated(mesh, rng.standard_normal(steps).astype(np.float32))

    def step(x, t):
        y = dist_irfftn(dist_rfftn(x, mesh) * kern, m, mesh)
        return y * 0.5 + x * signal.index_select(0, torch.clamp(t, max=steps - 1).reshape(1))

    x = field_sharding(mesh, x0)
    for t in range(steps):
        x = step(x, Sharded([torch.tensor(t, device=d) for d in mesh.devices]))
    want = [s.cpu() for s in x.shards]
    graphs = Graphs(mesh.devices)
    start = field_sharding(mesh, x0).shards
    graphs.capture("step", start, lambda static, t: (step(Sharded(static), t).shards, None))
    assert [p.use_count() for p in graphs._pools] == [1] * (n - 1)  # held by the graphs
    torch.cuda.empty_cache()  # frees no block of the graphs' pools
    witness = [torch.full((1 << 20,), float(k + 1), device=d)
               for k, d in enumerate(mesh.devices)]
    state = start
    for t in range(steps):
        state, _ = graphs.replay("step", state, t)
        torch.cuda.empty_cache()
    assert all(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
               for a, b in zip(state, want))
    assert all(bool((w == k + 1).all()) for k, w in enumerate(witness))


# z_to_y trades [nz/S, ny, m] slabs along y into [nz, ny/S, m]; y_to_z the mirror image
TRADE_DIMS = {"z_to_y": (1, 0), "y_to_z": (0, 1)}


def _trade_parts(mesh, trade, layout, seed, nz=64, ny=64, m=33):
    """Each card's complex64 part for ``trade``: contiguous, or laid out as cuFFT's inverse
    along z returns it (strides (1, m·a, a) for a part [a, b, m]: z innermost)."""
    s = mesh.size
    a, b = (nz // s, ny) if trade == "z_to_y" else (nz, ny // s)
    g = torch.Generator().manual_seed(seed)
    parts = []
    for d in mesh.devices:
        if layout == "contiguous":
            parts.append(torch.randn(a, b, m, dtype=torch.complex64, generator=g).to(d))
        else:
            parts.append(torch.randn(b, m, a, dtype=torch.complex64, generator=g).to(d)
                         .permute(2, 0, 1))
            assert parts[-1].stride() == (1, m * a, a)
    return parts


def _same_trade(got, want):
    """Two trades' outputs equal bit for bit, shape, strides and device too."""
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert (x.shape, x.stride(), x.device) == (y.shape, y.stride(), y.device)
        assert torch.equal(torch.view_as_real(x).view(torch.int32),
                           torch.view_as_real(y).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("layout", ["contiguous", "cufft_strided"])
@pytest.mark.parametrize("trade", sorted(TRADE_DIMS))
def test_peer_trade_equals_the_cat_trade_eager_and_replayed(trade, layout, n):
    """`InProcess.all_to_all` on n cards with peer access takes the peer path (each block
    copied straight into its slot of the receiver's buffer) and equals
    `comm._cat` (each block's ``.to``, then `torch.cat`) bit for bit: eagerly, where the
    counter's ``direct`` bytes equal its ``sent`` ones, and replayed three times from a
    graph captured across the cards (`graphs.Graphs`), on new parts each time."""
    from kwave_tpu_torch.graphs import Graphs
    from kwave_tpu_torch.parallel import comm

    mesh = _cards_mesh(n)
    if not all(torch.cuda.can_device_access_peer(a, b)
               for a in mesh.devices for b in mesh.devices if a != b):
        pytest.skip(f"cards {mesh.devices} lack peer access between some pair")
    split, concat = TRADE_DIMS[trade]

    def cat(parts):
        return comm._cat([comm._chunks(p, n, split) for p in parts], mesh.devices, concat)

    parts = _trade_parts(mesh, trade, layout, 0)
    comm.TRADES.begin_step()
    got = mesh.comm.all_to_all(parts, split, concat)
    comm.TRADES.end_step()
    assert isinstance(mesh.comm._paths[tuple(mesh.devices)], comm._PeerTrade)
    _same_trade(got, cat(parts))
    step = comm.TRADES.step
    assert step["direct"] == step["sent"] == step["between_cards"]
    assert sum(step["sent"].values()) == (n - 1) * sum(p.numel() * 8 for p in parts) // n

    graphs = Graphs(mesh.devices)
    graphs.capture("trade", parts,
                   lambda static, t: (static, mesh.comm.all_to_all(static, split, concat)))
    for seed in (1, 2, 3):
        new = _trade_parts(mesh, trade, layout, seed)
        _, replayed = graphs.replay("trade", new, 0)
        _same_trade(replayed, cat(new))


# ---------------------------------------------------------------------------
# Several shards a process under a process group over NCCL (``--num_processes P
# --devices P*C``): the rank's C shards, their copies into one buffer a slot and one NCCL
# all-to-all a slot group, in one CUDA graph a window. Each test skips unless the machine
# has the cards it names.
# ---------------------------------------------------------------------------

def _nccl_group(world=1, rank=0, port=None, cards=1):
    """`initialize` over NCCL on a free local port (rank 0 picks it)."""
    import socket

    from kwave_tpu_torch.parallel.distributed import initialize

    if port is None:
        probe = socket.socket()
        probe.bind(("localhost", 0))
        port = probe.getsockname()[1]
        probe.close()
    initialize(f"localhost:{port}", world, rank, "cuda", cards=cards)


def _end_group():
    import gc

    import torch.distributed as dist

    gc.collect()  # the runs' graphs go before the communicators they hold
    torch.cuda.synchronize()
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("flags", MESH_GRAPH_FLAGS, ids=MESH_GRAPH_IDS)
def test_mesh_graph_windows_over_nccl_with_two_shards_a_rank_of_one_card(flags):
    """The four window-encode variants at world size 1 over NCCL with 2 shards of cuda:0
    (C = 2: one slot group a shard, each split from the default group on the same card):
    graphs equal eager bit for bit with equal launches, the variant's kernel once a
    window and for the tail on each shard, and both equal 2 shards of cuda:0 in one
    process."""
    from kwave_tpu_torch.parallel import make_mesh
    from kwave_tpu_torch.parallel.comm import ProcessGroup

    require_cuda()
    flags = flags + ["--p_max_all", "--p_final"]
    data = _graph_input((24, 24, 24), 8 * GRAPH_O + 3)
    one_process, _, _, _ = _graph_run(data, flags, True, mesh=_cuda_mesh(2))
    _nccl_group()
    try:
        mesh = make_mesh(2, devices=["cuda:0"] * 2)
        assert isinstance(mesh.comm, ProcessGroup) and mesh.comm.local == 2
        assert mesh.shard_ids == [0, 1] and mesh.size == 2
        assert mesh.graph_devices == (torch.device("cuda", 0),) * 2
        _, launches = _hold_graphs_to_eager(data, flags, min_replays=5, mesh=mesh)
        assert launches[MESH_GRAPH_IDS[MESH_GRAPH_FLAGS.index(flags[:-2])]] == 2 * 9
        got, _, _, _ = _graph_run(data, flags, True, mesh=mesh)
        _same_outputs(one_process, got)
    finally:
        _end_group()


def _two_by_two_rank(rank: int, port: int, out: str) -> int:
    """One of the two ranks of `test_cards_graph_two_processes_of_two_cards` (in a
    process of its own): 2 cards, graphs held to eager; rank 0 saves the graph run."""
    from chip_smoke import _save_outputs
    from kwave_tpu_torch.parallel import make_mesh

    _nccl_group(2, rank, port, cards=2)
    try:
        mesh = make_mesh(4)
        assert mesh.shard_ids == [2 * rank, 2 * rank + 1], mesh
        assert mesh.graph_devices == (torch.device("cuda", 2 * rank),
                                      torch.device("cuda", 2 * rank + 1)), mesh
        data = _graph_input((24, 24, 24), 8 * GRAPH_O + 3)
        _, launches = _hold_graphs_to_eager(data, CARDS_FLAGS, min_replays=5, mesh=mesh)
        assert launches["w40_overlap"] == 2 * 9, launches
        got, _, _, _ = _graph_run(data, CARDS_FLAGS, True, mesh=mesh)
        if rank == 0:
            _save_outputs(got, out)
        mesh.comm.barrier()
    finally:
        _end_group()
    return 0


@pytest.mark.cuda
def test_cards_graph_two_processes_of_two_cards(tmp_path):
    """2 processes x 2 cards over NCCL (each slot group bound to its card as it is made):
    each rank's graph run equals its eager run, and rank 0's file equals 4 cards in one
    process and 4 shards of cuda:0 bit for bit."""
    import os
    import subprocess
    import sys

    from chip_smoke import _differ_from_saved, _free_port

    require_cuda()
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 cards; {torch.cuda.device_count()} present")
    here = os.path.dirname(os.path.abspath(__file__))
    port, out = _free_port(), str(tmp_path / "two_by_two.npz")
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; import test_torch_cuda as t; "
            "sys.exit(t._two_by_two_rank({}, {}, {!r}))")
    procs = [subprocess.Popen([sys.executable, "-c", code.format(here, os.path.dirname(here),
                                                                 r, port, out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), [log[-3000:] for log in logs]
    data = _graph_input((24, 24, 24), 8 * GRAPH_O + 3)
    for mesh in (_cards_mesh(4), _cuda_mesh(4)):
        got, _, _, _ = _graph_run(data, CARDS_FLAGS, True, mesh=mesh)
        assert not _differ_from_saved(got, out), (mesh, _differ_from_saved(got, out))
