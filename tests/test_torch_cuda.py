"""The port's CUDA kernels on the card (each test skips, with its reason, without one).

This file imports no jax, so it also runs on a GPU machine without JAX; there, from the
repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports jax; the ``cuda`` marker it registers
is then unknown, which pytest only warns about.)
"""

import numpy as np
import pytest
import torch

from kwave_tpu_torch import oracle
from kwave_tpu_torch.basis import MAX_EXP_P, generate_basis
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
@pytest.mark.parametrize("overlap,threads,split,packed", [
    (True, None, None, False), (True, 64, 1, False), (True, 32, 2, False),
    (True, 128, 2, False), (True, 256, 1, False), (True, 256, 1, True),
    (False, None, None, False), (False, 32, 1, False), (False, 256, 1, False),
    (False, 256, 1, True)])
def test_w40_kernel_designs_match_plain(overlap, threads, split, packed):
    """The 40-bit window kernel as the wrapper launches it, with one thread a sensor and
    one lane a buffer, at other block sizes, and the baseline that packs its words at every
    step: all bit-identical to the plain version and to the reference's loop as written,
    at H = 1..3, both parities, the mirror, a partial window, one step, and N ragged against
    the warp (16 or 32 sensors) and the block."""
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
                got = ew._kernel_40b(*args, threads=threads, split=split, packed=packed)
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
        ew._kernel_40b(chunk, tabs, planes, MAX_EXP_P, 0, 0, True, threads=48)
    with pytest.raises(RuntimeError, match="cudaError"):
        ew._kernel_40b(chunk, tabs, planes[:3], MAX_EXP_P, 0, 0, False, split=2)
    with pytest.raises(RuntimeError, match="cudaError"):
        ew._kernel_40b(chunk, tabs, planes, ew.MAX_E_CONST + 1, 0, 0, True)
    ew.launch_floor(basis.o_size, 1, N)
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
        for threads, rows in ((32, 1), (256, 2), (128, 16)):  # other geometries, same bits
            other, _ = fastpath.launch_window_projection(chunk, lo, hi, p1, w == 0,
                                                         threads=threads, rows=rows)
            np.testing.assert_array_equal(bits(other), bits(flat[w]),
                                          err_msg=f"window {w} rows {rows}")
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
@pytest.mark.parametrize("nz,ny,nx", [(32, 16, 256), (100, 12, 260), (256, 8, 256)])
@pytest.mark.parametrize("n_ops", [1, 3])
def test_zfuse_kernel_matches_plain_and_float64(nz, ny, nx, n_ops):
    """K7 at nz = 32, 100 (not a power of two: the dense kernel) and 256, nxr = 129 and
    131, one op and three: within 2e-6 of the peak of `apply_plain` and of a float64
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
    equal and unequal radices), nxr = 129 and 131 (131 leaves a ragged last tile), one op
    and three, grad on each axis with and without kappa, and nabla: within 2e-6 of the
    peak of a float64 FFT, 4e-6 of `apply_plain` (the dense fp32 sum, itself up to 1.3e-6
    off float64 where the radix passes are 2e-7 off: the sum of the two bounds) and of
    `apply_radix_plain`; every launch counted as the radix kernel's."""
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
    assert zfuse.kernel_for(nz) == "radix" and plan.passes == zfuse.radix_passes(nz)
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
        assert zfuse.KERNEL_LAUNCHES == {"radix": before["radix"] + 1,
                                         "dense": before["dense"]}
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
def test_zfuse_dense_kernel_takes_other_nz():
    """nz = 100 and nz = 4 go to the dense kernel and count as its launches."""
    from kwave_tpu_torch.ops import zfuse

    dev = require_cuda()
    for nz in (100, 4):
        ny, nx = 4, 16
        k2 = [(np.fft.fftfreq(m) * 2 * np.pi * m / 1e-2) ** 2 for m in (nz, ny)]
        k2.append((np.fft.rfftfreq(nx) * 2 * np.pi * nx / 1e-2) ** 2)
        plan = zfuse.make_plan((nz, ny, nx), *k2, 1e-5, dev)
        assert plan.passes is None
        rng = np.random.default_rng(nz)
        sizes = (nz, ny, plan.nxr)
        s = torch.from_numpy((rng.standard_normal(sizes) + 1j * rng.standard_normal(sizes))
                             .astype(np.complex64)).to(dev)
        before = dict(zfuse.KERNEL_LAUNCHES)
        specs = (zfuse.OpSpec("nabla", power=0.5),)
        got = zfuse.apply(plan, s, specs, ())[0]
        torch.cuda.synchronize()
        assert zfuse.KERNEL_LAUNCHES == {"radix": before["radix"],
                                         "dense": before["dense"] + 1}
        want = zfuse.apply_plain(plan, s, specs, ())[0]
        assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())


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
