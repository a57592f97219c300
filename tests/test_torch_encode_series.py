"""The whole-record exact encode of the port (`ops.encode_series`, `encoder.encode_steps`,
`encoder.encode_series_exact`) on the CPU, where the wrappers take their plain versions.

Held bit for bit against the NumPy oracle on real data and against the port's own window
loop (`encoder.encode_chunk`), which both round every product. Against the JAX entries
(`kwave_tpu.ops.encode_pallas.encode_series_*` with ``interpret=True``): bit for bit on
dyadic data, whose products are exact; on real data within 1e-6 of the frames' peak for
the float planes and 2e-6 of the peak for the decoded 40-bit planes, because XLA:CPU
contracts mul+add into an FMA inside the interpreted loop body, so each of the o steps of
a window may differ by half an ulp of the running sum (tests/test_pallas_ops.py holds the
JAX window kernel to the oracle at atol 1e-2 on amplitude 1e5 for the same reason; a
sum near cancellation makes a relative bound meaningless).

The kernels split a record into chunks of G windows and recompute the live buffer over the
window before each chunk; the plain versions do the same with ``chunk_windows``, and are
held bit for bit to the unsplit plain versions (real data) and to the JAX entries (dyadic
data)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kwave_tpu import encoder as jenc
from kwave_tpu.ops import encode_pallas as ep
from kwave_tpu_torch import bitpack, convert, encoder, oracle
from kwave_tpu_torch.basis import MAX_EXP_P, generate_basis
from kwave_tpu_torch.ops import encode_series as es
from torch_helpers import bits, dyadic_basis, dyadic_series, real_series, stacked_tables

VARIANTS = [(True, True), (True, False), (False, True), (False, False)]  # (mode40, overlap)
STATE_KEYS = {True: ("hdr1", "mr1", "mi1", "hdr2", "mr2", "mi2"),
              False: ("acc1_re", "acc1_im", "acc2_re", "acc2_im")}


def _entry(series, tabs, o, mode40, overlap):
    x, t = torch.from_numpy(series), torch.from_numpy(tabs)
    if mode40:
        return es.encode_series_40b(x, t, MAX_EXP_P, o, overlap)
    return es.encode_series_float_exact(x, t, o, overlap)


def _oracle(series, basis, mode40, overlap, total=None):
    enc = oracle.OracleEncoder(basis, series.shape[1], mode40=mode40, overlap=overlap,
                               total_steps=total or series.shape[0])
    return enc, enc.encode_series(series)


def _assert_frames_equal_oracle(frames, frames_o, mode40):
    assert frames[0].shape[0] == len(frames_o)
    for k, fo in enumerate(frames_o):
        for plane, b in zip(frames, fo):
            np.testing.assert_array_equal(bits(plane[k].T.contiguous()),
                                          bits(b.astype(np.uint32) if mode40 else b),
                                          err_msg=f"frame {k}")


@pytest.mark.parametrize("mode40,overlap", VARIANTS)
@pytest.mark.parametrize("h,windows,n", [(1, 1, 37), (2, 4, 300), (4, 5, 130), (2, 2, 33)])
def test_entries_match_oracle_and_window_loop(mode40, overlap, h, windows, n):
    """K = 1, even and odd, H = 1, 2, 4, ragged N, steps beyond the last window ignored:
    frames and the post-emission state equal the oracle's and the window loop's bits."""
    basis = generate_basis(11.0, 1, h, normalize=True)
    o = basis.o_size
    series = real_series(windows * o + 3, n, 11.0, seed=h + windows)
    frames, state = _entry(series, stacked_tables(basis), o, mode40, overlap)
    assert len(frames) == (3 if mode40 else 2) and len(state) == (6 if mode40 else 4)
    assert all(tuple(f.shape) == (windows, h, n) for f in frames)
    enc, frames_o = _oracle(series[: windows * o], basis, mode40, overlap,
                            total=windows * o + 3)
    _assert_frames_equal_oracle(frames, frames_o, mode40)
    names = STATE_KEYS[mode40]
    for name, plane in zip(names, state):
        if not overlap and name.endswith("2") or not overlap and "acc2" in name:
            assert not plane.any()  # one accumulator: the second set is zeros
            continue
        want = getattr(enc, name)
        np.testing.assert_array_equal(bits(plane.T.contiguous()),
                                      bits(want.astype(np.uint32) if mode40 else want),
                                      err_msg=name)
    # the port's own window loop
    cfg = encoder.EncoderConfig.for_stream(basis, False, mode40, overlap)
    tables = encoder.make_tables(basis, False)
    st = encoder.init_state(cfg, n)
    for k in range(windows):
        st, fr = encoder.encode_chunk(st, torch.from_numpy(series[k * o:(k + 1) * o]), cfg,
                                      tables)
        for a, b in zip(fr, frames):
            np.testing.assert_array_equal(bits(a), bits(b[k]), err_msg=f"window {k}")
    for name, plane in zip(names, state):
        if name in st:
            np.testing.assert_array_equal(bits(st[name]), bits(plane), err_msg=name)


@pytest.mark.parametrize("mode40,overlap", VARIANTS)
@pytest.mark.parametrize("windows", [1, 4, 5])
def test_entries_match_jax_entries_on_dyadic_data(mode40, overlap, windows):
    basis = dyadic_basis(o=8, harmonics=2)
    o, n = basis.o_size, 200  # n not a lane multiple: the JAX wrapper pads, the port masks
    series = dyadic_series(windows * o + 2, n, seed=windows, scale=128.0 if mode40 else 1.0)
    tabs = stacked_tables(basis)
    frames, state = _entry(series, tabs, o, mode40, overlap)
    if mode40:
        jf, js = ep.encode_series_40b(jnp.asarray(series), jnp.asarray(tabs), MAX_EXP_P, o,
                                      overlap=overlap, interpret=True)
    else:
        jf, js = ep.encode_series_float_exact(jnp.asarray(series), jnp.asarray(tabs), o,
                                              overlap=overlap, interpret=True)
    assert len(jf) == len(frames) and len(js) == len(state)
    for a, b in zip(frames + state, tuple(jf) + tuple(js)):
        np.testing.assert_array_equal(bits(a), bits(np.asarray(b)))


def _plain(series, tabs, o, mode40, overlap, chunk_windows=None):
    x, t = torch.from_numpy(series), torch.from_numpy(tabs)
    if mode40:
        return es.encode_series_40b_plain(x, t, MAX_EXP_P, o, overlap, chunk_windows)
    return es.encode_series_float_exact_plain(x, t, o, overlap, chunk_windows)


@pytest.mark.parametrize("mode40,overlap", VARIANTS)
@pytest.mark.parametrize("g", [1, 2, 3, 8])
@pytest.mark.parametrize("windows", [1, 2, 5, 8, 13])
def test_chunked_plain_equals_unchunked_plain(mode40, overlap, g, windows):
    """The kernels' decomposition, in the plain version: chunks of G windows, each from
    zero accumulators plus the live buffer recomputed over the window before it, give the
    unsplit record's frames and final state bit for bit (K < G, K a multiple of G and
    not, odd and even chunk boundaries)."""
    basis = generate_basis(7.0, 1, 2, normalize=True)
    o, n = basis.o_size, 21
    series = real_series(windows * o + 2, n, 7.0, seed=10 * windows + g)
    tabs = stacked_tables(basis)
    whole = _plain(series, tabs, o, mode40, overlap)
    split = _plain(series, tabs, o, mode40, overlap, chunk_windows=g)
    assert all(tuple(f.shape) == (windows, 2, n) for f in split[0])
    for a, b in zip(whole[0] + whole[1], split[0] + split[1]):
        np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.parametrize("mode40,overlap", VARIANTS)
@pytest.mark.parametrize("g,windows", [(1, 5), (2, 5), (3, 8), (8, 13), (8, 2)])
def test_chunked_entries_match_jax_entries_on_dyadic_data(mode40, overlap, g, windows):
    """The plain versions cut into the kernels' chunks against the JAX entries."""
    basis = dyadic_basis(o=8, harmonics=2)
    o, n = basis.o_size, 40
    series = dyadic_series(windows * o + 2, n, seed=windows, scale=128.0 if mode40 else 1.0)
    tabs = stacked_tables(basis)
    frames, state = _plain(series, tabs, o, mode40, overlap, chunk_windows=g)
    if mode40:
        jf, js = ep.encode_series_40b(jnp.asarray(series), jnp.asarray(tabs), MAX_EXP_P, o,
                                      overlap=overlap, interpret=True)
    else:
        jf, js = ep.encode_series_float_exact(jnp.asarray(series), jnp.asarray(tabs), o,
                                              overlap=overlap, interpret=True)
    for a, b in zip(frames + state, tuple(jf) + tuple(js)):
        np.testing.assert_array_equal(bits(a), bits(np.asarray(b)))


@pytest.mark.parametrize("k_total,want", [
    (1, 8), (5, 8), (204, 8), (8 * 65535, 8), (8 * 65535 + 1, 9), (1_000_000, 16)])
def test_chunk_windows_for(k_total, want):
    """G is 8, and more only to keep the chunks within one launch's 65535."""
    assert es.chunk_windows_for(k_total) == want
    assert -(-k_total // want) <= es.MAX_CHUNKS


@pytest.mark.parametrize("mode40,overlap", VARIANTS)
def test_entries_match_jax_entries_on_real_data(mode40, overlap):
    basis = generate_basis(10.0, 1, 2, normalize=True)
    o, n = basis.o_size, 96
    series = real_series(4 * o, n, 10.0, seed=11)
    tabs = stacked_tables(basis)
    frames, state = _entry(series, tabs, o, mode40, overlap)
    if mode40:
        jf, js = ep.encode_series_40b(jnp.asarray(series), jnp.asarray(tabs), MAX_EXP_P, o,
                                      overlap=overlap, interpret=True)
        peak = float(np.abs(series).max()) * o
        for k in (0, 3):
            mine = bitpack.decode40(*(p for p in (frames + state)[k:k + 3]), MAX_EXP_P)
            theirs = bitpack.decode40(*(torch.from_numpy(np.array(p).view(np.int32))
                                        for p in (tuple(jf) + tuple(js))[k:k + 3]),
                                      MAX_EXP_P)
            for a, b in zip(mine, theirs):
                assert float((a - b).abs().max()) <= 2e-6 * peak
    else:
        jf, js = ep.encode_series_float_exact(jnp.asarray(series), jnp.asarray(tabs), o,
                                              overlap=overlap, interpret=True)
        peak = max(float(np.abs(np.asarray(f)).max()) for f in jf)
        for a, b in zip(frames + state, tuple(jf) + tuple(js)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6 * peak)


@pytest.mark.parametrize("mode40,overlap", VARIANTS)
@pytest.mark.parametrize("case", ["rem", "aligned", "one_window", "tiny", "tiny_total",
                                  "short_of_longer"])
def test_encode_series_exact_branches_match_oracle(mode40, overlap, case):
    """Every branch of encode_series_exact against the oracle, bit for bit: a trailing
    remainder, an aligned record, the record of exactly one window, the tiny record
    (T < o: the lastStep frame), a tiny total_steps, and fewer steps than one window of a
    longer record (no frame yet)."""
    basis = generate_basis(11.0, 1, 2, normalize=True)
    o, n = basis.o_size, 37
    steps, total = {"rem": (4 * o + 5, None), "aligned": (3 * o, None),
                    "one_window": (o, None), "tiny": (o - 4, None),
                    "tiny_total": (o - 2, o - 2), "short_of_longer": (o - 3, 5 * o)}[case]
    series = real_series(steps, n, 11.0, seed=steps)
    frames, st = encoder.encode_series_exact(torch.from_numpy(series), basis, mode40=mode40,
                                             overlap=overlap, total_steps=total)
    enc, frames_o = _oracle(series, basis, mode40, overlap, total=total)
    want_frames = {"rem": 4, "aligned": 3, "one_window": 1, "tiny": 1, "tiny_total": 1,
                   "short_of_longer": 0}[case]
    assert len(frames_o) == want_frames
    assert all(tuple(f.shape) == (want_frames, 2, n) for f in frames)
    _assert_frames_equal_oracle(frames, frames_o, mode40)
    assert st["sampled_step"] == enc.sampled_step == steps
    assert st["compressed_step"] == want_frames
    keys = STATE_KEYS[mode40][: (6 if mode40 else 4) // (1 if overlap else 2)]
    assert set(st) == set(keys) | {"sampled_step", "compressed_step"}
    if case not in ("tiny", "tiny_total"):  # there the oracle does not zero after lastStep
        for name in keys:
            want = getattr(enc, name)
            np.testing.assert_array_equal(bits(st[name].T.contiguous()),
                                          bits(want.astype(np.uint32) if mode40 else want),
                                          err_msg=name)


@pytest.mark.parametrize("mode40,overlap", VARIANTS)
def test_encode_series_exact_matches_jax_on_dyadic_data(mode40, overlap, monkeypatch):
    """Against kwave_tpu.encoder.encode_series_exact through its kernels (USE_PALLAS, in
    interpret mode on the CPU), frames and state, with a trailing remainder."""
    import jax

    monkeypatch.setattr(jenc, "USE_PALLAS", True)
    jax.clear_caches()
    basis = dyadic_basis(o=8, harmonics=2)
    series = dyadic_series(3 * 8 + 5, 37, seed=9, scale=128.0 if mode40 else 1.0)
    frames, st = encoder.encode_series_exact(torch.from_numpy(series), basis, mode40=mode40,
                                             overlap=overlap)
    jframes, jst = jenc.encode_series_exact(series, basis, mode40=mode40, overlap=overlap)
    jax.clear_caches()
    for a, b in zip(frames, jframes):
        np.testing.assert_array_equal(bits(a), bits(np.asarray(b)))
    mine = convert.encoder_state_to_numpy(st)
    assert set(mine) == set(jst)
    for k, v in jst.items():
        np.testing.assert_array_equal(bits(mine[k]), bits(np.asarray(v)), err_msg=k)


@pytest.mark.parametrize("mode40,overlap", VARIANTS)
def test_encode_steps_continues_a_record(mode40, overlap):
    """The continuation of tests/test_jax_codec.py: after a record with a trailing
    remainder, further steps through encode_steps cross the next saving boundary and emit
    the frame the oracle emits for the joined record; and a whole record fed step by step
    from fresh state (mirror at the first saving step only) equals encode_series_exact."""
    basis = generate_basis(8.0, 1, 2, normalize=True)
    o, n = basis.o_size, 29
    steps = 3 * o + 5
    series = real_series(steps + o + 1, n, 8.0, seed=21)
    frames, st = encoder.encode_series_exact(torch.from_numpy(series[:steps]), basis,
                                             mode40=mode40, overlap=overlap)
    cfg = encoder.EncoderConfig.for_stream(basis, False, mode40, overlap)
    tables = encoder.make_tables(basis, False)
    st, extra = encoder.encode_steps(st, torch.from_numpy(series[steps:]), cfg, tables)
    enc, frames_o = _oracle(series, basis, mode40, overlap)
    assert len(extra) == 1 and len(frames_o) == 4
    for a, b in zip(extra[0], frames_o[3]):
        np.testing.assert_array_equal(bits(a.T.contiguous()),
                                      bits(b.astype(np.uint32) if mode40 else b))
    assert st["sampled_step"] == series.shape[0] and st["compressed_step"] == 4

    st2, all_frames = encoder.encode_steps(encoder.init_state(cfg, n),
                                           torch.from_numpy(series[: 3 * o]), cfg, tables)
    assert len(all_frames) == 3
    for k, fr in enumerate(all_frames):
        for a, b in zip(fr, frames):
            np.testing.assert_array_equal(bits(a), bits(b[k]), err_msg=f"frame {k}")


def test_encode_steps_matches_jax_on_dyadic_data():
    basis = dyadic_basis(o=8, harmonics=1)
    o, n = basis.o_size, 6
    series = dyadic_series(3 * o + 5, n, seed=9)
    more = dyadic_series(o - 5, n, seed=10)
    _, st = encoder.encode_series_exact(torch.from_numpy(series), basis)
    _, jst = jenc.encode_series_exact(series, basis)
    cfg = encoder.EncoderConfig.for_stream(basis, False, False, True)
    jcfg = jenc.EncoderConfig.for_stream(basis, False, False, True)
    st, extra = encoder.encode_steps(st, torch.from_numpy(more), cfg,
                                     encoder.make_tables(basis, False))
    jst, jextra = jenc.encode_steps(jst, np.asarray(more, np.float32), jcfg,
                                    jenc.make_tables(basis, False))
    assert len(extra) == len(jextra) == 1
    for a, b in zip(extra[0], jextra[0]):
        np.testing.assert_array_equal(bits(a), bits(np.asarray(b)))
    mine = convert.encoder_state_to_numpy(st)
    for k, v in jst.items():
        np.testing.assert_array_equal(bits(mine[k]), bits(np.asarray(v)), err_msg=k)


def test_frames_to_flat_bytes_equal_the_oracles():
    """Path A's last link: the frames of encode_series_exact through frames_to_flat_* give
    the oracle's byte stream."""
    basis = generate_basis(11.0, 1, 2, normalize=True)
    series = real_series(3 * 11 + 2, 19, 11.0, seed=2)
    x = torch.from_numpy(series)
    _, fo40 = _oracle(series, basis, True, True)
    f40, _ = encoder.encode_series_exact(x, basis, mode40=True)
    want = np.stack([oracle.soa_to_bytes(*fr) for fr in fo40])
    np.testing.assert_array_equal(encoder.frames_to_flat_40b(*f40), want)
    _, fof = _oracle(series, basis, False, True)
    ff, _ = encoder.encode_series_exact(x, basis)
    want = np.stack([np.stack(fr, -1).reshape(-1) for fr in fof])
    np.testing.assert_array_equal(bits(encoder.frames_to_flat_float(*ff)), bits(want))


def test_entries_refuse_bad_arguments():
    basis = dyadic_basis(o=4, harmonics=1)
    tabs = torch.from_numpy(stacked_tables(basis))
    x = torch.zeros((9, 5))
    with pytest.raises(ValueError, match="less than one window"):
        es.encode_series_float_exact(x[:3], tabs, 4)
    with pytest.raises(ValueError, match="tabs must be"):
        es.encode_series_40b(x, tabs, MAX_EXP_P, 5)
    with pytest.raises(ValueError, match="float32"):
        es.encode_series_float_exact(x.double(), tabs, 4)
    with pytest.raises(ValueError, match="contiguous"):
        es.encode_series_float_exact(x.T.contiguous().T, tabs, 4)
    with pytest.raises(ValueError, match="chunk_windows"):
        es.encode_series_float_exact_plain(x, tabs, 4, chunk_windows=0)
    before = dict(es.LAUNCHES)
    es.encode_series_float_exact(x, tabs, 4)
    assert es.LAUNCHES == before  # the plain version counts nothing
