"""kwave_tpu_torch.encoder (exact path) against the NumPy oracle (real data, bit for bit)
and kwave_tpu.encoder (dyadic data, bit for bit): encode_chunk windows, a trailing
partial window through accumulate_chunk, and the tiny-record emit_partial. The fast path
(encode_series_frames, encode_series_fast with every packed width) against
kwave_tpu.encoder: dyadic data bit for bit, real data within rtol 1e-6 / atol 1e-2 at
amplitude 1e5 (tests/test_fastpath_ops.py's bound)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kwave_tpu import bitpack as jbitpack
from kwave_tpu import encoder as jenc
from kwave_tpu import oracle
from kwave_tpu.basis import MAX_EXP_P, generate_basis
from kwave_tpu_torch import convert, encoder
from torch_helpers import bits, dyadic_basis, dyadic_series, real_series

N = 37


def _plane_names(mode40, overlap):
    names = ("hdr1", "mr1", "mi1", "hdr2", "mr2", "mi2") if mode40 else (
        "acc1_re", "acc1_im", "acc2_re", "acc2_im")
    return names if overlap else names[: len(names) // 2]


def _port_run(series, basis, shifted, mode40, overlap):
    """Windows of oSize through encode_chunk, the remainder through accumulate_chunk."""
    cfg = encoder.EncoderConfig.for_stream(basis, shifted, mode40, overlap)
    tables = encoder.make_tables(basis, shifted)
    st = encoder.init_state(cfg, series.shape[1])
    o = basis.o_size
    frames = []
    n_win = series.shape[0] // o
    for w in range(n_win):
        st, fr = encoder.encode_chunk(st, torch.from_numpy(series[w * o : (w + 1) * o]),
                                      cfg, tables)
        frames.append(fr)
    if series.shape[0] > n_win * o:
        st = encoder.accumulate_chunk(st, torch.from_numpy(series[n_win * o :]), cfg,
                                      tables)
    return cfg, st, frames


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("mode40", [True, False])
def test_sequence_matches_oracle_on_real_data(mode40, overlap):
    basis = generate_basis(11.0, 1, 2, normalize=True)
    o = basis.o_size
    series = real_series(5 * o + 3, N, 11.0, seed=int(mode40) + 2 * int(overlap))
    _, st, frames = _port_run(series, basis, False, mode40, overlap)
    enc = oracle.OracleEncoder(basis, N, mode40=mode40, overlap=overlap,
                               total_steps=series.shape[0])
    frames_o = enc.encode_series(series)
    assert len(frames) == len(frames_o) == series.shape[0] // o
    for w, (fr, fo) in enumerate(zip(frames, frames_o)):
        for k, (a, b) in enumerate(zip(fr, fo)):
            np.testing.assert_array_equal(bits(a.T.contiguous()),
                                          bits(b.astype(np.uint32) if mode40 else b),
                                          err_msg=f"frame {w} plane {k}")
    # the live accumulators after the tail equal the oracle's
    for name in _plane_names(mode40, overlap):
        want = getattr(enc, name)
        np.testing.assert_array_equal(bits(st[name].T.contiguous()),
                                      bits(want.astype(np.uint32) if mode40 else want),
                                      err_msg=name)
    assert st["sampled_step"] == enc.sampled_step
    assert st["compressed_step"] == enc.compressed_step


@pytest.mark.parametrize("mode40", [True, False])
def test_tiny_record_emit_partial_matches_oracle(mode40):
    basis = generate_basis(16.0, 1, 1, normalize=True)
    series = real_series(basis.o_size - 3, N, 16.0, seed=8)
    cfg, st, frames = _port_run(series, basis, False, mode40, True)
    assert frames == []
    st, frame = encoder.emit_partial(st, cfg)
    frames_o = oracle.OracleEncoder(basis, N, mode40=mode40,
                                    total_steps=series.shape[0]).encode_series(series)
    assert len(frames_o) == 1 and st["compressed_step"] == 1
    for a, b in zip(frame, frames_o[0]):
        np.testing.assert_array_equal(bits(a.T.contiguous()),
                                      bits(b.astype(np.uint32) if mode40 else b))


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("mode40", [True, False])
def test_sequence_matches_jax_encoder_on_dyadic_data(mode40, overlap, shifted):
    basis = dyadic_basis(o=8, harmonics=2)
    o = basis.o_size
    series = dyadic_series(4 * o + 5, N, seed=3, scale=128.0 if mode40 else 1.0)
    cfg, st, frames = _port_run(series, basis, shifted, mode40, overlap)

    jcfg = jenc.EncoderConfig.for_stream(basis, shifted, mode40, overlap)
    jtab = jenc.make_tables(basis, shifted)
    jst = jenc.init_state(jcfg, N)
    for w in range(4):
        jst, jfr = jenc.encode_chunk(jst, jnp.asarray(series[w * o : (w + 1) * o]), jcfg,
                                     jtab)
        for k, (a, b) in enumerate(zip(frames[w], jfr)):
            np.testing.assert_array_equal(bits(a), bits(b), err_msg=f"frame {w} {k}")
    jst = jenc.accumulate_chunk(jst, jnp.asarray(series[4 * o :]), jcfg, jtab)
    # the tail's partial frame, force-emitted by both
    st, fr = encoder.emit_partial(st, cfg)
    jst, jfr = jenc.emit_partial(jst, jcfg)
    for a, b in zip(fr, jfr):
        np.testing.assert_array_equal(bits(a), bits(b))
    mine = convert.encoder_state_to_numpy(st)
    assert set(mine) == set(jst)
    for k, v in jst.items():
        np.testing.assert_array_equal(bits(mine[k]), bits(np.asarray(v)), err_msg=k)


@pytest.mark.parametrize("mode40", [True, False])
def test_encoder_state_converts_both_ways(mode40):
    basis = dyadic_basis(o=4, harmonics=1)
    jcfg = jenc.EncoderConfig.for_stream(basis, False, mode40, True)
    jst, _ = jenc.encode_chunk(jenc.init_state(jcfg, 9),
                               jnp.asarray(dyadic_series(4, 9, scale=128.0)), jcfg,
                               jenc.make_tables(basis, False))
    port = convert.encoder_state_from_jax(jst)
    assert port["sampled_step"] == 4 and port["compressed_step"] == 1
    assert port["hdr1" if mode40 else "acc1_re"].dtype == (
        torch.int32 if mode40 else torch.float32)
    back = convert.encoder_state_to_numpy(port)
    for k, v in jst.items():
        np.testing.assert_array_equal(bits(back[k]), bits(np.asarray(v)), err_msg=k)
        assert back[k].dtype == np.asarray(v).dtype


def test_encode_chunk_rejects_misaligned_or_wrong_length_windows():
    basis = dyadic_basis(o=4, harmonics=1)
    cfg = encoder.EncoderConfig.for_stream(basis, False, False, True)
    tables = encoder.make_tables(basis, False)
    st = encoder.init_state(cfg, 3)
    with pytest.raises(ValueError, match="takes 4 steps"):
        encoder.encode_chunk(st, torch.zeros((3, 3)), cfg, tables)
    st = encoder.accumulate_chunk(st, torch.zeros((2, 3)), cfg, tables)
    with pytest.raises(ValueError, match="multiple of oSize"):
        encoder.encode_chunk(st, torch.zeros((4, 3)), cfg, tables)


# ---------------------------------------------------------------------------
# Fast path: whole-series windowed projection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("compute", ["flat", "vpu"])
def test_encode_series_frames_matches_jax(monkeypatch, use_pallas, compute):
    """Real data at amplitude 1e5 within rtol 1e-6 / atol 1e-2 of both JAX paths (its
    einsum and, with USE_PALLAS, its kernels in interpret mode); a record shorter than
    one window gives no frames."""
    monkeypatch.setattr(jenc, "USE_PALLAS", use_pallas)
    basis = generate_basis(20.0, 1, 2, normalize=True)
    o = basis.o_size
    x = real_series(7 * o + 4, N, 20.0, seed=12)
    mine = encoder.encode_series_frames(torch.from_numpy(x), basis, compute=compute)
    theirs = jenc.encode_series_frames(jnp.asarray(x), basis,
                                       compute="flat" if compute == "flat" else "vpu")
    assert mine.shape == (7, 4, N)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-2)
    short = encoder.encode_series_frames(torch.from_numpy(x[: o - 1]), basis)
    assert short.shape == (0, 4, N)


@pytest.mark.parametrize("bits_", [None, 8, 16, 24, 32, 40])
@pytest.mark.parametrize("overlap", [True, False])
def test_encode_series_fast_bit_exact_on_dyadic_data(overlap, bits_):
    """Float frames are bit-exact on dyadic data, so every packed width is too."""
    basis = dyadic_basis(o=8, harmonics=2)
    for shifted in (False, True):
        x = dyadic_series(6 * 8 + 5, N, seed=4, scale=64.0)
        mine = encoder.encode_series_fast(torch.from_numpy(x), basis, shifted,
                                          overlap=overlap, bits=bits_)
        theirs = jenc.encode_series_fast(jnp.asarray(x), basis, shifted, overlap=overlap,
                                         bits=bits_)
        assert len(mine) == len(theirs) == (2 if bits_ is None else 3)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(bits(a), bits(np.asarray(b)))


@pytest.mark.parametrize("overlap", [True, False])
def test_encode_series_fast_matches_jax_on_real_data(overlap):
    basis = generate_basis(16.0, 1, 3, normalize=True)
    x = real_series(6 * basis.o_size + 3, N, 16.0, seed=13)
    mine = encoder.encode_series_fast(torch.from_numpy(x), basis, overlap=overlap)
    theirs = jenc.encode_series_fast(jnp.asarray(x), basis, overlap=overlap)
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-2)
    mine40 = encoder.encode_series_fast(torch.from_numpy(x), basis, overlap=overlap,
                                        mode40=True)
    # the same float frames pack to the same 40-bit words
    from_mine = jbitpack.encode40(mine[0].numpy(), mine[1].numpy(), MAX_EXP_P)
    for a, b in zip(mine40, from_mine):
        np.testing.assert_array_equal(bits(a), bits(np.asarray(b)))


def test_encode_series_fast_refuses_other_precisions():
    basis = dyadic_basis(o=4, harmonics=1)
    with pytest.raises(ValueError, match="split3"):
        encoder.encode_series_fast(torch.zeros((8, 3)), basis, precision="split3")
    with pytest.raises(ValueError, match="default"):
        encoder.encode_series_fast(torch.zeros((8, 3)), basis, overlap=False,
                                   precision="default")


def test_frames_to_flat_match_jax():
    rng = np.random.default_rng(14)
    f_re, f_im = (rng.standard_normal((3, 2, 11)).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(
        encoder.frames_to_flat_float(torch.from_numpy(f_re), torch.from_numpy(f_im)),
        jenc.frames_to_flat_float(f_re, f_im))
    planes = [rng.integers(0, hi, (3, 2, 11)).astype(np.uint32)
              for hi in (256, 65536, 65536)]
    mine = encoder.frames_to_flat_40b(*(torch.from_numpy(p.view(np.int32)) for p in planes))
    np.testing.assert_array_equal(mine, jenc.frames_to_flat_40b(*planes))
    np.testing.assert_array_equal(
        encoder.frames_to_flat_40b(*(torch.from_numpy(p[0].view(np.int32))
                                     for p in planes)),
        jenc.frames_to_flat_40b(*(p[0] for p in planes)))


@pytest.mark.parametrize("packed", [False, True])
def test_frames_convert_from_and_to_jax(packed):
    basis = dyadic_basis(o=4, harmonics=2)
    x = jnp.asarray(dyadic_series(5 * 4, 9, seed=2, scale=64.0))
    if packed:
        theirs = jenc.encode_series_fast(x, basis, bits=24)
        mine = convert.frames_from_jax(theirs)
        assert isinstance(mine, tuple) and all(a.dtype == torch.int32 for a in mine)
    else:
        theirs = jenc.encode_series_frames(x, basis)
        mine = convert.frames_from_jax(theirs)
        assert mine.dtype == torch.float32
    back = convert.frames_to_numpy(mine)
    for a, b in zip(back if packed else (back,), theirs if packed else (theirs,)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(bits(a), bits(np.asarray(b)))
