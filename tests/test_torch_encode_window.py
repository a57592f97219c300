"""The window-encode op (kwave_tpu_torch.ops.encode_window), all four variants.

On the CPU the plain versions run: bit-for-bit against the Pallas kernels of
kwave_tpu.ops.encode_pallas in interpret mode (dyadic-exact data, since XLA:CPU contracts
mul+add) and against kwave_tpu.oracle (real-valued data: torch's eager CPU ops round every
product, as the reference does). The CUDA kernels are held bit-for-bit against their
plain versions on the card in tests/test_torch_cuda.py.

The 40-bit plain version computes as the kernel does: each buffer a chain of its own, held
between steps as the floats its words decode to (`bitpack.quantize40`). It is held bit for
bit to the reference's loop as written (`encode_window_40b_exact_unsplit_plain`), and
`quantize40` to ``decode40(encode40(.))`` on drawn and on enumerated float pairs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kwave_tpu import oracle
from kwave_tpu.basis import MAX_EXP_P, MAX_EXP_U, generate_basis
from kwave_tpu.ops import encode_pallas
from kwave_tpu_torch import bitpack, encoder
from kwave_tpu_torch.ops import encode_window as ew
from torch_helpers import (
    bits,
    dyadic_basis,
    dyadic_series,
    real_series,
    stacked_tables,
)

N = 200  # not a multiple of 32 or 128


def _initial_planes(mode40, overlap, h, seed):
    """Nonzero starting accumulators (dyadic values, so every product stays exact)."""
    rng = np.random.default_rng(seed)
    n_acc = 2 if overlap else 1
    vals = [(rng.integers(-64, 65, (h, N)) * 4.0).astype(np.float32)
            for _ in range(2 * n_acc)]
    if not mode40:
        return vals
    planes = []
    for k in range(n_acc):
        planes += [a.astype(np.uint32) for a in oracle.encode40(vals[2 * k],
                                                                 vals[2 * k + 1],
                                                                 MAX_EXP_P)]
    return planes


def _run_plain(mode40, chunk, tabs, planes, parity, mirror, overlap):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    if mode40:
        return ew.encode_window_40b_exact(
            t(chunk), t(tabs), tuple(t(p.view(np.int32)) for p in planes), MAX_EXP_P,
            parity, mirror, overlap)
    return ew.encode_window_float_exact(t(chunk), t(tabs), tuple(t(p) for p in planes),
                                        parity, mirror, overlap)


@pytest.mark.parametrize("mirror", [0, 1])
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("mode40", [True, False])
def test_plain_matches_pallas_interpret(mode40, overlap, h, parity, mirror):
    basis = dyadic_basis(o=8, harmonics=h)
    tabs = stacked_tables(basis)
    chunk = dyadic_series(basis.o_size, N, seed=parity + 2 * h,
                          scale=128.0 if mode40 else 1.0)
    planes = _initial_planes(mode40, overlap, h, seed=h)
    mine = _run_plain(mode40, chunk, tabs, planes, parity, mirror, overlap)
    jp = tuple(jnp.asarray(p) for p in planes)
    if mode40:
        ref = encode_pallas.encode_window_40b_exact(
            jnp.asarray(chunk), jnp.asarray(tabs), jp, MAX_EXP_P, parity, mirror,
            overlap=overlap, interpret=True)
    else:
        ref = encode_pallas.encode_window_float_exact(
            jnp.asarray(chunk), jnp.asarray(tabs), jp, parity, mirror, overlap=overlap,
            interpret=True)
    assert len(mine) == len(ref)
    for k, (a, b) in enumerate(zip(mine, ref)):
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=f"plane {k}")


@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("mode40", [True, False])
def test_plain_matches_oracle_on_real_data(mode40, overlap, h):
    """Chain windows as the encoder does (parity alternating, the mirror in window 0,
    odd/even emission with zeroing) and hold every frame against the oracle."""
    basis = generate_basis(12.0, 1, h, normalize=True)
    o, windows = basis.o_size, 4
    x = real_series(o * windows, N, 12.0, seed=h)
    frames_o = oracle.OracleEncoder(basis, N, mode40=mode40, overlap=overlap,
                                    total_steps=o * windows).encode_series(x)
    tabs = torch.from_numpy(stacked_tables(basis))
    dtype = torch.int32 if mode40 else torch.float32
    per_buf = 3 if mode40 else 2
    n_planes = per_buf * (2 if overlap else 1)
    planes = tuple(torch.zeros((h, N), dtype=dtype) for _ in range(n_planes))
    run = ew.encode_window_40b_exact if mode40 else ew.encode_window_float_exact
    extra = (MAX_EXP_P,) if mode40 else ()
    for w in range(windows):
        chunk = torch.from_numpy(x[w * o : (w + 1) * o])
        planes = run(chunk, tabs, planes, *extra, w % 2, int(w == 0 and overlap),
                     overlap)
        odd = (w + 1) % 2 == 0
        first = odd or not overlap
        frame = planes[:per_buf] if first else planes[per_buf:]
        for k, plane_o in enumerate(frames_o[w]):
            np.testing.assert_array_equal(
                bits(frame[k].T.contiguous()).astype(np.uint32),
                bits(plane_o.astype(np.uint32) if mode40 else plane_o),
                err_msg=f"window {w} plane {k}")
        zero = tuple(torch.zeros_like(p) for p in frame)
        planes = zero + planes[per_buf:] if first else planes[:per_buf] + zero


def test_wrapper_rejects_bad_inputs():
    tabs = torch.zeros((16, 4), dtype=torch.float32)
    planes = tuple(torch.zeros((1, 10), dtype=torch.float32) for _ in range(4))
    with pytest.raises(ValueError, match="chunk holds"):
        ew.encode_window_float_exact(torch.zeros((9, 10)), tabs, planes, 0, 0)
    with pytest.raises(ValueError, match="planes must be"):
        ew.encode_window_40b_exact(torch.zeros((8, 10)), tabs,
                                   planes[:2] + planes[:1] * 4, MAX_EXP_P, 0, 0)
    with pytest.raises(ValueError, match="parity"):
        ew.encode_window_float_exact(torch.zeros((8, 10)), tabs, planes, 2, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        ew.encode_window_float_exact(
            torch.zeros((8, 10), device="meta"), tabs.to("meta"),
            tuple(p.to("meta") for p in planes), 0, 0)
    before = dict(ew.LAUNCHES)
    ew.encode_window_float_exact(torch.zeros((8, 10)), tabs, planes, 0, 1)
    assert ew.LAUNCHES == before  # the plain version counts no launch


# ---------------------------------------------------------------------------
# The step that stays out of the words: bitpack.quantize40
# ---------------------------------------------------------------------------


def _assert_quantize_equals_round_trip(bits_r, bits_i, e):
    """quantize40 == decode40(encode40(.)) of the port and of the JAX package's oracle."""
    re = torch.from_numpy(np.asarray(bits_r, np.uint32).view(np.float32))
    im = torch.from_numpy(np.asarray(bits_i, np.uint32).view(np.float32))
    got = bitpack.quantize40(re, im, e)
    want = bitpack.decode40(*bitpack.encode40(re, im, e), e)
    theirs = oracle.decode40(*oracle.encode40(re.numpy(), im.numpy(), e), e)
    for g, w, t in zip(got, want, theirs):
        np.testing.assert_array_equal(bits(g), bits(w))
        np.testing.assert_array_equal(bits(g), bits(t))


def _float_bits(e):
    """Bit patterns of float32 values around the exponent offset ``e``: any sign, an
    exponent drawn from zero and denormals (0), far below e, just around e .. e + 15 (the
    range the word holds), above e + 15 (saturation) and the top of the range, and a
    mantissa that is zero, all ones, one bit, or anything."""
    exponent = st.one_of(
        st.just(0), st.integers(1, 255), st.integers(max(e - 30, 0), min(e + 20, 255)),
        st.integers(max(e - 2, 0), min(e + 2, 255)), st.integers(min(e + 14, 255), 255))
    mantissa = st.one_of(
        st.just(0), st.just(0x7FFFFF), st.integers(0, 0x7FFFFF),
        st.integers(0, 22).map(lambda k: 1 << k),
        st.integers(0, 22).map(lambda k: 0x7FFFFF >> k),
        st.integers(0, 22).map(lambda k: (0x7FFFFF >> k) << k))
    return st.builds(lambda s, x, m: (s << 31) | (x << 23) | m, st.integers(0, 1), exponent,
                     mantissa)


@pytest.mark.parametrize("e", [MAX_EXP_P, MAX_EXP_U, 0, 1, ew.MAX_E_CONST, 250])
@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_quantize40_equals_decode_of_encode_on_drawn_pairs(e, data):
    """Zeros, denormals, equal and far-apart exponents, exponents below e and above
    e + 15, both signs. e = 250 is past `MAX_E_CONST`: the shift counts can wrap there, and
    quantize40 then takes the pack and the unpack as they are."""
    pairs = data.draw(st.lists(st.tuples(_float_bits(e), _float_bits(e)), min_size=1,
                               max_size=64))
    _assert_quantize_equals_round_trip([p[0] for p in pairs], [p[1] for p in pairs], e)


@pytest.mark.parametrize("e", [MAX_EXP_P, MAX_EXP_U, 3, 240])
def test_quantize40_equals_decode_of_encode_on_every_exponent_pair(e):
    """Every pair of exponent fields (256 x 256), each with seeded random signs and
    mantissas and with the mantissa edge cases (zero, all ones)."""
    rng = np.random.default_rng(e)
    e_r, e_i = (a.reshape(-1).astype(np.uint32) for a in np.meshgrid(np.arange(256),
                                                                     np.arange(256)))
    for fill in ("random", "zero", "ones"):
        def mant():
            if fill == "random":
                return rng.integers(0, 1 << 23, e_r.shape, dtype=np.uint32)
            return np.full(e_r.shape, 0 if fill == "zero" else 0x7FFFFF, np.uint32)
        sign = lambda: rng.integers(0, 2, e_r.shape, dtype=np.uint32) << 31  # noqa: E731
        _assert_quantize_equals_round_trip(sign() | (e_r << 23) | mant(),
                                           sign() | (e_i << 23) | mant(), e)


# ---------------------------------------------------------------------------
# The lane decomposition of the 40-bit plain version
# ---------------------------------------------------------------------------


def _random_words(rng, h, n, n_acc):
    """Accumulator words that hold large, small, zero and saturated values."""
    planes = []
    for _ in range(n_acc):
        scale = 10.0 ** rng.integers(-3, 9, (h, n))
        re = (rng.standard_normal((h, n)) * scale).astype(np.float32)
        im = (rng.standard_normal((h, n)) * scale[:, ::-1]).astype(np.float32)
        re[:, ::7] = 0.0
        planes += [torch.from_numpy(np.ascontiguousarray(a).astype(np.uint32).view(np.int32))
                   for a in oracle.encode40(re, im, MAX_EXP_P)]
    return tuple(planes)


@pytest.mark.parametrize("n", [200, 33])
@pytest.mark.parametrize("steps,parity,mirror", [(None, 0, 0), (None, 0, 1), (None, 1, 0),
                                                 (None, 1, 1), (3, 1, 0), (1, 0, 0)])
@pytest.mark.parametrize("h", [1, 2, 3])
@pytest.mark.parametrize("overlap", [True, False])
def test_lane_split_plain_equals_unsplit_plain(overlap, h, steps, parity, mirror, n):
    """Each buffer as a chain of its own, unpacked once and packed once, against both
    buffers in one loop with the words between steps: real-valued data (every product
    rounded), whole and partial windows, both parities, the mirror, H = 1..3, two N."""
    basis = generate_basis(14.0, 1, h, normalize=True)
    o = basis.o_size
    tabs = torch.from_numpy(stacked_tables(basis))
    chunk = torch.from_numpy(real_series(o if steps is None else steps, n, 14.0,
                                         seed=h + parity))
    planes = _random_words(np.random.default_rng(h + n), h, n, 2 if overlap else 1)
    args = (chunk, tabs, planes, MAX_EXP_P, parity, mirror, overlap)
    split = ew.encode_window_40b_exact_plain(*args)
    unsplit = ew.encode_window_40b_exact_unsplit_plain(*args)
    assert len(split) == len(unsplit) == len(planes)
    for k, (a, b) in enumerate(zip(split, unsplit)):
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=f"plane {k}")


@pytest.mark.parametrize("mirror", [0, 1])
@pytest.mark.parametrize("overlap", [True, False])
def test_unsplit_plain_matches_pallas_interpret(overlap, mirror):
    """The reference's loop as written against the JAX package's kernel in interpret mode
    (dyadic data), as `test_plain_matches_pallas_interpret` holds the lane-split one."""
    h, parity = 2, 1
    basis = dyadic_basis(o=8, harmonics=h)
    tabs = stacked_tables(basis)
    chunk = dyadic_series(basis.o_size, N, seed=5, scale=128.0)
    planes = _initial_planes(True, overlap, h, seed=h)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    mine = ew.encode_window_40b_exact_unsplit_plain(
        t(chunk), t(tabs), tuple(t(p.view(np.int32)) for p in planes), MAX_EXP_P, parity,
        mirror, overlap)
    ref = encode_pallas.encode_window_40b_exact(
        jnp.asarray(chunk), jnp.asarray(tabs), tuple(jnp.asarray(p) for p in planes),
        MAX_EXP_P, parity, mirror, overlap=overlap, interpret=True)
    for k, (a, b) in enumerate(zip(mine, ref)):
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=f"plane {k}")


@pytest.mark.parametrize("overlap", [True, False])
def test_window_loop_equals_whole_record_and_oracle_bytes(overlap):
    """40-bit windows through `encoder.encode_chunk` one by one, the same record through
    `encode_series_exact`, and the oracle: the same frame bytes."""
    from kwave_tpu_torch.basis import generate_basis as torch_basis

    h, n, windows = 2, 50, 5
    basis = torch_basis(12.0, 1, h, normalize=True)
    o = basis.o_size
    x = real_series(o * windows + 2, n, 12.0, seed=9)
    cfg = encoder.EncoderConfig.for_stream(basis, False, True, overlap)
    tables = encoder.make_tables(basis, False)
    st_, loop = encoder.init_state(cfg, n), []
    for w in range(windows):
        st_, frame = encoder.encode_chunk(st_, torch.from_numpy(x[w * o:(w + 1) * o]), cfg,
                                          tables)
        loop.append(encoder.frames_to_flat_40b(*frame))
    whole, _ = encoder.encode_series_exact(torch.from_numpy(x), basis, mode40=True,
                                           overlap=overlap)
    frames_o = oracle.OracleEncoder(generate_basis(12.0, 1, h, normalize=True), n,
                                    mode40=True, overlap=overlap,
                                    total_steps=x.shape[0]).encode_series(x)
    want = np.stack([oracle.soa_to_bytes(*fr) for fr in frames_o])
    np.testing.assert_array_equal(np.stack(loop), want)
    np.testing.assert_array_equal(encoder.frames_to_flat_40b(*whole), want)


def test_wrapper_refuses_an_exponent_offset_that_can_wrap():
    tabs = torch.zeros((16, 4), dtype=torch.float32)
    planes = tuple(torch.zeros((1, 10), dtype=torch.int32) for _ in range(6))
    with pytest.raises(ValueError, match="e_const"):
        ew.encode_window_40b_exact(torch.zeros((8, 10)), tabs, planes,
                                   ew.MAX_E_CONST + 1, 0, 0)
    with pytest.raises(ValueError, match="e_const"):
        ew.encode_window_40b_exact(torch.zeros((8, 10)), tabs, planes, -1, 0, 0)
