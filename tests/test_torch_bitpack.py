"""kwave_tpu_torch.bitpack bit-for-bit against the NumPy oracle and kwave_tpu.bitpack."""

import numpy as np
import pytest
import torch

from kwave_tpu import bitpack as jbitpack
from kwave_tpu import oracle
from kwave_tpu.basis import MAX_EXP_P, MAX_EXP_U
from kwave_tpu_torch import bitpack


def _rand_pressures(n, seed=0):
    """Magnitudes over 12 decades plus +-0, +-inf, tiny and over-range values."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-3, 9, n)
    vals = (mag * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    edge = np.float32(
        [0.0, -0.0, 1e-30, -1e-30, 3e8, -3e8, np.inf, -np.inf, 0.03125, -0.03125, 1.0,
         1e38, -1e38, 1e-45]
    )
    return np.concatenate([vals, edge])


@pytest.mark.parametrize("e", [MAX_EXP_P, MAX_EXP_U])
def test_encode40_bit_exact(e):
    re = _rand_pressures(4096, 1)
    im = _rand_pressures(4096, 2)
    h, r, i = bitpack.encode40(torch.from_numpy(re), torch.from_numpy(im), e)
    assert h.dtype == torch.int32
    h_o, r_o, i_o = oracle.encode40(re, im, e)
    np.testing.assert_array_equal(h.numpy(), h_o)
    np.testing.assert_array_equal(r.numpy(), r_o)
    np.testing.assert_array_equal(i.numpy(), i_o)
    h_j, r_j, i_j = jbitpack.encode40(re, im, e)
    for mine, theirs in ((h, h_j), (r, r_j), (i, i_j)):
        np.testing.assert_array_equal(mine.numpy().view(np.uint32), np.asarray(theirs))


@pytest.mark.parametrize("e", [MAX_EXP_P, MAX_EXP_U])
def test_decode40_bit_exact(e):
    rng = np.random.default_rng(3)
    h = rng.integers(0, 256, 8192).astype(np.uint8)
    mr = rng.integers(0, 65536, 8192).astype(np.uint16)
    mi = rng.integers(0, 65536, 8192).astype(np.uint16)
    t = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    re, im = bitpack.decode40(t(h), t(mr), t(mi), e)
    re_o, im_o = oracle.decode40(h, mr, mi, e)
    np.testing.assert_array_equal(re.numpy().view(np.uint32), re_o.view(np.uint32))
    np.testing.assert_array_equal(im.numpy().view(np.uint32), im_o.view(np.uint32))
    re_j, im_j = jbitpack.decode40(h.astype(np.uint32), mr.astype(np.uint32),
                                   mi.astype(np.uint32), e)
    np.testing.assert_array_equal(re.numpy().view(np.uint32),
                                  np.asarray(re_j).view(np.uint32))
    np.testing.assert_array_equal(im.numpy().view(np.uint32),
                                  np.asarray(im_j).view(np.uint32))


@pytest.mark.parametrize("e", [MAX_EXP_P, MAX_EXP_U])
def test_encode_decode_roundtrip_is_a_fixed_point(e):
    """Re-encoding decoded in-range values gives the same planes (the accumulate-in-
    packed-form invariant); saturated and flushed edge values are not in range."""
    rng = np.random.default_rng(4)
    scale = 2.0 ** (e - 127 + 6)  # mid-range of the 4-bit shared exponent above e
    re = (scale * rng.standard_normal(2048)).astype(np.float32)
    im = (scale * rng.standard_normal(2048)).astype(np.float32)
    planes = bitpack.encode40(torch.from_numpy(re), torch.from_numpy(im), e)
    again = bitpack.encode40(*bitpack.decode40(*planes, e), e)
    for a, b in zip(planes, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("h,n", [(1, 203), (3, 201), (2, 64)])
def test_pack_frame_wire_matches_oracle_bytes(h, n):
    rng = np.random.default_rng(h * 1000 + n)
    hdr = rng.integers(0, 256, (h, n)).astype(np.int32)
    mr = rng.integers(0, 65536, (h, n)).astype(np.int32)
    mi = rng.integers(0, 65536, (h, n)).astype(np.int32)
    words = bitpack.pack_frame_wire(*(torch.from_numpy(a) for a in (hdr, mr, mi)))
    got = bitpack.frame_wire_bytes(words, n * h)
    # writer order pH = i*H + ih: point-major
    expected = oracle.soa_to_bytes(hdr.T.reshape(-1).astype(np.uint8),
                                   mr.T.reshape(-1).astype(np.uint16),
                                   mi.T.reshape(-1).astype(np.uint16))
    np.testing.assert_array_equal(got, expected)
    jwords = jbitpack.pack_frame_wire(hdr.astype(np.uint32), mr.astype(np.uint32),
                                      mi.astype(np.uint32))
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(jwords))


def test_frame_wire_bytes_rejects_a_short_payload():
    words = torch.zeros(5, dtype=torch.int32)  # 20 bytes = 4 coefficients
    with pytest.raises(ValueError, match="expects"):
        bitpack.frame_wire_bytes(words, 8)


@pytest.mark.parametrize("total_bits", [8, 16, 24, 32, 40])
@pytest.mark.parametrize("e", [MAX_EXP_P, MAX_EXP_U])
def test_encode_decode_packed_bit_exact(total_bits, e):
    """The W-bit codec (8/16/24/32, and 40 delegating to encode40/decode40) against
    kwave_tpu.bitpack bit for bit, both ways."""
    re = _rand_pressures(4096, 5)
    im = _rand_pressures(4096, 6)
    planes = bitpack.encode_packed(torch.from_numpy(re), torch.from_numpy(im), e,
                                   total_bits)
    jplanes = jbitpack.encode_packed(re, im, e, total_bits)
    for mine, theirs in zip(planes, jplanes):
        assert mine.dtype == torch.int32
        np.testing.assert_array_equal(mine.numpy().view(np.uint32), np.asarray(theirs))
    dec = bitpack.decode_packed(*planes, e, total_bits)
    jdec = jbitpack.decode_packed(*jplanes, e, total_bits)
    for mine, theirs in zip(dec, jdec):
        np.testing.assert_array_equal(mine.numpy().view(np.uint32),
                                      np.asarray(theirs).view(np.uint32))


@pytest.mark.parametrize("total_bits", [8, 16, 24, 32])
def test_decode_packed_of_random_fields_bit_exact(total_bits):
    """Every field value, including ones no encode produces, unpacks as in JAX."""
    m = bitpack.SUPPORTED_MANT_BITS[total_bits]
    rng = np.random.default_rng(total_bits)
    h = rng.integers(0, 256, 8192).astype(np.uint32)
    mr, mi = (rng.integers(0, 1 << m, 8192).astype(np.uint32) for _ in range(2))
    mine = bitpack.decode_packed(*(torch.from_numpy(a.view(np.int32)) for a in (h, mr, mi)),
                                 MAX_EXP_P, total_bits)
    theirs = jbitpack.decode_packed(h, mr, mi, MAX_EXP_P, total_bits)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b).view(np.uint32))


def test_packed_width_refused():
    with pytest.raises(ValueError, match="12"):
        bitpack.encode_packed(torch.zeros(2), torch.zeros(2), MAX_EXP_P, 12)
