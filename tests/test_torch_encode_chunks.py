"""kwave_tpu_torch.encoder.encode_chunks against kwave_tpu.encoder.encode_chunks: C
windows in one call, bit for bit, 40-bit and float, overlap on and off, shifted tables,
from a fresh state and from one carried over an earlier call. Dyadic data (exact
products), since XLA:CPU contracts the JAX float path's mul+add; on real data the port's
frames equal the NumPy oracle's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kwave_tpu import encoder as jenc
from kwave_tpu import oracle
from kwave_tpu.basis import generate_basis
from kwave_tpu_torch import convert, encoder
from torch_helpers import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    bits, dyadic_basis, dyadic_series, one_torch_thread, real_series)

N = 37


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("mode40", [True, False])
def test_encode_chunks_matches_jax_bit_for_bit(mode40, overlap, shifted):
    basis = dyadic_basis(o=8, harmonics=2)
    o = basis.o_size
    series = dyadic_series(7 * o, N, seed=5, scale=128.0 if mode40 else 1.0)
    cfg = encoder.EncoderConfig.for_stream(basis, shifted, mode40, overlap)
    tables = encoder.make_tables(basis, shifted)
    jcfg = jenc.EncoderConfig.for_stream(basis, shifted, mode40, overlap)
    jtab = jenc.make_tables(basis, shifted)
    st, jst = encoder.init_state(cfg, N), jenc.init_state(jcfg, N)
    # two calls: 3 chunks from a fresh state (the mirror), then 4 from the carried state
    for first, count in ((0, 3), (3, 4)):
        chunks = series[first * o:(first + count) * o].reshape(count, o, N)
        st, frames = encoder.encode_chunks(st, torch.from_numpy(chunks), cfg, tables)
        jst, jframes = jenc.encode_chunks(jst, jnp.asarray(chunks), jcfg, jtab)
        assert len(frames) == len(jframes) == (3 if mode40 else 2)
        for k, (a, b) in enumerate(zip(frames, jframes)):
            assert tuple(a.shape) == (count, 2, N)
            np.testing.assert_array_equal(bits(a), bits(np.asarray(b)),
                                          err_msg=f"chunks from {first}, plane {k}")
        mine = convert.encoder_state_to_numpy(st)
        assert set(mine) == set(jst)
        for k, v in jst.items():
            np.testing.assert_array_equal(bits(mine[k]), bits(np.asarray(v)), err_msg=k)


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("mode40", [True, False])
def test_encode_chunks_matches_the_oracle_on_real_data(mode40, overlap):
    basis = generate_basis(12.0, 1, 2, normalize=True)
    o = basis.o_size
    series = real_series(5 * o, N, 12.0, seed=9)
    cfg = encoder.EncoderConfig.for_stream(basis, False, mode40, overlap)
    st, frames = encoder.encode_chunks(encoder.init_state(cfg, N),
                                       torch.from_numpy(series.reshape(5, o, N)), cfg,
                                       encoder.make_tables(basis, False))
    frames_o = oracle.OracleEncoder(basis, N, mode40=mode40, overlap=overlap,
                                    total_steps=series.shape[0]).encode_series(series)
    assert st["sampled_step"] == 5 * o and st["compressed_step"] == 5
    for w, fo in enumerate(frames_o):
        for k, b in enumerate(fo):
            np.testing.assert_array_equal(bits(frames[k][w].T.contiguous()),
                                          bits(b.astype(np.uint32) if mode40 else b),
                                          err_msg=f"frame {w} plane {k}")
