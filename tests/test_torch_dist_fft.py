"""The port's pencil FFT (`kwave_tpu_torch.parallel.fft`) on in-process CPU meshes of 2, 4
and 8 shards, against numpy and against `kwave_tpu.parallel.fft` on the JAX package's 8
virtual CPU devices, on the same inputs with `tests/test_dist_fft.py`'s tolerances (the
`mxfft` engine is not ported: the entries take no engine)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kwave_tpu.parallel import field_sharding as jfield_sharding
from kwave_tpu.parallel import make_mesh as jmake_mesh
from kwave_tpu.parallel.fft import dist_rfftn as jdist_rfftn
from kwave_tpu_torch.parallel import field_sharding, make_mesh, pencil_fft
from kwave_tpu_torch.parallel import fft as dfft
from torch_helpers import one_torch_thread  # noqa: F401

SHARDS = (2, 4, 8)


def _mesh(s):
    return make_mesh(s, devices=["cpu"] * s)


def _whole(x, dim):
    return torch.cat(x.shards, dim=dim).numpy()


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("shape", [(16, 24, 20), (24, 16, 10)])
def test_dist_rfftn_matches_reference(s, shape):
    """nz != ny != nx; the y-sharded spectrum assembled is numpy's rfftn and the JAX
    package's pencil's."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = _whole(dfft.dist_rfftn(field_sharding(_mesh(s), x), _mesh(s)), 1)
    ref = np.fft.rfftn(x.astype(np.float64)).astype(np.complex64)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)
    jmesh = jmake_mesh(8)
    jgot = np.asarray(jdist_rfftn(jax.device_put(jnp.asarray(x), jfield_sharding(jmesh, 3)),
                                  jmesh))
    np.testing.assert_allclose(got, jgot, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("s", SHARDS)
def test_dist_roundtrip_and_sharding(s):
    x = np.random.default_rng(1).standard_normal((16, 16, 12)).astype(np.float32)
    mesh = _mesh(s)
    xk = dfft.dist_rfftn(field_sharding(mesh, x), mesh)
    back = dfft.dist_irfftn(xk, 12, mesh)
    np.testing.assert_allclose(_whole(back, 0), x, atol=2e-6)
    # the spectrum is y-sharded, the field z-sharded
    assert [tuple(k.shape) for k in xk.shards] == [(16, 16 // s, 7)] * s
    assert [tuple(b.shape) for b in back.shards] == [(16 // s, 16, 12)] * s


@pytest.mark.parametrize("s", SHARDS)
def test_dist_spectral_multiply_kappa(s):
    """A k-space operator in the y-sharded layout (`spectral_sharding`) matches the
    single-device result: the solver's spectral-multiply pattern."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 16, 16)).astype(np.float32)
    kap = rng.random((16, 16, 9)).astype(np.float32)
    mesh = _mesh(s)
    got = dfft.dist_irfftn(dfft.dist_rfftn(field_sharding(mesh, x), mesh)
                           * dfft.spectral_sharding(mesh, kap), 16, mesh)
    ref = np.fft.irfftn(np.fft.rfftn(x) * kap, s=(16, 16, 16), axes=(0, 1, 2))
    np.testing.assert_allclose(_whole(got, 0), ref.astype(np.float32), atol=1e-4)


def test_refuses_nz_or_ny_that_does_not_divide():
    """The slabs and the pencil split z and y into S equal blocks: anything else is
    refused, with a message that names the axis lengths."""
    mesh = _mesh(8)
    with pytest.raises(ValueError, match="nz = 12 does not divide by the mesh's 8"):
        field_sharding(mesh, torch.zeros(12, 16, 8))
    with pytest.raises(ValueError, match="nz and ny divisible.*nz = 16, ny = 12"):
        dfft.dist_rfftn(field_sharding(mesh, torch.zeros(16, 12, 8)), mesh)


def test_mxfft_engine_is_refused():
    """The matmul FFT is not ported, on purpose (`tests/test_torch_import.py`'s
    NOT_PORTED): the pencil's entries take no ``engine``, so asking for one fails."""
    mesh = _mesh(2)
    x = field_sharding(mesh, torch.zeros(4, 4, 4))
    for call in (lambda: dfft.dist_rfftn(x, mesh, engine="mxfft"),
                 lambda: dfft.dist_irfftn(x, 4, mesh, engine="mxfft"),
                 lambda: pencil_fft(mesh, 4, engine="mxfft")):
        with pytest.raises(TypeError, match="engine"):
            call()


@pytest.mark.parametrize("s", SHARDS)
def test_shifted_velocity_z_shift_on_a_mesh(s):
    """The z half-cell shift of a z-sharded field trades it to y-blocks (`along_z`) and
    back: the shifted velocities equal the single-device ones; x and y stay local."""
    from kwave_tpu_torch.parallel import shard_operators, shard_state
    from kwave_tpu_torch.solver import (Grid, Medium, SimState, make_operators,
                                        shifted_velocity)

    grid = Grid(nx=12, ny=16, nz=16, dx=1e-4, dy=1e-4, dz=1e-4, dt=1e-8, nt=1)
    ops = make_operators(grid, Medium(c0=1500.0, rho0=1000.0), (2, 2, 2), (2.0,) * 3,
                         need_shift=True)
    rng = np.random.default_rng(3)
    f = [torch.from_numpy(rng.standard_normal(grid.shape).astype(np.float32))
         for _ in range(3)]
    zero = torch.zeros(grid.shape)
    state = SimState(p=zero, ux_sgx=f[0], uy_sgy=f[1], uz_sgz=f[2], rho_x=zero,
                     rho_y=zero, rho_z=zero)
    mesh = _mesh(s)
    one = shifted_velocity(state, ops)
    many = shifted_velocity(shard_state(state, mesh), shard_operators(ops, 3, mesh, grid),
                            pencil_fft(mesh, grid.nx))
    for a, b in zip(one, many):
        np.testing.assert_allclose(_whole(b, 0), a.numpy(), rtol=1e-5, atol=1e-6)
