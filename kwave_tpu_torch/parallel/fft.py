"""Distributed 3D FFT: the pencil decomposition over the mesh (port of
`kwave_tpu.parallel.fft`).

Every transform stays local to a shard; the field crosses the mesh once per transpose:

  forward:  [nz/S, ny, nx] --rfft(x), fft(y) local--> [nz/S, ny, nxR]
            --all_to_all (z for y)--> [nz, ny/S, nxR] --fft(z) local--> spectral, y-sharded
  inverse:  the mirror image.

The (y, x) legs are one 2D transform of each z-plane (`torch.fft.rfft2`: one cuFFT plan
and one scaling, as close to the single-device `rfftn` as a split allows), z a batched 1D
one. Spectral fields and spectral operators therefore live y-sharded
(`spectral_sharding`), time-domain fields z-sharded. Only the x leg is a real (r2c / c2r)
transform; y and z are complex. Every leg is cuFFT: the JAX package's matmul FFT (its
``engine="mxfft"``) is not ported, on purpose (ROADMAP.md). A trade costs one copy of each
shard's data between its blocks and the communicator (`parallel.comm`).
"""

from __future__ import annotations

import torch

from kwave_tpu_torch.parallel.sharded import Sharded


def _check(parts, mesh, what: str) -> None:
    nz, ny = parts[0].shape[0] * mesh.size, parts[0].shape[1]
    if ny % mesh.size:
        raise ValueError(f"{what}: the pencil needs nz and ny divisible by the mesh's "
                         f"{mesh.size} shards; got nz = {nz}, ny = {ny}")


def spectral_sharding(mesh, xk) -> Sharded:
    """A spectral array ``[nz, ny, nxR]`` in the layout `dist_rfftn` produces: each shard
    its block of y."""
    from kwave_tpu_torch.parallel.mesh import _split

    return _split(mesh, xk, 1, "ny")


def z_to_y(x: Sharded, mesh) -> Sharded:
    """Trade ``[nz/S, ny, m]`` z-slabs for ``[nz, ny/S, m]`` y-blocks."""
    _check(x.shards, mesh, "z_to_y")
    return Sharded(mesh.comm.all_to_all(x.shards, split_dim=1, concat_dim=0))


def y_to_z(x: Sharded, mesh) -> Sharded:
    """Trade ``[nz, ny/S, m]`` y-blocks for ``[nz/S, ny, m]`` z-slabs."""
    if x.shards[0].shape[0] % mesh.size:
        raise ValueError(f"y_to_z: nz = {x.shards[0].shape[0]} does not divide by the "
                         f"mesh's {mesh.size} shards")
    return Sharded(mesh.comm.all_to_all(x.shards, split_dim=0, concat_dim=1))


def dist_rfftn(x: Sharded, mesh) -> Sharded:
    """3D rfftn of a z-sharded ``[nz, ny, nx]`` field -> y-sharded spectrum ``[nz, ny,
    nxR]``."""
    return torch.fft.fft(z_to_y(torch.fft.rfft2(x, dim=(1, 2)), mesh), dim=0)


def dist_irfftn(xk: Sharded, nx: int, mesh) -> Sharded:
    """Inverse of `dist_rfftn`: y-sharded spectrum -> z-sharded real ``[nz, ny, nx]``."""
    x = y_to_z(torch.fft.ifft(xk, dim=0), mesh)
    return torch.fft.irfft2(x, s=(x.shards[0].shape[1], nx), dim=(1, 2))


def along_z(fn, x: Sharded, mesh) -> Sharded:
    """``fn`` applied along z of a z-sharded field: traded to y-blocks ``[nz, ny/S, nx]``,
    where every z line is whole, and back (the z half-cell shift of
    `solver.step.shifted_velocity`)."""
    return y_to_z(fn(z_to_y(x, mesh)), mesh)
