"""The fused z-stage path of the port on the CPU (`ops.zfuse.apply` takes `apply_plain`
there), the compact operators, and `run_simulation(fuse_z=True)`, against the JAX package.

Tolerances, and why:
- `apply_plain` against `kwave_tpu.ops.zfuse.apply(interpret=True)`: 3e-5 x max|ref|, the
  JAX test's own bound (tests/test_zfuse.py): its contraction is a 3-pass bf16 split.
- `apply_plain` against a float64 numpy ``ifft(fft(s, 0) * op, 0)``: 2e-6 x max|ref|; a
  dense fp32 DFT over nz <= 32 terms measured 1.7e-7 to 2.2e-7 here (and 4e-6 to 7e-6
  against the JAX kernel).
- `apply_radix_plain` (the radix kernel's passes on tensors) against the float64 reference:
  the same 2e-6 (measured 8e-8 at nz = 8 to 2.2e-7 at nz = 1024: an FFT's error grows with
  log2 nz); against `apply_plain`: 4e-6, the sum of the two bounds, because `apply_plain`
  is the dense sum and is itself up to 7e-7 off float64 at nz = 1024 (measured apart at
  most 7e-7).
- `apply_bluestein_plain` (the Bluestein kernel's steps on tensors) against the float64
  reference: the same 2e-6 (measured 1.4e-7 at nz = 2 to 3.7e-7 at nz = 13 and 251 here:
  the FFTs of an even M >= 2 nz, the chirp rounded to complex64 from a float64 table);
  against `apply_plain`: 4e-6, as above.
- compact against full operators over 6 steps: 1e-5 x max|p| (the operators agree to fp32
  rounding: they are built in fp32 on the device instead of float64 on the host; measured
  1.3e-7).
- a step with `spectral_multi` against the unfused step: 2e-4 x max, as
  tests/test_zfuse.py (measured 2.4e-7 over 6 steps: both routes are fp32 throughout).
- `run_simulation` with `fuse_z=True` against its default run and against the JAX package's
  `fuse_z=True` run: 1e-4 x max, as tests/test_zfuse.py.
"""

import dataclasses
import importlib

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kwave_tpu import solver as jsolver
from kwave_tpu.ops import zfuse as jzfuse
from kwave_tpu_torch import convert, solver
from kwave_tpu_torch.ops import zfuse


# the module: the package exports the function `step` under the same name
step_mod = importlib.import_module("kwave_tpu_torch.solver.step")

JAX_TOL, F64_TOL = 3e-5, 2e-6


def _case(nz=32, ny=16, nx=16, seed=0, jax_plan=True):
    rng = np.random.default_rng(seed)
    nxr = nx // 2 + 1
    s = (rng.standard_normal((nz, ny, nxr))
         + 1j * rng.standard_normal((nz, ny, nxr))).astype(np.complex64)
    k2z = (np.fft.fftfreq(nz) * 2 * np.pi * nz / 1e-2) ** 2
    k2y = (np.fft.fftfreq(ny) * 2 * np.pi * ny / 1e-2) ** 2
    k2x = (np.fft.rfftfreq(nx) * 2 * np.pi * nx / 1e-2) ** 2
    plan = zfuse.make_plan((nz, ny, nx), k2z, k2y, k2x, 1e-5)
    jplan = None
    if jax_plan:
        jplan = jzfuse.make_plan((nz, ny, nx), k2z, k2y, k2x, c_ref_dt_2=1e-5)
    return s, (k2z, k2y, k2x), plan, jplan


def _kappa_np(k2, c):
    k = np.sqrt(k2[0][:, None, None] + k2[1][None, :, None] + k2[2][None, None, :])
    arg = c * k
    return np.where(arg == 0, 1.0, np.sin(arg) / np.where(arg == 0, 1.0, arg))


def _ref64(s, op):
    return np.fft.ifft(np.fft.fft(s.astype(np.complex128), axis=0) * op, axis=0)


def _both(plan, jplan, s, specs, dds, use_kappa=True):
    mine = zfuse.apply(plan, torch.from_numpy(s), specs,
                       tuple(torch.from_numpy(d[:, 0] + 1j * d[:, 1]) for d in dds),
                       use_kappa=use_kappa)
    theirs = jzfuse.apply(jplan, jnp.asarray(s.real), jnp.asarray(s.imag),
                          tuple(jzfuse.OpSpec(o.kind, o.axis, o.power) for o in specs),
                          tuple(dds), use_kappa=use_kappa, interpret=True)
    return [m.numpy() for m in mine], [np.asarray(r) + 1j * np.asarray(i) for r, i in theirs]


def _hold(got, jax_out, ref64):
    scale = np.abs(ref64).max()
    assert np.abs(got - jax_out).max() <= JAX_TOL * scale
    assert np.abs(got - ref64).max() <= F64_TOL * scale


def test_grad_ops_all_axes_share_one_forward():
    s, k2, plan, jplan = _case()
    nz, ny, nxr = s.shape
    rng = np.random.default_rng(3)
    dds = [rng.standard_normal((n, 2)).astype(np.float32) for n in (nz, ny, nxr)]
    specs = tuple(zfuse.OpSpec("grad", axis=a) for a in (0, 1, 2))
    before = dict(zfuse.LAUNCHES)
    mine, theirs = _both(plan, jplan, s, specs, dds)
    assert zfuse.LAUNCHES == before  # the plain version counts nothing
    kap = _kappa_np(k2, 1e-5)
    for got, jout, dd, shp in zip(mine, theirs, dds, [(nz, 1, 1), (1, ny, 1), (1, 1, nxr)]):
        assert got.dtype == np.complex64
        _hold(got, jout, _ref64(s, kap * (dd[:, 0] + 1j * dd[:, 1]).reshape(shp)))


def test_nabla_ops_and_pole():
    s, k2, plan, jplan = _case(seed=5)
    power = -0.5
    mine, theirs = _both(plan, jplan, s, (zfuse.OpSpec("nabla", power=power),), (),
                         use_kappa=False)
    k = np.sqrt(k2[0][:, None, None] + k2[1][None, :, None] + k2[2][None, None, :])
    op = np.where(k == 0, 0.0, np.where(k == 0, 1.0, k) ** power)
    _hold(mine[0], theirs[0], _ref64(s, op))


def test_partial_x_tail_block():
    """nxr = 131: no multiple of anything the kernel or the TPU tiles by."""
    s, k2, plan, jplan = _case(nz=16, ny=8, nx=260, seed=7)
    dd = np.random.default_rng(8).standard_normal((16, 2)).astype(np.float32)
    mine, theirs = _both(plan, jplan, s, (zfuse.OpSpec("grad", axis=0),), (dd,))
    op = _kappa_np(k2, 1e-5) * (dd[:, 0] + 1j * dd[:, 1]).reshape(16, 1, 1)
    _hold(mine[0], theirs[0], _ref64(s, op))


def test_grad_without_kappa_and_nz_not_a_power_of_two():
    s, k2, plan, _ = _case(nz=25, ny=6, nx=10, seed=9)
    dd = np.random.default_rng(10).standard_normal((6, 2)).astype(np.float32)
    ddc = torch.from_numpy(dd[:, 0] + 1j * dd[:, 1])
    got = zfuse.apply(plan, torch.from_numpy(s), (zfuse.OpSpec("grad", axis=1),), (ddc,),
                      use_kappa=False)[0].numpy()
    ref = _ref64(s, (dd[:, 0] + 1j * dd[:, 1]).reshape(1, 6, 1))
    assert np.abs(got - ref).max() <= F64_TOL * np.abs(ref).max()


RADIX_NZ = [8, 16, 32, 64, 128, 256, 512]
# radices 3, 5 and 7 among the passes; 11 and 13 (22, 26, 110); a generic pass (34 = 17 x 2)
MIXED_NZ = [12, 24, 60, 100, 192, 448, 22, 26, 34, 110]
PLAIN_TOL = 4e-6  # radix passes against the dense sum: the sum of their two bounds
# z lengths of the column kernel held to the JAX package's kernel (1: its transforms are
# the identity)
COLUMN_JAX_NZ = [1, 4, 6, 12]


def _tiled(plan):
    """``plan``, or where `kernel_for` sends its z length to the column kernel, a plan that
    names the shared-memory FFT kernel of that length (radix at 8 and 16, else mixed)."""
    if plan.kernel != "column":
        return plan
    tiled = "radix" if plan.nz in (8, 16) else "mixed"
    return dataclasses.replace(plan, **zfuse.kernel_tables(plan.nz, tiled))


def _radix_case(nz, n_ops, kind, use_kappa, seed, jax_plan=True):
    """A small spectrum [nz, 3, 4] with its ops, dd vectors and float64 operators."""
    ny, nx = 3, 6
    s, k2, plan, jplan = _case(nz=nz, ny=ny, nx=nx, seed=seed, jax_plan=jax_plan)
    rng = np.random.default_rng(seed + 1)
    sizes = (nz, ny, nx // 2 + 1)
    shapes = [(nz, 1, 1), (1, ny, 1), (1, 1, sizes[2])]
    kap = _kappa_np(k2, 1e-5) if use_kappa else 1.0
    k = np.sqrt(k2[0][:, None, None] + k2[1][None, :, None] + k2[2][None, None, :])
    if kind == "nabla":
        powers = (-0.5, 0.5, 1.0)[:n_ops]
        specs = tuple(zfuse.OpSpec("nabla", power=p) for p in powers)
        return s, plan, jplan, specs, [], [np.where(k == 0, 0.0, np.where(k == 0, 1.0, k) ** p)
                                           for p in powers]
    axes = (0, 1, 2)[:n_ops] if n_ops == 3 else (int(kind[-1]),)
    dds = [rng.standard_normal((sizes[a], 2)).astype(np.float32) for a in axes]
    ops64 = [kap * (d[:, 0] + 1j * d[:, 1]).reshape(shapes[a]) for a, d in zip(axes, dds)]
    return s, plan, jplan, tuple(zfuse.OpSpec("grad", axis=a) for a in axes), dds, ops64


@pytest.mark.parametrize("use_kappa", [True, False])
@pytest.mark.parametrize("n_ops,kind", [(1, "grad0"), (1, "grad1"), (1, "grad2"),
                                        (1, "nabla"), (3, "grad"), (3, "nabla")])
@pytest.mark.parametrize("nz", RADIX_NZ + MIXED_NZ)
def test_radix_plain_matches_float64_and_dense_plain(nz, n_ops, kind, use_kappa):
    """The radix and mixed kernels' decomposition on tensors: their passes, the operator
    looked up at the digit-reversed bin, the inverse passes, the 1/nz, kappa at arg == 0 and
    the nabla at k == 0 (bin 0 of column 0 is in every case)."""
    s, plan, _, specs, dds, ops64 = _radix_case(nz, n_ops, kind, use_kappa, seed=nz + n_ops,
                                                jax_plan=False)
    plan = _tiled(plan)
    assert plan.passes == zfuse.radix_passes(nz) and int(np.prod(plan.passes)) == nz
    ddc = tuple(torch.from_numpy(d[:, 0] + 1j * d[:, 1]) for d in dds)
    got = zfuse.apply_radix_plain(plan, torch.from_numpy(s), specs, ddc, use_kappa=use_kappa)
    dense = zfuse.apply_plain(plan, torch.from_numpy(s), specs, ddc, use_kappa=use_kappa)
    assert len(got) == n_ops
    for g, d, op64 in zip(got, dense, ops64):
        ref = _ref64(s, op64)
        scale = np.abs(ref).max()
        assert g.dtype == torch.complex64 and tuple(g.shape) == s.shape
        assert np.abs(g.numpy() - ref).max() <= F64_TOL * scale
        assert np.abs(g.numpy() - d.numpy()).max() <= PLAIN_TOL * scale


def test_radix_plain_matches_the_jax_kernel():
    s, plan, jplan, specs, dds, ops64 = _radix_case(32, 3, "grad", True, seed=4)
    ddc = tuple(torch.from_numpy(d[:, 0] + 1j * d[:, 1]) for d in dds)
    got = zfuse.apply_radix_plain(plan, torch.from_numpy(s), specs, ddc)
    theirs = jzfuse.apply(jplan, jnp.asarray(s.real), jnp.asarray(s.imag),
                          tuple(jzfuse.OpSpec(o.kind, o.axis, o.power) for o in specs),
                          tuple(dds), use_kappa=True, interpret=True)
    for g, (re, im), op64 in zip(got, theirs, ops64):
        _hold(g.numpy(), np.asarray(re) + 1j * np.asarray(im), _ref64(s, op64))


@pytest.mark.parametrize("nz,passes", [(8, (8,)), (16, (16,)), (32, (8, 4)), (64, (8, 8)),
                                       (128, (16, 8)), (256, (16, 16)), (512, (8, 8, 8)),
                                       (1024, (16, 8, 8))])
def test_radix_pass_plans_and_digit_reversal(nz, passes):
    """The plans the CUDA source instantiates, and the bin order they leave: a
    permutation, equal to the kernel's own formula for three passes. `kernel_for` sends 8
    and 16 to the column kernel; a plan may name the radix kernel there."""
    assert zfuse.radix_passes(nz) == passes
    assert zfuse.kernel_for(nz) == ("column" if nz in zfuse.COLUMN_NZ else "radix")
    assert zfuse.kernel_tables(nz, "radix")["passes"] == passes
    bins = zfuse.digit_reversed_bins(passes)
    assert sorted(bins) == list(range(nz))
    # position p = q0*(nz/R0) + q1*(nz/(R0*R1)) + q2 holds bin q0 + R0*(q1 + R1*q2)
    r = passes + (1,) * (3 - len(passes))
    p = np.arange(nz)
    q0, q1, q2 = p // (r[1] * r[2]), (p // r[2]) % r[1], p % r[2]
    np.testing.assert_array_equal(bins, q0 + r[0] * (q1 + r[1] * q2))


@pytest.mark.parametrize("nz", [24, 60, 96, 22, 26, 34])
def test_mixed_plain_matches_the_jax_kernel(nz):
    """The mixed kernel's passes on tensors (radices 3 and 5 among them; 11 at 22, 13 at
    26, the generic pass of 17 at 34) against the JAX package's kernel in interpret mode,
    three grad ops off one forward."""
    s, plan, jplan, specs, dds, ops64 = _radix_case(nz, 3, "grad", True, seed=nz)
    assert plan.kernel == "mixed"
    ddc = tuple(torch.from_numpy(d[:, 0] + 1j * d[:, 1]) for d in dds)
    got = zfuse.apply_radix_plain(plan, torch.from_numpy(s), specs, ddc)
    theirs = jzfuse.apply(jplan, jnp.asarray(s.real), jnp.asarray(s.imag),
                          tuple(jzfuse.OpSpec(o.kind, o.axis, o.power) for o in specs),
                          tuple(dds), use_kappa=True, interpret=True)
    for g, (re, im), op64 in zip(got, theirs, ops64):
        _hold(g.numpy(), np.asarray(re) + 1j * np.asarray(im), _ref64(s, op64))


@pytest.mark.parametrize("nz", [18, 24, 48, 60, 96, 100, 192, 320, 448, 1000, 1536, 1701,
                                20, 21, 28, 33, 39, 22, 26, 110, 176, 208, 1331, 1573])
def test_mixed_pass_plans(nz):
    """The mixed kernel's plans: radices from its set, at most MAX_PASSES of them, whose
    product is nz, the power-of-two part in the widest passes first and each odd factor a
    pass of its own, leaving the bins in an order that is a permutation."""
    passes = zfuse.radix_passes(nz)
    assert zfuse.kernel_for(nz) == "mixed" and int(np.prod(passes)) == nz
    assert set(passes) <= set(zfuse.RADICES) and len(passes) <= zfuse.MAX_PASSES
    odd = [r for r in passes if r % 2]
    assert passes[len(passes) - len(odd):] == tuple(sorted(odd))
    assert list(passes[:len(passes) - len(odd)]) == sorted(passes[:len(passes) - len(odd)],
                                                           reverse=True)
    assert sorted(zfuse.digit_reversed_bins(passes)) == list(range(nz))


@pytest.mark.parametrize("nz", [25, 100, 192, 1000, 1536])
def test_mixed_nz_take_the_mixed_kernel(nz):
    """nz with prime factors of 7 or less, no power of two, from 8 to MIXED_MAX_NZ: the
    plan names the mixed kernel and carries its passes and its bin table; on the CPU
    `apply` takes the plain version and counts no launch."""
    s, _, plan, _ = _case(nz=nz, ny=2, nx=4)
    assert plan.kernel == "mixed" and plan.passes == zfuse.radix_passes(nz)
    assert plan.bins.dtype == torch.int16
    np.testing.assert_array_equal(plan.bins.numpy(), zfuse.digit_reversed_bins(plan.passes))
    before = dict(zfuse.KERNEL_LAUNCHES)
    got = zfuse.apply(plan, torch.from_numpy(s), (zfuse.OpSpec("nabla", power=-0.5),), ())
    want = zfuse.apply_plain(plan, torch.from_numpy(s), (zfuse.OpSpec("nabla", power=-0.5),))
    assert zfuse.KERNEL_LAUNCHES == before and torch.equal(got[0], want[0])
    assert zfuse.MIXED_MAX_NZ >= 1701


@pytest.mark.parametrize("nz", [17, 23, 34, 230, 172, 1316, 188, 1504])
def test_generic_pass_plans(nz):
    """A z length with one prime factor from PRIME_MIN to PRIME_MAX takes the mixed kernel
    with a generic pass of that prime first, then the passes of the rest as any mixed plan;
    the bin order they leave is a permutation, and the plan carries it."""
    passes = zfuse.radix_passes(nz)
    p = passes[0]
    assert zfuse.kernel_for(nz) == "mixed" and int(np.prod(passes)) == nz
    assert zfuse.PRIME_MIN <= p <= zfuse.PRIME_MAX and p not in zfuse.RADICES
    assert passes[1:] == (zfuse.radix_passes(nz // p) if nz > p else ())
    assert set(passes[1:]) <= set(zfuse.RADICES) and len(passes) <= zfuse.MAX_PASSES
    bins = zfuse.digit_reversed_bins(passes)
    assert sorted(bins) == list(range(nz))
    _, _, plan, _ = _case(nz=nz, ny=2, nx=4, jax_plan=False)
    np.testing.assert_array_equal(plan.bins.numpy(), bins)


@pytest.mark.parametrize("nz", [127, 251, 289, 1009, 1699, 1709, 1692, 1705])
def test_bluestein_plans(nz):
    """A z length the mixed passes refuse (a prime above PRIME_MAX, two prime factors from
    17 up: 289 = 17^2, or a generic pass whose two tiles of 8 columns, roots and table of
    roots do not fit a block: 1692 = 47 x 36, 1705 = 31 x 55) takes the Bluestein kernel:
    M is the even length from 2 nz to the next power of two, of passes that are all
    radices in registers, whose cost is least (`bluestein_length`); the plan carries no
    bin table, the filter's transform being in the order of the positions, a permutation
    of M; the chirp and the filter's transform are float64's, rounded."""
    assert zfuse.radix_passes(nz) is None and zfuse.kernel_for(nz) == "bluestein"
    _, _, plan, _ = _case(nz=nz, ny=2, nx=4, jax_plan=False)
    m = plan.m
    assert m == zfuse.bluestein_length(nz) >= 2 * nz and m % 2 == 0
    cost = zfuse._bluestein_cost(nz, m, plan.passes)
    for k in range(2 * nz, 1 << (2 * nz - 1).bit_length() + 1, 2):
        passes = zfuse._passes(k, generic=False)
        assert passes is None or zfuse._bluestein_cost(nz, k, passes) >= cost
    assert set(plan.passes) <= set(zfuse.RADICES) and int(np.prod(plan.passes)) == m
    bins = zfuse.digit_reversed_bins(plan.passes)
    assert plan.bins is None and sorted(bins) == list(range(m))
    n = np.arange(nz)
    chirp = np.exp(-1j * np.pi * n.astype(np.float64) ** 2 / nz)
    np.testing.assert_allclose(plan.chirp.numpy(), chirp, rtol=0, atol=1e-6)
    c = np.zeros(m, complex)
    c[:nz], c[m - nz + 1:] = chirp, chirp[1:][::-1]
    want = np.fft.fft(c)[bins] / m
    np.testing.assert_allclose(plan.filt.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert tuple(plan.m_roots.shape) == (m,) and plan.filt.dtype == torch.complex64


@pytest.mark.parametrize("nz", [1, 2, 4, 11, 110, 176, 1009, 1331,
                                13, 17, 23, 127, 1699, 1709])
def test_other_nz_take_the_dense_kernel(nz):
    """The z lengths that took the dense kernel before every length had an FFT (below 8, a
    prime factor of 11 or more, and 1, its last), and more: each takes the kernel
    `kernel_for` names (the column kernel from 1 to 16); the plan carries that kernel's
    tables and none of the others'; the plain version of another kernel refuses it;
    `apply` on the CPU takes the dense plain version and counts no launch; no kernel list
    names a dense kernel."""
    want = {127: "bluestein", 1009: "bluestein", 1699: "bluestein",
            1709: "bluestein"}.get(nz, "column" if nz <= 16 else "mixed")
    assert zfuse.kernel_for(nz) == want
    s, _, plan, _ = _case(nz=nz, ny=2, nx=4, jax_plan=False)
    assert plan.kernel == want
    assert (plan.passes is None) == (want == "column")
    assert (plan.m is None) == (want != "bluestein")
    if want == "mixed":
        assert plan.passes == zfuse.radix_passes(nz)
    nab = (zfuse.OpSpec("nabla"),)
    st = torch.from_numpy(s)
    if want != "bluestein":
        with pytest.raises(ValueError, match="bluestein kernel"):
            zfuse.apply_bluestein_plain(plan, st, nab)
    if want != "mixed":
        with pytest.raises(ValueError, match=f"{want} kernel"):
            zfuse.apply_radix_plain(plan, st, nab)
    before = dict(zfuse.KERNEL_LAUNCHES)
    assert torch.equal(zfuse.apply(plan, st, nab)[0], zfuse.apply_plain(plan, st, nab)[0])
    assert zfuse.KERNEL_LAUNCHES == before
    with pytest.raises(ValueError, match="nz must be in"):
        _case(nz=zfuse.MAX_NZ + 1, ny=2, nx=4, jax_plan=False)
    assert set(zfuse.KERNEL_LAUNCHES) == set(zfuse.KERNELS) == {"radix", "mixed",
                                                                  "bluestein", "column"}


@pytest.mark.parametrize("n_ops,kind", [(1, "grad0"), (1, "nabla"), (3, "grad"),
                                        (3, "nabla")])
@pytest.mark.parametrize("nz", [17, 127, 230, 251, 1009, 1709])
def test_bluestein_plain_matches_float64_and_dense_plain(nz, n_ops, kind):
    """The Bluestein kernel's steps on tensors (the chirp, the passes of M, the filter in
    position order, the 1/M in the table, the operator and 1/nz on the forward
    convolution) at the z lengths it takes and, through a plan that names it, at 17 and 230
    (M = 40, 512), one op and three: within 2e-6 of the peak of float64 (up to M = 3584 at
    nz = 1709) and 4e-6 of `apply_plain`."""
    s, plan, _, specs, dds, ops64 = _radix_case(nz, n_ops, kind, True, seed=nz + n_ops,
                                                jax_plan=False)
    plan = dataclasses.replace(plan, **zfuse.kernel_tables(nz, "bluestein"))
    ddc = tuple(torch.from_numpy(d[:, 0] + 1j * d[:, 1]) for d in dds)
    got = zfuse.apply_bluestein_plain(plan, torch.from_numpy(s), specs, ddc)
    dense = zfuse.apply_plain(plan, torch.from_numpy(s), specs, ddc)
    assert len(got) == n_ops
    for g, d, op64 in zip(got, dense, ops64):
        ref = _ref64(s, op64)
        scale = np.abs(ref).max()
        assert g.dtype == torch.complex64 and tuple(g.shape) == s.shape
        assert np.abs(g.numpy() - ref).max() <= F64_TOL * scale
        assert np.abs(g.numpy() - d.numpy()).max() <= PLAIN_TOL * scale


@pytest.mark.parametrize("nz,m", [(17, 40), (17, 64), (127, 288), (143, 288), (1331, 2688)])
def test_bluestein_tables_at_another_m(nz, m):
    """`bluestein_tables` at a convolution length other than `bluestein_length`'s (as the
    design sweep takes one without radices 11 and 13): its own passes of M (no bin table),
    and the Bluestein steps within 2e-6 of float64's peak, three grad ops off one
    forward."""
    s, plan, _, specs, dds, ops64 = _radix_case(nz, 3, "grad", True, seed=nz, jax_plan=False)
    plan = dataclasses.replace(plan, **zfuse.bluestein_tables(nz, m))
    assert plan.m == m and int(np.prod(plan.passes)) == m and plan.bins is None
    assert sorted(zfuse.digit_reversed_bins(plan.passes)) == list(range(m))
    ddc = tuple(torch.from_numpy(d[:, 0] + 1j * d[:, 1]) for d in dds)
    got = zfuse.apply_bluestein_plain(plan, torch.from_numpy(s), specs, ddc)
    for g, op64 in zip(got, ops64):
        ref = _ref64(s, op64)
        assert np.abs(g.numpy() - ref).max() <= F64_TOL * np.abs(ref).max()


@pytest.mark.parametrize("nz,m", [(17, 32), (17, 34), (127, 254)])
def test_bluestein_tables_refuse_a_length_they_cannot_take(nz, m):
    """M below 2 nz - 1, or with a factor no pass takes (17, 127), is refused."""
    with pytest.raises(ValueError, match="no convolution length"):
        zfuse.bluestein_tables(nz, m)


@pytest.mark.parametrize("nz", [127, 143, 251])
@pytest.mark.parametrize("n_ops,kind,use_kappa", [(1, "grad0", True), (3, "grad", True),
                                                  (3, "grad", False), (3, "nabla", False)])
def test_bluestein_plain_at_the_rule_length_matches_float64_and_the_jax_kernel(nz, n_ops,
                                                                               kind,
                                                                               use_kappa):
    """The Bluestein kernel's steps at the M of `bluestein_length` (127: 256 = 16 x 16;
    143 = 11 x 13, through a plan that names the kernel: 320 = 8 x 8 x 5; 251: 512 =
    8 x 8 x 8), a few columns: within 2e-6 of float64's peak and 3e-5 of the JAX package's
    kernel in interpret mode (its own bound: a bf16 split of the DFT)."""
    s, plan, jplan, specs, dds, ops64 = _radix_case(nz, n_ops, kind, use_kappa, seed=nz)
    plan = dataclasses.replace(plan, **zfuse.kernel_tables(nz, "bluestein"))
    assert plan.m == zfuse.bluestein_length(nz) == {127: 256, 143: 320, 251: 512}[nz]
    ddc = tuple(torch.from_numpy(d[:, 0] + 1j * d[:, 1]) for d in dds)
    got = zfuse.apply_bluestein_plain(plan, torch.from_numpy(s), specs, ddc,
                                      use_kappa=use_kappa)
    theirs = jzfuse.apply(jplan, jnp.asarray(s.real), jnp.asarray(s.imag),
                          tuple(jzfuse.OpSpec(o.kind, o.axis, o.power) for o in specs),
                          tuple(dds), use_kappa=use_kappa, interpret=True)
    for g, (re, im), op64 in zip(got, theirs, ops64):
        _hold(g.numpy(), np.asarray(re) + 1j * np.asarray(im), _ref64(s, op64))


def test_bluestein_length_rule_at_every_z_length_it_takes():
    """At each of the 1013 z lengths up to MAX_NZ that take the Bluestein kernel: M is even,
    from 2 nz to the next power of two, of two to MAX_PASSES passes of radices in
    registers, the first a power of two (the kernel's half-zero first and last passes);
    the tile of one op, two and three fits a block's 227 KB and its blocks an SM's 228 KB;
    and its cost is at most that of the power of two and of the shortest candidate."""
    lengths = [nz for nz in range(2, zfuse.MAX_NZ + 1) if zfuse.kernel_for(nz) == "bluestein"]
    assert len(lengths) == 1013 and lengths[-1] == zfuse.MAX_NZ == 1709
    for nz in lengths:
        m = zfuse.bluestein_length(nz)
        top = 1 << (2 * nz - 1).bit_length()
        assert m % 2 == 0 and 2 * nz <= m <= top, nz
        passes = zfuse._passes(m, generic=False)
        assert 2 <= len(passes) <= zfuse.MAX_PASSES and set(passes) <= set(zfuse.RADICES)
        assert passes[0] in (2, 4, 8, 16) and int(np.prod(passes)) == m
        for n_ops in (1, 2, 3):
            tile = zfuse.bluestein_tile(nz, m, n_ops)
            assert tile.tc in zfuse.BLUESTEIN_TC and 1 <= tile.blocks <= zfuse.BLUESTEIN_BLOCKS
            assert tile.smem <= zfuse.SMEM_BLOCK
            assert tile.blocks * (tile.smem + zfuse.SMEM_RESERVED) <= zfuse.SMEM_SM
        cost = zfuse._bluestein_cost(nz, m, passes)
        shortest = next(k for k in range(2 * nz, top + 1, 2)
                        if len(zfuse._passes(k, generic=False) or ()) >= 2)
        for k in (top, shortest):
            assert cost <= zfuse._bluestein_cost(nz, k, zfuse._passes(k, generic=False)), nz


def test_bluestein_tile_rule():
    """`bluestein_tile`: the width of least fitted cost (the widest that keeps two blocks
    an SM, here), fewer columns or blocks as M grows, the nz tile only with several ops,
    the tables staged while they cost no block, a named width that does not fit refused."""
    one, three = (zfuse.bluestein_tile(251, 512, k) for k in (1, 3))
    assert (one.tc, one.blocks, one.staged) == (16, 3, ("filt", "chirp", "k2z"))
    assert (three.tc, three.blocks) == (16, 2)
    assert three.smem - one.smem == 8 * 251 * 16  # the nz tile of the forward convolution
    assert one.smem == 8 * (512 * 16 + 512 + 512 + 251) + 4 * 251
    wide = zfuse.bluestein_tile(1009, 2048, 1)
    assert (wide.tc, wide.blocks) == (4, 2)
    assert zfuse.bluestein_tile(1009, 2048, 1, tc=32) is None
    assert zfuse.bluestein_tile(1009, 2048, 3, tc=8).blocks == 1


@pytest.mark.parametrize("nz", [22, 26, 34])
def test_bluestein_plain_matches_the_jax_kernel(nz):
    """The Bluestein kernel's steps on tensors, through a plan that names it, against the
    JAX package's kernel in interpret mode, three grad ops off one forward."""
    s, plan, jplan, specs, dds, ops64 = _radix_case(nz, 3, "grad", True, seed=nz + 7)
    plan = dataclasses.replace(plan, **zfuse.kernel_tables(nz, "bluestein"))
    ddc = tuple(torch.from_numpy(d[:, 0] + 1j * d[:, 1]) for d in dds)
    got = zfuse.apply_bluestein_plain(plan, torch.from_numpy(s), specs, ddc)
    theirs = jzfuse.apply(jplan, jnp.asarray(s.real), jnp.asarray(s.imag),
                          tuple(jzfuse.OpSpec(o.kind, o.axis, o.power) for o in specs),
                          tuple(dds), use_kappa=True, interpret=True)
    for g, (re, im), op64 in zip(got, theirs, ops64):
        _hold(g.numpy(), np.asarray(re) + 1j * np.asarray(im), _ref64(s, op64))


@pytest.mark.parametrize("n_ops,kind,use_kappa", [(1, "grad0", True), (1, "nabla", False),
                                                  (3, "grad", True), (3, "grad", False)])
@pytest.mark.parametrize("nz", COLUMN_JAX_NZ)
def test_column_plain_matches_the_jax_kernel_and_float64(nz, n_ops, kind, use_kappa):
    """The column kernel's z lengths: the plan names it, carries no passes and no bin table
    (the kernel takes the operator at the natural bin), and `apply` on the CPU takes its
    plain version, `apply_plain` (the dense product over z), and counts no launch; within
    3e-5 of the JAX package's kernel in interpret mode and 2e-6 of a float64 FFT's peak."""
    s, plan, jplan, specs, dds, ops64 = _radix_case(nz, n_ops, kind, use_kappa, seed=nz + 40)
    assert plan.kernel == zfuse.kernel_for(nz) == "column"
    assert plan.passes is None and plan.bins is None and plan.m is None
    ddc = tuple(torch.from_numpy(d[:, 0] + 1j * d[:, 1]) for d in dds)
    before = dict(zfuse.KERNEL_LAUNCHES)
    got = zfuse.apply(plan, torch.from_numpy(s), specs, ddc, use_kappa=use_kappa)
    assert zfuse.KERNEL_LAUNCHES == before
    theirs = jzfuse.apply(jplan, jnp.asarray(s.real), jnp.asarray(s.imag),
                          tuple(jzfuse.OpSpec(o.kind, o.axis, o.power) for o in specs),
                          tuple(dds), use_kappa=use_kappa, interpret=True)
    for g, (re, im), op64 in zip(got, theirs, ops64):
        assert g.dtype == torch.complex64 and tuple(g.shape) == s.shape
        _hold(g.numpy(), np.asarray(re) + 1j * np.asarray(im), _ref64(s, op64))


@pytest.mark.parametrize("nz", list(range(1, 18)))
def test_short_z_lengths_take_the_column_kernel_where_it_was_measured_faster(nz):
    """Every z length from 2 to 16 takes the column kernel (COLUMN_NZ: measured faster
    there than the radix or mixed kernel that took it before), 1 too (a grid of one z
    plane: the transforms are the identity), and 17 the mixed kernel; a plan may name the
    column kernel at any z length from 1 to COLUMN_MAX_NZ (the kernel is built for each)
    and at no other, and the radix or mixed kernel at a column length from 2."""
    want = "column" if nz <= 16 else "mixed"
    assert zfuse.kernel_for(nz) == want and (nz in zfuse.COLUMN_NZ) == (want == "column")
    assert zfuse.COLUMN_NZ == set(range(1, zfuse.COLUMN_MAX_NZ + 1))
    if nz <= zfuse.COLUMN_MAX_NZ:
        assert zfuse.kernel_tables(nz, "column") == dict(
            kernel="column", passes=None, bins=None, m=None, chirp=None, filt=None,
            m_roots=None)
    else:
        with pytest.raises(ValueError, match="column kernel does not take"):
            zfuse.kernel_tables(nz, "column")
    tiled = "radix" if nz in (8, 16) else "mixed"
    if nz == 1:  # no FFT kernel takes a length of 1
        with pytest.raises(ValueError, match=f"{tiled} kernel does not take"):
            zfuse.kernel_tables(nz, tiled)
        with pytest.raises(ValueError, match="column kernel does not take"):
            zfuse.kernel_tables(0, "column")
    else:
        assert zfuse.kernel_tables(nz, tiled)["passes"] == zfuse.radix_passes(nz)


def test_apply_refuses_a_plan_without_its_fft_tables():
    """A plan may name another kernel (a test holds a kernel at a length that `kernel_for`
    sends elsewhere), but an FFT kernel needs passes of its radices that multiply to its
    length, the radix and mixed kernels the bin table, and the Bluestein kernel an even M
    >= 2 nz, the chirp, the filter and the M roots; a kernel that is not one of KERNELS
    ("dense" among them) is refused."""
    s, _, plan, _ = _case(nz=24, ny=2, nx=4)
    st, nab = torch.from_numpy(s), (zfuse.OpSpec("nabla"),)
    for bad in (dataclasses.replace(plan, bins=None), dataclasses.replace(plan, passes=(8, 4)),
                dataclasses.replace(plan, passes=None),
                dataclasses.replace(plan, kernel="dense", passes=None),
                dataclasses.replace(plan, kernel="fft"),
                dataclasses.replace(plan, kernel="bluestein"),
                dataclasses.replace(plan, passes=(12, 2)),
                dataclasses.replace(plan, **{**zfuse.kernel_tables(24, "bluestein"),
                                             "chirp": None}),
                dataclasses.replace(plan, **zfuse.kernel_tables(12, "bluestein"))):
        with pytest.raises(ValueError, match="kernel"):
            zfuse.apply(bad, st, nab)


def test_apply_refuses_bad_arguments():
    s, _, plan, _ = _case()
    st = torch.from_numpy(s)
    g = zfuse.OpSpec("grad", axis=0)
    with pytest.raises(ValueError, match="complex64"):
        zfuse.apply(plan, st.to(torch.complex128), (g,), (plan.roots,))
    with pytest.raises(ValueError, match="dd vectors"):
        zfuse.apply(plan, st, (g,), ())
    with pytest.raises(ValueError, match="share one forward"):
        zfuse.apply(plan, st, (zfuse.OpSpec("nabla"),) * 4, ())
    with pytest.raises(ValueError, match="axis 0"):
        zfuse.apply(plan, st, (g,), (plan.roots[:5].contiguous(),))
    with pytest.raises(ValueError, match="grad .* or nabla"):
        zfuse.apply(plan, st, (zfuse.OpSpec("curl"),), ())


# ---------------------------------------------------------------------------
# Compact operators, the fused step, the fused run_simulation
# ---------------------------------------------------------------------------


def _setup(n=16, nt=8):
    kw = dict(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=nt)
    rng = np.random.default_rng(7)
    medium = dict(c0=(1500.0 + 100.0 * rng.random((n, n, n))).astype(np.float32),
                  rho0=1000.0, alpha_coeff=0.75, alpha_power=1.5)
    p0 = np.zeros((n, n, n), np.float32)
    p0[n // 2, n // 2, n // 2] = 1e5
    return kw, medium, p0


def _march(ops, p0, n_steps, spectral_multi=None, cfg=None):
    cfg = cfg or solver.SolverConfig(absorbing=True)
    grid_like = solver.Grid(nx=p0.shape[2], ny=p0.shape[1], nz=p0.shape[0], dx=1, dy=1,
                            dz=1, dt=1, nt=1)
    st = solver.add_initial_pressure(solver.init_state(grid_like), ops,
                                     torch.from_numpy(p0), spectral_multi)
    for t in range(1, 1 + n_steps):
        st = solver.step(st, t, ops, solver.Sources(), cfg, spectral_multi)
    return st.p.numpy()


@pytest.mark.parametrize("dim", [2, 3])
def test_compact_operators_match_the_jax_package(dim):
    kw, medium, _ = _setup()
    if dim == 2:
        kw.update(nz=1, dz=0.0)
        medium["c0"] = medium["c0"][0]
    pml = ((2,) * dim, (2.0,) * dim)
    mine = solver.make_operators(solver.Grid(**kw), solver.Medium(**medium), *pml,
                                 absorbing=True, need_source_kappa=True, need_shift=True,
                                 compact=True)
    theirs = convert.operators_from_jax(jsolver.make_operators(
        jsolver.Grid(**kw), jsolver.Medium(**medium), *pml, absorbing=True,
        need_source_kappa=True, need_shift=True, compact=True))
    for name in ("kappa", "absorb_nabla1", "absorb_nabla2", "source_kappa", "c2",
                 "absorb_tau", "absorb_eta"):
        assert getattr(mine, name) is None, name
    assert (mine.k2_z is None) == (dim == 2)
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if not isinstance(a, torch.Tensor):
            assert a == b, f.name
            continue
        assert a.dtype == b.dtype and torch.equal(a, b), f.name


def test_lazy_accessors_rebuild_the_full_operators():
    """Each accessor on compact operators against the host-built array of full
    operators, to fp32 rounding of the transcendental (1e-6 relative to the peak)."""
    kw, medium, _ = _setup()
    args = (solver.Grid(**kw), solver.Medium(**medium), (2, 2, 2), (2.0,) * 3)
    full = solver.make_operators(*args, absorbing=True, need_source_kappa=True)
    compact = solver.make_operators(*args, absorbing=True, need_source_kappa=True,
                                    compact=True)
    pairs = [(step_mod._kappa(compact, 3), full.kappa),
             (step_mod._source_kappa_op(compact, 3), full.source_kappa),
             (step_mod._c2_op(compact), full.c2)]
    pairs += list(zip(step_mod._absorb_nablas(compact, 3),
                      (full.absorb_nabla1, full.absorb_nabla2)))
    pairs += list(zip(step_mod._tau_eta_op(compact), (full.absorb_tau, full.absorb_eta)))
    for got, want in pairs:
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert step_mod._kappa(full, 3) is full.kappa  # host-built arrays win when present


def test_compact_step_matches_full_step():
    kw, medium, p0 = _setup()
    args = (solver.Grid(**kw), solver.Medium(**medium), (2, 2, 2), (2.0,) * 3)
    p_full = _march(solver.make_operators(*args, absorbing=True), p0, 6)
    p_compact = _march(solver.make_operators(*args, absorbing=True, compact=True), p0, 6)
    assert np.abs(p_compact - p_full).max() <= 1e-5 * np.abs(p_full).max()


@pytest.mark.parametrize("nonlinear", [False, True])
def test_step_with_spectral_multi_matches_unfused(nonlinear):
    """All 14 transforms of the heterogeneous absorbing step through the fused pipeline
    (three outputs off one forward for the pressure gradient, the three velocity
    gradients, the two nabla terms without kappa) against the unfused compact step."""
    kw, medium, p0 = _setup()
    if nonlinear:
        medium["bona"] = 6.0
    ops = solver.make_operators(solver.Grid(**kw), solver.Medium(**medium), (2, 2, 2),
                                (2.0,) * 3, absorbing=True, compact=True)
    calls = []
    pipeline = zfuse.make_pipeline((16, 16, 16), ops.k2_z, ops.k2_y, ops.k2_x,
                                   ops.c_ref_dt_2)

    def counted(field, specs, dds, use_kappa=True):
        calls.append((tuple(s.kind for s in specs), use_kappa))
        return pipeline(field, specs, dds, use_kappa)

    cfg = solver.SolverConfig(absorbing=True, nonlinear=nonlinear)
    p_ref = _march(ops, p0, 6, cfg=cfg)
    p_fused = _march(ops, p0, 6, counted, cfg=cfg)
    assert np.abs(p_fused - p_ref).max() <= 2e-4 * np.abs(p_ref).max()
    per_step = [(("grad",) * 3, True)] + [(("grad",), True)] * 3 + [(("nabla",), False)] * 2
    assert calls == per_step[:1] + per_step * 6  # the p0 peel, then 6 steps


def _input(kw, medium, p0, n_sensors=48):
    from kwave_tpu_torch.io.input_file import InputData

    grid = solver.Grid(**kw)
    mask = np.sort(np.random.default_rng(1).choice(grid.n_elements, n_sensors,
                                                   replace=False))
    return InputData(grid=grid, medium=solver.Medium(**medium), pml_size=(2, 2, 2),
                     pml_alpha=(2.0,) * 3, sensor_mask_index=mask, p0=p0), mask


def test_driver_fuse_z_matches_default_and_jax(tmp_path):
    """run_simulation with fuse_z on (the tiny configuration of tests/test_zfuse.py)
    against the port's default run and the JAX package's fuse_z run."""
    _hold_fuse_z_run(tmp_path, nz=16, fft_direct_base=16)


def test_driver_fuse_z_with_a_radix_11_pass_matches_default_and_jax(tmp_path):
    """The same at nz = 22, whose plan is the mixed kernel's with a pass of radix 11. The
    JAX package builds its fused z stage only under its matmul FFT (without it ``fuse_z``
    changes nothing there), so its run takes ``matmul_fft=True`` at the automatic direct
    base (128), which does not split z: its fused run is then 6.1e-5 of the peak off the
    port's default run. At ``fft_direct_base=16``, which splits z = 22, its fused run reads
    0.90 of the peak off: a fault of the reference's fused stage, not a reference."""
    assert zfuse.radix_passes(22) == (2, 11)
    _hold_fuse_z_run(tmp_path, nz=22, fft_direct_base=None)


def _hold_fuse_z_run(tmp_path, nz, fft_direct_base):
    """The port's default, compact and fused runs, and the JAX package's fused run (its
    matmul FFT at ``fft_direct_base``, None for its automatic base), each within 1e-4 of
    the peak of the port's default run, and the two fused runs of each other."""
    from kwave_tpu.driver import RunConfig as JRunConfig
    from kwave_tpu.driver import run_simulation as jrun
    from kwave_tpu.io.input_file import InputData as JInputData
    from kwave_tpu_torch.driver import RunConfig, run_simulation

    kw, _, p0 = _setup(nt=30)
    if nz != kw["nz"]:
        kw["nz"] = nz
        p0 = np.zeros((nz, kw["ny"], kw["nx"]), np.float32)
        p0[nz // 2, kw["ny"] // 2, kw["nx"] // 2] = 1e5
    medium = dict(c0=1500.0, rho0=1000.0)
    data, mask = _input(kw, medium, p0)
    outs = {}
    for name, run in (("default", RunConfig(flags=dict(p_raw=True))),
                      ("compact", RunConfig(flags=dict(p_raw=True), compact_operators=True)),
                      ("fused", RunConfig(flags=dict(p_raw=True), compact_operators=True,
                                          fuse_z=True))):
        path = str(tmp_path / f"{name}.h5")
        run_simulation(data, run, path, device="cpu")
        with h5py.File(path) as f:
            outs[name] = np.asarray(f["p"])
    jdata = JInputData(grid=jsolver.Grid(**kw), medium=jsolver.Medium(**medium),
                       pml_size=(2, 2, 2), pml_alpha=(2.0,) * 3, sensor_mask_index=mask,
                       p0=p0)
    jpath = str(tmp_path / "jax.h5")
    fft = dict(matmul_fft=True, fft_precision="high")
    if fft_direct_base is not None:
        fft["fft_direct_base"] = fft_direct_base
    jrun(jdata, JRunConfig(flags=dict(p_raw=True), compact_operators=True, fuse_z=True, **fft),
         jpath)
    with h5py.File(jpath) as f:
        outs["jax"] = np.asarray(f["p"])
    ref = outs["default"]
    assert ref.shape == (1, 30, 48) or ref.shape[-2:] == (30, 48)
    for name in ("compact", "fused", "jax"):
        assert outs[name].shape == ref.shape
        assert np.abs(outs[name] - ref).max() <= 1e-4 * np.abs(ref).max(), name
    assert np.abs(outs["fused"] - outs["jax"]).max() <= 1e-4 * np.abs(outs["jax"]).max()


def test_driver_fuse_z_without_3d_compact_operators_warns_and_runs_unfused(tmp_path,
                                                                           monkeypatch):
    import io

    from kwave_tpu_torch.driver import RunConfig, run_simulation
    from kwave_tpu_torch.utils.observability import Logger

    log = io.StringIO()
    monkeypatch.setattr(Logger, "_out", log)  # the logger holds the stream it was born with

    kw, _, p0 = _setup(nt=6)
    data, _ = _input(kw, dict(c0=1500.0, rho0=1000.0), p0)
    out = {}
    for name, run in (("plain", RunConfig(flags=dict(p_raw=True))),
                      ("asked", RunConfig(flags=dict(p_raw=True), compact_operators=False,
                                          fuse_z=True))):
        path = str(tmp_path / f"{name}.h5")
        run_simulation(data, run, path, device="cpu")
        with h5py.File(path) as f:
            out[name] = np.asarray(f["p"])
    assert log.getvalue().count("fuse_z needs 3D compact operators") == 1
    np.testing.assert_array_equal(out["asked"], out["plain"])


def test_driver_fuse_z_beyond_the_largest_z_length_warns_and_runs_unfused(tmp_path,
                                                                         monkeypatch):
    """nz = MAX_NZ + 1 with compact operators and fuse_z: one BASIC warning, and the output
    of the unfused compact run bit for bit (the JAX package runs such a grid too)."""
    import io

    from kwave_tpu_torch.driver import RunConfig, run_simulation
    from kwave_tpu_torch.utils.observability import Logger

    log = io.StringIO()
    monkeypatch.setattr(Logger, "_out", log)
    nz = zfuse.MAX_NZ + 1
    kw = dict(nx=8, ny=8, nz=nz, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=4)
    p0 = np.zeros((nz, 8, 8), np.float32)
    p0[nz // 2, 4, 4] = 1e5
    data, _ = _input(kw, dict(c0=1500.0, rho0=1000.0), p0)
    out = {}
    for name, fuse in (("compact", None), ("asked", True)):
        path = str(tmp_path / f"{name}.h5")
        run_simulation(data, RunConfig(flags=dict(p_raw=True), compact_operators=True,
                                       fuse_z=fuse), path, device="cpu")
        with h5py.File(path) as f:
            out[name] = np.asarray(f["p"])
    assert log.getvalue().count(f"fuse_z takes nz up to {zfuse.MAX_NZ}") == 1
    assert np.abs(out["compact"]).max() > 0
    np.testing.assert_array_equal(out["asked"], out["compact"])


@pytest.mark.parametrize("n,asked,want", [(192, None, True), (191, None, False),
                                          (192, False, False), (16, True, True)])
def test_compact_operators_are_automatic_from_192_cubed(monkeypatch, n, asked, want):
    """The rule of `run_simulation` for `compact_operators=None`, read off the `compact` argument it
    hands to make_operators (stopped there, so that no full-size grid is built)."""
    from kwave_tpu_torch import driver
    from kwave_tpu_torch.io.input_file import InputData

    class Stop(Exception):
        pass

    def fake_make_operators(*args, compact, **kwargs):
        raise Stop(compact)

    monkeypatch.setattr(driver, "make_operators", fake_make_operators)
    grid = solver.Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=4)
    data = InputData(grid=grid, medium=solver.Medium(c0=1500.0, rho0=1000.0),
                     pml_size=(2, 2, 2), pml_alpha=(2.0,) * 3,
                     sensor_mask_index=np.arange(4))
    run = driver.RunConfig(flags=dict(p_raw=True), compact_operators=asked)
    with pytest.raises(Stop) as stop:
        driver.run_simulation(data, run, "unused.h5", device="cpu")
    assert stop.value.args[0] is want
    assert driver.RunConfig(flags={}).fuse_z is None
