"""Fused z stage of the solver's spectral multiplies: z-DFT -> pointwise operator ->
z-IDFT in one kernel, with the operator built in the kernel from per-axis vectors.

Replaces the TPU kernel of ``kwave_tpu/ops/zfuse.py`` (``_kernel``, entries ``apply`` and
``make_pipeline``). For each (y, x) column of a spectrum ``S[nz, ny, nxr]`` (z in canonical
bin order, after the x/y transforms):

- ``F = DFT_z . S``; ``k^2 = k2z[z] + (k2y[y] + k2x[x])``;
- "grad" ops multiply by ``kappa * dd[axis]``, where ``kappa = sin(a)/a`` with
  ``a = c_ref_dt_2 * sqrt(k^2)`` (1 at ``a == 0``; left out when ``use_kappa`` is false)
  and ``dd`` is a complex per-axis vector indexed by z, y or x (the
  computePressureGradient / computeVelocityGradient factors);
- "nabla" ops multiply by ``|k|^power`` with 0 at ``k == 0`` (the absorbing-term factors);
- ``out = IDFT_z . G`` (with the 1/nz). Up to three ops share the one forward transform.

Two kernels, both CUDA C++ for sm_90a in ``kwave_tpu_torch/csrc/zfuse.cu``; `apply`
chooses by ``nz`` (`kernel_for`), and either launches or raises:

- "radix", for ``nz`` a power of two from 8 to 1024: a radix FFT in shared memory.
  `radix_passes` gives its passes (radix 16, 8 or 4; 256 = 16 x 16). Forward as decimation
  in frequency, which leaves ``F`` in digit-reversed order (`digit_reversed_bins`); the
  operator is looked up at the bin each position holds; inverse as decimation in time,
  which takes that order and gives natural order. It is bound by the bytes it moves.
  `apply_radix_plain` is the same passes on tensors.
- "dense", for every other ``nz`` up to `MAX_NZ`: the dense DFT in fp32 FMAs, the ``nz``
  roots of unity indexed by ``(k*z) mod nz``; bound by operations (``16*nz^2`` flop per
  column and op pair against 16 B moved). `apply_plain` is the same sum as a matrix
  product.

`apply` takes `apply_plain` only for tensors on the CPU. Spectra and ``dd`` vectors are
complex64 tensors (the JAX package's re/im planes and ``[n, 128]`` / ``[8, n]`` tilings are
TPU layout, not semantics).

`make_pipeline` builds the solver's ``spectral_multi``: ``torch.fft.rfft2`` over (y, x),
`apply` over z, ``torch.fft.irfft2`` back (the JAX package takes matmul transforms for x
and y only because XLA's FFT is slow on a TPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Launches of the kernel by `apply` (not by the plain version), by the number of ops.
LAUNCHES = {"zfuse_1op": 0, "zfuse_2op": 0, "zfuse_3op": 0}

# The same launches by the kernel that took them.
KERNEL_LAUNCHES = {"radix": 0, "dense": 0}

MAX_OPS = 3
# dense: two tiles of nz x 8 columns (re/im planes) and the roots must fit a block's 227 KB
MAX_NZ = (227 * 1024) // (8 * 4 * 4 + 8)
# radix: a power of two in this range (at 1024 two tiles of nz x 8 columns are 128 KB)
RADIX_MIN_NZ, RADIX_MAX_NZ = 8, 1024


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, KERNEL_LAUNCHES):
        for k in counts:
            counts[k] = 0


def radix_passes(nz: int) -> tuple[int, ...] | None:
    """The radices of the radix kernel's forward passes, first pass first, or None where
    ``nz`` goes to the dense kernel. As few passes as radix <= 16 allows, the widest first."""
    if nz & (nz - 1) or not RADIX_MIN_NZ <= nz <= RADIX_MAX_NZ:
        return None
    bits = nz.bit_length() - 1
    n_passes = -(-bits // 4)
    passes = []
    for left in range(n_passes, 0, -1):
        b = -(-bits // left)
        passes.append(1 << b)
        bits -= b
    return tuple(passes)


def kernel_for(nz: int) -> str:
    """Which of the two kernels a spectrum of ``nz`` bins takes: "radix" or "dense"."""
    return "radix" if radix_passes(nz) else "dense"


def digit_reversed_bins(passes: tuple[int, ...]) -> np.ndarray:
    """``bins[p]``: the bin that position ``p`` holds after the forward passes. With
    radices R0, R1, ... and ``p = q0*(nz/R0) + q1*(nz/(R0*R1)) + ...`` it is
    ``q0 + R0*(q1 + R1*(...))``."""
    p = np.arange(int(np.prod(passes)))
    bins, weight, below = np.zeros_like(p), 1, len(p)
    for r in passes:
        below //= r
        bins += (p // below) % r * weight
        weight *= r
    return bins


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One pointwise spectral operator. kind="grad": ``kappa * dd[axis]``, its complex dd
    vector passed in ``dds`` of `apply`; kind="nabla": ``|k|^power``, 0 at k = 0."""

    kind: str  # "grad" | "nabla"
    axis: int = 0  # grad: 0=z, 1=y, 2=x (index into [nz, ny, nxr])
    power: float = 0.0  # nabla exponent


@dataclasses.dataclass(frozen=True)
class ZFusePlan:
    """Constants of one spectrum shape on one device (built once per run)."""

    nz: int
    ny: int
    nxr: int
    c_ref_dt_2: float
    roots: torch.Tensor  # [nz] complex64: exp(-2*pi*i*j/nz)
    k2z: torch.Tensor  # [nz] float32
    k2y: torch.Tensor  # [ny]
    k2x: torch.Tensor  # [nxr]
    passes: tuple[int, ...] | None = None  # the radix kernel's; None: the dense kernel


def make_plan(shape: tuple[int, int, int], k2z, k2y, k2x, c_ref_dt_2: float,
              device: torch.device | str = "cpu") -> ZFusePlan:
    """``shape`` is the real grid ``[nz, ny, nx]``; ``k2*`` are the per-axis wavenumber^2
    vectors (``k2x`` reduced to ``nx//2 + 1``)."""
    nz, ny, nx = (int(n) for n in shape)

    def vec(v, n):
        v = torch.as_tensor(np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                                       else v, np.float32)).to(device)
        if tuple(v.shape) != (n,):
            raise ValueError(f"expected a k^2 vector of {n} entries; got {tuple(v.shape)}")
        return v.contiguous()

    if not 1 <= nz <= MAX_NZ:
        raise ValueError(f"nz must be in 1..{MAX_NZ}; got {nz}")
    roots = np.exp(-2j * np.pi * np.arange(nz) / nz).astype(np.complex64)
    return ZFusePlan(nz=nz, ny=ny, nxr=nx // 2 + 1, c_ref_dt_2=float(c_ref_dt_2),
                     roots=torch.from_numpy(roots).to(device),
                     k2z=vec(k2z, nz), k2y=vec(k2y, ny), k2x=vec(k2x, nx // 2 + 1),
                     passes=radix_passes(nz))


def full_operator(plan: ZFusePlan, op: OpSpec, dd, use_kappa: bool) -> torch.Tensor:
    """The full pointwise operator [nz, ny, nxr] of one op, in the kernel's order."""
    k2 = plan.k2z[:, None, None] + (plan.k2y[None, :, None] + plan.k2x[None, None, :])
    if op.kind == "nabla":
        kmag = torch.sqrt(k2)
        safe = torch.where(kmag == 0, torch.ones_like(kmag), kmag)
        return torch.where(kmag == 0, torch.zeros_like(kmag), safe ** op.power)
    shape = [1, 1, 1]
    shape[op.axis] = -1
    d = dd.reshape(shape)
    if not use_kappa:
        return d
    arg = plan.c_ref_dt_2 * torch.sqrt(k2)
    kappa = torch.where(arg == 0, torch.ones_like(arg),
                        torch.sin(arg) / torch.where(arg == 0, torch.ones_like(arg), arg))
    return d * kappa


def apply_plain(plan: ZFusePlan, s: torch.Tensor, ops: tuple[OpSpec, ...], dds: tuple = (),
                use_kappa: bool = True) -> list[torch.Tensor]:
    """`apply` in plain PyTorch: the dense z-DFT as a complex matrix product, the
    operators as full arrays."""
    nz = plan.nz
    j = torch.arange(nz, device=s.device)
    fwd = plan.roots[(j[:, None] * j[None, :]) % nz]  # [k, z]
    inv = fwd.conj() / nz
    f = torch.einsum("kz,zyx->kyx", fwd, s)
    outs, dd_i = [], 0
    for op in ops:
        dd = None
        if op.kind == "grad":
            dd = dds[dd_i]
            dd_i += 1
        outs.append(torch.einsum("zk,kyx->zyx", inv,
                                 f * full_operator(plan, op, dd, use_kappa)))
    return outs


def _small_dft(r: int, inverse: bool, device) -> torch.Tensor:
    j = np.arange(r)
    w = np.exp((2j if inverse else -2j) * np.pi * ((j[:, None] * j[None, :]) % r) / r)
    return torch.from_numpy(w.astype(np.complex64)).to(device)


def apply_radix_plain(plan: ZFusePlan, s: torch.Tensor, ops: tuple[OpSpec, ...],
                      dds: tuple = (), use_kappa: bool = True) -> list[torch.Tensor]:
    """`apply` as the radix kernel computes it, on tensors: the forward passes of
    ``plan.passes`` (a pass of radix R over sub-transforms of length L takes positions
    ``blk*L + j + m*(L/R)`` and leaves output q, times ``w_L^(q*j)``, at
    ``blk*L + j + q*(L/R)``), the operator at the bin each position then holds, and the
    same passes undone in reverse order with the conjugate roots."""
    if plan.passes is None:
        raise ValueError(f"nz={plan.nz} has no radix passes; it takes the dense kernel")
    nz, tail = plan.nz, tuple(s.shape[1:])
    j = torch.arange(nz, device=s.device)

    def twiddle(length, r):  # [r (q), length/r (j)]: w_L^(q*j) = roots[q*j*(nz/L)]
        return plan.roots[(j[:r, None] * j[None, :length // r]) * (nz // length)]

    f, length = s, nz
    for r in plan.passes:
        v = f.reshape(nz // length, r, length // r, *tail)  # [blk, m, j, y, x]
        v = torch.einsum("qm,bmjyx->bqjyx", _small_dft(r, False, s.device), v)
        f = (v * twiddle(length, r)[None, :, :, None, None]).reshape(nz, *tail)
        length //= r
    bins = torch.from_numpy(digit_reversed_bins(plan.passes)).to(s.device)
    outs, dd_i = [], 0
    for op in ops:
        dd = None
        if op.kind == "grad":
            dd = dds[dd_i]
            dd_i += 1
        full = full_operator(plan, op, dd, use_kappa)
        if full.shape[0] == nz:  # the operator varies along z: take it at each position's bin
            full = full[bins]
        g, length = f * (full / nz), 1
        for r in reversed(plan.passes):
            length *= r
            v = g.reshape(nz // length, r, length // r, *tail)  # [blk, q, j, y, x]
            v = v * twiddle(length, r).conj()[None, :, :, None, None]
            g = torch.einsum("mq,bqjyx->bmjyx", _small_dft(r, True, s.device),
                             v).reshape(nz, *tail)
        outs.append(g.to(torch.complex64))
    return outs


def _check(plan: ZFusePlan, s, ops, dds) -> None:
    if s.dtype != torch.complex64 or tuple(s.shape) != (plan.nz, plan.ny, plan.nxr):
        raise ValueError(f"the spectrum must be complex64 [{plan.nz}, {plan.ny}, "
                         f"{plan.nxr}]; got {s.dtype} {tuple(s.shape)}")
    if not 1 <= len(ops) <= MAX_OPS:
        raise ValueError(f"1..{MAX_OPS} ops share one forward transform; got {len(ops)}")
    grads = [op for op in ops if op.kind == "grad"]
    if any(op.kind not in ("grad", "nabla") for op in ops) or \
            any(op.axis not in (0, 1, 2) for op in grads):
        raise ValueError(f"ops must be grad (axis 0..2) or nabla; got {ops}")
    if len(dds) != len(grads):
        raise ValueError(f"{len(grads)} grad ops need {len(grads)} dd vectors; got "
                         f"{len(dds)}")
    for op, dd in zip(grads, dds):
        n = (plan.nz, plan.ny, plan.nxr)[op.axis]
        if dd.dtype != torch.complex64 or tuple(dd.shape) != (n,):
            raise ValueError(f"the dd vector of axis {op.axis} must be complex64 [{n}]; got "
                             f"{dd.dtype} {tuple(dd.shape)}")
    for t in (s, plan.roots, plan.k2z, *dds):
        if t.device != s.device:
            raise ValueError(f"all tensors must be on {s.device}; got {t.device}")
        if not t.is_contiguous():
            raise ValueError("all tensors must be contiguous")
    if s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {s.device}")


def apply(plan: ZFusePlan, s: torch.Tensor, ops: tuple[OpSpec, ...], dds: tuple = (),
          use_kappa: bool = True) -> list[torch.Tensor]:
    """Run the fused z stage on the spectrum ``s[nz, ny, nxr]`` (complex64): returns one
    complex64 spectrum per op. ``dds``: one complex64 vector per "grad" op, in op order.

    On a CUDA tensor this launches one of two hand-written kernels, by ``nz``: the radix
    FFT where `radix_passes` gives a plan (a power of two, 8..1024), the dense DFT for every
    other ``nz``. `KERNEL_LAUNCHES` counts which. Neither falls back to the other or to a
    plain version."""
    ops, dds = tuple(ops), tuple(dds)
    _check(plan, s, ops, dds)
    if s.device.type == "cpu":
        return apply_plain(plan, s, ops, dds, use_kappa)
    from kwave_tpu_torch.ops import _build

    lib = _build.load_library()
    outs = [torch.empty_like(s) for _ in ops]
    dd_iter = iter(dds)
    dd_ptrs = [next(dd_iter).data_ptr() if op.kind == "grad" else None for op in ops]
    pad = MAX_OPS - len(ops)
    kernel = "radix" if plan.passes else "dense"
    fn, radices = lib.kw_zfuse, ()
    if plan.passes:
        fn, radices = lib.kw_zfuse_radix, plan.passes + (1,) * (3 - len(plan.passes))
    with torch.cuda.device(s.device):
        err = fn(
            s.data_ptr(), plan.roots.data_ptr(), plan.k2z.data_ptr(), plan.k2y.data_ptr(),
            plan.k2x.data_ptr(), *dd_ptrs, *[None] * pad,
            *(o.data_ptr() for o in outs), *[None] * pad,
            plan.nz, plan.ny, plan.nxr, len(ops),
            *(0 if op.kind == "grad" else 1 for op in ops), *[0] * pad,
            *(op.axis for op in ops), *[0] * pad,
            *(float(op.power) for op in ops), *[0.0] * pad,
            plan.c_ref_dt_2, int(bool(use_kappa)), *radices,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"zfuse.apply ({kernel} kernel): CUDA launch failed with "
                           f"cudaError {err}")
    LAUNCHES[f"zfuse_{len(ops)}op"] += 1
    KERNEL_LAUNCHES[kernel] += 1
    return outs


def make_pipeline(shape: tuple[int, int, int], k2z, k2y, k2x, c_ref_dt_2: float,
                  device: torch.device | str = "cpu"):
    """Build the solver's ``spectral_multi`` for a 3D grid: ``(field, op_specs, dd_vectors,
    use_kappa) -> [real fields]``, computing ``irfftn(op * [kappa *] rfftn(field))`` per op
    with the x/y stages as ``rfft2``/``irfft2`` and the z stage and operators fused in
    `apply`. The kernel's IDFT carries 1/nz, ``irfft2`` the 1/(ny*nx)."""
    nz, ny, nx = (int(n) for n in shape)
    plan = make_plan((nz, ny, nx), k2z, k2y, k2x, c_ref_dt_2, device)

    def spectral_multi(field, specs, dds, use_kappa=True):
        s = torch.fft.rfft2(field)  # [nz, ny, nxr], z still in real space
        outs = apply(plan, s, tuple(specs), tuple(dds), use_kappa=use_kappa)
        return [torch.fft.irfft2(o, s=(ny, nx)) for o in outs]

    return spectral_multi
