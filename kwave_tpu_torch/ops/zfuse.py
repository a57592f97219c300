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

Three kernels, all CUDA C++ for sm_90a in ``kwave_tpu_torch/csrc/zfuse.cu``. `make_plan`
chooses one by ``nz`` (`kernel_for`) and records it in the plan; `apply` launches the
kernel its plan names, or raises:

- "radix", for ``nz`` a power of two from 8 to 1024: a radix FFT in shared memory, one
  instantiation per pass plan. `radix_passes` gives its passes (radix 16, 8 or 4; 256 =
  16 x 16). Forward as decimation in frequency, which leaves ``F`` in digit-reversed order
  (`digit_reversed_bins`); the operator is looked up at the bin each position holds;
  inverse as decimation in time, which takes that order and gives natural order. It is
  bound by the bytes it moves.
- "mixed", for every other ``nz`` from 8 to `MIXED_MAX_NZ` whose prime factors are 2, 3, 5
  and 7 (192, 320, 384, 448, ...): the same FFT with the pass plan as a runtime argument,
  radices from `RADICES` (the power-of-two part in passes of up to 16, each odd factor a
  pass of its own), and the bin table (`ZFusePlan.bins`) read from device memory.
- "dense", for every other ``nz`` up to `MAX_NZ` (below 8, a prime factor of 11 or more):
  the dense DFT in fp32 FMAs, the ``nz`` roots of unity indexed by ``(k*z) mod nz``; bound
  by operations (``16*nz^2`` flop per column and op pair against 16 B moved).

`apply_radix_plain` is the radix and mixed kernels' passes on tensors; `apply_plain` is
the dense sum as a matrix product.

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
KERNEL_LAUNCHES = {"radix": 0, "mixed": 0, "dense": 0}

MAX_OPS = 3
# dense: two tiles of nz x 8 columns (re/im planes) and the roots must fit a block's 227 KB
MAX_NZ = (227 * 1024) // (8 * 4 * 4 + 8)
# radix: a power of two in this range (at 1024 two tiles of nz x 8 columns are 128 KB)
RADIX_MIN_NZ, RADIX_MAX_NZ = 8, 1024
# mixed: the butterflies of csrc/zfuse.cu, and the passes a plan may have (2 * 3^6 = 1458
# takes seven)
RADICES = (16, 8, 4, 2, 3, 5, 7)
MAX_PASSES = 7
# mixed: two tiles of nz x 8 columns of complex64 and the roots fit a block's 227 KB (the
# bin table is read from device memory, as k2z is, so that 1701 = 3^5 x 7 fits too)
MIXED_MAX_NZ = (227 * 1024) // (2 * 8 * 8 + 8)
KERNELS = ("radix", "mixed", "dense")


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, KERNEL_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _power_of_two_passes(bits: int) -> list[int]:
    """2^bits in as few passes of radix <= 16 as there can be, the widest first."""
    passes = []
    for left in range(-(-bits // 4), 0, -1):
        b = -(-bits // left)
        passes.append(1 << b)
        bits -= b
    return passes


def radix_passes(nz: int) -> tuple[int, ...] | None:
    """The radices of the FFT kernels' forward passes, first pass first, or None where
    ``nz`` goes to the dense kernel: the power-of-two part of ``nz`` in as few passes of
    radix <= 16 as there can be, the widest first, then each factor 3, 5 and 7 a pass of
    its own, for ``nz`` from 8 to `MIXED_MAX_NZ`."""
    if not RADIX_MIN_NZ <= nz <= MIXED_MAX_NZ:
        return None
    bits, rest = 0, nz
    while rest % 2 == 0:
        rest //= 2
        bits += 1
    odd = []
    for f in (3, 5, 7):
        while rest % f == 0:
            rest //= f
            odd.append(f)
    passes = tuple(_power_of_two_passes(bits) + odd)
    return passes if rest == 1 and len(passes) <= MAX_PASSES else None


def kernel_for(nz: int) -> str:
    """Which of the three kernels a spectrum of ``nz`` bins takes: "radix", "mixed" or
    "dense"."""
    if radix_passes(nz) is None:
        return "dense"
    return "radix" if not nz & (nz - 1) and nz <= RADIX_MAX_NZ else "mixed"


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
    kernel: str = "dense"  # the kernel `apply` launches: "radix", "mixed" or "dense"
    passes: tuple[int, ...] | None = None  # the FFT kernels' (`radix_passes`); None: dense
    bins: torch.Tensor | None = None  # [nz] int16: the bin each position holds (passes)


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
    passes = radix_passes(nz)
    bins = None
    if passes:
        bins = torch.from_numpy(digit_reversed_bins(passes).astype(np.int16)).to(device)
    return ZFusePlan(nz=nz, ny=ny, nxr=nx // 2 + 1, c_ref_dt_2=float(c_ref_dt_2),
                     roots=torch.from_numpy(roots).to(device),
                     k2z=vec(k2z, nz), k2y=vec(k2y, ny), k2x=vec(k2x, nx // 2 + 1),
                     kernel=kernel_for(nz), passes=passes, bins=bins)


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
    """`apply` as the radix and mixed kernels compute it, on tensors: the forward passes of
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
    bins = plan.bins.long()  # the table the kernels read
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
    if plan.kernel not in KERNELS or (plan.kernel != "dense" and (
            plan.bins is None or tuple(plan.bins.shape) != (plan.nz,)
            or int(np.prod(plan.passes or ())) != plan.nz)):
        raise ValueError(f"the plan's kernel must be one of {KERNELS}, and an FFT kernel "
                         f"needs passes whose product is nz={plan.nz} and its bin table; "
                         f"got {plan.kernel!r}, passes {plan.passes}")
    fft = (plan.bins,) if plan.kernel != "dense" else ()
    for t in (s, plan.roots, plan.k2z, *fft, *dds):
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

    On a CUDA tensor this launches the hand-written kernel the plan names
    (``plan.kernel``: "radix", "mixed" or "dense", chosen by `make_plan`), and
    `KERNEL_LAUNCHES` counts which. No kernel falls back to another or to a plain
    version."""
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
    args = (*dd_ptrs, *[None] * pad, *(o.data_ptr() for o in outs), *[None] * pad,
            plan.nz, plan.ny, plan.nxr, len(ops),
            *(0 if op.kind == "grad" else 1 for op in ops), *[0] * pad,
            *(op.axis for op in ops), *[0] * pad,
            *(float(op.power) for op in ops), *[0.0] * pad,
            plan.c_ref_dt_2, int(bool(use_kappa)))
    fields = (plan.k2z.data_ptr(), plan.k2y.data_ptr(), plan.k2x.data_ptr())
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.kernel == "radix":
            err = lib.kw_zfuse_radix(s.data_ptr(), plan.roots.data_ptr(), *fields, *args,
                                     *plan.passes, *(1,) * (3 - len(plan.passes)), stream)
        elif plan.kernel == "mixed":
            err = lib.kw_zfuse_mixed(s.data_ptr(), plan.roots.data_ptr(),
                                     plan.bins.data_ptr(), *fields, *args,
                                     len(plan.passes), *plan.passes,
                                     *(1,) * (MAX_PASSES - len(plan.passes)), stream)
        else:
            err = lib.kw_zfuse(s.data_ptr(), plan.roots.data_ptr(), *fields, *args, stream)
    if err != 0:
        raise RuntimeError(f"zfuse.apply ({plan.kernel} kernel): CUDA launch failed with "
                           f"cudaError {err}")
    LAUNCHES[f"zfuse_{len(ops)}op"] += 1
    KERNEL_LAUNCHES[plan.kernel] += 1
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
