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

Four kernels, all CUDA C++ for sm_90a in ``kwave_tpu_torch/csrc/`` (``zfuse.cu``: radix;
``zfuse_mixed.cuh``, in ``zfuse_mixed.cu`` and, for plans with a generic pass,
``zfuse_mixed_generic.cu`` / ``zfuse_mixed_generic3.cu``; ``zfuse_bluestein.cuh``, one
source a tile width; ``zfuse_column.cu``; what they share in ``zfuse.cuh``).
`make_plan` chooses one by ``nz`` (`kernel_for`) and records it in the plan with its tables
(`kernel_tables`); `apply` launches the kernel its plan names, or raises:

- "column", for the short ``nz`` of `COLUMN_NZ`, 1 to `COLUMN_MAX_NZ`: one thread a
  column, its nz values transformed in registers (at ``nz = 1``, a grid of one z plane,
  the transforms are the identity), multiplied by each op's operator at the natural bin
  and transformed back, without shared memory or a barrier.
- "radix", for ``nz`` a power of two from 32 to 1024 (built from 8; a plan may name it
  at 8 and 16): a radix FFT in shared memory, one instantiation per pass plan.
  `radix_passes` gives its passes (radix 16, 8 or 4; 256 = 16 x 16). Forward as
  decimation in frequency, which leaves ``F`` in digit-reversed order
  (`digit_reversed_bins`); the operator is looked up at the bin each position holds;
  inverse as decimation in time, which takes that order and gives natural order. It is
  bound by the bytes it moves.
- "mixed", for every other ``nz`` from 17 to `MIXED_MAX_NZ` whose prime factors are at
  most 13, or all of them but one prime from 17 to `PRIME_MAX` (192, 176 = 16 x 11, 230 =
  2 x 5 x 23, ...): the same FFT with the pass plan as a runtime argument, radices from
  `RADICES` (the power-of-two part in passes of up to 16, each odd factor a pass of its
  own), the one larger prime a generic pass of its own, first (`radix_passes`: its
  butterfly's input pairs dealt to a few lanes that hold them in registers and add their
  shares by warp shuffles, its roots in a table; its plans in sources of their own), and
  the bin table (`ZFusePlan.bins`) read from device memory.
- "bluestein", for every other ``nz`` up to `MAX_NZ` (53, 127, 251, 1009, 1709, ...):
  Bluestein's chirp-z transform, each z-DFT one circular convolution of an even length
  ``M >= 2 nz`` chosen by cost (`bluestein_length`: 512 at nz = 251, 2048 at 1009), the
  chirp and the filter's transform from float64 tables, the filter's in the order of the
  positions the forward passes leave; the chirp, the filter and the operator are applied
  inside the passes, and the passes skip the half of each transform that is known to be
  zero or is not kept (`apply_bluestein_plain`, `bluestein_tile`).

`apply_radix_plain` is the radix and mixed kernels' passes on tensors,
`apply_bluestein_plain` the Bluestein kernel's steps, `apply_plain` the dense sum as a
matrix product (the plain version of the column kernel, and every kernel's reference).

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
KERNEL_LAUNCHES = {"radix": 0, "mixed": 0, "bluestein": 0, "column": 0}

MAX_OPS = 3
# The longest z length the fused stage takes, every one up to it by one of the kernels:
# the mixed kernel's limit (`MIXED_MAX_NZ`), to which the Bluestein kernel, which takes the
# lengths the mixed one cannot factor, is held (the driver runs a longer z unfused)
MAX_NZ = 1709
# radix: a power of two in this range (at 1024 two tiles of nz x 8 columns are 128 KB)
RADIX_MIN_NZ, RADIX_MAX_NZ = 8, 1024
# mixed: the butterflies in registers of csrc/zfuse.cu, and the passes a plan may have
# (2 * 3^6 = 1458 takes seven)
RADICES = (16, 8, 4, 2, 3, 5, 7, 11, 13)
MAX_PASSES = 7
# mixed: the primes that take the generic pass (one a plan, the first pass); a z length
# with a larger prime factor, or two factors from 17 up, takes the Bluestein kernel.
# PRIME_MAX is the measured crossover (timed on an H100, PERF.md section 6, K7 mixed: z
# lengths 4p and 8p, one op and three, against the Bluestein kernel that folds its
# pointwise steps into its passes): with the generic pass of registers and a
# table of roots, the generic pass is faster in all 36 cases from 17 to 47 (0.50-0.97 of
# the Bluestein kernel's time), the Bluestein kernel in 39 of the 40 from 53 to 127 (the
# 40th, 712 = 89 x 8 with three ops, 3.5 % slower)
PRIME_MIN, PRIME_MAX = 17, 47
# mixed: two tiles of nz x 8 columns of complex64 and the roots fit a block's 227 KB (the
# bin table is read from device memory, as k2z is, so that 1701 = 3^5 x 7 fits too); a
# generic plan's table of roots (`generic_table_size`) must fit beside them
MIXED_MAX_NZ = (227 * 1024) // (2 * 8 * 8 + 8)
# the generic pass's pairs (m, p - m) a lane holds at most (csrc/zfuse_mixed.cuh)
GENERIC_PAIRS = 12
KERNELS = ("radix", "mixed", "bluestein", "column")
# column: the z lengths the kernel is built for (csrc/zfuse_column.cu), and those
# `kernel_for` sends to it: every one, since from 2 it was faster than the radix or mixed
# kernel that took each before and than the cuFFT route at every one of them, one op and
# three (timed on an H100, PERF.md section 6, K7 column; spectra [nz, 256, 129]: 0.0046 /
# 0.0058 ms at 4 against mixed 0.0187 / 0.0288; 0.0105 / 0.0148 at 16 against radix
# 0.0192 / 0.0384); at 1 its transforms are the identity
COLUMN_MAX_NZ = 16
COLUMN_NZ = frozenset(range(1, COLUMN_MAX_NZ + 1))


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


def _is_prime(n: int) -> bool:
    return n > 1 and all(n % d for d in range(2, int(n ** 0.5) + 1))


def _passes(n: int, generic: bool) -> tuple[int, ...] | None:
    """The mixed passes of a length ``n`` >= 2 (see `radix_passes`), or None."""
    bits, rest = 0, n
    while rest % 2 == 0:
        rest //= 2
        bits += 1
    odd = []
    for f in (3, 5, 7, 11, 13):
        while rest % f == 0:
            rest //= f
            odd.append(f)
    lead = ()
    if generic and PRIME_MIN <= rest <= PRIME_MAX and _is_prime(rest):
        lead, rest = (rest,), 1
    passes = lead + tuple(_power_of_two_passes(bits) + odd)
    return passes if n >= 2 and rest == 1 and len(passes) <= MAX_PASSES else None


def generic_table_size(p: int) -> int:
    """Entries (complex64) of the generic pass's table of roots for the prime ``p``: H =
    (p - 1)/2 rows of G lanes x K pairs, G the least power of two that leaves each lane at
    most `GENERIC_PAIRS` pairs (csrc/zfuse_mixed.cuh `generic_table_size`)."""
    h, lanes = (p - 1) // 2, 1
    while lanes < 32 and -(-h // lanes) > GENERIC_PAIRS:
        lanes *= 2
    return h * lanes * -(-h // lanes)


def radix_passes(nz: int) -> tuple[int, ...] | None:
    """The radices of the FFT kernels' forward passes, first pass first, or None where
    ``nz`` goes to the Bluestein (or, at 1, the column) kernel, for ``nz`` from 2 to
    `MIXED_MAX_NZ`: one prime from `PRIME_MIN` to `PRIME_MAX` as a generic pass where
    ``nz`` has one (and its two tiles of 8 columns, the roots and its table fit a block:
    not at 1692 = 47 x 36 or 1705 = 31 x 55), then the power-of-two part in as few passes
    of radix <= 16 as there can be, the widest first, then each factor 3, 5, 7, 11 and 13
    a pass of its own."""
    passes = _passes(nz, generic=True) if nz <= MIXED_MAX_NZ else None
    if passes and passes[0] >= PRIME_MIN and \
            8 * (2 * nz * 8 + nz + generic_table_size(passes[0])) > SMEM_BLOCK:
        return None
    return passes


def radix_takes(nz: int) -> bool:
    """Whether the radix kernel is built for ``nz``: a power of two from `RADIX_MIN_NZ` to
    `RADIX_MAX_NZ` (`kernel_for` sends it those above `COLUMN_MAX_NZ`; a plan may name it
    at the others)."""
    return not nz & (nz - 1) and RADIX_MIN_NZ <= nz <= RADIX_MAX_NZ


def kernel_for(nz: int) -> str:
    """Which of the four kernels a spectrum of ``nz`` bins takes: "column", "radix",
    "mixed" or "bluestein"."""
    if nz in COLUMN_NZ:
        return "column"
    if radix_takes(nz):
        return "radix"
    return "mixed" if radix_passes(nz) else "bluestein"


# The Bluestein kernel's shared memory (csrc/zfuse_bluestein.cuh): a block may take 227 KB
# of an SM's 228 KB, each block 1 KB of it reserved; at most BLUESTEIN_BLOCKS blocks an SM
# (its registers are capped for three); the tile widths it is built for, widest first.
SMEM_BLOCK, SMEM_SM, SMEM_RESERVED = 227 * 1024, 228 * 1024, 1024
BLUESTEIN_BLOCKS = 3
BLUESTEIN_TC = (32, 16, 8, 4, 2)
BLUESTEIN_MIN_M = 32  # two passes at least: the kernel fuses the first and the last
# the tables a block may stage beside its tiles, in the order it stages them (the filter
# is read at every element of every convolution, the chirp at two a column, k2z at one
# an op), with their bytes per entry and their length (M or nz)
_STAGED = (("filt", 8, "m"), ("chirp", 8, "nz"), ("k2z", 4, "nz"))
# The kernel's time, fitted to timings on an H100 (PERF.md section 6, K7 Bluestein; 80 at
# nz = 127 to 1709 over M and the tile width; 11 % rms): per column,
# M x its weighted sweeps (`_bluestein_sweeps`) x (1 + _SWEEP_OVERHEAD / (M x TC)) (a
# barrier's cost in tile elements) x _BLOCKS_COST[blocks an SM]. A pass's weight is its
# radix's cost an element against a pass of radix 8.
_RADIX_COST = {2: 0.5, 3: 1.02, 4: 0.76, 5: 1.32, 7: 1.4, 8: 1.0, 11: 1.93, 13: 1.5,
               16: 1.48}
_SWEEP_OVERHEAD = 1679.0
_BLOCKS_COST = {1: 1.55, 2: 1.12, 3: 1.0}
# the calls of a fused step: five of one op for every call of three
_STEP_CALLS = ((1, 5), (3, 1))


@dataclasses.dataclass(frozen=True)
class BluesteinTile:
    """How the Bluestein kernel lays out one call (`bluestein_tile`): ``tc`` columns a
    tile, ``blocks`` blocks an SM, ``staged`` the tables it copies into shared memory (the
    rest it reads through the cache), ``smem`` its bytes of shared memory."""

    tc: int
    blocks: int
    staged: tuple[str, ...]
    smem: int


def _tile_factor(m: int, tc: int, blocks: int) -> float:
    """The fitted time of a column at tile width ``tc`` and ``blocks`` blocks an SM,
    against a tile without barrier cost."""
    return (1.0 + _SWEEP_OVERHEAD / (m * tc)) * _BLOCKS_COST[blocks]


def bluestein_tile(nz: int, m: int, n_ops: int, tc: int = 0) -> BluesteinTile | None:
    """The layout of a Bluestein call: the tile width (``tc``, or for 0 the one of least
    `_tile_factor`, then of more blocks), the blocks an SM its shared memory leaves (at
    most `BLUESTEIN_BLOCKS`), then every table of `_STAGED`, in turn, that fits without a
    block less. Shared memory: the M tile of ``tc`` columns, an nz tile of the forward
    convolution where there are several ops (one op works in place), the M roots, and the
    staged tables. None where not even a tile of the narrowest width fits."""
    best = None
    for width in (tc,) if tc else BLUESTEIN_TC:
        smem = 8 * (m * width + (nz * width if n_ops > 1 else 0) + m)
        blocks = min(BLUESTEIN_BLOCKS, SMEM_SM // (smem + SMEM_RESERVED))
        if smem > SMEM_BLOCK or blocks < 1:
            continue
        staged = []
        for name, size, length in _STAGED:
            more = size * (m if length == "m" else nz)
            if blocks * (smem + more + SMEM_RESERVED) <= SMEM_SM and smem + more <= SMEM_BLOCK:
                staged.append(name)
                smem += more
        tile = BluesteinTile(width, blocks, tuple(staged), smem)
        key = (_tile_factor(m, width, blocks), -blocks)
        if best is None or key < best[0]:
            best = (key, tile)
    return best[1] if best else None


def _bluestein_sweeps(passes: tuple[int, ...], n_ops: int) -> float:
    """The sweeps of the M tile a column of one call makes, each weighted by its pass's
    `_RADIX_COST`: with one op the first pass's radix three times (the first forward pass,
    the bridge into the op's convolution, the last inverse pass), each middle one four,
    the last two (the turn of each convolution); with several, (first twice, middles twice,
    last once) for the forward convolution and for each op's."""
    w = [_RADIX_COST[r] for r in passes]
    if n_ops == 1:
        return 3 * w[0] + 4 * sum(w[1:-1]) + 2 * w[-1]
    return (2 * w[0] + 2 * sum(w[1:-1]) + w[-1]) * (1 + n_ops)


def _bluestein_cost(nz: int, m: int, passes: tuple[int, ...]) -> float:
    """The rule's cost of a convolution length: the fitted time of a fused step's calls
    (`_STEP_CALLS`), each at its own tile (`bluestein_tile`), in units of one element of a
    radix-8 sweep; inf where a call's tile does not fit."""
    cost = 0.0
    for n_ops, calls in _STEP_CALLS:
        tile = bluestein_tile(nz, m, n_ops)
        if tile is None:
            return float("inf")
        cost += calls * m * _bluestein_sweeps(passes, n_ops) * _tile_factor(m, tile.tc,
                                                                           tile.blocks)
    return cost


def bluestein_length(nz: int) -> int:
    """M: among the even lengths from ``max(2 nz, BLUESTEIN_MIN_M)`` to the next power of
    two whose FFT the mixed passes take without a generic pass (radices from `RADICES`, at
    most `MAX_PASSES`, two at least), the one of least `_bluestein_cost` (the shortest of
    equal cost): 512 = 8 x 8 x 8 at nz = 251, not 504 = 8 x 3 x 3 x 7; 2048 = 16 x 16 x 8
    at 1009; 3584 = 8 x 8 x 8 x 7 at 1709, not 4096 = 16 x 16 x 16."""
    lo = max(2 * nz, BLUESTEIN_MIN_M)
    best, best_cost = None, float("inf")
    for m in range(lo, 1 << (lo - 1).bit_length() + 1, 2):
        passes = _passes(m, generic=False)
        cost = _bluestein_cost(nz, m, passes) if passes and len(passes) >= 2 else float("inf")
        if cost < best_cost:
            best, best_cost = m, cost
    return best


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
    kernel: str  # the kernel `apply` launches: one of KERNELS
    # the FFT's passes (of nz for the radix and mixed kernels, of m for the Bluestein
    # kernel; None for the column kernel) and, for the radix and mixed kernels, the bin each
    # position holds after them (int16)
    passes: tuple[int, ...] | None = None
    bins: torch.Tensor | None = None
    # the Bluestein kernel's: its convolution length M, the chirp w_n = exp(-i*pi*(n^2 mod
    # 2 nz)/nz) [nz], the transform of the filter c (c_j = c_{M-j} = w_j, j < nz; 0 else)
    # over M, FFT_M(c)/M [M] in the order of the positions after the forward passes
    # (filt[p] = FFT_M(c)[digit_reversed_bins(passes)[p]]/M), and the M roots
    # exp(-2*pi*i*j/M), all complex64
    m: int | None = None
    chirp: torch.Tensor | None = None
    filt: torch.Tensor | None = None
    m_roots: torch.Tensor | None = None


def _roots(n: int) -> np.ndarray:
    return np.exp(-2j * np.pi * np.arange(n) / n).astype(np.complex64)


def kernel_tables(nz: int, kernel: str, device: torch.device | str = "cpu") -> dict:
    """The `ZFusePlan` fields of ``kernel`` at ``nz`` (`make_plan` takes `kernel_for`'s;
    a test may name another, to hold a kernel at a length that `kernel_for` sends
    elsewhere): a ValueError where the kernel does not take ``nz``."""
    fields = dict(kernel=kernel, passes=None, bins=None, m=None, chirp=None, filt=None,
                  m_roots=None)
    if kernel == "column":
        if not 1 <= nz <= COLUMN_MAX_NZ:
            raise ValueError(f"the column kernel does not take nz={nz}")
        return fields
    if kernel in ("radix", "mixed"):
        passes = radix_passes(nz)
        if passes is None or (kernel == "radix" and not radix_takes(nz)):
            raise ValueError(f"the {kernel} kernel does not take nz={nz}")
        bins = digit_reversed_bins(passes)
    elif kernel == "bluestein":
        if not 2 <= nz <= MAX_NZ:
            raise ValueError(f"the bluestein kernel does not take nz={nz}")
        return bluestein_tables(nz, bluestein_length(nz), device)
    else:
        raise ValueError(f"the kernel must be one of {KERNELS}; got {kernel!r}")
    fields.update(passes=passes, bins=torch.from_numpy(bins.astype(np.int16)).to(device))
    return fields


def bluestein_tables(nz: int, m: int, device: torch.device | str = "cpu") -> dict:
    """The Bluestein kernel's `ZFusePlan` fields at ``nz`` with the convolution length
    ``m`` (`kernel_tables` takes `bluestein_length`; a test may take another M): an even
    M >= 2 nz (the upper half of the first pass's inputs is then zero, and of the last
    pass's outputs unused) of two passes or more."""
    passes = _passes(m, generic=False)
    if m < 2 * nz or m % 2 or passes is None or len(passes) < 2:
        raise ValueError(f"M={m} is no convolution length of nz={nz}")
    n = np.arange(nz, dtype=np.int64)
    chirp = np.exp(-1j * np.pi * ((n * n) % (2 * nz)) / nz)  # float64, n^2 mod 2nz exact
    c = np.zeros(m, np.complex128)
    c[:nz] = chirp
    c[m - nz + 1:] = chirp[1:][::-1]
    filt = (np.fft.fft(c)[digit_reversed_bins(passes)] / m).astype(np.complex64)
    return dict(kernel="bluestein", passes=passes, bins=None,
                m=m, chirp=torch.from_numpy(chirp.astype(np.complex64)).to(device),
                filt=torch.from_numpy(filt).to(device),
                m_roots=torch.from_numpy(_roots(m)).to(device))


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
    return ZFusePlan(nz=nz, ny=ny, nxr=nx // 2 + 1, c_ref_dt_2=float(c_ref_dt_2),
                     roots=torch.from_numpy(_roots(nz)).to(device),
                     k2z=vec(k2z, nz), k2y=vec(k2y, ny), k2x=vec(k2x, nx // 2 + 1),
                     **kernel_tables(nz, kernel_for(nz), device))


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
    return [torch.einsum("zk,kyx->zyx", inv, f * full)
            for full in _op_list(plan, ops, dds, use_kappa)]


def _small_dft(r: int, inverse: bool, device) -> torch.Tensor:
    j = np.arange(r)
    w = np.exp((2j if inverse else -2j) * np.pi * ((j[:, None] * j[None, :]) % r) / r)
    return torch.from_numpy(w.astype(np.complex64)).to(device)


def _forward_passes(f: torch.Tensor, passes: tuple[int, ...], roots: torch.Tensor):
    """The FFT kernels' forward passes over the first axis of ``f`` (n = prod(passes)
    long; ``roots`` its n roots): a pass of radix R over sub-transforms of length L takes
    positions ``blk*L + j + m*(L/R)`` and leaves output q, times ``w_L^(q*j)``, at
    ``blk*L + j + q*(L/R)``, so the result is in digit-reversed order."""
    n, tail = f.shape[0], tuple(f.shape[1:])
    j, length = torch.arange(n, device=f.device), n
    for r in passes:
        v = f.reshape(n // length, r, length // r, *tail)  # [blk, m, j, ...]
        v = torch.einsum("qm,bmj...->bqj...", _small_dft(r, False, f.device), v)
        w = roots[(j[:r, None] * j[None, :length // r]) * (n // length)]  # w_L^(q*j)
        f = (v * w.reshape(1, r, length // r, *[1] * len(tail))).reshape(n, *tail)
        length //= r
    return f


def _inverse_passes(g: torch.Tensor, passes: tuple[int, ...], roots: torch.Tensor):
    """`_forward_passes` undone without the 1/n: the same passes in reverse order with the
    conjugate roots, digit-reversed order in and natural order out."""
    n, tail = g.shape[0], tuple(g.shape[1:])
    j, length = torch.arange(n, device=g.device), 1
    for r in reversed(passes):
        length *= r
        v = g.reshape(n // length, r, length // r, *tail)  # [blk, q, j, ...]
        w = roots[(j[:r, None] * j[None, :length // r]) * (n // length)].conj()
        v = v * w.reshape(1, r, length // r, *[1] * len(tail))
        g = torch.einsum("mq,bqj...->bmj...", _small_dft(r, True, g.device), v)
        g = g.reshape(n, *tail)
    return g


def _op_list(plan: ZFusePlan, ops, dds, use_kappa):
    """The full operator of each op (`full_operator`), its dd vector taken in turn."""
    fulls, dd_i = [], 0
    for op in ops:
        dd = None
        if op.kind == "grad":
            dd = dds[dd_i]
            dd_i += 1
        fulls.append(full_operator(plan, op, dd, use_kappa))
    return fulls


def apply_radix_plain(plan: ZFusePlan, s: torch.Tensor, ops: tuple[OpSpec, ...],
                      dds: tuple = (), use_kappa: bool = True) -> list[torch.Tensor]:
    """`apply` as the radix and mixed kernels compute it, on tensors: the forward passes of
    ``plan.passes`` (`_forward_passes`; a generic pass of a prime is the same pass with its
    radix a prime), the operator and the 1/nz at the bin each position then holds, and the
    same passes undone (`_inverse_passes`)."""
    if plan.kernel not in ("radix", "mixed") or plan.passes is None:
        raise ValueError(f"nz={plan.nz} has no radix passes; it takes the {plan.kernel} "
                         f"kernel")
    nz = plan.nz
    f = _forward_passes(s, plan.passes, plan.roots)
    bins = plan.bins.long()  # the table the kernels read
    outs = []
    for full in _op_list(plan, ops, dds, use_kappa):
        if full.shape[0] == nz:  # the operator varies along z: take it at each position's bin
            full = full[bins]
        outs.append(_inverse_passes(f * (full / nz), plan.passes, plan.roots)
                    .to(torch.complex64))
    return outs


def apply_bluestein_plain(plan: ZFusePlan, s: torch.Tensor, ops: tuple[OpSpec, ...],
                          dds: tuple = (), use_kappa: bool = True) -> list[torch.Tensor]:
    """`apply` as the Bluestein kernel computes it, on tensors. With the chirp ``w``, the
    DFT is ``F_k = w_k conv_k``, ``conv_k = sum_n (s_n w_n) conj(w_(k-n))``, and each op's
    output ``out_n = conj(w_n) sum_k (G_k conj(w_k)) w_(n-k)`` with ``G = F op / nz``, so
    that its input ``G_k conj(w_k) = conv_k op_k / nz``: F is never formed. Each sum is a
    circular convolution of length M: the input (nz long) zero-padded to M, the mixed
    forward passes of M (digit-reversed), times the filter's transform at each position
    (``conj(filt)`` forward, ``filt`` inverse: the filter ``c`` is even, so the transform
    of ``conj(c)`` is ``conj(FFT_M(c))``), the inverse passes, the first nz kept. The 1/M
    is in the table (``filt = FFT_M(c)/M``, in position order), the 1/nz with the
    operator, at the natural bin k, as in the kernel."""
    if plan.kernel != "bluestein" or plan.m is None:
        raise ValueError(f"the plan of nz={plan.nz} names the {plan.kernel} kernel, not "
                         f"the bluestein kernel and its tables")
    nz, m, tail = plan.nz, plan.m, tuple(s.shape[1:])
    filt = plan.filt.reshape(m, *[1] * len(tail))
    chirp = plan.chirp.reshape(nz, *[1] * len(tail))

    def convolve(a, f):  # the first nz of the circular convolution of a (nz long) with f
        padded = torch.zeros((m, *a.shape[1:]), dtype=torch.complex64, device=a.device)
        padded[:nz] = a
        return _inverse_passes(_forward_passes(padded, plan.passes, plan.m_roots) * f,
                               plan.passes, plan.m_roots)[:nz]

    conv = convolve(s * chirp, filt.conj())
    return [(convolve(conv * (full / nz), filt) * chirp.conj()).to(torch.complex64)
            for full in _op_list(plan, ops, dds, use_kappa)]


def _checked_tables(plan: ZFusePlan) -> tuple:
    """The tables the plan's kernel reads; a ValueError where the plan does not carry them
    (a plan may name another kernel than `make_plan` chose, but then with its tables)."""
    nz, passes, kernel = plan.nz, plan.passes or (), plan.kernel
    n = plan.m if kernel == "bluestein" else nz
    # the mixed kernel takes one generic pass of an odd prime, first
    generic = kernel == "mixed" and passes and passes[0] >= PRIME_MIN and _is_prime(passes[0])
    ok = kernel in KERNELS
    if kernel == "column":
        ok = 1 <= nz <= COLUMN_MAX_NZ
    elif ok:
        ok = (n is not None and int(np.prod(passes)) == n and len(passes) <= MAX_PASSES
              and set(passes[1 if generic else 0:]) <= set(RADICES))
    if ok and kernel in ("radix", "mixed"):
        ok = plan.bins is not None and tuple(plan.bins.shape) == (n,)
    if ok and kernel == "bluestein":
        ok = n >= 2 * nz and n % 2 == 0 and len(passes) >= 2 and all(
            t is not None and tuple(t.shape) == (k,)
            for t, k in ((plan.chirp, nz), (plan.filt, n), (plan.m_roots, n)))
    if not ok:
        raise ValueError(f"the plan's kernel must be one of {KERNELS}, an FFT kernel needs "
                         f"passes of its radices whose product is its length (nz={nz}; M "
                         f"for the bluestein kernel), the radix and mixed kernels their bin "
                         f"table, the bluestein kernel an even M >= 2 nz of two passes "
                         f"or more, the chirp, the filter and the M roots, and the column "
                         f"kernel nz from 1 to {COLUMN_MAX_NZ}; got "
                         f"{kernel!r}, passes {plan.passes}, M {plan.m}")
    if kernel == "column":
        return ()
    if kernel == "bluestein":
        return plan.chirp, plan.filt, plan.m_roots
    return (plan.bins,)


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
    tables = _checked_tables(plan)
    for t in (s, plan.roots, plan.k2z, *tables, *dds):
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
    (``plan.kernel``: one of `KERNELS`, chosen by `make_plan`), and `KERNEL_LAUNCHES`
    counts which. No kernel falls back to another or to a plain version."""
    ops, dds = tuple(ops), tuple(dds)
    _check(plan, s, ops, dds)
    if s.device.type == "cpu":
        return apply_plain(plan, s, ops, dds, use_kappa)
    from kwave_tpu_torch.ops import _build

    outs = _launch(_build.load_library(), plan, s, ops, dds, use_kappa)
    LAUNCHES[f"zfuse_{len(ops)}op"] += 1
    KERNEL_LAUNCHES[plan.kernel] += 1
    return outs


def _launch(lib, plan: ZFusePlan, s: torch.Tensor, ops: tuple[OpSpec, ...], dds: tuple,
            use_kappa: bool, tc: int = 0) -> list[torch.Tensor]:
    """`apply`'s launch of the kernel the plan names from the library ``lib`` (a test
    passes one of the mixed kernel's two generic builds as ``kw_zfuse_mixed``), on CUDA
    tensors that `apply` checked; counts nothing. ``tc``: the tile width of the Bluestein
    kernel (0: `bluestein_tile`'s) or of the mixed kernel (32, 16 or 8; 0: its own rule);
    a test may name another."""
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
    passes = (*(plan.passes or ()), *(1,) * (MAX_PASSES - len(plan.passes or ())))
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.kernel == "radix":
            err = lib.kw_zfuse_radix(s.data_ptr(), plan.roots.data_ptr(), *fields, *args,
                                     *plan.passes, *(1,) * (3 - len(plan.passes)), stream)
        elif plan.kernel == "mixed":
            err = lib.kw_zfuse_mixed(s.data_ptr(), plan.roots.data_ptr(),
                                     plan.bins.data_ptr(), *fields, *args,
                                     len(plan.passes), *passes, tc, stream)
        elif plan.kernel == "bluestein":
            tile = bluestein_tile(plan.nz, plan.m, len(ops), tc)
            if tile is None:
                raise ValueError(f"no tile of {tc or 'any'} columns fits M={plan.m}")
            staged = sum(1 << i for i, (name, _, _) in enumerate(_STAGED)
                         if name in tile.staged)
            err = lib.kw_zfuse_bluestein(s.data_ptr(), plan.m_roots.data_ptr(),
                                         plan.chirp.data_ptr(), plan.filt.data_ptr(),
                                         *fields, *args, plan.m, len(plan.passes), *passes,
                                         tile.tc, staged, stream)
        else:
            err = lib.kw_zfuse_column(s.data_ptr(), plan.roots.data_ptr(), *fields, *args,
                                      stream)
    if err != 0:
        raise RuntimeError(f"zfuse.apply ({plan.kernel} kernel): CUDA launch failed with "
                           f"cudaError {err}")
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
