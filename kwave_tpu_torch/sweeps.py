"""Sweeps of the redesigned kernels' free parameters, and of the designs they were chosen
from, on the card.

    python -m kwave_tpu_torch.sweeps [--iters 20] [--only k1 k6 ...]

Prints the card's name and power limit, then one JSON line per measurement (device time
per launch from CUDA events, the stream held by a sleep kernel while the host enqueues):

- ``floor``: an empty kernel at the 40-bit window kernel's grid, block and shared memory
  (o = 16, H = 1, N = 16384), per block size: what a window costs before it does anything.
- ``k1``: the 40-bit window kernel (`ops.encode_window`) at that shape, with and without
  overlap: the baseline that packs and unpacks its words at every step (``packed``), the
  step that stays out of the words with one thread a sensor (``split`` 1) and with one
  lane a buffer (``split`` 2), each at block sizes 32 .. 256, with whether the planes have
  the bits of the default. ``k2``: the float window kernel over the block sizes.
- ``k6``: the one-window projection (`ops.fastpath.launch_window_projection`) at the
  codec's window [20, 16384], H = 2, over block sizes and coefficient rows per thread (1:
  the rows spread over the grid, each sample loaded by 2H threads; 4: all rows in one
  thread), and beside it the table's ``torch.cat`` that the wrapper ran per call before
  the kernels took the two half tables.
- ``k3``: the whole-record exact encode (`ops.encode_series`), four variants, at windows
  per thread G = 1 .. K, on the codec's record (T = 4096, N = 16384, H = 2, o = 20) and on
  two small ones (13 windows of 16384 sensors; 204 windows of 1024 sensors), with whether
  frames and state have the bits of the default G. It says what the constant
  `ops.encode_series.CHUNK_WINDOWS` costs where the record is small.
- ``k7``: the fused z stage (`ops.zfuse.apply`) at the spectrum [256, 256, 129]: one and
  three gradient ops with and without kappa, one nabla op, and beside them a device copy of
  the spectrum (the same bytes as one op: read once, written once).
- ``k7prime``: where the generic pass of a prime stops paying against Bluestein's transform
  (the source of `ops.zfuse.PRIME_MAX`): at z lengths 4p and 8p for primes p from 17 to
  127, spectra [nz, 128, 129], one op and three, the mixed kernel with a generic pass of p
  first (a plan built here past PRIME_MAX) beside the Bluestein kernel, with the two
  outputs' largest difference over the peak.
- ``k7generic``: the mixed kernel's plans with a generic pass (`csrc/zfuse_mixed.cuh`) in
  the two builds of the one library, registers capped for 2 blocks an SM
  (``kw_zfuse_mixed_generic``) and for 3 (``kw_zfuse_mixed_generic3``), beside the build
  ``kw_zfuse_mixed`` picks (``routed``), timed in turns, three times, at the spectra [230,
  230, 116] and [k p, 128, 129] for every prime p from 17 to PRIME_MAX and k of
  `K7_GENERIC_KS` (one, two and three radix passes after the generic pass), one op and
  three (the fused step's gradients, with kappa), with each output's largest difference
  from the 2-block build's over its peak.
- ``k7small``: the column kernel at z lengths 2 to 16 (spectra [nz, 256, 129], one op and
  three, the fused step's gradients with kappa) beside the shared-memory FFT kernel that
  took each length before it (radix at 8 and 16, mixed at the others, through a plan that
  names it) and the cuFFT route ``ifft(fft(s, 0) * op, 0)``, the three timed in turns,
  three times (the source of `ops.zfuse.COLUMN_NZ`), with the kernels' largest difference
  over the peak.
- ``k7design``: the mixed kernel's two design switches (`csrc/zfuse.cuh`), each variant a
  library built with its ``-D`` flags, timed in turns in this process at the spectra
  [nz, n, n/2 + 1] (n = nz up to 512, else 128) of z lengths whose first inverse pass is
  of radix 3, 5, 7, 11, 13 or 16, one op and three (the fused step's pressure and
  velocity gradients, with kappa): the operator built in the first inverse pass up to
  radix 7 and in a step of its own above (the default) against always in the step and
  always in the pass; radices 11 and 13 as butterflies in registers (the default) against
  the generic pass (a z length with two such factors then takes the Bluestein kernel, at
  the shortest M without them); and both switched, the design before radices 11 and 13.
  Each output's largest difference from the default's over its peak.
- ``k7bluestein``: the Bluestein kernel's convolution length M and tile width (the source
  of `ops.zfuse.bluestein_length`'s cost and `ops.zfuse.bluestein_tile`'s rule): at nz =
  127, 251, 509, 1009 and 1709, spectra [nz, 256, 129], one op and three (the fused step's
  gradients, with kappa), the candidate lengths (every even M from 2 nz to the next power
  of two whose passes the kernel takes) of least cost by the rule, the shortest one, and
  at the rule's M every tile width that fits; each beside the cuFFT route
  ``ifft(fft(s, 0) * op, 0)`` and with its output's largest difference from the rule's
  over its peak. Then, at the rule's M and tile, the kernel's registers capped for three
  blocks an SM (the default) and for two (``-D KW_BLUE_BLOCKS=2``), two builds timed in
  turns.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys

import numpy as np
import torch

K3_RECORDS = ((4096, 16384), (260, 16384), (4080, 1024))  # (T, N) at o = 20, H = 2
K3_CHUNKS = (1, 2, 3, 4, 6, 8, 16, 32, 204)
K7_GRID = 256
WINDOW_SHAPE = (16, 1, 16384)  # o, H, N of the main path's window
WINDOW_BLOCKS = (32, 64, 128, 256)
K6_ROWS = (1, 2, 4, 8)


def time_ms(fn, iters: int) -> float:
    """Device ms per call (the one-window sweeps pass ten times ``--iters``: their launches
    take microseconds)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)  # ~20 ms: every launch is enqueued before the first runs
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _same_bits(a, b) -> bool:
    return all(torch.equal(p.view(torch.int32), q.view(torch.int32))
               for p, q in zip(a[0] + a[1], b[0] + b[1]))


def _same_planes(a, b) -> bool:
    return all(torch.equal(p.view(torch.int32), q.view(torch.int32)) for p, q in zip(a, b))


def sweep_windows(iters: int) -> None:
    """``floor``, ``k1`` and ``k2`` at the main path's window."""
    from kwave_tpu_torch import bitpack, encoder
    from kwave_tpu_torch.basis import MAX_EXP_P, generate_basis
    from kwave_tpu_torch.ops import encode_window as ew

    o, h, n = WINDOW_SHAPE
    basis = generate_basis(float(o), 1, h, normalize=True)
    tabs = encoder.stacked_tables(encoder.make_tables(basis, False, "cuda"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    chunk = 1e5 * torch.randn((o, n), device="cuda", generator=gen)
    vals = [1e5 * torch.randn((h, n), device="cuda", generator=gen) for _ in range(4)]
    words = tuple(p.contiguous() for p in bitpack.encode40(vals[0], vals[1], MAX_EXP_P)
                  + bitpack.encode40(vals[2], vals[3], MAX_EXP_P))
    for threads in WINDOW_BLOCKS:
        for split in (1, 2):
            ms = time_ms(lambda: ew.launch_floor(o, h, n, threads, split), 10 * iters)
            print(json.dumps(dict(sweep="floor", threads=threads, split=split, ms=ms)),
                  flush=True)
    for overlap in (True, False):
        planes = words if overlap else words[:3]
        default = ew._kernel_40b(chunk, tabs, planes, MAX_EXP_P, 0, 1, overlap)
        variants = [(True, 1)] + [(False, s) for s in ((1, 2) if overlap else (1,))]
        for packed, split in variants:
            for threads in WINDOW_BLOCKS:
                def run(threads=threads, split=split, packed=packed):
                    return ew._kernel_40b(chunk, tabs, planes, MAX_EXP_P, 0, 1, overlap,
                                          threads=threads, split=split, packed=packed)
                print(json.dumps(dict(
                    sweep="k1", overlap=overlap, packed=packed, split=split, threads=threads,
                    default=(not packed and threads == ew.WINDOW_THREADS
                             and split == (ew.W40_SPLIT if overlap else 1)),
                    ms=time_ms(run, 10 * iters), same_bits=_same_planes(run(), default))),
                    flush=True)
        accs = tuple(vals[:4 if overlap else 2])
        for threads in WINDOW_BLOCKS:
            print(json.dumps(dict(
                sweep="k2", overlap=overlap, threads=threads,
                default=threads == ew.WINDOW_THREADS,
                ms=time_ms(lambda: ew._kernel_float(chunk, tabs, accs, 0, 1, overlap,
                                                    threads=threads), 10 * iters))),
                flush=True)


def sweep_k6(iters: int) -> None:
    from kwave_tpu_torch import bench, encoder
    from kwave_tpu_torch.basis import generate_basis
    from kwave_tpu_torch.ops import fastpath as fp

    basis = generate_basis(20.0, 1, 2, normalize=True)
    o, n = basis.o_size, 16384
    t = encoder.make_tables(basis, False, "cuda")
    tab = torch.cat([t["be_re"], t["be_im"]], dim=1)
    lo, hi = tab[:o].contiguous(), tab[o:].contiguous()
    chunk = bench.make_series(o, n, 20.0, seed=0, device="cuda")
    p1 = torch.zeros((2 * basis.harmonics, n), device="cuda")
    default = fp.launch_window_projection(chunk, lo, hi, p1, False)
    for rows in K6_ROWS:
        for threads in WINDOW_BLOCKS:
            def run(threads=threads, rows=rows):
                return fp.launch_window_projection(chunk, lo, hi, p1, False, threads=threads,
                                                   rows=rows)
            print(json.dumps(dict(
                sweep="k6", rows=rows, threads=threads,
                default=(threads == fp.WINDOW_THREADS
                         and rows == fp.window_rows_for(2 * basis.harmonics)),
                ms=time_ms(run, 10 * iters), same_bits=_same_planes(run(), default))),
                flush=True)
    print(json.dumps(dict(
        sweep="k6", case="torch.cat of the two half tables (no part of a call any more)",
        ms=time_ms(lambda: torch.cat([lo, hi], dim=1).contiguous(), 10 * iters))), flush=True)


def sweep_k3(iters: int) -> None:
    from kwave_tpu_torch import bench, encoder
    from kwave_tpu_torch.basis import MAX_EXP_P, generate_basis
    from kwave_tpu_torch.ops import encode_series as es

    basis = generate_basis(20.0, 1, 2, normalize=True)
    o = basis.o_size
    tabs = encoder.stacked_tables(encoder.make_tables(basis, False, "cuda"))
    for steps, n in K3_RECORDS:
        x = bench.make_series(steps, n, 20.0, seed=3, device="cuda")
        k_total = steps // o
        for mode40 in (True, False):
            for overlap in (True, False):
                if mode40:
                    def run(g, x=x, overlap=overlap):
                        return es._kernel_40b(x, tabs, MAX_EXP_P, o, overlap, chunk_windows=g)
                else:
                    def run(g, x=x, overlap=overlap):
                        return es._kernel_float(x, tabs, o, overlap, chunk_windows=g)
                default = run(None)
                for g in sorted({min(g, k_total) for g in K3_CHUNKS}):
                    print(json.dumps(dict(
                        sweep="k3", mode40=mode40, overlap=overlap, steps=steps, sensors=n,
                        windows=k_total, chunk_windows=g,
                        default=g == es.chunk_windows_for(k_total),
                        ms=time_ms(lambda: run(g), iters),
                        same_bits=_same_bits(run(g), default))), flush=True)
        del x


def sweep_k7(iters: int) -> None:
    from kwave_tpu_torch.ops import zfuse

    n = K7_GRID
    k2 = (2 * np.pi * np.fft.fftfreq(n, 1e-4)) ** 2
    plan = zfuse.make_plan((n, n, n), k2, k2, k2[:n // 2 + 1], 1500.0 * 2e-8 / 2, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)

    def cplx(*shape):
        return torch.view_as_complex(torch.randn(*shape, 2, device="cuda", generator=gen))

    s = cplx(plan.nz, plan.ny, plan.nxr)
    dds = {0: cplx(plan.nz), 1: cplx(plan.ny), 2: cplx(plan.nxr)}
    grad = {a: zfuse.OpSpec("grad", axis=a) for a in dds}
    cases = [("1 grad (z)", (grad[0],), (dds[0],)),
             ("3 grad (x, y, z)", (grad[2], grad[1], grad[0]), (dds[2], dds[1], dds[0]))]
    for what, specs, vecs in cases:
        for use_kappa in (True, False):
            ms = time_ms(lambda: zfuse.apply(plan, s, specs, vecs, use_kappa=use_kappa), iters)
            print(json.dumps(dict(sweep="k7", case=what, use_kappa=use_kappa, ms=ms)),
                  flush=True)
    nabla = (zfuse.OpSpec("nabla", power=-0.5),)
    print(json.dumps(dict(sweep="k7", case="1 nabla", use_kappa=False,
                          ms=time_ms(lambda: zfuse.apply(plan, s, nabla, (), False), iters))),
          flush=True)
    out = torch.empty_like(s)
    print(json.dumps(dict(sweep="k7", case="device copy of the spectrum", use_kappa=None,
                          ms=time_ms(lambda: out.copy_(s), iters))), flush=True)


K7_PRIMES = (17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71, 79, 89, 97, 101, 127)


def sweep_k7prime(iters: int) -> None:
    import dataclasses

    from kwave_tpu_torch.ops import zfuse

    ny, nx = 128, 256
    gen = torch.Generator(device="cuda").manual_seed(7)

    def cplx(*shape):
        return torch.view_as_complex(torch.randn(*shape, 2, device="cuda", generator=gen))

    for p in K7_PRIMES:
        for k in (4, 8):
            nz = k * p
            k2 = [(2 * np.pi * np.fft.fftfreq(n, 1e-4)) ** 2 for n in (nz, ny)]
            k2.append((2 * np.pi * np.fft.rfftfreq(nx, 1e-4)) ** 2)
            base = zfuse.make_plan((nz, ny, nx), *k2, 1500.0 * 2e-8 / 2, "cuda")
            passes = (p, *zfuse.radix_passes(k))  # past PRIME_MAX too
            bins = torch.from_numpy(zfuse.digit_reversed_bins(passes).astype(np.int16)).cuda()
            plans = {"generic": dataclasses.replace(base, kernel="mixed", passes=passes,
                                                    bins=bins),
                     "bluestein": dataclasses.replace(
                         base, **zfuse.kernel_tables(nz, "bluestein", "cuda"))}
            s = cplx(nz, ny, nx // 2 + 1)
            dds = (cplx(nx // 2 + 1), cplx(ny), cplx(nz))
            for n_ops in (1, 3):
                specs = tuple(zfuse.OpSpec("grad", axis=a) for a in (2, 1, 0))[-n_ops:]
                vecs = dds[-n_ops:]
                outs = {k_: zfuse.apply(pl, s, specs, vecs) for k_, pl in plans.items()}
                peak = max(float(o.abs().max()) for o in outs["bluestein"])
                diff = max(float((a - b).abs().max())
                           for a, b in zip(outs["generic"], outs["bluestein"]))
                row = dict(sweep="k7prime", p=p, nz=nz, m=plans["bluestein"].m,
                           passes=list(passes), n_ops=n_ops, diff=diff / peak,
                           routed=base.kernel)
                for kernel, plan in plans.items():
                    row[f"{kernel}_ms"] = time_ms(
                        lambda: zfuse.apply(plan, s, specs, vecs), iters)
                print(json.dumps(row), flush=True)
            del s


# the mixed kernel's design switches (csrc/zfuse.cuh) of each variant of ``k7design``
K7_DESIGNS = {
    "default": (),
    "op_always_step": ("KW_OP_IN_PASS_MAX=0",),
    "op_always_in_pass": ("KW_OP_IN_PASS_MAX=16",),
    "generic_11_13": ("KW_RADIX_11_13=0",),
    "before_11_13": ("KW_OP_IN_PASS_MAX=16", "KW_RADIX_11_13=0"),
}
K7_DESIGN_NZ = (192, 320, 384, 448, 256, 176, 208, 220, 352, 1331)


def _design_plan(base, radix_11_13: bool):
    """``base``'s z length through the mixed kernel (its passes as `ops.zfuse.radix_passes`
    gives them; 256 too), or without butterflies of 11 and 13: one such prime as the
    generic pass, first, and two or more through the Bluestein kernel at the shortest even
    M >= 2 nz whose passes have neither."""
    import dataclasses

    from kwave_tpu_torch.ops import zfuse

    nz, dev = base.nz, base.roots.device
    if radix_11_13:
        return dataclasses.replace(base, **zfuse.kernel_tables(nz, "mixed", dev))
    rest, primes = nz, []
    for p in (11, 13):
        while rest % p == 0:
            rest //= p
            primes.append(p)
    if len(primes) < 2:
        passes = (*primes, *zfuse.radix_passes(rest))
        bins = zfuse.digit_reversed_bins(passes).astype(np.int16)
        return dataclasses.replace(base, kernel="mixed", passes=passes,
                                   bins=torch.from_numpy(bins).to(dev))
    m = 2 * nz
    while (zfuse._passes(m, generic=False) is None
           or m % 11 == 0 or m % 13 == 0):
        m += 2
    return dataclasses.replace(base, **zfuse.bluestein_tables(nz, m, dev))


def sweep_k7design(iters: int) -> None:
    import time
    from concurrent.futures import ThreadPoolExecutor

    from kwave_tpu_torch.ops import _build, zfuse

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(K7_DESIGNS)) as pool:  # one nvcc a source, all at once
        libs = dict(zip(K7_DESIGNS, pool.map(_build.load_library, K7_DESIGNS.values())))
    print(json.dumps(dict(sweep="k7design", built=list(K7_DESIGNS),
                          seconds=time.perf_counter() - t0)), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(9)

    def cplx(*shape):
        return torch.view_as_complex(torch.randn(*shape, 2, device="cuda", generator=gen))

    for nz in K7_DESIGN_NZ:
        n = nz if nz <= 512 else 128
        k2 = [(2 * np.pi * np.fft.fftfreq(m, 1e-4)) ** 2 for m in (nz, n)]
        k2.append((2 * np.pi * np.fft.rfftfreq(n, 1e-4)) ** 2)
        base = zfuse.make_plan((nz, n, n), *k2, 1500.0 * 2e-8 / 2, "cuda")
        plans = {name: _design_plan(base, "KW_RADIX_11_13=0" not in flags)
                 for name, flags in K7_DESIGNS.items()}
        s = cplx(nz, n, n // 2 + 1)
        dds = (cplx(n // 2 + 1), cplx(n), cplx(nz))
        for n_ops in (1, 3):
            specs = tuple(zfuse.OpSpec("grad", axis=a) for a in (2, 1, 0))[-n_ops:]
            vecs = dds[-n_ops:]
            for plan in plans.values():
                zfuse._check(plan, s, specs, vecs)
            calls = {name: functools.partial(zfuse._launch, libs[name], plan, s, specs, vecs,
                                             True)
                     for name, plan in plans.items()}
            want = calls["default"]()
            peak = max(float(o.abs().max()) for o in want)
            row = dict(sweep="k7design", nz=nz, spectrum=list(s.shape), n_ops=n_ops,
                       routed=base.kernel, plans={}, ms={}, diff={})
            for name, call in calls.items():
                plan = plans[name]
                row["plans"][name] = dict(kernel=plan.kernel, passes=list(plan.passes),
                                          m=plan.m)
                row["diff"][name] = max(float((a - b).abs().max())
                                        for a, b in zip(call(), want)) / peak
                row["ms"][name] = []
            for _ in range(3):  # the variants in turns, three times
                for name, call in calls.items():
                    row["ms"][name].append(time_ms(call, iters))
            print(json.dumps(row), flush=True)
        del s


K7_BLUESTEIN_NZ = (127, 251, 509, 1009, 1709)
K7_BLUESTEIN_CANDIDATES = 5  # the candidates of least cost timed at each nz
# the register cap of csrc/zfuse_bluestein.cuh: three blocks an SM (the default) or two
K7_BLUESTEIN_BUILDS = {"default": (), "two_blocks": ("KW_BLUE_BLOCKS=2",)}


def sweep_k7bluestein(iters: int) -> None:
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    from kwave_tpu_torch.ops import _build, zfuse

    with ThreadPoolExecutor(len(K7_BLUESTEIN_BUILDS)) as pool:
        libs = dict(zip(K7_BLUESTEIN_BUILDS,
                        pool.map(_build.load_library, K7_BLUESTEIN_BUILDS.values())))
    lib = libs["default"]
    n = 256
    gen = torch.Generator(device="cuda").manual_seed(13)

    def cplx(*shape):
        return torch.view_as_complex(torch.randn(*shape, 2, device="cuda", generator=gen))

    for nz in K7_BLUESTEIN_NZ:
        k2 = [(2 * np.pi * np.fft.fftfreq(k, 1e-4)) ** 2 for k in (nz, n)]
        k2.append((2 * np.pi * np.fft.rfftfreq(n, 1e-4)) ** 2)
        base = zfuse.make_plan((nz, n, n), *k2, 1500.0 * 2e-8 / 2, "cuda")
        lo = 2 * nz
        cands = [(zfuse._bluestein_cost(nz, m, zfuse._passes(m, generic=False)), m)
                 for m in range(lo, 1 << (lo - 1).bit_length() + 1, 2)
                 if zfuse._passes(m, generic=False)]
        cands.sort()
        lengths = sorted({m for _, m in cands[:K7_BLUESTEIN_CANDIDATES]}
                         | {min(m for _, m in cands)})
        rule = zfuse.bluestein_length(nz)
        cost = dict((m, c) for c, m in cands)
        plans = {m: dataclasses.replace(base, **zfuse.bluestein_tables(nz, m, "cuda"))
                 for m in lengths}
        s = cplx(nz, n, n // 2 + 1)
        dds = (cplx(n // 2 + 1), cplx(n), cplx(nz))
        for n_ops in (1, 3):
            specs = tuple(zfuse.OpSpec("grad", axis=a) for a in (2, 1, 0))[-n_ops:]
            vecs = dds[-n_ops:]
            ops_full = [zfuse.full_operator(base, sp, dd, True).to(torch.complex64)
                        for sp, dd in zip(specs, vecs)]

            def library():
                f = torch.fft.fft(s, dim=0)
                return [torch.fft.ifft(f * op, dim=0) for op in ops_full]

            library_ms = time_ms(library, iters)
            del ops_full
            zfuse._check(plans[rule], s, specs, vecs)
            want = zfuse._launch(lib, plans[rule], s, specs, vecs, True)
            peak = max(float(o.abs().max()) for o in want)
            runs = [(m, 0) for m in lengths]
            runs += [(rule, tc) for tc in zfuse.BLUESTEIN_TC
                     if zfuse.bluestein_tile(nz, rule, n_ops, tc)
                     and tc != zfuse.bluestein_tile(nz, rule, n_ops).tc]
            for m, tc in runs:
                tile = zfuse.bluestein_tile(nz, m, n_ops, tc)

                def call(m=m, tc=tc):
                    return zfuse._launch(lib, plans[m], s, specs, vecs, True, tc)

                diff = max(float((a - b).abs().max()) for a, b in zip(call(), want)) / peak
                print(json.dumps(dict(
                    sweep="k7bluestein", nz=nz, spectrum=list(s.shape), n_ops=n_ops, m=m,
                    passes=list(plans[m].passes), rule=m == rule, cost=cost[m], tc=tile.tc,
                    blocks=tile.blocks, staged=list(tile.staged), smem=tile.smem,
                    ms=time_ms(call, iters), library_ms=library_ms, diff=diff)), flush=True)
            # the register cap: each build at the rule's M and tile, in turns, three times
            calls = {name: functools.partial(zfuse._launch, build, plans[rule], s, specs,
                                             vecs, True)
                     for name, build in libs.items()}
            ms = {name: [] for name in calls}
            for _ in range(3):
                for name, call in calls.items():
                    ms[name].append(time_ms(call, iters))
            print(json.dumps(dict(sweep="k7bluestein", nz=nz, n_ops=n_ops, m=rule,
                                  builds={k: list(v) for k, v in K7_BLUESTEIN_BUILDS.items()},
                                  ms=ms, diff={name: max(float((a - b).abs().max())
                                                         for a, b in zip(call(), want)) / peak
                                               for name, call in calls.items()})),
                  flush=True)
            del want
        del s


# z lengths k p of ``k7generic``: one radix pass after the generic pass (4, 8), two (12, 20,
# 24) and three (30, 60)
K7_GENERIC_KS = (4, 8, 12, 20, 24, 30, 60)


def _k7_inputs(nz: int, ny: int, nx: int, gen):
    """A plan of the spectrum [nz, ny, nx/2 + 1] of `make_plan`'s choice, a random spectrum
    and the three dd vectors (x, y, z), all on the card."""
    from kwave_tpu_torch.ops import zfuse

    def cplx(*shape):
        return torch.view_as_complex(torch.randn(*shape, 2, device="cuda", generator=gen))

    k2 = [(2 * np.pi * np.fft.fftfreq(n, 1e-4)) ** 2 for n in (nz, ny)]
    k2.append((2 * np.pi * np.fft.rfftfreq(nx, 1e-4)) ** 2)
    base = zfuse.make_plan((nz, ny, nx), *k2, 1500.0 * 2e-8 / 2, "cuda")
    return base, cplx(nz, ny, nx // 2 + 1), (cplx(nx // 2 + 1), cplx(ny), cplx(nz))


def _in_turns(calls: dict, iters: int, rounds: int = 3) -> dict:
    """Each call's device ms, timed in turns ``rounds`` times."""
    ms = {name: [] for name in calls}
    for _ in range(rounds):
        for name, call in calls.items():
            ms[name].append(time_ms(call, iters))
    return ms


def _largest_diff(calls: dict, want) -> dict:
    peak = max(float(o.abs().max()) for o in want)
    return {name: max(float((a - b).abs().max()) for a, b in zip(call(), want)) / peak
            for name, call in calls.items()}


def sweep_k7generic(iters: int) -> None:
    import types

    from kwave_tpu_torch.ops import _build, zfuse

    lib = _build.load_library()
    # the two builds of the generic plans, each as the library `_launch` calls
    builds = {"2 blocks": types.SimpleNamespace(kw_zfuse_mixed=lib.kw_zfuse_mixed_generic),
              "3 blocks": types.SimpleNamespace(kw_zfuse_mixed=lib.kw_zfuse_mixed_generic3)}
    gen = torch.Generator(device="cuda").manual_seed(17)
    shapes = [(230, 230, 230)] + [(k * p, 128, 256) for k in K7_GENERIC_KS
                                  for p in K7_PRIMES if p <= zfuse.PRIME_MAX
                                  and zfuse.radix_passes(k * p)]
    for shape in shapes:
        base, s, dds = _k7_inputs(*shape, gen)
        plan = _generic_plan(base)
        for n_ops in (1, 3):
            specs = tuple(zfuse.OpSpec("grad", axis=a) for a in (2, 1, 0))[-n_ops:]
            vecs = dds[-n_ops:]
            zfuse._check(plan, s, specs, vecs)
            calls = {name: functools.partial(zfuse._launch, b, plan, s, specs, vecs, True)
                     for name, b in builds.items()}
            calls["routed"] = functools.partial(zfuse._launch, lib, plan, s, specs, vecs, True)
            print(json.dumps(dict(
                sweep="k7generic", nz=shape[0], spectrum=list(s.shape), n_ops=n_ops,
                passes=list(plan.passes), ms=_in_turns(calls, iters),
                diff=_largest_diff(calls, calls["2 blocks"]()))), flush=True)
        del s


def _generic_plan(base):
    """``base``'s z length through the mixed kernel with its prime from 17 up as a generic
    pass, first (a plan built here past PRIME_MAX too)."""
    import dataclasses

    from kwave_tpu_torch.ops import zfuse

    nz = base.nz
    p = next(p for p in range(zfuse.PRIME_MIN, nz + 1) if nz % p == 0 and zfuse._is_prime(p))
    passes = (p, *(zfuse.radix_passes(nz // p) if nz > p else ()))
    bins = torch.from_numpy(zfuse.digit_reversed_bins(passes).astype(np.int16)).cuda()
    return dataclasses.replace(base, kernel="mixed", passes=passes, bins=bins)


K7_SMALL_NZ = tuple(range(2, 17))


def sweep_k7small(iters: int) -> None:
    import dataclasses

    from kwave_tpu_torch.ops import zfuse

    gen = torch.Generator(device="cuda").manual_seed(19)
    for nz in K7_SMALL_NZ:
        base, s, dds = _k7_inputs(nz, 256, 256, gen)
        tiled = "radix" if zfuse.radix_takes(nz) else "mixed"
        plans = {kernel: dataclasses.replace(base, **zfuse.kernel_tables(nz, kernel, "cuda"))
                 for kernel in ("column", tiled)}
        for n_ops in (1, 3):
            specs = tuple(zfuse.OpSpec("grad", axis=a) for a in (2, 1, 0))[-n_ops:]
            vecs = dds[-n_ops:]
            ops_full = [zfuse.full_operator(base, sp, dd, True).to(torch.complex64)
                        for sp, dd in zip(specs, vecs)]

            def library(ops_full=ops_full):
                f = torch.fft.fft(s, dim=0)
                return [torch.fft.ifft(f * op, dim=0) for op in ops_full]

            calls = {kernel: functools.partial(zfuse.apply, plan, s, specs, vecs)
                     for kernel, plan in plans.items()}
            diff = _largest_diff(calls, library())
            calls["library"] = library
            print(json.dumps(dict(sweep="k7small", nz=nz, spectrum=list(s.shape),
                                  n_ops=n_ops, routed=base.kernel, tiled=tiled,
                                  passes=list(plans[tiled].passes), ms=_in_turns(calls, iters),
                                  diff=diff)), flush=True)
        del s


SWEEPS = {"windows": sweep_windows, "k6": sweep_k6, "k3": sweep_k3, "k7": sweep_k7,
          "k7prime": sweep_k7prime, "k7generic": sweep_k7generic, "k7small": sweep_k7small,
          "k7design": sweep_k7design, "k7bluestein": sweep_k7bluestein}


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--only", nargs="*", choices=sorted(SWEEPS), default=sorted(SWEEPS),
                        help="the sweeps to run (default: all)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kwave_tpu_torch.sweeps needs an NVIDIA card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    for name in SWEEPS:
        if name in args.only:
            SWEEPS[name](args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
