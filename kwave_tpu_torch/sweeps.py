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
"""

from __future__ import annotations

import argparse
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


SWEEPS = {"windows": sweep_windows, "k6": sweep_k6, "k3": sweep_k3, "k7": sweep_k7}


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
