"""Sweeps of the two redesigned kernels' free parameters, on the card.

    python -m kwave_tpu_torch.sweeps [--iters 20]

Prints the card's name and power limit, then one JSON line per measurement (device time
per launch from CUDA events, the stream held by a sleep kernel while the host enqueues):

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


def time_ms(fn, iters: int) -> float:
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


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kwave_tpu_torch.sweeps needs an NVIDIA card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    sweep_k3(args.iters)
    sweep_k7(args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
