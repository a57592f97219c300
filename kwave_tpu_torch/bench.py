"""Codec round-trip benchmark of kwave_tpu_torch on one device (port of the
repository's ``bench.py``).

    python -m kwave_tpu_torch.bench [--steps 4096] [--sensors 16384] [--period 20]
                                    [--harmonics 2] [--reps-inner 16] [--reps-outer 4]

The device comes from ``KWAVE_TPU_TORCH_DEVICE`` (``cuda`` by default; ``cpu`` runs the
plain versions, for a small shape in the tests). Prints ONE JSON line with bench.py's
keys: ``metric`` ("codec_encode_decode"), ``value`` (GB/s over the 2S bytes of series in
and out), ``unit``, ``vs_baseline``, ``actual_bytes_value`` (GB/s over the 2S + 2F bytes
the chain really moves), ``ceiling`` (GB/s of a same-run chained elementwise pass over
the series) and ``fraction`` (actual over ceiling: kernel and ceiling shift together
within a run, so the ratio tracks the code); and beside them ``device``, the time per
round trip on the device and on the host clock, and the number of round trips run.

Workload (BASELINE.json north star): a pressure-scale series [T, N] fp32, the
windowed-harmonic projection encode (`encoder.encode_series_frames`) and the overlap-add
decode (`decoder.reconstruct_frames`) in the packed [K, 2H, N] frame layout. REPS_INNER
round trips are chained, each encoding the previous reconstruction (a true serial data
dependency); the reconstruction is a fixed point of the transform for band-limited
signals, and one round trip is held to a relative error below 0.02 first. On CUDA the
time comes from CUDA events around the chains; TF32 is off, so the matmul-based plain
versions elsewhere stay fp32.

``vs_baseline`` is over `kwave_tpu_torch.oracle`'s float encode (the reference's per-step CPU
accumulate loop in NumPy, as tools/measure_oracle.py times it), timed in the same run on
this host's CPU on the first 1024 steps x 8192 sensors of the same series: a CPU figure.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from kwave_tpu_torch import decoder, encoder
from kwave_tpu_torch.basis import generate_basis

PERIOD = 20.0
HARMONICS = 2
T_STEPS = 4096
N_SENSORS = 16384  # 256 MiB series
REPS_INNER = 16  # chained round trips per timed call
REPS_OUTER = 4
ORACLE_STEPS, ORACLE_SENSORS = 1024, 8192  # the slice tools/measure_oracle.py encodes
GUARD = 0.02  # round-trip relative error, as bench.py


def make_series(steps: int, n: int, period: float, seed: int,
                device: torch.device) -> torch.Tensor:
    """Two harmonics of the period with per-sensor phases from a numpy seed, built on
    the device (no 256 MiB host upload)."""
    phase = torch.from_numpy(
        np.random.default_rng(seed).uniform(0.0, 2.0 * np.pi, (1, n)).astype(np.float32)
    ).to(device)
    t = torch.arange(steps, dtype=torch.float32, device=device)[:, None]
    x = 1e5 * torch.sin(2 * np.pi * t / period + phase)
    return x + 1e4 * torch.sin(4 * np.pi * t / period + 1.7 * phase)


def _elapsed_s(fn, device: torch.device, calls: int) -> tuple[float, float]:
    """(device seconds, host seconds) per call of ``fn``, after one warm-up call. The
    device time comes from CUDA events; on the CPU there is only the host clock."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        wall = (time.perf_counter() - t0) / calls
        return wall, wall
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    wall = (time.perf_counter() - t0) / calls
    return start.elapsed_time(end) / 1e3 / calls, wall


def oracle_gbps(series: torch.Tensor, basis) -> float:
    """`kwave_tpu_torch.oracle` float encode throughput on this host's CPU, on a slice."""
    from kwave_tpu_torch.oracle import OracleEncoder

    x = series[:ORACLE_STEPS, :ORACLE_SENSORS].cpu().numpy()
    enc = OracleEncoder(basis, n_sensors=x.shape[1], total_steps=x.shape[0])
    t0 = time.perf_counter()
    enc.encode_series(x)
    return x.nbytes / (time.perf_counter() - t0) / 1e9


def run(steps: int = T_STEPS, sensors: int = N_SENSORS, period: float = PERIOD,
        harmonics: int = HARMONICS, reps_inner: int = REPS_INNER,
        reps_outer: int = REPS_OUTER, compute: str = "flat", seed: int = 0,
        device: torch.device | str = "cuda") -> dict:
    """The benchmark on ``device``; returns the JSON line's fields."""
    device = torch.device(device)
    cb = generate_basis(period, 1, harmonics, normalize=True)
    o = cb.o_size
    n_frames = steps // o
    if n_frames < 5:
        raise ValueError(f"{steps} steps hold {n_frames} windows of {o}; the guard needs 5")
    series = make_series(steps, sensors, period, seed, device)
    tables = encoder.make_tables(cb, False, device)
    tab_re, tab_im = tables["be_re"], tables["be_im"]
    round_trips = 0

    def one_roundtrip(x):
        nonlocal round_trips
        round_trips += 1
        frames = encoder.encode_series_frames(x, cb, compute=compute)
        return frames, decoder.reconstruct_frames(frames, tab_re, tab_im, o, steps,
                                                  compute=compute)

    def roundtrip_chain():
        x = series
        for _ in range(reps_inner):  # only the latest reconstruction stays alive
            _, x = one_roundtrip(x)
        return x

    def copy_chain():
        x = series
        for _ in range(reps_inner):
            x = x * 1.0
        return x

    frames, rec = one_roundtrip(series)
    mid = slice(2 * o, n_frames * o - 2 * o)
    err = float((rec[mid] - series[mid]).abs().max() / series.abs().max())
    if not err < GUARD:
        raise RuntimeError(f"round trip relative error {err} >= {GUARD}")
    f_bytes = frames.numel() * 4  # written by encode, read by decode
    del frames, rec

    dt, wall = (t / reps_inner for t in _elapsed_s(roundtrip_chain, device, reps_outer))
    dt_copy = _elapsed_s(copy_chain, device, reps_outer)[0] / reps_inner

    s_bytes = series.numel() * 4  # encode reads the series, decode writes it
    gbps = 2 * s_bytes / dt / 1e9
    actual_gbps = (2 * s_bytes + 2 * f_bytes) / dt / 1e9
    ceiling = 2 * s_bytes / dt_copy / 1e9
    return {
        "metric": "codec_encode_decode",
        "value": gbps,
        "unit": "GB/s",
        "vs_baseline": gbps / oracle_gbps(series, cb),
        "actual_bytes_value": actual_gbps,
        "ceiling": ceiling,
        "fraction": actual_gbps / ceiling,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "ms_per_round_trip": dt * 1e3,
        "wall_ms_per_round_trip": wall * 1e3,
        "round_trip_err": err,
        "round_trips": round_trips,
        "shape": {"steps": steps, "sensors": sensors, "period": period,
                  "harmonics": harmonics, "frames": [n_frames, 2 * harmonics, sensors]},
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=T_STEPS)
    p.add_argument("--sensors", type=int, default=N_SENSORS)
    p.add_argument("--period", type=float, default=PERIOD)
    p.add_argument("--harmonics", type=int, default=HARMONICS)
    p.add_argument("--reps-inner", type=int, default=REPS_INNER)
    p.add_argument("--reps-outer", type=int, default=REPS_OUTER)
    p.add_argument("--compute", default="flat",
                   help="flat (the default entries) or vpu (the 3D entries)")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> int:
    from kwave_tpu_torch.cli import device_from_env

    args = build_parser().parse_args(argv)
    device = device_from_env()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    result = run(args.steps, args.sensors, args.period, args.harmonics, args.reps_inner,
                 args.reps_outer, args.compute, args.seed, device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
