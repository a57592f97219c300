#!/usr/bin/env python3
"""Smoke test of kwave_tpu_torch on one NVIDIA card: builds the CUDA kernels from the
sources in this checkout, holds each against its plain PyTorch version and the NumPy
oracle, then drives the port's main path at 128^3 with 16384 index sensors.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and the script exits non-zero without
the final ok line):
1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc builds csrc/*.cu into build/kwave_tpu_torch/ (timed);
3. kernel parity: the four window-encode variants at o=16, H=1 and 2, N=16384, bit for
   bit against their plain versions on the card and against kwave_tpu.oracle on the
   first 256 sensors; kernel and plain time per window from CUDA events;
4. main path: `driver.run_simulation` on a 128^3 heterogeneous absorbing medium with a
   p0 source, period 16, a few windows plus a tail, as ``--p_raw --p_c --40-bit_complex``
   and then as three shorter runs that take the other three variants. The output goes
   to an in-memory group (this run does not need h5py). Checks: each variant launched
   once per window-encode call, Nc == steps // o, the p_c bytes equal the oracle's
   encoding of p_raw on the first 256 sensors and decode to within 1e-3 of the series
   peak, no NaN. Prints ms/step.
5. codec kernels: the projection encode (K5, both entries) at the codec round trip's
   full shape (T=4096, N=16384, period 20, H=2), and at H=1, H=4 and a ragged N, against
   its plain version and a float64 projection (within 1e-6 of the frame peak) and the
   oracle's float encoder on 256 sensors (2e-6); flat == 3D bit for bit; K6 window by
   window == K5 bit for bit; dyadic data bit-exact. The synthesis decode (K4, both
   entries) on the same frames and on five boundary cases, against plain (1e-6 of the
   peak) and `kwave_tpu.oracle.reconstruct` on 256 sensors (4e-6). Kernel and plain
   times at the full shape from CUDA events, and wall time per call;
6. codec round trip: `kwave_tpu_torch.bench` at bench.py's shape (GB/s,
   actual_bytes_value, ceiling, fraction, the err < 0.02 guard), one encode and one
   decode launch per round trip; a shorter chain through the 3D entries; the same
   series encoded window by window through K6, equal to the whole-series frames; and
   phase 4's float `p_c` decoded by `decoder.reconstruct_frames` (K4) against the oracle.
Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``. TF32 is off throughout, so every plain version on the
card computes in full fp32.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
O_SIZE, N_SENSORS, GRID_N = 16, 16384, 128
ORACLE_SENSORS = 256
DECODE_TOL = 1e-3  # of the series peak, as tests/test_torch_driver.py

# the codec round trip's full shape (bench.py)
CODEC_T, CODEC_N, CODEC_PERIOD, CODEC_H = 4096, 16384, 20.0, 2
CODEC_TOL = 1e-6  # kernel vs plain and vs a float64 projection, of the peak
ORACLE_ENC_TOL = 2e-6  # vs the oracle's per-step float accumulate, of the frame peak
ORACLE_DEC_TOL = 4e-6  # vs oracle.reconstruct, of the series peak

VARIANTS = {
    # LAUNCHES key: (mode40, overlap, the TPU kernel it replaces)
    "w40_overlap": (True, True, "kwave_tpu/ops/encode_pallas.py:273"),
    "w40_no_overlap": (True, False, "kwave_tpu/ops/encode_pallas.py:323"),
    "wfloat_overlap": (False, True, "kwave_tpu/ops/encode_pallas.py:216"),
    "wfloat_no_overlap": (False, False, "kwave_tpu/ops/encode_pallas.py:247"),
}


class MemAttrs(dict):
    def create(self, name, value):
        self[name] = value


class MemDataset:
    """The subset of h5py.Dataset that the port's writers use, over a numpy array."""

    def __init__(self, shape, dtype, data=None):
        self.data = np.array(data) if data is not None else np.zeros(shape, dtype)
        self.attrs = MemAttrs()

    @property
    def shape(self):
        return self.data.shape

    def __getitem__(self, key):
        return self.data[key]

    def __setitem__(self, key, value):
        self.data[key] = value


class MemGroup:
    """The subset of h5py.Group that the port's writers use, held in memory."""

    def __init__(self):
        self.items = {}
        self.attrs = MemAttrs()

    def create_dataset(self, name, shape=None, dtype=None, data=None, chunks=None,
                       compression=None, compression_opts=None):
        self.items[name] = MemDataset(shape, dtype, data)
        return self.items[name]

    def create_group(self, name):
        self.items[name] = MemGroup()
        return self.items[name]

    def __getitem__(self, name):
        return self.items[name]


def device_phase():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[1 device] {name} (torch {torch.__version__}, CUDA {torch.version.cuda})",
          flush=True)
    print(smi, flush=True)
    return name, smi


def build_phase():
    from kwave_tpu_torch.ops import _build

    _build.library_path().unlink(missing_ok=True)  # build from the sources, every run
    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    print(f"[2 build] nvcc sm_90a -> {_build.library_path().name} in {secs:.2f} s",
          flush=True)
    return secs


def _tables(basis):
    from kwave_tpu_torch import encoder

    return encoder.stacked_tables(encoder.make_tables(basis, False, "cuda"))


def _series(steps, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(steps)[:, None]
    amp = rng.uniform(0.5, 2.0, n) * 1e5
    x = amp * np.sin(2 * np.pi * t / O_SIZE + rng.uniform(0, 2 * np.pi, n))
    return (x + rng.normal(0, 1e3, (steps, n))).astype(np.float32)


def _time_per_call(fn, iters, warmup):
    """(device ms, wall ms) per call. The device time is taken with CUDA events while a
    sleep kernel holds the stream, so the host has enqueued every call before the device
    starts them and the events see the launches back to back (host-bound code, such as
    a plain version of ~1000 small launches per window, still shows its gaps). The wall
    time is the host clock per call, synchronized."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / iters * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1_000_000 / start.elapsed_time(end)
    torch.cuda._sleep(int(cycles_per_ms * (2.0 * wall_ms * iters + 5.0)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, wall_ms


def kernel_phase():
    """All four variants at the main path's shapes, against plain and oracle."""
    import torch

    from kwave_tpu import oracle
    from kwave_tpu.basis import MAX_EXP_P, generate_basis
    from kwave_tpu_torch import bitpack, encoder
    from kwave_tpu_torch.ops import encode_window as ew

    results = {}
    for key, (mode40, overlap, _) in VARIANTS.items():
        worst = 0.0
        for h in (1, 2):
            basis = generate_basis(float(O_SIZE), 1, h, normalize=True)
            tabs = _tables(basis)
            x = torch.from_numpy(_series(3 * O_SIZE, N_SENSORS, seed=h)).cuda()
            # (a) one window from nonzero state, per parity and mirror: kernel == plain
            rng = np.random.default_rng(h)
            vals = [torch.from_numpy((1e5 * rng.standard_normal((h, N_SENSORS))).astype(
                np.float32)).cuda() for _ in range(4)]
            if mode40:
                planes = bitpack.encode40(vals[0], vals[1], MAX_EXP_P) + bitpack.encode40(
                    vals[2], vals[3], MAX_EXP_P)
                planes = tuple(p.contiguous() for p in planes[: 6 if overlap else 3])
                extra = (MAX_EXP_P,)
                kern, plain = ew.encode_window_40b_exact, ew.encode_window_40b_exact_plain
            else:
                planes = tuple(vals[: 4 if overlap else 2])
                extra = ()
                kern = ew.encode_window_float_exact
                plain = ew.encode_window_float_exact_plain
            chunk = x[:O_SIZE].contiguous()
            for parity in (0, 1):
                for mirror in (0, 1):
                    args = (chunk, tabs, planes, *extra, parity, mirror, overlap)
                    got, want = kern(*args), plain(*args)
                    torch.cuda.synchronize()
                    for a, b in zip(got, want):
                        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                            raise AssertionError(f"{key} H={h} parity={parity} "
                                                 f"mirror={mirror}: kernel != plain")
                    if mode40:  # decoded values, for the error column
                        for k in range(0, len(got), 3):
                            for d1, d2 in zip(bitpack.decode40(*got[k:k + 3], MAX_EXP_P),
                                              bitpack.decode40(*want[k:k + 3], MAX_EXP_P)):
                                worst = max(worst, float((d1 - d2).abs().max()))
                    else:
                        for a, b in zip(got, want):
                            worst = max(worst, float((a - b).abs().max()))
            # (b) three windows from zero state through the encoder: == oracle
            cfg = encoder.EncoderConfig.for_stream(basis, False, mode40, overlap)
            tabd = encoder.make_tables(basis, False, "cuda")
            st = encoder.init_state(cfg, N_SENSORS, "cuda")
            frames = []
            for w in range(3):
                st, fr = encoder.encode_chunk(st, x[w * O_SIZE:(w + 1) * O_SIZE], cfg, tabd)
                frames.append([f[:, :ORACLE_SENSORS].T.cpu().numpy() for f in fr])
            sub = x[:, :ORACLE_SENSORS].cpu().numpy()
            frames_o = oracle.OracleEncoder(basis, ORACLE_SENSORS, mode40=mode40,
                                            overlap=overlap,
                                            total_steps=sub.shape[0]).encode_series(sub)
            for w, (fr, fo) in enumerate(zip(frames, frames_o)):
                for a, b in zip(fr, fo):
                    b = b.astype(np.uint32).view(np.int32) if mode40 else b
                    if not np.array_equal(np.ascontiguousarray(a).view(np.int32),
                                          np.ascontiguousarray(b).view(np.int32)):
                        raise AssertionError(f"{key} H={h} window {w}: kernel != oracle")
            if h == 1:  # the main path's shape: time it
                args = (chunk, tabs, planes, *extra, 0, 0, overlap)
                ms, wall = _time_per_call(lambda: kern(*args), iters=200, warmup=20)
                plain_ms, plain_wall = _time_per_call(lambda: plain(*args), iters=10,
                                                        warmup=2)
        results[key] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)
        print(f"[3 kernel] {key}: bit-exact vs plain (H=1,2, parity 0/1, mirror 0/1) and "
              f"vs oracle ({ORACLE_SENSORS} sensors, 3 windows); per window at o={O_SIZE} "
              f"H=1 N={N_SENSORS}, device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms; wall per call: kernel {wall:.4f} ms, plain {plain_wall:.4f} ms",
              flush=True)
    return results


CODEC_KERNELS = {
    # LAUNCHES key: (module of the count, the TPU kernel it replaces)
    "reconstruct_series_flat": ("fastpath", "kwave_tpu/ops/fastpath.py:344"),
    "reconstruct_series": ("fastpath", "kwave_tpu/ops/fastpath.py:431"),
    "encode_frames_flat": ("fastpath", "kwave_tpu/ops/fastpath.py:279"),
    "encode_frames": ("fastpath", "kwave_tpu/ops/fastpath.py:126"),
    "wfloat_projection": ("encode_window", "kwave_tpu/ops/encode_pallas.py:132"),
}


def _rel_err(got, want) -> float:
    """max |got - want| over the peak of want, in float64 on the host."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _codec_tables(basis):
    """(tab_lo, tab_hi) [o, 2H] for the projection and tab4 [o, 4H] for the synthesis."""
    import torch

    from kwave_tpu_torch import encoder

    o = basis.o_size
    t = encoder.make_tables(basis, False, "cuda")
    tab = torch.cat([t["be_re"], t["be_im"]], dim=1)
    tab4 = torch.cat([t["be_re"][o:], t["be_im"][o:], t["be_re"][:o], t["be_im"][:o]],
                     dim=1)
    return tab[:o].contiguous(), tab[o:].contiguous(), tab4.contiguous()


def _oracle_frames(x_host, basis):
    """The oracle's float overlap frames of x_host [T, n] as [K, 2H, n] float32."""
    from kwave_tpu import oracle

    frames = oracle.OracleEncoder(basis, x_host.shape[1],
                                  total_steps=x_host.shape[0]).encode_series(x_host)
    return np.stack([np.concatenate([fr.T, fi.T]) for fr, fi in frames])


def _oracle_reconstruct(frames, basis, n_steps):
    from kwave_tpu import oracle

    f = frames[:, :, :ORACLE_SENSORS].cpu().numpy()
    h = basis.harmonics
    return oracle.reconstruct(np.swapaxes(f[:, :h], 1, 2), np.swapaxes(f[:, h:], 1, 2),
                              basis, False, n_steps)


def codec_kernel_phase():
    """K5 (both entries), K6 and K4 (both entries) against plain, float64 and oracle."""
    import torch

    from kwave_tpu.basis import generate_basis
    from kwave_tpu_torch import bench
    from kwave_tpu_torch.ops import encode_window as ew
    from kwave_tpu_torch.ops import fastpath as fp

    results = {}
    for h, n in ((CODEC_H, CODEC_N), (1, CODEC_N), (4, CODEC_N), (CODEC_H, CODEC_N - 3)):
        main = (h, n) == (CODEC_H, CODEC_N)
        basis = generate_basis(CODEC_PERIOD, 1, h, normalize=True)
        o = basis.o_size
        lo, hi, tab4 = _codec_tables(basis)
        x = bench.make_series(CODEC_T, n, CODEC_PERIOD, seed=h + n, device="cuda")
        # K5: both entries, plain, float64 and the oracle
        frames = fp.encode_frames_flat(x, lo, hi, o)
        _require(torch.equal(frames.view(torch.int32),
                             fp.encode_frames(x, lo, hi, o).view(torch.int32)),
                 f"H={h} N={n}: encode_frames (3D) != encode_frames_flat")
        plain = fp.encode_frames_plain(x, lo, hi, o)
        enc_err = _rel_err(frames, plain)
        sub = slice(0, ORACLE_SENSORS)
        f64 = fp.encode_frames_plain(x[:, sub].double(), lo.double(), hi.double(), o)
        f64_err = _rel_err(frames[..., sub], f64)
        orc_err = _rel_err(frames[..., sub], torch.from_numpy(
            _oracle_frames(x[:, sub].cpu().numpy(), basis)))
        _require(enc_err <= CODEC_TOL and f64_err <= CODEC_TOL
                 and orc_err <= ORACLE_ENC_TOL,
                 f"H={h} N={n}: encode off by {enc_err:.3g} (plain), {f64_err:.3g} "
                 f"(float64), {orc_err:.3g} (oracle) of the peak")
        # K6 window by window == K5
        p1 = torch.zeros((2 * h, n), device="cuda")
        k6_err = 0.0
        for w in range(frames.shape[0]):
            chunk = x[w * o:(w + 1) * o]
            frame, p1_next = ew.encode_window_float(chunk, lo, hi, p1, first_window=w == 0)
            _require(torch.equal(frame.view(torch.int32), frames[w].view(torch.int32)),
                     f"H={h} N={n}: K6 window {w} != K5 frame")
            if w < 3:
                k6_err = max(k6_err, float((frame - ew.encode_window_float_plain(
                    chunk, lo, hi, p1, w == 0)[0]).abs().max()))
            p1 = p1_next
        # K4: both entries on the frames, plain and the oracle
        rec = fp.reconstruct_series_flat(frames, tab4, o, CODEC_T)
        _require(torch.equal(rec.view(torch.int32), fp.reconstruct_series(
            frames, tab4, o, CODEC_T).view(torch.int32)),
                 f"H={h} N={n}: reconstruct_series (3D) != reconstruct_series_flat")
        dec_err = _rel_err(rec, fp.reconstruct_series_plain(frames, tab4, o, CODEC_T))
        _require(dec_err <= CODEC_TOL, f"H={h} N={n}: decode off plain by {dec_err:.3g}")
        line = (f"[5 codec] H={h} N={n} T={CODEC_T} o={o}: K5 flat == 3D bit for bit, "
                f"off plain {enc_err:.2e}, float64 {f64_err:.2e}, oracle {orc_err:.2e} of "
                f"the peak; K6 x{frames.shape[0]} windows == K5 bit for bit; K4 flat == 3D, "
                f"off plain {dec_err:.2e}")
        if main:
            line += _codec_main_checks(x, frames, rec, basis, lo, hi, tab4, results,
                                       k6_err)
        print(line, flush=True)
    return results


def _codec_main_checks(x, frames, rec, basis, lo, hi, tab4, results, k6_err):
    """At the full shape: K4 against the oracle and on the five boundary cases, dyadic
    bit-exactness, and the times of every kernel and its plain version."""
    import torch

    from kwave_tpu_torch.ops import encode_window as ew
    from kwave_tpu_torch.ops import fastpath as fp

    o = basis.o_size
    dec_orc = _rel_err(rec[:, :ORACLE_SENSORS],
                       torch.from_numpy(_oracle_reconstruct(frames, basis, CODEC_T)))
    _require(dec_orc <= ORACLE_DEC_TOL, f"decode off the oracle by {dec_orc:.3g}")
    cases = [(12, 12 * o - 7), (12, 5 * o), (4, 6 * o), (1, o), (12, 1)]
    worst_case = 0.0
    for k_frames, n_steps in cases:
        f = frames[:k_frames].contiguous()
        got = fp.reconstruct_series_flat(f, tab4, o, n_steps)
        _require(tuple(got.shape) == (n_steps, CODEC_N) and torch.equal(
            got.view(torch.int32),
            fp.reconstruct_series(f, tab4, o, n_steps).view(torch.int32)),
            f"boundary case {k_frames} frames, {n_steps} steps: flat != 3D")
        e_plain = _rel_err(got, fp.reconstruct_series_plain(f, tab4, o, n_steps))
        e_orc = _rel_err(got[:, :ORACLE_SENSORS],
                         torch.from_numpy(_oracle_reconstruct(f, basis, n_steps)))
        _require(e_plain <= CODEC_TOL and e_orc <= ORACLE_DEC_TOL,
                 f"boundary case {k_frames} frames, {n_steps} steps: off plain "
                 f"{e_plain:.3g}, oracle {e_orc:.3g}")
        worst_case = max(worst_case, e_plain, e_orc)
    rng = np.random.default_rng(1)
    xd = torch.from_numpy(rng.integers(-8, 9, (CODEC_T, CODEC_N)).astype(np.float32)).cuda()
    ld, hd = (torch.from_numpy((rng.integers(-7, 8, tuple(lo.shape)) / 32.0).astype(
        np.float32)).cuda() for _ in range(2))
    fd = fp.encode_frames_flat(xd, ld, hd, o)
    _require(torch.equal(fd.view(torch.int32), fp.encode_frames_plain(xd, ld, hd, o).view(
        torch.int32)), "dyadic encode: kernel != plain")
    td = torch.from_numpy((rng.integers(-7, 8, tuple(tab4.shape)) / 32.0).astype(
        np.float32)).cuda()
    _require(torch.equal(
        fp.reconstruct_series_flat(fd, td, o, CODEC_T, normalized=False).view(torch.int32),
        fp.reconstruct_series_plain(fd, td, o, CODEC_T, normalized=False).view(
            torch.int32)), "dyadic decode: kernel != plain")

    p1 = torch.zeros_like(frames[0])
    chunk = x[:o]
    timed = {  # LAUNCHES key: (kernel call, plain call)
        "encode_frames_flat": (lambda: fp.encode_frames_flat(x, lo, hi, o),
                               lambda: fp.encode_frames_plain(x, lo, hi, o)),
        "encode_frames": (lambda: fp.encode_frames(x, lo, hi, o),
                          lambda: fp.encode_frames_plain(x, lo, hi, o)),
        "wfloat_projection": (lambda: ew.encode_window_float(chunk, lo, hi, p1),
                              lambda: ew.encode_window_float_plain(chunk, lo, hi, p1)),
        "reconstruct_series_flat": (
            lambda: fp.reconstruct_series_flat(frames, tab4, o, CODEC_T),
            lambda: fp.reconstruct_series_plain(frames, tab4, o, CODEC_T)),
        "reconstruct_series": (lambda: fp.reconstruct_series(frames, tab4, o, CODEC_T),
                               lambda: fp.reconstruct_series_plain(frames, tab4, o,
                                                                   CODEC_T)),
    }
    errs = {
        "encode_frames_flat": float((frames - fp.encode_frames_plain(x, lo, hi, o)).abs()
                                    .max()),
        "wfloat_projection": k6_err,
        "reconstruct_series_flat": float(
            (rec - fp.reconstruct_series_plain(frames, tab4, o, CODEC_T)).abs().max()),
    }
    errs["encode_frames"] = errs["encode_frames_flat"]
    errs["reconstruct_series"] = errs["reconstruct_series_flat"]
    parts = []
    for key, (kern, plain) in timed.items():
        ms, wall = _time_per_call(kern, iters=50, warmup=5)
        plain_ms, plain_wall = _time_per_call(plain, iters=10, warmup=2)
        results[key] = dict(max_abs_err=errs[key], ms=ms, plain_ms=plain_ms)
        parts.append(f"{key} {ms * 1e3:.1f} us (wall {wall * 1e3:.1f} us), plain "
                     f"{plain_ms * 1e3:.1f} us (wall {plain_wall * 1e3:.1f} us)")
    return (f"; K4 off oracle {dec_orc:.2e} ({ORACLE_SENSORS} sensors); 5 boundary cases "
            f"flat == 3D, worst {worst_case:.2e} off plain/oracle; dyadic K5 and K4 == plain "
            f"bit for bit; device time per call: " + "; ".join(parts))


def codec_round_trip_phase(float_out, float_steps):
    """The codec's entry points at full width with the counts set to 0 first: the bench
    chain (flat entries), a shorter chain through the 3D entries, the series encoded
    window by window through K6, and phase 4's float p_c decoded through K4."""
    import torch

    from kwave_tpu.basis import generate_basis
    from kwave_tpu_torch import bench, decoder, encoder
    from kwave_tpu_torch.ops import encode_window as ew
    from kwave_tpu_torch.ops import fastpath as fp

    ew.reset_launch_counts()
    fp.reset_launch_counts()
    res = bench.run(device="cuda")
    _require(fp.LAUNCHES["encode_frames_flat"] == res["round_trips"] ==
             fp.LAUNCHES["reconstruct_series_flat"],
             f"{res['round_trips']} round trips launched {fp.LAUNCHES}")
    print(f"[6 round trip] T={CODEC_T} N={CODEC_N} H={CODEC_H} period {CODEC_PERIOD:g}: "
          f"{json.dumps({k: res[k] for k in ('value', 'actual_bytes_value', 'ceiling', 'fraction', 'vs_baseline', 'ms_per_round_trip', 'wall_ms_per_round_trip', 'round_trip_err')})}"
          f"; {res['round_trips']} round trips, one encode_frames_flat and one "
          f"reconstruct_series_flat launch each", flush=True)
    res3 = bench.run(reps_inner=2, reps_outer=1, compute="vpu", device="cuda")
    _require(fp.LAUNCHES["encode_frames"] == res3["round_trips"] ==
             fp.LAUNCHES["reconstruct_series"], f"3D entries launched {fp.LAUNCHES}")
    print(f"[6 round trip] 3D entries (compute=vpu): {res3['round_trips']} round trips, "
          f"{res3['ms_per_round_trip']:.4f} ms each, guard err "
          f"{res3['round_trip_err']:.2e}", flush=True)

    basis = generate_basis(CODEC_PERIOD, 1, CODEC_H, normalize=True)
    o = basis.o_size
    x = bench.make_series(CODEC_T, CODEC_N, CODEC_PERIOD, seed=0, device="cuda")
    whole = encoder.encode_series_frames(x, basis)
    lo, hi, _ = _codec_tables(basis)
    p1 = torch.zeros((2 * CODEC_H, CODEC_N), device="cuda")
    for w in range(whole.shape[0]):
        frame, p1 = ew.encode_window_float(x[w * o:(w + 1) * o], lo, hi, p1,
                                           first_window=w == 0)
        _require(torch.equal(frame.view(torch.int32), whole[w].view(torch.int32)),
                 f"streamed window {w} != whole-series frame")
    print(f"[6 round trip] the series window by window through encode_window_float: "
          f"{whole.shape[0]} frames == encode_series_frames bit for bit", flush=True)

    # phase 4's float p_c (H=1, period O_SIZE) decoded on the card
    rows = float_out["p_c"].data[0]  # [Nc, 2*H*N] interleaved (pH = i*H + ih, re/im)
    c = np.ascontiguousarray(rows).view(np.float32).reshape(rows.shape[0], N_SENSORS, 1, 2)
    frames = torch.from_numpy(np.concatenate(
        [np.swapaxes(c[..., 0], 1, 2), np.swapaxes(c[..., 1], 1, 2)], axis=1)).cuda()
    pbasis = generate_basis(float(O_SIZE), 1, 1, normalize=True)
    t = encoder.make_tables(pbasis, False, "cuda")
    rec = decoder.reconstruct_frames(frames, t["be_re"], t["be_im"], O_SIZE, float_steps)
    err = _rel_err(rec[:, :ORACLE_SENSORS], torch.from_numpy(
        _oracle_reconstruct(frames, pbasis, float_steps)))
    _require(torch.isfinite(rec).all().item() and err <= ORACLE_DEC_TOL,
             f"p_c decode off the oracle by {err:.3g}")
    counts = {k: (fp.LAUNCHES if mod == "fastpath" else ew.LAUNCHES)[k]
              for k, (mod, _) in CODEC_KERNELS.items()}
    _require(all(v > 0 for v in counts.values()), f"a codec kernel never ran: {counts}")
    print(f"[6 round trip] phase 4's float p_c ({rows.shape[0]} frames x {N_SENSORS} "
          f"sensors, {float_steps} steps) through decoder.reconstruct_frames: off "
          f"oracle.reconstruct {err:.2e} of the peak ({ORACLE_SENSORS} sensors); "
          f"launches {counts}", flush=True)
    return counts


def _input(nt: int):
    """128^3 heterogeneous absorbing medium, p0 at the centre, 16384 random index
    sensors (the setup of tools/bench_driver_40bit.py), from seed 7."""
    from kwave_tpu_torch.io.input_file import InputData
    from kwave_tpu_torch.solver import Grid, Medium

    n = GRID_N
    dx = 1e-4
    grid = Grid(nx=n, ny=n, nz=n, dx=dx, dy=dx, dz=dx, dt=0.3 * dx / 1600.0, nt=nt)
    rng = np.random.default_rng(7)
    medium = Medium(c0=(1500.0 + 100.0 * rng.random(grid.shape)).astype(np.float32),
                    rho0=(1000.0 + 50.0 * rng.random(grid.shape)).astype(np.float32),
                    alpha_coeff=0.75, alpha_power=1.5)
    mask = np.sort(rng.choice(grid.n_elements, N_SENSORS, replace=False)).astype(np.int64)
    p0 = np.zeros(grid.shape, np.float32)
    p0[n // 2, n // 2, n // 2] = 1e5
    return InputData(grid=grid, medium=medium, pml_size=(10, 10, 10),
                     pml_alpha=(2.0, 2.0, 2.0), absorbing=True, sensor_mask_index=mask,
                     p0=p0)


def _run(flags: list[str], windows: int, tail: int):
    import torch

    from kwave_tpu_torch import params
    from kwave_tpu_torch.driver import run_simulation

    args = params.build_parser().parse_args(["-i", "-", "-o", "-", "--period",
                                             str(O_SIZE), *flags])
    data = _input(windows * O_SIZE + tail)
    run = params.args_to_run_config(args, dt=data.grid.dt)
    out = MemGroup()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_simulation(data, run, out, device="cuda")
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, data.grid.nt


def _check_run(out, flags, steps):
    """Nc, no NaN, and the p_c bytes against the oracle's encoding of p_raw."""
    from kwave_tpu import oracle
    from kwave_tpu.basis import generate_basis

    mode40, overlap = "--40-bit_complex" in flags, "--no_overlap" not in flags
    p = out["p"].data[0]
    rows = out["p_c"].data[0]
    if rows.shape[0] != steps // O_SIZE:
        raise AssertionError(f"{flags}: Nc={rows.shape[0]} != steps // o = {steps // O_SIZE}")
    if not np.isfinite(p).all():
        raise AssertionError(f"{flags}: NaN/inf in p_raw")
    basis = generate_basis(float(O_SIZE), 1, 1, normalize=True)
    sub = np.ascontiguousarray(p[:, :ORACLE_SENSORS])
    frames_o = oracle.OracleEncoder(basis, ORACLE_SENSORS, mode40=mode40, overlap=overlap,
                                    total_steps=steps).encode_series(sub)
    k = ORACLE_SENSORS
    raw = np.ascontiguousarray(rows).view(np.uint8)
    if mode40:
        mine = raw[:, : 5 * k]
        want = np.stack([oracle.soa_to_bytes(*fr) for fr in frames_o])
        h, r, i = oracle.bytes_to_soa(np.ascontiguousarray(mine).reshape(-1))
        re, im = oracle.decode40(h.reshape(-1, k, 1), r.reshape(-1, k, 1),
                                 i.reshape(-1, k, 1), oracle.MAX_EXP_P)
    else:
        mine = raw[:, : 8 * k]
        want = np.stack([np.stack(fr, -1).reshape(-1).view(np.uint8) for fr in frames_o])
        c = np.ascontiguousarray(mine).view(np.float32).reshape(-1, k, 1, 2)
        re, im = c[..., 0], c[..., 1]
    if not np.array_equal(mine, want):
        raise AssertionError(f"{flags}: p_c bytes != oracle encoding of p_raw")
    x_port = oracle.reconstruct(re, im, basis, False, steps)
    fo = [np.stack(f) for f in zip(*frames_o)]
    if mode40:
        re_o, im_o = oracle.decode40(*fo, oracle.MAX_EXP_P)
    else:
        re_o, im_o = fo
    x_ref = oracle.reconstruct(re_o, im_o, basis, False, steps)
    peak = float(np.abs(p).max())
    err = float(np.abs(x_port - x_ref).max())
    if not (np.isfinite(x_port).all() and err <= DECODE_TOL * peak):
        raise AssertionError(f"{flags}: decoded p_c off by {err} (peak {peak})")
    return err, peak


def main_path_phase():
    from kwave_tpu_torch.ops import encode_window as ew

    runs = [  # (flags, windows, tail, the variant it takes)
        (["--p_raw", "--p_c", "--40-bit_complex"], 8, 5, "w40_overlap"),
        (["--p_raw", "--p_c", "--no_overlap"], 3, 5, "wfloat_no_overlap"),
        (["--p_raw", "--p_c", "--40-bit_complex", "--no_overlap"], 3, 5, "w40_no_overlap"),
        (["--p_raw", "--p_c"], 3, 5, "wfloat_overlap"),
    ]
    _run(runs[0][0], 1, 3)  # warm-up: CUDA context, cuFFT plans (not counted)
    ew.reset_launch_counts()
    float_run = None
    for flags, windows, tail, variant in runs:
        before = dict(ew.LAUNCHES)
        out, secs, steps = _run(flags, windows, tail)
        delta = {k: ew.LAUNCHES[k] - before[k] for k in ew.LAUNCHES}
        calls = windows + (1 if tail else 0)  # full windows + the trailing partial one
        want = {k: (calls if k == variant else 0) for k in ew.LAUNCHES}
        if delta != want:
            raise AssertionError(f"{flags}: launches {delta}, expected {want}")
        err, peak = _check_run(out, flags, steps)
        sim_ms = float(out.attrs["simulation_phase_execution_time"]) / steps * 1e3
        print(f"[4 main path] {' '.join(flags)}: {GRID_N}^3, {N_SENSORS} sensors, "
              f"{steps} steps ({windows} windows + {tail}-step tail), "
              f"{sim_ms:.3f} ms/step in the simulation phase, "
              f"{secs / steps * 1e3:.3f} ms/step end to end; {variant} launched "
              f"{delta[variant]}x; Nc={steps // O_SIZE}; p_c == oracle(p_raw) bytes on "
              f"{ORACLE_SENSORS} sensors, decoded diff {err:.3g} (peak {peak:.3g})",
              flush=True)
        if flags == ["--p_raw", "--p_c"]:
            float_run = (out, steps)  # decoded on the card in phase 6
    return dict(ew.LAUNCHES), float_run


def main() -> int:
    if not (ROOT / "kwave_tpu_torch").is_dir():
        print("chip_smoke.py: kwave_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; needs an NVIDIA card",
              file=sys.stderr)
        return 2
    # full fp32 for every plain version: a TF32 matmul would be ~1e-3 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    name, smi = device_phase()
    print(f"[1 device] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}, float32_matmul_precision="
          f"{torch.get_float32_matmul_precision()}", flush=True)
    build_phase()
    kernels = kernel_phase()
    launches, float_run = main_path_phase()
    codec = codec_kernel_phase()
    codec_launches = codec_round_trip_phase(*float_run)

    rows = [dict(name=key, route="cuda", source="kwave_tpu_torch/csrc/encode_window.cu",
                 replaces=VARIANTS[key][2], launches=launches[key], **kernels[key])
            for key in VARIANTS]
    rows += [dict(name=key, route="cuda", source="kwave_tpu_torch/csrc/fastpath.cu",
                  replaces=replaces, launches=codec_launches[key], **codec[key])
             for key, (_, replaces) in CODEC_KERNELS.items()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
