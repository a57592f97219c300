#!/usr/bin/env python3
"""Smoke test of kwave_tpu_torch on one NVIDIA card: builds the CUDA kernels from the
sources in this checkout, holds each against its plain PyTorch version and the NumPy
oracle, then drives the port's paths: the simulation at 128^3 with 16384 index sensors,
the codec round trip, the whole-record exact encode, the 256^3, 192^3, 220^3, 230^3 and
251^3 simulations and a 6 x 1152 x 1152 slab with the fused z stage (K7's radix, mixed,
Bluestein and column kernels), a run in checkpoint legs with the intensity and Q-term
outputs, the
acceptance sweep's inputs on the card against the port on the CPU, the mesh
(`kwave_tpu_torch.parallel`) on the one card, the windows replayed as CUDA graphs on
one card and on the mesh, and the CLI on HDF5 files through the port's own codec.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and the script exits non-zero without
the final ok line):
1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc builds csrc/*.cu into build/kwave_tpu_torch/ (timed);
3. kernel parity: the four window-encode variants at o=16, H=1, 2 and 3, N=16384 and a
   ragged N=16384-37, both parities, the mirror on and off and a partial window of 11
   steps, bit for bit against their plain versions on the card; for the 40-bit variants also
   the reference's loop as written, to the same bits, and one window whose values lie
   below, inside and above the 40-bit word's range; H=1 and 2 against
   kwave_tpu_torch.oracle on the first 256 sensors; kernel and plain time per window from
   CUDA events;
4. main path: `driver.run_simulation` on a 128^3 heterogeneous absorbing medium with a
   p0 source, period 16, a few windows plus a tail, as ``--p_raw --p_c --40-bit_complex``
   and then as three shorter runs that take the other three variants. The output goes
   to an in-memory group (phase 14 runs the same input through files). Checks: each variant launched
   once per window-encode call, Nc == steps // o, the p_c bytes equal the oracle's
   encoding of p_raw on the first 256 sensors and decode to within 1e-3 of the series
   peak, no NaN. Prints ms/step.
5. codec kernels: the projection encode (K5, both entries) at the codec round trip's
   full shape (T=4096, N=16384, period 20, H=2), and at H=1, H=4 and a ragged N, against
   its plain version and a float64 projection (within 1e-6 of the frame peak) and the
   oracle's float encoder on 256 sensors (2e-6); flat == 3D bit for bit; K6 window by
   window == K5 bit for bit; dyadic data bit-exact; one call of each encode entry (K5 flat
   and 3D, K6) under torch.profiler runs its one kernel on the device and nothing else. The synthesis decode (K4, both
   entries) on the same frames and on five boundary cases, against plain (1e-6 of the
   peak) and `kwave_tpu_torch.oracle.reconstruct` on 256 sensors (4e-6). Kernel and plain
   times at the full shape from CUDA events, and wall time per call; beside them one
   PyTorch call for each kernel's function (K5 and K6 an einsum over the series'
   overlapping windows, K4 a transposed convolution), held to the kernel (1e-4 of the
   peak) and timed, used nowhere in the port;
6. codec round trip: `kwave_tpu_torch.bench` at bench.py's shape (GB/s,
   actual_bytes_value, ceiling, fraction, the err < 0.02 guard), one encode and one
   decode launch per round trip; a shorter chain through the 3D entries; the same
   series encoded window by window through K6, equal to the whole-series frames; and
   phase 4's float `p_c` decoded by `decoder.reconstruct_frames` (K4) against the oracle.
7. whole-record exact encode (path A): bench.py's record uncut (T=4096 and a 7-step tail,
   N=16384, period 20, H=2), all four variants. The two entries of
   `ops.encode_series` bit for bit against their plain versions, the K1/K2 window loop
   and the oracle on 256 sensors; then `encoder.encode_series_exact` with the counts set
   to 0 first (one whole-record launch, one partial-window launch), its frames through
   `frames_to_flat_*` equal to the oracle's bytes, its final state equal to the
   oracle's, and the float frames decoded through K4 against `oracle.reconstruct`. Then a
   record of 13 windows (odd, no multiple of the 8 windows a thread) against the unsplit
   plain version and the window loop, and the same record cut at 3 windows a thread
   (chunks that start on odd and on even windows), bit for bit.
8. fused z stage (path B), K7's four kernels (column: the short nz of
   `ops.zfuse.COLUMN_NZ`; radix: nz a power of two from 32; mixed: other nz with prime
   factors up to 13, or all but one prime up to `ops.zfuse.PRIME_MAX` (a generic pass);
   Bluestein: the rest): (a) K7 at the
   spectra of 256^3 (radix, and mixed through a plan that names it), 192^3 (mixed)
   and, with the operators of a homogeneous medium of the same recipe, 384^3, 320^3 and
   448^3 (mixed), 176^3 and 208^3 (mixed with radix 11 / 13), 230^3 (mixed with the
   generic pass of 23, and Bluestein), 251^3 (Bluestein, M = 512), 1009 x
   128 x 128 (Bluestein, M = 2048; its rows name the tile width, the blocks an SM and the
   staged tables, and time `apply_bluestein_plain` too) and 4 x 256 x 256, 6 x 256 x 256
   (column, and mixed through a plan that names it: the kernel nz below 8 took before),
   one op and three, against a float64 FFT (2e-6 of
   the peak) and the kernel's own plain version (4e-6), timed beside `apply_plain` and the
   library route ``ifft(fft(s, 0) * op, 0)``, its launches counted under the kernel that
   took them; (b) small spectra (ny = 8) at nz = 64, 128, 512 (radix), 2, 6, 8, 11, 13, 15,
   16 (column), 17, 22, 24, 60, 96, 100, 110, 176, 230, 448, 1000, 1331, 1536 (mixed) and
   127, 251, 1009, 1699, 1709 (Bluestein), each through the kernel `kernel_for` names,
   against the same two; (c) `run_simulation` at 256^3, 192^3, 220^3 (4 x 5 x 11), 230^3 (23 x 2 x 5),
   251^3 (a prime) and the thin slab 6 x 1152 x 1152 (7.96 M points, a PML of 1 cell in
   z), 16384 sensors, ``--p_raw --p_c --40-bit_complex``, 2 windows and a
   5-step tail, once with compact operators alone and once with ``fuse_z``: p_raw of the
   two within 1e-4 of the peak, each run's p_c bytes equal to the oracle's encoding of its
   own p_raw, every K7 launch the kernel `kernel_for` names (radix, mixed, mixed, mixed,
   Bluestein, column), ms/step of both, and the device time by kernel of one profiled
   window of each (of the fused run alone at 230); at 220, 251 and the slab both runs are
   read a second time after the first two, to tell the first use of the grid's FFT plans
   and buffers, which the first run of a grid pays, from the steps.
9. checkpoint legs and the intensity / Q-term outputs: `run_simulation` at phase 4's
   width (128^3, 16384 index sensors, period 16, H = 1) as ``--p_raw
   --u_non_staggered_raw --p_c --u_non_staggered_c --40-bit_complex --I_avg_c --Q_term_c
   --I_avg --Q_term``, 6 windows and a 5-step tail, every file an in-memory group: run A
   in one leg, run B in four (a checkpoint every 2 windows, so three legs of 2 windows
   and one of the 5 trailing steps, each a fresh `run_simulation(resume_from=...)` on
   the reopened output). Checks: every dataset of B
   equals A's bit for bit; A's I*_avg on the first 256 sensors against a float64 numpy
   time shift and mean, its I*_avg_c against the oracle's decode of the stored p_c and
   u*_non_staggered_c frames averaged in float64, its Q_term and Q_term_c against a
   float64 numpy spectral divergence of the scattered intensities (the intensities
   within 1e-5 of the peak; Q within 1e-6 of k_max |I|max, the size of the terms that
   its derivatives sum and cancel); the 40-bit window kernel launched 4 x (windows + 1) times in A and in B
   (four compressed streams; no window encoded twice across a leg boundary). The record's
   101 steps leave its spectrum without a Nyquist bin, so `postproc.time_shift_half_step`
   is also held to float64 numpy at 96 steps. Prints ms/step of A and B, seconds per
   checkpoint write and per resume, seconds of the post-processing, and the device time
   by kind of kernel of one profiled window of the loop.
10. the acceptance inputs on the card: (a) every input of the CPU acceptance sweep
   (tests/acceptance_cases.py: 2D, p sources in modes 0/1/2 with one series and many, u
   sources, a transducer, nonuniform maps, nonlinear and absorbing media, cuboids, tiny
   and one-window records, legs, ``--post``; and, the card's alone, nz = 100 with the
   fused z stage, the mixed K7 inside a real run) run by the port on the card and on
   the CPU in this process: every dataset's name, layout and attributes equal, data
   within rel L2 1e-4, 40-bit rows decoded first (where they are above it, each
   coefficient within 2o steps of the word's absolute quantum, and the line names them),
   and the CPU's p series encoded on the card to the CPU's p_c bytes; (b) phase 9's input at full width (128^3, 16384
   sensors, 2 windows and a 5-step tail) with ``--p_raw --u_non_staggered_raw --p_c
   --u_non_staggered_c --40-bit_complex --I_avg --Q_term --p_max --p_rms``, card
   against CPU likewise (the shifted velocity's Nyquist bin at the size users run), and
   for the 40-bit dataset of the largest rel L2 the coefficient farthest apart (frame row,
   sensor, harmonic, part), both values and their distance in steps of the word, the
   coefficient parts counted by steps apart, and the rel L2 without the parts at most one
   step apart (`acceptance_cases.worst_40bit`);
   (c) `solver.simulate` on the card: the standing wave (2D, 3D, 3D fused: radix K7)
   against its closed form (5e-3) and acoustic reciprocity (1e-4 of the peak). Prints
   the window kernels' and K7's launches (by kernel).
11. the mesh on the one card (in-process meshes list `cuda:0` S times): (a) phase 8's
   256^3 input with ``--p_raw --p_c --40-bit_complex --p_max_all --p_final``, 2 windows
   and a 5-step tail, after a 3-step warm-up of each layout, on one device and on 4, 2
   and 1 shards: K1a launched once a window and once for the tail on every shard; p and
   p_max_all within rtol 2e-5 / atol 2e-6 of their own peaks of the one-device run
   (tests/test_dist_step.py's), p_final within atol 5e-6 of its own (FINAL_ATOL: the
   pencil's and the 3D transforms' roundings, read against two witnesses below), p_c
   decoded within 1e-3 of its peak, and the mesh run's p re-encoded on one device == its
   p_c bytes; ms/step of each; 4 and 2 shards against the unsharded pencil (1 shard)
   within 2e-6 of each peak, p_final too, and whether they are equal bit for bit; the
   one-device run against itself with p0 tripled (its fields' own rounding), and two
   faults that the p_final check must catch (fp16, a slab out of order); (b) the pencil
   FFT alone at 256^3 on 2 and 4 shards against torch.fft (1e-5 of the peak: rfftn, the
   round trip, a kappa multiply) and the bytes and device time of one z-for-y trade; (c)
   every spectral multiplier of the step (ddk_pos / ddk_neg with kappa, the nablas,
   source_kappa) and the three half-cell shifts, one axis at a time, on 4 shards against
   one device at 128^3 and 256^3 (rel L2 1e-5: a Nyquist bin that cuFFT keeps shows as
   0.07), and a 128^3 run with ``--u_non_staggered_raw --I_avg --Q_term`` on 4 shards
   against one device (rel L2 1e-4; Q within 1e-6 of k_max |I|max, as phase 9); (d)
   `initialize` at world size 1 over NCCL, `make_mesh()` a process mesh, (a)'s input
   through it cold (the group's first run) and warm against (a)'s one-device run, and
   one profiled window of it and of the one-shard in-process mesh (kernel time by kind,
   the host's busiest operations); (e) the 4-shard run in one leg and in four (a
   checkpoint every window), bit for bit, and its first checkpoint resumed on one device
   against the one-leg run. Every part runs and reports before the phase fails on any of
   them.
12. the window as one device program (CUDA graphs of the window, `driver.make_window_fn`):
   phase 4's 128^3 main path, phase 8's 256^3 unfused and fused (radix K7), 251^3 fused
   (Bluestein) and the 6 x 1152 x 1152 slab fused (column), each as runs of 13 windows
   and a 5-step tail with every window eager (``RunConfig.cuda_graphs=False``, each
   window through `driver._run_window`) and with graphs, in the order eager, graphs,
   graphs, eager. Checks: the runs equal bit for bit, with equal launches of every
   kernel; every graph run's windows as `driver.plan_windows` says (1 eager, 2 captured,
   10 replayed). Prints warm ms/step each way (the median time from one window's start
   to the next's, from the fourth window on, over o) beside the simulation phase's
   ms/step, device ms/step of an eager 6-window run and of replayed windows (the
   profiler's kernels; CUDA events around the replays beside them), the idle share each
   way, capture and instantiation per key, and peak memory (allocated, reserved). Then the main path's other three variants, 6 windows and a tail, with
   graphs against eager, bit for bit, each variant launched once per window-encode call
   both ways. Phases 4 and 9 run through graphs too (their runs of 8 and 6 windows
   replay from the fourth window on), and phase 4 holds its runs' windows to the plan.
13. the mesh's window as one device program (CUDA graphs over the pencil FFT's trades):
   phase 11 (a)'s 256^3 input on 4 shards of cuda:0 in one process, then through a
   process group of one over NCCL, each as a cell of phase 12 (13 windows and a 5-step
   tail, eager, graphs, graphs, eager; bit for bit, equal launches, the windows as
   planned; warm and device ms/step, idle share, capture per key, peak memory); then that
   group with 2 shards of cuda:0 (C = 2 shards a rank: one slot group a shard, split from
   the default group), eager and with graphs in turns, bit for bit to 2 shards of cuda:0
   in one process, its K1a launches printed. The `kernels` line's
   ``launches_mesh_graph_path`` is the phase's count of each window kernel.
14. the file edge (`kwave_tpu_torch.io.h5file`, the port's own HDF5 reader and writer):
   phase 4's input written by the port's `write_input_file`, then `cli.main(["-i", in,
   "-o", out, "--p_raw", "--p_c", "--40-bit_complex", "--period", "16"])` at 8 windows
   and at 64, a 5-step tail each; the 8-window run again as a ``python -m
   kwave_tpu_torch.cli`` process, in two legs through ``--checkpoint_file`` (5 windows,
   then 3 and the tail) and with ``-c 4``; and the other three variants at 3 windows.
   Each output read back through the codec. Checks: every dataset bit for bit the
   in-memory run of the same input (``-c 4``: the values, and deflate at level 4 on p
   and p_c), the 64-window p_c the oracle's encoding of its p, each variant's kernel
   launched once a window-encode call. Prints simulation-phase ms/step on files and in
   memory, the seconds spent in the codec's writes and ``close()``, the file sizes and
   MB/s over the codec's seconds, with the card's name and power limit; the `kernels`
   line's ``launches_file_path`` is the phase's count of each window kernel.
Then one JSON line with every kernel's numbers (its time beside its bound: the larger of
its bytes over 3.35 TB/s and its fp32 operations over 67 TFLOP/s; ``launches`` the count
of the kernel's path, which must be above 0; ``launches_graph_path`` phase 12's count,
launches replayed from graphs included), and as the last line
``{"ok": true, "device": {...}}``. TF32 is off throughout, so every plain version on the
card computes in full fp32.

``python3 chip_smoke.py --main-path-readings N [--main-path-windows W] [--package-from
DIR]`` runs none of the phases: it builds the kernels and prints N readings of phase 4's
first run (or of the same run at W windows) as one JSON line, with the package of DIR
where that is given. Two commits are compared by running
it for each in turns, several processes a commit, in one session on one card.

``python3 chip_smoke.py --mesh-processes N`` (N cards) runs none of the phases either:
phase 11 (a)'s input at 256^3 and 512^3, 13 windows and a 5-step tail, as N processes
over NCCL, one card each, with every window eager and with graphs in turns (eager,
graphs, graphs, eager; the graph run equal to the eager one bit for bit, launches
equal), held to card 0 alone (run both ways too), with warm and simulation-phase
ms/step of each run. With ``--cards-per-process C`` (N x C cards) each process drives C
cards (the JAX package's multi-process mesh, P processes x C local devices): each rank
reads both grids as ``--mesh-cards`` reads them (eager and graphs in turns, bit for bit;
warm, simulation-phase and replayed device ms/step, idle share, capture per key, one
trade) and saves phase 11 (a)'s 37 steps at 256^3, which N x C one-card processes save
too; this process holds both, bit for bit, to ``--devices N x C`` in one process and to
N x C shards of cuda:0.

``python3 chip_smoke.py --mesh-cards N`` (N cards) runs none of the phases either: the
in-process mesh over N cards that ``--devices N`` builds (one shard a card, the trades
peer copies), whose windows and lead-in are one CUDA graph across the cards. First the
probe (`cards_probe`: a pencil program captured across the cards without the package's
`graphs.Graphs`, replayed against its eager steps bit for bit, eager tensors untouched);
then phase 11 (a)'s input at 256^3 and 512^3, 13 windows and a 5-step tail, eager and
with graphs in turns (bit for bit, launches equal; warm, simulation-phase and replayed
device ms/step, idle share, capture per key, peak memory a card); then phase 11 (a)'s
37 steps at 256^3 held to card 0 alone and bit for bit to N shards of cuda:0 and to N
processes over NCCL (`--mesh-processes`' ranks, which save their output); and the
reading of p_final over the 213 steps of the graph run against card 0 alone. It prints
the window kernel's launches in its graph runs (``launches_cards_graph_path``) and ends
with the ok line, its ``count`` N.
"""

from __future__ import annotations

import argparse
import functools
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

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12  # fp32 outside the tensor cores

SERIES_TAIL = 7  # path A: steps after the last whole window
BIG_N = 256  # path B's grid
ZFUSE_TOL = 2e-6  # K7 vs a float64 FFT, of the peak
# K7 vs apply_plain: the dense fp32 sum is itself up to 1.3e-6 off float64 at nz = 256, the
# radix kernel 2e-7, so the two are held to the sum of their bounds
ZFUSE_PLAIN_TOL = 4e-6
FUSED_RUN_TOL = 1e-4  # p_raw of the fused run vs the compact-only run, of the peak

# phase 9: the run in legs
LEGS_FLAGS = ["--p_raw", "--u_non_staggered_raw", "--p_c", "--u_non_staggered_c",
              "--40-bit_complex", "--I_avg_c", "--Q_term_c", "--I_avg", "--Q_term"]
LEGS_WINDOWS, LEGS_TAIL, LEG_WINDOWS = 6, 5, 2  # the record; windows between checkpoints
INTENSITY_TOL = 1e-5  # I*_avg, I*_avg_c vs float64 numpy, of the peak
Q_TOL = 1e-6  # Q_term[_c] vs float64 numpy, of k_max |I|max (see `_intensity_checks`)


RAGGED = 37  # sensors short of N_SENSORS in phase 3's ragged windows


def _bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: every input byte read once and every output
    byte written once at the HBM rate, or the fp32 operations at the peak rate."""
    terms = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / FP32_FLOP_PER_S * 1e3}
    by = max(terms, key=terms.get)
    return dict(bound_ms=terms[by], bound_by=by)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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

    @property
    def dtype(self):
        return self.data.dtype

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

    def __contains__(self, name):
        return name in self.items

    def __delitem__(self, name):
        del self.items[name]

    def keys(self):
        return self.items.keys()


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


def _window_planes(mode40, overlap, h, n, seed):
    """Nonzero starting accumulators [h, n] of one variant, on the card."""
    import torch

    from kwave_tpu_torch import bitpack
    from kwave_tpu_torch.basis import MAX_EXP_P

    rng = np.random.default_rng(seed)
    vals = [torch.from_numpy((1e5 * rng.standard_normal((h, n))).astype(np.float32)).cuda()
            for _ in range(4)]
    if not mode40:
        return tuple(vals[: 4 if overlap else 2])
    planes = bitpack.encode40(vals[0], vals[1], MAX_EXP_P) + bitpack.encode40(
        vals[2], vals[3], MAX_EXP_P)
    return tuple(p.contiguous() for p in planes[: 6 if overlap else 3])


def _edge_window_check(key, overlap) -> None:
    """One 40-bit window whose values leave the word's range on both sides: samples over
    100 binades (zeros and a denormal row among them) against table entries that put the
    two halves of an accumulator up to 30 binades apart, H=16, a ragged N. Kernel == plain
    == the reference's loop as written, bit for bit."""
    import torch

    from kwave_tpu_torch.basis import MAX_EXP_P
    from kwave_tpu_torch.ops import encode_window as ew

    rng = np.random.default_rng(31)
    o, h, n = 6, 16, 4099
    gaps = 2.0 ** -rng.integers(0, 31, (2 * o, 4 * h))
    tabs = torch.from_numpy((rng.choice([-1.0, 1.0], gaps.shape) * gaps
                             * rng.uniform(0.5, 1.0, gaps.shape)).astype(np.float32)).cuda()
    mag = 2.0 ** rng.integers(-60, 41, (o, n)) * rng.uniform(1.0, 2.0, (o, n))
    x = (rng.choice([-1.0, 1.0], mag.shape) * mag).astype(np.float32)
    x[:, ::11] = 0.0
    x[2, ::5] = 1e-40
    chunk = torch.from_numpy(x).cuda()
    planes = _window_planes(True, overlap, h, n, seed=5)
    for parity, mirror in ((0, 1), (1, 0)):
        args = (chunk, tabs, planes, MAX_EXP_P, parity, mirror, overlap)
        got = ew.encode_window_40b_exact(*args)
        torch.cuda.synchronize()
        for name, want in (("plain", ew.encode_window_40b_exact_plain(*args)),
                           ("unsplit plain",
                            ew.encode_window_40b_exact_unsplit_plain(*args))):
            _require(all(_bits_equal(a, b) for a, b in zip(got, want)),
                     f"{key}: edge-value window (parity {parity}, mirror {mirror}): kernel "
                     f"!= {name}")


def kernel_phase():
    """All four variants at the main path's shapes, against plain and oracle."""
    import torch

    from kwave_tpu_torch import oracle
    from kwave_tpu_torch.basis import MAX_EXP_P, generate_basis
    from kwave_tpu_torch import bitpack, encoder
    from kwave_tpu_torch.ops import encode_window as ew

    results, worst_lib = {}, {}
    for key, (mode40, overlap, _) in VARIANTS.items():
        worst = 0.0
        if mode40:
            extra = (MAX_EXP_P,)
            kern, plain = ew.encode_window_40b_exact, ew.encode_window_40b_exact_plain
            # the reference's loop as written
            others = {"unsplit plain": ew.encode_window_40b_exact_unsplit_plain}
        else:
            extra, others = (), {}
            kern = ew.encode_window_float_exact
            plain = ew.encode_window_float_exact_plain
        for h in (1, 2, 3):
            basis = generate_basis(float(O_SIZE), 1, h, normalize=True)
            tabs = _tables(basis)
            x = torch.from_numpy(_series(3 * O_SIZE, N_SENSORS, seed=h)).cuda()
            # (a) one window from nonzero state, per parity and mirror, a partial window,
            # the full and a ragged N: kernel == plain, and so does the reference's loop
            for n in (N_SENSORS, N_SENSORS - RAGGED):
                planes = _window_planes(mode40, overlap, h, n, seed=h)
                for steps, parity, mirror in ((O_SIZE, 0, 0), (O_SIZE, 0, 1), (O_SIZE, 1, 0),
                                              (O_SIZE, 1, 1), (O_SIZE - 5, 1, 0)):
                    chunk = x[:steps, :n].contiguous()
                    args = (chunk, tabs, planes, *extra, parity, mirror, overlap)
                    got, want = kern(*args), plain(*args)
                    torch.cuda.synchronize()
                    what = f"{key} H={h} N={n} steps={steps} parity={parity} mirror={mirror}"
                    _require(all(_bits_equal(a, b) for a, b in zip(got, want)),
                             f"{what}: kernel != plain")
                    for name, other in others.items():
                        _require(all(_bits_equal(a, b) for a, b in zip(other(*args), want)),
                                 f"{what}: {name} != plain")
                    if mode40:  # decoded values, for the error column
                        for k in range(0, len(got), 3):
                            for d1, d2 in zip(bitpack.decode40(*got[k:k + 3], MAX_EXP_P),
                                              bitpack.decode40(*want[k:k + 3], MAX_EXP_P)):
                                worst = max(worst, float((d1 - d2).abs().max()))
                    else:
                        for a, b in zip(got, want):
                            worst = max(worst, float((a - b).abs().max()))
            if h == 3:
                continue
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
                chunk = x[:O_SIZE].contiguous()
                planes = _window_planes(mode40, overlap, h, N_SENSORS, seed=h)
                args = (chunk, tabs, planes, *extra, 0, 0, overlap)
                ms, wall = _time_per_call(lambda: kern(*args), iters=200, warmup=20)
                plain_ms, plain_wall = _time_per_call(lambda: plain(*args), iters=10,
                                                        warmup=2)
                # the chunk and the table in, each plane in and out; 4 products and 4
                # sums per sensor and step; the 40-bit requantisation is integer work
                bound = _bound(_nbytes(chunk, tabs, *planes, *planes),
                               8.0 * O_SIZE * N_SENSORS)
                lib_ms = None
                if not mode40:  # the float window as one library call: planes + tab^T x
                    lib_ms, lib_err = _window_library_call(args, kern, overlap, h)
                    worst_lib[key] = lib_err
        if mode40:
            _edge_window_check(key, overlap)
        results[key] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, **bound,
                            library_ms=lib_ms)
        print(f"[3 kernel] {key}: bit-exact vs plain (H=1,2,3; N={N_SENSORS} and "
              f"{N_SENSORS - RAGGED}; parity 0/1, mirror 0/1, a window of {O_SIZE - 5} steps"
              + (f"; also {', '.join(others)}; and a window of values below, inside and "
                 f"above the word's range" if others else "") + f") and "
              f"vs oracle ({ORACLE_SENSORS} sensors, 3 windows, H=1,2); per window at "
              f"o={O_SIZE} H=1 N={N_SENSORS}, device time: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms" + ("" if lib_ms is None else
                                    f", one torch.addmm {lib_ms:.4f} ms (off the kernel by "
                                    f"{worst_lib[key]:.1e} of the peak)")
              + f"; wall per call: kernel {wall:.4f} ms, plain {plain_wall:.4f} ms",
              flush=True)
    return results


def _window_library_call(args, kern, overlap: bool, h: int):
    """K2's function as one PyTorch call, timed and used nowhere in the port: the planes
    stacked [4H, N] (2H without overlap) plus the window's table rows transposed times the
    chunk (`torch.addmm`; without overlap the two half-tables summed first, so the two
    adds of the kernel become one, a difference of fp32 rounding). Held to the kernel
    within LIBRARY_TOL of the peak. Returns (device ms, error)."""
    import torch

    chunk, tabs, planes, parity = args[0], args[1], args[2], args[3]
    o = tabs.shape[0] // 2
    rows = tabs[parity * o: parity * o + chunk.shape[0]]
    if not overlap:
        rows = rows[:, :2 * h] + rows[:, 2 * h:]
    rows_t = rows.t().contiguous()
    stacked = torch.cat(planes).contiguous()
    lib = torch.addmm(stacked, rows_t, chunk)
    err = _rel_err(lib, torch.cat(kern(*args)))
    _require(err <= LIBRARY_TOL, f"the window's library call is off the kernel by {err:.3g}")
    ms, _ = _time_per_call(lambda: torch.addmm(stacked, rows_t, chunk), iters=200, warmup=20)
    return ms, err


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
    from kwave_tpu_torch import oracle

    frames = oracle.OracleEncoder(basis, x_host.shape[1],
                                  total_steps=x_host.shape[0]).encode_series(x_host)
    return np.stack([np.concatenate([fr.T, fi.T]) for fr, fi in frames])


def _oracle_reconstruct(frames, basis, n_steps):
    from kwave_tpu_torch import oracle

    f = frames[:, :, :ORACLE_SENSORS].cpu().numpy()
    h = basis.harmonics
    return oracle.reconstruct(np.swapaxes(f[:, :h], 1, 2), np.swapaxes(f[:, h:], 1, 2),
                              basis, False, n_steps)


def codec_kernel_phase():
    """K5 (both entries), K6 and K4 (both entries) against plain, float64 and oracle."""
    import torch

    from kwave_tpu_torch.basis import generate_basis
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


def _device_events(fn) -> dict:
    """Name -> count of everything the device ran during one call of ``fn`` (kernels,
    copies, memsets), from torch.profiler. A trace with no device activity at all, which
    the profiler now and then gives for a call of a few microseconds, shows nothing either
    way: the call is traced again, three times at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # not the first call: the build and the allocator's first blocks are set-up
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = {e.key: e.count for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")}
        if events:
            break
    return events


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
    # a call of an encode entry runs its kernel on the device, and nothing else
    for name, call, kernel in (
            ("encode_frames_flat", lambda: fp.encode_frames_flat(x, lo, hi, o),
             "project_frames"),
            ("encode_frames", lambda: fp.encode_frames(x, lo, hi, o), "project_frames"),
            ("encode_window_float", lambda: ew.encode_window_float(chunk, lo, hi, p1),
             "project_window")):
        events = _device_events(call)
        _require(len(events) == 1 and sum(events.values()) == 1
                 and kernel in next(iter(events)),
                 f"{name} ran on the device, besides one {kernel}: {events}")
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
    # series or frames in, the other out, the table; 2 flop per sample, window half and
    # coefficient component
    flops = 2.0 * CODEC_T * CODEC_N * 2 * (2 * CODEC_H)
    bounds = {
        "encode_frames_flat": _bound(_nbytes(x, lo, hi, frames), flops),
        "reconstruct_series_flat": _bound(_nbytes(frames, tab4, rec), flops),
        "wfloat_projection": _bound(_nbytes(chunk, lo, hi, p1, p1, p1),
                                    flops / (CODEC_T // o)),
    }
    bounds["encode_frames"] = bounds["encode_frames_flat"]
    bounds["reconstruct_series"] = bounds["reconstruct_series_flat"]
    library, lib_errs = _codec_library_calls(x, frames, rec, lo, hi, tab4, o)
    parts = []
    for key, (kern, plain) in timed.items():
        ms, wall = _time_per_call(kern, iters=50, warmup=5)
        plain_ms, plain_wall = _time_per_call(plain, iters=10, warmup=2)
        lib_ms, _ = _time_per_call(library[key], iters=10, warmup=2)
        results[key] = dict(max_abs_err=errs[key], ms=ms, plain_ms=plain_ms, **bounds[key],
                            library_ms=lib_ms)
        parts.append(f"{key} {ms * 1e3:.1f} us (wall {wall * 1e3:.1f} us), plain "
                     f"{plain_ms * 1e3:.1f} us (wall {plain_wall * 1e3:.1f} us), library "
                     f"{lib_ms * 1e3:.1f} us")
    return (f"; library calls off the kernels by {lib_errs} of the peak; "
            f"each encode entry's call is one kernel on the device and nothing else "
            f"(torch.profiler); K4 off oracle {dec_orc:.2e} ({ORACLE_SENSORS} sensors); 5 "
            f"boundary cases "
            f"flat == 3D, worst {worst_case:.2e} off plain/oracle; dyadic K5 and K4 == plain "
            f"bit for bit; device time per call: " + "; ".join(parts))


LIBRARY_TOL = 1e-4  # a library call vs the kernel, of the peak: the same function


def _codec_library_calls(x, frames, rec, lo, hi, tab4, o):
    """One PyTorch call for each codec kernel's function, timed beside it and used nowhere
    in the port: K5 an einsum over the series' overlapping 2o-sample windows (frames 1 on;
    frame 0 is the mirror), K6 the same einsum over one window, K4 a transposed
    convolution (the product with the table and the overlap-add in one call; it covers
    the whole windows). Each is held to the kernel's result (LIBRARY_TOL of the peak).
    Returns LAUNCHES key -> call, and the errors."""
    import torch
    import torch.nn.functional as F

    h2 = lo.shape[1]
    tab = torch.cat([lo, hi])  # [2o, 2H]
    win = x[o:3 * o]  # the samples of frame 2
    fold = tab4 * (o / 2.0)  # the normalisation undo, as the kernel folds it
    weight = torch.cat([fold[:, h2:], fold[:, :h2]]).t().unsqueeze(1).contiguous()
    calls = {
        "encode_frames_flat": lambda: torch.einsum("knu,uj->kjn", x.unfold(0, 2 * o, o), tab),
        "wfloat_projection": lambda: torch.einsum("un,uj->jn", win, tab),
        "reconstruct_series_flat": lambda: F.conv_transpose1d(frames.permute(2, 1, 0), weight,
                                                              stride=o),
    }
    k = frames.shape[0]
    errs = {
        "K5": _rel_err(calls["encode_frames_flat"](), frames[1:]),
        "K6": _rel_err(calls["wfloat_projection"](), frames[2]),
        "K4": _rel_err(calls["reconstruct_series_flat"]()[:, 0, o:(k + 1) * o].t(),
                       rec[:k * o]),
    }
    _require(max(errs.values()) <= LIBRARY_TOL,
             f"a library call computes another function: {errs}")
    calls["encode_frames"] = calls["encode_frames_flat"]
    calls["reconstruct_series"] = calls["reconstruct_series_flat"]
    return calls, {k: float(f"{v:.2e}") for k, v in errs.items()}


def codec_round_trip_phase(float_out, float_steps):
    """The codec's entry points at full width with the counts set to 0 first: the bench
    chain (flat entries), a shorter chain through the 3D entries, the series encoded
    window by window through K6, and phase 4's float p_c decoded through K4."""
    import torch

    from kwave_tpu_torch.basis import generate_basis
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


SERIES_KERNELS = {
    # LAUNCHES key of ops.encode_series: (mode40, overlap, the TPU kernel it replaces)
    "series40_overlap": (True, True, "kwave_tpu/ops/encode_pallas.py:450"),
    "series40_no_overlap": (True, False, "kwave_tpu/ops/encode_pallas.py:450"),
    "seriesf_overlap": (False, True, "kwave_tpu/ops/encode_pallas.py:554"),
    "seriesf_no_overlap": (False, False, "kwave_tpu/ops/encode_pallas.py:554"),
}
ZFUSE_KERNELS = ("zfuse_1op", "zfuse_3op")  # LAUNCHES keys of ops.zfuse on path B
MIXED_N = 192  # phase 8 (c): the mixed kernel's run (compact operators turn on here)
# phase 8 (a): K7 alone at the spectra [nz, ny, nx/2 + 1] of these grids, through these
# kernels
K7_SPECTRA = (((384,) * 3, ("mixed",)), ((320,) * 3, ("mixed",)),
              ((448,) * 3, ("mixed",)), ((176,) * 3, ("mixed",)), ((208,) * 3, ("mixed",)),
              ((230,) * 3, ("mixed", "bluestein")),
              ((251,) * 3, ("bluestein",)), ((1009, 128, 128), ("bluestein",)),
              ((4, 256, 256), ("column", "mixed")), ((6, 256, 256), ("column", "mixed")))
# phase 8 (c): the runs after 256^3 and 192^3, each through the kernel kernel_for names:
# (nz x ny x nx, the runs profiled, the runs read again after both); the thin slab 6 x
# 1152 x 1152 (7.96 M points: compact operators by run_simulation's own rule) takes the column K7
FUSED_GRIDS = (((220,) * 3, ("compact", "fused"), ("compact", "fused")),
               ((230,) * 3, ("fused",), ()),
               ((251,) * 3, ("compact", "fused"), ("compact", "fused")),
               ((6, 1152, 1152), ("compact", "fused"), ("compact", "fused")))
K7_SOURCES = {"radix": "kwave_tpu_torch/csrc/zfuse.cu",
              "mixed": "kwave_tpu_torch/csrc/zfuse_mixed.cuh",
              "bluestein": "kwave_tpu_torch/csrc/zfuse_bluestein.cuh",
              "column": "kwave_tpu_torch/csrc/zfuse_column.cu"}


def _bits_equal(a, b) -> bool:
    import torch

    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _event_ms(fn):
    """(result, device ms) of one call, by CUDA events (for calls too long to repeat)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _decode40(planes):
    from kwave_tpu_torch import bitpack
    from kwave_tpu_torch.basis import MAX_EXP_P

    return bitpack.decode40(*planes, MAX_EXP_P)


ODD_WINDOWS, ODD_CHUNK = 13, 3  # a record of K odd, and a chunk that makes odd boundaries


def _odd_record_check(x, tabs, basis, tables, mode40, overlap) -> str:
    """The first 13 windows as a record of their own (at 8 windows a thread a chunk of 8
    and one of 5): frames and final state against the unsplit plain version and the K1/K2
    window loop, bit for bit; and the same bits from the kernel at 3 windows a thread
    (chunks that start on odd and on even windows, a last chunk of one window)."""
    from kwave_tpu_torch import encoder
    from kwave_tpu_torch.basis import MAX_EXP_P
    from kwave_tpu_torch.ops import encode_series as es

    o = basis.o_size
    head = x[:ODD_WINDOWS * o + 1]
    if mode40:
        frames, state = es.encode_series_40b(head, tabs, MAX_EXP_P, o, overlap)
        cut = es._kernel_40b(head, tabs, MAX_EXP_P, o, overlap, chunk_windows=ODD_CHUNK)
        pf, ps = es.encode_series_40b_plain(head, tabs, MAX_EXP_P, o, overlap)
    else:
        frames, state = es.encode_series_float_exact(head, tabs, o, overlap)
        cut = es._kernel_float(head, tabs, o, overlap, chunk_windows=ODD_CHUNK)
        pf, ps = es.encode_series_float_exact_plain(head, tabs, o, overlap)
    what = f"the {ODD_WINDOWS}-window record"
    _require(frames[0].shape[0] == ODD_WINDOWS
             and all(_bits_equal(a, b) for a, b in zip(frames + state, pf + ps)),
             f"{what}: kernel != plain")
    _require(all(_bits_equal(a, b) for a, b in zip(frames + state, cut[0] + cut[1])),
             f"{what}: {ODD_CHUNK} windows a thread != {es.chunk_windows_for(ODD_WINDOWS)}")
    cfg = encoder.EncoderConfig.for_stream(basis, False, mode40, overlap)
    st = encoder.init_state(cfg, head.shape[1], "cuda")
    for k in range(ODD_WINDOWS):
        st, fr = encoder.encode_chunk(st, head[k * o:(k + 1) * o], cfg, tables)
        _require(all(_bits_equal(a, b[k]) for a, b in zip(fr, frames)),
                 f"{what}: frame {k} != the window loop's")
    keys = [n for n in st if n not in ("sampled_step", "compressed_step")]
    _require(all(_bits_equal(st[n], p) for n, p in zip(keys, state)),
             f"{what}: final state != the window loop's")
    return (f"{what} == plain, == the window loop, == itself at {ODD_CHUNK} windows a "
            f"thread")


def series_phase():
    """Path A: the whole-record exact encode at bench.py's shape, four variants."""
    import torch

    from kwave_tpu_torch import bench, decoder, encoder, oracle
    from kwave_tpu_torch.basis import MAX_EXP_P, generate_basis
    from kwave_tpu_torch.ops import encode_series as es
    from kwave_tpu_torch.ops import encode_window as ew

    basis = generate_basis(CODEC_PERIOD, 1, CODEC_H, normalize=True)
    o, k_total = basis.o_size, CODEC_T // basis.o_size
    x = bench.make_series(CODEC_T + SERIES_TAIL, CODEC_N, CODEC_PERIOD, seed=3,
                          device="cuda")
    sub = np.ascontiguousarray(x[:, :ORACLE_SENSORS].cpu().numpy())
    tabs = _tables(basis)
    tables = encoder.make_tables(basis, False, "cuda")
    results, launches = {}, {}
    for key, (mode40, overlap, _) in SERIES_KERNELS.items():
        head = x[:CODEC_T]
        if mode40:
            kern = functools.partial(es.encode_series_40b, head, tabs, MAX_EXP_P, o, overlap)
            plain = functools.partial(es.encode_series_40b_plain, head, tabs, MAX_EXP_P, o,
                                      overlap)
        else:
            kern = functools.partial(es.encode_series_float_exact, head, tabs, o, overlap)
            plain = functools.partial(es.encode_series_float_exact_plain, head, tabs, o,
                                      overlap)
        # (a) the entry against its plain version (one run of it, timed) ...
        frames, state = kern()
        (pf, ps), plain_ms = _event_ms(plain)
        _require(all(_bits_equal(a, b) for a, b in zip(frames + state, pf + ps)),
                 f"{key}: kernel != plain")
        worst = 0.0
        if mode40:
            for k in (0, 3):
                got = _decode40((frames + state)[k:k + 3])
                want = _decode40((pf + ps)[k:k + 3])
                worst = max(worst, *(float((a - b).abs().max()) for a, b in zip(got, want)))
        else:
            worst = max(float((a - b).abs().max()) for a, b in zip(frames + state, pf + ps))
        del pf, ps
        # ... and against the K1/K2 window loop on the card
        cfg = encoder.EncoderConfig.for_stream(basis, False, mode40, overlap)
        st = encoder.init_state(cfg, CODEC_N, "cuda")
        for k in range(k_total):
            st, fr = encoder.encode_chunk(st, x[k * o:(k + 1) * o], cfg, tables)
            _require(all(_bits_equal(a, b[k]) for a, b in zip(fr, frames)),
                     f"{key}: frame {k} != the window loop's")
        keys = [n for n in st if n not in ("sampled_step", "compressed_step")]
        _require(all(_bits_equal(st[n], p) for n, p in zip(keys, state)),
                 f"{key}: final state != the window loop's")
        if not overlap:
            _require(not any(bool(p.any()) for p in state[len(keys):]),
                     f"{key}: the second set of state planes is not zero")
        # (b) the path, counts at 0: encode_series_exact -> frames_to_flat -> bytes
        es.reset_launch_counts()
        ew.reset_launch_counts()
        frames, st = encoder.encode_series_exact(x, basis, mode40=mode40, overlap=overlap)
        torch.cuda.synchronize()
        window_key = ("w40" if mode40 else "wfloat") + key[key.index("_"):]
        want = {**{n: int(n == key) for n in es.LAUNCHES},
                **{n: int(n == window_key) for n in ew.LAUNCHES}}
        _require({**es.LAUNCHES, **ew.LAUNCHES} == want,
                 f"{key}: launches {es.LAUNCHES} {ew.LAUNCHES}, expected {want}")
        launches[key] = es.LAUNCHES[key]
        enc = oracle.OracleEncoder(basis, ORACLE_SENSORS, mode40=mode40, overlap=overlap,
                                   total_steps=sub.shape[0])
        frames_o = enc.encode_series(sub)
        k_path = (CODEC_T + SERIES_TAIL) // o  # the longer record may hold a window more
        _require(len(frames_o) == k_path == frames[0].shape[0]
                 and st["sampled_step"] == CODEC_T + SERIES_TAIL
                 and st["compressed_step"] == k_path, f"{key}: frame or step count")
        cut = tuple(f[:, :, :ORACLE_SENSORS] for f in frames)
        if mode40:
            mine = encoder.frames_to_flat_40b(*cut)
            theirs = np.stack([oracle.soa_to_bytes(*fr) for fr in frames_o])
        else:
            mine = encoder.frames_to_flat_float(*cut).view(np.uint8)
            theirs = np.stack([np.stack(fr, -1).reshape(-1) for fr in frames_o]).view(np.uint8)
        _require(np.array_equal(mine, theirs), f"{key}: frame bytes != the oracle's")
        for n in keys:  # the live accumulators after the trailing steps
            got = st[n][:, :ORACLE_SENSORS].T.contiguous().cpu().numpy().view(np.uint32)
            ref = getattr(enc, n)
            ref = ref.astype(np.uint32) if mode40 else np.ascontiguousarray(ref).view(
                np.uint32)
            _require(np.array_equal(got, ref), f"{key}: state plane {n} != the oracle's")
        line = (f"[7 series] {key}: N={CODEC_N} H={CODEC_H} o={o}: T={CODEC_T}, {k_total} "
                f"frames and final state == plain, == the window loop; "
                f"encode_series_exact at T={CODEC_T}+{SERIES_TAIL}: {k_path} frames' bytes "
                f"and the state after the {(CODEC_T + SERIES_TAIL) % o}-step tail == oracle "
                f"({ORACLE_SENSORS} sensors), one whole-record launch and one "
                f"partial-window launch")
        if key == "seriesf_overlap":  # the float frames through the decode kernel
            packed = torch.cat(frames, dim=1).contiguous()  # [K, 2H, N]
            n_rec = k_path * o
            rec = decoder.reconstruct_frames(packed, tables["be_re"], tables["be_im"], o,
                                             n_rec)
            err = _rel_err(rec[:, :ORACLE_SENSORS],
                           torch.from_numpy(_oracle_reconstruct(packed, basis, n_rec)))
            _require(torch.isfinite(rec).all().item() and err <= ORACLE_DEC_TOL,
                     f"{key}: decoded frames off oracle.reconstruct by {err:.3g}")
            line += f"; decoded through K4 off oracle.reconstruct {err:.2e} of the peak"
        line += "; " + _odd_record_check(x, tabs, basis, tables, mode40, overlap)
        ms, wall = _time_per_call(kern, iters=20, warmup=2)
        # the K*o steps read and the table in; the frames and all state planes out
        f0, s0 = kern()
        flops = 8.0 * k_total * o * CODEC_N * CODEC_H
        lib_ms = None
        if not mode40:
            lib_ms, lib_err = _series_library_call(head, tables, f0, o, overlap)
            line += (f"; one torch.einsum over the windows {lib_ms:.4f} ms (off the kernel "
                     f"by {lib_err:.1e} of the peak)")
        results[key] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                            **_bound(_nbytes(x[:k_total * o], tabs, *f0, *s0), flops),
                            library_ms=lib_ms)
        del f0, s0, frames, st
        print(line + f"; device time per call: kernel {ms:.4f} ms (wall {wall:.4f} ms), "
              f"plain {plain_ms:.1f} ms (one call); bound "
              f"{results[key]['bound_ms']:.4f} ms by {results[key]['bound_by']}", flush=True)
    return results, launches


def _series_library_call(x, tables, frames, o: int, overlap: bool):
    """K3b's function as one PyTorch call, timed and used nowhere in the port: with overlap
    an einsum over the series' overlapping 2o-sample windows (`Tensor.unfold`, K5's call:
    frames 1 on; frame 0 is the mirror), without it over the o-sample windows on the
    summed half-tables. Held to the kernel's frames within LIBRARY_TOL of the peak.
    Returns (device ms, error)."""
    import torch

    k = x.shape[0] // o
    tab = torch.cat([tables["be_re"], tables["be_im"]], dim=1)  # [2o, 2H]
    got = torch.cat(frames, dim=1)  # [K, 2H, N]
    if overlap:
        def call():
            return torch.einsum("knu,uj->kjn", x[:k * o].unfold(0, 2 * o, o), tab)
        want = got[1:]
    else:
        half = tab[:o] + tab[o:]
        windows = x[:k * o].reshape(k, o, -1)

        def call():
            return torch.einsum("kun,uj->kjn", windows, half)
        want = got
    err = _rel_err(call(), want)
    _require(err <= LIBRARY_TOL, f"the record's library call is off the kernel by {err:.3g}")
    ms, _ = _time_per_call(call, iters=20, warmup=2)
    return ms, err


def _zfuse_cases(ops, n_ops):
    """(specs, dds, use_kappa) of the shapes the fused step launches: the three pressure
    gradients off one forward; one velocity gradient; one absorbing nabla."""
    from kwave_tpu_torch.ops import zfuse

    if n_ops == 3:
        return [(tuple(zfuse.OpSpec("grad", axis=a) for a in (2, 1, 0)),
                 (ops.ddx_pos, ops.ddy_pos, ops.ddz_pos), True)]
    return [((zfuse.OpSpec("grad", axis=0),), (ops.ddz_neg,), True),
            ((zfuse.OpSpec("nabla", power=ops.alpha_power - 2.0),), (), False)]


def _kernel_plan(plan, kernel: str):
    """``plan`` made to launch ``kernel`` (a plan field, so the same spectrum can be timed
    through another kernel than the one `make_plan` chose)."""
    import dataclasses

    from kwave_tpu_torch.ops import zfuse

    if kernel == plan.kernel:
        return plan
    return dataclasses.replace(plan,
                               **zfuse.kernel_tables(plan.nz, kernel, plan.roots.device))


def _own_plain(plan):
    """The plain version that computes what ``plan``'s kernel computes, step by step."""
    from kwave_tpu_torch.ops import zfuse

    return {"radix": zfuse.apply_radix_plain, "mixed": zfuse.apply_radix_plain,
            "bluestein": zfuse.apply_bluestein_plain}.get(plan.kernel, zfuse.apply_plain)


def zfuse_kernel_phase(ops, shape: tuple[int, int, int], kernels: tuple[str, ...]) -> dict:
    """K7 at the spectrum [nz, ny, nx/2 + 1] of ``ops``'s grid ``shape`` through each of
    ``kernels``, with one op and with three (`_zfuse_cases`): held to the kernel's own plain
    version and a float64 FFT, timed beside `apply_plain` and the library route (both timed
    once per op count), its launches counted under the kernel that took them. Returns the
    rows by name."""
    import torch

    from kwave_tpu_torch.ops import zfuse

    n, ny, nx = shape
    base = zfuse.make_plan(shape, ops.k2_z, ops.k2_y, ops.k2_x, ops.c_ref_dt_2, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)  # on the card: 448^3 in no time
    s = torch.fft.rfft2(torch.randn(shape, device="cuda", generator=gen)).contiguous()
    f64 = torch.fft.fft(s.to(torch.complex128), dim=0)
    results, others = {}, {}
    for key in ZFUSE_KERNELS:
        n_ops = int(key[6])
        specs, dds, use_kappa = _zfuse_cases(ops, n_ops)[0]
        opfull = [zfuse.full_operator(base, sp, dd, use_kappa).to(torch.complex64)
                  for sp, dd in zip(specs, dds)]

        def library():
            f = torch.fft.fft(s, dim=0)
            return [torch.fft.ifft(f * op, dim=0) for op in opfull]

        plain_ms, _ = _time_per_call(
            functools.partial(zfuse.apply_plain, base, s, specs, dds, use_kappa=use_kappa),
            iters=5, warmup=1)
        lib_ms, _ = _time_per_call(library, iters=10, warmup=2)
        del opfull
        # the spectrum and the vectors in, one spectrum per op out; operations as an FFT
        # would need them (5 n log2 n per transform and column, 8 per pointwise product),
        # since the bound is the least the card could take, not the dense DFT's count
        cols = base.ny * base.nxr
        flops = (1 + n_ops) * 5.0 * n * np.log2(n) * cols + n_ops * 8.0 * n * cols
        bound = _bound(_nbytes(s, base.k2z, base.k2y, base.k2x, *dds)
                       + n_ops * _nbytes(s), flops)
        others[n_ops] = dict(plain_ms=plain_ms, library_ms=lib_ms, **bound)
    for kernel in kernels:
        plan = _kernel_plan(base, kernel)
        zfuse.reset_launch_counts()
        for key in ZFUSE_KERNELS:
            n_ops = int(key[6])
            worst, worst_plain, worst_ref = 0.0, 0.0, 0.0
            for specs, dds, use_kappa in _zfuse_cases(ops, n_ops):
                outs = zfuse.apply(plan, s, specs, dds, use_kappa=use_kappa)
                torch.cuda.synchronize()
                plain = _own_plain(plan)(plan, s, specs, dds, use_kappa=use_kappa)
                dd_i = 0
                for spec, got, want in zip(specs, outs, plain):
                    dd = None
                    if spec.kind == "grad":
                        dd, dd_i = dds[dd_i], dd_i + 1
                    op = zfuse.full_operator(base, spec, dd, use_kappa)
                    ref = torch.fft.ifft(f64 * op, dim=0)
                    peak = float(ref.abs().max())
                    e_plain = float((got - want).abs().max())
                    e_ref = float((got - ref).abs().max())
                    _require(torch.isfinite(torch.view_as_real(got)).all().item()
                             and e_plain <= ZFUSE_PLAIN_TOL * peak
                             and e_ref <= ZFUSE_TOL * peak,
                             f"{kernel} K7 at nz={n}, {key} {spec}: off plain "
                             f"{e_plain / peak:.3g}, float64 {e_ref / peak:.3g} of the peak")
                    worst = max(worst, e_plain)
                    worst_plain = max(worst_plain, e_plain / peak)
                    worst_ref = max(worst_ref, e_ref / peak)
                    del ref
                del outs, plain
            specs, dds, use_kappa = _zfuse_cases(ops, n_ops)[0]
            ms, wall = _time_per_call(
                functools.partial(zfuse.apply, plan, s, specs, dds, use_kappa=use_kappa),
                iters=10, warmup=2)
            row = dict(max_abs_err=worst, ms=ms, **others[n_ops])
            layout = ""
            if kernel == "bluestein":  # its tile, and its own plain version's time
                tile = zfuse.bluestein_tile(plan.nz, plan.m, n_ops)
                row["tile"] = dict(tc=tile.tc, blocks=tile.blocks, staged=list(tile.staged),
                                   smem=tile.smem)
                row["own_plain_ms"], _ = _time_per_call(
                    functools.partial(zfuse.apply_bluestein_plain, plan, s, specs, dds,
                                      use_kappa=use_kappa), iters=3, warmup=1)
                layout = (f", tiles of {tile.tc} columns, {tile.blocks} blocks an SM, "
                          f"staged {list(tile.staged)}, {tile.smem} B of shared memory; "
                          f"apply_bluestein_plain {row['own_plain_ms']:.4f} ms")
            results[f"zfuse_{kernel}_{n_ops}op_nz{n}"] = dict(row, kernel=kernel, n_ops=n_ops)
            moved = (1 + n_ops) * _nbytes(s)
            print(f"[8 zfuse] {kernel} kernel (passes {plan.passes}, M {plan.m}{layout}), {key}: "
                  f"spectrum [{n}, {base.ny}, {base.nxr}], off plain at most "
                  f"{worst_plain:.2e} and float64 {worst_ref:.2e} of the peak; device time "
                  f"per call: kernel {ms:.4f} ms (wall {wall:.4f} ms, "
                  f"{moved / ms / 1e6:.0f} GB/s of the spectra), plain {row['plain_ms']:.4f} ms, library ifft(fft*op) "
                  f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms by "
                  f"{row['bound_by']}", flush=True)
        want = {k: sum(zfuse.LAUNCHES.values()) if k == kernel else 0
                for k in zfuse.KERNEL_LAUNCHES}
        _require(zfuse.KERNEL_LAUNCHES == want and want[kernel] > 0,
                 f"nz={n} did not go through the {kernel} kernel: {zfuse.KERNEL_LAUNCHES}")
    return results


# phase 8 (b): small spectra [nz, 8, 129] and the kernel each must take
SMALL_SPECTRA = ((64, "radix"), (128, "radix"), (512, "radix"), (2, "column"),
                 (6, "column"), (8, "column"), (11, "column"), (13, "column"),
                 (15, "column"), (16, "column"), (17, "mixed"), (22, "mixed"), (24, "mixed"),
                 (60, "mixed"), (96, "mixed"), (100, "mixed"), (110, "mixed"),
                 (176, "mixed"), (230, "mixed"), (448, "mixed"), (1000, "mixed"),
                 (1331, "mixed"), (1536, "mixed"), (127, "bluestein"), (251, "bluestein"),
                 (1009, "bluestein"), (1699, "bluestein"), (1709, "bluestein"))


def _zfuse_small_spectra():
    """K7 on small spectra [nz, 8, 129] (`SMALL_SPECTRA`): the radix kernel at two passes
    of equal and of unequal radix and at three; the column kernel at nz = 2 to 16 (one
    butterfly, or two with the twiddles between: 6, 15); the mixed kernel at radices 3, 5,
    7, 11 and 13, the generic pass of 17 and of 23, three and four passes and the widest
    tile (1536); the Bluestein kernel from M = 256 (127) to M = 4096 (1709). One op and
    three, against a float64 FFT and the kernel's own plain version."""
    import torch

    from kwave_tpu_torch.ops import zfuse

    ny, nx = 8, 256
    rng = np.random.default_rng(13)
    for nz, kernel in SMALL_SPECTRA:
        k2 = [(np.fft.fftfreq(m) * 2 * np.pi * m / 1e-2) ** 2 for m in (nz, ny)]
        k2.append((np.fft.rfftfreq(nx) * 2 * np.pi * nx / 1e-2) ** 2)
        plan = zfuse.make_plan((nz, ny, nx), *k2, 1e-5, "cuda")
        _require(plan.kernel == kernel, f"nz={nz}: the plan names {plan.kernel}, not {kernel}")
        sizes = (nz, ny, plan.nxr)
        s = torch.from_numpy((rng.standard_normal(sizes) + 1j * rng.standard_normal(sizes))
                             .astype(np.complex64)).cuda()
        dds = [torch.from_numpy((rng.standard_normal(m) + 1j * rng.standard_normal(m))
                                .astype(np.complex64)).cuda() for m in sizes]
        f64 = torch.fft.fft(s.to(torch.complex128), dim=0)
        cases = [(tuple(zfuse.OpSpec("grad", axis=a) for a in (2, 1, 0)), dds[::-1], True),
                 ((zfuse.OpSpec("grad", axis=0),), dds[:1], False),
                 ((zfuse.OpSpec("nabla", power=-0.5),), (), False)]
        zfuse.reset_launch_counts()
        worst = 0.0
        for specs, dd, use_kappa in cases:
            outs = zfuse.apply(plan, s, specs, dd, use_kappa=use_kappa)
            torch.cuda.synchronize()
            plain = _own_plain(plan)(plan, s, specs, dd, use_kappa=use_kappa)
            dd_iter = iter(dd)
            for spec, got, want in zip(specs, outs, plain):
                op = zfuse.full_operator(plan, spec, next(dd_iter) if spec.kind == "grad"
                                         else None, use_kappa)
                ref = torch.fft.ifft(f64 * op, dim=0)
                peak = float(ref.abs().max())
                e_plain = float((got - want).abs().max()) / peak
                e_ref = float((got - ref).abs().max()) / peak
                _require(e_plain <= ZFUSE_PLAIN_TOL and e_ref <= ZFUSE_TOL,
                         f"nz={nz} {spec}: off plain {e_plain:.3g}, float64 {e_ref:.3g}")
                worst = max(worst, e_plain, e_ref)
        want = {k: len(cases) if k == kernel else 0 for k in zfuse.KERNEL_LAUNCHES}
        _require(zfuse.KERNEL_LAUNCHES == want,
                 f"nz={nz}: launches by kernel {zfuse.KERNEL_LAUNCHES}, expected {kernel}")
        print(f"[8 zfuse] spectrum [{nz}, {ny}, {plan.nxr}]: {len(cases)} launches of the "
              f"{kernel} kernel (passes {plan.passes}, M {plan.m}), one op and three, off "
              f"its plain version and "
              f"float64 at most {worst:.2e} of the peak", flush=True)


SETUP_COPIES = "host-to-device copies"  # the operators' upload: set-up, not the step

# kernel-name fragment -> what the kernel is, for the profile line (first match wins)
KERNEL_GROUPS = (("nccl", "NCCL"), ("zfuse_", "K7 zfuse"), ("fft", "cuFFT"), ("w40_window", "K1a encode"),
                 ("elementwise", "elementwise"), ("index", "gather/scatter"),
                 ("HtoD", SETUP_COPIES), ("DtoH", "device-to-host copies"),
                 ("copy", "device copies"), ("Memcpy", "device copies"),
                 ("Memset", "memset"))


def _profile_window(data, flags, host_top=0, windows=1, **run_fields):
    """Device time by kind of kernel over one profiled window of `run_simulation` (16
    steps; or a run of ``windows`` windows): (device ms per step, [(kind, share), ...],
    ms of host-to-device copies, which are the run's set-up and are left out of both,
    [(host op, self ms per step), ...] of the ``host_top`` host events with the most time
    of their own). Only kernel events count: the operator events above them carry the
    same time again. The run's set-up (operators, sharding, the first window's plans) is
    inside the window."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    steps = windows * O_SIZE
    short = dataclasses.replace(data, grid=dataclasses.replace(data.grid, nt=steps))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _run(flags, windows, 0, data=short, **run_fields)
    groups: dict[str, float] = {}
    host = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            host.append((e.key, e.self_cpu_time_total / 1e3 / steps))
            continue
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        kind = next((g for frag, g in KERNEL_GROUPS if frag in e.key), "other")
        groups[kind] = groups.get(kind, 0.0) + t
    setup_ms = groups.pop(SETUP_COPIES, 0.0) / 1e3
    total = sum(groups.values())
    _require(total > 0, "the profiler saw no device time")
    top = sorted(groups.items(), key=lambda r: -r[1])
    host = sorted(host, key=lambda r: -r[1])[:host_top]
    return total / 1e3 / steps, [(k, t / total) for k, t in top], setup_ms, host


FUSED_FLAGS = ["--p_raw", "--p_c", "--40-bit_complex"]
FUSED_WINDOWS, FUSED_TAIL = 2, 5


RUN_FIELDS = {"compact": dict(compact_operators=True),
              "fused": dict(compact_operators=True, fuse_z=True)}


def _fused_runs(data, kernel: str, profile: tuple[str, ...] = ("compact", "fused"),
                again: tuple[str, ...] = ()) -> dict:
    """One input run with compact operators alone and with ``fuse_z``, and each run named
    in ``again`` a second time after both: every K7 launch of the fused run counted as
    ``kernel``'s, p_raw of the two within `FUSED_RUN_TOL`, each run's p_c bytes equal to
    the oracle's encoding of its own p_raw, ms/step of each and one profiled window of each
    run named in ``profile``. Returns the fused run's launches by LAUNCHES key."""
    from kwave_tpu_torch.ops import encode_window as ew
    from kwave_tpu_torch.ops import zfuse

    g = data.grid
    where = f"{g.nz} x {g.ny} x {g.nx}, {len(data.sensor_mask_index)} sensors"
    outs, ms_step, launches, by_kernel = {}, {}, {}, {}
    for run in ("compact", "fused", *again):
        name = run if run not in ms_step else f"{run} again"
        zfuse.reset_launch_counts()
        ew.reset_launch_counts()
        out, secs, steps, _ = _run(FUSED_FLAGS, FUSED_WINDOWS, FUSED_TAIL, data=data,
                                   **RUN_FIELDS[run])
        launches[name] = dict(zfuse.LAUNCHES)
        by_kernel[name] = dict(zfuse.KERNEL_LAUNCHES)
        _require(ew.LAUNCHES["w40_overlap"] == FUSED_WINDOWS + 1,
                 f"{name}: window-encode launches {ew.LAUNCHES}")
        err, peak = _check_run(out, FUSED_FLAGS, steps)
        outs[name] = out["p"].data[0]
        ms_step[name] = float(out.attrs["simulation_phase_execution_time"]) / steps * 1e3
        print(f"[8 fused] {name}: {where}, {steps} steps ({FUSED_WINDOWS} windows + "
              f"{FUSED_TAIL}-step tail), {ms_step[name]:.3f} ms/step in the simulation "
              f"phase, {secs / steps * 1e3:.3f} ms/step end to end; zfuse launches "
              f"{launches[name]} {by_kernel[name]}; p_c == oracle(p_raw) bytes on "
              f"{ORACLE_SENSORS} sensors, decoded diff {err:.3g} (peak {peak:.3g})",
              flush=True)
    steps = FUSED_WINDOWS * O_SIZE + FUSED_TAIL
    # the p0 peel is one three-op call; every later step one three-op and five one-op
    want = {"zfuse_1op": 5 * (steps - 1), "zfuse_2op": 0, "zfuse_3op": steps}
    _require(all(n == (want if name.startswith("fused") else {k: 0 for k in want})
                 for name, n in launches.items()),
             f"zfuse launches {launches}, expected {want} and none without fuse_z")
    _require(all(n == {k: sum(want.values()) if k == kernel else 0 for k in n}
                 for name, n in by_kernel.items() if name.startswith("fused")),
             f"the fused runs' launches by kernel: {by_kernel}, all expected as {kernel}")
    diff = float(np.abs(outs["fused"] - outs["compact"]).max())
    peak = float(np.abs(outs["compact"]).max())
    _require(np.isfinite(outs["fused"]).all() and diff <= FUSED_RUN_TOL * peak,
             f"p_raw of the fused run off the compact run by {diff / peak:.3g} of the peak")
    print(f"[8 fused] {where}: p_raw fused vs compact-only: max diff {diff / peak:.2e} of "
          f"the peak ({peak:.4g}); ms/step " + ", ".join(
              f"{name.replace('compact', 'unfused')} {ms:.3f}" for name, ms in ms_step.items())
          + f"; every K7 launch the {kernel} kernel's", flush=True)
    for name, fields in RUN_FIELDS.items():
        if name in profile:
            dev_ms, top, setup_ms, _ = _profile_window(data, FUSED_FLAGS, **fields)
            print(f"[8 profile] {name}, {where}: {dev_ms:.3f} ms of kernel time per step "
                  f"over one window; " + "; ".join(f"{k} {share:.1%}" for k, share in top)
                  + f"; set-up uploads {setup_ms:.1f} ms, left out; idle share against "
                  f"the unprofiled run's {ms_step[name]:.3f} ms/step: "
                  f"{1 - dev_ms / ms_step[name]:.1%}", flush=True)
    return launches["fused"]


def _spectrum_ops(shape: tuple[int, int, int]):
    """Compact operators of an nz x ny x nx grid of `_input`'s recipe in a homogeneous
    medium (c0 1600 m/s, the heterogeneous one's c_ref; rho0 1000 kg/m^3; the same
    absorption): the per-axis vectors K7 reads, without the grid's media fields."""
    from kwave_tpu_torch.solver import Grid, Medium, make_operators

    dx = 1e-4
    nz, ny, nx = shape
    grid = Grid(nx=nx, ny=ny, nz=nz, dx=dx, dy=dx, dz=dx, dt=0.3 * dx / 1600.0, nt=1)
    medium = Medium(c0=1600.0, rho0=1000.0, alpha_coeff=0.75, alpha_power=1.5)
    pml = tuple(min(10, n // 4) for n in (nx, ny, nz))  # 10, or a quarter of a short axis
    return make_operators(grid, medium, pml, (2.0, 2.0, 2.0), absorbing=True,
                          device="cuda", compact=True)


def fused_phase():
    """Path B, the fused z stage: (a) K7 timed at the spectra of 256^3 (the radix kernel,
    and the mixed one at the same nz), 192^3 (mixed) and `K7_SPECTRA`; (b) the
    small spectra; (c) the 256^3, 192^3 and `FUSED_GRIDS` runs unfused and fused. Returns
    the K7 rows by name (each with its kernel and op count) and the launches by LAUNCHES
    key of each kernel's runs, summed."""
    import torch

    from kwave_tpu_torch.ops import zfuse
    from kwave_tpu_torch.solver import make_operators

    steps = FUSED_WINDOWS * O_SIZE + FUSED_TAIL
    rows, launches = {}, {}

    def add(kernel, counts):
        have = launches.setdefault(kernel, {})
        for k, v in counts.items():
            have[k] = have.get(k, 0) + v

    for n, kernels in ((BIG_N, ("radix", "mixed")), (MIXED_N, ("mixed",))):
        t0 = time.perf_counter()
        data = _input(steps, n)
        ops = make_operators(data.grid, data.medium, data.pml_size, data.pml_alpha,
                             absorbing=True, device="cuda", compact=True)
        print(f"[8 fused] {n}^3 input and compact operators built in "
              f"{time.perf_counter() - t0:.1f} s (host float64)", flush=True)
        rows.update(zfuse_kernel_phase(ops, (n,) * 3, kernels))
        del ops
        torch.cuda.empty_cache()
        add(kernels[0], _fused_runs(data, kernels[0]))
        del data
    t0 = time.perf_counter()
    for shape, kernels in K7_SPECTRA:
        rows.update(zfuse_kernel_phase(_spectrum_ops(shape), shape, kernels))
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _zfuse_small_spectra()
    t2 = time.perf_counter()
    for shape, profile, again in FUSED_GRIDS:
        kernel = zfuse.kernel_for(shape[0])
        add(kernel, _fused_runs(_input(steps, shape=shape), kernel, profile, again))
        torch.cuda.empty_cache()
    t3 = time.perf_counter()
    print(f"[time] phase 8: K7_SPECTRA rows {t1 - t0:.1f} s, small spectra {t2 - t1:.1f} s, "
          f"FUSED_GRIDS runs {t3 - t2:.1f} s", flush=True)
    return rows, launches


def _input(nt: int, n: int = GRID_N, shape: tuple[int, int, int] | None = None):
    """n^3 (or ``shape``, nz x ny x nx) heterogeneous absorbing medium (128^3 unless told),
    p0 at the centre, 16384 random index sensors (the setup of
    tools/bench_driver_40bit.py), from seed 7; a PML of 10 cells, or a quarter of an axis
    shorter than 40."""
    from kwave_tpu_torch.io.input_file import InputData
    from kwave_tpu_torch.solver import Grid, Medium

    dx = 1e-4
    nz, ny, nx = shape or (n, n, n)
    grid = Grid(nx=nx, ny=ny, nz=nz, dx=dx, dy=dx, dz=dx, dt=0.3 * dx / 1600.0, nt=nt)
    rng = np.random.default_rng(7)
    medium = Medium(c0=(1500.0 + 100.0 * rng.random(grid.shape)).astype(np.float32),
                    rho0=(1000.0 + 50.0 * rng.random(grid.shape)).astype(np.float32),
                    alpha_coeff=0.75, alpha_power=1.5)
    mask = np.sort(rng.choice(grid.n_elements, N_SENSORS, replace=False)).astype(np.int64)
    p0 = np.zeros(grid.shape, np.float32)
    p0[nz // 2, ny // 2, nx // 2] = 1e5
    return InputData(grid=grid, medium=medium,
                     pml_size=tuple(min(10, m // 4) for m in (nx, ny, nz)),
                     pml_alpha=(2.0, 2.0, 2.0), absorbing=True, sensor_mask_index=mask,
                     p0=p0)


def _sync(mesh=None) -> None:
    """Wait for the current card and for every card of ``mesh`` (an in-process mesh may
    span several)."""
    import torch

    torch.cuda.synchronize()
    for d in dict.fromkeys(mesh.devices if mesh is not None else ()):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _run(flags: list[str], windows: int, tail: int, data=None, out=None, resume_from=None,
         device="cuda", mesh=None, window_log=None, **run_fields):
    """One `run_simulation` through the CLI's parser into an in-memory group (``out``, or
    a new one); ``run_fields`` sets RunConfig fields that have no flag
    (compact_operators, fuse_z, cuda_graphs) or that take a group here
    (checkpoint_file); ``window_log`` (a list) receives the run's window objects. Returns
    the group, the seconds, the record's steps and the run's summary."""
    import dataclasses

    import torch

    from kwave_tpu_torch import params
    from kwave_tpu_torch.driver import run_simulation

    args = params.build_parser().parse_args(["-i", "-", "-o", "-", "--period",
                                             str(O_SIZE), *flags])
    data = data if data is not None else _input(windows * O_SIZE + tail)
    run = dataclasses.replace(params.args_to_run_config(args, dt=data.grid.dt),
                              **run_fields)
    out = out if out is not None else MemGroup()
    _sync(mesh)
    t0 = time.perf_counter()
    legs = {} if resume_from is None else {"resume_from": resume_from}
    if window_log is not None:  # not passed otherwise: an older package takes no log
        legs["window_log"] = window_log
    summary = run_simulation(data, run, out, device=device, mesh=mesh, **legs)
    _sync(mesh)
    return out, time.perf_counter() - t0, data.grid.nt, summary


def _check_run(out, flags, steps):
    """Nc, no NaN, and the p_c bytes against the oracle's encoding of p_raw."""
    from kwave_tpu_torch import oracle
    from kwave_tpu_torch.basis import generate_basis

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
        before, log = dict(ew.LAUNCHES), []
        out, secs, steps, _ = _run(flags, windows, tail, window_log=log)
        delta = {k: ew.LAUNCHES[k] - before[k] for k in ew.LAUNCHES}
        actions = _check_actions(log, windows)
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
              f"{ORACLE_SENSORS} sensors, decoded diff {err:.3g} (peak {peak:.3g}); "
              f"windows {actions}", flush=True)
        if flags == ["--p_raw", "--p_c"]:
            float_run = (out, steps)  # decoded on the card in phase 6
    return dict(ew.LAUNCHES), float_run


def _check_actions(log: list, windows: int, t_first: int = 0, cfg=None) -> str:
    """The windows of a run on the card ran as `driver.plan_windows` says (the first with
    the p0 peel, eager, then the others); returns them counted by action."""
    from kwave_tpu_torch import driver, solver

    actions = [a for w in log for a in w.actions]
    plan = driver.plan_windows(cfg or solver.SolverConfig(), O_SIZE, t_first, windows)
    _require(actions == [(t, a) for t, _, a in plan],
             f"the windows ran as {actions}, the plan says {plan}")
    return ", ".join(f"{sum(a == k for _, a in actions)} {k}"
                     for k in ("eager", "capture", "replay"))


def _member(group, path: str):
    """The dataset or group of an in-memory group at ``path`` ("a/b")."""
    for name in path.split("/"):
        group = group[name]
    return group


def _datasets(group, prefix=""):
    """Every dataset of an in-memory group, by its path."""
    for name, item in group.items.items():
        if isinstance(item, MemGroup):
            yield from _datasets(item, f"{prefix}{name}/")
        else:
            yield prefix + name, item.data


def _intensity_checks(out, data, steps) -> dict:
    """Run A's intensities and Q terms against float64 numpy (module docstring, phase 9);
    returns each one's largest error as a share of its peak."""
    from kwave_tpu_torch import oracle

    k, t = ORACLE_SENSORS, steps
    errs = {}

    def hold(name, got, want, peak=None, tol=INTENSITY_TOL):
        own = float(np.abs(want).max())
        peak = own if peak is None else peak
        err = float(np.abs(got.astype(np.float64) - want).max())
        _require(own > 0 and np.isfinite(got).all() and err <= tol * peak,
                 f"{name}: off float64 numpy by {err / max(peak, 1e-300):.3g} of "
                 f"{peak:.4g} (its own peak {own:.4g}), allowed {tol:g}")
        errs[name] = err / own

    def decoded(name, e):  # stored 40-bit frames of the first k sensors, H = 1
        raw = np.ascontiguousarray(out[name].data[0]).view(np.uint8)[:, : 5 * k]
        planes = oracle.bytes_to_soa(np.ascontiguousarray(raw).reshape(-1))
        re, im = oracle.decode40(*(p.reshape(-1, k, 1) for p in planes), e)
        return re.astype(np.float64), im.astype(np.float64)

    n_bins = t // 2 + 1
    shift = (np.arange(n_bins) + t // 2) % t - t // 2
    phase = np.exp(1j * np.pi * shift / t)[:, None]
    p = out["p"].data[0][:, :k].astype(np.float64)
    p_re, p_im = decoded("p_c", oracle.MAX_EXP_P)
    _require(p_re.shape[0] == LEGS_WINDOWS, f"p_c holds {p_re.shape[0]} frames")
    for a in "xyz":
        u = out[f"u{a}_non_staggered"].data[0][:, :k].astype(np.float64)
        shifted = np.fft.irfft(np.fft.rfft(u, axis=0) * phase, n=t, axis=0)
        hold(f"I{a}_avg", out[f"I{a}_avg"].data.reshape(-1)[:k], (p * shifted).mean(axis=0))
        u_re, u_im = decoded(f"u{a}_non_staggered_c", oracle.MAX_EXP_U)
        hold(f"I{a}_avg_c", out[f"I{a}_avg_c"].data.reshape(-1)[:k],
             (0.5 * (p_re * u_re + p_im * u_im)).sum(axis=2).mean(axis=0))

    # the record's 101 steps leave the spectrum without a Nyquist bin, whose imaginary
    # part cuFFT's c2r transform does not drop as the CPU's does: an even length, directly
    import torch

    from kwave_tpu_torch import postproc

    u = np.random.default_rng(11).standard_normal((6 * O_SIZE, k)).astype(np.float32)
    shift = (np.arange(u.shape[0] // 2 + 1) + u.shape[0] // 2) % u.shape[0] - u.shape[0] // 2
    hold(f"time_shift_T{u.shape[0]}",
         postproc.time_shift_half_step(torch.from_numpy(u).to("cuda")).cpu().numpy(),
         np.fft.irfft(np.fft.rfft(u.astype(np.float64), axis=0)
                      * np.exp(1j * np.pi * shift / u.shape[0])[:, None],
                      n=u.shape[0], axis=0))

    grid, mask = data.grid, data.sensor_mask_index
    for suffix in ("", "_c"):
        q, scale = np.zeros(grid.shape, np.float64), 0.0
        for axis, (a, d) in enumerate(zip("zyx", (grid.dz, grid.dy, grid.dx))):
            field = np.zeros(grid.n_elements, np.float64)
            field[mask] = out[f"I{a}_avg{suffix}"].data.reshape(-1)
            n = grid.shape[axis]
            ik = 2j * np.pi / d * ((np.arange(n // 2 + 1) + n // 2) % n - n // 2) / n
            shp = [1, 1, 1]
            shp[axis] = -1
            q -= np.fft.irfft(np.fft.rfft(field.reshape(grid.shape), axis=axis)
                              * ik.reshape(shp), n=n, axis=axis)
            scale = max(scale, np.pi / d * float(np.abs(field).max()))
        # The scattered field is a set of spikes, and the derivative at a spike is a sum
        # over all wavenumbers of terms up to k_max |I| that cancel: the fp32 error goes
        # with that size, not with what is left of the sum. So Q is held to 1e-6 of
        # k_max |I|max; the line prints the error as a share of Q's own peak.
        hold("Q_term" + suffix, out["Q_term" + suffix].data.reshape(-1),
             q.reshape(-1)[mask], peak=scale, tol=Q_TOL)
    return errs


class _TimedCheckpoints:
    """While open, `io.checkpoint`'s two functions are timed, the device drained before
    and after each call; ``seconds`` holds, per function name, the seconds of every call
    in order. The driver itself carries no such clock."""

    def __enter__(self):
        import torch

        from kwave_tpu_torch.io import checkpoint

        self.module, self.seconds = checkpoint, {}
        self.saved = {n: getattr(checkpoint, n)
                      for n in ("write_checkpoint", "read_checkpoint")}

        def timed(name, fn):
            def call(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
                return result
            return call

        for name, fn in self.saved.items():
            setattr(checkpoint, name, timed(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def legs_phase(smi):
    """Phase 9: one run in one leg and in three, and what the intensity and Q-term
    outputs hold (module docstring)."""
    from kwave_tpu_torch.ops import encode_window as ew

    steps = LEGS_WINDOWS * O_SIZE + LEGS_TAIL
    data = _input(steps)
    post_attr, sim_attr, pre_attr = ("post-processing_phase_execution_time",
                                     "simulation_phase_execution_time",
                                     "pre-processing_phase_execution_time")
    # four compressed streams, each one launch a window and one for the trailing steps
    want = 4 * (LEGS_WINDOWS + 1)

    ew.reset_launch_counts()
    out_a, secs_a, _, _ = _run(LEGS_FLAGS, LEGS_WINDOWS, LEGS_TAIL, data=data)
    launches_a = dict(ew.LAUNCHES)

    ew.reset_launch_counts()
    out_b, ckpt = MemGroup(), MemGroup()
    stops, pre, secs_b, resume = [], [0.0], 0.0, None
    with _TimedCheckpoints() as timed:
        while True:
            _, secs, _, summary = _run(LEGS_FLAGS, LEGS_WINDOWS, LEGS_TAIL, data=data,
                                       out=out_b, resume_from=resume, checkpoint_file=ckpt,
                                       checkpoint_interval_steps=LEG_WINDOWS * O_SIZE)
            secs_b += secs
            stops.append(summary.get("__checkpointed_at__"))
            pre.append(float(out_b.attrs[pre_attr]))  # cumulated over the legs so far
            if stops[-1] is None:
                break
            resume = ckpt
            _require(len(stops) < 10, f"the run in legs does not end: {stops}")
    launches_b = dict(ew.LAUNCHES)
    writes, reads = timed.seconds["write_checkpoint"], timed.seconds["read_checkpoint"]
    _require(len(writes) == len(stops) and len(reads) == len(stops) - 1,
             f"{len(stops)} legs wrote {len(writes)} checkpoints and read {len(reads)}")
    # the trailing steps are a leg of their own: the last checkpoint falls at the end of
    # the last whole window, before the end of the record
    _require(stops == [(k * LEG_WINDOWS * O_SIZE,)
                       for k in range(1, LEGS_WINDOWS // LEG_WINDOWS + 1)] + [None],
             f"legs stopped at {stops}")
    for name, got in (("A", launches_a), ("B", launches_b)):
        _require(got == {k: (want if k == "w40_overlap" else 0) for k in got},
                 f"run {name}: window-encode launches {got}, expected w40_overlap {want}")

    a, b = dict(_datasets(out_a)), dict(_datasets(out_b))
    _require(a.keys() == b.keys(), f"datasets differ: {sorted(a.keys() ^ b.keys())}")
    differing = {}
    for name in a:
        x, y = np.ascontiguousarray(a[name]), np.ascontiguousarray(b[name])
        same = x.shape == y.shape and x.dtype == y.dtype and \
            np.array_equal(x.view(np.uint8), y.view(np.uint8))
        if not same:
            diff = np.abs(x.astype(np.float64) - y.astype(np.float64))
            differing[name] = (float(diff.max()), float(np.abs(x).max()))
    _require(not differing, f"three legs differ from one leg in (max diff, peak): "
             f"{differing}")
    errs = _intensity_checks(out_a, data, steps)

    def ms_step(out, less=0.0):
        return (float(out.attrs[sim_attr]) - less) / steps * 1e3

    in_sim = sum(writes[:-1])  # the last one, at the end of the run, is post-processing
    pre_legs = [b - a for a, b in zip(pre, pre[1:])]
    print(f"[9 legs] {' '.join(LEGS_FLAGS)}: {GRID_N}^3, {N_SENSORS} sensors, {steps} steps "
          f"({LEGS_WINDOWS} windows + {LEGS_TAIL}-step tail), {len(a)} datasets; run B in "
          f"{len(stops)} legs (checkpoints at {[at[0] for at in stops if at]}) == run A bit "
          f"for bit in every dataset; w40_overlap launched {want}x in A and in B "
          f"(4 streams x ({LEGS_WINDOWS} windows + the tail)); against float64 numpy, of "
          f"each one's peak: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()),
          flush=True)
    print(f"[9 legs] run A: {ms_step(out_a):.3f} ms/step in the simulation phase, "
          f"{secs_a / steps * 1e3:.3f} ms/step end to end ({smi})", flush=True)
    print(f"[9 legs] run B: {ms_step(out_b):.3f} ms/step in the simulation phase summed over "
          f"the legs, {ms_step(out_b, in_sim):.3f} without the {len(stops) - 1} checkpoint "
          f"writes inside it, {secs_b / steps * 1e3:.3f} ms/step end to end ({smi})", flush=True)
    print(f"[9 legs] checkpoint write: {' '.join(f'{w:.4f}' for w in writes)} s each "
          f"(7 fields of {GRID_N}^3 to the host, they and 4 Temp_ pairs into a group; the "
          f"last one at the end of the run)", flush=True)
    print(f"[9 legs] resume: checkpoint read {' '.join(f'{r:.4f}' for r in reads)} s each; "
          f"the pre-processing phase, which on a resumed leg also puts the state on the "
          f"device and reopens the output: {' '.join(f'{x:.4f}' for x in pre_legs)} s per "
          f"leg, the first not resumed", flush=True)
    print(f"[9 legs] post-processing: {float(out_a.attrs[post_attr]):.4f} s in run A, "
          f"{float(out_b.attrs[post_attr]):.4f} s in run B's last leg (aggregates, I_avg "
          f"and Q_term from the stored series, Q_term_c)", flush=True)
    # the window loop alone: the outputs computed after the run are left out
    loop_flags = [f for f in LEGS_FLAGS if f not in ("--I_avg", "--Q_term", "--Q_term_c")]
    dev_ms, top, setup_ms, _ = _profile_window(data, loop_flags)
    print(f"[9 profile] {' '.join(loop_flags)}: {dev_ms:.3f} ms of kernel time per step "
          f"over one window; " + "; ".join(f"{k} {share:.1%}" for k, share in top)
          + f"; set-up uploads {setup_ms:.1f} ms, left out; idle share against run A's "
          f"{ms_step(out_a):.3f} ms/step: {1 - dev_ms / ms_step(out_a):.1%}", flush=True)
    return launches_a


# phase 10: the acceptance inputs on the card against the port on the CPU
FULL_FLAGS = ["--p_raw", "--u_non_staggered_raw", "--p_c", "--u_non_staggered_c",
              "--40-bit_complex", "--I_avg", "--Q_term", "--p_max", "--p_rms"]
FULL_WINDOWS, FULL_TAIL = 2, 5
STANDING_WAVE_ATOL = 5e-3  # tests/test_solver.py's closed form, of the unit amplitude
RECIPROCITY_TOL = 1e-4  # of the peak, as tests/test_solver.py


def _acceptance_cases():
    """tests/acceptance_cases.py: the sweep's inputs and checks (numpy and the port)."""
    tests = str(ROOT / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import acceptance_cases

    return acceptance_cases


def _run_case(ac, c, device):
    """One acceptance case through the port as its CLI runs it (flags through its parser,
    ``--benchmark``, legs resumed from a checkpoint, then ``--post``), every file an
    in-memory group; ``--copy_sensor_mask`` is the CLI's own edit of a file on disk and
    is left out on both devices. A ``fuse_z`` case takes the fused z stage on the card."""
    import dataclasses

    from kwave_tpu_torch import params
    from kwave_tpu_torch.driver import _corners_to_indices, run_simulation
    from kwave_tpu_torch.postproc import post_process_output_file

    data = ac.port_input(c)
    args = params.build_parser().parse_args(["-i", "-", "-o", "-", *c.flags])
    if args.benchmark is not None:
        data.grid = dataclasses.replace(data.grid, nt=min(args.benchmark, data.grid.nt))
    run = params.args_to_run_config(args, dt=data.grid.dt)
    if not any(run.flags.values()) and not (args.I_avg or args.I_avg_c or args.Q_term
                                            or args.Q_term_c):
        run.flags["p_raw"] = True  # the CLI's default output
    if c.fuse_z and device == "cuda":
        run = dataclasses.replace(run, fuse_z=True, compact_operators=True)
    out, resume = MemGroup(), None
    if c.legs:
        run = dataclasses.replace(run, checkpoint_file=MemGroup())
    for _ in range(100):
        summary = run_simulation(data, run, out, device=device, resume_from=resume)
        if "__checkpointed_at__" not in summary:
            break
        resume = run.checkpoint_file
    if c.post:
        post = params.build_parser().parse_args(["-i", "-", "-o", "-", "--post", *c.post])
        mask = data.sensor_mask_index
        if mask is None:
            mask = _corners_to_indices(data.sensor_mask_corners, data.grid)
        for from_coeffs, i_avg, q_term in ((False, post.I_avg, post.Q_term),
                                           (True, post.I_avg_c, post.Q_term_c)):
            if i_avg or q_term:
                post_process_output_file(out, data.grid, mask, want_i_avg=i_avg,
                                         want_q_term=q_term, from_coeffs=from_coeffs,
                                         block_size=post.block_size, device=device)
    return out


def _hold_card_to_cpu(ac, c, card, cpu, device="cuda") -> tuple[dict, set, str]:
    """Every dataset of the card's output against the CPU's (the sweep's tolerances), and
    the CPU's p_c bytes against the card's encoding of the CPU's p series (exact: the
    port's encoders are the oracle's bit for bit on both devices)."""
    errs, floored = ac.compare_outputs(cpu, card)
    fed = ac.p_c_fed_the_series(cpu, c, device=device)
    if fed is None:
        return errs, floored, "-"
    mine, stored, _ = fed
    _require(np.array_equal(mine, stored),
             f"{c.name}: p_c of the CPU's series encoded on the card != the CPU's p_c")
    return errs, floored, "equal"


def acceptance_phase(smi):
    """Phase 10: (a) every input of the acceptance sweep, (b) phase 9's input at full
    width, each run by the port on the card and on the CPU in this process and held to
    each other; (c) `simulate` on the card against the standing wave's closed form and
    acoustic reciprocity. Returns the launches of (a) and (b) by LAUNCHES key."""
    from kwave_tpu_torch.ops import encode_window as ew
    from kwave_tpu_torch.ops import zfuse

    ac = _acceptance_cases()
    t0 = time.perf_counter()
    ew.reset_launch_counts()
    zfuse.reset_launch_counts()
    cards = {c.name: _run_case(ac, c, "cuda") for c in ac.CASES}
    launches = {**ew.LAUNCHES, **zfuse.LAUNCHES}
    k7 = dict(zfuse.KERNEL_LAUNCHES)
    card_s = time.perf_counter() - t0
    _require(k7["mixed"] > 0, f"no run launched the mixed z-stage kernel: {k7}")
    worst, fed, faults, floors = {}, 0, [], []
    for c in ac.CASES:
        try:
            errs, floored, p_c = _hold_card_to_cpu(ac, c, cards[c.name],
                                                   _run_case(ac, c, "cpu"))
        except AssertionError as e:  # every case is checked; all faults are reported
            faults.append(f"{c.name}: {e}")
            continue
        worst[c.name] = max(v for k, v in errs.items() if k not in floored)
        floors += [f"{c.name}/{k} {errs[k]:.2e}" for k in sorted(floored)]
        fed += p_c == "equal"
    _require(not faults, "card != CPU in " + " | ".join(faults))
    name = max(worst, key=worst.get)
    print(f"[10 acceptance] (a) {len(ac.CASES)} inputs of the acceptance sweep, card vs "
          f"the port on the CPU: every dataset's name, layout and attributes equal, data "
          f"within rel L2 {ac.REL_L2:g} (worst {worst[name]:.2e}, {name}; 40-bit rows "
          f"held by the quantum floor: {floors or 'none'}); p_c of the "
          f"CPU's series encoded on the card == the CPU's bytes in {fed} runs; card runs "
          f"{card_s:.1f} s; window kernels launched "
          f"{ {k: v for k, v in launches.items() if k in ew.LAUNCHES and v} }, "
          f"K7 {k7} (mixed: {ac.case('fused_dense_nz100').name})", flush=True)

    steps = FULL_WINDOWS * O_SIZE + FULL_TAIL
    data = _input(steps)
    ew.reset_launch_counts()
    zfuse.reset_launch_counts()
    card, secs, _, _ = _run(FULL_FLAGS, FULL_WINDOWS, FULL_TAIL, data=data)
    for k, v in ew.LAUNCHES.items():
        launches[k] += v
    t2 = time.perf_counter()
    cpu, _, _, _ = _run(FULL_FLAGS, FULL_WINDOWS, FULL_TAIL, data=data, device="cpu")
    cpu_s = time.perf_counter() - t2
    errs, floored, p_c = _hold_card_to_cpu(
        ac, ac.Case("full_width", "card", tuple(FULL_FLAGS)), card, cpu)
    shifted = max(v for k, v in errs.items() if "non_staggered" in k and "_c" not in k)
    top = sorted(errs, key=errs.get)[-3:][::-1]
    print(f"[10 acceptance] (b) {' '.join(FULL_FLAGS)}: {GRID_N}^3, {N_SENSORS} sensors, "
          f"{steps} steps ({FULL_WINDOWS} windows + {FULL_TAIL}-step tail), card vs CPU in "
          f"{len(errs)} datasets: worst rel L2 "
          + ", ".join(f"{k} {errs[k]:.2e}" for k in top)
          + f" (held by the quantum floor: {sorted(floored) or 'none'}), u*_non_staggered "
          f"{shifted:.2e}; p_c bytes {p_c}; card {secs:.2f} s, CPU {cpu_s:.1f} s ({smi})",
          flush=True)
    # the worst 40-bit dataset: which coefficient, and how many steps of its word apart
    forty = [k for k in errs if float(_member(cpu, k).attrs.get("c_complex_size", 0)) == 1.25]
    if forty:
        where = max(forty, key=errs.get)
        w = ac.worst_40bit(_member(cpu, where), _member(card, where))
        print(f"[10 acceptance] (b) worst 40-bit dataset {where} (rel L2 {errs[where]:.2e}): "
              f"frame row {w['row']}, sensor {w['sensor']} (mask index "
              f"{int(data.sensor_mask_index[w['sensor']])}), harmonic {w['harmonic']}, "
              f"{w['part']}: CPU {w['want']!r}, card {w['got']!r}, {w['quanta']:g} steps "
              f"of its word (step {w['step']:g}, the value {abs(w['want']) / w['step']:.1f} "
              f"steps); of its {w['parts']} coefficient parts, by steps apart "
              f"{w['differ']}; rel L2 {w['rel_l2']:.2e}, and "
              f"{w['rel_l2_without_one_step']:.2e} with the parts at most one step apart set "
              f"equal", flush=True)

    ew.reset_launch_counts()
    zfuse.reset_launch_counts()
    waves = {(dim, fused): ac.standing_wave_error(dim, fused, "cuda")
             for dim, fused in ((2, False), (3, False), (3, True))}
    recip = ac.reciprocity_error("cuda")
    _require(max(waves.values()) <= STANDING_WAVE_ATOL and recip <= RECIPROCITY_TOL,
             f"simulate on the card: standing wave {waves}, reciprocity {recip:.3g}")
    _require(zfuse.KERNEL_LAUNCHES["radix"] > 0, "the fused standing wave launched no K7")
    print(f"[10 acceptance] (c) simulate on the card: standing wave off cos(w t) cos(kx) by "
          f"{waves[(2, False)]:.2e} (2D), {waves[(3, False)]:.2e} (3D), "
          f"{waves[(3, True)]:.2e} (3D, fused z stage: K7 {dict(zfuse.KERNEL_LAUNCHES)}), "
          f"allowed {STANDING_WAVE_ATOL:g}; reciprocity |G(A->B) - G(B->A)| "
          f"{recip:.2e} of the peak, allowed {RECIPROCITY_TOL:g}; phase 10 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# phase 11: the mesh (kwave_tpu_torch.parallel) on the one card
MESH_FLAGS = ["--p_raw", "--p_c", "--40-bit_complex", "--p_max_all", "--p_final"]
MESH_WINDOWS, MESH_TAIL = 2, 5
MESH_RTOL, MESH_ATOL = 2e-5, 2e-6  # of each dataset's own peak: tests/test_dist_step.py's
# p_final of a run through the pencil FFT against a run through the 3D transforms, of its
# own peak. On an H100 at 256^3: 2.67e-6 on 1, 2 and 4 shards (37 steps; 4 and 2 shards
# equal 1 bit for bit, so it is the two transforms' rounding, not the sharding) and
# 3.68e-6 for (e)'s resume (53 steps); the faults of `_final_controls` read 2.43e-4
# (fp16) and 1 (a slab out of order), and each must fail it.
FINAL_ATOL = 5e-6
PENCIL_TOL = 1e-5  # the pencil FFT vs torch.fft.rfftn on the card, of the peak
AXIS_TOL = 1e-5  # a sharded spectral multiplier vs the single-device one, rel L2
MESH_LEGS_WINDOWS = 3  # phase 11 (e): 3 windows and the tail, a leg a window


def _mesh(s: int):
    from kwave_tpu_torch.parallel import make_mesh

    return make_mesh(s, devices=["cuda:0"] * s)


def _hold_mesh_run(single, meshed, what: str, final_atol: float = FINAL_ATOL) -> dict:
    """A mesh run's output against another run's of the same input (module docstring,
    phase 11): p, p_max_all and p_final each to rtol / atol of its own peak (p_final's atol
    ``final_atol``), the 40-bit p_c decoded to DECODE_TOL of the peak, and the mesh run's
    own p series encoded on the card to its p_c bytes. Returns each one's largest error as
    a share of its own peak."""
    import torch

    from kwave_tpu_torch import encoder, oracle
    from kwave_tpu_torch.basis import generate_basis

    errs = {}
    for name in ("p", "p_max_all", "p_final"):
        if name not in single.keys():
            continue
        a = np.asarray(single[name].data, np.float64)
        b = np.asarray(meshed[name].data, np.float64)
        peak = float(np.abs(a).max())
        atol = final_atol if name == "p_final" else MESH_ATOL
        bad = np.abs(b - a) > atol * peak + MESH_RTOL * np.abs(a)
        _require(a.shape == b.shape and np.isfinite(b).all() and not bad.any(),
                 f"{what}: {name} off the other run at {int(bad.sum())} points (max "
                 f"{np.abs(b - a).max() / peak:.3g} of its peak, atol {atol:g})")
        errs[name] = float(np.abs(b - a).max() / peak)

    def coeffs(out):
        rows = np.ascontiguousarray(out["p_c"].data[0]).view(np.uint8)
        n = out["p"].data.shape[-1]
        h, r, i = oracle.bytes_to_soa(np.ascontiguousarray(rows[:, : 5 * n]).reshape(-1))
        return np.stack(oracle.decode40(h.reshape(-1, n, 1), r.reshape(-1, n, 1),
                                        i.reshape(-1, n, 1), oracle.MAX_EXP_P))

    ca, cb = coeffs(single), coeffs(meshed)
    err = float(np.abs(ca - cb).max() / np.abs(ca).max())
    _require(err <= DECODE_TOL, f"{what}: decoded p_c off by {err:.3g} of the peak")
    errs["p_c decoded"] = err
    series = np.asarray(meshed["p"].data[0])
    frames, _ = encoder.encode_series_exact(
        torch.from_numpy(series).cuda(), generate_basis(float(O_SIZE), 1, 1, normalize=True),
        mode40=True, total_steps=series.shape[0])
    mine = encoder.frames_to_flat_40b(*frames)
    stored = np.ascontiguousarray(meshed["p_c"].data[0]).view(np.uint8)[:, : mine.shape[1]]
    _require(np.array_equal(mine, stored),
             f"{what}: its p series encoded on one device != its p_c bytes")
    return errs


def _same_bits(a, b) -> list[str]:
    """The datasets of two runs' outputs that differ in a bit."""
    a, b = dict(_datasets(a)), dict(_datasets(b))
    return [k for k in a if k not in b or not np.array_equal(
        np.ascontiguousarray(a[k]).view(np.uint8), np.ascontiguousarray(b[k]).view(np.uint8))]


def _rounding_witness(data, one) -> dict:
    """The one-device run ``one`` against the same run with p0 tripled, its fields divided
    by 3: one linear problem through other roundings. How far p, p_max_all and p_final
    move, each of its own peak: the fields' own rounding at this size, which the mesh's
    gap from the one-device run is read against."""
    import dataclasses

    tripled, _, _, _ = _run(MESH_FLAGS, MESH_WINDOWS, MESH_TAIL, compact_operators=True,
                            data=dataclasses.replace(data, p0=data.p0 * np.float32(3)))
    errs = {}
    for name in ("p", "p_max_all", "p_final"):
        a = np.asarray(one[name].data, np.float64)
        b = np.asarray(tripled[name].data, np.float64) / 3
        errs[name] = float(np.abs(b - a).max() / np.abs(a).max())
    return errs


def _final_controls(single, meshed, s: int) -> dict:
    """Two faults the p_final check (FINAL_ATOL) must catch, with each one's reading of the
    peak: the mesh run's p_final rounded to fp16, and its z-slabs one shard out of
    order."""
    a = np.asarray(single["p_final"].data, np.float64)
    b = np.asarray(meshed["p_final"].data, np.float32)
    peak = float(np.abs(a).max())
    faults = {"fp16": (b / np.float32(peak)).astype(np.float16).astype(np.float64) * peak,
              "a slab out of order": np.roll(b.reshape(BIG_N, -1), BIG_N // s,
                                             axis=0).reshape(b.shape).astype(np.float64)}
    out = {}
    for name, got in faults.items():
        bad = np.abs(got - a) > FINAL_ATOL * peak + MESH_RTOL * np.abs(a)
        _require(bad.any(), f"the p_final check passes a fault: {name}")
        out[name] = float(np.abs(got - a).max() / peak)
    return out


def _per_axis(n: int, s: int) -> dict:
    """Every spectral multiplier of the step on a mesh of s shards at n^3, one axis at a
    time, against the single-device step on the card: the pressure gradient (ddk_pos *
    kappa), the velocity divergence terms (ddk_neg * kappa), the absorbing nablas, the
    additive source's source_kappa and the velocity's half-cell shifts. Returns name ->
    rel L2."""
    import torch

    from kwave_tpu_torch.parallel import field_sharding, pencil_fft, shard_operators
    from kwave_tpu_torch.solver import Grid, Medium, make_operators, shifted_velocity
    from kwave_tpu_torch.solver.step import SimState, _grad_fields, _irfftn, _rfftn

    grid = Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=1e-8, nt=1)
    medium = Medium(c0=1500.0, rho0=1000.0, alpha_coeff=0.75, alpha_power=1.5)
    ops = make_operators(grid, medium, (10, 10, 10), (2.0,) * 3, absorbing=True,
                         need_source_kappa=True, need_shift=True, device="cuda")
    mesh = _mesh(s)
    ops_s = shard_operators(ops, 3, mesh, grid=grid)
    fft = pencil_fft(mesh, n)
    gen = torch.Generator(device="cuda").manual_seed(n + s)
    f = [torch.randn(grid.shape, device="cuda", generator=gen) for _ in range(3)]
    fs = [field_sharding(mesh, x) for x in f]

    def whole(x):
        return torch.cat(x.shards, dim=0)

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    out = {}
    for sign in ("pos", "neg"):
        dds = [getattr(ops, f"dd{a}_{sign}") for a in "xyz"]
        dds_s = [getattr(ops_s, f"dd{a}_{sign}") for a in "xyz"]
        one = _grad_fields(f[0], ops, *dds, grid.shape)
        many = _grad_fields(fs[0], ops_s, *dds_s, fs[0].shards[0].shape, fft=fft)
        for a, x, y in zip("xyz", one, many):
            out[f"dd{a}_{sign}"] = rel(whole(y), x)
    shape_s = fs[0].shards[0].shape
    for name, op, op_s in (("nabla1", ops.absorb_nabla1, ops_s.absorb_nabla1),
                           ("nabla2", ops.absorb_nabla2, ops_s.absorb_nabla2),
                           ("source_kappa", ops.source_kappa, ops_s.source_kappa)):
        one = _irfftn(_rfftn(f[1]) * op, grid.shape)
        out[name] = rel(whole(fft.irfftn(fft.rfftn(fs[1]) * op_s, shape_s)), one)
    zero = torch.zeros(grid.shape, device="cuda")
    state = SimState(p=zero, ux_sgx=f[0], uy_sgy=f[1], uz_sgz=f[2], rho_x=zero,
                        rho_y=zero, rho_z=zero)
    zs = field_sharding(mesh, zero)
    state_s = SimState(p=zs, ux_sgx=fs[0], uy_sgy=fs[1], uz_sgz=fs[2], rho_x=zs,
                          rho_y=zs, rho_z=zs)
    for a, x, y in zip("xyz", shifted_velocity(state, ops),
                       shifted_velocity(state_s, ops_s, fft)):
        out[f"shift_{a}"] = rel(whole(y), x)
    return out


def _transpose_time(n: int, s: int) -> tuple[float, float, float]:
    """(bytes, device ms, GB/s) of one z-for-y trade of an n^3 spectrum over s shards on
    the card: every shard's slab read once and written once."""
    import torch

    from kwave_tpu_torch.parallel import field_sharding
    from kwave_tpu_torch.parallel import fft as dfft

    mesh = _mesh(s)
    xk = torch.fft.rfft(torch.randn(n, n, n, device="cuda"), dim=2)
    parts = field_sharding(mesh, xk)
    ms, _ = _time_per_call(lambda: dfft.z_to_y(parts, mesh), iters=20, warmup=3)
    n_bytes = 2.0 * xk.numel() * xk.element_size()
    return n_bytes, ms, n_bytes / ms / 1e6


def _pencil_alone(n: int) -> list[str]:
    """Phase 11 (b): the pencil FFT at n^3 on 2 and 4 shards against torch.fft on the
    card, and a multiply by the step's kappa; one trade's bytes and time. The multiplier
    is a real one that is even in k, as every multiplier of the step: it keeps the
    product the spectrum of a real field. A random multiplier does not (it breaks the
    Hermitian symmetry of the kx = 0 and Nyquist planes), and cuFFT's 3D c2r and the
    pencil's 2D c2r then each drop a different part of what belongs to no real field
    (0.027 of the peak at 256^3, where the CPU's transforms agree)."""
    import torch

    from kwave_tpu_torch.parallel import field_sharding
    from kwave_tpu_torch.parallel import fft as dfft
    from kwave_tpu_torch.solver import Grid, Medium, make_operators

    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(n, n, n, device="cuda", generator=gen)
    grid = Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=1e-8, nt=1)
    kap = make_operators(grid, Medium(c0=1500.0, rho0=1000.0), (10, 10, 10), (2.0,) * 3,
                         device="cuda").kappa
    ref = torch.fft.rfftn(x)
    ref_op = torch.fft.irfftn(ref * kap, s=x.shape)
    lines = []
    for s in (2, 4):
        mesh = _mesh(s)
        xs = field_sharding(mesh, x)
        k = dfft.dist_rfftn(xs, mesh)
        fwd = float((torch.cat(k.shards, 1) - ref).abs().max() / ref.abs().max())
        back = torch.cat(dfft.dist_irfftn(k, n, mesh).shards, 0)
        rt = float((back - x).abs().max() / x.abs().max())
        op = torch.cat(dfft.dist_irfftn(k * dfft.spectral_sharding(mesh, kap), n,
                                        mesh).shards, 0)
        mul = float((op - ref_op).abs().max() / ref_op.abs().max())
        _require(max(fwd, rt, mul) <= PENCIL_TOL,
                 f"pencil FFT at {n}^3 on {s} shards: rfftn {fwd:.3g}, round trip {rt:.3g}, "
                 f"kappa multiply {mul:.3g} of the peak")
        n_bytes, ms, rate = _transpose_time(n, s)
        lines.append(f"S={s}: rfftn off torch.fft.rfftn {fwd:.2e}, round trip {rt:.2e}, "
                     f"kappa multiply {mul:.2e} of the peak; one z-for-y trade "
                     f"{n_bytes / 1e6:.1f} MB in {ms:.4f} ms ({rate:.0f} GB/s)")
    return lines


def mesh_phase(smi):
    """Phase 11: kwave_tpu_torch.parallel on the one card (module docstring). Every part
    runs and reports; a part that fails is printed as a FAULT, and the phase then fails
    with all of them. Returns the window kernels' launches on the mesh path (the S = 4,
    2 and 1 runs)."""
    import copy
    import dataclasses

    import torch
    import torch.distributed as dist

    from kwave_tpu_torch.ops import encode_window as ew
    from kwave_tpu_torch.parallel import make_mesh
    from kwave_tpu_torch.parallel.comm import ProcessGroup
    from kwave_tpu_torch.parallel.distributed import WriterGather, initialize

    t_phase = time.perf_counter()
    steps = MESH_WINDOWS * O_SIZE + MESH_TAIL
    data = _input(steps, BIG_N)
    compact = dict(compact_operators=True)
    faults: list[str] = []

    def part(fn, *args):
        try:
            return fn(*args)
        except AssertionError as e:
            faults.append(str(e))
            print(f"[11 mesh] FAULT: {e}", flush=True)
            return None

    # (a) full width: one device (key 0), then 4, 2 and 1 shards on it
    outs, ms_step, launches = {}, {}, {}

    def full_width(s):
        # warm-up: the CUDA context, the build and the cuFFT plans of this layout (3 steps)
        short = dataclasses.replace(data, grid=dataclasses.replace(data.grid, nt=3))
        _run(MESH_FLAGS, 0, 3, data=short, mesh=_mesh(s) if s else None, **compact)
        ew.reset_launch_counts()
        out, secs, _, _ = _run(MESH_FLAGS, MESH_WINDOWS, MESH_TAIL, data=data,
                               mesh=_mesh(s) if s else None, **compact)
        launches[s] = dict(ew.LAUNCHES)
        outs[s] = out
        ms_step[s] = float(out.attrs["simulation_phase_execution_time"]) / steps * 1e3
        on = f"S={s}" if s else "one device"
        print(f"[11 mesh] (a) {' '.join(MESH_FLAGS)}: {BIG_N}^3, {N_SENSORS} sensors, "
              f"{steps} steps, {on}: {ms_step[s]:.3f} ms/step in the simulation phase, "
              f"{secs / steps * 1e3:.3f} end to end; K1a (w40_overlap) launched "
              f"{launches[s]['w40_overlap'] / max(s, 1):g}x on each of the {max(s, 1)} "
              f"shards ({smi})", flush=True)
        want = max(s, 1) * (MESH_WINDOWS + 1)  # every shard a window and the tail
        _require(launches[s] == {k: (want if k == "w40_overlap" else 0) for k in ew.LAUNCHES},
                 f"{on}: window-encode launches {launches[s]}, expected {want} of w40")
        if s:
            errs = _hold_mesh_run(outs[0], out, on)
            print(f"[11 mesh] (a) {on} against one device, of each one's own peak: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                  + "; its p re-encoded on one device == its p_c bytes", flush=True)

    for s in (0, 4, 2, 1):
        part(full_width, s)

    def witnesses():
        # the shards against the one-shard pencil: what sharding itself adds
        for s in (4, 2):
            errs = _hold_mesh_run(outs[1], outs[s], f"S={s} against S=1", MESH_ATOL)
            differ = _same_bits(outs[1], outs[s])
            print(f"[11 mesh] (a) S={s} against S=1 (the pencil unsharded): "
                  + (f"differs in {differ}, of each one's own peak: " + ", ".join(
                      f"{k} {v:.3g}" for k, v in errs.items()) if differ
                     else "equal bit for bit in every dataset"), flush=True)
        # the one-device run against itself through other roundings, and two faults
        errs = _rounding_witness(data, outs[0])
        ctrl = _final_controls(outs[0], outs[4], 4)
        print(f"[11 mesh] (a) one device against itself with p0 x3 (fields / 3), of each "
              f"one's own peak: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f"; p_final faults the check (atol {FINAL_ATOL:g}) catches: " + ", ".join(
                  f"{k} {v:.3g}" for k, v in ctrl.items()), flush=True)

    part(witnesses)

    def pencil():  # (b) the pencil FFT alone
        for line in _pencil_alone(BIG_N):
            print(f"[11 mesh] (b) pencil FFT at {BIG_N}^3, {line} ({smi})", flush=True)

    part(pencil)

    # (c) every spectral multiplier per axis, at 128^3 and 256^3; then the velocity shift
    # and the Q term through runs at 128^3
    def axes(n):
        errs = _per_axis(n, 4)
        print(f"[11 mesh] (c) {n}^3, S=4 against one device, rel L2 per multiplier and "
              f"axis: " + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()), flush=True)
        worst = max(errs, key=errs.get)
        _require(errs[worst] <= AXIS_TOL, f"per-axis multipliers at {n}^3: {worst} "
                 f"{errs[worst]:.3g}")

    for n in (GRID_N, BIG_N):
        part(axes, n)

    def q_run():
        q_flags = ["--p_raw", "--u_non_staggered_raw", "--I_avg", "--Q_term"]
        q_data = _input(steps)
        q_one, _, _, _ = _run(q_flags, MESH_WINDOWS, MESH_TAIL, data=q_data)
        q_mesh, _, _, _ = _run(q_flags, MESH_WINDOWS, MESH_TAIL, data=q_data, mesh=_mesh(4))
        errs, got = {}, dict(_datasets(q_mesh))
        # the Q term is a sum of terms up to k_max |I| that cancel (phase 9): it is held
        # to Q_TOL of k_max |I|max, the rest to rel L2 1e-4
        i_max = max(float(np.abs(v).max()) for k, v in got.items() if k.endswith("_avg"))
        q_scale = np.pi / min(q_data.grid.dx, q_data.grid.dy, q_data.grid.dz) * i_max
        for name, a in _datasets(q_one):
            a64, b64 = np.asarray(a, np.float64), np.asarray(got[name], np.float64)
            errs[name] = float(np.abs(b64 - a64).max() / q_scale) if name == "Q_term" \
                else float(np.linalg.norm(b64 - a64) / np.linalg.norm(a64))
        print(f"[11 mesh] (c) {' '.join(q_flags)}: {GRID_N}^3, S=4 against one device: "
              f"rel L2 " + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()
                                     if k != "Q_term")
              + f"; Q_term {errs['Q_term']:.1e} of k_max |I|max", flush=True)
        bad = {k: v for k, v in errs.items() if v > (Q_TOL if k == "Q_term" else 1e-4)}
        _require(not bad, f"128^3 S=4 run off one device: {bad}")

    part(q_run)

    def nccl():  # (d) the process communicator at world size 1 over NCCL
        one_shard = _mesh(1)  # made first: under a process group the mesh is the group's
        initialize(f"localhost:{_free_port()}", 1, 0, "cuda")
        try:
            _require(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
            pg = make_mesh()
            _require(isinstance(pg.comm, ProcessGroup) and pg.size == 1
                     and WriterGather()._nproc == 1, f"process mesh {pg}")
            # cold: the group's first run, then the same run again
            ms_pg = {}
            for when in ("cold", "warm"):
                out, _, _, _ = _run(MESH_FLAGS, MESH_WINDOWS, MESH_TAIL, data=data,
                                    mesh=pg, **compact)
                ms_pg[when] = float(out.attrs["simulation_phase_execution_time"]) / steps * 1e3
            print(f"[11 mesh] (d) process group over NCCL, world size 1 (make_mesh() -> "
                  f"{pg}): {ms_pg['cold']:.3f} ms/step cold, {ms_pg['warm']:.3f} warm, "
                  f"against S=1 in one process {ms_step.get(1, float('nan')):.3f} and one "
                  f"device {ms_step.get(0, float('nan')):.3f} ({smi})", flush=True)
            errs = _hold_mesh_run(outs[0], out, "NCCL world 1")
            differ = _same_bits(outs[1], out)
            for name, mesh in (("NCCL world 1", pg), ("S=1 in one process", one_shard)):
                dev_ms, top, _, host = _profile_window(data, MESH_FLAGS, host_top=6,
                                                       mesh=mesh, **compact)
                print(f"[11 mesh] (d) profile, {name}, one {O_SIZE}-step run with its "
                      f"set-up: {dev_ms:.3f} ms of kernel time per step; " + "; ".join(
                          f"{k} {share:.1%}" for k, share in top)
                      + "; host self ms per step: " + ", ".join(
                          f"{k} {t:.3f}" for k, t in host), flush=True)
        finally:
            dist.destroy_process_group()
        print(f"[11 mesh] (d) against one device, of each one's own peak: " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()) + "; against S=1 in one process: "
            + (f"differs in {differ}" if differ else "equal bit for bit"), flush=True)

    part(nccl)

    def legs():  # (e) the S = 4 run in one leg and in four; a checkpoint on one device
        leg_steps = MESH_LEGS_WINDOWS * O_SIZE + MESH_TAIL
        leg_data = _input(leg_steps, BIG_N)
        one_leg, _, _, _ = _run(MESH_FLAGS, MESH_LEGS_WINDOWS, MESH_TAIL, data=leg_data,
                                mesh=_mesh(4), **compact)
        out_b, ckpt, resume, stops, first = MemGroup(), MemGroup(), None, [], None
        while True:
            _, _, _, summary = _run(MESH_FLAGS, MESH_LEGS_WINDOWS, MESH_TAIL,
                                    data=leg_data, out=out_b, resume_from=resume,
                                    mesh=_mesh(4), checkpoint_file=ckpt,
                                    checkpoint_interval_steps=O_SIZE, **compact)
            stops.append(summary.get("__checkpointed_at__"))
            if first is None:
                first = (copy.deepcopy(ckpt), copy.deepcopy(out_b))
            if stops[-1] is None:
                break
            resume = ckpt
            _require(len(stops) < 10, f"the mesh run in legs does not end: {stops}")
        _require(len(stops) == MESH_LEGS_WINDOWS + 1, f"legs stopped at {stops}")
        differing = _same_bits(one_leg, out_b) + _same_bits(out_b, one_leg)
        _require(not differing, f"S=4 in {len(stops)} legs != one leg in {differing}")
        print(f"[11 mesh] (e) {BIG_N}^3 S=4, {leg_steps} steps: {len(stops)} legs "
              f"(checkpoints at {[x[0] for x in stops if x]}) == one leg bit for bit in "
              f"all {len(dict(_datasets(one_leg)))} datasets", flush=True)
        resumed = first[1]
        _run(MESH_FLAGS, MESH_LEGS_WINDOWS, MESH_TAIL, data=leg_data, out=resumed,
             resume_from=first[0], **compact)
        errs = _hold_mesh_run(one_leg, resumed, "S=4 checkpoint resumed on one device")
        print(f"[11 mesh] (e) the first checkpoint resumed on one device, against the "
              f"one-leg mesh run, of each one's own peak: " + ", ".join(
                  f"{k} {v:.3g}" for k, v in errs.items()), flush=True)

    part(legs)
    torch.cuda.empty_cache()
    print(f"[11 mesh] phase 11 in {time.perf_counter() - t_phase:.1f} s, {len(faults)} "
          f"faults", flush=True)
    _require(not faults, "phase 11: " + " | ".join(faults))
    return {k: sum(launches[s][k] for s in (4, 2, 1)) for k in launches[4]}


# phase 12: the window as one device program (CUDA graphs of the window)
GRAPH_WINDOWS = 13  # 1 eager, 2 captured, 10 replayed
GRAPH_TAIL = 5
GRAPH_CELLS = (  # (what, nz x ny x nx, flags, RunConfig fields)
    ("128^3 main path", (GRID_N,) * 3, ["--p_raw", "--p_c", "--40-bit_complex"], {}),
    ("256^3 unfused", (BIG_N,) * 3, FUSED_FLAGS, RUN_FIELDS["compact"]),
    ("256^3 fused", (BIG_N,) * 3, FUSED_FLAGS, RUN_FIELDS["fused"]),
    ("251^3 fused", (251,) * 3, FUSED_FLAGS, RUN_FIELDS["fused"]),
    ("6 x 1152^2 fused", (6, 1152, 1152), FUSED_FLAGS, RUN_FIELDS["fused"]),
)
GRAPH_VARIANT_WINDOWS = 6  # the main path's other three variants: 6 windows and the tail
GRAPH_PROFILE_WINDOWS = 6  # the profiled eager run of each cell


def _launch_counts() -> dict:
    from kwave_tpu_torch.ops import encode_window as ew
    from kwave_tpu_torch.ops import zfuse

    return {**ew.LAUNCHES, **zfuse.LAUNCHES,
            **{f"k7 {k}": v for k, v in zfuse.KERNEL_LAUNCHES.items()}}


def _replay_ms(graphs, reps: int = 3, profile: bool = True) -> tuple[float, float | None]:
    """Device ms per step of one captured window replayed ``reps`` times on its own static
    state: (CUDA events around the replays on the capturing card, where a graph over
    several cards also ends; torch.profiler's kernel time of another ``reps``, or None
    without ``profile``). The launch counters are left as they were."""
    import torch
    from torch.profiler import ProfilerActivity

    from kwave_tpu_torch.ops import encode_window as ew
    from kwave_tpu_torch.ops import zfuse

    saved = [(d, dict(d)) for d in (ew.LAUNCHES, zfuse.LAUNCHES, zfuse.KERNEL_LAUNCHES)]
    key = next(iter(graphs.capture_seconds))
    graphs.replay(key, graphs.static, 0)  # warm
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graphs.replay(key, graphs.static, 0)
    end.record()
    torch.cuda.synchronize()
    kernels = None
    if profile:
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                graphs.replay(key, graphs.static, 0)
            torch.cuda.synchronize()
        kernels = sum(getattr(e, "self_device_time_total", None) or
                      getattr(e, "self_cuda_time_total", 0) for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA")) / 1e3 / (reps * O_SIZE)
    for d, was in saved:  # these replays are no path's launches
        d.update(was)
    return start.elapsed_time(end) / (reps * O_SIZE), kernels


def _window_starts(calls: list):
    """A context in which every call of a run's window object appends its start time on
    the host's clock to ``calls`` (the windows themselves run unchanged)."""
    import contextlib

    from kwave_tpu_torch import driver

    @contextlib.contextmanager
    def recording():
        orig = driver._Window.__call__

        def call(self, *args, **kwargs):
            calls.append(time.perf_counter())
            return orig(self, *args, **kwargs)

        driver._Window.__call__ = call
        try:
            yield
        finally:
            driver._Window.__call__ = orig

    return recording()


def _graph_cell(what, shape, flags, fields, mesh=None, tag="[12 graph]",
                profile_windows=GRAPH_PROFILE_WINDOWS) -> dict:
    """One cell of phase 12. After an eager warm-up run (the grid's first run pays its
    set-up), runs of GRAPH_WINDOWS windows (and a tail) with every window eager and with
    graphs, in the order eager, graphs, graphs, eager, each after the allocator's cache is
    emptied: the first of each way equal bit for bit with equal launches, and give the
    peak memory; the graph runs' windows as planned. Warm ms/step of each run: the median
    time from one window's start to the next's over the windows from the fourth on (with
    graphs: replayed windows only), over o; beside it the simulation phase's ms/step.
    Device ms/step (torch.profiler's kernels) of an eager run and of replayed windows,
    beside CUDA events around the replays; capture time per key. On ``mesh`` where given
    (phase 13); ``tag`` heads the printed lines; the eager run profiled has
    ``profile_windows`` windows. Returns the graph run's launches and the cell's K7
    kernel."""
    import dataclasses

    import torch

    from kwave_tpu_torch.ops import zfuse

    t0 = time.perf_counter()
    base = _input(GRAPH_WINDOWS * O_SIZE + GRAPH_TAIL, shape=shape)
    _run(flags, 2, GRAPH_TAIL, cuda_graphs=False, mesh=mesh, **fields,
         data=dataclasses.replace(base, grid=dataclasses.replace(
             base.grid, nt=2 * O_SIZE + GRAPH_TAIL)))
    outs, counts, logs, peak, warm, sim = {}, {}, {}, {}, {}, {}
    for graphs in (False, True, True, False):
        log, starts, before = [], [], _launch_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with _window_starts(starts):
            out, _, steps, _ = _run(flags, GRAPH_WINDOWS, GRAPH_TAIL, data=base,
                                    window_log=log, cuda_graphs=graphs, mesh=mesh,
                                    **fields)
        gaps = np.diff(starts[3:]) / O_SIZE * 1e3  # from the 4th window on
        warm.setdefault(graphs, []).append(float(np.median(gaps)))
        sim.setdefault(graphs, []).append(
            float(out.attrs["simulation_phase_execution_time"]) / steps * 1e3)
        if graphs not in outs:
            outs[graphs], logs[graphs] = out, log
            peak[graphs] = (torch.cuda.max_memory_allocated() / 2**30,
                            torch.cuda.max_memory_reserved() / 2**30)
            counts[graphs] = {k: v - before[k] for k, v in _launch_counts().items()}
        if graphs:
            acts = _check_actions(log, GRAPH_WINDOWS)
        else:
            _require(all(a == "eager" for x in log for _, a in x.actions),
                     f"{what}: a window of the eager run was not eager")
    differ = _same_bits(outs[False], outs[True])
    _require(not differ, f"{what}: the graph run differs from the eager run in {differ}")
    _require(counts[True] == counts[False],
             f"{what}: launches with graphs {counts[True]}, eager {counts[False]}")
    t_prof = time.perf_counter()
    dev = {False: _profile_window(base, flags, windows=profile_windows,
                                  cuda_graphs=False, mesh=mesh, **fields)[0]}
    replay, dev[True] = _replay_ms(logs[True][1].graphs)
    t_prof = time.perf_counter() - t_prof
    capture = sorted(logs[True][1].graphs.capture_seconds.values())
    idle = {g: 1 - dev[g] / float(np.mean(warm[g])) for g in (False, True)}
    kernel = zfuse.kernel_for(shape[0]) if fields.get("fuse_z") else None
    print(f"{tag} {what}: {GRAPH_WINDOWS} windows + {GRAPH_TAIL} with graphs == every "
          f"window eager, bit for bit ({len(list(_datasets(outs[True])))} datasets); windows "
          f"{acts}; launches eager == graph: "
          f"{ {k: v for k, v in counts[True].items() if v} }", flush=True)
    print(f"{tag} {what}: warm ms/step eager {warm[False]}, graph {warm[True]} "
          f"(two runs each; simulation phase of the {GRAPH_WINDOWS}-window runs, first "
          f"windows and captures included: eager {sim[False]}, graph {sim[True]}); "
          f"device ms/step (profiler's kernels) "
          f"eager {dev[False]:.4f} ({profile_windows}-window run), graph "
          f"{dev[True]:.4f} (replayed windows; CUDA events around them "
          f"{replay:.4f}); idle eager {idle[False]:.1%}, graph "
          f"{idle[True]:.1%}; capture + instantiate per key {capture} s; peak memory "
          f"allocated / reserved eager {peak[False][0]:.3f} / {peak[False][1]:.3f} GiB, "
          f"graph {peak[True][0]:.3f} / {peak[True][1]:.3f} GiB; the cell in "
          f"{time.perf_counter() - t0:.1f} s, its profiles {t_prof:.1f} s", flush=True)
    del outs, logs
    torch.cuda.empty_cache()
    return {"counts": counts[True], "kernel": kernel}


def graph_phase(smi):
    """Phase 12: `GRAPH_CELLS` (`_graph_cell`), then the main path's other three
    variants at 128^3 with graphs against eager, bit for bit. Returns the launches of
    the graph runs by `encode_window.LAUNCHES` key and, for K7, by kernel and op count."""
    from kwave_tpu_torch.ops import encode_window as ew

    print(f"[12 graph] card {smi}", flush=True)
    window, k7 = {k: 0 for k in ew.LAUNCHES}, {}
    for what, shape, flags, fields in GRAPH_CELLS:
        got = _graph_cell(what, shape, flags, fields)
        for k in window:
            window[k] += got["counts"][k]
        if got["kernel"] is not None:
            _require(got["counts"][f"k7 {got['kernel']}"] > 0,
                     f"{what}: no {got['kernel']} K7 launch")
            have = k7.setdefault(got["kernel"], {})
            for n in ("zfuse_1op", "zfuse_2op", "zfuse_3op"):
                have[n] = have.get(n, 0) + got["counts"][n]
    w = GRAPH_VARIANT_WINDOWS
    for flags, variant in ((["--p_raw", "--p_c", "--no_overlap"], "wfloat_no_overlap"),
                           (["--p_raw", "--p_c", "--40-bit_complex", "--no_overlap"],
                            "w40_no_overlap"),
                           (["--p_raw", "--p_c"], "wfloat_overlap")):
        outs, counts = {}, {}
        for graphs in (False, True):
            log, before = [], _launch_counts()
            outs[graphs], *_ = _run(flags, w, GRAPH_TAIL, window_log=log,
                                    cuda_graphs=graphs)
            counts[graphs] = {k: v - before[k] for k, v in _launch_counts().items()}
        acts = _check_actions(log, w)
        differ = _same_bits(outs[False], outs[True])
        _require(not differ and counts[True] == counts[False]
                 and counts[True][variant] == w + 1,
                 f"{flags}: graph vs eager differ in {differ}; launches {counts}")
        window[variant] += counts[True][variant]
        print(f"[12 graph] {' '.join(flags)}: {w} windows + {GRAPH_TAIL} with graphs == "
              f"eager, bit for bit; windows {acts}; {variant} launched "
              f"{counts[True][variant]}x both ways", flush=True)
    _require(all(window[k] > 0 for k in VARIANTS), f"phase 12: launches {window}")
    return window, k7


# phase 13: the mesh's window as one device program (CUDA graphs over the pencil's trades)
MESH_GRAPH_SHARDS = 4
CARDS_GRIDS = (BIG_N, 512)  # --mesh-processes: phase 11 (a)'s input at these n^3 across the cards
MESH_GRAPH_PROFILE_WINDOWS = 2  # the eager run profiled: S shards' launches slow the profiler


def _free_port() -> int:
    import socket

    probe = socket.socket()
    probe.bind(("localhost", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def mesh_graph_phase(smi):
    """Phase 13: phase 11 (a)'s 256^3 input (``MESH_FLAGS``, compact operators) on 4 shards
    of cuda:0 in one process, then through a process group of one over NCCL, each as
    phase 12's cell (`_graph_cell`: 13 windows and a 5-step tail, eager, graphs, graphs,
    eager; bit for bit, equal launches, the windows as planned; warm and device ms/step,
    idle share, capture per key, peak memory); then that group with 2 shards of cuda:0
    (C = 2: one slot group a shard, each split from the default group), eager and with
    graphs in turns (`_turns`), bit for bit to 2 shards of cuda:0 in one process.
    Returns the graph runs' launches by `encode_window.LAUNCHES` key."""
    import gc

    import torch
    import torch.distributed as dist

    from kwave_tpu_torch.ops import encode_window as ew
    from kwave_tpu_torch.parallel import make_mesh
    from kwave_tpu_torch.parallel.comm import ProcessGroup
    from kwave_tpu_torch.parallel.distributed import initialize

    print(f"[13 mesh graph] card {smi}", flush=True)
    compact = dict(compact_operators=True)
    shape = (BIG_N,) * 3
    mesh = _mesh(MESH_GRAPH_SHARDS)
    _require(mesh.graph_devices == (torch.device("cuda", 0),) * MESH_GRAPH_SHARDS,
             f"{mesh}: graphs on {mesh.graph_devices}")
    got = _graph_cell(f"{BIG_N}^3, {MESH_GRAPH_SHARDS} shards of cuda:0", shape,
                      MESH_FLAGS, compact, mesh=mesh, tag="[13 mesh graph]",
                      profile_windows=MESH_GRAPH_PROFILE_WINDOWS)
    launches = {k: got["counts"][k] for k in ew.LAUNCHES}
    data = _input(GRAPH_WINDOWS * O_SIZE + GRAPH_TAIL, BIG_N)
    # made before the group: under one make_mesh builds the group's mesh
    in_process, _, _, _ = _run(MESH_FLAGS, GRAPH_WINDOWS, GRAPH_TAIL, data=data,
                               mesh=_mesh(2), **compact)

    def slots():  # C = 2 shards of cuda:0 under the group of one
        two = make_mesh(2, devices=["cuda:0"] * 2)
        _require(isinstance(two.comm, ProcessGroup) and two.comm.local == 2
                 and two.shard_ids == [0, 1]
                 and two.graph_devices == (torch.device("cuda", 0),) * 2,
                 f"{two}: graphs on {two.graph_devices}")
        res = _turns(data, two)
        differ = _same_bits(res["outs"][False], res["outs"][True])
        differ_one = _same_bits(res["outs"][True], in_process)
        counts = res["counts"][True]
        print(f"[13 mesh graph] {BIG_N}^3, NCCL at world size 1 with 2 shards of cuda:0 "
              f"({two}): graphs == eager bit for bit ({differ or 'equal'}), launches equal; "
              f"== 2 shards of cuda:0 in one process ({differ_one or 'equal'}); windows "
              f"{res['acts']}; K1a (w40_overlap) launches {counts['w40_overlap']}; warm "
              f"ms/step eager {res['warm'][False]}, graph {res['warm'][True]}; simulation "
              f"phase ms/step eager {res['sim'][False]}, graph {res['sim'][True]}",
              flush=True)
        _require(not differ and not differ_one, f"C = 2 on cuda:0: graphs differ from eager "
                 f"in {differ}, from one process in {differ_one}")
        return counts

    initialize(f"localhost:{_free_port()}", 1, 0, "cuda")
    try:
        pg = make_mesh()
        _require(pg.graph_devices == (torch.device("cuda", 0),),
                 f"{pg}: graphs on {pg.graph_devices}")
        got = _graph_cell(f"{BIG_N}^3, NCCL at world size 1", shape, MESH_FLAGS, compact,
                          mesh=pg, tag="[13 mesh graph]",
                          profile_windows=MESH_GRAPH_PROFILE_WINDOWS)
        two_counts = slots()
    finally:
        gc.collect()  # the graphs that hold NCCL's trades go before its communicator
        torch.cuda.synchronize()
        dist.destroy_process_group()
    for k in launches:
        launches[k] += got["counts"][k] + two_counts[k]
    _require(launches["w40_overlap"] > 0 and two_counts["w40_overlap"] > 0,
             f"phase 13: launches {launches}, C = 2 {two_counts}")
    return launches


def _turns(data, mesh=None) -> dict:
    """Phase 11 (a)'s flags on ``data`` (GRAPH_WINDOWS windows and a tail) with every
    window eager and with graphs, in the order eager, graphs, graphs, eager. Returns the
    first output of each way ("outs") and its launches ("counts"), warm ms/step (phase
    12's measure) and simulation phase ms/step of every run by way ("warm", "sim"), the
    graph runs' windows by action ("acts"), the first graph run's window object
    ("window": its graphs, and the operators, mask and tables that they read, which must
    outlive any later replay) and the peak memory allocated on each card of the run, GiB,
    in its first run each way ("peak")."""
    import torch

    cards = list(dict.fromkeys(mesh.devices)) if mesh is not None else \
        [torch.device("cuda", torch.cuda.current_device())]
    res = {"outs": {}, "counts": {}, "warm": {}, "sim": {}, "peak": {}}
    for graphs in (False, True, True, False):
        log, starts, before = [], [], _launch_counts()
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        with _window_starts(starts):
            out, _, steps, _ = _run(MESH_FLAGS, GRAPH_WINDOWS, GRAPH_TAIL, data=data,
                                    mesh=mesh, window_log=log, cuda_graphs=graphs,
                                    compact_operators=True)
        res["warm"].setdefault(graphs, []).append(float(np.median(np.diff(starts[3:]))
                                                        / O_SIZE * 1e3))
        if "simulation_phase_execution_time" in out.attrs:  # the writer's output alone
            res["sim"].setdefault(graphs, []).append(
                float(out.attrs["simulation_phase_execution_time"]) / steps * 1e3)
        if graphs not in res["outs"]:
            res["outs"][graphs] = out
            res["counts"][graphs] = {k: v - before[k] for k, v in _launch_counts().items()}
            res["peak"][graphs] = [torch.cuda.max_memory_allocated(d) / 2**30 for d in cards]
            if graphs:
                res["window"] = log[1]
        if graphs:
            res["acts"] = _check_actions(log, GRAPH_WINDOWS)
    _require(res["counts"][True] == res["counts"][False],
             f"launches with graphs {res['counts'][True]}, eager {res['counts'][False]}")
    return res


MESH_DATASETS = ("p", "p_c", "p_max_all", "p_final")  # what --save-outputs keeps


def _save_outputs(out, path: Path) -> None:
    np.savez(path, **{k: np.asarray(out[k].data) for k in MESH_DATASETS})


def _differ_from_saved(out, path: Path) -> list[str]:
    """The datasets of ``out`` that differ in a bit from those `_save_outputs` wrote."""
    with np.load(path) as saved:
        return [k for k in MESH_DATASETS if not np.array_equal(
            np.ascontiguousarray(out[k].data).view(np.uint8),
            np.ascontiguousarray(saved[k]).view(np.uint8))]


def _rank_phase(rank: int, world: int, port: int, save_to: Path | None = None,
                per: int = 1) -> int:
    """One rank of ``--mesh-processes``: phase 11 (a)'s input at each of CARDS_GRIDS through
    `run_simulation` on a mesh of ``per`` shards a process (NCCL, cards rank·per ..
    rank·per + per - 1). With one card a process: 13 windows and a tail eager and with
    graphs in turns (`_turns`; rank 0 holds the graph run to the eager one bit for bit),
    then phase 11 (a)'s run of 2 windows and the tail, which rank 0 holds to the same run
    on its card alone (the check's tolerances are read at that length, module docstring
    phase 11); with ``save_to`` (``--mesh-cards``) only that last run at BIG_N, whose
    output rank 0 saves there (`_save_outputs`). With several (``--cards-per-process``):
    each grid as `_cards_cell` and one trade (`_cards_trade`), then that last run, saved
    by rank 0 where ``save_to`` is given."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from kwave_tpu_torch.parallel import make_mesh
    from kwave_tpu_torch.parallel.distributed import initialize

    initialize(f"localhost:{port}", world, rank, "cuda", cards=per)
    try:
        mesh = make_mesh(world * per)
        _require(mesh.graph_devices == tuple(torch.device("cuda", rank * per + k)
                                             for k in range(per)),
                 f"{mesh}: graphs on {mesh.graph_devices}")
        if per > 1:
            _, smi = device_phase()
            launches = 0
            for n in CARDS_GRIDS:
                res = _cards_cell(n, mesh, smi)
                launches += res["counts"][True]["w40_overlap"]
                del res
                torch.cuda.empty_cache()
                ms, cross = _cards_trade(mesh, n)
                print(f"[cards x {per}] {n}^3: one z-for-y trade over the {mesh.size} "
                      f"shards {ms:.4f} ms (replayed; rank {rank}), {cross / 1e6:.1f} MB "
                      f"across cards, {cross / ms / 1e6:.1f} GB/s", flush=True)
                torch.cuda.empty_cache()
            print(f"[cards x {per}] rank {rank}: K1a (w40_overlap) launches in the graph "
                  f"runs {launches}", flush=True)
            _require(launches > 0, f"rank {rank}: no K1a launch")
        if save_to is not None or per > 1:
            data = _input(MESH_WINDOWS * O_SIZE + MESH_TAIL, BIG_N)
            out, _, _, _ = _run(MESH_FLAGS, MESH_WINDOWS, MESH_TAIL, data=data, mesh=mesh,
                                compact_operators=True)
            if rank == 0 and save_to is not None:
                _save_outputs(out, save_to)
            mesh.comm.barrier()
            return 0
        steps = GRAPH_WINDOWS * O_SIZE + GRAPH_TAIL
        for n in CARDS_GRIDS:
            data = _input(steps, n)
            res = _turns(data, mesh)  # its first run warms up
            outs, counts, warm, sim = (res[k] for k in ("outs", "counts", "warm", "sim"))
            if rank == 0:
                differ = _same_bits(outs[False], outs[True])
                _require(not differ, f"{n}^3 on {world} cards: graphs differ from eager "
                         f"in {differ}")
                print(f"[cards] {n}^3, {N_SENSORS} sensors, {steps} steps, "
                      f"{' '.join(MESH_FLAGS)}: {world} processes over NCCL, one card "
                      f"each: graphs == eager bit for bit, launches equal (rank 0: "
                      f"{ {k: v for k, v in counts[True].items() if v} }); windows "
                      f"{res['acts']}; "
                      f"warm ms/step eager {warm[False]}, graph {warm[True]}; simulation "
                      f"phase ms/step eager {sim[False]}, graph {sim[True]}", flush=True)
            del outs, res
            two = dataclasses.replace(data, grid=dataclasses.replace(
                data.grid, nt=MESH_WINDOWS * O_SIZE + MESH_TAIL))
            out, secs, _, _ = _run(MESH_FLAGS, MESH_WINDOWS, MESH_TAIL, data=two, mesh=mesh,
                                   compact_operators=True)
            if rank == 0:
                ms = float(out.attrs["simulation_phase_execution_time"]) / two.grid.nt * 1e3
                _run(MESH_FLAGS, 0, 3, compact_operators=True, data=dataclasses.replace(
                    data, grid=dataclasses.replace(data.grid, nt=3)))
                one, one_secs, _, _ = _run(MESH_FLAGS, MESH_WINDOWS, MESH_TAIL, data=two,
                                           compact_operators=True)
                ms_one = float(one.attrs["simulation_phase_execution_time"]) / two.grid.nt \
                    * 1e3
                print(f"[cards] {n}^3, {two.grid.nt} steps: {world} processes "
                      f"{ms:.3f} ms/step in the simulation phase "
                      f"({secs / two.grid.nt * 1e3:.3f} end to end); card 0 alone "
                      f"{ms_one:.3f} ({one_secs / two.grid.nt * 1e3:.3f})", flush=True)
                errs = _hold_mesh_run(one, out, f"{world} processes at {n}^3")
                print(f"[cards] {n}^3: the {world} processes against card 0 alone, of the "
                      f"peak: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()),
                      flush=True)
                del one
            mesh.comm.barrier()
            del data, out
            torch.cuda.empty_cache()
    finally:
        import gc

        gc.collect()  # the graphs that hold NCCL's trades go before its communicator
        torch.cuda.synchronize()
        dist.destroy_process_group()
    return 0


CARDS_SECONDS = 1500  # --mesh-processes: the ranks' time, all grids


def _spawn_ranks(world: int, *extra: str) -> list[int]:
    """``world`` processes of this script as the ranks of one NCCL group (``--mesh-rank
    R``, one card each unless ``extra`` holds ``--cards-per-process``): every rank's
    output is printed, and any rank's failure ends the other ranks at once (they would
    wait in a collective for NCCL's timeout). Returns their exit codes."""
    import tempfile

    port = _free_port()
    logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
                               str(r), "--mesh-processes", str(world), "--port", str(port),
                               *extra],
                              stdout=logs[r], stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + CARDS_SECONDS
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline \
                and not any(p.returncode for p in procs):
            time.sleep(1.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (log, p) in enumerate(zip(logs, procs)):
        log.seek(0)
        print(f"--- rank {r} (exit {p.returncode}) ---", flush=True)
        print("\n".join(line for line in log.read().splitlines() if "progress" not in line),
              flush=True)
    return [p.returncode for p in procs]


def cards_phase(world: int, per: int = 1) -> int:
    """``--mesh-processes N [--cards-per-process C]``: phase 11 (a) as N processes over
    NCCL, C cards each (the kernels built once first; `_spawn_ranks`). With C > 1 each
    rank reads every grid as `_cards_cell` and one trade, and saves the 37-step run at
    BIG_N; then N·C processes of one card save the same run (``--save-outputs``), and
    this process holds both, bit for bit, to the in-process mesh over the N·C cards
    (``--devices N·C``) and to N·C shards of cuda:0."""
    import tempfile

    import torch

    from kwave_tpu_torch import cli, params

    name, smi = device_phase()
    need, have = world * per, torch.cuda.device_count()
    _require(have >= need, f"--mesh-processes {world} x {per} cards needs {need} cards; "
             f"{have} present")
    build_phase()
    if per == 1:
        codes = _spawn_ranks(world)
        _require(all(rc == 0 for rc in codes), f"ranks exited {codes}")
    else:
        tmp = Path(tempfile.mkdtemp())
        saved = {f"{world} processes x {per} cards": tmp / "cards.npz",
                 f"{need} processes": tmp / "ranks.npz"}
        for (what, path), ranks, extra in zip(saved.items(), (world, need),
                                              (("--cards-per-process", str(per)), ())):
            codes = _spawn_ranks(ranks, *extra, "--save-outputs", str(path))
            _require(all(rc == 0 for rc in codes), f"{what}: ranks exited {codes}")
        parser = params.build_parser()
        cards = cli.mesh_from_args(parser, parser.parse_args(
            ["-i", "-", "-o", "-", "--devices", str(need)]), torch.device("cuda"))
        data = _input(MESH_WINDOWS * O_SIZE + MESH_TAIL, BIG_N)
        compact = dict(compact_operators=True)
        out, _, steps, _ = _run(MESH_FLAGS, MESH_WINDOWS, MESH_TAIL, data=data, mesh=cards,
                                **compact)
        shards, _, _, _ = _run(MESH_FLAGS, MESH_WINDOWS, MESH_TAIL, data=data,
                               mesh=_mesh(need), **compact)
        differ = {what: _differ_from_saved(out, path) for what, path in saved.items()}
        differ[f"{need} shards of cuda:0"] = _same_bits(out, shards)
        print(f"[cards x {per}] {BIG_N}^3, {steps} steps: --devices {need} in one process "
              f"against " + "; ".join(f"{k}: differ in {v}" for k, v in differ.items()),
              flush=True)
        _require(not any(differ.values()), f"{world} x {per} cards: {differ}")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


PROBE_N = 128  # the probe's grid, n^3 over the cards
PROBE_STEPS = 5


def cards_probe(n_cards: int) -> dict:
    """One CUDA graph across ``n_cards`` cards, captured from this one thread without
    the package's `graphs.Graphs`: a state-carrying program on an in-process mesh of one
    shard a card (the pencil FFT's rfft2, all-to-all by peer copies, fft over z, a
    spectral multiply, the inverse, and a signal read at a time index that lies on each
    card), captured on a side stream of card 0 that the other cards' side streams join
    by events, their allocations in a `torch.cuda.MemPool` a card. Replayed
    PROBE_STEPS times from the state of an eager run, it must give that run's bits, and
    tensors made eagerly on every card after the capture must keep their values through
    the replays (no eager allocation lands in the graph's memory). Returns the peer
    access, the bits, the clobber check and eager / replayed ms per step."""
    import contextlib

    import torch

    from kwave_tpu_torch.parallel import make_mesh
    from kwave_tpu_torch.parallel.fft import dist_irfftn, dist_rfftn, spectral_sharding
    from kwave_tpu_torch.parallel.mesh import field_sharding, replicated
    from kwave_tpu_torch.parallel.sharded import Sharded

    devs = [torch.device("cuda", k) for k in range(n_cards)]
    peer = {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
            for i in range(n_cards) for j in range(n_cards) if i != j}
    mesh = make_mesh(n_cards)
    n = PROBE_N
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((n, n, n)).astype(np.float32)
    kern = np.exp(-rng.random((n, n, n // 2 + 1))).astype(np.complex64)
    signal = replicated(mesh, rng.standard_normal(PROBE_STEPS).astype(np.float32))
    k_sh = spectral_sharding(mesh, kern)

    def step(x, t):
        y = dist_irfftn(dist_rfftn(x, mesh) * k_sh, n, mesh)
        at = signal.index_select(0, torch.clamp(t, max=PROBE_STEPS - 1).reshape(1))
        return y * 0.5 + x * at

    def sync():
        for d in devs:
            torch.cuda.synchronize(d)

    def eager_run():
        x = field_sharding(mesh, x0)
        for t in range(PROBE_STEPS):
            x = step(x, Sharded([torch.tensor(t, device=d) for d in devs]))
        return [s.cpu() for s in x.shards]

    want = eager_run()  # also the warm-up: cuFFT plans, peer access
    sync()
    t0 = time.perf_counter()
    eager_run()
    sync()
    eager_ms = (time.perf_counter() - t0) / PROBE_STEPS * 1e3

    static = field_sharding(mesh, x0)
    t_dev = [torch.zeros((), dtype=torch.int64, device=d) for d in devs]
    graph = torch.cuda.CUDAGraph()
    pools = []
    for d in devs[1:]:
        with torch.cuda.device(d):  # a MemPool belongs to the card current when it is made
            pools.append(torch.cuda.MemPool())
    streams = [torch.cuda.Stream(d) for d in devs]
    for s, d in zip(streams, devs):
        s.wait_stream(torch.cuda.current_stream(d))
    t_cap = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for s in reversed(streams):  # card 0's last: the capture's device is current
            stack.enter_context(torch.cuda.stream(s))
        for pool, d in zip(pools, devs[1:]):
            stack.enter_context(torch.cuda.use_mem_pool(pool, d))
        graph.capture_begin(pool=torch.cuda.graph_pool_handle())
        try:
            for s in streams[1:]:
                s.wait_stream(streams[0])  # joins the capture
            new = step(static, Sharded(t_dev))
            for a, b in zip(static.shards, new.shards):
                a.copy_(b)
            for s in streams[1:]:
                streams[0].wait_stream(s)  # joins back before the capture ends
        finally:
            graph.capture_end()
    capture_s = time.perf_counter() - t_cap
    for s, d in zip(streams, devs):
        torch.cuda.current_stream(d).wait_stream(s)
    witness = [torch.full((1 << 20,), float(k + 1), device=d) for k, d in enumerate(devs)]

    def replay(t):
        for tk in t_dev:
            tk.fill_(t)
        main = torch.cuda.current_stream(devs[0])
        for d in devs[1:]:
            main.wait_stream(torch.cuda.current_stream(d))
        graph.replay()
        for d in devs[1:]:
            torch.cuda.current_stream(d).wait_stream(main)

    for a, x in zip(static.shards, field_sharding(mesh, x0).shards):
        a.copy_(x)
    for t in range(PROBE_STEPS):
        replay(t)
    got = [s.cpu() for s in static.shards]
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, want))
    kept = all(bool((w == k + 1).all()) for k, w in enumerate(witness))
    sync()
    t0 = time.perf_counter()
    for t in range(PROBE_STEPS):
        replay(t)
    sync()
    replay_ms = (time.perf_counter() - t0) / PROBE_STEPS * 1e3
    out = {"cards": n_cards, "peer_access": all(peer.values()), "bits_equal": same,
           "eager_tensors_kept": kept, "capture_s": capture_s, "eager_ms_per_step": eager_ms,
           "replayed_ms_per_step": replay_ms}
    print(f"[cards probe] {n_cards} cards, {n}^3, {PROBE_STEPS} steps: {json.dumps(out)}",
          flush=True)
    del graph, pools
    _require(same and kept, f"the graph across {n_cards} cards: {out}")
    return out


def _cards_cell(grid: int, mesh, smi: str) -> dict:
    """One grid of ``--mesh-cards`` (and of ``--cards-per-process``, on each rank): phase
    11 (a)'s input at grid^3, GRAPH_WINDOWS
    windows and a tail, eager and with graphs in turns on ``mesh`` (`_turns`): bit for
    bit, launches equal; prints warm and simulation-phase ms/step, device ms/step of a
    replayed window (CUDA events on card 0, where the graph over the cards ends), the
    idle share each way against it, capture + instantiate per key and the peak memory a
    card of this process. Returns the turns' results."""
    res = _turns(_input(GRAPH_WINDOWS * O_SIZE + GRAPH_TAIL, grid), mesh)
    differ = _same_bits(res["outs"][False], res["outs"][True])
    _require(not differ, f"{grid}^3 on {mesh}: graphs differ from eager in {differ}")
    graphs = res["window"].graphs
    device, _ = _replay_ms(graphs, profile=False)
    idle = {g: 1 - device / float(np.mean(res["warm"][g])) for g in (False, True)}
    capture = sorted(graphs.capture_seconds.values())
    peak = {g: [round(x, 3) for x in res["peak"][g]] for g in (False, True)}
    print(f"[cards graph] {grid}^3, {N_SENSORS} sensors, {GRAPH_WINDOWS * O_SIZE + GRAPH_TAIL} "
          f"steps, {' '.join(MESH_FLAGS)}, {mesh}: graphs == eager bit for bit, launches "
          f"equal ({ {k: v for k, v in res['counts'][True].items() if v} }); windows "
          f"{res['acts']}; warm ms/step eager {res['warm'][False]}, graph "
          f"{res['warm'][True]}; simulation phase ms/step eager {res['sim'].get(False)}, "
          f"graph {res['sim'].get(True)} (the writer's alone); device ms/step of a replayed "
          f"window (events) {device:.4f}; "
          f"idle eager {idle[False]:.1%}, graph {idle[True]:.1%}; capture + instantiate "
          f"per key {capture} s; peak GiB allocated a card eager {peak[False]}, graph "
          f"{peak[True]}; card {smi}", flush=True)
    return res


def _cards_trade(mesh, n: int, reps: int = 10) -> tuple[float, float]:
    """One z-for-y trade of an n^3 spectrum over the mesh's cards (this process's, and
    the other ranks' over NCCL): (device ms, from a graph of a round trip, z for y and
    back, captured with `graphs.Graphs` and replayed ``reps`` times between CUDA events
    on this process's first card, where the graph ends; the bytes that cross between the
    shards in one trade)."""
    import torch

    from kwave_tpu_torch.graphs import Graphs
    from kwave_tpu_torch.parallel import Sharded, field_sharding
    from kwave_tpu_torch.parallel import fft as dfft

    xk = torch.fft.rfft(torch.randn(n, n, n, device=mesh.devices[0]), dim=2)
    parts = field_sharding(mesh, xk).shards

    def round_trip(static, t):
        return dfft.y_to_z(dfft.z_to_y(Sharded(static), mesh), mesh).shards, None

    round_trip(parts, None)  # eager first: peer access, the allocator's blocks
    graphs = Graphs(mesh.devices)
    graphs.capture("trade", parts, round_trip)
    graphs.replay("trade", parts, 0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(mesh.devices[0]):
        start.record()
        for _ in range(reps):
            graphs.replay("trade", graphs.static, 0)
        end.record()
        torch.cuda.synchronize()
    s = mesh.size
    return start.elapsed_time(end) / (2 * reps), xk.numel() * xk.element_size() * (s - 1) / s


def mesh_cards_phase(n: int) -> int:
    """``--mesh-cards N``: the in-process mesh over N cards (``--devices N``, one shard a
    card, `InProcess` peer copies), its windows and lead-in one CUDA graph across the
    cards. The probe (`cards_probe`); each of CARDS_GRIDS as `_cards_cell`; phase 11
    (a)'s 37 steps at BIG_N held to card 0 alone (`_hold_mesh_run`) and bit for bit to
    N shards of cuda:0 and to the ``--mesh-processes N`` run of the same input (N
    processes over NCCL, `_spawn_ranks`); p_final over the 213 steps of the turns'
    graph run against card 0 alone and N shards of cuda:0 (a reading, no bound). Prints
    the window kernel's launches in the graph runs (``launches_cards_graph_path``) and
    the contract's last line with ``count`` N."""
    import dataclasses
    import tempfile

    import torch

    from kwave_tpu_torch import cli, params
    from kwave_tpu_torch.ops import encode_window as ew

    name, smi = device_phase()
    have = torch.cuda.device_count()
    _require(have >= n, f"--mesh-cards {n} needs {n} cards; {have} present")
    build_phase()
    cards_probe(n)
    parser = params.build_parser()
    mesh = cli.mesh_from_args(parser, parser.parse_args(
        ["-i", "-", "-o", "-", "--devices", str(n)]), torch.device("cuda"))
    _require(mesh.graph_devices == tuple(torch.device("cuda", k) for k in range(n)),
             f"--devices {n}: {mesh} is graphed on {mesh.graph_devices}")
    launches = {k: 0 for k in ew.LAUNCHES}
    long_run = None
    for grid in CARDS_GRIDS:
        res = _cards_cell(grid, mesh, smi)
        for k in launches:
            launches[k] += res["counts"][True][k]
        if grid == BIG_N:
            long_run = res["outs"][True]
        del res
        torch.cuda.empty_cache()
        ms, cross = _cards_trade(mesh, grid)
        print(f"[cards graph] {grid}^3: one z-for-y trade over the {n} cards {ms:.4f} ms "
              f"(replayed), {cross / 1e6:.1f} MB across cards, {cross / ms / 1e6:.1f} GB/s",
              flush=True)
        torch.cuda.empty_cache()

    def cut(data, nt):
        return dataclasses.replace(data, grid=dataclasses.replace(data.grid, nt=nt))

    long_data = _input(GRAPH_WINDOWS * O_SIZE + GRAPH_TAIL, BIG_N)
    data = cut(long_data, MESH_WINDOWS * O_SIZE + MESH_TAIL)
    compact = dict(compact_operators=True)
    _run(MESH_FLAGS, 0, 3, data=cut(data, 3), **compact)
    one, one_secs, steps, _ = _run(MESH_FLAGS, MESH_WINDOWS, MESH_TAIL, data=data, **compact)
    out, secs, _, _ = _run(MESH_FLAGS, MESH_WINDOWS, MESH_TAIL, data=data, mesh=mesh,
                           **compact)
    errs = _hold_mesh_run(one, out, f"{n} cards in one process at {BIG_N}^3")
    shards, _, _, _ = _run(MESH_FLAGS, MESH_WINDOWS, MESH_TAIL, data=data, mesh=_mesh(n),
                           **compact)
    differ_shards = _same_bits(shards, out)
    del shards
    saved = Path(tempfile.mkdtemp()) / "ranks.npz"
    codes = _spawn_ranks(n, "--save-outputs", str(saved))
    _require(all(rc == 0 for rc in codes), f"the {n} ranks exited {codes}")
    differ_ranks = _differ_from_saved(out, saved)
    print(f"[cards graph] {BIG_N}^3, {steps} steps: {n} cards in one process "
          f"{secs / steps * 1e3:.3f} ms/step end to end, card 0 alone "
          f"{one_secs / steps * 1e3:.3f}; against card 0 alone, of the peak: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; against {n} shards of cuda:0 differ in {differ_shards}; against {n} "
          f"processes over NCCL differ in {differ_ranks}", flush=True)
    _require(not differ_shards and not differ_ranks,
             f"{n} cards in one process differ from {n} shards of cuda:0 in "
             f"{differ_shards}, from {n} processes in {differ_ranks}")
    long_one, _, _, _ = _run(MESH_FLAGS, GRAPH_WINDOWS, GRAPH_TAIL, data=long_data,
                             **compact)
    long_shards, _, _, _ = _run(MESH_FLAGS, GRAPH_WINDOWS, GRAPH_TAIL, data=long_data,
                                mesh=_mesh(n), **compact)
    a = np.asarray(long_one["p_final"].data, np.float64)
    b = np.asarray(long_run["p_final"].data, np.float64)
    print(f"[cards graph] {BIG_N}^3, {long_data.grid.nt} steps: p_final of {n} cards in "
          f"one process (graphs) against card 0 alone {np.abs(b - a).max() / np.abs(a).max():.3e}"
          f" of its peak (FINAL_ATOL {FINAL_ATOL:g} holds at {steps} steps; not checked "
          f"here); against {n} shards of cuda:0 differ in "
          f"{_same_bits(long_shards, long_run)}", flush=True)
    rows = [dict(name=key, route="cuda", source="kwave_tpu_torch/csrc/encode_window.cu",
                 replaces=VARIANTS[key][2], launches_cards_graph_path=launches[key])
            for key in VARIANTS]
    _require(launches["w40_overlap"] > 0, f"--mesh-cards: launches {launches}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": n}}), flush=True)
    return 0


FILE_FLAGS = ["--p_raw", "--p_c", "--40-bit_complex"]
FILE_WINDOWS = (8, 64)  # phase 14: the CLI on files, phase 4's run and one 8 x as long
FILE_TAIL = 5
FILE_LEG_WINDOWS = 5  # the two-leg file run: a checkpoint after 5 of the 8 windows
FILE_LEVEL = 4  # the -c run's deflate level
FILE_SECONDS = 600  # the subprocess run's time limit


class _CodecClock:
    """Seconds spent inside the HDF5 codec's writes (``Dataset.__setitem__``,
    ``Group.create_dataset``) and ``File.close`` while it is installed; a call inside
    another (create_dataset's data) counts once."""

    def __init__(self):
        from kwave_tpu_torch.io import h5file

        self.seconds = {"writes": 0.0, "close": 0.0}
        self._depth = 0
        self._saved = [(cls, name, getattr(cls, name), kind) for cls, name, kind in (
            (h5file.Dataset, "__setitem__", "writes"),
            (h5file.Group, "create_dataset", "writes"),
            (h5file.File, "close", "close"))]

    def _timed(self, fn, kind):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            self._depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self._depth -= 1
                if not self._depth:
                    self.seconds[kind] += time.perf_counter() - t0
        return call

    def __enter__(self):
        for cls, name, fn, kind in self._saved:
            setattr(cls, name, self._timed(fn, kind))
        return self

    def __exit__(self, *exc):
        for cls, name, fn, _ in self._saved:
            setattr(cls, name, fn)


def _same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).view(np.uint8), np.ascontiguousarray(b).view(np.uint8))


def _file_datasets(path) -> dict:
    """Every dataset of an output file read back through the port's codec, with its
    chunks and compression, and the file's simulation-phase seconds."""
    from kwave_tpu_torch.io import h5file

    with h5file.File(path, "r") as f:
        sim = float(f.attrs["simulation_phase_execution_time"])
        return {name: (f[name][...], f[name].chunks, f[name].compression,
                       f[name].compression_opts) for name in f.keys()}, sim


def _hold_file_to_memory(path, mem, what: str) -> float:
    """The output file at ``path`` holds ``mem``'s (an in-memory run of the same input)
    datasets bit for bit; returns the file's simulation-phase seconds."""
    got, sim = _file_datasets(path)
    _require(set(got) == set(mem.items), f"{what}: datasets {sorted(got)} != "
             f"{sorted(mem.items)}")
    differ = [k for k, (a, *_) in got.items() if not _same_bytes(a, mem[k].data)]
    _require(not differ, f"{what}: {differ} differ from the in-memory run's bits")
    return sim


def file_phase(smi, device: str = "cuda") -> dict:
    """Phase 14: the CLI on files. Phase 4's input written by the port's
    `write_input_file`, run by `cli.main` (-i in.h5 -o out.h5) at 8 and at 64 windows and
    a 5-step tail, once more at 8 as a ``python -m kwave_tpu_torch.cli`` process, in two
    legs through ``--checkpoint_file``, with ``-c 4``, and in the other three variants at
    3 windows; every output read back through the codec and held bit for bit to the
    in-memory run of the same input (values alone for ``-c``). Returns the window
    kernels' launches on the file path."""
    import os
    import tempfile

    from kwave_tpu_torch import cli
    from kwave_tpu_torch.io.input_file import read_input_file, write_input_file
    from kwave_tpu_torch.ops import encode_window as ew

    period = ["--period", str(O_SIZE)]
    launches = dict.fromkeys(ew.LAUNCHES, 0)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="file_phase_") as tmp:
        def cli_run(inp, out, flags, windows, variant="w40_overlap", tail=FILE_TAIL):
            """cli.main on files; its window kernel launched once a window-encode call."""
            before = dict(ew.LAUNCHES)
            _sync()
            t0 = time.perf_counter()
            with _CodecClock() as clock:
                _require(cli.main(["-i", inp, "-o", out, *period, *flags]) == 0,
                         f"cli.main {flags} returned non-zero")
            _sync()
            secs = time.perf_counter() - t0
            delta = {k: ew.LAUNCHES[k] - before[k] for k in ew.LAUNCHES}
            calls = windows + (1 if tail else 0)
            want = {k: (calls if k == variant else 0) for k in ew.LAUNCHES}
            _require(delta == want, f"{flags}: launches {delta}, expected {want}")
            for k, n in delta.items():
                launches[k] += n
            return secs, clock.seconds

        for windows in FILE_WINDOWS:
            steps = windows * O_SIZE + FILE_TAIL
            inp, out = os.path.join(tmp, f"in_{windows}.h5"), os.path.join(tmp, f"out_{windows}.h5")
            t0 = time.perf_counter()
            write_input_file(inp, _input(steps))
            in_write = time.perf_counter() - t0
            data = read_input_file(inp)
            mem, mem_secs, _, _ = _run(FILE_FLAGS, windows, FILE_TAIL, data=data, device=device)
            secs, codec = cli_run(inp, out, FILE_FLAGS, windows)
            sim = _hold_file_to_memory(out, mem, f"{windows}-window file run")
            _check_run(mem, FILE_FLAGS, steps)
            size = os.path.getsize(out)
            codec_s = codec["writes"] + codec["close"]
            print(f"[14 files] {windows} windows + {FILE_TAIL} ({steps} steps), "
                  f"{' '.join(FILE_FLAGS)}: file == in-memory run bit for bit (p, p_c); "
                  f"simulation phase {sim / steps * 1e3:.4f} ms/step on files, "
                  f"{float(mem.attrs['simulation_phase_execution_time']) / steps * 1e3:.4f} "
                  f"in memory; cli.main {secs:.3f} s ({mem_secs:.3f} s in memory through "
                  f"run_simulation); codec writes {codec['writes']:.4f} s, close "
                  f"{codec['close']:.4f} s; output {size} bytes, "
                  f"{size / codec_s / 1e6:.1f} MB/s over the codec's time; input "
                  f"{os.path.getsize(inp)} bytes written in {in_write:.3f} s; w40_overlap "
                  f"launched {steps // O_SIZE + 1}x; {smi}", flush=True)
            if windows != FILE_WINDOWS[0]:
                continue
            # the same run as a process of its own
            env = dict(os.environ, KWAVE_TPU_TORCH_DEVICE=device)
            sub = os.path.join(tmp, "out_subprocess.h5")
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "kwave_tpu_torch.cli", "-i", inp,
                                   "-o", sub, *period, *FILE_FLAGS], cwd=ROOT, env=env,
                                  capture_output=True, text=True, timeout=FILE_SECONDS)
            _require(proc.returncode == 0, f"python -m kwave_tpu_torch.cli failed: "
                     f"{proc.stderr[-2000:]}")
            sub_secs = time.perf_counter() - t0
            _hold_file_to_memory(sub, mem, "python -m kwave_tpu_torch.cli")
            # two legs through a checkpoint file
            legs = os.path.join(tmp, "out_legs.h5")
            ckpt = ["--checkpoint_file", os.path.join(tmp, "ckpt.h5"),
                    "--checkpoint_timesteps", str(FILE_LEG_WINDOWS * O_SIZE)]
            leg_secs = [cli_run(inp, legs, FILE_FLAGS + ckpt, FILE_LEG_WINDOWS, tail=0)[0],
                        cli_run(inp, legs, FILE_FLAGS + ckpt, windows - FILE_LEG_WINDOWS)[0]]
            _hold_file_to_memory(legs, mem, "the two-leg file run")
            # deflated at -c 4: the same values, the dataset's filter as asked
            gz = os.path.join(tmp, "out_gzip.h5")
            gz_secs, gz_codec = cli_run(inp, gz, FILE_FLAGS + ["-c", str(FILE_LEVEL)],
                                        windows)
            deflated, _ = _file_datasets(gz)
            _require(all(deflated[k][2:] == ("gzip", FILE_LEVEL) for k in ("p", "p_c")),
                     f"-c {FILE_LEVEL}: {[(k, v[1:]) for k, v in deflated.items()]}")
            _require(all(_same_bytes(deflated[k][0], mem[k].data) for k in ("p", "p_c")),
                     f"-c {FILE_LEVEL}: values differ from the in-memory run")
            print(f"[14 files] python -m kwave_tpu_torch.cli {sub_secs:.2f} s (a process "
                  f"of its own: start, read, run, write) == in-memory run bit for bit; two "
                  f"legs ({FILE_LEG_WINDOWS} windows, then {windows - FILE_LEG_WINDOWS} and "
                  f"the tail) {leg_secs[0]:.3f} + {leg_secs[1]:.3f} s == one run bit for "
                  f"bit; -c {FILE_LEVEL} {gz_secs:.3f} s, codec writes "
                  f"{gz_codec['writes']:.4f} s, close {gz_codec['close']:.4f} s, "
                  f"{os.path.getsize(gz)} bytes, values equal; {smi}", flush=True)
        # the main path's other three variants through files
        steps = 3 * O_SIZE + FILE_TAIL
        inp = os.path.join(tmp, "in_variants.h5")
        write_input_file(inp, _input(steps))
        data = read_input_file(inp)
        for flags, variant in ((["--p_raw", "--p_c", "--no_overlap"], "wfloat_no_overlap"),
                               (["--p_raw", "--p_c", "--40-bit_complex", "--no_overlap"],
                                "w40_no_overlap"),
                               (["--p_raw", "--p_c"], "wfloat_overlap")):
            out = os.path.join(tmp, f"out_{variant}.h5")
            mem = _run(flags, 3, FILE_TAIL, data=data, device=device)[0]
            cli_run(inp, out, flags, 3, variant)
            _hold_file_to_memory(out, mem, f"{' '.join(flags)} file run")
        print(f"[14 files] the other three variants (3 windows + {FILE_TAIL}) on files == "
              f"in memory bit for bit; window kernels launched on the file path: "
              f"{launches}", flush=True)
    return launches


def readings_phase(readings: int, tree: Path, windows: int = 8) -> int:
    """``--main-path-readings``: phase 4's first run (128^3, 16384 sensors, 8 windows and a
    5-step tail, 40-bit overlap; or ``windows`` windows) ``readings`` times in this
    process, after the build and the same warm-up, with the package of ``tree``. One
    reading a run does not resolve 5 % on a loop the host bounds; two trees are compared
    by such processes in turns."""
    _, smi = device_phase()
    build_phase()
    flags, tail = ["--p_raw", "--p_c", "--40-bit_complex"], 5
    _run(flags, 1, 3)  # warm-up, as phase 4's
    sim, end = [], []
    for _ in range(readings):
        out, secs, steps, _ = _run(flags, windows, tail)
        sim.append(float(out.attrs["simulation_phase_execution_time"]) / steps * 1e3)
        end.append(secs / steps * 1e3)
    print(json.dumps({"main_path_readings": {
        "tree": str(tree), "flags": flags, "steps": windows * O_SIZE + tail, "card": smi,
        "sim_ms_per_step": sim, "end_to_end_ms_per_step": end,
        "median_sim_ms_per_step": float(np.median(sim))}}), flush=True)
    return 0


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description="The port's check on one NVIDIA H100.")
    parser.add_argument("--main-path-readings", type=int, default=0, metavar="N",
                        help="instead of the phases: N readings of phase 4's first run")
    parser.add_argument("--main-path-windows", type=int, default=8, metavar="W",
                        help="with --main-path-readings: the run's windows (8: phase 4's)")
    parser.add_argument("--package-from", type=Path, default=ROOT, metavar="DIR",
                        help="with --main-path-readings: the checkout whose "
                             "kwave_tpu_torch is read (another commit, for a comparison)")
    parser.add_argument("--mesh-processes", type=int, default=0, metavar="N",
                        help="instead of the phases: phase 11 (a) as N processes over "
                             "NCCL, one card each (needs N cards)")
    parser.add_argument("--cards-per-process", type=int, default=1, metavar="C",
                        help="with --mesh-processes N: each process drives C cards (needs "
                             "N x C cards), held to N x C processes, --devices N x C and "
                             "N x C shards of cuda:0")
    parser.add_argument("--mesh-cards", type=int, default=0, metavar="N",
                        help="instead of the phases: the in-process mesh over N cards "
                             "(--devices N), eager and as one CUDA graph across them "
                             "(needs N cards)")
    parser.add_argument("--mesh-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--save-outputs", type=Path, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    tree = args.package_from.resolve()
    if not (tree / "kwave_tpu_torch").is_dir():
        print(f"chip_smoke.py: kwave_tpu_torch/ is not in {tree}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; needs an NVIDIA card",
              file=sys.stderr)
        return 2
    # full fp32 for every plain version: a TF32 matmul would be ~1e-3 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if args.main_path_readings:
        return readings_phase(args.main_path_readings, tree, args.main_path_windows)
    if args.mesh_rank is not None:
        return _rank_phase(args.mesh_rank, args.mesh_processes, args.port, args.save_outputs,
                           args.cards_per_process)
    if args.mesh_processes:
        return cards_phase(args.mesh_processes, args.cards_per_process)
    if args.mesh_cards:
        return mesh_cards_phase(args.mesh_cards)

    name, smi = device_phase()
    print(f"[1 device] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}, float32_matmul_precision="
          f"{torch.get_float32_matmul_precision()}", flush=True)
    t_run = time.perf_counter()

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[time] phase {phase} in {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    timed("2 (build)", build_phase)
    kernels = timed(3, kernel_phase)
    launches, float_run = timed(4, main_path_phase)
    codec = timed(5, codec_kernel_phase)
    codec_launches = timed(6, codec_round_trip_phase, *float_run)
    series, series_launches = timed(7, series_phase)
    fused, fused_launches = timed(8, fused_phase)
    legs_launches = timed(9, legs_phase, smi)
    _require(legs_launches["w40_overlap"] > 0, "phase 9 launched no window kernel")
    acceptance_launches = timed(10, acceptance_phase, smi)
    mesh_launches = timed(11, mesh_phase, smi)
    graph_launches, graph_k7 = timed(12, graph_phase, smi)
    mesh_graph_launches = timed(13, mesh_graph_phase, smi)
    file_launches = timed(14, file_phase, smi)
    print(f"[time] phases 2-14 in {time.perf_counter() - t_run:.1f} s", flush=True)

    rows = [dict(name=key, route="cuda", source="kwave_tpu_torch/csrc/encode_window.cu",
                 replaces=VARIANTS[key][2], launches=launches[key], **kernels[key])
            for key in VARIANTS]
    rows += [dict(name=key, route="cuda", source="kwave_tpu_torch/csrc/fastpath.cu",
                  replaces=replaces, launches=codec_launches[key], **codec[key])
             for key, (_, replaces) in CODEC_KERNELS.items()]
    rows += [dict(name=key, route="cuda", source="kwave_tpu_torch/csrc/encode_series.cu",
                  replaces=replaces, launches=series_launches[key], **series[key])
             for key, (_, _, replaces) in SERIES_KERNELS.items()]
    for r in rows:  # the window kernels' launches in phase 12's and 13's graph runs
        r["launches_graph_path"] = graph_launches.get(r["name"], 0)
        if r["name"] in file_launches:  # and on phase 14's file path
            r["launches_file_path"] = file_launches[r["name"]]
        if r["name"] in mesh_graph_launches:
            r["launches_mesh_graph_path"] = mesh_graph_launches[r["name"]]
    for key, row in fused.items():  # launches: the runs of the row's kernel (phase 8)
        kernel, n_ops = row.pop("kernel"), row.pop("n_ops")
        extra = {}
        if kernel in graph_k7:
            extra["launches_graph_path"] = graph_k7[kernel][f"zfuse_{n_ops}op"]
        rows.append(dict(name=key, route="cuda", source=K7_SOURCES[kernel],
                         replaces="kwave_tpu/ops/zfuse.py:113",
                         launches=fused_launches.get(kernel, {}).get(f"zfuse_{n_ops}op", 0),
                         **row, **extra))
    for r in rows:  # launches on phase 9's and phase 10's paths, beside the main path's
        if r["name"] in legs_launches:
            r["launches_legs_path"] = legs_launches[r["name"]]
        if r["name"] in acceptance_launches:
            r["launches_acceptance_path"] = acceptance_launches[r["name"]]
        if mesh_launches.get(r["name"]):
            r["launches_mesh_path"] = mesh_launches[r["name"]]
    _require(all(r["launches"] > 0 for r in rows),
             f"a kernel was never launched on its path: {rows}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
