"""CLI parameter surface: the kspaceFirstOrder flag set as argparse (port of
`kwave_tpu.params`; CommandLineParameters.cpp:253-299, flag docs main.cpp:196-307).

Same long-option names and semantics (`-s` is 1-based, `-c` is the output-file gzip level,
`--benchmark` truncates Nt). ``-g``/``-t`` are accepted for drop-in compatibility and
ignored: the device comes from ``KWAVE_TPU_TORCH_DEVICE``. The spectral-engine knobs of
`kwave_tpu.params` are accepted too: the FFT here is cuFFT in full fp32, so ``auto`` /
``highest`` and the mxfft switches change nothing, and ``--fft_precision high`` is
refused (`refused_fft_flags`). Flags whose feature is not ported yet are parsed and
refused by `unported_flags` with their ROADMAP item; none is silently ignored.
"""

from __future__ import annotations

import argparse
from typing import Optional

from kwave_tpu_torch.driver import RunConfig

STREAM_FLAGS = (
    "p_raw", "p_c", "p_rms", "p_max", "p_min", "p_max_all", "p_min_all", "p_final",
    "u_raw", "u_c", "u_non_staggered_raw", "u_non_staggered_c", "u_rms", "u_max",
    "u_min", "u_max_all", "u_min_all", "u_final",
)

# flag (argparse dest) -> the ROADMAP item that ports it
UNPORTED = {
    "devices": "queue 1 item 2 (parallel)",
    "distributed": "queue 1 item 2 (parallel)",
    "coordinator": "queue 1 item 2 (parallel)",
    "num_processes": "queue 1 item 2 (parallel)",
    "process_id": "queue 1 item 2 (parallel)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kspaceFirstOrder-Torch",
        description="Fluid k-space first-order simulator (PyTorch + CUDA) with "
        "on-the-fly compression",
    )
    p.add_argument("-i", "--input_file", required=True, help="HDF5 input file")
    p.add_argument("-o", "--output_file", required=True, help="HDF5 output file")
    p.add_argument("-r", "--progress_interval", type=int, default=5,
                   help="progress print interval in %%")
    p.add_argument("-t", "--threads", type=int, default=None, help="(compat; ignored)")
    p.add_argument("-g", "--gpu_id", type=int, default=None,
                   help="(compat; ignored: set KWAVE_TPU_TORCH_DEVICE)")
    p.add_argument("-c", "--compression_level", type=int, default=0,
                   help="output HDF5 gzip level 0-9")
    p.add_argument("-s", "--sampling_start", type=int, default=1,
                   help="first sampled timestep (1-based, as the reference)")
    p.add_argument("--benchmark", type=int, default=None, metavar="STEPS",
                   help="run only STEPS timesteps")
    p.add_argument("--verbose", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--version", action="store_true")
    p.add_argument("--copy_sensor_mask", action="store_true",
                   help="copy the sensor mask into the output file")

    p.add_argument("--checkpoint_file", default=None)
    p.add_argument("--checkpoint_interval", type=int, default=None, metavar="SECONDS")
    p.add_argument("--checkpoint_timesteps", type=int, default=None, metavar="STEPS")

    # not ported yet: refused with their ROADMAP item (see UNPORTED)
    p.add_argument("--devices", type=int, default=None, metavar="N")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    p.add_argument("--num_processes", type=int, default=None, metavar="N")
    p.add_argument("--process_id", type=int, default=None, metavar="R")

    # pressure streams
    p.add_argument("-p", "--p_raw", action="store_true")
    for f in STREAM_FLAGS[1:8]:
        p.add_argument(f"--{f}", action="store_true")
    # velocity streams
    p.add_argument("-u", "--u_raw", action="store_true")
    for f in STREAM_FLAGS[9:]:
        p.add_argument(f"--{f}", action="store_true")
    # intensity / Q term
    for f in ("I_avg", "I_avg_c", "Q_term", "Q_term_c"):
        p.add_argument(f"--{f}", action="store_true")
    p.add_argument("--post", action="store_true",
                   help="post-processing only on an existing output file")
    p.add_argument("--block_size", type=int, default=None,
                   help="I/O block size for post-processing")

    # compression configuration
    p.add_argument("--frequency", type=float, default=None,
                   help="source frequency [Hz]; period = 1/(dt*frequency)")
    p.add_argument("--period", type=float, default=None,
                   help="compression basis period in timesteps")
    p.add_argument("--mos", type=int, default=1, help="multiple of overlap size")
    p.add_argument("--harmonics", type=int, default=1)
    p.add_argument("--no_overlap", action="store_true",
                   help="no-overlap compression windows")
    p.add_argument("--40-bit_complex", dest="bit40", action="store_true",
                   help="store coefficients in the packed 40-bit format")

    # spectral-engine knobs of kwave_tpu.params (its matmul FFT); no-ops with cuFFT
    p.add_argument("--fft_precision", choices=["auto", "highest", "high"],
                   default="auto",
                   help="auto and highest: cuFFT in full fp32 (what this port always "
                        "runs); high (a reduced-precision matmul FFT) is refused")
    p.add_argument("--mxfft", dest="matmul_fft", action="store_const", const=True,
                   default=None, help="(compat; ignored: the FFT is cuFFT)")
    p.add_argument("--no-mxfft", dest="matmul_fft", action="store_const", const=False,
                   help="(compat; ignored: the FFT is cuFFT)")
    p.add_argument("--fft_direct_base", type=int, default=None,
                   help="(compat; ignored: the FFT is cuFFT)")
    return p


def unported_flags(args) -> list[str]:
    """The set flags whose feature this port does not run yet, each with its ROADMAP
    item."""
    return [f"--{k}: {item}" for k, item in UNPORTED.items()
            if getattr(args, k) not in (None, False)]


def refused_fft_flags(args) -> list[str]:
    """The spectral-engine settings this port refuses, each with the reason."""
    if args.fft_precision == "high":
        return ["--fft_precision high: the reduced-precision matmul FFT is under "
                "ROADMAP.md's \"Not ported, on purpose\"; cuFFT runs in full fp32 "
                "(auto / highest)"]
    return []


def args_to_run_config(args, dt: Optional[float] = None) -> RunConfig:
    """argparse Namespace -> driver RunConfig (the Parameters::init digest,
    Parameters.cpp:113-154,461-552)."""
    period = args.period
    if period is None and args.frequency is not None:
        if dt is None:
            raise ValueError("--frequency needs the input file's dt")
        period = 1.0 / (args.frequency * dt)  # Parameters.cpp:473-485
    return RunConfig(
        flags={k: getattr(args, k) for k in STREAM_FLAGS},
        i_avg=args.I_avg,
        i_avg_c=args.I_avg_c,
        q_term=args.Q_term,
        q_term_c=args.Q_term_c,
        mode40=args.bit40,
        no_overlap=args.no_overlap,
        period=period,
        mos=args.mos,
        harmonics=args.harmonics,
        sampling_start=max(args.sampling_start - 1, 0),  # 1-based CLI -> 0-based
        compression_level=args.compression_level,
        checkpoint_file=args.checkpoint_file,
        checkpoint_interval_steps=args.checkpoint_timesteps,
        checkpoint_interval_seconds=args.checkpoint_interval,
        block_size=args.block_size,
        progress_interval=args.progress_interval,
        benchmark_steps=args.benchmark,
    )
