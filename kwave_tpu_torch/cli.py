"""kspaceFirstOrder-Torch command-line entry (port of `kwave_tpu.cli`; main.cpp:840-937).

``python -m kwave_tpu_torch.cli -i input.h5 -o output.h5 --p_raw --p_c --40-bit_complex``

The device comes from ``KWAVE_TPU_TORCH_DEVICE`` (``cuda`` by default, ``cpu`` for the
tests); asking for CUDA where it is not available raises.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from kwave_tpu_torch.driver import _corners_to_indices, require_device, run_simulation
from kwave_tpu_torch.io.input_file import read_input_file
from kwave_tpu_torch.params import (
    args_to_run_config,
    build_parser,
    refused_fft_flags,
    unported_flags,
)
from kwave_tpu_torch.utils.observability import Logger

VERSION = "kspaceFirstOrder-Torch v0.1 (kwave_tpu_torch; port of kwave_tpu)"
DEVICE_ENV = "KWAVE_TPU_TORCH_DEVICE"


def device_from_env() -> torch.device:
    """The run's device from ``KWAVE_TPU_TORCH_DEVICE`` (default ``cuda``; set ``cpu``
    to run on the CPU)."""
    device = torch.device(os.environ.get(DEVICE_ENV, "cuda"))
    require_device(device)
    return device


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.version:
        print(VERSION)
        return 0
    refused = unported_flags(args)
    if refused:
        parser.error("not ported yet (see ROADMAP.md): " + "; ".join(refused))
    refused = refused_fft_flags(args)
    if refused:
        parser.error("; ".join(refused))
    Logger.level = args.verbose
    device = device_from_env()

    t0 = time.time()
    data = read_input_file(args.input_file)

    if args.post:
        # --post: post-processing only on an existing output file (main.cpp --post); the
        # c_* attributes are read from the datasets themselves
        from kwave_tpu_torch.postproc import post_process_output_file

        mask = data.sensor_mask_index
        if mask is None:
            mask = _corners_to_indices(data.sensor_mask_corners, data.grid)
        for from_coeffs, i_avg, q_term in ((False, args.I_avg, args.Q_term),
                                           (True, args.I_avg_c, args.Q_term_c)):
            if i_avg or q_term:
                post_process_output_file(
                    args.output_file, data.grid, mask, want_i_avg=i_avg,
                    want_q_term=q_term, from_coeffs=from_coeffs,
                    block_size=args.block_size, device=device,
                )
        print(f"[kwave_tpu_torch] post-processing done in {time.time() - t0:.2f}s")
        return 0

    if args.benchmark is not None:
        # --benchmark truncates Nt (Parameters.cpp:130-133)
        data.grid = dataclasses.replace(data.grid, nt=min(args.benchmark, data.grid.nt))
    run = args_to_run_config(args, dt=data.grid.dt)
    load_s = time.time() - t0
    run.data_load_seconds = load_s
    if not any(run.flags.values()) and not (
        args.I_avg or args.I_avg_c or args.Q_term or args.Q_term_c
    ):
        # a run with no outputs at all is useless: keep the reference's old p default,
        # but only when no output of any kind (intensity, Q term) was asked for
        run.flags["p_raw"] = True

    t1 = time.time()
    summary = run_simulation(
        data, run, args.output_file, device=device,
        resume_from=args.checkpoint_file
        if args.checkpoint_file and _checkpoint_exists(args.checkpoint_file) else None,
    )
    sim_s = time.time() - t1

    if args.copy_sensor_mask:
        # carry the mask into the output file (1-based on disk, as in the input format)
        import h5py

        from kwave_tpu_torch.io import names as dn
        from kwave_tpu_torch.io.hdf5 import tag_dataset

        with h5py.File(args.output_file, "r+") as f:
            if data.sensor_mask_index is not None:
                name, arr = dn.SENSOR_MASK_INDEX, data.sensor_mask_index[None, None, :]
            else:
                name, arr = dn.SENSOR_MASK_CORNERS, data.sensor_mask_corners[None, :, :]
            ds = f.create_dataset(name, data=arr.astype(np.uint64) + 1)
            tag_dataset(ds, data=dn.DATA_LONG)

    print(f"[kwave_tpu_torch] {device}: load {load_s:.2f}s  simulate+store {sim_s:.2f}s")
    for name, shape in summary.items():
        print(f"  {name}: {shape}")
    return 0


def _checkpoint_exists(path: str) -> bool:
    """A readable checkpoint file is at ``path`` (then the run continues from it)."""
    import h5py

    if not os.path.exists(path):
        return False
    try:
        with h5py.File(path, "r") as f:
            return "t_index" in f
    except OSError:
        return False


if __name__ == "__main__":
    sys.exit(main())
