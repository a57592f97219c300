"""kspaceFirstOrder-Torch command-line entry (port of `kwave_tpu.cli`; main.cpp:840-937).

``python -m kwave_tpu_torch.cli -i input.h5 -o output.h5 --p_raw --p_c --40-bit_complex``

The device comes from ``KWAVE_TPU_TORCH_DEVICE`` (``cuda`` by default, ``cpu`` for the
tests); asking for CUDA where it is not available raises.

On a mesh: ``--devices N`` z-shards the run over N cards of this process (N shards on the
CPU); ``--coordinator HOST:PORT --num_processes P --process_id R`` (or ``--distributed``
under torchrun) runs P processes, each with ``--devices`` / P shards (one without
``--devices``) on as many of its host's cards over NCCL, or CPU shards over gloo.
Process 0 alone writes the output file.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from kwave_tpu_torch.driver import _corners_to_indices, require_device, run_simulation
from kwave_tpu_torch.io.h5file import File, FormatError
from kwave_tpu_torch.io.input_file import read_input_file
from kwave_tpu_torch.params import (
    args_to_run_config,
    build_parser,
    refused_fft_flags,
    unported_flags,
)
from kwave_tpu_torch.utils.observability import Logger, PhaseTimers

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
    import torch.distributed as dist

    ours = not dist.is_initialized()  # a process group this call starts, it also ends
    mesh = mesh_from_args(parser, args, device)
    try:
        return _run(args, device, mesh)
    finally:
        if ours and dist.is_initialized():
            dist.destroy_process_group()


def mesh_from_args(parser, args, device: torch.device):
    """The run's mesh from the mesh flags (None: one device), as `kwave_tpu.cli` builds
    it: a process group first when one is asked for (``--num_processes`` needs
    ``--coordinator`` and ``--process_id``), whose mesh spans every rank: ``--devices``
    counts every process's devices, a multiple of the P processes (P by default), and
    each process takes ``--devices`` / P of them (its cards, `initialize`'s ``cards``,
    or that many CPU shards); else ``--devices N`` shards in this process, on N cards,
    or N times the CPU."""
    import torch.distributed as dist

    from kwave_tpu_torch.parallel import make_mesh
    from kwave_tpu_torch.parallel.distributed import initialize

    world = None  # the process group's size, known before it starts
    if args.num_processes is not None:
        if args.num_processes > 1 and (args.coordinator is None or args.process_id is None):
            parser.error("--num_processes requires --coordinator HOST:PORT and "
                         "--process_id R (or use bare --distributed under torchrun)")
        if args.coordinator is not None:
            world = args.num_processes
    elif args.distributed:
        world = int(os.environ["WORLD_SIZE"])
    if dist.is_initialized():  # a group the caller started
        world = dist.get_world_size()
    n = args.devices if args.devices is not None else world or 1
    if world is not None and n % world:
        parser.error(f"--devices {n} under a multi-process launch must equal the global "
                     f"device count: the {world} processes' local devices, the same "
                     f"number each, so a multiple of {world}")
    local = n // world if world is not None else n
    if world is not None and not dist.is_initialized():
        if args.num_processes is not None:
            initialize(args.coordinator, args.num_processes, args.process_id, device,
                       cards=local)
        else:
            initialize(device=device, cards=local)
    if n == 1:
        return None
    return make_mesh(n, devices=[device] * local if device.type == "cpu" else None)


def _run(args, device: torch.device, mesh) -> int:
    writer = mesh is None or mesh.is_writer
    t0 = time.perf_counter()
    timers = PhaseTimers()  # the data load's; run_simulation times the other phases
    timers.start("data_load")
    data = read_input_file(args.input_file)
    load_s = timers.stop("data_load")

    if args.post:
        if not writer:
            return 0  # only process 0 touches the output file
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
        print(f"[kwave_tpu_torch] post-processing done in {time.perf_counter() - t0:.2f}s")
        return 0

    if args.benchmark is not None:
        # --benchmark truncates Nt (Parameters.cpp:130-133)
        data.grid = dataclasses.replace(data.grid, nt=min(args.benchmark, data.grid.nt))
    run = args_to_run_config(args, dt=data.grid.dt)
    run.data_load_seconds = load_s
    if not any(run.flags.values()) and not (
        args.I_avg or args.I_avg_c or args.Q_term or args.Q_term_c
    ):
        # a run with no outputs at all is useless: keep the reference's old p default,
        # but only when no output of any kind (intensity, Q term) was asked for
        run.flags["p_raw"] = True

    t1 = time.perf_counter()
    summary = run_simulation(
        data, run, args.output_file, device=device,
        resume_from=args.checkpoint_file
        if args.checkpoint_file and _checkpoint_exists(args.checkpoint_file) else None,
        mesh=mesh,
    )
    sim_s = time.perf_counter() - t1

    if args.copy_sensor_mask and writer:
        # carry the mask into the output file (1-based on disk, as in the input format)
        from kwave_tpu_torch.io import names as dn
        from kwave_tpu_torch.io.hdf5 import tag_dataset

        with File(args.output_file, "r+") as f:
            if data.sensor_mask_index is not None:
                name, arr = dn.SENSOR_MASK_INDEX, data.sensor_mask_index[None, None, :]
            else:
                name, arr = dn.SENSOR_MASK_CORNERS, data.sensor_mask_corners[None, :, :]
            ds = f.create_dataset(name, data=arr.astype(np.uint64) + 1)
            tag_dataset(ds, data=dn.DATA_LONG)

    where = device if mesh is None else mesh
    print(f"[kwave_tpu_torch] {where}: load {load_s:.2f}s  simulate+store {sim_s:.2f}s")
    for name, shape in summary.items():
        print(f"  {name}: {shape}")
    return 0


def _checkpoint_exists(path: str) -> bool:
    """A readable checkpoint file is at ``path`` (then the run continues from it)."""
    if not os.path.exists(path):
        return False
    try:
        with File(path, "r") as f:
            return "t_index" in f
    except (OSError, FormatError):
        return False


if __name__ == "__main__":
    sys.exit(main())
