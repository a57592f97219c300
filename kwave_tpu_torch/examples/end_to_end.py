"""End-to-end worked example on the port (port of ``examples/end_to_end.py``): build an
input file, simulate with a raw and a compressed pressure stream, decode the compressed
stream back to time series, and verify it against the raw recording.

    python -m kwave_tpu_torch.examples.end_to_end [workdir]

The device comes from ``KWAVE_TPU_TORCH_DEVICE`` (``cuda`` by default, ``cpu`` for the
tests). Needs ``h5py`` for the files. The decode runs on the same device: on CUDA it is
one launch of the synthesis kernel (`kwave_tpu_torch.ops.fastpath`).
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from kwave_tpu_torch import decoder
from kwave_tpu_torch.basis import generate_basis
from kwave_tpu_torch.driver import RunConfig, run_simulation
from kwave_tpu_torch.io.input_file import InputData, read_input_file, write_input_file
from kwave_tpu_torch.solver import Grid, Medium

PERIOD = 20.0  # timesteps per source cycle = the compression basis period
HARMONICS = 2
GATE = 0.05  # relative error of the steady-state half, as examples/end_to_end.py


def main(workdir: str | None = None, device: torch.device | str | None = None) -> int:
    import h5py

    if device is None:
        from kwave_tpu_torch.cli import device_from_env

        device = device_from_env()
    workdir = workdir or tempfile.mkdtemp(prefix="kwave_tpu_torch_example_")
    os.makedirs(workdir, exist_ok=True)

    # -- 1. Describe the simulation (what the MATLAB toolbox would do) -------------
    n = 32
    grid = Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=400)
    rng = np.random.default_rng(0)
    medium = Medium(  # heterogeneous speed of sound, absorbing
        c0=(1500.0 + 50.0 * rng.random(grid.shape)).astype(np.float32),
        rho0=1000.0, alpha_coeff=0.75, alpha_power=1.5,
    )
    # A driven tonal source, the codec's production regime: the compression period
    # matches the source period (a broadband p0 pulse would not compress well).
    src_plane = n // 4
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    disc = (yy - n / 2) ** 2 + (xx - n / 2) ** 2 <= (n / 6) ** 2
    src_idx = ((src_plane * n + yy[disc]) * n + xx[disc]).astype(np.int64)
    t_sig = np.arange(grid.nt, dtype=np.float32)
    signal = (1e5 * np.sin(2 * np.pi * t_sig / PERIOD)).astype(np.float32)
    sensors = np.sort(rng.choice(grid.n_elements, 128, replace=False))

    inp = os.path.join(workdir, "input.h5")
    write_input_file(inp, InputData(
        grid=grid, medium=medium, absorbing=True,
        pml_size=(6, 6, 6), pml_alpha=(2.0,) * 3,
        sensor_mask_index=sensors.astype(np.int64),
        p_source_flag=grid.nt, p_source_mode=1,  # additive-no-correction
        p_source_index=src_idx, p_source_input=signal,
    ))

    # -- 2. Simulate with a raw AND a compressed pressure stream -------------------
    # (equivalently: python -m kwave_tpu_torch.cli -i input.h5 -o output.h5
    #                    --p_raw --p_c --period 20 --harmonics 2)
    out = os.path.join(workdir, "output.h5")
    summary = run_simulation(
        read_input_file(inp),
        RunConfig(flags=dict(p_raw=True, p_c=True), period=PERIOD, harmonics=HARMONICS),
        out, device=device,
    )
    print("datasets written:", {k: tuple(v) for k, v in summary.items()})

    # -- 3. Read the output and decode the compressed stream -----------------------
    with h5py.File(out) as f:
        raw = np.asarray(f["p"])[0]  # [Nt, Nsens]
        pc = np.asarray(f["p_c"])[0]  # [Nc, mSize] coefficient frames
        attrs = dict(f["p_c"].attrs)
    h = int(attrs["c_harmonics"])
    if attrs["c_period"] != np.float32(PERIOD) or h != HARMONICS:
        raise RuntimeError(f"p_c attributes {attrs} do not match the run")

    # frames [Nc, mSize = 2*H*Nsens interleaved re/im] -> [Nc, H, N] re/im planes,
    # then the basis synthesis on the device
    coeffs = pc.reshape(pc.shape[0], len(sensors), h, 2)
    f_re = np.transpose(coeffs[..., 0], (0, 2, 1))  # [Nc, H, N]
    f_im = np.transpose(coeffs[..., 1], (0, 2, 1))
    cb = generate_basis(PERIOD, 1, HARMONICS, normalize=True)
    o = cb.o_size
    rec = decoder.reconstruct_series(f_re, f_im, cb, False, raw.shape[0],
                                     device=device).cpu().numpy()

    # -- 4. Verify: the reconstruction matches the raw recording -------------------
    # the steady-state half of the record: the arrival transient at each sensor is
    # broadband and is not what the tonal codec encodes; the last window is partial
    steps = f_re.shape[0] * o
    lo, hi = steps // 2, steps - 2 * o
    err = np.abs(rec[lo:hi] - raw[lo:hi]).max() / np.abs(raw[lo:hi]).max()
    ratio = raw.size * 4 / pc.nbytes
    print(f"roundtrip rel err {err:.2e} (windowed-harmonic projection), "
          f"compression ratio {ratio:.1f}x, on {device}")
    if not err < GATE:
        raise RuntimeError(f"round-trip relative error {err} >= {GATE}")
    print("OK: output at", out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else None))
