"""The control of a cell's check: the reference computed in bfloat16 put in the program's
place, at the cell's own size, on several seeds; with it the program's own readings are
the lower end of each limit and the control's the upper (PERF.md gives both).

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13

For each seed it makes the cell's inputs, runs the float64 reference and the bfloat16
one, writes the bfloat16 run's outputs as the program would (the raw series, the
oracle's 40-bit words at the sampled sensors) and prints
one JSON line of the check's numbers. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

if __name__ == "__main__":  # run as a script: import from the checkout's root
    sys.path[0] = str(Path(__file__).resolve().parent.parent)


def as_program_outputs(cell, inputs: dict, seed: int, series: np.ndarray) -> dict:
    """A job's datasets (name -> (array, dtype name, attrs)) holding ``series`` (a
    reference run's pressure at the sensors) in the program's layout. Compressed rows hold
    the oracle's words at the sampled sensors only: the check reads no other."""
    from benchmark.reference import compare, recipe

    n = int(inputs["sensors"].numel())
    h = int(cell.config.get("harmonics", 1))
    sample = recipe.oracle_sample(n, int(cell.config["oracle_sensors"]), seed)
    basis = compare.Codec(float(cell.config["period"]), h, sample, n).basis
    raw = compare._encode(series[:, sample], basis)
    rows = np.zeros((raw.shape[0], -(-5 * n // 4) * h * 4), np.uint8)
    rows[:, : 5 * n * h].reshape(raw.shape[0], n, h, 5)[:, sample] = raw
    out = {}
    for c in cell.config["checks"]:
        if c["kind"] == "series":
            out[c["dataset"]] = series.astype(np.float32)[None]
        elif c["kind"] in ("coeff", "bytes"):
            out[c["dataset"]] = rows.view(np.float32)[None]
            if c["kind"] == "bytes":
                out[c["raw"]] = series.astype(np.float32)[None]
    return {k: (v, str(v.dtype), {}) for k, v in out.items()}


def control_numbers(cell, seed: int, device) -> dict:
    """The check's numbers of the reference computed in bfloat16 in the program's place,
    on the cell's inputs of ``seed``."""
    from benchmark import harness

    inputs = harness.make_inputs(cell, seed, device)
    inputs = {k: v.cpu() if hasattr(v, "cpu") else v for k, v in inputs.items()}
    ref = harness.reference_outputs(cell, inputs, device)
    low = harness.reference_outputs(cell, inputs, device, "bfloat16")
    outputs = as_program_outputs(cell, inputs, seed, low.numpy())
    got = harness.numbers(cell, inputs, seed, [outputs], ref)[0]
    got.pop("layout_off", None)  # the control writes no file: its layout is not its own
    return got


def main(argv=None) -> int:
    import torch

    from benchmark import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = control_numbers(cell, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": cell.name, "seed": seed, "precision": "bfloat16",
                          "seconds": time.perf_counter() - t0, "numbers": got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
