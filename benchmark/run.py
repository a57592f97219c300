"""Run one cell of BENCHMARK.json once on this machine's NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as its last line of standard output, one JSON object: ``correct``, ``attempted``
(jobs started in the window), ``failed`` (jobs that raised or broke a limit), ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number that decides ``correct`` beside its limit (also the last lines of standard error).
Exits non-zero, printing no result, without as many CUDA cards as the cell asks for, or
when the JAX package or JAX was loaded in this process.
"""

import time

T_START = time.time()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":  # run as a script: import from the checkout's root
    sys.path[0] = str(ROOT)


def _power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    try:
        cell = harness.load_cell(args.workload)
    except (harness.CellError, OSError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {n}", file=sys.stderr)
        return 3
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    torch.cuda.set_device(devices[0])
    print(f"card: {_power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr, flush=True)
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), devices,
                           T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}; it may load none of "
              f"{', '.join(harness.FORBIDDEN)}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(devices[0]),
              "count": cell.chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    device.update(res.get("device_trace", {}))
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"], "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    # a number that could not be read (a dataset missing) is printed as the largest float
    line["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"]) else 1e308,
                          "limit": c["limit"]} for k, c in res["checks"].items()}
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
