"""The port's codec benchmark (kwave_tpu_torch.bench) at a tiny shape on the CPU: the JSON
line carries bench.py's keys, the round trip passes its err < 0.02 guard, the chain runs
the expected number of round trips, and a series the basis cannot hold trips the guard."""

import json
import os
import subprocess
import sys

import pytest

from kwave_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("metric", "value", "unit", "vs_baseline", "actual_bytes_value", "ceiling",
        "fraction")


@pytest.mark.parametrize("compute", ["flat", "vpu"])
def test_bench_runs_small_on_the_cpu(compute):
    res = bench.run(steps=400, sensors=96, reps_inner=3, reps_outer=2, compute=compute,
                    device="cpu")
    assert all(k in res for k in KEYS)
    assert res["metric"] == "codec_encode_decode" and res["unit"] == "GB/s"
    assert res["device"] == "cpu"
    assert res["round_trip_err"] < bench.GUARD
    assert res["round_trips"] == 1 + (1 + 2) * 3  # guard, warm-up chain, timed chains
    assert res["shape"]["frames"] == [20, 4, 96]
    assert all(res[k] > 0 for k in ("value", "vs_baseline", "ceiling", "fraction"))
    # 2S + 2F over 2S: F/S = 2H/o = 0.4 at period 20, H = 2
    assert res["actual_bytes_value"] == pytest.approx(1.2 * res["value"])


def test_bench_guard_trips_on_a_series_the_basis_cannot_hold():
    with pytest.raises(RuntimeError, match="relative error"):
        bench.run(steps=200, sensors=32, harmonics=1, reps_inner=1, reps_outer=1,
                  device="cpu")


def test_bench_main_prints_one_json_line():
    env = dict(os.environ, KWAVE_TPU_TORCH_DEVICE="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "kwave_tpu_torch.bench", "--steps", "200", "--sensors",
         "32", "--reps-inner", "2", "--reps-outer", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    assert set(KEYS) <= set(json.loads(lines[0]))


def test_bench_refuses_a_missing_card():
    env = dict(os.environ, KWAVE_TPU_TORCH_DEVICE="cuda")
    proc = subprocess.run([sys.executable, "-m", "kwave_tpu_torch.bench"], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode == 0:
        pytest.skip("a CUDA card is present here")
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert proc.stdout == ""
