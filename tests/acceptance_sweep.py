"""Both CLIs on the acceptance cases (`acceptance_cases.CASES`): the shared part of
tests/test_torch_acceptance_*.py. Each case's input is written once per package by
`kwave_tpu.io.input_file.write_input_file` (a run may write a detected period back into
its input file), `kwave_tpu.cli.main` and `kwave_tpu_torch.cli.main` (on the CPU) run it,
in legs and with ``--post`` where the case says so, and the two output files are held to
each other (`acceptance_cases.compare_outputs`)."""

from __future__ import annotations

import importlib
import math
import os

import h5py
import numpy as np
import pytest

import acceptance_cases as ac
from kwave_tpu import cli as jcli
from kwave_tpu.io import input_file as jin
from kwave_tpu.solver import Grid, Medium
from kwave_tpu_torch import cli as tcli


def jax_input(c: ac.Case, tmp: str):
    """The case's input as `kwave_tpu`'s InputData: what the JAX suite's function returns
    (with the case's edits), or the inline fields."""
    if c.base is None:
        f = c.fields()
        return jin.InputData(**dict(f, grid=Grid(**f["grid"]), medium=Medium(**f["medium"])))
    module, fn, kwargs = c.base
    make = getattr(importlib.import_module(module), fn)
    if fn == "_toy_input":  # writes its own file too, into the directory it is given
        from pathlib import Path

        os.makedirs(tmp, exist_ok=True)
        data = make(Path(tmp), **kwargs)[1]
    else:
        data = make(**kwargs)
    for k, v in (c.edits() if c.edits else {}).items():
        setattr(data, k, v)
    return data


def _run(main, c: ac.Case, data, where: str, env: dict) -> str:
    os.makedirs(where, exist_ok=True)
    inp, out = os.path.join(where, "in.h5"), os.path.join(where, "out.h5")
    jin.write_input_file(inp, data)
    args = ["-i", inp, "-o", out, *c.flags]
    calls = 1
    if c.legs:
        args += ["--checkpoint_file", os.path.join(where, "ckpt.h5"),
                 "--checkpoint_timesteps", str(c.legs)]
        calls = math.ceil(c.sampled_steps / c.legs)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        for _ in range(calls):
            assert main(args) == 0, (c.name, args)
        if c.post:
            assert main(["-i", inp, "-o", out, "--post", *c.post]) == 0, (c.name, "--post")
    return out


class Runs:
    """Each case's pair of output files (JAX, port), made at first use and shared by the
    module's checks."""

    def __init__(self, tmp):
        self.tmp, self.done = str(tmp), {}

    def __call__(self, name: str):
        if name not in self.done:
            c = ac.case(name)
            where = os.path.join(self.tmp, name)
            data = jax_input(c, where)
            self.done[name] = (_run(jcli.main, c, data, os.path.join(where, "jax"), {}),
                               _run(tcli.main, c, data, os.path.join(where, "port"),
                                    {tcli.DEVICE_ENV: "cpu"}))
        return self.done[name]


def names(group: str) -> list[str]:
    return [c.name for c in ac.CASES if c.group == group]


def check_outputs(runs: Runs, name: str) -> None:
    out_j, out_t = runs(name)
    with h5py.File(out_j, "r") as fj, h5py.File(out_t, "r") as ft:
        errs, floored = ac.compare_outputs(fj, ft)
    assert errs and not floored, (name, floored)


def check_p_c_bytes(runs: Runs, name: str) -> None:
    """The port fed the JAX run's ``p`` series writes the oracle's ``p_c`` bytes (the
    port's encoders are the oracle's bit for bit). The JAX file's own bytes may differ in
    a few coefficients, because XLA:CPU contracts the JAX encoder's mul+add (float and
    40-bit alike): float frames within 1e-5 of the port's, 40-bit frames equal or, where
    not, their decoded coefficients within rel L2 1e-4 (`compare_outputs`' bound)."""
    from kwave_tpu_torch import oracle
    from kwave_tpu_torch.basis import generate_basis

    out_j, _ = runs(name)
    with h5py.File(out_j, "r") as f:
        fed = ac.p_c_fed_the_series(f, ac.case(name))
        assert fed is not None, f"{name}: no index-mask p and p_c"
        mine, stored, mode40 = fed
        series = np.asarray(f["p"])[0]
        ds = f["p_c"]
        h = int(ds.attrs["c_harmonics"])
        basis = generate_basis(float(ds.attrs["c_period"]), int(ds.attrs["c_mos"]), h,
                               normalize=True)
    assert mine.shape == stored.shape and mine.shape[0] >= 1
    overlap = "--no_overlap" not in ac.case(name).flags and basis.period < series.shape[0]
    frames = oracle.OracleEncoder(basis, series.shape[1], mode40=mode40, overlap=overlap,
                                  total_steps=series.shape[0]).encode_series(series)
    if mode40:
        want = np.stack([oracle.soa_to_bytes(*fr) for fr in frames])
    else:
        want = np.stack([np.stack(fr, -1).reshape(-1).view(np.uint8) for fr in frames])
    np.testing.assert_array_equal(mine, want)
    if mode40:
        def coeffs(raw):
            planes = oracle.bytes_to_soa(np.ascontiguousarray(raw).reshape(-1))
            return np.concatenate(oracle.decode40(*planes, oracle.MAX_EXP_P))

        a, b = coeffs(mine).astype(np.float64), coeffs(stored).astype(np.float64)
        assert np.linalg.norm(b - a) <= ac.REL_L2 * np.linalg.norm(a), name
    else:
        peak = float(np.abs(series).max())
        np.testing.assert_allclose(mine.view(np.float32), stored.view(np.float32),
                                   rtol=1e-5, atol=1e-5 * peak)


def has_p_c_pair(name: str) -> bool:
    c = ac.case(name)
    f = c.fields()
    return f.get("sensor_mask_index") is not None and "--p_c" in c.flags and \
        ("--p_raw" in c.flags or "-p" in c.flags)
