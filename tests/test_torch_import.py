"""The port imports torch, never jax and nothing of kwave_tpu: every kwave_tpu_torch
module, and chip_smoke.py, imports with all three blocked."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "kwave_tpu")


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if fullname.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {fullname}")
        return None


sys.meta_path.insert(0, Blocker())
import kwave_tpu_torch
names = [m.name for m in pkgutil.walk_packages(kwave_tpu_torch.__path__,
                                               "kwave_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # import only: main() needs the card
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print(len(names))
"""


def _run(script):
    return subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120)


def test_every_module_imports_without_jax():
    proc = _run(_SCRIPT)
    assert proc.returncode == 0, proc.stderr
    # scaffold, codec, kernels, encoder, sampling, streams, solver, io, utils, driver, cli
    assert int(proc.stdout.strip()) >= 20


def test_codec_modules_import_without_jax():
    """The codec slice's modules are among those walked, and import with jax blocked."""
    proc = _run(_SCRIPT.replace("print(len(names))", "print(' '.join(names))"))
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert {"kwave_tpu_torch.decoder", "kwave_tpu_torch.ops.fastpath",
            "kwave_tpu_torch.bench", "kwave_tpu_torch.examples.end_to_end"} <= names


def test_blocker_blocks_the_jax_package():
    """The finder the other tests rely on really refuses `kwave_tpu` and `jax`, and the
    port's own spec modules and the last slice's modules are among those walked."""
    probe = _SCRIPT.split("import kwave_tpu_torch")[0] + """
for name in BLOCKED + ("kwave_tpu.basis",):
    try:
        importlib.import_module(name)
    except ImportError:
        continue
    raise SystemExit(f"{name} imported although blocked")
"""
    proc = _run(probe)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    proc = _run(_SCRIPT.replace("print(len(names))", "print(' '.join(names))"))
    assert proc.returncode == 0, proc.stderr
    assert {"kwave_tpu_torch.basis", "kwave_tpu_torch.oracle",
            "kwave_tpu_torch.ops.encode_series", "kwave_tpu_torch.ops.zfuse"} \
        <= set(proc.stdout.split())


def test_parallel_modules_import_without_jax_and_without_h5py():
    """The mesh slice's modules are among those walked, and import with jax, kwave_tpu
    and h5py blocked (torch.distributed is imported inside the functions that use it)."""
    proc = _run(_SCRIPT.replace("print(len(names))", "print(' '.join(names))"))
    assert proc.returncode == 0, proc.stderr
    assert {"kwave_tpu_torch.parallel", "kwave_tpu_torch.parallel.mesh",
            "kwave_tpu_torch.parallel.fft", "kwave_tpu_torch.parallel.comm",
            "kwave_tpu_torch.parallel.distributed", "kwave_tpu_torch.parallel.sharded"} \
        <= set(proc.stdout.split())
    proc = _run(_SCRIPT.replace('BLOCKED = ("jax", "jaxlib", "kwave_tpu")',
                                'BLOCKED = ("jax", "jaxlib", "kwave_tpu", "h5py")'))
    assert proc.returncode == 0, proc.stderr


def test_checkpoint_and_postproc_import_without_jax_and_without_h5py():
    """The checkpoint-leg and post-processing modules are among those walked, and they
    (with every other module of the port, and chip_smoke) also import where h5py is
    absent: it is imported only inside the function that opens a file on disk."""
    proc = _run(_SCRIPT.replace("print(len(names))", "print(' '.join(names))"))
    assert proc.returncode == 0, proc.stderr
    assert {"kwave_tpu_torch.io.checkpoint", "kwave_tpu_torch.postproc"} \
        <= set(proc.stdout.split())
    proc = _run(_SCRIPT.replace('BLOCKED = ("jax", "jaxlib", "kwave_tpu")',
                                'BLOCKED = ("jax", "jaxlib", "kwave_tpu", "h5py")'))
    assert proc.returncode == 0, proc.stderr


# What of kwave_tpu has no counterpart in the port, on purpose, each with its reason: a
# module ("path") or one top-level name of a module ("path::name"). ROADMAP.md's "Not
# ported, on purpose" and queue 1 say more.
NOT_PORTED = {
    "native/__init__.py": "the C++ oracle (-ffp-contract=off): one more reference of the "
                          "tests, not a part of the port",
    "native/build.py": "builds that C++ oracle",
    "ops/mxfft.py": "the matmul FFT exists because XLA's FFT is slow on a TPU; cuFFT does "
                    "that job on the card, so the pencil FFT (parallel/fft.py, "
                    "pencil_fft) takes no engine= and solver/step.py::FftOps has no "
                    "shift_axis / batched hooks",
    "encoder.py::USE_PALLAS": "the TPU kernel switch; the port picks the kernel by the "
                              "tensor's device",
    "ops/fastpath.py::LANE": "the TPU's 128-lane tile",
    "ops/zfuse.py::LANE": "the TPU's 128-lane tile",
    "ops/zfuse.py::BY": "the TPU kernel's y block",
    "ops/encode_pallas.py::LANE": "the TPU's 128-lane tile",
    "solver/operators.py::cvec": "packed (re, im) planes are a TPU layout; the port keeps "
                                 "complex64",
    "solver/operators.py::pack_complex": "the same packed layout",
}
# A module of the JAX package whose names the port spreads over other modules.
COUNTERPARTS = {"ops/encode_pallas.py": ("ops/encode_window.py", "ops/encode_series.py")}


def _top_level(path, public_only, reexports):
    """Top-level names a module defines or assigns (with ``reexports``, also those it
    imports from elsewhere, as an ``__init__`` exports them); read with ``ast``, nothing
    imported."""
    import ast

    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif reexports and isinstance(node, (ast.Import, ast.ImportFrom)) and \
                getattr(node, "module", None) != "__future__":
            names |= {a.asname or a.name.split(".")[0] for a in node.names}
    return {n for n in names if not (public_only and n.startswith("_"))}


def test_every_public_name_of_kwave_tpu_has_a_counterpart():
    """Each public top-level name of each kwave_tpu module (an ``__init__``'s re-exports
    included) is bound at the top level of its counterpart in kwave_tpu_torch, or stands
    on NOT_PORTED with its reason; and NOT_PORTED names nothing the port has since got."""
    import pathlib

    ref, port = pathlib.Path(REPO, "kwave_tpu"), pathlib.Path(REPO, "kwave_tpu_torch")
    missing, stale = [], []
    for path in sorted(ref.rglob("*.py")):
        rel = path.relative_to(ref).as_posix()
        names = _top_level(path, True, path.name == "__init__.py")
        others = [port / c for c in COUNTERPARTS.get(rel, (rel,))]
        have = set()
        for other in others:
            if other.exists():
                have |= _top_level(other, False, True)
        if rel in NOT_PORTED:
            if have:
                stale.append(rel)
            continue
        for name in sorted(names - have):
            if f"{rel}::{name}" not in NOT_PORTED:
                missing.append(f"{rel}::{name}")
        stale += [k for k in NOT_PORTED if k.startswith(f"{rel}::")
                  and k.split("::")[1] in have]
    assert not missing, f"not in the port and not on NOT_PORTED: {missing}"
    assert not stale, f"on NOT_PORTED but present in the port: {stale}"
    assert all(reason for reason in NOT_PORTED.values())


# ---------------------------------------------------------------------------
# The entry point with h5py blocked: the port's files go through its own HDF5 codec
# ---------------------------------------------------------------------------

_CLI = _SCRIPT.split("import kwave_tpu_torch")[0].replace(
    'BLOCKED = ("jax", "jaxlib", "kwave_tpu")',
    'BLOCKED = ("jax", "jaxlib", "kwave_tpu", "h5py")') + """
import runpy
sys.argv = ["kwave_tpu_torch.cli", *ARGS]
try:
    runpy.run_module("kwave_tpu_torch.cli", run_name="__main__")
finally:
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
"""
CLI_PERIOD, CLI_SENSORS = 8, 48
CLI_STEPS = 5 * CLI_PERIOD + 3  # 5 windows and a 3-step tail


def _cli_blocked(args):
    """``python -m kwave_tpu_torch.cli *args`` on the CPU, with jax, jaxlib, kwave_tpu
    and h5py blocked."""
    env = dict(os.environ, KWAVE_TPU_TORCH_DEVICE="cpu", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", _CLI.replace("*ARGS", repr(args)[1:-1])],
                          cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _cli_input(path):
    """16^3 heterogeneous absorbing medium, p0 at two points, 48 index sensors, written
    by the JAX package (tests/test_torch_driver.py's input, smaller)."""
    import numpy as np

    from kwave_tpu.io import input_file as jin
    from kwave_tpu.solver import Grid, Medium

    n = 16
    grid = Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=CLI_STEPS)
    rng = np.random.default_rng(11)
    medium = Medium(c0=(1500 + 100 * rng.random(grid.shape)).astype(np.float32),
                    rho0=(1000 + 50 * rng.random(grid.shape)).astype(np.float32),
                    alpha_coeff=0.75, alpha_power=1.5)
    p0 = np.zeros(grid.shape, np.float32)
    p0[8, 8, 8], p0[6, 9, 7] = 1e5, -5e4
    mask = np.sort(rng.choice(grid.n_elements, CLI_SENSORS, replace=False)).astype(np.int64)
    jin.write_input_file(path, jin.InputData(
        grid=grid, medium=medium, pml_size=(4, 4, 4), pml_alpha=(2.0,) * 3,
        absorbing=True, sensor_mask_index=mask, p0=p0))


def _p_c_is_the_oracle_s_encoding_of_p(path):
    """The port's 40-bit p_c rows are the oracle's encoding of the port's own p, byte for
    byte (tests/test_torch_driver.py's check)."""
    import h5py
    import numpy as np

    from kwave_tpu import oracle
    from kwave_tpu.basis import generate_basis

    with h5py.File(path, "r") as f:
        p, rows = np.asarray(f["p"])[0], np.asarray(f["p_c"])[0]
    basis = generate_basis(float(CLI_PERIOD), 1, 1, normalize=True)
    frames = oracle.OracleEncoder(basis, CLI_SENSORS, mode40=True, overlap=True,
                                  total_steps=p.shape[0]).encode_series(p)
    want = np.stack([oracle.soa_to_bytes(*fr) for fr in frames])
    mine = np.ascontiguousarray(rows).view(np.uint8)[:, : 5 * CLI_SENSORS]
    assert rows.shape[0] == CLI_STEPS // CLI_PERIOD
    np.testing.assert_array_equal(mine, want)


def _the_same_bits(a, b):
    """Two output files of the port equal bit for bit: every dataset and attribute but
    the root's run-specific ones."""
    import h5py
    import numpy as np

    from acceptance_cases import _VOLATILE_ROOT

    def content(f):
        out = {k: np.asarray(v).tobytes() for k, v in f.attrs.items()
               if not any(w in k for w in _VOLATILE_ROOT)}
        f.visititems(lambda name, obj: out.__setitem__(name, (
            None if isinstance(obj, h5py.Group) else
            (obj.shape, obj.dtype.str, obj.chunks, obj.compression, obj.compression_opts,
             np.asarray(obj[()]).tobytes()),
            {k: np.asarray(v).tobytes() for k, v in obj.attrs.items()})))
        return out

    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        assert content(fa) == content(fb)


def test_cli_runs_end_to_end_without_h5py(tmp_path):
    """``python -m kwave_tpu_torch.cli --p_raw --p_c --40-bit_complex -c 4
    --copy_sensor_mask`` with h5py blocked writes what the JAX CLI writes on the same
    input (h5py reads both): the same tree, shapes, chunks, filters and attributes, raw p
    within rel L2 1e-4, and p_c the oracle's encoding of the port's own p."""
    import shutil

    import h5py

    import acceptance_cases as ac
    from kwave_tpu import cli as jcli

    inp_j, inp_t = str(tmp_path / "in_jax.h5"), str(tmp_path / "in_port.h5")
    _cli_input(inp_j)
    shutil.copy(inp_j, inp_t)
    out_j, out_t = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    flags = ["--p_raw", "--p_c", "--40-bit_complex", "-c", "4", "--copy_sensor_mask",
             "--period", str(CLI_PERIOD)]
    assert jcli.main(["-i", inp_j, "-o", out_j, *flags]) == 0
    _cli_blocked(["-i", inp_t, "-o", out_t, *flags])
    with h5py.File(out_j, "r") as fj, h5py.File(out_t, "r") as ft:
        errs, _ = ac.compare_outputs(fj, ft)
        assert ft["p"].compression_opts == 4 and "sensor_mask_index" in ft
    assert errs["p"] <= ac.REL_L2
    _p_c_is_the_oracle_s_encoding_of_p(out_t)


def test_cli_legs_and_post_without_h5py(tmp_path):
    """The same input in two legs through ``--checkpoint_file`` and then ``--post``,
    with h5py blocked: bit for bit the port's one-leg run with the same ``--post``, and
    held to the JAX CLI's legs and post as the sweep holds two outputs."""
    import shutil

    import h5py

    import acceptance_cases as ac
    from kwave_tpu import cli as jcli

    flags = ["--p_raw", "--p_c", "--40-bit_complex", "--u_non_staggered_raw",
             "--period", str(CLI_PERIOD)]
    post = ["--post", "--I_avg", "--Q_term"]
    inp = str(tmp_path / "in.h5")
    _cli_input(inp)
    outs = {}
    for who in ("jax", "legs", "one"):
        shutil.copy(inp, str(tmp_path / f"in_{who}.h5"))
        outs[who] = str(tmp_path / f"{who}.h5")
    legs = ["--checkpoint_file", str(tmp_path / "ckpt_{}.h5"), "--checkpoint_timesteps",
            str(3 * CLI_PERIOD)]  # 24 steps, then the other 19

    def args(who, *more):
        return ["-i", str(tmp_path / f"in_{who}.h5"), "-o", outs[who],
                *[m.format(who) for m in more]]

    for _ in range(2):
        assert jcli.main(args("jax", *flags, *legs)) == 0
        _cli_blocked(args("legs", *flags, *legs))
    with h5py.File(outs["legs"], "r") as f:  # the second leg finished the record
        assert f["p"].shape[1] == CLI_STEPS and f["p"][0, -1].any()
    _cli_blocked(args("one", *flags))
    assert jcli.main(args("jax", *post)) == 0
    _cli_blocked(args("legs", *post))
    _cli_blocked(args("one", *post))
    _the_same_bits(outs["legs"], outs["one"])
    with h5py.File(outs["jax"], "r") as fj, h5py.File(outs["legs"], "r") as ft:
        errs, _ = ac.compare_outputs(fj, ft)
    assert {"p", "p_c", "Ix_avg", "Q_term"} <= set(errs), sorted(errs)
    _p_c_is_the_oracle_s_encoding_of_p(outs["legs"])
