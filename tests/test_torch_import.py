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
