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
