"""The port imports torch and never jax: every kwave_tpu_torch module imports with jax
blocked."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import kwave_tpu_torch
names = [m.name for m in pkgutil.walk_packages(kwave_tpu_torch.__path__,
                                               "kwave_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
print(len(names))
"""


def test_every_module_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    # scaffold, codec, kernels, encoder, sampling, streams, solver, io, utils, driver, cli
    assert int(proc.stdout.strip()) >= 20


def test_codec_modules_import_without_jax():
    """The codec slice's modules are among those walked, and import with jax blocked."""
    script = _SCRIPT.replace("print(len(names))", "print(' '.join(names))")
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert {"kwave_tpu_torch.decoder", "kwave_tpu_torch.ops.fastpath",
            "kwave_tpu_torch.bench", "kwave_tpu_torch.examples.end_to_end"} <= names
