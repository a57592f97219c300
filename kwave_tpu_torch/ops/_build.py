"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` (all at once) and linked into
one shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers: the build takes seconds, not
minutes). The library goes to ``build/kwave_tpu_torch/`` at the repository root, named by
a hash of the sources and flags, so an unchanged tree reuses it and a changed one
rebuilds. Nothing here runs at import time: the first launch on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kwave_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_MIXED = [_P] * 12 + [_I] * 10 + [ctypes.c_float] * 4 + [_I] * 10 + [_P]  # kw_zfuse_mixed's
# C signatures of csrc/*.cu (pointers and the stream as void*)
SIGNATURES = {
    # encode_window.cu
    # chunk, tabs, 6 planes in, 6 planes out; steps, o, H, N, e, parity, mirror, overlap
    "kw_encode_window_40b": [_P] * 14 + [_I] * 8 + [_P],
    # chunk, tabs, 4 planes in, 4 planes out; steps, o, H, N, parity, mirror, overlap
    "kw_encode_window_float": [_P] * 10 + [_I] * 7 + [_P],
    # encode_series.cu
    # series, tabs, 3 frame planes, 6 state planes; K, o, H, N, e, overlap, G
    "kw_encode_series_40b": [_P] * 11 + [_I] * 7 + [_P],
    # series, tabs, 2 frame planes, 4 state planes; K, o, H, N, overlap, G
    "kw_encode_series_float": [_P] * 8 + [_I] * 6 + [_P],
    # fastpath.cu
    # series, tab_lo, tab_hi, frames; K, o, H, N
    "kw_project_frames": [_P] * 4 + [_I] * 4 + [_P],
    # chunk, tab_lo, tab_hi, p1_in, frame, p1_out; o, H, N, first_window
    "kw_project_window": [_P] * 6 + [_I] * 4 + [_P],
    # frames, tab, x; k_total, o, H, N, n_steps
    "kw_synth_series": [_P] * 3 + [_I] * 5 + [_P],
    # zfuse.cu
    # spectrum, roots, k2z, k2y, k2x, 3 dd vectors, 3 outputs; nz, ny, nxr, n_ops, 3 kinds,
    # 3 axes; 3 powers, c_ref_dt_2; use_kappa; the radices of the three passes (1 for a
    # pass that is not taken)
    "kw_zfuse_radix": [_P] * 11 + [_I] * 10 + [ctypes.c_float] * 4 + [_I] * 4 + [_P],
    # spectrum, roots, bins, k2z, k2y, k2x, 3 dd vectors, 3 outputs; the same ints and
    # floats; use_kappa, the number of passes, seven radices (1 past the last pass) and the
    # tile width (0: the kernel's rule)
    "kw_zfuse_mixed": _MIXED,
    # the same for a plan with a generic pass, the build capped for 2 and for 3 blocks an
    # SM (zfuse_mixed_generic*.cu; kw_zfuse_mixed picks one, a test may name either)
    "kw_zfuse_mixed_generic": _MIXED,
    "kw_zfuse_mixed_generic3": _MIXED,
    # the prime p: the entries of its generic pass's table
    "kw_zfuse_generic_table_size": [_I],
    # spectrum, M roots, chirp, filter, k2z, k2y, k2x, 3 dd vectors, 3 outputs; the same
    # ints and floats; use_kappa, M, the number of passes, seven radices, the tile width
    # and the staged tables
    "kw_zfuse_bluestein": [_P] * 13 + [_I] * 10 + [ctypes.c_float] * 4 + [_I] * 12 + [_P],
    # zfuse_column.cu: kw_zfuse_radix's arguments without the radices
    "kw_zfuse_column": [_P] * 11 + [_I] * 10 + [ctypes.c_float] * 4 + [_I] + [_P],
}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):  # the sources and the headers they share
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libkwave_tpu_torch_{digest.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; wait for every one, then raise on the first that
    failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    results = [p.communicate() for p in procs]
    for cmd, proc, (_, err) in zip(cmds, procs, results):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")


def build() -> Path:
    """Compile the sources unless a library for exactly these sources exists: one nvcc per
    source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build under a temporary name and rename, so a cut build never leaves a half file
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in _sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for obj, src in zip(objs, _sources())])
        lib = str(Path(tmp) / out.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every C signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
