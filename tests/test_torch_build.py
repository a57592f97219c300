"""The C interface of the port's CUDA library, read from ``kwave_tpu_torch/csrc/`` on the
CPU: every ``extern "C"`` function that a source defines is declared in
`kwave_tpu_torch.ops._build.SIGNATURES` with the arguments of its definition, and
``SIGNATURES`` declares nothing else. `ctypes` passes whatever a wrapper gives it, so a
slip between a definition and its declaration would otherwise show only on the card."""

import ctypes
import re

import pytest

from kwave_tpu_torch.ops import _build

_MACRO = re.compile(r"^#define\s+(\w+)\s*((?:.*\\\n)*.*)$", re.M)
_BLOCK = re.compile(r'extern "C" \{(.*?)\n\}  // extern "C"', re.S)
_DEFINITION = re.compile(r"^(\w+)\s+(kw_\w+)\s*\(([^)]*)\)\s*\{", re.M)


def _macros() -> dict:
    """The object-like macros of the sources and headers, each on one line."""
    found = {}
    for src in sorted(_build.CSRC_DIR.glob("*.cu*")):
        for name, body in _MACRO.findall(src.read_text()):
            if not body.startswith("("):
                found[name] = body.replace("\\\n", " ")
    return found


def _ctype(param: str):
    """The argument type that ctypes must be given for one C parameter."""
    if "*" in param:
        return ctypes.c_void_p
    kind = param.split()[0]
    return {"int": ctypes.c_int, "float": ctypes.c_float}[kind]


def _entry_points() -> dict:
    """Name -> (return type, argument types) of every function defined inside an
    ``extern "C"`` block of ``csrc/*.cu``."""
    macros, found = _macros(), {}
    for src in sorted(_build.CSRC_DIR.glob("*.cu")):
        for block in _BLOCK.findall(src.read_text()):
            for ret, name, params in _DEFINITION.findall(block):
                params = macros.get(params.strip(), params)
                parts = [p.strip() for p in params.split(",") if p.strip()]
                assert name not in found, f"{name} is defined twice"
                found[name] = (ret, [_ctype(p) for p in parts if p != "void"])
    return found


ENTRY_POINTS = _entry_points()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_every_c_entry_point_is_declared(name):
    ret, argtypes = ENTRY_POINTS[name]
    assert ret == "int"  # load_library declares every restype c_int
    assert name in _build.SIGNATURES, f"{name} is not in _build.SIGNATURES"
    declared = _build.SIGNATURES[name]
    assert len(declared) == len(argtypes), \
        f"{name}: {len(declared)} arguments declared, {len(argtypes)} defined"
    assert declared == argtypes


def test_signatures_declare_only_functions_the_sources_define():
    assert set(_build.SIGNATURES) <= set(ENTRY_POINTS), \
        sorted(set(_build.SIGNATURES) - set(ENTRY_POINTS))
    assert len(ENTRY_POINTS) >= 14  # every kernel family's entries were found
