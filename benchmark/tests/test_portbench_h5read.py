"""The benchmark's frozen HDF5 reader reads the file cell's outputs as libhdf5 (through
h5py, where it is installed) and the program's own reader do: every dataset's bytes,
shape, type, chunks and attributes, and the file's attributes. It refuses what those
files never hold."""

import numpy as np
import pytest

from benchmark.reference import h5read
from benchmark.tests.portbench_helpers import SEED, tiny


def _bytes(a):
    return np.ascontiguousarray(a).view(np.uint8)


def _attrs(attrs) -> dict:
    """name -> (dtype, bytes) of each attribute, so that a type that differs shows."""
    out = {}
    for k in attrs.keys():
        v = np.asarray(attrs[k])
        out[k] = (v.dtype.str, v.shape, _bytes(v).tobytes())
    return out


def _summary(f) -> dict:
    out = {"/": _attrs(f.attrs)}
    for k in f.keys():
        d = f[k]
        out[k] = (d.shape, np.dtype(d.dtype).str, d.chunks,
                  _bytes(d[...]).tobytes(), _attrs(d.attrs))
    return out


def _cli_output(tmp_path, extra=()) -> str:
    import torch

    from benchmark import harness
    from kwave_tpu_torch import cli

    cell = tiny(harness.load_cell("het128-p40-files"), windows=3)
    inputs = harness.make_inputs(cell, SEED, torch.device("cpu"))
    program = harness.Program(cell, inputs, [torch.device("cpu")], tmp_path)
    out = str(tmp_path / "out.h5")
    argv = ["-i", program.input_path[cell.steps], "-o", out, *program.flags, *extra]
    assert cli.main(argv) == 0
    return out


def test_the_reader_reads_the_file_cells_output_as_libhdf5_and_the_program_do(tmp_path):
    from kwave_tpu_torch.io import h5file

    out = _cli_output(tmp_path)
    with h5read.File(out) as f:
        ours = _summary(f)
    assert {"p", "p_c"} <= set(ours)
    with h5file.File(out) as f:
        assert _summary(f) == ours
    try:
        import h5py
    except ImportError:  # the card's machine has no h5py: the program's reader alone
        return
    with h5py.File(out, "r") as f:
        assert _summary(f) == ours


def test_the_reader_refuses_a_filter_no_cell_writes(tmp_path):
    out = _cli_output(tmp_path, ["-c", "4"])
    with h5read.File(out) as f:
        with pytest.raises(h5read.FormatError, match="filter"):
            f["p"]


def test_the_reader_refuses_to_write(tmp_path):
    with pytest.raises(ValueError):
        h5read.File(tmp_path / "new.h5", "w")
