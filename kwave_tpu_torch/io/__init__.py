"""HDF5 I/O of the port: jax-free copies of `kwave_tpu.io`'s input, output and checkpoint
file contract (same dataset names, dtypes, chunking, ``c_*`` attributes and file header).

``h5py`` is imported only where a file on disk is opened, so every reader and writer also
works on an open group-like object (the subset of the h5py group API they use)."""

from kwave_tpu_torch.io import names
from kwave_tpu_torch.io.checkpoint import read_checkpoint, write_checkpoint
from kwave_tpu_torch.io.hdf5 import (
    create_dataset,
    read_scalar,
    write_file_header,
    write_scalar,
)
from kwave_tpu_torch.io.input_file import InputData, read_input_file, write_input_file
from kwave_tpu_torch.io.output_file import (
    CompressionAttrs,
    create_compressed_dataset,
    create_cuboid_group,
    create_output_file,
    create_raw_dataset,
    write_aggregate,
    write_frame,
    write_frames,
)

__all__ = [
    "names",
    "create_dataset",
    "read_scalar",
    "write_scalar",
    "write_file_header",
    "InputData",
    "read_input_file",
    "write_input_file",
    "CompressionAttrs",
    "create_output_file",
    "create_raw_dataset",
    "create_compressed_dataset",
    "create_cuboid_group",
    "write_frame",
    "write_frames",
    "write_aggregate",
    "read_checkpoint",
    "write_checkpoint",
]
