"""k-Wave input-file reader/writer (port of `kwave_tpu.io.input_file`; format: the
reference's main.cpp:350-640 doc table; reader semantics:
Parameters::readScalarsFromInputFile, Parameters/Parameters.cpp:194-380 and
MatrixContainer::init dataset wiring, Containers/MatrixContainer.cpp:73-416).

The writer exists so the framework is self-contained (the reference relies on the MATLAB
toolbox to produce inputs); it emits version-1.1 files the reference binary would accept.

Dataset value conventions mirrored here:
- all HDF5 dims C-order (nz, ny, nx); scalars (1,1,1)
- masks / source indices are MATLAB 1-based in the file, rebased to 0-based on load
  (IndexMatrix::recomputeIndicesToCPP, MatrixClasses/IndexMatrix.h:115-117)
- sensor_mask_corners is [N, 6] u64 ((1-based) x1,y1,z1,x2,y2,z2 per cuboid,
  IndexMatrix::getTopLeftCorner/getBottomRightCorner, IndexMatrix.h:106-112)
- u/p source input: (1, T, n) when `many`, (1, 1, T) when single-series
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from kwave_tpu_torch.io import names
from kwave_tpu_torch.io.h5file import File
from kwave_tpu_torch.io.hdf5 import (
    create_dataset,
    read_scalar,
    tag_dataset,
    validate_file_header,
    write_file_header,
    write_scalar,
)
from kwave_tpu_torch.solver.operators import Grid, Medium
from kwave_tpu_torch.utils.observability import span


@dataclasses.dataclass
class InputData:
    """Everything a simulation needs, in solver-native (0-based, [nz,ny,nx]) conventions."""

    grid: Grid
    medium: Medium
    pml_size: tuple[int, int, int]
    pml_alpha: tuple[float, float, float]
    nonlinear: bool = False
    absorbing: bool = False
    nonuniform: bool = False
    # sensors
    sensor_mask_index: Optional[np.ndarray] = None  # 0-based flat indices
    sensor_mask_corners: Optional[np.ndarray] = None  # [N, 6] 0-based inclusive
    # sources (0-based indices; signals [T] or [n, T])
    p0: Optional[np.ndarray] = None
    p_source_index: Optional[np.ndarray] = None
    p_source_input: Optional[np.ndarray] = None
    p_source_flag: int = 0
    p_source_mode: int = 0
    p_source_many: bool = False
    u_source_index: Optional[np.ndarray] = None
    ux_source_input: Optional[np.ndarray] = None
    uy_source_input: Optional[np.ndarray] = None
    uz_source_input: Optional[np.ndarray] = None
    ux_source_flag: int = 0
    uy_source_flag: int = 0
    uz_source_flag: int = 0
    u_source_mode: int = 0
    u_source_many: bool = False
    transducer_source_input: Optional[np.ndarray] = None
    transducer_source_flag: int = 0
    delay_mask: Optional[np.ndarray] = None
    # non-uniform grid stretch maps: dict with keys dxudxn/dyudyn/dzudzn and the
    # *_sgx/_sgy/_sgz staggered variants (per-axis vectors)
    nonuniform_maps: Optional[dict] = None
    # auto-detected compression period cached as a `period` attribute on
    # p_source_input (Parameters.cpp:508-511 writes it so later legs skip the
    # detection pass); populated by read_input_file when present
    cached_period: Optional[float] = None
    # the file this InputData was read from (write-back target for the cache)
    source_path: Optional[str] = None

    def u_source_flag_any(self) -> bool:
        return bool(self.ux_source_flag or self.uy_source_flag or self.uz_source_flag)


def _field_shape_3(grid: Grid) -> tuple[int, int, int]:
    return (grid.nz, grid.ny, grid.nx)


def _write_medium_entry(f, name, value, grid):
    """Scalar -> (1,1,1); heterogeneous -> full (nz,ny,nx)."""
    arr = np.asarray(value, np.float32)
    if arr.ndim == 0:
        write_scalar(f, name, float(arr), np.float32)
    else:
        ds = create_dataset(f, name, _field_shape_3(grid))
        ds[...] = arr.reshape(_field_shape_3(grid))


def _signal_to_file(sig: np.ndarray, many: bool) -> np.ndarray:
    """[T] -> (1,1,T); [n,T] -> (1,T,n) (the reference reads (nx=n, ny=T) 2D datasets)."""
    sig = np.asarray(sig, np.float32)
    if many:
        return sig.T[None, :, :]
    return sig[None, None, :]


def write_input_file(path: str, data: InputData) -> None:
    grid, medium = data.grid, data.medium
    with File(path, "w") as f:
        write_file_header(f, names.FILE_TYPE_INPUT)
        # grid scalars
        write_scalar(f, names.NX, grid.nx)
        write_scalar(f, names.NY, grid.ny)
        write_scalar(f, names.NZ, grid.nz)
        write_scalar(f, names.NT, grid.nt)
        write_scalar(f, names.DT, float(grid.dt), np.float32)
        write_scalar(f, names.DX, float(grid.dx), np.float32)
        write_scalar(f, names.DY, float(grid.dy), np.float32)
        if grid.dim == 3:
            write_scalar(f, names.DZ, float(grid.dz), np.float32)
        c0 = np.asarray(medium.c0, np.float64)
        c_ref = float(medium.c_ref) if medium.c_ref is not None else float(c0.max())
        write_scalar(f, names.C_REF, c_ref, np.float32)
        # pml
        write_scalar(f, names.PML_X_SIZE, int(data.pml_size[0]))
        write_scalar(f, names.PML_Y_SIZE, int(data.pml_size[1]))
        if grid.dim == 3:
            write_scalar(f, names.PML_Z_SIZE, int(data.pml_size[2]))
        write_scalar(f, names.PML_X_ALPHA, float(data.pml_alpha[0]), np.float32)
        write_scalar(f, names.PML_Y_ALPHA, float(data.pml_alpha[1]), np.float32)
        if grid.dim == 3:
            write_scalar(f, names.PML_Z_ALPHA, float(data.pml_alpha[2]), np.float32)
        # flags
        write_scalar(f, names.NONUNIFORM_GRID_FLAG, int(data.nonuniform))
        write_scalar(f, names.ABSORBING_FLAG, int(data.absorbing))
        write_scalar(f, names.NONLINEAR_FLAG, int(data.nonlinear))
        write_scalar(f, names.P0_SOURCE_FLAG, int(data.p0 is not None))
        write_scalar(f, names.P_SOURCE_FLAG, int(data.p_source_flag))
        write_scalar(f, names.UX_SOURCE_FLAG, int(data.ux_source_flag))
        write_scalar(f, names.UY_SOURCE_FLAG, int(data.uy_source_flag))
        if grid.dim == 3:
            write_scalar(f, names.UZ_SOURCE_FLAG, int(data.uz_source_flag))
        write_scalar(f, names.TRANSDUCER_SOURCE_FLAG, int(data.transducer_source_flag))
        if data.p_source_flag or data.u_source_flag_any():
            write_scalar(f, names.P_SOURCE_MODE, int(data.p_source_mode))
            write_scalar(f, names.P_SOURCE_MANY, int(data.p_source_many))
            write_scalar(f, names.U_SOURCE_MODE, int(data.u_source_mode))
            write_scalar(f, names.U_SOURCE_MANY, int(data.u_source_many))
        # medium
        _write_medium_entry(f, names.RHO0, medium.rho0, grid)
        _write_medium_entry(f, names.C0, medium.c0, grid)
        rho0 = np.asarray(medium.rho0)
        if rho0.ndim > 0:
            for nm, v in ((names.RHO0_SGX, medium.rho0_sgx),
                          (names.RHO0_SGY, medium.rho0_sgy),
                          (names.RHO0_SGZ, medium.rho0_sgz)):
                if v is not None:
                    _write_medium_entry(f, nm, v, grid)
        if data.nonlinear and medium.bona is not None:
            _write_medium_entry(f, names.BONA, medium.bona, grid)
        if data.absorbing:
            write_scalar(f, names.ALPHA_POWER, float(medium.alpha_power), np.float32)
            _write_medium_entry(f, names.ALPHA_COEFF, medium.alpha_coeff, grid)
        # non-uniform grid stretch vectors (dims: x -> (1,1,nx), y -> (1,ny,1), z -> (nz,1,1))
        if data.nonuniform and data.nonuniform_maps:
            dims3 = {
                names.DXUDXN: (1, 1, grid.nx), names.DXUDXN_SGX: (1, 1, grid.nx),
                names.DYUDYN: (1, grid.ny, 1), names.DYUDYN_SGY: (1, grid.ny, 1),
                names.DZUDZN: (grid.nz, 1, 1), names.DZUDZN_SGZ: (grid.nz, 1, 1),
            }
            for nm, v in data.nonuniform_maps.items():
                ds = create_dataset(f, nm, dims3[nm])
                ds[...] = np.asarray(v, np.float32).reshape(dims3[nm])
        # sensors (1-based in file)
        if data.sensor_mask_index is not None:
            write_scalar(f, names.SENSOR_MASK_TYPE, 0)
            idx = np.asarray(data.sensor_mask_index, np.uint64) + 1
            ds = f.create_dataset(
                names.SENSOR_MASK_INDEX, data=idx[None, None, :], dtype=np.uint64
            )
            tag_dataset(ds, data=names.DATA_LONG)
        elif data.sensor_mask_corners is not None:
            write_scalar(f, names.SENSOR_MASK_TYPE, 1)
            corners = np.asarray(data.sensor_mask_corners, np.uint64) + 1
            ds = f.create_dataset(
                names.SENSOR_MASK_CORNERS, data=corners[None, :, :], dtype=np.uint64
            )
            tag_dataset(ds, data=names.DATA_LONG)
        # sources
        if data.p0 is not None:
            ds = create_dataset(f, names.P0_SOURCE_INPUT, _field_shape_3(grid))
            ds[...] = np.asarray(data.p0, np.float32).reshape(_field_shape_3(grid))
        if data.p_source_flag:
            _write_index(f, names.P_SOURCE_INDEX, data.p_source_index)
            f.create_dataset(
                names.P_SOURCE_INPUT,
                data=_signal_to_file(data.p_source_input, data.p_source_many),
            )
        if data.u_source_flag_any():
            _write_index(f, names.U_SOURCE_INDEX, data.u_source_index)
            for nm, sig in ((names.UX_SOURCE_INPUT, data.ux_source_input),
                            (names.UY_SOURCE_INPUT, data.uy_source_input),
                            (names.UZ_SOURCE_INPUT, data.uz_source_input)):
                if sig is not None:
                    f.create_dataset(nm, data=_signal_to_file(sig, data.u_source_many))
        if data.transducer_source_flag:
            _write_index(f, names.U_SOURCE_INDEX, data.u_source_index, skip_if_present=True)
            f.create_dataset(
                names.TRANSDUCER_SOURCE_INPUT,
                data=np.asarray(data.transducer_source_input, np.float32)[None, None, :],
            )
            _write_index(f, names.DELAY_MASK, data.delay_mask)


def _write_index(f, name, idx, skip_if_present=False):
    if skip_if_present and name in f:
        return
    arr = np.asarray(idx, np.uint64) + 1  # 0-based -> MATLAB 1-based
    ds = f.create_dataset(name, data=arr[None, None, :], dtype=np.uint64)
    tag_dataset(ds, data=names.DATA_LONG)


def _read_medium_entry(f, name):
    if name not in f:
        return None
    arr = np.asarray(f[name], np.float32)
    if arr.size == 1:
        return float(arr.reshape(-1)[0])
    return np.squeeze(arr) if arr.shape[0] == 1 and arr.ndim == 3 and arr.shape[1] == 1 \
        else arr


def _signal_from_file(arr: np.ndarray, many: bool) -> np.ndarray:
    arr = np.asarray(arr, np.float32)
    if many:
        return arr[0].T  # (1, T, n) -> [n, T]
    return arr.reshape(-1)  # (1,1,T) -> [T]


def read_input_file(path: str) -> InputData:
    """Load an input file into solver-native conventions (the
    `loadInputData`, KSpaceFirstOrderSolver.cpp:159-257)."""
    with span("kwave.input.read"), File(path, "r") as f:
        validate_file_header(f, names.FILE_TYPE_INPUT, path)
        nx, ny, nz = (read_scalar(f, n) for n in (names.NX, names.NY, names.NZ))
        is3d = nz > 1
        grid = Grid(
            nx=nx, ny=ny, nz=nz,
            dx=read_scalar(f, names.DX),
            dy=read_scalar(f, names.DY),
            dz=read_scalar(f, names.DZ) if is3d and names.DZ in f else 0.0,
            dt=read_scalar(f, names.DT),
            nt=read_scalar(f, names.NT),
        )
        shape = grid.shape

        def grid_or_scalar(name):
            v = _read_medium_entry(f, name)
            if isinstance(v, np.ndarray):
                return v.reshape(shape)
            return v

        absorbing = bool(read_scalar(f, names.ABSORBING_FLAG))
        nonlinear = bool(read_scalar(f, names.NONLINEAR_FLAG))
        medium = Medium(
            c0=grid_or_scalar(names.C0),
            rho0=grid_or_scalar(names.RHO0),
            rho0_sgx=grid_or_scalar(names.RHO0_SGX),
            rho0_sgy=grid_or_scalar(names.RHO0_SGY),
            rho0_sgz=grid_or_scalar(names.RHO0_SGZ),
            bona=grid_or_scalar(names.BONA) if nonlinear else None,
            alpha_coeff=grid_or_scalar(names.ALPHA_COEFF) if absorbing else None,
            alpha_power=read_scalar(f, names.ALPHA_POWER) if absorbing else 1.5,
            c_ref=read_scalar(f, names.C_REF),
        )
        pml_size = (
            read_scalar(f, names.PML_X_SIZE),
            read_scalar(f, names.PML_Y_SIZE),
            read_scalar(f, names.PML_Z_SIZE) if is3d else 0,
        )
        pml_alpha = (
            read_scalar(f, names.PML_X_ALPHA),
            read_scalar(f, names.PML_Y_ALPHA),
            read_scalar(f, names.PML_Z_ALPHA) if is3d else 0.0,
        )

        mask_type = read_scalar(f, names.SENSOR_MASK_TYPE) \
            if names.SENSOR_MASK_TYPE in f else 0
        mask_index = mask_corners = None
        if mask_type == 0 and names.SENSOR_MASK_INDEX in f:
            mask_index = np.asarray(f[names.SENSOR_MASK_INDEX], np.int64).reshape(-1) - 1
        elif names.SENSOR_MASK_CORNERS in f:
            mask_corners = (
                np.asarray(f[names.SENSOR_MASK_CORNERS], np.int64).reshape(-1, 6) - 1
            )

        p_source_flag = read_scalar(f, names.P_SOURCE_FLAG)
        ux_flag = read_scalar(f, names.UX_SOURCE_FLAG)
        uy_flag = read_scalar(f, names.UY_SOURCE_FLAG)
        uz_flag = read_scalar(f, names.UZ_SOURCE_FLAG) if is3d and names.UZ_SOURCE_FLAG in f else 0
        tr_flag = read_scalar(f, names.TRANSDUCER_SOURCE_FLAG)
        p_many = bool(read_scalar(f, names.P_SOURCE_MANY)) if names.P_SOURCE_MANY in f else False
        u_many = bool(read_scalar(f, names.U_SOURCE_MANY)) if names.U_SOURCE_MANY in f else False

        def read_idx(name):
            return (np.asarray(f[name], np.int64).reshape(-1) - 1) if name in f else None

        nonuniform = bool(read_scalar(f, names.NONUNIFORM_GRID_FLAG))
        nonuniform_maps = None
        if nonuniform:
            nonuniform_maps = {}
            for nm in (names.DXUDXN, names.DYUDYN, names.DZUDZN,
                       names.DXUDXN_SGX, names.DYUDYN_SGY, names.DZUDZN_SGZ):
                if nm in f:
                    nonuniform_maps[nm] = np.asarray(f[nm], np.float32).reshape(-1)

        p0_flag = bool(read_scalar(f, names.P0_SOURCE_FLAG))
        p0 = None
        if p0_flag and names.P0_SOURCE_INPUT in f:
            p0 = np.asarray(f[names.P0_SOURCE_INPUT], np.float32).reshape(shape)

        return InputData(
            grid=grid,
            medium=medium,
            pml_size=pml_size,
            pml_alpha=pml_alpha,
            nonlinear=nonlinear,
            absorbing=absorbing,
            nonuniform=nonuniform,
            nonuniform_maps=nonuniform_maps,
            sensor_mask_index=mask_index,
            sensor_mask_corners=mask_corners,
            p0=p0,
            p_source_index=read_idx(names.P_SOURCE_INDEX),
            p_source_input=_signal_from_file(f[names.P_SOURCE_INPUT], p_many)
            if names.P_SOURCE_INPUT in f else None,
            cached_period=(
                float(f[names.P_SOURCE_INPUT].attrs["period"])
                if names.P_SOURCE_INPUT in f
                and "period" in f[names.P_SOURCE_INPUT].attrs else None
            ),
            source_path=path,
            p_source_flag=p_source_flag,
            p_source_mode=read_scalar(f, names.P_SOURCE_MODE)
            if names.P_SOURCE_MODE in f else 0,
            p_source_many=p_many,
            u_source_index=read_idx(names.U_SOURCE_INDEX),
            ux_source_input=_signal_from_file(f[names.UX_SOURCE_INPUT], u_many)
            if names.UX_SOURCE_INPUT in f else None,
            uy_source_input=_signal_from_file(f[names.UY_SOURCE_INPUT], u_many)
            if names.UY_SOURCE_INPUT in f else None,
            uz_source_input=_signal_from_file(f[names.UZ_SOURCE_INPUT], u_many)
            if names.UZ_SOURCE_INPUT in f else None,
            ux_source_flag=ux_flag,
            uy_source_flag=uy_flag,
            uz_source_flag=uz_flag,
            u_source_mode=read_scalar(f, names.U_SOURCE_MODE)
            if names.U_SOURCE_MODE in f else 0,
            u_source_many=u_many,
            transducer_source_input=np.asarray(
                f[names.TRANSDUCER_SOURCE_INPUT], np.float32
            ).reshape(-1) if names.TRANSDUCER_SOURCE_INPUT in f else None,
            transducer_source_flag=tr_flag,
            delay_mask=read_idx(names.DELAY_MASK),
        )
