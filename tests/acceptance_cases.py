"""The inputs of the acceptance sweep and the checks that hold two runs' outputs to each
other.

tests/test_torch_acceptance_*.py run `kwave_tpu.cli` and `kwave_tpu_torch.cli` on every
case here, on an input file that `kwave_tpu.io.input_file.write_input_file` writes, and
`chip_smoke.py` phase 10 runs the port on the card and on the CPU on the same inputs,
held in memory. So this module imports neither jax, nor h5py, nor `kwave_tpu`.

A case's input comes from the JAX suite: where the suite has an importable input maker
(``_input`` of tests/test_driver.py and the like) the case names it in ``base`` and the
tests write what that function returns; the copy of it here (`INPUT_MAKERS`) is what the
card runs, and `tests/test_torch_acceptance_driver.py` holds every copy to its original
field by field. Inputs that the suite builds inside a test function are built
here (``inline``), with the test they come from named beside them.

Checks (`compare_outputs`): the same datasets and groups by name, shape, dtype, chunks,
compression and attributes, and the same root attributes by name (the device memory
that a run on the card adds aside) and, where they describe the file rather than the
run, by value; float data within
rel L2 1e-4; 40-bit ``_c`` rows compared as the coefficients that `oracle.decode40`
reads from their bytes, never as float views (their bytes read as NaN), to rel L2 1e-4
or each within 2o steps of the word's absolute quantum (`compare_outputs`); integer
data equal. `p_c_fed_the_series` encodes a run's stored ``p`` series with the port, to hold
the bytes of a ``p_c`` to it. `standing_wave_error` and `reciprocity_error` run the JAX
suite's two physics checks through the port's `simulate` on a given device
(tests/test_torch_physics.py on the CPU, phase 10 on the card).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import numpy as np

REL_L2 = 1e-4  # float data of two runs: two FFT libraries or two devices (fp32)

# root attributes whose values are the run's own (clocks, memory, host, producer)
_VOLATILE_ROOT = ("time", "date", "memory", "size", "host", "created_by", "description",
                  "cpu_cores")


# ---------------------------------------------------------------------------
# Builders: copies of the JAX suite's, returning InputData's fields with the grid and
# medium as dicts (numpy only)
# ---------------------------------------------------------------------------


def _grid(n=16, nt=60, **kw) -> dict:
    return dict(dict(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=nt), **kw)


def _shape(grid: dict) -> tuple:
    return (grid["ny"], grid["nx"]) if grid["nz"] == 1 else \
        (grid["nz"], grid["ny"], grid["nx"])


def _centre_p0(grid: dict, value=1e5) -> np.ndarray:
    shape = _shape(grid)
    p0 = np.zeros(shape, np.float32)
    p0[tuple(s // 2 for s in shape)] = value
    return p0


def _water(grid: dict, n_sensors: int, seed: int, pml=4) -> dict:
    """Homogeneous water, p0 = 1e5 at the centre, sorted random index sensors."""
    n_el = grid["nx"] * grid["ny"] * grid["nz"]
    mask = np.sort(np.random.default_rng(seed).choice(n_el, n_sensors, replace=False))
    dims = 2 if grid["nz"] == 1 else 3
    return dict(grid=grid, medium=dict(c0=1500.0, rho0=1000.0), pml_size=(pml,) * dims,
                pml_alpha=(2.0,) * dims, sensor_mask_index=mask.astype(np.int64),
                p0=_centre_p0(grid))


def driver_input(nt=60, n=16) -> dict:
    """tests/test_driver.py::_input"""
    return _water(_grid(n, nt), 64, 3)


def edge_input(nt=60, n=16) -> dict:
    """tests/test_edge_cases.py::_input"""
    return _water(_grid(n, nt), 48, 3)


def legs_input(nt=60, n=16) -> dict:
    """tests/test_checkpoint_legs.py::_input"""
    return _water(_grid(n, nt), 40, 9)


def post_input(nt=60, n=16) -> dict:
    """tests/test_postproc.py::_sim_input"""
    return _water(_grid(n, nt), 48, 5)


def io_toy_input(het=False, with_sources=True) -> dict:
    """tests/test_io.py::_toy_input (which also writes its file; the tests take its
    InputData): a 16 x 12 x 8 absorbing medium, p0 of unit noise, a mode-1 p source."""
    grid = _grid(nt=64, nx=16, ny=12, nz=8)
    shape = _shape(grid)
    rng = np.random.default_rng(1)
    if het:
        medium = dict(c0=(1500 + 10 * rng.random(shape)).astype(np.float32),
                      rho0=(1000 + 5 * rng.random(shape)).astype(np.float32),
                      alpha_coeff=0.5, alpha_power=1.5)
    else:
        medium = dict(c0=1500.0, rho0=1000.0, alpha_coeff=0.5, alpha_power=1.5)
    p0 = rng.standard_normal(shape).astype(np.float32)
    mask = rng.choice(16 * 12 * 8, 20, replace=False).astype(np.int64)
    data = dict(grid=grid, medium=medium, pml_size=(4, 4, 4), pml_alpha=(2.0, 2.0, 2.0),
                absorbing=True, sensor_mask_index=np.sort(mask), p0=p0)
    if with_sources:
        data.update(p_source_flag=30, p_source_index=np.array([5, 17, 200], np.int64),
                    p_source_input=rng.standard_normal(30).astype(np.float32),
                    p_source_mode=1)
    return data


INPUT_MAKERS = {
    ("test_driver", "_input"): driver_input,
    ("test_edge_cases", "_input"): edge_input,
    ("test_checkpoint_legs", "_input"): legs_input,
    ("test_postproc", "_sim_input"): post_input,
    ("test_io", "_toy_input"): io_toy_input,
}


# -- inputs the suite builds inside its tests ---------------------------------------------


def _corners(base: dict, corners) -> dict:
    return dict(base, sensor_mask_index=None, sensor_mask_corners=np.array(corners))


def cuboid_pair_input(corners, nt=60) -> dict:
    """tests/test_postproc.py's cuboid tests and test_driver.py's cuboid == index mask:
    16^3 water, p0 at (8, 8, 8), the given cuboids."""
    return _corners(_water(_grid(16, nt), 1, 0), corners)


def driver_2d_input() -> dict:
    """tests/test_driver.py::test_driver_2d_end_to_end"""
    return _water(_grid(24, 40, nz=1), 30, 2)


def detected_period_input() -> dict:
    """tests/test_driver.py::test_detected_period_cached_in_input_file: a 200-sample
    sine of period 10 through four p source points, 19 sensors, no p0."""
    sig = (1e5 * np.sin(2 * np.pi * np.arange(200, dtype=np.float32) / 10.0))
    return dict(grid=_grid(12, 30), medium=dict(c0=1500.0, rho0=1000.0),
                pml_size=(2, 2, 2), pml_alpha=(2.0,) * 3,
                sensor_mask_index=np.arange(1, 20, dtype=np.int64),
                p_source_index=np.arange(1, 5, dtype=np.int64),
                p_source_input=sig.astype(np.float32), p_source_flag=200)


def cli_input(nt, n_sensors, seed) -> dict:
    """tests/test_cli.py: 16^3 water, p0 at (8, 8, 8)."""
    return _water(_grid(16, nt), n_sensors, seed)


def cli_benchmark_input() -> dict:
    """tests/test_cli.py::test_cli_benchmark_truncates: the first ten points as sensors."""
    return dict(_water(_grid(16, 100), 1, 0), sensor_mask_index=np.arange(10, dtype=np.int64))


def io_field_input() -> dict:
    """tests/test_io.py::test_driver_writes_field_shaped_all_and_final"""
    grid = _grid(nt=20, nx=16, ny=12, nz=8)
    data = _water(grid, 16, 0, pml=2)
    p0 = np.zeros(_shape(grid), np.float32)
    p0[4, 6, 8] = 1e5
    return dict(data, p0=p0)


def source_2d_input(**sources) -> dict:
    """tests/test_solver.py's source cases: the 16 x 16 mini grid (CFL 0.2, 20 steps),
    PML 4, water, 24 sensors, no p0."""
    grid = _grid(16, 20, nz=1, dt=0.2 * 1e-4 / 1500.0)
    return dict(_water(grid, 24, 6), p0=None, **sources)


def p_source_2d(mode: int, many: bool) -> dict:
    """A sine p source at the centre (one series, 1e5 as the suite's), or three points
    with a series each (amplitudes 1e5, 5e4, 2.5e4)."""
    t = np.arange(20)
    sig = (1e5 * np.sin(2 * np.pi * t / 10)).astype(np.float32)
    idx = np.array([16 * 8 + 8], np.int64)
    if many:
        idx = np.array([16 * 8 + 8, 16 * 4 + 5, 16 * 11 + 9], np.int64)
        sig = np.stack([sig, 0.5 * np.roll(sig, 3), 0.25 * np.roll(sig, 5)])
    return source_2d_input(p_source_flag=20, p_source_mode=mode, p_source_many=many,
                           p_source_index=idx, p_source_input=sig)


def u_source_2d() -> dict:
    """tests/test_solver.py::test_velocity_source_and_transducer, the u source: ux on two
    points, mode 1."""
    sig = (0.01 * np.sin(2 * np.pi * np.arange(20) / 8)).astype(np.float32)
    return source_2d_input(u_source_index=np.array([16 * 4 + 4, 16 * 4 + 5], np.int64),
                           ux_source_input=sig, ux_source_flag=20, u_source_mode=1)


def transducer_2d() -> dict:
    """The same test's transducer: two elements, delays 0 and 3."""
    sig = (0.01 * np.sin(2 * np.pi * np.arange(20) / 8)).astype(np.float32)
    return source_2d_input(u_source_index=np.array([16 * 4 + 4, 16 * 4 + 5], np.int64),
                           transducer_source_input=np.concatenate(
                               [sig, np.zeros(8, np.float32)]),
                           transducer_source_flag=20, delay_mask=np.array([0, 3], np.int64))


def u_source_many_3d() -> dict:
    """A many-series u source in mode 2 (ux, uy, uz on three points), 16^3, 40 steps."""
    grid = _grid(16, 40)
    t = np.arange(40)
    sig = (0.01 * np.sin(2 * np.pi * t / 8)).astype(np.float32)
    idx = np.array([(8 * 16 + 8) * 16 + 8, (5 * 16 + 9) * 16 + 7, (10 * 16 + 6) * 16 + 9],
                   np.int64)
    many = np.stack([sig, 0.5 * np.roll(sig, 2), -0.7 * sig])
    return dict(_water(grid, 48, 7), p0=None, u_source_index=idx, u_source_mode=2,
                u_source_many=True, ux_source_input=many, uy_source_input=0.5 * many,
                uz_source_input=-many, ux_source_flag=40, uy_source_flag=40,
                uz_source_flag=40)


def branches_input(dim: int) -> dict:
    """tests/test_solver.py::test_branches_finite, nonlinear and absorbing: a random
    heterogeneous medium (seed 0), B/A 6, 0.75 dB/(MHz^1.5 cm), PML 4, p0 1e5."""
    grid = _grid(16, 30, nz=1 if dim == 2 else 16, dt=0.2 * 1e-4 / 1500.0)
    shape = _shape(grid)
    rng = np.random.default_rng(0)
    medium = dict(c0=(1500.0 + 50.0 * rng.random(shape)).astype(np.float32),
                  rho0=(1000.0 + 30.0 * rng.random(shape)).astype(np.float32),
                  bona=6.0, alpha_coeff=0.75, alpha_power=1.5)
    return dict(_water(grid, 40, 8), medium=medium, nonlinear=True, absorbing=True)


def nonuniform_input() -> dict:
    """tests/test_solver.py::test_nonuniform_grid_reduces_to_uniform, the stretched maps:
    x stretched by 1 + 0.1 sin(i), y and z identity, 16^3, 20 steps."""
    grid = _grid(16, 20, dt=0.2 * 1e-4 / 1500.0)
    maps = {k: np.ones(16, np.float32) for k in (
        "dxudxn", "dyudyn", "dzudzn", "dxudxn_sgx", "dyudyn_sgy", "dzudzn_sgz")}
    maps["dxudxn"] = (1.0 + 0.1 * np.sin(np.arange(16))).astype(np.float32)
    maps["dxudxn_sgx"] = maps["dxudxn"]
    return dict(_water(grid, 40, 10), nonuniform=True, nonuniform_maps=maps)


def odd_even_input(nz=13, ny=16, nx=15, nt=30) -> dict:
    """Odd and even axes (13 x 16 x 15), water, p0 1e5 at the centre: the shifted
    velocity's Nyquist bin exists on y only."""
    return _water(_grid(nt=nt, nx=nx, ny=ny, nz=nz), 40, 11)


def fused_dense_input() -> dict:
    """nz = 100 (no power of two: the dense z-stage kernel), 16 x 16 in y, x; 24 steps."""
    return _water(_grid(nt=24, nx=16, ny=16, nz=100), 48, 12)


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Case:
    """One input and the runs made of it.

    ``base`` = (module of tests/, function, keyword arguments) when a function of the JAX
    suite makes the input, then ``edits`` replace fields of what it returns; else ``inline``
    makes the fields. ``flags`` go to both CLIs after ``-i``/``-o``. ``legs``: the run is
    made in legs of that many steps (``--checkpoint_timesteps``), each a fresh CLI call.
    ``post``: flags of a second call with ``--post``. ``fuse_z``: the card's run takes the
    fused z stage (compact operators), which no CLI flag selects; such a case runs on
    the card only."""

    name: str
    group: str  # which test file sweeps it: driver, edges, io_post, sources
    flags: tuple[str, ...]
    base: Optional[tuple] = None
    edits: Optional[Callable[[], dict]] = None
    inline: Optional[Callable[[], dict]] = None
    legs: int = 0
    post: tuple[str, ...] = ()
    fuse_z: bool = False

    def fields(self) -> dict:
        """The input's fields (numpy), from the copy of the input maker or ``inline``."""
        if self.inline is not None:
            return self.inline()
        module, fn, kwargs = self.base
        data = INPUT_MAKERS[(module, fn)](**kwargs)
        return dict(data, **(self.edits() if self.edits else {}))

    @property
    def sampled_steps(self) -> int:
        f = self.fields()
        nt = f["grid"]["nt"]
        if "--benchmark" in self.flags:
            nt = min(nt, int(self.flags[self.flags.index("--benchmark") + 1]))
        return nt - (int(self.flags[self.flags.index("-s") + 1]) - 1
                     if "-s" in self.flags else 0)


def _flags(*words) -> tuple[str, ...]:
    return tuple(" ".join(words).split())


H2 = "--period 10 --harmonics 2"
H1 = "--period 10 --harmonics 1"
STREAMS = "--p_raw --p_c --p_rms --p_max --p_min --p_max_all --p_final --u_raw"
CUBOIDS_2 = [[2, 3, 4, 5, 6, 7], [9, 9, 9, 12, 10, 9]]

CASES = [
    # tests/test_driver.py
    Case("driver_streams", "driver", _flags(STREAMS, H2), ("test_driver", "_input", {})),
    Case("driver_40bit_tail", "driver", _flags("--p_raw --p_c --40-bit_complex", H1),
         ("test_driver", "_input", {"nt": 47})),
    Case("driver_cuboids_sampling_start", "driver",
         _flags("--p_raw --p_c --p_rms -s 11", H1), ("test_driver", "_input", {"nt": 40}),
         edits=lambda: dict(sensor_mask_index=None, sensor_mask_corners=np.array(
             [[2, 2, 2, 5, 4, 3], [8, 8, 8, 9, 9, 9]]))),
    Case("driver_2d", "driver", _flags("--p_raw --p_c --u_raw --p_max", H2),
         inline=driver_2d_input),
    Case("driver_lead_in_peel", "driver", _flags("--p_raw -s 11"),
         ("test_driver", "_input", {"nt": 40})),
    Case("driver_tail_peel_tiny", "driver", _flags("--p_raw --p_c", H1),
         ("test_driver", "_input", {"nt": 7})),
    Case("driver_detected_period", "driver", _flags("--p_raw --p_c --harmonics 1"),
         inline=detected_period_input),
    Case("driver_cuboid_as_index_points", "driver", _flags("--p_raw --p_rms --p_c", H2),
         inline=lambda: cuboid_pair_input([[2, 3, 4, 6, 7, 8]], nt=30)),
    # tests/test_cli.py
    Case("cli_end_to_end", "driver", _flags("--p_raw --p_c --p_max", H2),
         inline=lambda: cli_input(40, 32, 0)),
    Case("cli_benchmark", "driver", _flags("-p --benchmark 20"), inline=cli_benchmark_input),
    Case("cli_copy_mask_and_post", "driver",
         _flags("--p_raw --u_non_staggered_raw --copy_sensor_mask"),
         inline=lambda: cli_input(40, 24, 1), post=_flags("--I_avg --Q_term")),
    # tests/test_edge_cases.py
    Case("edge_no_overlap_float", "edges", _flags("--p_raw --p_c --no_overlap", H2),
         ("test_edge_cases", "_input", {})),
    Case("edge_no_overlap_40bit", "edges",
         _flags("--p_raw --p_c --no_overlap --40-bit_complex", H2),
         ("test_edge_cases", "_input", {})),
    Case("edge_degenerate_overlap", "edges", _flags("--p_raw --p_c", H1),
         ("test_edge_cases", "_input", {"nt": 8})),
    Case("edge_tiny_record_overlap", "edges",
         _flags("--p_raw --p_c --period 5 --mos 2 --harmonics 1"),
         ("test_edge_cases", "_input", {"nt": 9})),
    Case("edge_one_window_float", "edges", _flags("--p_raw --p_c --mos 2", H1),
         ("test_edge_cases", "_input", {"nt": 20})),
    Case("edge_one_window_40bit", "edges",
         _flags("--p_raw --p_c --mos 2 --40-bit_complex", H1),
         ("test_edge_cases", "_input", {"nt": 20})),
    Case("edge_one_window_no_overlap", "edges", _flags("--p_raw --p_c", H2),
         ("test_edge_cases", "_input", {"nt": 10})),
    Case("edge_one_window_iavg_c_40bit", "edges",
         _flags("--p_c --I_avg_c --mos 2 --40-bit_complex", H1),
         ("test_edge_cases", "_input", {"nt": 20})),
    Case("edge_trailing_aggregates", "edges",
         _flags("--p_raw --p_c --p_rms --p_max --p_min", H1),
         ("test_edge_cases", "_input", {"nt": 47})),
    # tests/test_checkpoint_legs.py
    Case("legs_float", "edges", _flags("--p_raw --p_c --p_rms --p_max", H2),
         ("test_checkpoint_legs", "_input", {}), legs=20),
    Case("legs_40bit", "edges", _flags("--p_raw --p_c --40-bit_complex --period 10"),
         ("test_checkpoint_legs", "_input", {"nt": 40}), legs=10),
    # tests/test_io.py
    Case("io_toy_homogeneous", "io_post",
         _flags("--p_raw --p_c --u_non_staggered_raw --p_final --period 8"),
         ("test_io", "_toy_input", {"het": False})),
    Case("io_toy_heterogeneous", "io_post",
         _flags("--p_raw --p_c --40-bit_complex --u_raw --period 8"),
         ("test_io", "_toy_input", {"het": True})),
    Case("io_field_shaped", "io_post",
         _flags("--p_max_all --p_min_all --p_final --u_final"), inline=io_field_input),
    Case("io_gzip", "io_post", _flags("--p_raw --p_c -c 6", H2),
         inline=lambda: cli_input(40, 40, 3)),
    # tests/test_postproc.py
    Case("post_intensity_q_term", "io_post", _flags("--I_avg --Q_term --I_avg_c", H2),
         ("test_postproc", "_sim_input", {})),
    Case("post_iavg_c_40bit", "io_post",
         _flags("--p_c --u_non_staggered_c --I_avg_c --40-bit_complex", H1),
         ("test_postproc", "_sim_input", {})),
    Case("post_block_size", "io_post",
         _flags("--p_c --u_non_staggered_c --I_avg --Q_term --I_avg_c", H2),
         ("test_postproc", "_sim_input", {}),
         post=_flags("--I_avg --Q_term --block_size 500")),
    Case("post_cuboid_40bit", "io_post",
         _flags("--p_c --u_non_staggered_c --40-bit_complex", H2),
         inline=lambda: cuboid_pair_input([[2, 3, 4, 6, 6, 7], [9, 9, 9, 12, 10, 9]]),
         post=_flags("--I_avg_c")),
    Case("post_cuboid_raw_blocked", "io_post", _flags("--p_raw --u_non_staggered_raw"),
         inline=lambda: cuboid_pair_input([[2, 3, 4, 6, 6, 9], [9, 9, 9, 12, 10, 9]]),
         post=_flags("--I_avg --block_size 200")),
    Case("post_cuboid_layout", "io_post", _flags("--I_avg --Q_term --I_avg_c", H2),
         inline=lambda: cuboid_pair_input(CUBOIDS_2)),
    # tests/test_solver.py's source cases, and what the sweep adds
    *[Case(f"source_p_mode{mode}{'_many' if many else ''}", "sources",
           _flags("--p_raw --p_c --u_raw", H2),
           inline=functools.partial(p_source_2d, mode, many))
      for mode in (0, 1, 2) for many in (False, True)],
    Case("source_u_mode1", "sources", _flags("--p_raw --u_raw --p_c", H1),
         inline=u_source_2d),
    Case("source_transducer_delays_benchmark", "sources",
         _flags("--p_raw --u_raw --benchmark 16"), inline=transducer_2d),
    Case("source_u_many_mode2_gzip", "sources", _flags("--p_raw --u_raw --p_c -c 4", H2),
         inline=u_source_many_3d),
    Case("medium_nonlinear_absorbing_2d", "sources",
         _flags("--p_raw --p_c --u_non_staggered_raw --p_rms", H2),
         inline=lambda: branches_input(2)),
    Case("medium_nonlinear_absorbing_3d", "sources",
         _flags("--p_raw --p_c --40-bit_complex --u_non_staggered_raw --p_max", H2),
         inline=lambda: branches_input(3)),
    Case("grid_nonuniform", "sources",
         _flags("--p_raw --u_raw --p_c --no_overlap -s 4 --copy_sensor_mask", H1),
         inline=nonuniform_input),
    Case("grid_odd_even_shifted_velocity", "sources",
         _flags("--p_raw --u_non_staggered_raw --u_non_staggered_c --p_c", H1),
         inline=odd_even_input),
    # the card only: the dense z-stage kernel inside a real run
    Case("fused_dense_nz100", "card", _flags("--p_raw --p_c --40-bit_complex", H1),
         inline=fused_dense_input, fuse_z=True),
]


def case(name: str) -> Case:
    return next(c for c in CASES if c.name == name)


def port_input(c: Case):
    """The case's input as the port's `InputData`."""
    from kwave_tpu_torch.io.input_file import InputData
    from kwave_tpu_torch.solver import Grid, Medium

    f = c.fields()
    return InputData(**dict(f, grid=Grid(**f["grid"]), medium=Medium(**f["medium"])))


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def _is_group(obj) -> bool:
    return hasattr(obj, "keys")


def _items(group):
    return {k: group[k] for k in group.keys()}


def _attr(v):
    return v.decode() if isinstance(v, bytes) else v


def _words_40bit(rows: np.ndarray, harmonics: int):
    """40-bit rows (float32 whose bytes are the 5-byte words; any leading shape, one
    coefficient stream a last-axis row, padded) -> the (header, mR, mI) fields of every
    coefficient, [row, point * harmonics + harmonic]."""
    from kwave_tpu_torch import oracle

    width = rows.shape[-1] // harmonics  # ceil(1.25 n) floats for n points
    n = next(k for k in range(int(width / 1.25) + 2, 0, -1) if math.ceil(1.25 * k) == width)
    raw = np.ascontiguousarray(rows, np.float32).view(np.uint8)
    raw = raw.reshape(-1, raw.shape[-1])[:, : 5 * n * harmonics]
    return tuple(f.reshape(raw.shape[0], n * harmonics)
                 for f in oracle.bytes_to_soa(np.ascontiguousarray(raw).reshape(-1)))


def _decoded_40bit(rows: np.ndarray, harmonics: int, e: int):
    """40-bit rows -> (re, im) of every coefficient (`_words_40bit`'s layout)."""
    from kwave_tpu_torch import oracle

    return oracle.decode40(*_words_40bit(rows, harmonics), e)


def _rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    got, want = got.astype(np.float64), want.astype(np.float64)
    if not (np.isfinite(got).all() and np.isfinite(want).all()):
        return math.inf
    ref = np.linalg.norm(want)
    gap = np.linalg.norm(got - want)
    return gap / ref if ref > 0 else (0.0 if gap == 0 else math.inf)


def quantum_40bit(e: int) -> float:
    """The 40-bit word's absolute step for values below its largest exponent band:
    2^(e - 143), 2^-5 for pressure (e = 138) and 2^-29 for velocity (e = 114)."""
    return 2.0 ** (e - 143)


def worst_40bit(want, got) -> dict:
    """Where two 40-bit datasets of one layout (attributes ``c_harmonics``, ``c_max_exp``)
    differ the most: the coefficient (frame row, sensor, harmonic, part) whose decoded
    values are farthest apart, both values, and that distance in steps of the coarser of
    its two words (a word's step is 2^(eS + e - 143), eS its shared exponent); and over
    every coefficient part, how many differ by what number of steps, and the dataset's rel
    L2 (of re or im, the larger, as `compare_outputs`) with and without the parts that
    are at most one step apart."""
    h, e = int(want.attrs["c_harmonics"]), int(want.attrs["c_max_exp"])
    a, b = (np.asarray(x[...]) for x in (want, got))
    vals, steps = [], []
    for rows in (a, b):
        hdr, mr, mi = _words_40bit(rows, h)
        re, im = _decoded_40bit(rows, h, e)
        vals.append(np.stack([re, im]).astype(np.float64))
        steps.append(np.exp2((hdr & 0xF).astype(np.float64) + e - 143))
    gap = np.abs(vals[1] - vals[0])
    quanta = gap / np.maximum(steps[0], steps[1])[None]
    part, row, k = np.unravel_index(int(np.argmax(gap)), gap.shape)
    within_one = np.where(quanta <= 1.0, vals[0], vals[1])
    counts = {str(q): int((np.ceil(quanta - 1e-9) == q).sum()) for q in (1, 2, 3, 4)}
    counts["more"] = int((quanta > 4 + 1e-9).sum())
    return dict(row=int(row), sensor=int(k // h), harmonic=int(k % h),
                part=("re", "im")[part], want=float(vals[0][part, row, k]),
                got=float(vals[1][part, row, k]), quanta=float(quanta[part, row, k]),
                step=float(max(steps[0][row, k], steps[1][row, k])),
                parts=int(gap.size), differ=counts,
                rel_l2=max(_rel_l2(vals[1][i], vals[0][i]) for i in (0, 1)),
                rel_l2_without_one_step=max(_rel_l2(within_one[i], vals[0][i])
                                            for i in (0, 1)))


def compare_outputs(want, got, rel_l2: float = REL_L2) -> tuple[dict, set]:
    """Hold the output ``got`` to ``want`` (two h5py files, or two in-memory groups):
    the module docstring's checks. Returns each dataset's error (rel L2 of its data or
    of its decoded coefficients; 0 for equal integers), and the 40-bit datasets that
    were held by the quantum floor; raises AssertionError that lists every difference.

    The quantum floor: the exact encoder requantizes its accumulators at every step and
    rounds up, so where two runs' series differ in the last bits, a coefficient near the
    word's absolute step (`quantum_40bit`) can move by up to one step a sampled step, 2o
    steps in a frame. A 40-bit dataset above ``rel_l2`` passes when every coefficient is
    within that many steps of the other's (sensors that see only the solver's ringing)."""
    errs, floored, faults = {}, set(), []

    def attrs_of(obj):
        return {k: _attr(v) for k, v in obj.attrs.items()}

    root_w, root_g = attrs_of(want), attrs_of(got)
    # a run on the card also reports its device memory
    names_w, names_g = ({k for k in r if "device" not in k} for r in (root_w, root_g))
    if names_w != names_g:
        faults.append(f"root attributes differ: {sorted(names_w ^ names_g)}")
    for k, v in root_w.items():
        if not any(w in k for w in _VOLATILE_ROOT) and k in root_g and root_g[k] != v:
            faults.append(f"root attribute {k}: {root_g[k]!r} != {v!r}")

    def walk(w, g, path):
        iw, ig = _items(w), _items(g)
        if iw.keys() != ig.keys():
            faults.append(f"{path or '/'}: members differ {sorted(iw.keys() ^ ig.keys())}")
        for name in sorted(iw.keys() & ig.keys()):
            a, b, where = iw[name], ig[name], f"{path}/{name}".lstrip("/")
            if _is_group(a) or _is_group(b):
                if not (_is_group(a) and _is_group(b)):
                    faults.append(f"{where}: a group in one output only")
                else:
                    walk(a, b, where)
                continue
            aw, ag = attrs_of(a), attrs_of(b)
            if aw.keys() != ag.keys() or any(
                    not np.array_equal(np.asarray(ag[k]), np.asarray(v))
                    or type(ag[k]) is not type(v) for k, v in aw.items()):
                faults.append(f"{where}: attributes {ag} != {aw}")
            layout = [(tuple(x.shape), np.dtype(x.dtype), getattr(x, "chunks", None),
                       getattr(x, "compression", None),
                       getattr(x, "compression_opts", None)) for x in (a, b)]
            if layout[0] != layout[1]:
                faults.append(f"{where}: shape, dtype, chunks, compression {layout[1]} != "
                              f"{layout[0]}")
                continue
            x, y = np.asarray(a[...]), np.asarray(b[...])
            if np.issubdtype(x.dtype, np.integer):
                errs[where] = 0.0 if np.array_equal(x, y) else math.inf
            elif float(aw.get("c_complex_size", 0)) == 1.25:
                h, e = int(aw["c_harmonics"]), int(aw["c_max_exp"])
                pairs = list(zip(_decoded_40bit(x, h, e), _decoded_40bit(y, h, e)))
                errs[where] = max(_rel_l2(q, p) for p, q in pairs)
                steps = 2 * round(float(aw["c_period"]) * int(aw["c_mos"]))
                gap = max(float(np.abs(q.astype(np.float64) - p).max()) for p, q in pairs)
                if errs[where] > rel_l2 and gap <= steps * quantum_40bit(e):
                    floored.add(where)
                    continue
            else:
                errs[where] = _rel_l2(y, x)
            if not errs[where] <= rel_l2:
                faults.append(f"{where}: rel L2 {errs[where]:.3g} > {rel_l2:g}")

    walk(want, got, "")
    if not errs:
        faults.append("no dataset to compare")
    if faults:
        raise AssertionError("; ".join(faults))
    return errs, floored


def p_c_fed_the_series(out, c: Case, device="cpu"):
    """The port's encoding of the ``p`` series stored in ``out`` (an index mask's), with
    the c_* attributes of its ``p_c``, as the bytes of the stored rows; and those rows'
    bytes. None when ``out`` holds no such pair."""
    import torch

    from kwave_tpu_torch import encoder
    from kwave_tpu_torch.basis import generate_basis

    if "p" not in out.keys() or "p_c" not in out.keys() or _is_group(out["p_c"]):
        return None
    series = np.asarray(out["p"][...])[0]
    ds = out["p_c"]
    period, mos, h = (float(ds.attrs["c_period"]), int(ds.attrs["c_mos"]),
                      int(ds.attrs["c_harmonics"]))
    mode40 = float(ds.attrs["c_complex_size"]) == 1.25
    overlap = "--no_overlap" not in c.flags and period < series.shape[0]
    frames, _ = encoder.encode_series_exact(
        torch.from_numpy(series).to(device), generate_basis(period, mos, h, normalize=True),
        mode40=mode40, overlap=overlap, total_steps=series.shape[0])
    if mode40:
        mine = encoder.frames_to_flat_40b(*frames)
    else:
        mine = encoder.frames_to_flat_float(*frames).view(np.uint8)
    stored = np.ascontiguousarray(np.asarray(ds[...])[0]).view(np.uint8)
    return mine, stored[:, : mine.shape[1]], mode40


# ---------------------------------------------------------------------------
# Physics through `solver.simulate`, on any device
# ---------------------------------------------------------------------------


def standing_wave_error(dim: int, fused: bool = False, device="cpu") -> float:
    """tests/test_solver.py's standing wave: the k-space scheme with the sinc(c dt k / 2)
    correction integrates the homogeneous lossless wave equation exactly in time
    (KSpaceFirstOrderSolver.cpp:2404-2452), so p along x follows cos(w t) cos(kx x).
    Returns the largest deviation over 40 steps (CFL 0.3, 32 points a side, m = 3);
    ``fused``: compact operators and the fused z stage (3D)."""
    import torch

    from kwave_tpu_torch.solver import (Grid, Medium, SolverConfig, Sources, init_state,
                                        make_operators, simulate)

    n, c0, dx, steps = 32, 1500.0, 1e-4, 40
    dt = 0.3 * dx / c0
    grid = Grid(nx=n, ny=n, nz=1 if dim == 2 else n, dx=dx, dy=dx, dz=dx, dt=dt, nt=50)
    ops = make_operators(grid, Medium(c0=c0, rho0=1000.0), (0, 0, 0), (0, 0, 0),
                         device=device, compact=fused)
    multi = None
    if fused:
        from kwave_tpu_torch.ops import zfuse

        multi = zfuse.make_pipeline(grid.shape, ops.k2_z, ops.k2_y, ops.k2_x,
                                    ops.c_ref_dt_2, device)
    kx = 2 * np.pi * 3 / (n * dx)
    x = np.arange(n) * dx
    p0 = np.broadcast_to(np.cos(kx * x).astype(np.float32), grid.shape).copy()
    lead = (0,) * (dim - 1)
    # step t = 0 applies p0 after the zero state's update, so row t is p(t dt)
    _, ps = simulate(init_state(grid, device), ops, Sources(p0=torch.from_numpy(p0).to(device)),
                     SolverConfig(p0_source_flag=True), steps,
                     sample_fn=lambda s: s.p[lead], spectral_multi=multi)
    t = np.arange(steps)[:, None] * dt
    return float(np.abs(ps.cpu().numpy() - np.cos(c0 * kx * t) * np.cos(kx * x)).max())


def reciprocity_error(device="cpu") -> float:
    """tests/test_solver.py's acoustic reciprocity: in a lossless homogeneous medium the
    pressure recorded at B from an additive source at A equals that at A from B. Returns
    max |G(A->B) - G(B->A)| over 60 steps as a share of the peak (32^3, PML 6)."""
    import torch

    from kwave_tpu_torch.solver import (Grid, Medium, SolverConfig, Sources, init_state,
                                        make_operators, simulate)

    n = 32
    grid = Grid(nx=n, ny=n, nz=n, dx=1e-4, dy=1e-4, dz=1e-4, dt=2e-8, nt=60)
    ops = make_operators(grid, Medium(c0=1500.0, rho0=1000.0), (6, 6, 6), (2.0,) * 3,
                         need_source_kappa=True, device=device)
    sig = torch.from_numpy((4e-3 * np.sin(2 * np.pi * np.arange(60) / 12)
                            * np.hanning(60)).astype(np.float32)).to(device)
    a, b = (10 * n + 12) * n + 14, (20 * n + 18) * n + 22

    def record(src, rec):
        source = Sources(p_index=torch.tensor([src], device=device), p_signal=sig)
        _, vals = simulate(init_state(grid, device), ops, source,
                           SolverConfig(p_source_flag=60, p_source_mode=2), 60,
                           sample_fn=lambda s: s.p.reshape(-1)[rec])
        return vals.double().cpu().numpy()

    ab, ba = record(a, b), record(b, a)
    return float(np.abs(ab - ba).max() / np.abs(ab).max())
