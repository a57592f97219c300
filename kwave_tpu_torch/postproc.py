"""Post-processing: time-averaged acoustic intensity and the heat-source Q term (port of
`kwave_tpu.postproc`).

The reference computes these after the main loop (or in `--post` mode on an existing
output file), reading the stored sensor series back in memory-bounded blocks
(KSpaceFirstOrderSolver.cpp: computeAverageIntensities :1231-1534,
computeAverageIntensitiesC :1543-1775, computeQTerm :1783-2080). Semantics reproduced:

- **Raw-series intensity**: velocity is staggered half a timestep behind pressure, so u is
  time-shifted by +dt/2 spectrally (signed-frequency phase ramp exp(i*pi*shift/steps),
  :1259-1267) before averaging: I = mean_t p * shift(u).
- **Coefficient-space intensity**: I = mean_frames sum_h Re(cP * conj(cU)) / 2 per point,
  with no reconstruction (:1738-1764; `decoder.avg_intensity_frames`).
- **Q term**: scatter the sensor intensities onto the full grid, per-axis spectral
  derivative with plain ik (signed frequencies, :1905-1924), Q = -div(I).

The tensor functions run on the device of their inputs (`torch.fft.rfft` / `irfft`, a
scatter, a mean). The two file-level functions take the output file's path or an open
group-like object, and the device the blocks are staged on: the card, unless the caller
asks for the CPU.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from kwave_tpu_torch import decoder
from kwave_tpu_torch.driver import require_device
from kwave_tpu_torch.io import names as dn
from kwave_tpu_torch.io.hdf5 import (
    create_dataset,
    group_datasets,
    is_group,
    open_group,
    read_flat,
)
from kwave_tpu_torch.solver.step import real_at_nyquist


def _signed_freq_index(n_bins: int, n: int) -> np.ndarray:
    """Signed frequency index per rfft bin: ((i + n/2) % n) - n/2 (the reference's shift
    table, KSpaceFirstOrderSolver.cpp:1262-1266)."""
    i = np.arange(n_bins)
    return ((i + n // 2) % n - n // 2).astype(np.float64)


def _complex(re: np.ndarray, im: np.ndarray, n: int, device) -> torch.Tensor:
    """complex64 multiplier for the rfft bins of a length-``n`` real axis, on ``device``,
    from float64 tables, each cast to float32 first, real at the Nyquist bin of an even
    ``n`` (`solver.step.real_at_nyquist`: cuFFT's c2r transform keeps what the CPU's
    drops)."""
    table = torch.complex(torch.from_numpy(re.astype(np.float32)),
                          torch.from_numpy(im.astype(np.float32)))
    return real_at_nyquist(table, n).to(device)


def time_shift_half_step(u_series: torch.Tensor) -> torch.Tensor:
    """Shift a velocity time series [T, ...] forward by dt/2 onto pressure sample times:
    rfft over time, multiply exp(i*pi*shift/T), irfft (:1259-1267, applied :1455-1496)."""
    t_steps = u_series.shape[0]
    n_bins = t_steps // 2 + 1
    arg = np.pi * _signed_freq_index(n_bins, t_steps) / t_steps
    phase = _complex(np.cos(arg), np.sin(arg), t_steps, u_series.device)
    uk = torch.fft.rfft(u_series, dim=0)
    shape = (n_bins,) + (1,) * (u_series.ndim - 1)
    return torch.fft.irfft(uk * phase.reshape(shape), n=t_steps, dim=0)


def avg_intensity_raw(p_series: torch.Tensor, u_series: torch.Tensor) -> torch.Tensor:
    """I[point] = mean_t p[t] * u_shifted[t] (:1498-1517). Series are [T, N].

    The mean runs along a contiguous row per point: a reduction over the leading axis
    would add in an order that depends on how many points the block holds, and a blocked
    pass over a file would differ from the unblocked one in the last bit."""
    prod = p_series * time_shift_half_step(u_series)
    return torch.mean(prod.T.contiguous(), dim=1)


def avg_intensity_coeffs(cp_re, cp_im, cu_re, cu_im):
    """Coefficient-space intensity of frames ``[Nc, H, N]`` (re-export of
    `decoder.avg_intensity_frames`)."""
    return decoder.avg_intensity_frames(cp_re, cp_im, cu_re, cu_im)


def _ik_axis(n: int, d: float) -> np.ndarray:
    """Spectral derivative i*k on the rfft-reduced axis with signed frequencies
    (computeQTerm shift tables, :1905-1924), as its imaginary part in float32."""
    n_bins = n // 2 + 1
    return (2.0 * np.pi / d * _signed_freq_index(n_bins, n) / n).astype(np.float32)


def scatter_to_grid(values: torch.Tensor, mask: torch.Tensor, shape: tuple[int, ...]
                    ) -> torch.Tensor:
    """Sensor values -> full grid (zeros elsewhere): the Q-term scatter (:1835-1870)."""
    flat = torch.zeros(int(np.prod(shape)), dtype=torch.float32, device=values.device)
    flat[mask] = values.to(torch.float32)
    return flat.reshape(shape)


def q_term(ix: torch.Tensor, iy: torch.Tensor, iz: Optional[torch.Tensor],
           dx: float, dy: float, dz: float) -> torch.Tensor:
    """Q = -(dIx/dx + dIy/dy [+ dIz/dz]) via per-axis 1D spectral derivatives
    (:1926-2010). Inputs are full-grid [.., ny, nx] fields."""
    ndim = ix.ndim

    def ddx(f, d, axis):
        n = f.shape[axis]
        k_im = _ik_axis(n, d)
        op = _complex(np.zeros_like(k_im), k_im, n, f.device)  # i*k
        shp = [1] * ndim
        shp[axis] = op.shape[0]
        return torch.fft.irfft(torch.fft.rfft(f, dim=axis) * op.reshape(shp), n=n,
                               dim=axis)

    q = ddx(ix, dx, ndim - 1) + ddx(iy, dy, ndim - 2)
    if iz is not None:
        q = q + ddx(iz, dz, 0)
    return -q


def _q_at_sensors(intensities: dict[str, np.ndarray], grid, mask_np: np.ndarray,
                  device) -> np.ndarray:
    """Per-sensor intensities (by axis letter) -> Q term at the sensors."""
    mask = torch.as_tensor(np.asarray(mask_np, np.int64), device=device)
    fields = [scatter_to_grid(torch.from_numpy(np.asarray(v, np.float32)).to(device),
                              mask, grid.shape) for v in intensities.values()]
    q = q_term(fields[0], fields[1], fields[2] if grid.dim == 3 else None,
               grid.dx, grid.dy, grid.dz)
    return q.reshape(-1)[mask].cpu().numpy()


def _write_result(f, name: str, values: np.ndarray, cuboid_dims) -> None:
    """Aggregate [Npts] -> flat dataset, or a per-cuboid group when ``cuboid_dims``
    [(cz, cy, cx), ...] mirrors a cuboid-mask run's layout. Replaces an older result."""
    if name in f:
        del f[name]
    if cuboid_dims is None:
        ds = create_dataset(f, name, (1, 1, values.shape[0]))
        ds[...] = values.reshape(1, 1, -1)
        return
    grp = f.create_group(name)
    off = 0
    for ci, dims in enumerate(cuboid_dims):
        npts = int(np.prod(dims))
        grp.create_dataset(str(ci + 1), data=values[off : off + npts]
                           .reshape((1,) + tuple(dims)).astype(np.float32))
        off += npts


def q_term_from_intensity(output, grid, sensor_mask_index: np.ndarray,
                          suffix: str = "_c", device: torch.device | str = "cuda") -> None:
    """Q term from already-stored I{x,y,z}_avg<suffix> datasets (the on-the-fly I_avg_c
    accumulation path: computeQTerm consumes the IAvgC streams' data,
    KSpaceFirstOrderSolver.cpp:1016-1030 + :1783-2080)."""
    device = torch.device(device)
    require_device(device)
    axes = ("x", "y", "z") if grid.dim == 3 else ("x", "y")
    with open_group(output, "r+") as f:
        first = f[f"Ix_avg{suffix}"]
        cuboid_dims = None
        if is_group(first):
            cuboid_dims = [tuple(d.shape[1:]) for d in group_datasets(first)]
        intensities = {a: read_flat(f[f"I{a}_avg{suffix}"]) for a in axes}
        qs = _q_at_sensors(intensities, grid, sensor_mask_index, device)
        _write_result(f, dn.Q_TERM + suffix, qs, cuboid_dims)


# ---------------------------------------------------------------------------
# File-level post-processing (--post mode / end-of-run)
# ---------------------------------------------------------------------------


def _free_device_bytes(device: torch.device | str = "cpu") -> Optional[int]:
    """Free memory on a CUDA device; None on the CPU, which is no device distinct from
    the host."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[0])


def _auto_block_size(avail_bytes: Optional[int] = None,
                     device_bytes: Optional[int] = None,
                     device: torch.device | str = "cpu") -> int:
    """I/O block size (float elements) when --block_size is absent: the reference sizes
    its post-processing blocks from free host AND device memory
    (KSpaceFirstOrderSolver.cpp:1283-1307: min(host*0.98, device*0.90) / 20).
    Budget: 1/8 of host MemAvailable bounded by 1/4 of the device's free memory (the
    blocks are staged there for the fp32 time-shift FFTs), capped at 2 GB, floor 8M
    elements (32 MB).

    ``avail_bytes`` / ``device_bytes`` override the probes (tests)."""
    if avail_bytes is None:
        avail_bytes = 2 << 30
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemAvailable:"):
                        avail_bytes = int(line.split()[1]) * 1024
                        break
        except OSError:
            pass
    if device_bytes is None:
        device_bytes = _free_device_bytes(device)
    budget = min(avail_bytes // 8, 2 << 30)
    if device_bytes is not None:
        budget = min(budget, device_bytes // 4)
    return max(budget // 4, 8 << 20)


def _cuboid_cx_from_row(row_floats: int, harmonics: int, complex_size: float) -> int:
    """Geometric x extent from a packed coefficient x-row:
    row_floats = ceil(cx * complex_size) * harmonics (CuboidOutputStream.cpp:668-675).
    ceil(cx*cs) is strictly increasing in cx for cs >= 1, so the inverse is unique."""
    nf_h = row_floats // harmonics
    cx = int(nf_h / complex_size)
    while math.ceil((cx + 1) * complex_size) <= nf_h:
        cx += 1
    while cx > 0 and math.ceil(cx * complex_size) > nf_h:
        cx -= 1
    return cx


def post_process_output_file(
    output,
    grid,
    sensor_mask_index: np.ndarray,
    want_i_avg: bool = True,
    want_q_term: bool = False,
    from_coeffs: bool = False,
    block_size: Optional[int] = None,
    device: torch.device | str = "cuda",
) -> None:
    """Compute Ix/Iy/Iz_avg (and Q_term) from an output file holding p/u_non_staggered
    series (raw or compressed) and append the result datasets: the `--post` path
    (main.cpp --post flag; KSpaceFirstOrderSolver::postProcessing :950-1045).

    Coefficient mode reads `*_c` datasets and stays entirely in coefficient space
    (computeAverageIntensitiesC); packed 40-bit rows are unpacked with integer
    arithmetic, exact on any device.

    ``block_size`` bounds the I/O working set, as the reference's --block_size flag and
    auto-sizing (:1283-1307): the most float elements read per hyperslab block; None
    derives it from free host and device memory (`_auto_block_size`). Raw mode blocks
    over sensor points (the half-step time shift needs the full time axis per point);
    coefficient mode blocks over compressed frames (the intensity is a running mean over
    frames)."""
    device = torch.device(device)
    require_device(device)
    if block_size is None:
        block_size = _auto_block_size(device=device)

    axes = ("x", "y", "z") if grid.dim == 3 else ("x", "y")
    with open_group(output, "r+") as f:
        # fail with an actionable message when the run didn't record the needed series
        # (the reference requires the same inputs: postProcessing :950-1045)
        suffix = dn.COMPRESS_SUFFIX if from_coeffs else ""
        needed = ["p" + suffix] + [f"u{a}_non_staggered{suffix}" for a in axes]
        missing = [nm for nm in needed if nm not in f]
        if missing:
            mode = "coefficient (*_c)" if from_coeffs else "raw"
            raise ValueError(
                f"--post needs the {mode} datasets {missing} in {output}; "
                "re-run the simulation with the matching p/u_non_staggered stream "
                "flags (e.g. --p_c --u_non_staggered_c for coefficient mode)"
            )
        # cuboid-mask runs store series as groups of per-cuboid datasets "1", "2", ...
        # (CuboidOutputStream.cpp:656-722), read back in the linearized point order
        # (cuboid-concatenated, x fastest: the order of the sensor mask's index list)
        probe = f["p" + suffix]
        is_cuboid = is_group(probe)
        cuboid_shapes = None  # geometric (cz, cy, cx) per cuboid
        if is_cuboid:
            parts = group_datasets(probe)
            if from_coeffs:
                h_a = int(parts[0].attrs["c_harmonics"])
                cs_a = float(parts[0].attrs["c_complex_size"])
                cuboid_shapes = [
                    (d.shape[1], d.shape[2], _cuboid_cx_from_row(d.shape[3], h_a, cs_a))
                    for d in parts
                ]
            else:
                cuboid_shapes = [tuple(d.shape[1:]) for d in parts]

        def read_rows(name, lo, hi):
            """Rows [lo:hi) as [n, Npts*values_per_point] in linearized point order."""
            obj = f[name]
            if not is_cuboid:
                return obj[0, lo:hi]
            blocks = [d[lo:hi] for d in group_datasets(obj)]  # [n, cz, cy, cx*vpp] each
            return np.concatenate([b.reshape(b.shape[0], -1) for b in blocks], axis=1)

        def series_dims(name):
            """(n_rows, values_per_row) of a flat dataset or cuboid group."""
            obj = f[name]
            if not is_cuboid:
                return obj.shape[1], obj.shape[2]
            parts_ = group_datasets(obj)
            return parts_[0].shape[0], sum(int(np.prod(d.shape[1:])) for d in parts_)

        if from_coeffs:

            def load_coeffs(name, lo, hi):
                """Frame rows [lo:hi) of a `*_c` dataset/group -> (re, im) [hi-lo, N, H]:
                64-bit interleaved floats and packed 40-bit rows, index and cuboid
                layouts."""
                from kwave_tpu_torch.oracle import bytes_to_soa

                obj = f[name]
                attrs = group_datasets(obj)[0].attrs if is_cuboid else obj.attrs
                h_ = int(attrs["c_harmonics"])
                cs = float(attrs["c_complex_size"])
                if is_cuboid and cs != 2.0:
                    # 40-bit cuboid rows: per-(z, y) x-rows are PADDED to
                    # ceil(cx*1.25)*H floats, so strip the padding per cuboid before
                    # the 5-byte fields are read
                    planes = ([], [], [])
                    for d, (cz, cy, cx) in zip(group_datasets(obj), cuboid_shapes):
                        blk = np.ascontiguousarray(d[lo:hi])  # [n, cz, cy, nf]
                        n_blk = blk.shape[0]
                        by = blk.reshape(n_blk, cz, cy, -1).view(np.uint8)[
                            ..., : 5 * cx * h_]
                        soa = bytes_to_soa(np.ascontiguousarray(by).reshape(-1))
                        for acc, plane in zip(planes, soa):
                            acc.append(plane.reshape(n_blk, cz * cy * cx, h_))
                    re, im = decoder.decode_frames_40b(
                        *(torch.from_numpy(np.concatenate(p, axis=1).astype(np.int32))
                          for p in planes), int(attrs["c_max_exp"]))
                    return re.numpy(), im.numpy()
                rows = read_rows(name, lo, hi)  # [blk, mSize]
                if cs == 2.0:
                    c = rows.reshape(rows.shape[0], rows.shape[1] // (2 * h_), h_, 2)
                    return c[..., 0], c[..., 1]
                return decoder.decode_40bit_rows(rows, h_, int(attrs["c_max_exp"]))

            n_frames, m_size = series_dims("p" + dn.COMPRESS_SUFFIX)
            blk = max(1, block_size // max(m_size, 1))
            acc = {a: None for a in axes}
            for lo in range(0, n_frames, blk):
                hi = min(lo + blk, n_frames)
                cp_re, cp_im = load_coeffs("p" + dn.COMPRESS_SUFFIX, lo, hi)
                for a in axes:
                    cu_re, cu_im = load_coeffs(
                        f"u{a}_non_staggered" + dn.COMPRESS_SUFFIX, lo, hi)
                    part = np.sum(np.sum(cp_re * cu_re + cp_im * cu_im, axis=2), axis=0)
                    acc[a] = part if acc[a] is None else acc[a] + part
            intensities = {a: (acc[a] / n_frames * 0.5).astype(np.float32) for a in axes}
        else:
            t_steps, n_sens = series_dims(dn.P)
            intensities = {a: np.empty(n_sens, np.float32) for a in axes}

            def block_intensity(read, lo, hi):
                """``read(name)`` gives one block's [T, n] series; fills [lo:hi)."""
                p = torch.from_numpy(np.ascontiguousarray(read(dn.P))).to(device)
                for a in axes:
                    u = torch.from_numpy(
                        np.ascontiguousarray(read(f"u{a}_non_staggered"))).to(device)
                    intensities[a][lo:hi] = avg_intensity_raw(p, u).cpu().numpy()

            if is_cuboid:
                # time blocks don't work (the half-step shift needs the full time axis
                # per point); block per cuboid over z slabs: points within a z slab are
                # contiguous in the linearized order, so each (p, u) block pair is one
                # bounded hyperslab read
                off = 0
                for ci, (cz, cy, cx) in enumerate(cuboid_shapes):
                    blk_z = max(1, block_size // max(t_steps * cy * cx, 1))
                    for z0 in range(0, cz, blk_z):
                        z1 = min(z0 + blk_z, cz)
                        block_intensity(
                            lambda name: np.asarray(
                                group_datasets(f[name])[ci][:, z0:z1]
                            ).reshape(t_steps, -1),
                            off + z0 * cy * cx, off + z1 * cy * cx)
                    off += cz * cy * cx
            else:
                blk = max(1, block_size // max(t_steps, 1))
                for lo in range(0, n_sens, blk):
                    hi = min(lo + blk, n_sens)
                    block_intensity(lambda name: f[name][0, :, lo:hi], lo, hi)

        if want_i_avg:
            for a in axes:
                _write_result(f, f"I{a}_avg{suffix}", intensities[a], cuboid_shapes)
        if want_q_term:
            _write_result(f, dn.Q_TERM + suffix,
                          _q_at_sensors(intensities, grid, sensor_mask_index, device),
                          cuboid_shapes)
