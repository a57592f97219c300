"""Output streams: the sample -> reduce/compress -> file path (port of `kwave_tpu.streams`).

- a static `StreamSpec` list (which field, which reduce op, compression settings), the
  analogue of OutputStreamContainer::init's flag wiring (OutputStreamContainer.cpp:70-325);
- one state dict (`init_stream_states`) holding encoder accumulators and reduce buffers on
  the run's device;
- `process_chunk`, which consumes one oSize-step window of sampled rows per source and
  advances every stream at once: raw rows pass through, aggregates fold, compressed
  streams emit exactly one coefficient frame;
- a host-side `StreamWriter` that owns the output datasets and flushes emissions.

Dataset sizing follows the reference: raw rows Nt-s, compressed frames floor((Nt-s)/oSize)
(IndexOutputStream.cpp:105-117).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from kwave_tpu_torch import bitpack, encoder, sampling
from kwave_tpu_torch.basis import MAX_EXP_P, MAX_EXP_U, CompressionBasis
from kwave_tpu_torch.io import names as dn
from kwave_tpu_torch.io.output_file import (
    CompressionAttrs,
    create_aggregate_dataset,
    create_compressed_dataset,
    create_cuboid_group,
    create_field_dataset,
    create_raw_dataset,
)

# Sources a stream can sample (OutputStreamContainer.cpp:84-266).
SOURCES = (
    "p",
    "ux_sgx",
    "uy_sgy",
    "uz_sgz",
    "ux_shifted",
    "uy_shifted",
    "uz_shifted",
)


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    name: str  # dataset name, e.g. "p_c", "ux_rms"
    source: str  # one of SOURCES
    op: str  # raw | c | rms | max | min | max_all | min_all | final
    mode40: bool = False
    shifted_basis: bool = False  # velocity non-staggered streams use shifted tables
    # --no_overlap: single aliased accumulator (BaseOutputStream.cpp:246-257); also
    # auto-forced when the record is shorter than one period (Parameters.cpp:141-145)
    overlap: bool = True

    @staticmethod
    def from_flags(flags: dict[str, bool], is3d: bool, mode40: bool = False
                   ) -> list["StreamSpec"]:
        """Flag surface -> stream list (OutputStreamContainer::init,
        OutputStreamContainer.cpp:70-325)."""
        specs: list[StreamSpec] = []
        ax = ("x", "y", "z") if is3d else ("x", "y")

        def u_each(fmt, source_fmt, op, **kw):
            for a in ax:
                specs.append(StreamSpec(fmt.format(a=a), source_fmt.format(a=a), op, **kw))

        if flags.get("p_raw"):
            specs.append(StreamSpec(dn.P, "p", "raw"))
        if flags.get("p_c"):
            specs.append(StreamSpec(dn.P + dn.COMPRESS_SUFFIX, "p", "c", mode40=mode40))
        for op in ("rms", "max", "min", "max_all", "min_all", "final"):
            if flags.get(f"p_{op}"):
                specs.append(StreamSpec(f"p_{op}", "p", op))
        if flags.get("u_raw"):
            u_each("u{a}", "u{a}_sg{a}", "raw")
        if flags.get("u_c"):
            u_each("u{a}" + dn.COMPRESS_SUFFIX, "u{a}_sg{a}", "c", mode40=mode40)
        if flags.get("u_non_staggered_raw"):
            u_each("u{a}_non_staggered", "u{a}_shifted", "raw")
        if flags.get("u_non_staggered_c"):
            # non-staggered velocity uses the shifted basis + kMaxExpU
            # (BaseOutputStream.cpp:68-83)
            u_each("u{a}_non_staggered" + dn.COMPRESS_SUFFIX, "u{a}_shifted", "c",
                   mode40=mode40, shifted_basis=True)
        for op in ("rms", "max", "min", "max_all", "min_all", "final"):
            if flags.get(f"u_{op}"):
                u_each("u{a}_" + op, "u{a}_sg{a}", op)
        return specs

    def e_const(self) -> int:
        return MAX_EXP_U if self.shifted_basis else MAX_EXP_P

    def complex_size(self) -> float:
        return 1.25 if self.mode40 else 2.0  # BaseOutputStream.cpp:98-101


def needs_shifted_velocity(specs: list[StreamSpec]) -> bool:
    return any(s.source.endswith("_shifted") for s in specs)


def needed_sources(specs: list[StreamSpec]) -> list[str]:
    """Sources the per-step sensor gather must produce (whole-domain ops need none)."""
    seen: list[str] = []
    for s in specs:
        if s.op in ("max_all", "min_all", "final"):
            continue
        if s.source not in seen:
            seen.append(s.source)
    return seen


# ---------------------------------------------------------------------------
# Device-side state + chunk processing
# ---------------------------------------------------------------------------


def init_stream_states(specs: list[StreamSpec], n_sensors: int, n_grid: int,
                       basis: Optional[CompressionBasis],
                       device: torch.device | str = "cpu") -> dict[str, Any]:
    """One entry per stream: encoder state for `c`, reduce buffer for aggregates, None for
    raw/final (their data flows through chunk outputs / final state)."""
    states: dict[str, Any] = {}
    for s in specs:
        if s.op == "c":
            cfg = encoder.EncoderConfig.for_stream(basis, s.shifted_basis, s.mode40,
                                                   s.overlap)
            states[s.name] = encoder.init_state(cfg, n_sensors, device)
        elif s.op in ("rms", "max", "min"):
            states[s.name] = sampling.init_reduce_buffer(s.op, n_sensors, device)
        elif s.op in ("max_all", "min_all"):
            states[s.name] = sampling.init_reduce_buffer(s.op.split("_")[0], n_grid, device)
        elif s.op in ("raw", "final"):
            states[s.name] = None
        else:
            raise ValueError(f"stream {s.name!r}: unknown op {s.op!r}")
    return states


def encoder_tables(basis: CompressionBasis, device: torch.device | str = "cpu"
                   ) -> dict[bool, dict[str, torch.Tensor]]:
    """Plain and shifted basis tables on ``device``, keyed by ``shifted``."""
    return {False: encoder.make_tables(basis, False, device),
            True: encoder.make_tables(basis, True, device)}


def process_chunk(
    states: dict[str, Any],
    chunks: dict[str, torch.Tensor],  # source -> [steps, n_sensors] sampled rows
    specs: list[StreamSpec],
    basis: Optional[CompressionBasis],
    tables: Optional[dict[bool, dict[str, torch.Tensor]]],
    emit: bool = True,
) -> tuple[dict[str, Any], dict[str, Any]]:
    """Advance all streams by one aligned oSize window. Returns (states, emissions):
    emissions[name] = raw rows [o, N] | coefficient frame: float mode (re, im) planes,
    40-bit mode ONE wire-format int32 word tensor (`pack_40bit_emissions`; unpacked with
    `bitpack.frame_wire_bytes`) | None.

    ``emit=False`` processes a partial trailing window (< oSize rows): compressed streams
    accumulate without emitting a frame (IndexOutputStream.cpp:397-456). ``tables`` is
    `encoder_tables(basis, device)` (None without compressed streams). Whole-domain
    extrema are folded per step by the driver, not here."""
    out: dict[str, Any] = {}
    new_states = dict(states)
    for s in specs:
        if s.op == "raw":
            out[s.name] = chunks[s.source]
        elif s.op == "c":
            cfg = encoder.EncoderConfig.for_stream(basis, s.shifted_basis, s.mode40,
                                                   s.overlap)
            tab = tables[s.shifted_basis]
            if emit:
                st, frame = encoder.encode_chunk(states[s.name], chunks[s.source], cfg, tab)
                out[s.name] = frame
            else:
                st = encoder.accumulate_chunk(states[s.name], chunks[s.source], cfg, tab)
                out[s.name] = None
            new_states[s.name] = st
        elif s.op == "rms":
            x = chunks[s.source]
            new_states[s.name] = states[s.name] + torch.sum(x * x, dim=0)
        elif s.op == "max":
            new_states[s.name] = torch.maximum(states[s.name],
                                               torch.amax(chunks[s.source], dim=0))
        elif s.op == "min":
            new_states[s.name] = torch.minimum(states[s.name],
                                               torch.amin(chunks[s.source], dim=0))
    if emit:
        finalize_emissions(new_states, out, specs)
    return new_states, out


def finalize_emissions(states: dict[str, Any], emissions: dict[str, Any],
                       specs: list[StreamSpec]) -> None:
    """The per-frame post pass in its REQUIRED order, as one call (mutates
    ``emissions``): the coefficient-space intensity pass consumes the SoA planes first
    (IndexOutputStream::postSample; its iavg_c streams are not ported yet, ROADMAP
    queue 1 item 4), THEN the 40-bit frames are packed to wire words. Every emission
    producer (window loop, tiny-record partial) goes through this one helper."""
    if any(s.op == "iavg_c" for s in specs):
        raise NotImplementedError(
            "iavg_c streams (I_avg_c / Q_term_c) are not ported yet (ROADMAP queue 1 "
            "item 4)"
        )
    pack_40bit_emissions(emissions, specs)


def pack_40bit_emissions(emissions: dict[str, Any], specs: list[StreamSpec]) -> None:
    """Pack mode40 emission frames into wire-format words on the device (in place): 5 B
    per coefficient leave the device instead of the planes' 12."""
    for s in specs:
        if s.op == "c" and s.mode40 and emissions.get(s.name) is not None:
            emissions[s.name] = bitpack.pack_frame_wire(*emissions[s.name])


def finalize_aggregates(states: dict[str, Any], specs: list[StreamSpec],
                        sampled_steps: int) -> dict[str, np.ndarray]:
    """Post-processing of aggregate buffers (BaseOutputStream::postProcess,
    BaseOutputStream.cpp:160-180: rms scaled by 1/(Nt-s) and sqrt'd)."""
    out = {}
    for s in specs:
        if s.op == "rms":
            out[s.name] = sampling.post_rms(states[s.name], sampled_steps).cpu().numpy()
        elif s.op in ("max", "min", "max_all", "min_all"):
            out[s.name] = states[s.name].cpu().numpy()
    return out


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Host-side writer
# ---------------------------------------------------------------------------


class StreamWriter:
    """Owns the output-file datasets for a stream set; flushes emissions as they arrive.

    ``h5file`` is an open h5py file or any object with the subset of its group API used
    here (``create_dataset``, ``create_group``, item access, ``attrs.create``). Dataset
    sizing per IndexOutputStream::create (IndexOutputStream.cpp:87-171).

    ``cuboid_shapes`` [(cx, cy, cz), ...] switches raw/compressed/aggregate streams to
    the reference's cuboid layout: a group per stream with per-cuboid 4D datasets "1",
    "2", ... (CuboidOutputStream.cpp:656-722); the device still samples the linearized
    point list, and the writer splits each row back into cuboid blocks."""

    def __init__(
        self,
        h5file,
        specs: list[StreamSpec],
        n_sensors: int,
        sampled_steps: int,
        basis: Optional[CompressionBasis],
        compression_level: int = 0,
        cuboid_shapes: Optional[list[tuple[int, int, int]]] = None,
        field_shape: Optional[tuple[int, ...]] = None,
    ):
        self.specs = {s.name: s for s in specs}
        self.basis = basis
        self.n_sensors = n_sensors
        self.cuboid_shapes = cuboid_shapes
        self.rows = {s.name: 0 for s in specs}
        self.datasets = {}
        self.groups: set[str] = set()  # streams written as per-cuboid groups
        for s in specs:
            attrs = None
            if s.op == "c":
                attrs = CompressionAttrs(
                    harmonics=basis.harmonics, period=basis.period, mos=basis.mos,
                    shift=s.shifted_basis, complex_size=s.complex_size(),
                    max_exp=s.e_const(),
                )
            if s.op in ("raw", "c") and cuboid_shapes is not None:
                self.datasets[s.name] = create_cuboid_group(
                    h5file, s.name, cuboid_shapes, sampled_steps, attrs=attrs,
                    compression_level=compression_level,
                )
                self.groups.add(s.name)
            elif s.op == "raw":
                self.datasets[s.name] = create_raw_dataset(
                    h5file, s.name, n_sensors, sampled_steps, compression_level
                )
            elif s.op == "c":
                self.datasets[s.name] = create_compressed_dataset(
                    h5file, s.name, n_sensors, sampled_steps, attrs, compression_level
                )
            elif s.op in ("rms", "max", "min"):
                if cuboid_shapes is not None:
                    self.datasets[s.name] = create_cuboid_group(
                        h5file, s.name, cuboid_shapes, 1,
                        compression_level=compression_level,
                    )
                    self.groups.add(s.name)
                else:
                    self.datasets[s.name] = create_aggregate_dataset(
                        h5file, s.name, n_sensors, compression_level
                    )
            elif s.op in ("max_all", "min_all", "final"):
                if field_shape is None:
                    raise ValueError(
                        f"stream {s.name!r} needs the grid field shape for its dataset"
                    )
                self.datasets[s.name] = create_field_dataset(
                    h5file, s.name, field_shape, compression_level
                )

    def _write_cuboid_rows(self, grp, rows: np.ndarray, row0: int, values_per_pt):
        """Split linearized rows [n_rows, Npts*vpp] into per-cuboid 4D blocks."""
        n_rows = rows.shape[0]
        off = 0
        for ci, (cx, cy, cz) in enumerate(self.cuboid_shapes):
            npts = cx * cy * cz
            blk = rows[:, off * values_per_pt : (off + npts) * values_per_pt]
            ds = grp[str(ci + 1)]
            n = min(n_rows, ds.shape[0] - row0)
            if n > 0:
                ds[row0 : row0 + n, ...] = blk[:n].reshape(n, cz, cy, cx * values_per_pt)
            off += npts

    def _write_cuboid_40b(self, grp, flat_bytes: np.ndarray, row0: int) -> None:
        """One 40-bit frame into per-cuboid datasets: each point contributes 5*H bytes,
        laid into the padded per-(z, y) x-rows."""
        h = self.basis.harmonics
        off_pts = 0
        for ci, (cx, cy, cz) in enumerate(self.cuboid_shapes):
            npts = cx * cy * cz
            ds = grp[str(ci + 1)]
            if row0 < ds.shape[0]:
                byte_run = flat_bytes[off_pts * 5 * h : (off_pts + npts) * 5 * h]
                out = np.zeros(ds.shape[1:], np.float32)
                bpr = 5 * cx * h
                out.reshape(cz, cy, -1).view(np.uint8)[:, :, :bpr] = byte_run.reshape(
                    cz, cy, bpr
                )
                ds[row0, ...] = out
            off_pts += npts

    def flush_emissions(self, emissions: dict[str, Any]) -> None:
        """Write raw rows / one coefficient frame per compressed stream."""
        for name, data in emissions.items():
            if data is None:
                continue
            spec = self.specs[name]
            ds = self.datasets[name]
            if spec.op == "raw":
                rows = _host(data)
                if name in self.groups:
                    self._write_cuboid_rows(ds, rows, self.rows[name], 1)
                    self.rows[name] += rows.shape[0]
                    continue
                n = min(rows.shape[0], ds.shape[1] - self.rows[name])
                if n > 0:
                    ds[0, self.rows[name] : self.rows[name] + n, :] = rows[:n]
                    self.rows[name] += n
            elif spec.op == "c":
                if spec.mode40:
                    # emissions arrive as device-packed wire words; the payload is 5*N*H B
                    flat = bitpack.frame_wire_bytes(
                        data, self.n_sensors * self.basis.harmonics
                    )
                    if name in self.groups:
                        self._write_cuboid_40b(ds, flat, self.rows[name])
                        self.rows[name] += 1
                        continue
                    if self.rows[name] >= ds.shape[1]:
                        continue
                    row = np.zeros(ds.shape[2], np.float32)
                    row.view(np.uint8)[: flat.size] = flat
                    ds[0, self.rows[name], :] = row
                    self.rows[name] += 1
                else:
                    row = encoder.frames_to_flat_float(*data)
                    if name in self.groups:
                        self._write_cuboid_rows(ds, row.reshape(1, -1), self.rows[name],
                                                2 * self.basis.harmonics)
                        self.rows[name] += 1
                        continue
                    if self.rows[name] >= ds.shape[1]:
                        continue
                    ds[0, self.rows[name], :] = row.reshape(-1)
                    self.rows[name] += 1

    def flush_aggregates(self, finals: dict[str, np.ndarray]) -> None:
        for name, data in finals.items():
            tgt = self.datasets[name]
            vals = np.asarray(data)
            if name in self.groups:
                off = 0
                for ci, (cx, cy, cz) in enumerate(self.cuboid_shapes):
                    npts = cx * cy * cz
                    tgt[str(ci + 1)][...] = vals.reshape(-1)[off : off + npts].reshape(
                        1, cz, cy, cx
                    )
                    off += npts
            else:
                tgt[...] = vals.reshape(tgt.shape)

    def flush_final_fields(self, field_map: dict[str, Any]) -> None:
        """p_final/u*_final snapshots (KSpaceFirstOrderSolver.cpp:962-985)."""
        for name, data in field_map.items():
            ds = self.datasets[name]
            ds[...] = _host(data).reshape(ds.shape)
