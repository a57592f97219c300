"""Output streams: the sample -> reduce/compress -> file path (port of `kwave_tpu.streams`).

- a static `StreamSpec` list (which field, which reduce op, compression settings), the
  analogue of OutputStreamContainer::init's flag wiring (OutputStreamContainer.cpp:70-325);
- one state dict (`init_stream_states`) holding encoder accumulators and reduce buffers on
  the run's device;
- `process_chunk`, which consumes one oSize-step window of sampled rows per source and
  advances every stream at once: raw rows pass through, aggregates fold, compressed
  streams emit exactly one coefficient frame;
- a host-side `StreamWriter` that owns the output datasets and flushes emissions;
- the checkpoint forms of the stream state (`stream_states_to_checkpoint`,
  `restore_stream_states`, `restore_aggregates_from_file`, `raw_aggregates`), with which
  a run continues in a later leg.

Dataset sizing follows the reference: raw rows Nt-s, compressed frames floor((Nt-s)/oSize)
(IndexOutputStream.cpp:105-117).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from kwave_tpu_torch import bitpack, decoder, encoder, sampling
from kwave_tpu_torch.basis import MAX_EXP_P, MAX_EXP_U, CompressionBasis
from kwave_tpu_torch.io import names as dn
from kwave_tpu_torch.io.hdf5 import is_group, read_flat
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
    op: str  # raw | c | rms | max | min | max_all | min_all | final | iavg_c
    mode40: bool = False
    shifted_basis: bool = False  # velocity non-staggered streams use shifted tables
    # --no_overlap: single aliased accumulator (BaseOutputStream.cpp:246-257); also
    # auto-forced when the record is shorter than one period (Parameters.cpp:141-145)
    overlap: bool = True
    # doNotSave: the stream runs (samples, encodes, accumulates) but writes no dataset:
    # the hidden dependency streams of I_avg_c / Q_term_c
    # (OutputStreamContainer.cpp:269-325)
    save: bool = True

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
        elif s.op == "iavg_c":
            # on-the-fly coefficient-space intensity accumulator
            # (IndexOutputStream::postSample, IndexOutputStream.cpp:299-342)
            states[s.name] = torch.zeros(n_sensors, dtype=torch.float32, device=device)
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
    stepwise: bool = False,
) -> tuple[dict[str, Any], dict[str, Any]]:
    """Advance all streams by one aligned oSize window. Returns (states, emissions):
    emissions[name] = raw rows [o, N] | coefficient frame: float mode (re, im) planes,
    40-bit mode ONE wire-format int32 word tensor (`pack_40bit_emissions`; unpacked with
    `bitpack.frame_wire_bytes`) | None.

    ``emit=False`` processes a partial trailing window (< oSize rows): compressed streams
    accumulate without emitting a frame (IndexOutputStream.cpp:397-456), and the iavg_c
    pass is skipped (postSample fires per completed frame only). ``stepwise=True`` takes
    rows that start inside a window (the first steps of a leg resumed from a checkpoint
    that is not window-aligned): compressed streams go through `encoder.encode_steps`,
    and the rows must end at the window's boundary (``emit=True``: the one frame comes
    out) or before it (``emit=False``). ``tables`` is `encoder_tables(basis, device)`
    (None without compressed streams). Whole-domain extrema are folded per step by the
    driver, not here."""
    out: dict[str, Any] = {}
    new_states = dict(states)
    for s in specs:
        if s.op == "raw":
            out[s.name] = chunks[s.source]
        elif s.op == "c":
            cfg = encoder.EncoderConfig.for_stream(basis, s.shifted_basis, s.mode40,
                                                   s.overlap)
            tab = tables[s.shifted_basis]
            if stepwise:
                st, frames = encoder.encode_steps(states[s.name], chunks[s.source], cfg,
                                                  tab)
                if len(frames) != int(emit):
                    raise ValueError(
                        f"stream {s.name!r}: {len(frames)} frames from stepwise rows, "
                        f"expected {int(emit)}"
                    )
                out[s.name] = frames[0] if frames else None
            elif emit:
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
    """The per-frame post pass in its REQUIRED order, as one call (mutates both
    dicts): the coefficient-space intensity pass consumes the SoA planes first
    (IndexOutputStream::postSample), THEN the 40-bit frames are packed to wire words.
    Every emission producer (window loop, tiny-record partial) goes through this one
    helper."""
    accumulate_iavg_from_frames(states, emissions, specs)
    pack_40bit_emissions(emissions, specs)


def accumulate_iavg_from_frames(states: dict[str, Any], frames: dict[str, Any],
                                specs: list[StreamSpec]) -> None:
    """One postSample pass (IndexOutputStream.cpp:299-342): every iavg_c stream consumes
    the just-completed coefficient frames of its p/u partner streams (``[H, N]`` planes,
    40-bit ones decoded first). Mutates ``states``. Fires once per completed frame,
    including the tiny-record lastStep partial frame (:313)."""
    pf = None  # the pressure frame, shared by every axis: decoded once
    for s in specs:
        if s.op != "iavg_c":
            continue
        axis = s.name[1]  # "Ix_avg_c" -> "x"
        uf = frames[f"u{axis}_non_staggered" + dn.COMPRESS_SUFFIX]
        if pf is None:
            pf = frames["p" + dn.COMPRESS_SUFFIX]
            if s.mode40:
                pf = decoder.decode_frames_40b(*pf, MAX_EXP_P)
        if s.mode40:
            uf = decoder.decode_frames_40b(*uf, MAX_EXP_U)
        states[s.name] = decoder.avg_intensity_update(states[s.name], *pf, *uf)


def pack_40bit_emissions(emissions: dict[str, Any], specs: list[StreamSpec]) -> None:
    """Pack mode40 emission frames into wire-format words on the device (in place): 5 B
    per coefficient leave the device instead of the planes' 12."""
    for s in specs:
        if s.op == "c" and s.mode40 and emissions.get(s.name) is not None:
            emissions[s.name] = bitpack.pack_frame_wire(*emissions[s.name])


_AGGREGATE_OPS = ("rms", "max", "min", "max_all", "min_all", "iavg_c")


def finalize_aggregates(states: dict[str, Any], specs: list[StreamSpec],
                        sampled_steps: int, compressed_frames: int = 0
                        ) -> dict[str, np.ndarray]:
    """Post-processing of aggregate buffers (BaseOutputStream::postProcess,
    BaseOutputStream.cpp:160-180: rms scaled by 1/(Nt-s) and sqrt'd; IAvgC divided by
    the number of completed frames, IndexOutputStream.cpp:482-490)."""
    out = {}
    for s in specs:
        if s.op == "rms":
            out[s.name] = sampling.post_rms(states[s.name], sampled_steps).cpu().numpy()
        elif s.op in ("max", "min", "max_all", "min_all"):
            out[s.name] = states[s.name].cpu().numpy()
        elif s.op == "iavg_c":
            out[s.name] = states[s.name].cpu().numpy() / max(compressed_frames, 1)
    return out


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Checkpoint (de)serialization of stream states
# ---------------------------------------------------------------------------


def stream_states_to_checkpoint(states: dict[str, Any], specs: list[StreamSpec],
                                n_sensors: int
                                ) -> dict[str, tuple[np.ndarray, Optional[np.ndarray]]]:
    """Encoder accumulators -> the reference's Temp_<name>_1/2 flat buffers
    (BaseOutputStream::checkpoint, BaseOutputStream.cpp:551-606): float mode stores
    interleaved complex rows; 40-bit mode stores the packed 5-byte stream inside a
    float32 buffer of ceil(1.25 N) * H floats."""
    out = {}
    for s in specs:
        if s.op != "c":
            continue
        st = states[s.name]
        if s.mode40:
            def pack(k):
                flat = encoder.frames_to_flat_40b(st["hdr" + k], st["mr" + k],
                                                  st["mi" + k])
                buf = np.zeros(int(np.ceil(n_sensors * 1.25)) * st["hdr" + k].shape[0],
                               np.float32)
                buf.view(np.uint8)[: flat.size] = flat
                return buf

            out[s.name] = (pack("1"), pack("2") if "hdr2" in st else None)
        else:
            out[s.name] = (
                encoder.frames_to_flat_float(st["acc1_re"], st["acc1_im"]),
                encoder.frames_to_flat_float(st["acc2_re"], st["acc2_im"])
                if "acc2_re" in st else None,
            )
    return out


def restore_stream_states(states: dict[str, Any],
                          coeffs: dict[str, tuple[np.ndarray, Optional[np.ndarray]]],
                          specs: list[StreamSpec], sampled_steps_done: int, o_size: int
                          ) -> dict[str, Any]:
    """Inverse of `stream_states_to_checkpoint` + counter reseeding
    (loadCheckpointCompressionCoefficients, BaseOutputStream.cpp:528-544;
    mCompressedTimeStep reseed, IndexOutputStream.cpp:207-210). The planes go to the
    device of the state they replace."""
    from kwave_tpu_torch.oracle import bytes_to_soa

    new = dict(states)
    for s in specs:
        if s.op != "c" or s.name not in coeffs:
            continue
        st = dict(states[s.name])
        first = st["hdr1" if s.mode40 else "acc1_re"]
        (h, n), device = first.shape, first.device
        b1, b2 = coeffs[s.name]

        def put(a):  # sensor-major [N, H] on the host -> [H, N] on the device
            return torch.from_numpy(np.ascontiguousarray(a.reshape(n, h).T)).to(device)

        if s.mode40:
            def unpack(buf):
                raw = np.ascontiguousarray(
                    np.asarray(buf, np.float32).reshape(-1)).view(np.uint8)[: 5 * n * h]
                return tuple(put(a.astype(np.int32))
                             for a in bytes_to_soa(np.ascontiguousarray(raw)))

            st["hdr1"], st["mr1"], st["mi1"] = unpack(b1)
            if b2 is not None and "hdr2" in st:
                st["hdr2"], st["mr2"], st["mi2"] = unpack(b2)
        else:
            def unflat(buf):
                c = np.asarray(buf, np.float32).reshape(n, h, 2)
                return put(c[..., 0]), put(c[..., 1])

            st["acc1_re"], st["acc1_im"] = unflat(b1)
            if b2 is not None and "acc2_re" in st:
                st["acc2_re"], st["acc2_im"] = unflat(b2)
        st["sampled_step"] = int(sampled_steps_done)
        st["compressed_step"] = int(sampled_steps_done) // o_size
        new[s.name] = st
    return new


def restore_aggregates_from_file(states: dict[str, Any], specs: list[StreamSpec],
                                 h5file, sampled_steps_done: int) -> dict[str, Any]:
    """Aggregates are flushed RAW (pre-postProcess) to the output file at a checkpoint
    and reloaded on reopen (IndexOutputStream::reopen, IndexOutputStream.cpp:213-231);
    finalization (rms sqrt/scale, the IAvgC divide) happens only on the last leg."""
    new = dict(states)
    if sampled_steps_done <= 0:
        return new
    for s in specs:
        if s.op in _AGGREGATE_OPS:
            new[s.name] = torch.from_numpy(read_flat(h5file[s.name])).to(
                states[s.name].device)
    return new


def raw_aggregates(states: dict[str, Any], specs: list[StreamSpec]
                   ) -> dict[str, np.ndarray]:
    """Un-finalized aggregate buffers for a checkpoint-leg flush."""
    return {s.name: _host(states[s.name]) for s in specs if s.op in _AGGREGATE_OPS}


# ---------------------------------------------------------------------------
# Stream states on a mesh: one state dict a shard, over that shard's sensors (and slab)
# ---------------------------------------------------------------------------

_PER_SENSOR = ("rms", "max", "min", "iavg_c")
_WHOLE_DOMAIN = ("max_all", "min_all")


def state_pieces(states: list[dict[str, Any]], specs: list[StreamSpec],
                 ids: list[int]) -> dict[str, Any]:
    """This process's shards' stream states (one dict a shard, in shard order) as one
    tree to gather: the per-sensor planes and buffers as `Sharded` values along the
    sensor axis, the whole-domain buffers as `Sharded` slabs (`join_states` takes the
    gathered tree)."""
    from kwave_tpu_torch.parallel.sharded import Sharded

    def pieces(get, axis):
        return Sharded([get(st) for st in states], ids=ids, axis=axis)

    out: dict[str, Any] = {}
    for s in specs:
        first = states[0][s.name]
        if s.op == "c":
            out[s.name] = {k: pieces(lambda st, k=k: st[s.name][k], -1)
                           if isinstance(v, torch.Tensor) else v for k, v in first.items()}
        elif s.op in _PER_SENSOR:
            out[s.name] = pieces(lambda st: st[s.name], -1)
        elif s.op in _WHOLE_DOMAIN:
            out[s.name] = pieces(lambda st: st[s.name], 0)
        else:
            out[s.name] = None
    return out


def join_states(gathered: dict[str, Any], specs: list[StreamSpec], sensors
                ) -> dict[str, Any]:
    """A gathered `state_pieces` tree -> one state dict of host arrays, per-sensor values
    in the mask's order (``sensors``: `sampling.SlabSensors`)."""
    order = lambda a: sampling.in_mask_order(np.asarray(a), sensors)  # noqa: E731
    out: dict[str, Any] = {}
    for s in specs:
        v = gathered[s.name]
        if s.op == "c":
            out[s.name] = {k: order(a) if isinstance(a, np.ndarray) else a
                           for k, a in v.items()}
        elif s.op in _PER_SENSOR:
            out[s.name] = order(v)
        else:
            out[s.name] = v
    return out


def split_states(states: dict[str, Any], specs: list[StreamSpec], sensors, mesh
                 ) -> list[dict[str, Any]]:
    """One global state dict (tensors on any device, e.g. restored from a checkpoint) ->
    this process's shards' state dicts, each on its shard's device: per-sensor values at
    the shard's sensors, whole-domain buffers on its slab."""
    out = []
    for k, d in zip(mesh.shard_ids, mesh.devices):
        sel = torch.as_tensor(sensors.select[k], dtype=torch.int64)

        def at_sensors(a):
            return a.index_select(-1, sel.to(a.device)).to(d)

        st: dict[str, Any] = {}
        for s in specs:
            v = states[s.name]
            if s.op == "c":
                st[s.name] = {key: at_sensors(a) if isinstance(a, torch.Tensor) else a
                              for key, a in v.items()}
            elif s.op in _PER_SENSOR:
                st[s.name] = at_sensors(v)
            elif s.op in _WHOLE_DOMAIN:
                slab = v.shape[0] // mesh.size
                st[s.name] = v[k * slab:(k + 1) * slab].to(d)
            else:
                st[s.name] = v
        out.append(st)
    return out


# ---------------------------------------------------------------------------
# Host-side writer
# ---------------------------------------------------------------------------


class StreamWriter:
    """Owns the output-file datasets for a stream set; flushes emissions as they arrive.

    ``h5file`` is an open `io.h5file.File` or any object with the subset of its group API
    used here (``create_dataset``, ``create_group``, item access, ``attrs.create``). Dataset
    sizing per IndexOutputStream::create (IndexOutputStream.cpp:87-171).

    ``cuboid_shapes`` [(cx, cy, cz), ...] switches raw/compressed/aggregate streams to
    the reference's cuboid layout: a group per stream with per-cuboid 4D datasets "1",
    "2", ... (CuboidOutputStream.cpp:656-722); the device still samples the linearized
    point list, and the writer splits each row back into cuboid blocks.

    ``reopen`` attaches to the existing datasets of a checkpointed run and seeks each
    stream to its resume position (IndexOutputStream::reopen,
    IndexOutputStream.cpp:202-246: raw rows = ``rows_done`` sampled steps, compressed
    rows = floor(rows_done / oSize)). Streams with ``save=False`` own no dataset."""

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
        reopen: bool = False,
        rows_done: int = 0,
    ):
        self.specs = {s.name: s for s in specs}
        self.basis = basis
        self.n_sensors = n_sensors
        self.cuboid_shapes = cuboid_shapes
        o = basis.o_size if basis is not None else 1
        self.rows = {
            s.name: (rows_done if s.op == "raw" else rows_done // o) if reopen else 0
            for s in specs
        }
        self.datasets = {}
        self.groups: set[str] = set()  # streams written as per-cuboid groups
        if reopen:
            self.datasets = {s.name: h5file[s.name] for s in specs if s.save}
            self.groups = {name for name, ds in self.datasets.items() if is_group(ds)}
            return
        for s in specs:
            if not s.save:
                continue
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
            elif s.op in ("rms", "max", "min", "iavg_c"):
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
            if not spec.save:  # hidden dependency stream (doNotSave)
                continue
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
