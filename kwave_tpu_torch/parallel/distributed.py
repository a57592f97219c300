"""Multi-process orchestration: process init, the sensor-block sharded encode, and the
gathers to the writer (port of `kwave_tpu.parallel.distributed`).

- `initialize` starts `torch.distributed` (NCCL for a CUDA run, gloo for a CPU run).
- `encode_sharded`: the codec's data parallelism. Sensors are split over the mesh and each
  shard encodes its block on its own device (the codec state is per sensor), with no
  communication.
- `WriterGather`: the writer edge. Each rank ships only its own shards, point to point, to
  process 0, which assembles them in shard order. `fetch_global` / `gather_frames` give
  every rank the global value, for small collective state.

A sharded leaf of a gathered tree is a `Sharded` with ``ids`` and ``axis`` set: the
global value is its shards (of every process) concatenated along ``axis`` in the order of
``ids``. Other leaves (tensors, arrays, scalars, None) are the same on every process and
cross no wire.
"""

from __future__ import annotations

import os
import pickle
import select
import socket
from typing import Any, Optional

import numpy as np
import torch

from kwave_tpu_torch import encoder
from kwave_tpu_torch.basis import CompressionBasis
from kwave_tpu_torch.parallel.comm import ProcessGroup
from kwave_tpu_torch.parallel.mesh import Mesh, codec_sharding
from kwave_tpu_torch.parallel.sharded import Sharded, shard_map


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: torch.device | str = "cuda") -> int:
    """Join the process group; returns this process's rank.

    With ``num_processes`` the group is ``tcp://coordinator`` of that many ranks, this one
    ``process_id``; without it, torchrun's environment (``env://``: RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT). The backend is NCCL when ``device`` is a CUDA device (each
    rank takes card LOCAL_RANK, or its rank modulo the cards present) and gloo for the CPU;
    nothing falls back from one to the other."""
    import torch.distributed as dist

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL process group asked for, but "
                               "torch.cuda.is_available() is False")
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device}")
    if num_processes is not None:
        if coordinator is None or process_id is None:
            raise ValueError("num_processes needs coordinator (HOST:PORT) and process_id")
        rank, world, init = int(process_id), int(num_processes), f"tcp://{coordinator}"
    else:
        rank, world, init = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://"
    bound = {}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        # NCCL's communicator is made here, not at the run's first trade
        bound = {"device_id": torch.device("cuda", local)}
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world, **bound)
    return dist.get_rank()


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_series(series, mesh: Mesh) -> Sharded:
    """Sensor series ``[T, N]``: the sensor axis in blocks, one a shard."""
    return codec_sharding(mesh, torch.as_tensor(series, dtype=torch.float32))


def encode_sharded(series, basis: CompressionBasis, mesh: Mesh, shifted: bool = False,
                   mode40: bool = False):
    """The fast-path encode (`encoder.encode_series_fast`, the windowed-projection kernel
    on a CUDA tensor) of each shard's sensor block on its device. The projection contracts
    over time only, so the frames come out sensor-sharded with no communication: a tuple
    of `Sharded` planes ``[Nc, H, N_shard]`` (``axis=-1``)."""
    out = shard_map(lambda x: encoder.encode_series_fast(x, basis, shifted=shifted,
                                                         mode40=mode40),
                    shard_series(series, mesh))
    for plane in out:
        plane.ids, plane.axis = list(mesh.shard_ids), -1
    return out


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flatten(tree, leaves: list) -> Any:
    """Leaves of nested dicts / lists / tuples in a fixed order; returns the structure."""
    if isinstance(tree, dict):
        return ("dict", [(k, _flatten(v, leaves)) for k, v in tree.items()])
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Sharded):
        return (type(tree).__name__, [_flatten(v, leaves) for v in tree])
    leaves.append(tree)
    return ("leaf", len(leaves) - 1)


def _unflatten(spec, leaves: list):
    kind, body = spec
    if kind == "leaf":
        return leaves[body]
    if kind == "dict":
        return {k: _unflatten(v, leaves) for k, v in body}
    seq = [_unflatten(v, leaves) for v in body]
    return tuple(seq) if kind == "tuple" else seq


def _pieces(x: Sharded) -> list[tuple[int, np.ndarray]]:
    if x.ids is None or x.axis is None:
        raise ValueError("a gathered Sharded value needs its ids and axis")
    return [(i, np.ascontiguousarray(_np(s))) for i, s in zip(x.ids, x.shards)]


def _assemble(pieces: dict[int, tuple], axis: int) -> np.ndarray:
    """Pieces by shard id -> the global array (they must be shards 0..S-1)."""
    ids = sorted(pieces)
    if ids != list(range(len(ids))):
        raise RuntimeError(f"gathered shards {ids} do not cover 0..{len(ids) - 1}")
    return np.concatenate([pieces[i] for i in ids], axis=axis)


def _local(tree):
    """A tree gathered within one process: every `Sharded` leaf assembled, tensors to
    numpy."""
    leaves: list = []
    spec = _flatten(tree, leaves)
    out = []
    for x in leaves:
        if isinstance(x, Sharded):
            out.append(_assemble(dict(_pieces(x)), x.axis))
        elif isinstance(x, torch.Tensor):
            out.append(_np(x))
        else:
            out.append(x)
    return _unflatten(spec, out)


def fetch_global(tree):
    """A tree of (possibly sharded) values -> host numpy of the GLOBAL value, the same on
    every process (a collective: every process walks the same tree)."""
    if _world()[1] == 1:
        return _local(tree)
    leaves: list = []
    spec = _flatten(tree, leaves)
    mine = [(_pieces(x), x.axis) if isinstance(x, Sharded) else None for x in leaves]
    every = ProcessGroup().all_gather(mine)
    out = []
    for li, x in enumerate(leaves):
        if isinstance(x, Sharded):
            pieces = {i: d for rank in every for i, d in rank[li][0]}
            out.append(_assemble(pieces, x.axis))
        else:
            out.append(_np(x) if isinstance(x, torch.Tensor) else x)
    return _unflatten(spec, out)


def gather_frames(frames, mesh: Mesh) -> tuple:
    """Sensor-sharded frame planes (`encode_sharded`) -> host arrays in sensor order, on
    every process."""
    return tuple(fetch_global(list(frames)))


def _place(full: tuple, i: int, piece: np.ndarray) -> None:
    """Shard ``i``'s piece into its place in a preallocated (array, axis, offsets)."""
    arr, ax, offs = full
    arr[(slice(None),) * ax + (slice(offs[i], offs[i + 1]),)] = piece


def _default_store():
    from torch.distributed import distributed_c10d

    return distributed_c10d._get_default_store()


def _coordinator() -> tuple[str, int]:
    """(host, port) of the process group's rendezvous store: the TCP store under the
    default store's prefixes."""
    store = _default_store()
    while hasattr(store, "underlying_store"):
        store = store.underlying_store
    return getattr(store, "host", ""), getattr(store, "port", 0)


class WriterGather:
    """Point-to-point gather of sharded host values to the WRITER process only.

    The reference funnels all sampled data to exactly one consumer, its single process
    (OutputStreams/BaseOutputStream.cpp:369-388). Here each non-writer rank copies only its
    own shards to the host and sends them to process 0 over a TCP side channel; the
    writer assembles the global arrays in shard order. Bytes per window ~ one shard per
    rank; non-writer ranks never hold a global row.

    - The writer binds an ephemeral port and publishes its address through the process
      group's store. The address is ``KWAVE_WRITER_HOST`` when set, else the interface
      that routes to the coordinator (a UDP connect picks it), else the host name's.
    - Bulk data never rides a pickle: each rank sends one small pickled header, then each
      shard's raw bytes, length-prefixed; the writer reads every header first (the global
      shapes), then places the shards into the preallocated arrays one at a time.
    - A dead peer is a ConnectionError naming its rank (the TCP close); a silent one is a
      timeout error listing the ranks that did not deliver. The timeout is
      ``KWAVE_GATHER_TIMEOUT_S`` (300 s) unless given.
    - A context manager (``with WriterGather() as g: ...``) closes the sockets on any
      exception.

    ``gather(tree)`` returns the global numpy tree on the writer and None elsewhere. Every
    rank makes its instances and gathers in the same order (the driver's host code is the
    same on every rank)."""

    _instances = 0

    def __init__(self, timeout_s: float | None = None):
        if timeout_s is None:
            timeout_s = float(os.environ.get("KWAVE_GATHER_TIMEOUT_S", "300"))
        WriterGather._instances += 1
        self._key = f"kwave_writer_gather_{WriterGather._instances}"
        self._seq = 0
        self._rank, self._nproc = _world()
        self._timeout_s = timeout_s
        self._srv = None
        self._conns: dict[int, socket.socket] = {}
        self._sock = None
        if self._nproc <= 1:
            return
        import datetime

        store = _default_store()
        store.set_timeout(datetime.timedelta(seconds=timeout_s))
        if self._rank == 0:
            srv = socket.socket()
            srv.bind(("", 0))
            srv.listen(self._nproc - 1)
            srv.settimeout(timeout_s)
            host, port = self._advertise_host(), srv.getsockname()[1]
            store.set(self._key, f"{host}:{port}")
            self._srv = srv
            try:
                for _ in range(self._nproc - 1):
                    conn, _addr = srv.accept()
                    conn.settimeout(timeout_s)
                    peer = int.from_bytes(self._recv_n(conn, 4), "little")
                    self._conns[peer] = conn
            except socket.timeout:
                missing = sorted(set(range(1, self._nproc)) - set(self._conns))
                raise RuntimeError(
                    f"writer-gather: rank(s) {missing} never connected to the writer at "
                    f"{host}:{port} within {timeout_s:.0f}s (connected: "
                    f"{sorted(self._conns)}); set KWAVE_WRITER_HOST to the writer's "
                    "address as the other hosts see it") from None
        else:
            host, port = store.get(self._key).decode().rsplit(":", 1)
            try:
                sock = socket.create_connection((host, int(port)), timeout=timeout_s)
            except OSError as exc:
                raise RuntimeError(
                    f"writer-gather: rank {self._rank} cannot reach the writer at "
                    f"{host}:{port} ({exc}); set KWAVE_WRITER_HOST on the writer if its "
                    "detected address is not reachable") from exc
            sock.settimeout(timeout_s)
            sock.sendall(self._rank.to_bytes(4, "little"))
            self._sock = sock

    @staticmethod
    def _advertise_host() -> str:
        """The address the other ranks dial: the override, else the interface that routes
        to the coordinator, else the host name's."""
        override = os.environ.get("KWAVE_WRITER_HOST")
        if override:
            return override
        if _world()[1] > 1:
            chost, cport = _coordinator()
            try:
                probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                try:
                    probe.connect((chost or "127.0.0.1", int(cport or 1)))
                    return probe.getsockname()[0]
                finally:
                    probe.close()
            except OSError:
                pass
        try:
            return socket.gethostbyname(socket.gethostname())
        except OSError:
            return "127.0.0.1"

    def __enter__(self) -> "WriterGather":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _recv_n(self, sock, n: int, peer: int | None = None) -> bytes:
        buf = bytearray(n)
        self._recv_into(sock, memoryview(buf), peer)
        return bytes(buf)

    def _recv_into(self, sock, view, peer: int | None = None) -> None:
        got = 0
        who = f"rank {peer}" if peer is not None else "peer"
        while got < len(view):
            try:
                k = sock.recv_into(view[got:])
            except socket.timeout:
                raise RuntimeError(
                    f"writer-gather: {who} sent {got}/{len(view)} bytes then went silent "
                    f"for {self._timeout_s:.0f}s (seq {self._seq})") from None
            if k == 0:
                raise ConnectionError(
                    f"writer-gather: {who} closed the connection mid-gather (seq "
                    f"{self._seq}): the process likely died")
            got += k

    def _send_msg(self, sock, obj) -> None:
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        sock.sendall(len(payload).to_bytes(8, "little") + payload)

    def _recv_msg(self, sock, peer: int | None = None):
        n = int.from_bytes(self._recv_n(sock, 8, peer), "little")
        return pickle.loads(self._recv_n(sock, n, peer))

    def _recv_headers(self) -> dict[int, tuple]:
        """Every peer's header, in whatever order they come; a timeout names the ranks
        still silent."""
        import time

        pending = dict(self._conns)
        out = {}
        deadline = time.monotonic() + self._timeout_s
        while pending:
            wait = deadline - time.monotonic()
            ready = select.select(list(pending.values()), [], [], max(wait, 0))[0] \
                if wait > 0 else []
            if not ready:
                raise RuntimeError(
                    f"writer-gather: rank(s) {sorted(pending)} did not deliver seq "
                    f"{self._seq} within {self._timeout_s:.0f}s (delivered: "
                    f"{sorted(out)})")
            for peer in [p for p, c in pending.items() if c in ready]:
                out[peer] = self._recv_msg(pending.pop(peer), peer)
        return out

    def gather(self, tree):
        """Tree of values -> the global numpy tree on the writer; None on the other
        ranks (they hold only their own shards)."""
        if self._nproc <= 1:
            return _local(tree)
        self._seq += 1
        leaves: list = []
        spec = _flatten(tree, leaves)
        writer = self._rank == 0
        own = {li: _pieces(x) for li, x in enumerate(leaves) if isinstance(x, Sharded)}
        if not writer:
            # one small pickled header (seq + per-shard metadata), then each shard's raw
            # bytes, length-prefixed: never one pickle of the whole payload
            headers = [(li, i, d.dtype.str, d.shape) for li, ps in own.items()
                       for i, d in ps]
            self._send_msg(self._sock, (self._seq, headers))
            for ps in own.values():
                for _i, d in ps:
                    self._sock.sendall(d.nbytes.to_bytes(8, "little"))
                    if d.nbytes:
                        self._sock.sendall(memoryview(d.reshape(-1).view(np.uint8)))
            return None

        headers = self._recv_headers()
        for peer, (seq, _h) in headers.items():
            if seq != self._seq:
                raise RuntimeError(f"writer-gather out of lockstep: rank {peer} at seq "
                                   f"{seq}, writer at {self._seq}")
        # the global arrays from every piece's shape, preallocated; then each piece
        # placed as it arrives: peak memory = the globals plus one piece
        fulls = {}  # leaf -> (global array, axis, offset of each shard id along it)
        for li, ps in own.items():
            shapes = {i: d.shape for i, d in ps}
            for _seq, hdrs in headers.values():
                shapes.update({i: shape for hli, i, _dt, shape in hdrs if hli == li})
            ids = sorted(shapes)
            if ids != list(range(len(ids))):
                raise RuntimeError(f"writer-gather: shards {ids} of leaf {li} do not "
                                   f"cover 0..{len(ids) - 1}")
            ax = leaves[li].axis % len(shapes[0])
            offs = np.cumsum([0] + [shapes[i][ax] for i in ids])
            shape = list(shapes[0])
            shape[ax] = int(offs[-1])
            fulls[li] = (np.empty(shape, ps[0][1].dtype), ax, offs)
            for i, d in ps:
                _place(fulls[li], i, d)
        for peer, (_seq, hdrs) in headers.items():
            conn = self._conns[peer]
            for li, i, dtype_str, shape in hdrs:
                n_bytes = int.from_bytes(self._recv_n(conn, 8, peer), "little")
                piece = np.empty(shape, np.dtype(dtype_str))
                if piece.nbytes != n_bytes:
                    raise RuntimeError(
                        f"writer-gather: rank {peer} announced a {piece.dtype}{shape} shard "
                        f"({piece.nbytes} B) but sent {n_bytes} B (seq {self._seq})")
                if n_bytes:
                    self._recv_into(conn, memoryview(piece.reshape(-1).view(np.uint8)),
                                    peer)
                if li not in fulls:
                    raise RuntimeError(f"writer-gather: rank {peer} sent a shard of leaf "
                                       f"{li}, which is not sharded on the writer")
                _place(fulls[li], i, piece)
        out = [fulls[li][0] if li in fulls else _np(x) if isinstance(x, torch.Tensor) else x
               for li, x in enumerate(leaves)]
        return _unflatten(spec, out)

    def close(self) -> None:
        for conn in self._conns.values():
            try:
                conn.close()
            except OSError:
                pass
        for s in (self._sock, self._srv):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self._conns = {}
        self._sock = self._srv = None

    def __del__(self):  # best effort; the driver closes it explicitly
        self.close()
