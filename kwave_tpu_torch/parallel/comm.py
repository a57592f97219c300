"""The mesh's communicators: how shards trade tensors.

- `InProcess`: one process holds all S shards; a trade is a tensor copy between the
  shards' devices (several shards may share a device). The counterpart of ``--devices N``
  on one host and of the JAX tests' virtual CPU devices.
- `ProcessGroup`: `torch.distributed`, C shards a rank (P ranks, S = P·C shards; shard
  r·C + c is rank r's c-th, the order of `jax.devices()` across processes); the trade is
  `dist.all_to_all_single` on one contiguous buffer a shard of this process (NCCL for
  CUDA tensors, gloo for CPU tensors; complex buffers travel as `torch.view_as_real`).

Both take and return lists of this process's shard tensors, in shard order. A trade
neither waits on the host nor allocates outside PyTorch's allocator, so a CUDA graph can
hold it (`Mesh.graph_devices`). `InProcess` takes one of two paths, by the parts' devices
alone: where every shard lies on a CUDA card of its own and every ordered pair of those
cards has peer access, each block is copied straight into its slot of the receiver's
buffer, with the receivers' fences on a side stream a card (`_PeerTrade`); otherwise (the
CPU, shards that share a card, cards without peer access) each block's ``.to`` goes to
the receiver, which concatenates them with `torch.cat` (`_cat`). PyTorch issues a copy
between cards on the source card's current stream, after an event of the destination
card's current stream, and makes the destination's current stream wait for it; in a
capture those streams are the capture's, so the events are the graph's edges. NCCL's
`all_to_all_single` joins the current stream of its buffer's card (the capturing stream
there) by events, with no wait on the host.

`TRADES` counts the bytes that one step's in-process trades send between shards.
"""

from __future__ import annotations

from typing import Any

import torch

_REDUCE = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def _chunks(x: torch.Tensor, s: int, dim: int) -> list[torch.Tensor]:
    if x.shape[dim] % s:
        raise ValueError(f"axis {dim} of length {x.shape[dim]} does not split into {s} "
                         "equal blocks")
    return list(torch.chunk(x, s, dim))


class TradeCounter:
    """A program counter of `InProcess.all_to_all`: the bytes that the trades of one
    solver step send from one shard to another (shard i's block j, i != j), by source
    shard i, in ``step["sent"]``; of those, in ``step["between_cards"]``, the bytes
    whose two shards lie on different devices (each such block is one copy over the link
    between them); and in ``step["direct"]``, the bytes that the peer path (`_PeerTrade`)
    wrote straight into a receiver's slot (the key appears only where that path ran).

    The host counts a trade as it issues it, in an eager window and in a capture's
    recording pass; a replayed graph issues nothing on the host and sends what its
    capture counted. `driver._run_window` brackets each step of a window and its sensor
    gather with `begin_step` and `end_step`: the step's counts then replace the last
    step's (a step that traded nothing, on one device, leaves them)."""

    def __init__(self):
        self.step: dict[str, dict[int, int]] = {}
        self._open: dict[str, dict[int, int]] = {}

    def begin_step(self) -> None:
        self._open = {}

    def end_step(self) -> None:
        if self._open:
            self.step, self._open = self._open, {}

    def _add(self, kind: str, shard: int, n: int) -> None:
        got = self._open.setdefault(kind, {})
        got[shard] = got.get(shard, 0) + n

    def count(self, blocks: list[list[torch.Tensor]], devices: list[torch.device],
              direct: bool = False) -> None:
        """One trade: ``blocks[i][j]`` goes from shard i (on ``devices[i]``) to j, by the
        peer path where ``direct``."""
        for i, row in enumerate(blocks):
            for j, b in enumerate(row):
                if i != j:
                    n = b.numel() * b.element_size()
                    self._add("sent", i, n)
                    if devices[i] != devices[j]:
                        self._add("between_cards", i, n)
                    if direct:
                        self._add("direct", i, n)


TRADES = TradeCounter()


def _receiver(blocks: list[list[torch.Tensor]], j: int,
              concat_dim: int) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Shard j's buffer as `torch.cat` of the blocks it gets makes it (contiguous, on
    shard j's device), left empty, and its slot for each source shard's block."""
    got = [row[j] for row in blocks]
    lengths = [b.shape[concat_dim] for b in got]
    shape = list(got[j].shape)
    shape[concat_dim] = sum(lengths)
    out = torch.empty(shape, dtype=got[j].dtype, device=got[j].device)
    return out, list(torch.split(out, lengths, concat_dim))


def _cat(blocks: list[list[torch.Tensor]], devices: list[torch.device],
         concat_dim: int) -> list[torch.Tensor]:
    """The trade as each receiver's `torch.cat` of its blocks, each brought over by
    ``.to``: on any devices."""
    return [torch.cat([row[j].to(d) for row in blocks], dim=concat_dim)
            for j, d in enumerate(devices)]


class _PeerTrade:
    """The trade of S shards on S CUDA cards with peer access between every ordered pair:
    each block copied once, straight into its slot of the receiver's buffer, with
    PyTorch's own copy.

    PyTorch fences a copy between cards both ways: the source card's current stream waits
    for the destination card's current stream before the copy, and the destination's
    waits for the source's after it. Made on the receivers' current streams, those fences
    chain a trade's copies across the cards (a card's next outgoing copy waits for every
    block it has received). Here each card j has one side stream, which forks from j's
    current stream, copies the block j keeps and is j's current stream for the fences of
    the blocks j receives; j's current stream joins it at the end. A card's outgoing
    copies run one after another on its own current stream (they share its link) and wait
    for none of its incoming ones; they go in S - 1 rounds, card i sending to i + k in
    round k, so that each receiver takes one block a round, after its kept block, and a
    block waits at most for the last round's block into its receiver.

    The side stream's kernel (the kept block) matters in a capture: a stream's capture
    dependencies grow with each event it waits on until a kernel lands on it, and a side
    stream with none would make each copy depend on every earlier trade's copies in the
    graph (edges that grow with the square of the trades, and a launch that slows with
    them). The side streams are made once and fork from and rejoin the current streams
    by events, so a capture across the cards (`graphs.Graphs`) holds the trade as it
    holds any."""

    def __init__(self, devices: list[torch.device]):
        self.devices = devices
        self.side = [torch.cuda.Stream(d) for d in devices]

    def __call__(self, blocks: list[list[torch.Tensor]],
                 concat_dim: int) -> list[torch.Tensor]:
        s = len(self.devices)
        main = [torch.cuda.current_stream(d) for d in self.devices]
        bufs, slots = zip(*[_receiver(blocks, j, concat_dim) for j in range(s)])
        for j in range(s):
            self.side[j].wait_stream(main[j])
            with torch.cuda.stream(self.side[j]):  # restores j's current stream on exit
                slots[j][j].copy_(blocks[j][j])
        for k in range(1, s):
            for i in range(s):
                j = (i + k) % s
                with torch.cuda.stream(self.side[j]):
                    slots[j][i].copy_(blocks[i][j])
        for j in range(s):
            main[j].wait_stream(self.side[j])
        return list(bufs)


def _peer_trade(devices: list[torch.device]) -> _PeerTrade | None:
    """The peer path for shards on ``devices``, or None where it does not apply: a shard
    off CUDA, two shards on one card, or an ordered pair of cards without peer access.
    Peer access is enabled here by one small copy each way between every pair (PyTorch
    enables a card's access to another at their first copy), eagerly: `run_simulation`'s
    first window on a mesh is eager. Inside a capture the trade's own copies enable it."""
    if any(d.type != "cuda" for d in devices) or len(set(devices)) < len(devices):
        return None
    pairs = [(a, b) for a in devices for b in devices if a != b]
    if not all(torch.cuda.can_device_access_peer(a, b) for a, b in pairs):
        return None
    if not torch.cuda.is_current_stream_capturing():
        for a, b in pairs:
            torch.zeros(1, device=a).to(b)
    return _PeerTrade(devices)


class InProcess:
    """All S shards in this process."""

    rank, n_processes = 0, 1

    def __init__(self, size: int):
        self.size = size
        self._paths: dict[tuple[torch.device, ...], _PeerTrade | None] = {}

    def all_to_all(self, parts: list[torch.Tensor], split_dim: int,
                   concat_dim: int) -> list[torch.Tensor]:
        """Shard i's block j (of S equal blocks along ``split_dim``) goes to shard j, which
        concatenates the blocks it gets along ``concat_dim`` in the order of i: one copy
        of each shard's data. The peer path where the parts' devices allow it (the
        module's docstring), `_cat` elsewhere; both give the same bits."""
        s = self.size
        blocks = [_chunks(p, s, split_dim) for p in parts]
        devices = [p.device for p in parts]
        key = tuple(devices)
        if key not in self._paths:
            self._paths[key] = _peer_trade(devices)
        peer = self._paths[key]
        TRADES.count(blocks, devices, direct=peer is not None)
        if peer is None:
            return _cat(blocks, devices, concat_dim)
        return peer(blocks, concat_dim)

    def all_reduce(self, values: list[torch.Tensor], op: str) -> list[torch.Tensor]:
        """Elementwise ``op`` ("sum", "max", "min") over ``values``, this process's
        contributions: one a shard in shard order, or any other count (one value for
        the whole process, as the driver's stop flag). Returns the result once a value
        given, each on that value's device."""
        acc = values[0]
        for v in values[1:]:
            acc = _REDUCE[op](acc, v.to(acc.device))
        return [acc.to(v.device) for v in values]

    def gather_to(self, obj: Any, root: int = 0) -> list[Any]:
        """The one process's ``obj`` as the list of every process's."""
        return [obj]

    def all_gather(self, obj: Any) -> list[Any]:
        return [obj]

    def barrier(self) -> None:
        pass


class ProcessGroup:
    """C shards a rank of the default `torch.distributed` process group: this rank's
    shards lie on ``devices`` (one device a shard, in shard order; one shard where none
    are given), shard r·C + c on rank r's c-th.

    With C > 1 the trade has one group of the P ranks a slot c (made here, in slot order,
    as every rank makes them; under NCCL each bound to the slot's card as it is made, so
    that its communicator exists before the first trade). With C = 1 the one group is the
    default group."""

    def __init__(self, devices=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: call "
                               "kwave_tpu_torch.parallel.distributed.initialize first")
        self._dist = dist
        self.rank, self.n_processes = dist.get_rank(), dist.get_world_size()
        self.backend = dist.get_backend()  # "nccl" or "gloo"
        devices = [torch.device(d) for d in devices] if devices else []
        self.local = max(len(devices), 1)  # C
        self.size = self.n_processes * self.local
        self._groups = [None]  # the default group
        if self.local > 1:
            nccl = self.backend == "nccl"
            bound = getattr(dist.group.WORLD, "bound_device_id", None)
            if nccl and bound is not None and any(d != bound for d in devices):
                raise RuntimeError(
                    f"the default group is bound to {bound}, and PyTorch binds no group to "
                    f"another card: start it with initialize(..., cards={self.local}) for "
                    f"shards on {', '.join(map(str, devices))}")
            ranks = list(range(self.n_processes))
            self._groups = [dist.new_group(ranks, device_id=d if nccl else None)
                            for d in devices]

    def all_to_all(self, parts: list[torch.Tensor], split_dim: int,
                   concat_dim: int) -> list[torch.Tensor]:
        """`InProcess.all_to_all` over the S shards of every rank, in two exact copies. In
        this process each slot c' gathers onto its device one contiguous buffer ``[P, C,
        block]`` (stacked as ``[P·C, block]``) whose entry (r', c) is local shard c's block
        for shard r'·C + c' (peer copies, one ``.to`` a block, as `_cat` issues them);
        across the processes one `all_to_all_single` a slot, on the slot's group, sends
        row r' to rank r'. What slot c' receives is in global shard order, concatenated
        along ``concat_dim``. Every rank issues the slots in the same order."""
        p, c = self.n_processes, self.local
        blocks = [_chunks(x, self.size, split_dim) for x in parts]
        out = []
        for slot, (part, group) in enumerate(zip(parts, self._groups)):
            send = torch.stack([blocks[k][r * c + slot].to(part.device)
                                for r in range(p) for k in range(c)])
            recv = torch.empty_like(send)
            if send.is_complex():
                self._dist.all_to_all_single(torch.view_as_real(recv),
                                             torch.view_as_real(send), group=group)
            else:
                self._dist.all_to_all_single(recv, send, group=group)
            out.append(torch.cat(recv.unbind(0), dim=concat_dim))
        return out

    def all_reduce(self, values: list[torch.Tensor], op: str) -> list[torch.Tensor]:
        """`InProcess.all_reduce` across the processes: this process's ``values`` (one a
        shard, or one for the whole process) reduced here in their order, then one
        `dist.all_reduce` on the default group; the result once a value given, each on
        that value's device. A float sum therefore adds each process's sum; max and min
        are exact."""
        acc = values[0]
        for v in values[1:]:
            acc = _REDUCE[op](acc, v.to(acc.device))
        out = acc.clone()
        self._dist.all_reduce(out, op={"sum": self._dist.ReduceOp.SUM,
                                       "max": self._dist.ReduceOp.MAX,
                                       "min": self._dist.ReduceOp.MIN}[op])
        return [out.to(v.device) for v in values]

    def gather_to(self, obj: Any, root: int = 0) -> list[Any] | None:
        """Every rank's picklable ``obj`` on ``root`` in rank order; None elsewhere."""
        out = [None] * self.n_processes if self.rank == root else None
        self._dist.gather_object(obj, out, dst=root)
        return out

    def all_gather(self, obj: Any) -> list[Any]:
        out = [None] * self.n_processes
        self._dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        self._dist.barrier()
