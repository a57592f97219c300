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
hold it (`Mesh.graph_devices`): on one card `InProcess` is a `torch.cat` of views (the
`.to` of a block to its own device is the block itself); across cards each `.to` is a
peer copy on the source card's current stream, which PyTorch orders by events after the
destination card's current stream and before the destination's next op (in a capture
those streams are the capture's, so the events are the graph's edges); and NCCL's
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
    shard i, in ``step["sent"]``, and of those, in ``step["between_cards"]``, the bytes
    whose two shards lie on different devices (each such block is one copy over the link
    between them).

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

    def count(self, blocks: list[list[torch.Tensor]], devices: list[torch.device]) -> None:
        """One trade: ``blocks[i][j]`` goes from shard i (on ``devices[i]``) to j."""
        for i, row in enumerate(blocks):
            for j, b in enumerate(row):
                if i != j:
                    n = b.numel() * b.element_size()
                    self._add("sent", i, n)
                    if devices[i] != devices[j]:
                        self._add("between_cards", i, n)


TRADES = TradeCounter()


class InProcess:
    """All S shards in this process."""

    rank, n_processes = 0, 1

    def __init__(self, size: int):
        self.size = size

    def all_to_all(self, parts: list[torch.Tensor], split_dim: int,
                   concat_dim: int) -> list[torch.Tensor]:
        """Shard i's block j (of S equal blocks along ``split_dim``) goes to shard j, which
        concatenates the blocks it gets along ``concat_dim`` in the order of i: one copy
        of each shard's data."""
        s = self.size
        blocks = [_chunks(p, s, split_dim) for p in parts]
        TRADES.count(blocks, [p.device for p in parts])
        return [torch.cat([blocks[i][j].to(parts[j].device) for i in range(s)],
                          dim=concat_dim) for j in range(s)]

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
        for shard r'·C + c' (peer copies, issued as `InProcess.all_to_all` issues them);
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
