"""The mesh's communicators: how shards trade tensors.

- `InProcess`: one process holds all S shards; a trade is a tensor copy between the
  shards' devices (several shards may share a device). The counterpart of ``--devices N``
  on one host and of the JAX tests' virtual CPU devices.
- `ProcessGroup`: `torch.distributed`, one shard a rank; the trade is
  `dist.all_to_all_single` on one contiguous buffer (NCCL for CUDA tensors, gloo for CPU
  tensors; complex buffers travel as `torch.view_as_real`).

Both take and return lists of this process's shard tensors, in shard order. A trade
neither waits on the host nor allocates outside PyTorch's allocator, so a CUDA graph can
hold it (`Mesh.graph_devices`): on one card `InProcess` is a `torch.cat` of views (the
`.to` of a block to its own device is the block itself); across cards each `.to` is a
peer copy on the source card's current stream, which PyTorch orders by events after the
destination card's current stream and before the destination's next op (in a capture
those streams are the capture's, so the events are the graph's edges); and NCCL's
`all_to_all_single` joins the current (the capturing) stream by events, with no wait on
the host.
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
        return [torch.cat([blocks[i][j].to(parts[j].device) for i in range(s)],
                          dim=concat_dim) for j in range(s)]

    def all_reduce(self, values: list[torch.Tensor], op: str) -> list[torch.Tensor]:
        """Elementwise ``op`` ("sum", "max", "min") over the shards; every shard gets the
        result on its own device."""
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
    """One shard a rank of the default `torch.distributed` process group."""

    def __init__(self):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: call "
                               "kwave_tpu_torch.parallel.distributed.initialize first")
        self._dist = dist
        self.rank, self.n_processes = dist.get_rank(), dist.get_world_size()
        self.size = self.n_processes
        self.backend = dist.get_backend()  # "nccl" or "gloo"

    def all_to_all(self, parts: list[torch.Tensor], split_dim: int,
                   concat_dim: int) -> list[torch.Tensor]:
        """`InProcess.all_to_all` across the ranks: the blocks stacked into one contiguous
        buffer, one `all_to_all_single`, the received blocks concatenated."""
        (part,) = parts
        send = torch.stack(_chunks(part, self.size, split_dim))
        recv = torch.empty_like(send)
        if send.is_complex():
            self._dist.all_to_all_single(torch.view_as_real(recv), torch.view_as_real(send))
        else:
            self._dist.all_to_all_single(recv, send)
        return [torch.cat(recv.unbind(0), dim=concat_dim)]

    def all_reduce(self, values: list[torch.Tensor], op: str) -> list[torch.Tensor]:
        (value,) = values
        out = value.clone()
        self._dist.all_reduce(out, op={"sum": self._dist.ReduceOp.SUM,
                                       "max": self._dist.ReduceOp.MAX,
                                       "min": self._dist.ReduceOp.MIN}[op])
        return [out]

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
