"""`Sharded`: this process's shards of one value on a mesh, one tensor a shard (the
counterpart of a JAX array's addressable shards).

A torch function or tensor method applied to a `Sharded` runs once per shard, each call on
that shard's tensors: other `Sharded` arguments give their own shard, anything else is
passed to every call as it is (`__torch_function__`, PyTorch's override protocol). So the
solver's step runs unchanged on z-slabs and y-blocks; the spectral transforms, which need
the other shards, go through the mesh's pencil FFT. A result that is not a tensor (a
shape, a dtype, a device) must be the same on every shard, or the call raises.

``ids`` (the shards' global indices) and ``axis`` (the axis along which the shards make up
the global value) are set where a value is sharded on purpose (`parallel.mesh`), and are
read by the gathers (`parallel.distributed`); the results of operations carry neither.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch


def _count(a, n: Optional[int]) -> Optional[int]:
    if isinstance(a, Sharded):
        if n is not None and n != len(a.shards):
            raise ValueError(f"Sharded values of {n} and {len(a.shards)} shards meet")
        return len(a.shards)
    if isinstance(a, (list, tuple)):
        for x in a:
            n = _count(x, n)
    elif isinstance(a, dict):
        for x in a.values():
            n = _count(x, n)
    return n


def _pick(a, i: int):
    if isinstance(a, Sharded):
        return a.shards[i]
    if isinstance(a, (list, tuple)):
        return type(a)(_pick(x, i) for x in a)
    if isinstance(a, dict):
        return {k: _pick(v, i) for k, v in a.items()}
    return a


def _wrap(outs: list, what: str):
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return Sharded(outs)
    if first is None:
        return None
    if isinstance(first, (tuple, list)) and first and isinstance(first[0], torch.Tensor):
        return type(first)(Sharded(col) for col in zip(*outs))
    if any(o != first for o in outs[1:]):
        raise ValueError(f"{what}: the shards disagree ({outs})")
    return first


def shard_map(fn, *args, **kwargs):
    """``fn`` once per shard, on the shards' tensors; results wrapped as `Sharded`."""
    n = _count(kwargs, _count(args, None))
    if n is None:
        return fn(*args, **kwargs)
    outs = [fn(*_pick(args, i), **_pick(kwargs, i)) for i in range(n)]
    return _wrap(outs, getattr(fn, "__name__", str(fn)))


def _per_shard(name: str):
    """The tensor operator ``name`` (``__add__``, ...) applied shard by shard."""
    op = getattr(torch.Tensor, name)

    def method(self, *args):
        return shard_map(op, self, *args)

    method.__name__ = name
    return method


class Sharded:
    """Shards of one value, in shard order (see the module docstring)."""

    __slots__ = ("shards", "ids", "axis")

    def __init__(self, shards: Sequence[torch.Tensor], ids: Optional[Sequence[int]] = None,
                 axis: Optional[int] = None):
        self.shards = list(shards)
        self.ids = None if ids is None else list(ids)
        self.axis = axis
        if self.ids is not None and len(self.ids) != len(self.shards):
            raise ValueError(f"{len(self.shards)} shards with {len(self.ids)} ids")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return shard_map(func, *args, **(kwargs or {}))

    def __getattr__(self, name: str) -> Any:
        # tensor attributes and methods, shard by shard (only names that are not slots)
        if name.startswith("__"):
            raise AttributeError(name)
        values = [getattr(s, name) for s in self.shards]
        if callable(values[0]) and not isinstance(values[0], torch.Tensor):
            def method(*args, **kwargs):
                _count(kwargs, _count(args, len(values)))  # raises on other shard counts
                return _wrap([v(*_pick(args, i), **_pick(kwargs, i))
                              for i, v in enumerate(values)], name)
            return method
        return _wrap(values, name)

    def __repr__(self) -> str:
        return (f"Sharded({len(self.shards)} shards, ids={self.ids}, axis={self.axis}, "
                f"shapes={[tuple(s.shape) for s in self.shards]})")

    def __setitem__(self, key, value) -> None:
        shard_map(torch.Tensor.__setitem__, self, key, value)

    __hash__ = object.__hash__
    __getitem__ = _per_shard("__getitem__")
    __add__, __radd__ = _per_shard("__add__"), _per_shard("__radd__")
    __sub__, __rsub__ = _per_shard("__sub__"), _per_shard("__rsub__")
    __mul__, __rmul__ = _per_shard("__mul__"), _per_shard("__rmul__")
    __truediv__, __rtruediv__ = _per_shard("__truediv__"), _per_shard("__rtruediv__")
    __pow__, __rpow__ = _per_shard("__pow__"), _per_shard("__rpow__")
    __neg__ = _per_shard("__neg__")
    __eq__, __ne__ = _per_shard("__eq__"), _per_shard("__ne__")
    __lt__, __le__ = _per_shard("__lt__"), _per_shard("__le__")
    __gt__, __ge__ = _per_shard("__gt__"), _per_shard("__ge__")
    __and__, __or__, __invert__ = _per_shard("__and__"), _per_shard("__or__"), _per_shard("__invert__")
