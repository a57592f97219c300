"""Multi-device parallelism (port of `kwave_tpu.parallel`): the mesh, the field / codec
shardings, the pencil FFT and the writer gather.

The reference is strictly single-GPU (Readme.md:12). Here the solver fields are split
over z into slabs (one a shard), every 3D transform is a pencil FFT whose transposes trade
z for y between the shards, and the codec runs on each shard's own sensors; process 0
writes the file. The shards live in one process (`make_mesh(n)`, or the same device listed
n times) or C a rank of a `torch.distributed` process group of P ranks
(`parallel.distributed.initialize(..., cards=C)`, then `make_mesh(P * C)`).
"""

from kwave_tpu_torch.parallel.mesh import (
    Mesh,
    codec_sharding,
    field_sharding,
    make_mesh,
    pencil_fft,
    replicated,
    shard_operators,
    shard_state,
)
from kwave_tpu_torch.parallel.sharded import Sharded

__all__ = [
    "Mesh",
    "Sharded",
    "make_mesh",
    "field_sharding",
    "codec_sharding",
    "pencil_fft",
    "replicated",
    "shard_operators",
    "shard_state",
]
