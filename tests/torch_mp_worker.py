"""One rank of the port's multi-process tests (tests/test_torch_multiprocess.py), run as a
subprocess over gloo on the CPU. Imports no jax.

    python tests/torch_mp_worker.py encode <rank> <nprocs> <port> <out.npz>
        `encode_sharded` over the ranks, `gather_frames` to every rank; rank 0 saves the
        frames.
    python tests/torch_mp_worker.py die <rank> <nprocs> -- <cli arguments>
        the port's CLI, except that the highest rank exits hard (code 17) as it enters
        its second `WriterGather.gather`: the writer must fail naming it.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def encode(rank: int, nprocs: int, port: str, out: str) -> int:
    from kwave_tpu_torch.basis import generate_basis
    from kwave_tpu_torch.parallel import make_mesh
    from kwave_tpu_torch.parallel.distributed import (encode_sharded, gather_frames,
                                                      initialize)

    initialize(f"localhost:{port}", nprocs, rank, "cpu")
    mesh = make_mesh()
    assert mesh.size == nprocs and mesh.shard_ids == [rank], mesh
    x = series(nprocs)
    frames = gather_frames(encode_sharded(x, generate_basis(20.0, 1, 2, normalize=True),
                                          mesh), mesh)
    if rank == 0:
        np.savez(out, re=frames[0], im=frames[1])
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def series(nprocs: int) -> np.ndarray:
    """The sampled series that the encode test shares with its one-process reference."""
    t = np.arange(200, dtype=np.float32)[:, None]
    phase = np.linspace(0, 2 * np.pi, 64 * nprocs + 5, dtype=np.float32)[None, :]
    return (1e5 * np.sin(2 * np.pi * t / 20.0 + phase)).astype(np.float32)


def die(rank: int, nprocs: int, argv: list[str]) -> int:
    from kwave_tpu_torch.cli import main
    from kwave_tpu_torch.parallel.distributed import WriterGather

    if rank == nprocs - 1:
        gather, calls = WriterGather.gather, [0]

        def dying(self, tree):
            calls[0] += 1
            if calls[0] >= 2:
                os._exit(17)
            return gather(self, tree)

        WriterGather.gather = dying
    return main(argv)


if __name__ == "__main__":
    mode, rank, nprocs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    if mode == "encode":
        sys.exit(encode(rank, nprocs, sys.argv[4], sys.argv[5]))
    sys.exit(die(rank, nprocs, sys.argv[sys.argv.index("--") + 1:]))
