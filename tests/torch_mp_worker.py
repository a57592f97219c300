"""One rank of the port's multi-process tests (tests/test_torch_multiprocess.py,
tests/test_torch_multiprocess_cards.py), run as a subprocess over gloo on the CPU.
Imports no jax.

    python tests/torch_mp_worker.py encode <rank> <nprocs> <port> <out.npz>
        `encode_sharded` over the ranks, `gather_frames` to every rank; rank 0 saves the
        frames.
    python tests/torch_mp_worker.py trade <rank> <nprocs> <port> <C> <out>
        a mesh of C CPU shards a rank: the pencil's trades of `trade_parts` and the
        reductions of `reduce_values` over it; each rank saves its results to
        <out>.<rank>.npz.
    python tests/torch_mp_worker.py graphs <rank> <nprocs> <port> <C> <in.h5> <out>
        the run of <in.h5> (extended to `GRAPHS_NT` steps, sampling from `GRAPHS_START`)
        on C CPU shards a rank, its windows and lead-in through `graphs.Graphs` with the
        CUDA steps replaced (`torch_helpers.EagerCards`), then every window eager; rank 0
        writes <out>.graphs.h5 and <out>.eager.h5, each rank <out>.<rank>.npz (the graph
        run's window actions and the time index of every launch).
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


PAIRS = ((1, 0), (0, 1))  # the pencil's (split_dim, concat_dim): z for y, y for z


def trade_parts(shard: int, size: int, split_dim: int, dtype: str):
    """Shard ``shard``'s part of a mesh of ``size`` shards for a trade along
    ``split_dim`` (``[2, 2 * size, 3]`` or its mirror), real or complex, from its seed."""
    import torch

    shape = (2, 2 * size, 3) if split_dim == 1 else (2 * size, 2, 3)
    rng = np.random.default_rng(1000 * shard + split_dim)
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "complex64":
        x = x + 1j * rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(x))


def reduce_values(who: int, op: str):
    """One value a shard or a process (``who``) to reduce: integers in float32 for a
    sum (exact in any order), else normal samples."""
    import torch

    rng = np.random.default_rng(77 + who)
    x = rng.integers(-50, 50, 5) if op == "sum" else rng.standard_normal(5)
    return torch.from_numpy(x.astype(np.float32))


def trade(rank: int, nprocs: int, port: str, local: int, out: str) -> int:
    import torch.distributed as dist

    from kwave_tpu_torch.parallel import make_mesh
    from kwave_tpu_torch.parallel.distributed import initialize

    initialize(f"localhost:{port}", nprocs, rank, "cpu")
    mesh = make_mesh(nprocs * local, devices=["cpu"] * local)
    assert mesh.size == nprocs * local, mesh
    assert mesh.shard_ids == [rank * local + k for k in range(local)], mesh
    res = {}
    for split, concat in PAIRS:
        for dtype in ("float32", "complex64"):
            parts = [trade_parts(g, mesh.size, split, dtype) for g in mesh.shard_ids]
            for g, x in zip(mesh.shard_ids, mesh.comm.all_to_all(parts, split, concat)):
                res[f"trade/{split}{concat}/{dtype}/{g}"] = x.numpy()
    for op in ("sum", "max", "min"):
        got = mesh.comm.all_reduce([reduce_values(g, op) for g in mesh.shard_ids], op)
        for g, x in zip(mesh.shard_ids, got):
            res[f"shards/{op}/{g}"] = x.numpy()
        (x,) = mesh.comm.all_reduce([reduce_values(100 + rank, op)], op)
        res[f"process/{op}/{rank}"] = x.numpy()
    res["str"] = np.array(str(mesh))
    np.savez(f"{out}.{rank}.npz", **res)
    dist.destroy_process_group()
    return 0


GRAPHS_START, GRAPHS_NT = 21, 84  # a lead-in of 20 steps, 6 windows of 10, a tail of 3
GRAPHS_RUN = dict(flags=dict(p_raw=True, p_c=True, p_max_all=True, p_final=True),
                  period=10.0, harmonics=2, mode40=True, sampling_start=GRAPHS_START)


def graphs(rank: int, nprocs: int, port: str, local: int, inp: str, out: str) -> int:
    import dataclasses

    import torch.distributed as dist

    from kwave_tpu_torch import driver
    from kwave_tpu_torch import graphs as kgraphs
    from kwave_tpu_torch.io.input_file import read_input_file
    from kwave_tpu_torch.parallel import Mesh, make_mesh
    from kwave_tpu_torch.parallel.distributed import initialize
    from torch_helpers import EagerCards

    # every shard declared to lie on a card: the mesh and the step graph them
    step_mod = sys.modules["kwave_tpu_torch.solver.step"]
    Mesh.graph_devices = property(lambda self: tuple(self.devices))
    step_mod.graph_devices = lambda state: tuple(x.device for x in state.p.shards)
    driver.Graphs = kgraphs.Graphs = EagerCards
    initialize(f"localhost:{port}", nprocs, rank, "cpu")
    mesh = make_mesh(nprocs * local, devices=["cpu"] * local)
    data = read_input_file(inp)
    data.grid = dataclasses.replace(data.grid, nt=GRAPHS_NT)
    log: list = []
    for cuda_graphs in (True, False):
        kind = "graphs" if cuda_graphs else "eager"
        driver.run_simulation(data, driver.RunConfig(**GRAPHS_RUN, cuda_graphs=cuda_graphs),
                              f"{out}.{kind}.h5", device="cpu", mesh=mesh,
                              window_log=log if cuda_graphs else None)
    np.savez(f"{out}.{rank}.npz", actions=np.array([(t, a) for w in log for t, a in
                                                   w.actions], dtype=object),
             launches=np.array(EagerCards.launches))
    dist.destroy_process_group()
    return 0


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
    if mode == "trade":
        sys.exit(trade(rank, nprocs, sys.argv[4], int(sys.argv[5]), sys.argv[6]))
    if mode == "graphs":
        sys.exit(graphs(rank, nprocs, sys.argv[4], int(sys.argv[5]), sys.argv[6],
                        sys.argv[7]))
    sys.exit(die(rank, nprocs, sys.argv[sys.argv.index("--") + 1:]))
