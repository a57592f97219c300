"""The benchmark's four-card cell (``het512-p40-devices4``) rehearsed on the CPU: its
configuration at 16^3 on a 4-shard CPU mesh with compact operators (the path the 512^3
jobs take), through `run_simulation` as `cli.main --devices 4` calls it.

The run is held to the benchmark's plain reference (`benchmark.reference.kspace`, float64)
and to the codec oracle's words at the cell's own limits (`benchmark.harness.numbers`),
and the reference in bfloat16 in the program's place fails them. The trade counter
(`parallel.comm.TRADES`) is held to a count made by hand for that mesh, and the mesh's
spans (`kwave.edge`, `kwave.operators.shard`) open where a profiler runs (recorded by a
stand-in for `record_function`: the profiler itself takes half a minute over a CPU mesh's
ops). No JAX here.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from benchmark import control, harness
from benchmark.memgroup import MemGroup
from kwave_tpu_torch import params
from kwave_tpu_torch.driver import run_simulation
from kwave_tpu_torch.parallel import comm, make_mesh
from torch_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

CELL = "het512-p40-devices4"
SEED = 2**31 + 977  # larger than 32 signed bits hold, as the benchmark's seeds are
S, N = 4, 16
TRADES_A_STEP = 14  # 6 forward transforms and 8 inverse ones a step, one trade each
SPANS = ("kwave.edge", "kwave.operators.shard", "kwave.operators")


def _cell() -> harness.Cell:
    """The cell at 16^3 with 200 sensors and jobs of 4 windows and a 5-step tail (as the
    benchmark's own CPU tests cut it); every other setting the cell's."""
    cell = harness.load_cell(CELL)
    cell.config.update(grid=[N, N, N], pml_size=4, sensors=200, oracle_sensors=50,
                       Nt=4 * int(cell.config["period"]) + 5)
    return cell


@contextlib.contextmanager
def _spans():
    """The names of the spans that open inside, as a recording profiler receives them
    (`observability.span` asks `torch.autograd._profiler_enabled` and opens
    `torch.profiler.record_function`)."""
    names: list = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.autograd, "_profiler_enabled", lambda: True)
        mp.setattr(torch.profiler, "record_function",
                   lambda name: names.append(name) or contextlib.nullcontext())
        yield names


def _run(cell, inputs, mesh=None):
    """One job of ``cell`` as the files entry runs it (its flags; a mesh for
    ``--devices``), into memory, with compact operators: (datasets, span names)."""
    data = harness._input_data(inputs, cell.steps)
    args = params.build_parser().parse_args(["-i", "-", "-o", "-", *cell.config["flags"]])
    run = dataclasses.replace(params.args_to_run_config(args, dt=data.grid.dt),
                              compact_operators=True)
    out = MemGroup()
    with _spans() as names:
        run_simulation(data, run, out, device="cpu", mesh=mesh)
    return harness._datasets(out), set(names)


@pytest.fixture(scope="module")
def job():
    cell = _cell()
    cpu = torch.device("cpu")
    inputs = harness.make_inputs(cell, SEED, cpu)
    assert "--devices" in cell.config["flags"]
    comm.TRADES.step = {}
    got, spans = _run(cell, inputs, make_mesh(S, devices=["cpu"] * S))
    return cell, inputs, got, spans, dict(comm.TRADES.step)


def test_the_compact_mesh_job_agrees_with_the_plain_reference(job):
    cell, inputs, got, _, _ = job
    ref = harness.reference_outputs(cell, inputs, torch.device("cpu"))
    numbers = harness.numbers(cell, inputs, SEED, [got], ref)[0]
    limits = harness.limits(cell)
    assert set(numbers) == set(limits) == {"p_raw_gap", "p_c_gap", "p_c_bytes_off",
                                           "layout_off"}
    for k, v in numbers.items():
        assert v <= limits[k], (k, v, limits[k])
    assert np.abs(got["p"][0]).max() > 0


def test_the_bfloat16_control_fails_the_cells_limits():
    cell = _cell()
    numbers = control.control_numbers(cell, SEED, torch.device("cpu"))
    limits = harness.limits(cell)
    assert any(numbers[k] > limits[k] for k in numbers), numbers


def test_the_trade_counter_gives_a_steps_bytes_by_hand(job):
    """A trade sends each shard's S - 1 blocks of the spectrum [16, 16, 9] complex64 that
    belong to other shards: [16/S, 16/S, 9] x 8 bytes each, 14 trades a step. The CPU
    mesh's shards share one device, so nothing crosses a link."""
    *_, step = job
    block = (N // S) * (N // S) * (N // 2 + 1) * 8
    assert step == {"sent": {k: TRADES_A_STEP * (S - 1) * block for k in range(S)}}


def test_the_counter_counts_the_bytes_between_cards():
    """A block between shards of one device is sent, but crosses no link; a step begun
    again before it ended is dropped."""
    cards = [torch.device("cuda", k) for k in (0, 1, 1)]
    blocks = [list(torch.chunk(torch.zeros(3, 6, 2), 3, 1)) for _ in cards]
    n = 3 * 2 * 2 * 4  # bytes a block
    counter = comm.TradeCounter()
    counter.begin_step()
    counter.count(blocks, cards)
    counter.end_step()
    # shard 0 (cuda:0) sends to the two shards of cuda:1, shards 1 and 2 to cuda:0 alone
    want = {"sent": {0: 2 * n, 1: 2 * n, 2: 2 * n}, "between_cards": {0: 2 * n, 1: n, 2: n}}
    assert counter.step == want
    counter.begin_step()
    counter.count(blocks, [torch.device("cuda", 0)] * 3)
    counter.begin_step()
    counter.end_step()
    assert counter.step == want
    counter.begin_step()
    counter.count(blocks, [torch.device("cuda", 0)] * 3)
    counter.end_step()
    assert counter.step == {"sent": want["sent"]}


def test_the_counter_counts_the_peer_paths_bytes_as_direct():
    """A trade by the peer path counts each block it sends as ``direct`` too, by source
    shard; a trade by the cat path leaves the key out."""
    cards = [torch.device("cuda", k) for k in range(3)]
    blocks = [list(torch.chunk(torch.zeros(3, 6, 2), 3, 1)) for _ in cards]
    counter = comm.TradeCounter()
    counter.begin_step()
    counter.count(blocks, cards, direct=True)
    counter.end_step()
    assert counter.step["direct"] == counter.step["sent"] == counter.step["between_cards"]
    counter.begin_step()
    counter.count(blocks, cards)
    counter.end_step()
    assert "direct" not in counter.step


@pytest.mark.parametrize("devices", [["cpu"] * 4, ["cuda:0"] * 2,
                                     ["cuda:0", "cuda:1", "cpu"],
                                     ["cuda:1", "cuda:0", "cuda:1"]],
                         ids=["cpu_mesh", "shards_of_one_card", "a_shard_off_cuda",
                              "two_of_three_on_one_card"])
def test_only_shards_on_cards_of_their_own_take_the_peer_path(devices):
    """The trade's path depends on the parts' devices alone: the CPU, or two shards on one
    card, take the cat path (decided before any CUDA call, so this runs without a card)."""
    assert comm._peer_trade([torch.device(d) for d in devices]) is None


def test_a_cpu_mesh_trades_by_the_cat_path():
    """A 4-shard CPU mesh's trade is `comm._cat`'s bit for bit, and counts no ``direct``
    bytes."""
    mesh = make_mesh(S, devices=["cpu"] * S)
    parts = [torch.randn(2, 8, 3, dtype=torch.complex64,
                         generator=torch.Generator().manual_seed(k)) for k in range(S)]
    comm.TRADES.begin_step()
    got = mesh.comm.all_to_all(parts, 1, 0)
    comm.TRADES.end_step()
    assert mesh.comm._paths == {(torch.device("cpu"),) * S: None}
    assert set(comm.TRADES.step) == {"sent"}
    want = comm._cat([comm._chunks(p, S, 1) for p in parts], mesh.devices, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("layout", ["contiguous", "cufft_strided"])
@pytest.mark.parametrize("split,concat", [(1, 0), (0, 1)], ids=["z_to_y", "y_to_z"])
def test_the_peer_paths_slots_give_the_cat_paths_buffers(split, concat, layout):
    """Each receiver's buffer of the peer path (`comm._receiver`), every block copied into
    its slot, equals the cat path's bit for bit, shape and strides too, from contiguous
    parts and from parts laid out as cuFFT's inverse along z returns them (z innermost):
    the peer path's layout, rehearsed on the CPU."""
    g = torch.Generator().manual_seed(3)
    shape = (4, 16, 5) if split == 1 else (16, 4, 5)
    parts = []
    for _ in range(S):
        x = torch.randn(*shape, dtype=torch.complex64, generator=g)
        if layout == "cufft_strided":
            x = torch.randn(shape[1], shape[2], shape[0], dtype=torch.complex64,
                            generator=g).permute(2, 0, 1)
        parts.append(x)
    blocks = [comm._chunks(p, S, split) for p in parts]
    want = comm._cat(blocks, [torch.device("cpu")] * S, concat)
    for j in range(S):
        out, slots = comm._receiver(blocks, j, concat)
        for i in range(S):
            slots[i].copy_(blocks[i][j])
        assert (out.shape, out.stride()) == (want[j].shape, want[j].stride())
        assert torch.equal(torch.view_as_real(out), torch.view_as_real(want[j]))


def test_the_mesh_spans_appear_under_a_profiler(job):
    *_, spans, _ = job
    assert set(SPANS) <= spans


def test_one_device_has_no_edge_span_and_leaves_the_counter():
    cell = _cell()
    inputs = harness.make_inputs(cell, SEED, torch.device("cpu"))
    before = {"sent": {0: 1}}
    comm.TRADES.step = dict(before)
    _, names = _run(cell, inputs)
    assert "kwave.operators" in names
    assert "kwave.edge" not in names and "kwave.operators.shard" not in names
    assert comm.TRADES.step == before
