"""The four-card cell's pieces: its configuration against the 128^3 one, its five readers
against a hand-made trace of four cards whose answers are known (and against the same
trace without the program's spans, counter or peer copies, as an older commit gives it),
and the planted faults of `test_portbench_check` written for a mesh, whose sensor
gathers are `Sharded` pieces of unequal length (there those faults index one tensor and
raise in set-up's job instead)."""

import importlib
import json

import pytest
import torch

from benchmark import harness
from benchmark.tests.portbench_helpers import ROOT, run_tiny
from benchmark.trace import Trace

CELL = "het512-p40-devices4"
PTOP = "Memcpy PtoP (Device -> Device)"
COPY = ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
        "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}")
STEPS = 10
# a job of 10 steps from 0 to 1000 us on cards 0-3; card 4 is not the cell's
OPS = [("k", 0, 0.0, 400.0), (COPY, 0, 400.0, 100.0),
       ("k", 1, 0.0, 200.0), (PTOP, 1, 600.0, 100.0),
       (COPY, 2, 100.0, 50.0), (COPY, 2, 150.0, 50.0),
       ("k", 3, 0.0, 1000.0), ("Memcpy DtoD (Device -> Device)", 3, 0.0, 50.0),
       (PTOP, 4, 0.0, 1000.0)]
SPANS = [("job", 0.0, 1000.0),
         ("kwave.operators", 0.0, 50.0), ("kwave.operators.to_device", 0.0, 10.0),
         ("kwave.operators.build", 10.0, 50.0), ("kwave.operators.shard", 60.0, 90.0),
         ("kwave.operatorsX", 90.0, 95.0),  # another name: not the operators'
         ("kwave.edge", 100.0, 200.0), ("kwave.edge", 150.0, 300.0),  # overlapping
         ("kwave.edge", 800.0, 850.0)]
PEER_US = 300.0  # cards 0-2's copies between cards
# one step's bytes between cards at NVLink's 450 GB/s over the copies' time a step
LINK_BYTES = 450e9 * PEER_US / 1e6 / STEPS
WANT = {
    "trade_ms": PEER_US / 1e3 / STEPS / 4,
    "trade_link_share": 100.0,
    "edge_ms": (200.0 + 50.0) / 1e3,
    "mesh_ops_ms": (50.0 + 30.0) / 1e3,
    "cards_idle_share": 100.0 * (0.5 + 0.7 + 0.9 + 0.0) / 4,
}


def _ctx(ops=OPS, spans=SPANS) -> harness.Context:
    trace = Trace(ops=list(ops), spans=list(spans), cpu_ops=[], start=0.0, end=1000.0)
    return harness.Context(cell=None, jobs=[], trace=trace, traced_steps=STEPS,
                           cards=[0, 1, 2, 3])


@pytest.fixture
def counter(monkeypatch):
    """The program's trade counter holding one step of ``LINK_BYTES`` between cards."""
    from kwave_tpu_torch.parallel import comm

    third = LINK_BYTES / 3
    step = {"sent": {k: 2 * third for k in range(4)},
            "between_cards": {k: third for k in range(3)}}
    monkeypatch.setattr(comm.TRADES, "step", step)
    return comm.TRADES


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_gives_the_known_value(name, counter):
    reader = importlib.import_module(f"benchmark.metrics.{name}")
    assert reader.read(_ctx()) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_without_the_programs_spans_counter_or_peer_copies_each_reader_gives_none(
        name, monkeypatch):
    from kwave_tpu_torch.parallel import comm

    monkeypatch.delattr(comm, "TRADES")  # an older commit's program has no counter
    reader = importlib.import_module(f"benchmark.metrics.{name}")
    assert reader.read(harness.Context(cell=None, jobs=[])) is None  # no traced job
    older = [s for s in SPANS if not s[0].startswith("kwave.")]
    no_copies = [op for op in OPS if op[0] not in (PTOP, COPY)]
    got = reader.read(_ctx(no_copies, older))
    assert (got is None) == (name != "cards_idle_share")


def test_the_link_share_needs_both_the_counter_and_the_copies(counter):
    from benchmark.metrics import trade_link_share

    no_copies = [op for op in OPS if op[0] not in (PTOP, COPY)]
    assert trade_link_share.read(_ctx(no_copies)) is None
    counter.step = {"sent": {0: 1}}  # shards of one card: nothing crossed a link
    assert trade_link_share.read(_ctx()) is None


def test_the_link_share_is_at_most_100_at_the_links_rate(counter):
    """Copies that run at 450 GB/s read 100; slower ones less."""
    from benchmark.metrics import trade_link_share

    assert trade_link_share.read(_ctx()) == pytest.approx(100.0)
    slower = [(n, c, s, 2 * d if n in (PTOP, COPY) else d) for n, c, s, d in OPS]
    assert trade_link_share.read(_ctx(slower)) == pytest.approx(50.0)


def test_the_configuration_is_the_128_cells_at_512_on_four_cards():
    def load(name):
        return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())

    small, big = load("het128_index_p40"), load("het512_index_p40")
    assert big["grid"] == [512, 512, 512]
    assert big["flags"] == small["flags"] + ["--devices", "4"]
    assert set(big["reduced"]) == {"Nt"} and big["Nt"] == small["Nt"]
    same = set(small) - {"name", "source", "deployment", "grid", "flags", "assumed",
                         "reduced"}
    assert {k: big[k] for k in same} == {k: small[k] for k in same}
    assert len(big["source"]) <= 200


# --- faults planted under the timed path, written for a mesh ---------------------------


def _pieces(v):
    """A gather's result: its shards' tensors on a mesh, else itself."""
    from kwave_tpu_torch.parallel import Sharded

    return v.shards if isinstance(v, Sharded) else [v]


def _half_the_sensors(monkeypatch):
    """Each shard's gather leaves the second half of its sensors out (zeros)."""
    from kwave_tpu_torch import driver

    real = driver._gather_sources

    def gather(*a, **k):
        out = real(*a, **k)
        for v in out.values():
            for x in _pieces(v):
                x[x.shape[0] // 2:] = 0
        return out

    monkeypatch.setattr(driver, "_gather_sources", gather)


def _one_answer_altered(monkeypatch):
    """One sample of the pressure on the first shard off by a tenth of the field's
    peak."""
    from kwave_tpu_torch import driver

    real = driver._gather_sources

    def gather(*a, **k):
        out = real(*a, **k)
        if "p" in out:
            pieces = _pieces(out["p"])
            peak = max(float(x.abs().max()) for x in pieces if x.numel())
            pieces[0][3] += 0.1 * peak
        return out

    monkeypatch.setattr(driver, "_gather_sources", gather)


@pytest.mark.parametrize("fault", [_half_the_sensors, _one_answer_altered],
                         ids=["half_the_sensors", "one_answer_altered"])
def test_a_broken_gather_on_the_mesh_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = run_tiny(CELL)
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1


def test_the_mesh_cell_runs_its_flags_on_four_shards(monkeypatch):
    """The files entry hands ``--devices 4`` to `cli.main`, which runs a mesh of four
    shards (four CPU shards here, cuda:0-3 on the cards)."""
    from kwave_tpu_torch import cli

    meshes = []
    real = cli.mesh_from_args

    def spy(*a, **k):
        mesh = real(*a, **k)
        meshes.append(mesh)
        return mesh

    monkeypatch.setattr(cli, "mesh_from_args", spy)
    res = run_tiny(CELL)
    assert res["correct"], res["checks"]
    assert meshes and all(m is not None and m.size == 4 and
                          m.devices == [torch.device("cpu")] * 4 for m in meshes)
