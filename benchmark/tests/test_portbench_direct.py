"""`trade_direct_share` against the program's trade counter set by hand: 100 where every
byte sent went by the peer path, its share where part did, and None without the counter,
without its ``direct`` key (an older commit, or the cat path) or where nothing was sent."""

import pytest

from benchmark import harness
from benchmark.metrics import trade_direct_share


def _read():
    return trade_direct_share.read(harness.Context(cell=None, jobs=[]))


@pytest.fixture
def trades(monkeypatch):
    from kwave_tpu_torch.parallel import comm

    monkeypatch.setattr(comm.TRADES, "step", {})
    return comm.TRADES


def test_every_byte_by_the_peer_path_reads_100(trades):
    sent = {k: 3 * 2**20 for k in range(4)}
    trades.step = {"sent": sent, "between_cards": dict(sent), "direct": dict(sent)}
    assert _read() == pytest.approx(100.0)


def test_part_by_the_peer_path_reads_its_share(trades):
    trades.step = {"sent": {0: 300, 1: 100}, "direct": {0: 100}}
    assert _read() == pytest.approx(25.0)


@pytest.mark.parametrize("step", [{}, {"sent": {0: 1, 1: 1}},
                                  {"sent": {}, "direct": {}}],
                         ids=["nothing_counted", "no_direct_key", "nothing_sent"])
def test_without_direct_bytes_to_read_it_gives_none(step, trades):
    trades.step = step
    assert _read() is None


def test_without_the_counter_it_gives_none(monkeypatch):
    from kwave_tpu_torch.parallel import comm

    monkeypatch.delattr(comm, "TRADES")  # an older commit's program has no counter
    assert _read() is None
