"""The trades' copies between the cards against the link, in %: the bytes that one
step's trades send from card to card (the program's counter
`kwave_tpu_torch.parallel.comm.TRADES`, ``step["between_cards"]``, summed over the
source shards), over the device time of those copies a step (`trade_ms`' copies, summed
over the cards), over NVLink's rate in one direction. A card's copies write its blocks
over its links, at most at that rate, so the share cannot pass 100 unless the copies
overlap on one card. None where the program has no such counter (an older commit),
where it counted nothing between cards, or where the trace holds no such copy."""

import importlib

from benchmark.metrics.trade_ms import peer_copy_us

# NVLink 4 on an H100 SXM5, in each direction: 18 links x 25 GB/s (NVIDIA H100 Tensor
# Core GPU data sheet: "NVLink: 900GB/s", both directions together)
LINK_BYTES_PER_S = 450e9


def step_bytes() -> int:
    """The bytes one step sends between cards, by the program's own count (0 without
    it)."""
    try:
        comm = importlib.import_module("kwave_tpu_torch.parallel.comm")
    except ImportError:
        return 0
    step = getattr(getattr(comm, "TRADES", None), "step", None) or {}
    return int(sum(step.get("between_cards", {}).values()))


def read(ctx):
    if ctx.trace is None or not ctx.traced_steps or len(ctx.cards) < 2:
        return None
    n_bytes, us = step_bytes(), peer_copy_us(ctx)
    if n_bytes <= 0 or us <= 0:
        return None
    return 100.0 * n_bytes / (us / 1e6 / ctx.traced_steps) / LINK_BYTES_PER_S
