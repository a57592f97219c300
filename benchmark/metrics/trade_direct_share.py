"""The share of the trades' bytes that went straight into the receivers' buffers, in %:
the bytes that one step's trades copied by the peer path into a receiver's slot (the
program's counter `kwave_tpu_torch.parallel.comm.TRADES`, ``step["direct"]``), over the
bytes they sent from one shard to another (``step["sent"]``), each summed over the source
shards. 100 where every block went by the peer path, 0 where the counter has the key and
none did. None where the program has no such counter or key (an older commit, or a trade
that only concatenates) or sent nothing."""

import importlib


def read(ctx):
    try:
        comm = importlib.import_module("kwave_tpu_torch.parallel.comm")
    except ImportError:
        return None
    step = getattr(getattr(comm, "TRADES", None), "step", None) or {}
    sent = sum(step.get("sent", {}).values())
    if "direct" not in step or sent <= 0:
        return None
    return 100.0 * sum(step["direct"].values()) / sent
