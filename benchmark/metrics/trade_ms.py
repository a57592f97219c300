"""The pencil FFT's copies between the cards a step: the device time of the trades'
blocks going from one card to another (`kwave_tpu_torch.parallel.comm.InProcess.all_to_all`,
one ``.to`` a block) over the traced job, summed over the cell's cards, over the steps
and the cards, in ms: one card's mean a step. The blocks of the pencil FFT are strided,
and PyTorch copies a strided block to a card it has peer access to with its copy kernel
(``direct_copy_kernel_cuda``) on the source card, writing over the link; a contiguous
block would be one ``Memcpy PtoP``. Both are counted (on the mesh the copy kernel runs
for little else: 1 % of its time outside the trades, in a 37-step job at 512^3). The
receiver's ``torch.cat`` of its blocks is not. None where no such copy appears (one
card, or no trace)."""

PEER_COPY = "Memcpy PtoP"
COPY_KERNEL = "direct_copy_kernel_cuda"


def peer_copy_us(ctx) -> float:
    """Microseconds of copies between cards over the traced job, summed over the cell's
    cards."""
    return sum(d for name, c, _, d in ctx.trace.ops
               if c in ctx.cards and (name.startswith(PEER_COPY) or COPY_KERNEL in name))


def read(ctx):
    if ctx.trace is None or not ctx.traced_steps or len(ctx.cards) < 2:
        return None
    us = peer_copy_us(ctx)
    return us / 1e3 / ctx.traced_steps / len(ctx.cards) if us > 0 else None
