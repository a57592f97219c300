"""The 40-bit window encode kernel (K1, `csrc/encode_window.cu` ``w40_window``) against
its roofline, in %: the least time one launch can take over its mean time in the traced
job. A launch encodes one window of ``o`` steps of N sensors at H harmonics; it must read
the window's series (o N float32) and the basis table (2o x 4H float32), and read and
write the encoder's accumulator planes (3 or, with overlap, 6 int32 planes of H x N);
it does 8 float32 operations a step, sensor and harmonic. The larger of bytes over the
HBM rate and operations over the float32 rate is the bound (`benchmark.peaks`)."""

from benchmark import peaks

KERNEL = "w40_window"


def bound_s(o: int, n: int, h: int, overlap: bool = True) -> float:
    planes = (6 if overlap else 3) * h * n * 4
    n_bytes = o * n * 4 + 2 * o * 4 * h * 4 + 2 * planes
    return peaks.bound_s(n_bytes, 8.0 * o * n * h)


def read(ctx):
    if ctx.trace is None:
        return None
    card = ctx.cards[0]
    times = [d for name, c, _, d in ctx.trace.ops if c == card and KERNEL in name]
    if not times:
        return None
    cfg = ctx.cell.config
    n = int(cfg["sensors"])
    mean_s = sum(times) / len(times) / 1e6
    return 100.0 * bound_s(int(cfg["period"]), n, int(cfg.get("harmonics", 1))) / mean_s
