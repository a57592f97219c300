"""Fused compression-window encode: the reference-exact per-step accumulate of one
compressed stream over one window of sampled steps.

Replaces the TPU window kernels of ``kwave_tpu/ops/encode_pallas.py``:

- `encode_window_40b_exact`: ``_w40_kernel`` (overlap) and ``_w40_noov_kernel``
  (no overlap), entry ``encode_window_40b_exact``: per step, decode both 40-bit
  accumulators, add bE*x and bE_1*x from table row ``parity*o + u``, re-encode; after the
  loop the first window's mirror ``buf2 = encode(c2 + c1)``.
- `encode_window_float_exact`: ``_wfloat_exact_kernel`` and
  ``_wfloat_exact_noov_kernel``, entry ``encode_window_float_exact``: the same loop as an
  fp32 MAC of two complex accumulators (one aliased accumulator without overlap).
- `encode_window_float`: ``_float_kernel``, entry ``encode_window_float``: one window of
  the fast windowed projection (not bit-identical to the reference's MAC order), with
  the first-half projection P1 carried from window to window. Its kernel is
  ``project_window`` of ``csrc/fastpath.cu``, which sums each column as the whole-series
  projection kernel does, so window by window it gives that encode's frames bit for bit.

The kernels are CUDA C++ for sm_90a in ``kwave_tpu_torch/csrc/encode_window.cu``: the
accumulators in registers for the whole window, the window's table columns in shared
memory, the chunk read once and coalesced along the sensors. A window moves under 2 MB, so
what it costs is the launch, one round trip to device memory and the chain of ``steps``
dependent updates; the source says what the design does about each (the 40-bit
accumulators unpacked between steps, the two buffers of a sensor on two lanes, small
blocks that cover the card, every sample of a window loaded before its first step). Every
product and sum is an explicit round-to-nearest intrinsic, so no FMA contraction changes a
bit against the reference's scalar loop.

Beside each kernel sits its plain PyTorch version with the same signature (``*_plain``).
The 40-bit one computes as the kernel does (each buffer a chain of its own, held as floats
between steps by `bitpack.quantize40`); `encode_window_40b_exact_unsplit_plain` is the
reference's loop as written, and the tests hold the two to the same bits. The wrapper takes
the plain version only for tensors on the CPU; on a CUDA tensor it launches the kernel or
raises. The plain versions use no ``addcmul``/``addmm``, which fuse the multiply-add.

Layout: chunk ``[steps, N]`` float32 with ``1 <= steps <= o`` (``steps < o`` is a trailing
partial window, with the mirror off); tabs ``[2o, 4H]`` float32 =
``[bE_re | bE_im | bE1_re | bE1_im]`` columns; planes ``[H, N]``, int32 bit views of the
reference's uint32 words in 40-bit mode, float32 otherwise. ``parity`` and ``mirror`` are
host integers, so one build serves every window.
"""

from __future__ import annotations

import torch

from kwave_tpu_torch import bitpack
from kwave_tpu_torch.ops import fastpath

# Launches of each kernel variant by its wrapper (not by the plain versions).
LAUNCHES = {
    "w40_overlap": 0,
    "w40_no_overlap": 0,
    "wfloat_overlap": 0,
    "wfloat_no_overlap": 0,
    "wfloat_projection": 0,
}

# Exponent offsets of the 40-bit paths: 0 .. MAX_E_CONST (the reference's are 138 and 114).
# Above it a shift count of the pack can wrap in the reference's uint8, which the kernels'
# step between the words (quant40) leaves out; below 0 it is no exponent.
MAX_E_CONST = 234

# Largest window the kernels take: the table slice (steps x 4 floats) must fit the
# 48 KB of shared memory a launch gets without opting in to more.
MAX_STEPS = 48 * 1024 // 16


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _columns(tabs: torch.Tensor, row: int, h: int):
    t = tabs[row]
    return (t[0:h, None], t[h : 2 * h, None], t[2 * h : 3 * h, None],
            t[3 * h : 4 * h, None])


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def encode_window_40b_exact_unsplit_plain(chunk, tabs, planes, e_const: int, parity: int,
                                          mirror: int, overlap: bool = True):
    """The reference's loop as it is written: both buffers in one loop, every accumulator
    unpacked from its words and packed again at every step. `encode_window_40b_exact_plain`
    is held to it bit for bit by the tests."""
    o, h = tabs.shape[0] // 2, tabs.shape[1] // 4
    h1, r1, i1 = planes[:3]
    h2, r2, i2 = planes[3:] if overlap else (None, None, None)
    for u in range(chunk.shape[0]):
        x = chunk[u][None, :]
        t1r, t1i, t2r, t2i = _columns(tabs, parity * o + u, h)
        c1r, c1i = bitpack.decode40(h1, r1, i1, e_const)
        if overlap:
            c2r, c2i = bitpack.decode40(h2, r2, i2, e_const)
            c1r = c1r + t1r * x
            c1i = c1i + t1i * x
            c2r = c2r + t2r * x
            c2i = c2i + t2i * x
            h2, r2, i2 = bitpack.encode40(c2r, c2i, e_const)
        else:
            # cc += (bE*x + bE_1*x): products rounded, summed, then one accumulate
            c1r = c1r + (t1r * x + t2r * x)
            c1i = c1i + (t1i * x + t2i * x)
        h1, r1, i1 = bitpack.encode40(c1r, c1i, e_const)
    if not overlap:
        return h1, r1, i1
    if mirror:
        # first frame: buf2 = encode(c2 + c1) of the last step's values before re-encoding
        h2, r2, i2 = bitpack.encode40(c2r + c1r, c2i + c1i, e_const)
    return h1, r1, i1, h2, r2, i2


def _chain_40b(chunk, tabs, words, e_const: int, parity: int, buffer: int | None):
    """One 40-bit accumulator over the window, as one lane of the kernel carries it: the
    words unpacked once, then per step the MAC and `bitpack.quantize40`, the accumulator
    held as floats. ``buffer`` 0 / 1 takes bE / bE_1 (the two buffers never read each
    other); None is the no-overlap accumulator, which adds the sum of both products.
    Returns the post-MAC floats of the last step, which the caller packs."""
    o, h = tabs.shape[0] // 2, tabs.shape[1] // 4
    qr, qi = bitpack.decode40(*words, e_const)
    for u in range(chunk.shape[0]):
        x = chunk[u][None, :]
        t1r, t1i, t2r, t2i = _columns(tabs, parity * o + u, h)
        if buffer is None:
            # cc += (bE*x + bE_1*x): products rounded, summed, then one accumulate
            cr = qr + (t1r * x + t2r * x)
            ci = qi + (t1i * x + t2i * x)
        else:
            cr = qr + (t2r if buffer else t1r) * x
            ci = qi + (t2i if buffer else t1i) * x
        qr, qi = bitpack.quantize40(cr, ci, e_const)
    return cr, ci


def encode_window_40b_exact_plain(chunk, tabs, planes, e_const: int, parity: int,
                                  mirror: int, overlap: bool = True):
    """The kernel's decomposition: each buffer a chain of its own (`_chain_40b`), the words
    packed once after the last step."""
    if not overlap:
        return bitpack.encode40(*_chain_40b(chunk, tabs, planes[:3], e_const, parity, None),
                                e_const)
    c1r, c1i = _chain_40b(chunk, tabs, planes[:3], e_const, parity, 0)
    c2r, c2i = _chain_40b(chunk, tabs, planes[3:], e_const, parity, 1)
    if mirror:
        # first frame: buf2 = encode(c2 + c1) of the last step's values before re-encoding
        c2r, c2i = c2r + c1r, c2i + c1i
    return bitpack.encode40(c1r, c1i, e_const) + bitpack.encode40(c2r, c2i, e_const)


def encode_window_float_exact_plain(chunk, tabs, planes, parity: int, mirror: int,
                                    overlap: bool = True):
    o, h = tabs.shape[0] // 2, tabs.shape[1] // 4
    a1r, a1i = planes[:2]
    a2r, a2i = planes[2:] if overlap else (None, None)
    for u in range(chunk.shape[0]):
        x = chunk[u][None, :]
        t1r, t1i, t2r, t2i = _columns(tabs, parity * o + u, h)
        a1r = a1r + t1r * x
        a1i = a1i + t1i * x
        if overlap:
            a2r = a2r + t2r * x
            a2i = a2i + t2i * x
        else:
            # aliased buffer: two sequential adds into the same accumulator
            a1r = a1r + t2r * x
            a1i = a1i + t2i * x
    if not overlap:
        return a1r, a1i
    if mirror:
        a2r = a2r + a1r
        a2i = a2i + a1i
    return a1r, a1i, a2r, a2i


# ---------------------------------------------------------------------------
# Wrappers: checks, then the kernel (CUDA) or the plain version (CPU)
# ---------------------------------------------------------------------------


def _check(chunk, tabs, planes, plane_dtype, overlap: bool, parity: int) -> None:
    n_planes = (6 if plane_dtype == torch.int32 else 4) // (1 if overlap else 2)
    if chunk.ndim != 2 or chunk.dtype != torch.float32:
        raise ValueError(f"chunk must be float32 [steps, N]; got {chunk.dtype} "
                         f"{tuple(chunk.shape)}")
    if tabs.ndim != 2 or tabs.dtype != torch.float32 or tabs.shape[0] % 2 \
            or tabs.shape[1] % 4:
        raise ValueError(f"tabs must be float32 [2o, 4H]; got {tabs.dtype} "
                         f"{tuple(tabs.shape)}")
    steps, n = chunk.shape
    o, h = tabs.shape[0] // 2, tabs.shape[1] // 4
    if not 1 <= steps <= o:
        raise ValueError(f"chunk holds {steps} steps; the window takes 1..{o}")
    if steps > MAX_STEPS:
        raise ValueError(f"window of {steps} steps exceeds the kernel's {MAX_STEPS}")
    if parity not in (0, 1):
        raise ValueError(f"parity must be 0 or 1; got {parity!r}")
    if len(planes) != n_planes:
        raise ValueError(f"expected {n_planes} planes; got {len(planes)}")
    for t in (chunk, tabs, *planes):
        if t.device != chunk.device:
            raise ValueError(f"all tensors must be on {chunk.device}; got {t.device}")
        if not t.is_contiguous():
            raise ValueError("all tensors must be contiguous")
    for p in planes:
        if p.dtype != plane_dtype or tuple(p.shape) != (h, n):
            raise ValueError(f"planes must be {plane_dtype} [{h}, {n}]; got {p.dtype} "
                             f"{tuple(p.shape)}")
    if chunk.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {chunk.device}")


def check_e_const(e_const: int) -> None:
    if not 0 <= e_const <= MAX_E_CONST:
        raise ValueError(f"e_const must be in 0..{MAX_E_CONST}; got {e_const}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _kernel_40b(chunk, tabs, planes, e_const: int, parity: int, mirror: int, overlap: bool):
    """Launch the 40-bit window kernel on checked CUDA tensors."""
    from kwave_tpu_torch.ops import _build

    lib = _build.load_library()
    outs = tuple(torch.empty_like(p) for p in planes)
    ins = planes + (None,) * (6 - len(planes))
    outs6 = outs + (None,) * (6 - len(outs))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    steps, n = chunk.shape
    with torch.cuda.device(chunk.device):
        err = lib.kw_encode_window_40b(
            chunk.data_ptr(), tabs.data_ptr(), *map(ptr, ins), *map(ptr, outs6),
            steps, tabs.shape[0] // 2, tabs.shape[1] // 4, n, int(e_const), int(parity),
            int(bool(mirror)), int(bool(overlap)), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "encode_window_40b_exact")
    return outs


def encode_window_40b_exact(chunk, tabs, planes, e_const: int, parity: int, mirror: int,
                            overlap: bool = True):
    """One window of the reference-exact packed-accumulator path. ``planes`` is
    (hdr1, mr1, mi1[, hdr2, mr2, mi2]); returns the updated planes (frame emission and
    zeroing stay in `kwave_tpu_torch.encoder`)."""
    planes = tuple(planes)
    _check(chunk, tabs, planes, torch.int32, overlap, parity)
    check_e_const(e_const)
    if chunk.shape[1] == 0:  # no sensor (a mesh shard whose slab holds none): no work
        return planes
    if chunk.device.type == "cpu":
        return encode_window_40b_exact_plain(chunk, tabs, planes, e_const, parity, mirror,
                                             overlap)
    outs = _kernel_40b(chunk, tabs, planes, e_const, parity, mirror, overlap)
    LAUNCHES["w40_overlap" if overlap else "w40_no_overlap"] += 1
    return outs


def _kernel_float(chunk, tabs, planes, parity: int, mirror: int, overlap: bool):
    """Launch the float window kernel on checked CUDA tensors."""
    from kwave_tpu_torch.ops import _build

    lib = _build.load_library()
    outs = tuple(torch.empty_like(p) for p in planes)
    ins = planes + (None,) * (4 - len(planes))
    outs4 = outs + (None,) * (4 - len(outs))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    steps, n = chunk.shape
    with torch.cuda.device(chunk.device):
        err = lib.kw_encode_window_float(
            chunk.data_ptr(), tabs.data_ptr(), *map(ptr, ins), *map(ptr, outs4),
            steps, tabs.shape[0] // 2, tabs.shape[1] // 4, n, int(parity),
            int(bool(mirror)), int(bool(overlap)), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "encode_window_float_exact")
    return outs


def encode_window_float_exact(chunk, tabs, planes, parity: int, mirror: int,
                              overlap: bool = True):
    """One window of the reference-exact float accumulate path. ``planes`` is
    (acc1_re, acc1_im[, acc2_re, acc2_im]); returns the updated planes."""
    planes = tuple(planes)
    _check(chunk, tabs, planes, torch.float32, overlap, parity)
    if chunk.shape[1] == 0:  # no sensor (a mesh shard whose slab holds none): no work
        return planes
    if chunk.device.type == "cpu":
        return encode_window_float_exact_plain(chunk, tabs, planes, parity, mirror,
                                               overlap)
    outs = _kernel_float(chunk, tabs, planes, parity, mirror, overlap)
    LAUNCHES["wfloat_overlap" if overlap else "wfloat_no_overlap"] += 1
    return outs


def encode_window_float_plain(chunk, tab_lo, tab_hi, p1_prev, first_window: bool = False):
    h2 = tab_lo.shape[1]
    p = fastpath.project_windows_plain(chunk[None], torch.cat([tab_lo, tab_hi], dim=1))[0]
    p1, p2 = p[:h2], p[h2:]
    # frame = P1_prev + P2; the first window uses its own P1 (mirror identity)
    return (p1 if first_window else p1_prev) + p2, p1


def encode_window_float(chunk, tab_lo, tab_hi, p1_prev, first_window: bool = False):
    """One window of the fast projection: chunk [o, N], tab_lo/tab_hi [o, 2H], p1_prev
    [2H, N] (ignored when ``first_window``). Returns (frame [2H, N], p1 [2H, N]); pass
    p1 as p1_prev of the next window. Rows [:H] = re, [H:] = im."""
    o, h2 = tab_lo.shape
    if chunk.ndim != 2 or chunk.shape[0] != o or tuple(tab_hi.shape) != (o, h2) or h2 % 2 \
            or tuple(p1_prev.shape) != (h2, chunk.shape[1]):
        raise ValueError(f"expected chunk [o, N], tab_lo/tab_hi [o, 2H], p1_prev [2H, N]; "
                         f"got {tuple(chunk.shape)}, {tuple(tab_lo.shape)}, "
                         f"{tuple(tab_hi.shape)}, {tuple(p1_prev.shape)}")
    dev = fastpath.check_tensors((chunk, tab_lo, tab_hi, p1_prev), h2 // 2, o)
    if dev.type == "cpu":
        return encode_window_float_plain(chunk, tab_lo, tab_hi, p1_prev, first_window)
    # the kernel is the call's one piece of device work: it stages its table columns from
    # the two half tables as they are
    out = fastpath.launch_window_projection(
        *fastpath.as_contiguous(chunk, tab_lo, tab_hi, p1_prev), first_window)
    LAUNCHES["wfloat_projection"] += 1
    return out
