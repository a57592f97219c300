"""Decoder: coefficient unpacking, basis-synthesis reconstruction, coefficient-space
intensity (port of `kwave_tpu.decoder`).

- `decode_frames_40b` / `decode_40bit_rows`: packed planes or dataset rows -> fp32
  complex planes (integer unpack, bit-exact on any device; CompressHelper.cpp:224-284).
- `reconstruct` / `reconstruct_frames` / `reconstruct_series`: the overlap-add synthesis
  that inverts the windowed projection. Every entry goes through one launch of the
  synthesis kernel (`kwave_tpu_torch.ops.fastpath`; its plain contraction on the CPU),
  which writes the series once with the ``o/2`` normalisation folded into the table.
- `avg_intensity_update` / `avg_intensity_frames` / `avg_intensity_40b`: time-averaged
  intensity ``I = mean_c sum_h Re(cP * conj(cU)) / 2`` straight from coefficient space
  (IndexOutputStream.cpp:299-342, :482-490).

Layout: coefficient frames ``[..., H, N]`` (harmonics, sensors), packed frames
``[Nc, 2H, N]`` with rows ``[:H]`` = re, ``[H:]`` = im; basis tables time-major ``[2o, H]``
as `kwave_tpu_torch.encoder.make_tables` gives them. 40-bit planes are int32 tensors
holding the reference's uint32 bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kwave_tpu_torch import bitpack
from kwave_tpu_torch.basis import MAX_EXP_P, MAX_EXP_U, CompressionBasis
from kwave_tpu_torch.encoder import make_tables
from kwave_tpu_torch.ops import fastpath


def decode_frames_40b(hdr: torch.Tensor, mr: torch.Tensor, mi: torch.Tensor, e: int):
    """Unpack 40-bit coefficient planes ``[..., H, N]`` -> fp32 (re, im)."""
    return bitpack.decode40(hdr, mr, mi, e)


def decode_40bit_rows(rows, harmonics: int, max_exp: int):
    """Packed index-layout dataset rows -> decoded coefficient planes.

    ``rows`` is the float32-viewed ``[n_frames, mSize]`` content of a 40-bit ``*_c``
    dataset (``mSize = ceil(N*1.25)*H`` floats per frame, IndexOutputStream.cpp:91-93);
    returns numpy fp32 ``(re, im)`` of shape ``[n_frames, N, H]``."""
    from kwave_tpu_torch.oracle import bytes_to_soa

    rows = np.ascontiguousarray(rows)
    n_pts = int(rows.shape[1] / (1.25 * harmonics))
    raw = rows.view(np.uint8)[:, : 5 * n_pts * harmonics]
    planes = bytes_to_soa(np.ascontiguousarray(raw).reshape(-1))
    shape3 = (rows.shape[0], n_pts, harmonics)
    re, im = bitpack.decode40(
        *(torch.from_numpy(p.reshape(shape3).astype(np.int32)) for p in planes), max_exp)
    return re.numpy(), im.numpy()


def _tab4(be_re: torch.Tensor, be_im: torch.Tensor, o: int) -> torch.Tensor:
    """[o, 4H] = [bE_re[o:] | bE_im[o:] | bE_re[:o] | bE_im[:o]]: the late half pairs
    with frame k, the early half with frame k+1."""
    return torch.cat([be_re[o:], be_im[o:], be_re[:o], be_im[:o]], dim=1)


def reconstruct_frames(frames: torch.Tensor, be_re: torch.Tensor, be_im: torch.Tensor,
                       o_size: int, n_steps: int, normalized: bool = True,
                       compute: str = "flat") -> torch.Tensor:
    """Overlap-add synthesis from packed coefficient frames ``[Nc, 2H, N]`` (the layout
    `encoder.encode_series_frames` gives) -> ``x[n_steps, N]``:

        x[k*o + r] = scale * sum_h ( C_re[k,h]*bE_re[r+o,h] + C_im[k,h]*bE_im[r+o,h]
                                   + C_re[k+1,h]*bE_re[r,h] + C_im[k+1,h]*bE_im[r,h] )

    with ``scale = o/2`` when ``normalized`` (Parameters.cpp:549-551) and frames past the
    last one zero. "flat" takes the kernel's flat entry, other compute values its 3D
    entry; both are the same kernel."""
    tab = _tab4(be_re.to(frames.device), be_im.to(frames.device), o_size)
    if compute == "flat":
        return fastpath.reconstruct_series_flat(frames, tab, o_size, n_steps, normalized)
    return fastpath.reconstruct_series(frames, tab, o_size, n_steps, normalized,
                                       compute=compute)


def reconstruct(f_re: torch.Tensor, f_im: torch.Tensor, be_re: torch.Tensor,
                be_im: torch.Tensor, o_size: int, n_steps: int, normalized: bool = True,
                compute: str = "flat") -> torch.Tensor:
    """`reconstruct_frames` from split frames ``f_re``/``f_im`` ``[Nc, H, N]`` (one concat
    of the small coefficient side)."""
    return reconstruct_frames(torch.cat([f_re, f_im], dim=1), be_re, be_im, o_size,
                              n_steps, normalized, compute)


def reconstruct_series(frames_re, frames_im, basis: CompressionBasis, shifted: bool,
                       n_steps: int, device: Optional[torch.device | str] = None):
    """Convenience wrapper: frames ``[Nc, H, N]`` (numpy or tensors) + CompressionBasis ->
    ``x[n_steps, N]`` on ``device`` (default: the frames' device, the CPU for numpy)."""
    if device is None:
        device = frames_re.device if isinstance(frames_re, torch.Tensor) else "cpu"
    f_re, f_im = (torch.as_tensor(f, dtype=torch.float32, device=device)
                  for f in (frames_re, frames_im))
    tables = make_tables(basis, shifted, device)
    return reconstruct(f_re, f_im, tables["be_re"], tables["be_im"], basis.o_size, n_steps,
                       basis.normalized)


def avg_intensity_update(acc, cp_re, cp_im, cu_re, cu_im):
    """One per-frame accumulation: ``acc[i] += sum_h Re(cP * conj(cU)) / 2`` over one
    frame's ``[H, N]`` planes (IndexOutputStream.cpp:315-341)."""
    return acc + torch.sum(cp_re * cu_re + cp_im * cu_im, dim=0) * 0.5


def avg_intensity_frames(cp_re, cp_im, cu_re, cu_im):
    """All frames ``[Nc, H, N]`` -> time-averaged intensity ``[N]``: Nc
    `avg_intensity_update` calls then the postProcess divide (IndexOutputStream.cpp:485-489)."""
    n_c = cp_re.shape[0]
    total = torch.sum(cp_re * cu_re + cp_im * cu_im, dim=(0, 1)) * 0.5
    return total / n_c


def avg_intensity_40b(p_planes, u_planes, e_p: int = MAX_EXP_P, e_u: int = MAX_EXP_U):
    """40-bit variant: unpack both packed streams, then `avg_intensity_frames`."""
    cp = bitpack.decode40(*p_planes, e_p)
    cu = bitpack.decode40(*u_planes, e_u)
    return avg_intensity_frames(cp[0], cp[1], cu[0], cu[1])
