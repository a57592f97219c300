"""The port's worked example (kwave_tpu_torch/examples/end_to_end.py) runs on the CPU and
passes its own gate: the decoded p_c within 5 % of the raw recording on the steady-state
half (as examples/end_to_end.py). Its decode is held against kwave_tpu.decoder on the
same frames, to 4e-6 of the peak."""

import h5py
import jax.numpy as jnp
import numpy as np

from kwave_tpu import decoder as jdec
from kwave_tpu.basis import generate_basis
from kwave_tpu_torch import decoder
from kwave_tpu_torch.examples import end_to_end


def test_port_example_passes_its_gate(tmp_path, capsys):
    assert end_to_end.main(str(tmp_path / "ex"), device="cpu") == 0
    out = capsys.readouterr().out
    assert "roundtrip rel err" in out and "OK" in out

    with h5py.File(tmp_path / "ex" / "output.h5") as f:
        raw, pc = np.asarray(f["p"])[0], np.asarray(f["p_c"])[0]
    coeffs = pc.reshape(pc.shape[0], raw.shape[1], end_to_end.HARMONICS, 2)
    f_re = np.ascontiguousarray(np.transpose(coeffs[..., 0], (0, 2, 1)))
    f_im = np.ascontiguousarray(np.transpose(coeffs[..., 1], (0, 2, 1)))
    cb = generate_basis(end_to_end.PERIOD, 1, end_to_end.HARMONICS, normalize=True)
    mine = decoder.reconstruct_series(f_re, f_im, cb, False, raw.shape[0]).numpy()
    theirs = np.asarray(jdec.reconstruct_series(jnp.asarray(f_re), jnp.asarray(f_im), cb,
                                                False, raw.shape[0]))
    # the transient reaches ~1e9 at sensors near the source, where the fp32 sums cancel:
    # held to 4e-6 of the peak (the codec tolerance of chip_smoke.py against the oracle)
    np.testing.assert_allclose(mine, theirs, rtol=0, atol=4e-6 * np.abs(theirs).max())
