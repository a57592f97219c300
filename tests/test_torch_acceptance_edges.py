"""Acceptance sweep, part `edges`: the inputs of tests/test_edge_cases.py and
tests/test_checkpoint_legs.py. Both CLIs, kwave_tpu.cli and
kwave_tpu_torch.cli (on the CPU), run one input file that each package writes with
kwave_tpu.io.input_file.write_input_file (`acceptance_sweep`).

Every dataset: the same name, shape, dtype, chunks, compression and attributes; float
data within rel L2 1e-4; 40-bit rows decoded by the oracle first. Where a run stores an
index mask's `p` and `p_c`: the port fed the JAX run's series writes the oracle's bytes,
within 1e-5 (float) or rel L2 1e-4 decoded (40-bit) of the JAX file's."""

import pytest

import acceptance_sweep as sweep
from torch_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

NAMES = sweep.names("edges")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sweep.Runs(tmp_path_factory.mktemp("acceptance_edges"))


@pytest.mark.parametrize("name", NAMES)
def test_port_output_matches_jax(runs, name):
    sweep.check_outputs(runs, name)


@pytest.mark.parametrize("name", [n for n in NAMES if sweep.has_p_c_pair(n)])
def test_p_c_bytes_of_the_jax_series(runs, name):
    sweep.check_p_c_bytes(runs, name)
