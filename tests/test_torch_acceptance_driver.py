"""Acceptance sweep, part `driver`: the inputs of tests/test_driver.py and
tests/test_cli.py. Both CLIs, kwave_tpu.cli and
kwave_tpu_torch.cli (on the CPU), run one input file that each package writes with
kwave_tpu.io.input_file.write_input_file (`acceptance_sweep`).

Every dataset: the same name, shape, dtype, chunks, compression and attributes; float
data within rel L2 1e-4; 40-bit rows decoded by the oracle first. Where a run stores an
index mask's `p` and `p_c`: the port fed the JAX run's series writes the oracle's bytes,
within 1e-5 (float) or rel L2 1e-4 decoded (40-bit) of the JAX file's."""

import pytest

import acceptance_sweep as sweep
from torch_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

NAMES = sweep.names("driver")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sweep.Runs(tmp_path_factory.mktemp("acceptance_driver"))


@pytest.mark.parametrize("name", NAMES)
def test_port_output_matches_jax(runs, name):
    sweep.check_outputs(runs, name)


@pytest.mark.parametrize("name", [n for n in NAMES if sweep.has_p_c_pair(n)])
def test_p_c_bytes_of_the_jax_series(runs, name):
    sweep.check_p_c_bytes(runs, name)


@pytest.mark.parametrize("name", [c.name for c in sweep.ac.CASES if c.base is not None])
def test_input_maker_copy_equals_the_jax_suite_s(tmp_path, name):
    """The card runs `acceptance_cases`' copy of a JAX suite's input maker: field by field
    the same input as the input maker itself returns (with the case's edits)."""
    import dataclasses

    import numpy as np

    c = sweep.ac.case(name)
    want = sweep.jax_input(c, str(tmp_path))
    got = c.fields()
    for f in dataclasses.fields(want):
        if f.name == "source_path":
            continue
        a, b = got.get(f.name, f.default), getattr(want, f.name)
        if f.name in ("grid", "medium"):
            b = dataclasses.asdict(b)
            a = dict(dataclasses.asdict(type(getattr(want, f.name))(**a)))
            assert a.keys() == b.keys(), f.name
            for k in b:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                              err_msg=f"{f.name}.{k}")
        elif isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
        else:
            assert a == b, f.name


class _Group(dict):
    """An in-memory group: members by name, and ``attrs``."""

    def __init__(self, attrs=None, **members):
        super().__init__(members)
        self.attrs = dict(attrs or {})


class _Data:
    def __init__(self, data, attrs=None):
        self.data, self.attrs = data, dict(attrs or {})
        self.shape, self.dtype = data.shape, data.dtype

    def __getitem__(self, key):
        return self.data[key]


def _pair(p, rows, new_p=None, new_rows=None):
    import numpy as np

    attrs40 = {"c_complex_size": np.float32(1.25), "c_harmonics": np.int64(1),
               "c_max_exp": np.int64(138), "c_period": np.float32(10.0),
               "c_mos": np.int64(1)}
    p2 = p if new_p is None else new_p
    rows2 = rows if new_rows is None else new_rows
    return (_Group({"file_type": "output"}, p=_Data(p), p_c=_Data(rows, attrs40)),
            _Group({"file_type": "output"}, p=_Data(p2), p_c=_Data(rows2, attrs40)))


def test_worst_40bit_names_the_coefficient_and_its_distance_in_steps():
    """`worst_40bit` finds the coefficient two 40-bit datasets differ in most, with its
    distance in steps of its word (the step grows with the word's shared exponent), and
    counts the parts by steps apart."""
    import numpy as np

    from kwave_tpu_torch import oracle

    p = np.zeros((1, 20, 8), np.float32)
    vals = np.array([[1.5, -2.0, 0.25, 1.5, 0.75, -0.5, 1.0, 2.5]], np.float32)
    q = sweep.ac.quantum_40bit(138)

    def rows(v):
        raw = oracle.soa_to_bytes(*oracle.encode40(v, np.zeros_like(v), oracle.MAX_EXP_P))
        return np.concatenate([raw, np.zeros(40 - raw.size, np.uint8)]).view(
            np.float32).reshape(1, 1, 10)

    near = vals.copy()
    near[0, 2] += q  # one step
    near[0, 6] += 3 * q  # three steps: the worst
    want, got = _pair(p, rows(vals), new_rows=rows(near))
    w = sweep.ac.worst_40bit(want["p_c"], got["p_c"])
    assert (w["row"], w["sensor"], w["harmonic"], w["part"]) == (0, 6, 0, "re")
    assert w["quanta"] == 3.0 and w["step"] == q and w["got"] - w["want"] == 3 * q
    assert w["differ"] == {"1": 1, "2": 0, "3": 1, "4": 0, "more": 0} and w["parts"] == 16
    assert w["rel_l2"] > w["rel_l2_without_one_step"] > 0
    big = vals * np.float32(2 ** 20)  # -2^21 at sensor 1: shared exponent 10, step 2^5
    bumped = big.copy()
    bumped[0, 1] -= 64
    want, got = _pair(p, rows(big), new_rows=rows(bumped))
    w = sweep.ac.worst_40bit(want["p_c"], got["p_c"])
    assert (w["sensor"], w["step"], w["quanta"]) == (1, 32.0, 2.0)


def test_compare_outputs_holds_what_it_says():
    """`compare_outputs` passes equal outputs, fails float data 1e-3 off, and holds a
    40-bit coefficient near the word's absolute step by the quantum floor (passes three
    steps off, fails 2o + 3 steps off); a changed attribute fails."""
    import numpy as np

    from kwave_tpu_torch import oracle

    rng = np.random.default_rng(0)
    p = rng.standard_normal((1, 20, 8)).astype(np.float32)
    vals = np.array([[1.5, -2.0, 0.25, 1.5, 0.75, -0.5, 1.0, 2.5]], np.float32)

    def rows(v):
        planes = oracle.encode40(v, np.zeros_like(v), oracle.MAX_EXP_P)
        raw = oracle.soa_to_bytes(*planes)
        return np.concatenate([raw, np.zeros(40 - raw.size, np.uint8)]).view(
            np.float32).reshape(1, 1, 10)

    q = sweep.ac.quantum_40bit(138)
    errs, floored = sweep.ac.compare_outputs(*_pair(p, rows(vals)))
    assert errs == {"p": 0.0, "p_c": 0.0} and not floored
    with pytest.raises(AssertionError, match="p: rel L2"):
        sweep.ac.compare_outputs(*_pair(p, rows(vals), new_p=p * np.float32(1.001)))
    near = vals.copy()
    near[0, 2] += 3 * q  # three steps on a coefficient near the step
    errs, floored = sweep.ac.compare_outputs(*_pair(p, rows(vals), new_rows=rows(near)))
    assert floored == {"p_c"} and errs["p_c"] > sweep.ac.REL_L2
    far = vals.copy()
    far[0, 2] += 23 * q  # 2o + 3 steps (the encode rounds each side by up to one)
    with pytest.raises(AssertionError, match="p_c: rel L2"):
        sweep.ac.compare_outputs(*_pair(p, rows(vals), new_rows=rows(far)))
    want, got = _pair(p, rows(vals))
    got["p"].attrs["domain_type"] = "complex"
    with pytest.raises(AssertionError, match="p: attributes"):
        sweep.ac.compare_outputs(want, got)
