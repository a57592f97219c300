"""k-space pseudospectral fluid solver in PyTorch (port of `kwave_tpu.solver`): operators
built once a run on its device (`make_operators`), one pure `step` per timestep, and the main
loop `simulate` as a host loop over it."""

from kwave_tpu_torch.solver.operators import Grid, Medium, Operators, make_operators
from kwave_tpu_torch.solver.step import (
    LOCAL_FFT,
    FftOps,
    SimState,
    SolverConfig,
    Sources,
    add_initial_pressure,
    init_state,
    make_p0_init,
    make_simulate_fn,
    shifted_velocity,
    simulate,
    step,
)

__all__ = [
    "FftOps",
    "LOCAL_FFT",
    "Grid",
    "Medium",
    "Operators",
    "make_operators",
    "SimState",
    "SolverConfig",
    "Sources",
    "add_initial_pressure",
    "init_state",
    "make_p0_init",
    "make_simulate_fn",
    "shifted_velocity",
    "simulate",
    "step",
]
