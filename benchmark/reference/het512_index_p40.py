"""het512_index_p40's inputs: het128_index_p40's recipe at 512^3, a heterogeneous absorbing
medium, p0 at the centre, random index sensors (``configs/het512_index_p40.json``)."""

import math

from benchmark.reference import recipe


def make_inputs(config: dict, seed: int, device) -> dict:
    inputs = recipe.medium(config, seed, device)
    inputs["p0"] = recipe.centre_p0(inputs["shape"], config["p0_amplitude"], device)
    inputs["sensors"] = recipe.random_sensors(math.prod(inputs["shape"]),
                                              int(config["sensors"]), seed, device)
    return inputs
