"""On the card: the control (the plain reference put in the program's
place, in TF32) fails the cell's limits while the program passes them, at
sizes a test run holds. Run on the card with
``python -m pytest benchmark/tests -m gpu``; the cells' own sizes are
read by ``benchmark/calibrate.py --control --faults``."""

import pytest
import torch

import calibrate
import harness
from conftest import ROOT

SMALL = {
    "allegro-pql-8k-r8": ({"algo.batch_size": 1024, "algo.memory_size": 200000}, {"num_envs": 1024}),
    "allegro-pql-16k-r8": ({"algo.batch_size": 1024, "algo.memory_size": 200000}, {"num_envs": 2048}),
    "reacher-ddpgv-4k-u4": ({"algo.batch_size": 512, "algo.memory_size": 20000}, {"num_envs": 256}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_fails_where_the_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.find_cell(harness.load_benchmark(ROOT), workload)
    config, traffic = harness.load_json("configs", cell["config"]), harness.load_json("traffic", cell["traffic"])
    config["args"].update(SMALL[workload][0])
    traffic["args"].update(SMALL[workload][1])
    out = calibrate.readings_for_seed(cell, 2**31 + 17, "cuda", True, True, config, traffic)
    limits = config["limits"]
    assert all(v <= limits[k] for k, v in out["program"].items()), out["program"]
    assert any(v > limits[k] for k, v in out["control"].items()), out["control"]
    for fault, numbers in out["faults"].items():
        assert any(v > limits[k] for k, v in numbers.items()), (fault, numbers)
