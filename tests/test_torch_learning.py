"""The JAX package's Cartpole learning gate on the port, on the CPU (marked slow).

The configuration of tests/test_learning.py:32-59 (``chip_smoke.LEARNING_GATE``):
PQL on Cartpole, 256 envs, 32 eval envs, batch 1024, memory 2e5, warm-up
16, seed 0; warm-up, 150 ``train_iter`` calls, then the deterministic
policy's eval return from the port's ``Evaluator`` must exceed 250 (random ≈
20-90, optimum ≈ 500). ``chip_smoke.py``'s learning_gate phase and a
``gpu`` test of tests/test_torch_gpu.py run the same gate on the card.
"""

import pytest

from chip_smoke import LEARNING_THRESHOLD, learning_gate_return


@pytest.mark.slow
def test_pql_learns_cartpole():
    ret = learning_gate_return("pql", seed=0, device="cpu")
    assert ret > LEARNING_THRESHOLD, f"PQL failed to learn Cartpole: eval return {ret}"
