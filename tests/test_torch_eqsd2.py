"""EQSD2 of the port against the JAX package, on the CPU.

- one iteration on BimanualReacher with the equivariant and with the plain
  team, from a converted JAX state with the JAX draws (per step
  ``split(k, 5)``: both hands on the first half, the joint team actor on the
  second; one permutation of the H·E/2 rows per epoch key); episodes
  truncated at 6 steps inside a horizon of 8: every network (EMLPs 16 wide
  in both packages, fixture ``narrow``), the losses, obs-rms, obs, dones,
  episode statistics and counters; the value-rms pair present and unmoved;
- a second iteration past a change of ``kl_weight`` (``kl_decay_iters`` 6:
  the weight 1/3 at the first parity iteration, 0 at the second),
  ``update_count`` one per minibatch; ``LinearSchedule`` against the JAX
  one, bitwise;
- the eval hook (the team actor's mean on the views split without a
  tracker); a JAX snapshot into the port.

Tolerance rtol 1e-4 / atol 1e-5 with the Adam allowance of
tests/test_torch_pql.py::_assert_close.
"""

import jax
import numpy as np
import pytest

from pql_tpu.ops.schedules import LinearSchedule as JaxLinearSchedule
from pql_tpu_torch.ops.schedules import LinearSchedule

from test_torch_eqsd import (  # noqa: F401  (narrow and _one_thread are fixtures)
    MAX_LEN,
    PLAIN,
    SMALL,
    _one_thread,
    _parity_iteration,
    eval_hook,
    narrow,
    one_iteration,
    snapshot_starts_the_port,
)
from test_torch_ppo import _agents


@pytest.mark.parametrize("extra,team", [({}, "DiagGaussianEquivariantMLPPolicy"), (PLAIN, "DiagGaussianMLPPolicy")],
                         ids=["eq", "plain"])
def test_one_iteration_matches_jax(narrow, extra, team):  # noqa: F811
    one_iteration("eqsd2", extra, team)


def test_second_iteration_past_a_kl_weight_change(narrow):  # noqa: F811
    jcfg, jagent, agent = _agents("eqsd2", **SMALL, algo__kl_decay_iters=6)
    jagent.env.max_episode_length = agent.env.max_episode_length = MAX_LEN
    js, _ = jagent.train_iter(jagent.init(jax.random.PRNGKey(1)))
    n_updates = 2 * agent.rows // 32
    assert agent.kl_schedule(n_updates) == pytest.approx(1 / 3) and agent.kl_schedule(2 * n_updates) == 0.0
    js, state = _parity_iteration(jagent, jcfg, agent, js, None)
    js, state = _parity_iteration(jagent, jcfg, agent, js, state)
    assert state.update_count == 3 * n_updates


@pytest.mark.parametrize("start,end,total", [(1.0, 0.0, 1000), (0.8, 0.05, 7), (0.3, 2.5, 3)])
def test_linear_schedule_matches_jax(start, end, total):
    for step in (0, 1, 2, 3, 5, 7, 999, 1000, 5000):
        want = np.float32(JaxLinearSchedule(start, end, total)(step))
        assert np.float32(LinearSchedule(start, end, total)(step)) == want, step


def test_eval_hook_matches_jax(narrow):  # noqa: F811
    eval_hook("eqsd2", {})


def test_snapshot_from_jax_starts_the_port(tmp_path, narrow):  # noqa: F811
    snapshot_starts_the_port(tmp_path, "eqsd2", {})
