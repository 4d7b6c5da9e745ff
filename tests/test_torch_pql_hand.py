"""Whole-iteration parity on the hand: one PQL-D AllegroHand iteration of the
port against the JAX package (E = 8, batch 32), as
tests/test_torch_pql.py::test_one_iteration_matches_jax does for Cartpole
and Ant. Its own file, so that the JAX compile of the hand's PQL (warm-up
and iteration, the costliest of the suite) runs on a worker of its own
under ``--dist loadfile``.

The iteration's draws are rebuilt from the JAX state's key by
``test_torch_pql._jax_draws``, the hand's per-step draws (the goals
re-sampled on success) included.

Tolerances: those of tests/test_torch_pql.py (rtol 1e-4 / atol 1e-5, with
its allowance for Adam's per-element normalisation), except on the cube's
angular velocity, 3 of the 53 columns of obs and next_obs: the sim phase's
control step leaves it within 1e-2 rad/s of the JAX package's, not 1e-4
(tests/test_torch_hand.py says why), so those columns of the new obs, the
replay's next_obs and the env state's qd take atol 1e-2 (2.8e-4 seen).
"""

import jax
import numpy as np
import pytest
import torch

from pql_tpu.algos.pql import PQL as JPQL
from pql_tpu.cfg import make_config as j_make_config
from pql_tpu.parallel import make_mesh
from pql_tpu_torch.algos.pql import PQL
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.utils.convert import load_pql_state, pql_state_from_jax
from test_torch_pql import SMALL_RIGID, TOL, _assert_params, _copy, _jax_draws, _jax_tree

CUBE_W_ATOL = 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_obs_close(got, want, n_dof, msg):
    """Obs-shaped values: TOL, and atol CUBE_W_ATOL on the cube's angular
    velocity (obs: q, qd of the fingers, cube position, quaternion, linear
    velocity, angular velocity, target, difference)."""
    ang = np.zeros(got.shape[-1], bool)
    ang[2 * n_dof + 3 + 4 + 3 : 2 * n_dof + 3 + 4 + 6] = True
    np.testing.assert_allclose(got[..., ~ang], want[..., ~ang], err_msg=msg, **TOL)
    np.testing.assert_allclose(got[..., ang], want[..., ang], rtol=TOL["rtol"], atol=CUBE_W_ATOL, err_msg=msg)


def test_one_pql_d_hand_iteration_matches_jax():
    algo, task, size = "pql_d", "AllegroHand", SMALL_RIGID
    jcfg = j_make_config(algo, task=task, **size)
    jagent = JPQL(jcfg, mesh=make_mesh(1))
    jstate = jagent.init(jax.random.PRNGKey(0))
    jstate, _ = jagent.warmup(jstate)
    before = _copy(jstate)  # train_iter donates jstate
    tree = _jax_tree(jagent, before)
    draws = _jax_draws(jagent, jcfg, jstate.rng)
    assert draws["step"].shape == (1, size["num_envs"], 3)
    jstate, jmetrics = jagent.train_iter(jstate)
    after = _copy(jstate)

    agent = PQL(make_config(algo, task=task, **size), device="cpu")
    state = agent.init()
    load_pql_state(state, pql_state_from_jax(tree, before.replay.layout))
    state, metrics = agent.train_iter(state, draws)

    n_dof = agent.env.task.n_dof
    for name in ("critic_loss", "actor_loss"):
        np.testing.assert_allclose(float(metrics[f"train/{name}"]), float(jmetrics[f"train/{name}"]), err_msg=name,
                                   **TOL)
    lr = jcfg.algo.actor_lr  # == critic_lr
    _assert_params(state.actor, jagent._unravel_a(after.actor_params), "actor", 2 * lr * jagent.n_actor)
    _assert_params(state.critic, jagent._unravel_c(after.critic_params), "critic", 2 * lr * jagent.n_critic)
    _assert_params(state.critic_target, jagent._unravel_c(after.critic_target), "critic_target",
                   2 * lr * jagent.n_critic)
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(state.obs_rms, k).numpy(), getattr(after.obs_rms, k), err_msg=k, **TOL)
    for name, s, d in after.replay.layout:
        got, want = state.replay.field(name).numpy(), after.replay.data[..., s : s + d]
        if name in ("obs", "next_obs"):
            _assert_obs_close(got, want, n_dof, name)
        else:
            np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    _assert_obs_close(state.obs.numpy(), after.obs, n_dof, "obs")
    for k, v in after.env_state.state.items():
        np.testing.assert_allclose(state.env_state.state[k].numpy(), v, rtol=TOL["rtol"],
                                   atol=CUBE_W_ATOL if k == "qd" else TOL["atol"], err_msg=k)
    np.testing.assert_allclose(state.success_tracker.ring.numpy(), after.success_tracker.ring)
    assert (state.replay.ptr, state.replay.total_writes) == (int(after.replay.ptr), int(after.replay.total_writes))
    assert (state.env_steps, state.critic_update_count, state.actor_update_count) == (
        int(after.env_steps), int(after.critic_update_count), int(after.actor_update_count)
    )
    assert (state.critic_update_count, state.actor_update_count) == (8, 4)  # one iteration after warm-up
