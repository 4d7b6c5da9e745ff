"""The vision tasks of the port against the JAX package, on the CPU.

- ``ReacherVision`` and ``BimanualReacherVision`` from the JAX draws at 6
  envs: the fresh state (``q_prev = q``), ``proprio``, ``pointcloud`` and
  ``render`` against the JAX task's vmapped functions, then again after a
  few control steps (``q_prev`` the step's starting ``q``);
- ``VecEnv.step`` through an auto-reset: a done env's ``q_prev`` is its
  fresh episode's ``q``, as the JAX ``VecEnv`` gives it;
- both names registered; the image in [0, 1] and moving with the arm.

Tolerance rtol 1e-4 / atol 1e-5 (tests/test_torch_ppo.py's ``TOL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pql_tpu.envs import make_task as j_make_task
from pql_tpu.envs.base import VecEnv as JVecEnv
from pql_tpu.envs.base import VecEnvState as JVecEnvState
from pql_tpu_torch.envs import TASK_REGISTRY, make_task
from pql_tpu_torch.envs.base import VecEnv, VecEnvState
from test_torch_ppo import rollout_draws
from test_torch_pql import TOL
from test_torch_rigid import jax_reset_draws

E = 6
TASKS = ["ReacherVision", "BimanualReacherVision"]


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _views(jtask, task, js, state, what):
    """The JAX views of the vmapped state ``js`` against the port's of ``state``."""
    names = ("proprio", "pointcloud") + (("render",) if hasattr(jtask, "render") else ())
    for name in names:
        want = np.asarray(jax.vmap(getattr(jtask, name))(js))
        got = getattr(task, name)(state).numpy()
        assert got.shape == want.shape, (what, name)
        np.testing.assert_allclose(got, want, err_msg=f"{what} {name}", **TOL)
    for k, v in js.items():
        np.testing.assert_allclose(state[k].numpy(), np.asarray(v), err_msg=f"{what} state {k}", **TOL)


@pytest.mark.parametrize("name", TASKS)
def test_views_match_jax_fresh_and_after_steps(name):
    jtask, task = j_make_task(name), make_task(name)
    keys = jax.random.split(jax.random.PRNGKey(1), E)
    js = jax.vmap(jtask.init_state)(keys)
    state = task.init_state(jax_reset_draws(jtask, keys))
    if name == "ReacherVision":
        assert set(state) == set(js) and torch.equal(state["q_prev"], state["q"])
    _views(jtask, task, js, state, "fresh")
    actions = np.random.default_rng(2).uniform(-1, 1, size=(4, E, task.action_dim)).astype(np.float32)
    for t in range(4):
        step_keys = jax.random.split(jax.random.PRNGKey(10 + t), E)
        q_before = state["q"]
        js, jr, *_ = jax.vmap(jtask.dynamics)(js, jnp.asarray(actions[t]), step_keys)
        state, r, *_ = task.dynamics(state, torch.from_numpy(actions[t]))
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), **TOL)
        if name == "ReacherVision":
            assert torch.equal(state["q_prev"], q_before)
    _views(jtask, task, js, state, "after 4 steps")


@pytest.mark.parametrize("name", TASKS)
def test_auto_reset_refreshes_q_prev_as_jax(name):
    """Envs 0-2 at the time limit: the step ends their episodes, and their
    state (``q_prev`` included) and obs are the fresh episode's."""
    jenv, env = JVecEnv(j_make_task(name), E), VecEnv(make_task(name), E)
    keys = jax.random.split(jax.random.PRNGKey(3), E)
    js = jax.vmap(jenv.task.init_state)(keys)
    state = env.task.init_state(jax_reset_draws(jenv.task, keys))
    act = np.random.default_rng(4).uniform(-1, 1, size=(E, env.action_dim)).astype(np.float32)
    js, *_ = jax.vmap(jenv.task.dynamics)(js, jnp.asarray(act), keys)  # q_prev ≠ q before the step
    state, *_ = env.task.dynamics(state, torch.from_numpy(act))
    time = np.array([env.max_episode_length - 1] * 3 + [5] * 3, np.int32)
    jstate = JVecEnvState(state=js, time=jnp.asarray(time))
    k_e = jax.random.PRNGKey(5)
    jnext, jobs, jrew, jdone, _ = jenv.step(jstate, jnp.asarray(act), k_e)
    reset = rollout_draws(jenv, [(None, k_e)], lambda k: {})["reset"][0]
    nxt, obs, rew, done, info = env.step(VecEnvState(state=state, time=torch.from_numpy(time)), torch.from_numpy(act),
                                         reset)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert done[:3].all() and not done[3:].any() and info["truncated"][:3].all()
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **TOL)
    for k, v in jnext.state.items():
        np.testing.assert_allclose(nxt.state[k].numpy(), np.asarray(v), err_msg=k, **TOL)
    if name == "ReacherVision":
        fresh = env.task.init_state(reset)
        assert torch.equal(nxt.state["q_prev"][:3], fresh["q"][:3])
        assert not torch.equal(nxt.state["q_prev"][3:], nxt.state["q"][3:])


def test_tasks_are_registered_and_render_sane():
    assert {"ReacherVision", "BimanualReacherVision"} <= set(TASK_REGISTRY)
    task = make_task("ReacherVision")
    state = task.init_state(task.draw_reset(torch.Generator().manual_seed(0), 3))
    assert task.render(state).shape == (3, 1, 2, 48, 48, 3) and task.visual_spec["img"] == (1, 2, 48, 48, 3)
    for _ in range(5):
        state, *_ = task.dynamics(state, torch.ones(3, 2))
    img = task.render(state)
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0 and float(img[..., 2].abs().max()) == 0.0
    assert float((img[:, 0, 1] - img[:, 0, 0]).abs().max()) > 1e-4  # the frames differ once the arm moves
    bim = make_task("BimanualReacherVision")
    s = bim.init_state(bim.draw_reset(torch.Generator().manual_seed(1), 4))
    assert bim.proprio(s).shape == (4, 2, 6) and bim.pointcloud(s).shape == (4, 40, 3) and bim.multi is not None
    assert not hasattr(bim, "render")
