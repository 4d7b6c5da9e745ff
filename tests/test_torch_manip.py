"""FrankaCubeStack and the task wrappers of the port against the JAX package, on the CPU.

- ``init_state`` from the JAX ``init_state``'s own draws (k1, k2, k3,
  injected through ``test_torch_rigid.jax_reset_draws``), and ``get_obs``;
- a rollout of the JAX ``VecEnv`` under seeded uniform actions with the
  gripper closed, during which envs whose cube sits at the end effector
  grasp it: each control step of the port from the same state and action
  (state, reward, terminated, success) and the auto-resetting
  ``VecEnv.step`` with the JAX reset draws;
- the grasp mechanic (after tests/test_task_suite.py:77): a cube teleported
  to the end effector is grasped when the gripper closes, held while it
  stays closed, released when it opens, and a released cube above cube B
  drops onto it, which stacks (reward +16, terminated, success);
- ``FlatObTask`` and ``ClipActionTask`` (after tests/test_envs.py:81,112);
- one PPO iteration on FrankaCubeStack (8 envs, horizon 2), as
  tests/test_torch_ppo.py does it on Cartpole.

Tolerance rtol 1e-4 / atol 1e-5 (positions and reward), 1e-4 on
velocities, flags exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pql_tpu.envs.base import VecEnv as JVecEnv
from pql_tpu.envs.classic import Pendulum as JPendulum
from pql_tpu.envs.classic import PointMass as JPointMass
from pql_tpu.envs.manip import FrankaCubeStack as JFranka
from pql_tpu.envs.wrappers import ClipActionTask as JClip
from pql_tpu.envs.wrappers import FlatObTask as JFlat
from pql_tpu_torch.envs import make_task
from pql_tpu_torch.envs.base import VecEnv, VecEnvState
from pql_tpu_torch.envs.classic import Pendulum, PointMass
from pql_tpu_torch.envs.manip import CUBE_A_HALF, CUBE_B_HALF, FrankaCubeStack
from pql_tpu_torch.envs.wrappers import ClipActionTask, FlatObTask
from test_torch_ppo import _agents, _gaussian_normals, assert_onpolicy_state, jax_iteration_draws, onpolicy_tree
from test_torch_pql import TOL, _assert_close, _copy
from test_torch_rigid import jax_reset_draws

from pql_tpu_torch.utils.convert import load_ppo_state, params_from_jax, ppo_state_from_jax

E = 16
ROLL = 12
STEP_TOL = {"q": TOL, "qd": dict(rtol=1e-4, atol=1e-4), "cube_a": TOL, "cube_b": TOL, "grasped": dict(rtol=0, atol=0)}


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _assert_state(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k, tol in STEP_TOL.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=f"{what} {k}", **tol)


def test_init_state_and_obs_from_jax_draws():
    jt, pt = JFranka(), FrankaCubeStack()
    keys = jax.random.split(jax.random.PRNGKey(0), E)
    want = _np(jax.vmap(jt.init_state)(keys))
    got = pt.init_state(jax_reset_draws(jt, keys))
    _assert_state(got, want, "init")
    np.testing.assert_allclose(pt.get_obs(got).numpy(), np.asarray(jax.vmap(jt.get_obs)(want)), **TOL)
    draw = pt.draw_reset(torch.Generator().manual_seed(0), 4096)
    assert draw.shape == (4096, 11) and pt.obs_dim == 27 and pt.action_dim == 8
    for cols, lo, hi in ((slice(0, 7), -0.1, 0.1), (slice(7, 9), 0.25, 0.45), (slice(9, 11), -0.45, -0.25)):
        assert lo <= float(draw[:, cols].min()) < lo + 0.01 and hi - 0.01 < float(draw[:, cols].max()) <= hi


@pytest.fixture(scope="module")
def rollout():
    """ROLL steps of the JAX VecEnv with the gripper closed; envs 0-3 start
    with cube A at the end effector, so they grasp on the first step."""
    jt = JFranka()
    jenv = JVecEnv(jt, E)
    step = jax.jit(jenv.step)
    s, _ = jenv.reset(jax.random.PRNGKey(1))
    ee = jax.vmap(jt._ee_pos)(s.state["q"])
    cube_a = s.state["cube_a"].at[:4].set(ee[:4])
    s = s.replace(state=dict(s.state, cube_a=cube_a))
    rng, key = np.random.RandomState(2), jax.random.PRNGKey(3)
    steps = []
    for _ in range(ROLL):
        key, k = jax.random.split(key)
        action = rng.uniform(-1, 1, (E, 8)).astype(np.float32)
        action[:, 7] = np.abs(action[:, 7]) + 0.1  # closed
        out = step(s, jnp.asarray(action), k)
        _, k_reset = jax.random.split(k)
        dyn = jax.vmap(jt.dynamics)(s.state, jnp.asarray(action), jax.random.split(k, E))
        steps.append(dict(state=_np(dict(s.state)), time=np.array(s.time), action=action,
                          reset_draw=jax_reset_draws(jt, jenv.env_keys(k_reset, 0)), dyn=_np(dyn),
                          out=_np((dict(out[0].state), out[0].time, out[1], out[2], out[3]))))
        s = out[0]
    return steps


def test_control_step_matches_jax(rollout):
    pt = FrankaCubeStack()
    for i, st in enumerate(rollout):
        nxt, reward, terminated, info = pt.dynamics(_t(st["state"]), torch.from_numpy(st["action"]))
        w_nxt, w_reward, w_term, w_info = st["dyn"]
        _assert_state(nxt, w_nxt, f"step {i}")
        np.testing.assert_allclose(reward.numpy(), w_reward, err_msg=f"step {i} reward", **TOL)
        np.testing.assert_array_equal(terminated.numpy(), w_term)
        np.testing.assert_array_equal(info["success"].numpy(), w_info["success"])
    held = np.array([st["dyn"][0]["grasped"][:4] for st in rollout])
    assert held[0].all()  # the cubes at the end effector were grasped


def test_vec_env_step_matches_jax(rollout):
    env = VecEnv(FrankaCubeStack(), E)
    for i, st in enumerate(rollout):
        s = VecEnvState(state=_t(st["state"]), time=torch.from_numpy(st["time"]))
        s2, obs, reward, done, info = env.step(s, torch.from_numpy(st["action"]), st["reset_draw"])
        w_state, w_time, w_obs, w_reward, w_done = st["out"]
        _assert_state(s2.state, w_state, f"step {i}")
        np.testing.assert_array_equal(s2.time.numpy(), w_time)
        np.testing.assert_allclose(obs.numpy(), w_obs, err_msg=f"step {i} obs", rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(reward.numpy(), w_reward, **TOL)
        np.testing.assert_array_equal(done.numpy(), w_done)


def test_grasp_hold_release_and_stack():
    jt, pt = JFranka(), FrankaCubeStack()
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    js = jax.vmap(jt.init_state)(keys)
    s = pt.init_state(jax_reset_draws(jt, keys))
    ee = pt._ee_pos(s["q"])
    s["cube_a"] = ee.clone()
    js = dict(js, cube_a=jnp.asarray(ee.numpy()))
    # env 3 already released its cube just above cube B's stack target
    above = s["cube_b"][3] + torch.tensor([0.0, 0.0, CUBE_A_HALF + CUBE_B_HALF + 0.02])
    s["cube_a"][3] = above
    js["cube_a"] = js["cube_a"].at[3].set(jnp.asarray(above.numpy()))
    close = torch.zeros(4, 8)
    close[:3, 7] = 1.0
    close[3, 7] = -1.0
    dyn = jax.vmap(jt.dynamics)
    rngs = jax.random.split(jax.random.PRNGKey(6), 4)

    s1, r1, d1, i1 = pt.dynamics(s, close)
    w1 = dyn(js, jnp.asarray(close.numpy()), rngs)
    assert s1["grasped"].tolist() == [1.0, 1.0, 1.0, 0.0]
    assert d1.tolist() == [False, False, False, True] and i1["success"].tolist() == [0.0, 0.0, 0.0, 1.0]
    assert float(r1[3]) >= 16.0 > float(r1[:3].max())  # the stack bonus
    s2, *_ = pt.dynamics(s1, close)  # held while closed: the cube follows the end effector
    np.testing.assert_allclose(s2["cube_a"][:3].numpy(), (pt._ee_pos(s2["q"])[:3] - torch.tensor(
        [0.0, 0.0, CUBE_A_HALF])).numpy(), **TOL)
    open_ = -close.abs()
    s3, *_ = pt.dynamics(s2, open_)
    w2 = dyn(w1[0], jnp.asarray(close.numpy()), rngs)
    w3 = dyn(w2[0], jnp.asarray(open_.numpy()), rngs)
    assert s3["grasped"].tolist() == [0.0] * 4
    np.testing.assert_allclose(s3["cube_a"][:3, 2].numpy(), (s2["cube_a"][:3, 2] - 0.02).clamp_min(CUBE_A_HALF).numpy(),
                               **TOL)
    for got, want, what in ((s1, w1, "close"), (s3, w3, "open")):
        _assert_state(got, _np(want[0]), what)
    np.testing.assert_allclose(r1.numpy(), np.asarray(w1[1]), **TOL)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(w1[2]))


# ---------------------------------------------------------------- wrappers


class _DictPointMass(PointMass):
    def get_obs(self, state):
        flat = super().get_obs(state)
        return {"b": flat[:, 2:], "a": flat[:, :2]}


class _JDictPointMass(JPointMass):
    def get_obs(self, state):
        flat = super().get_obs(state)
        return {"b": flat[2:], "a": flat[:2]}


def test_flat_ob_task_matches_jax():
    pt, jt = FlatObTask(_DictPointMass()), JFlat(_JDictPointMass())
    D = PointMass.obs_dim
    assert (pt.keys, pt.slices, pt.obs_dim) == (jt.keys, jt.slices, jt.obs_dim) == (("a", "b"), {"a": (0, 2),
                                                                                                  "b": (2, D)}, D)
    keys = jax.random.split(jax.random.PRNGKey(7), 8)
    s = pt.init_state(jax_reset_draws(JPointMass(), keys))
    np.testing.assert_allclose(pt.get_obs(s).numpy(), PointMass().get_obs(s).numpy())
    js = jax.vmap(jt.init_state)(keys)
    np.testing.assert_allclose(pt.get_obs(s).numpy(), np.asarray(jax.vmap(jt.get_obs)(js)), **TOL)
    env = VecEnv(pt, 8)
    st, obs = env.reset(pt.draw_reset(torch.Generator().manual_seed(0), 8))
    st, obs2, *_ = env.step(st, torch.zeros(8, 2), pt.draw_reset(torch.Generator().manual_seed(1), 8))
    assert obs.shape == obs2.shape == (8, D)
    with pytest.raises(ValueError, match="dict-observation"):
        FlatObTask(PointMass())


def test_clip_action_task_matches_jax():
    pt, jt = ClipActionTask(Pendulum()), JClip(JPendulum())
    assert (pt.obs_dim, pt.action_dim, pt.max_episode_length) == (3, 1, 200)
    keys = jax.random.split(jax.random.PRNGKey(8), 4)
    s = pt.init_state(jax_reset_draws(JPendulum(), keys))
    big, one = torch.full((4, 1), 10.0), torch.ones(4, 1)
    (n1, r1, *_), (n2, r2, *_) = pt.dynamics(s, big), pt.dynamics(s, one)
    np.testing.assert_allclose(r1.numpy(), r2.numpy())
    js = jax.vmap(jt.init_state)(keys)
    _, jr, *_ = jax.vmap(jt.dynamics)(js, jnp.full((4, 1), 10.0), keys)
    np.testing.assert_allclose(r1.numpy(), np.asarray(jr), **TOL)

    class Echo:  # reports the action it receives as its reward
        obs_dim, action_dim, max_episode_length = 1, 1, 5

        def dynamics(self, state, action):
            return state, action[:, 0], torch.zeros(action.shape[0], dtype=torch.bool), {}

    assert ClipActionTask(Echo()).dynamics({}, torch.tensor([[10.0], [-3.0], [0.5]]))[1].tolist() == [1.0, -1.0, 0.5]


# ------------------------------------------------------------ PPO on Franka


def test_ppo_iteration_on_franka_matches_jax():
    size = dict(task="FrankaCubeStack", num_envs=8, algo__horizon_len=2, algo__batch_size=8, algo__update_times=2)
    jcfg, jagent, agent = _agents("ppo", **size)
    js = jagent.init(jax.random.PRNGKey(0))
    js, _ = jagent.train_iter(js)
    before = _copy(js)
    draws = jax_iteration_draws(jagent, jcfg, js.rng, _gaussian_normals((8, 8)), 2 * 8)
    js, jmetrics = jagent.train_iter(js)
    after = _copy(js)
    assert make_task("FrankaCubeStack").obs_dim == agent.obs_dim == 27

    state = agent.init()
    load_ppo_state(state, ppo_state_from_jax(onpolicy_tree(before)))
    state, metrics = agent.train_iter(state, draws)
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), err_msg=k, rtol=1e-4, atol=1e-4)
    n = 2 * 2
    _assert_close(state.actor.state_dict(), params_from_jax(after.actor_params), "actor", 2 * jcfg.algo.actor_lr * n)
    _assert_close(state.critic.state_dict(), params_from_jax(after.critic_params), "critic",
                  2 * jcfg.algo.critic_lr * n)
    assert_onpolicy_state(state, after, "franka")
    for k, v in state.env_state.state.items():
        np.testing.assert_allclose(v.numpy(), after.env_state.state[k], err_msg=k, rtol=1e-4, atol=1e-4)
    assert jcfg.algo.reward_scale == 0.1
