"""The ported rigid-body tasks (pql_tpu_torch.envs.rigid) against the JAX package, on the CPU.

For each task (Ant, Humanoid, Anymal) a JAX ``VecEnv`` of E = 8 envs with
``max_episode_length`` cut to ``MAX_LEN`` is reset from a key, env 0 is
turned upside down (so it terminates on the first step), and the jitted
JAX ``VecEnv.step`` (compiled once per task, the costly part of this file)
runs ``ROLL`` steps under uniform numpy actions. The rollout covers a
termination with auto-reset (env 0 at step 0) and truncations at the time
limit (steps MAX_LEN - 1 and MAX_LEN), asserted by the test.

At every step of the rollout the port starts from the JAX state and takes
the same step: ``dynamics`` (its reward and terminated against the JAX
step's reward and done-and-not-truncated, its next state against the JAX
one where the env did not reset) and ``VecEnv.step`` with reset draws
rebuilt from the step's key (``jax_reset_draws``).

Tolerances (fp32 on both sides, sums in other orders):
- ``init_state`` from the same draws: exact (the same elementwise ops);
- ``get_obs``: rtol 1e-6 / atol 1e-6 (quaternion rotations of order-1
  values);
- one step's state, obs and reward: the control step's tolerances of
  tests/test_torch_physics.py: rtol 1e-4 with atol 1e-5 on positions,
  anchors and the reward (whose forward velocity divides a position change
  by 1/60 s), atol 1e-4 where velocities enter (qd and the obs);
- terminated, done, truncated and the episode clocks: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pql_tpu.envs.rigid as jrigid
import pql_tpu_torch.envs.rigid as trigid
from pql_tpu.envs.base import VecEnv as JVecEnv
from pql_tpu_torch.envs.base import VecEnv, VecEnvState

TASKS = ("Ant", "Humanoid", "Anymal")
E = 8
MAX_LEN = 12
ROLL = MAX_LEN + 2
TOL = dict(rtol=1e-4, atol=1e-5)
VEL_TOL = dict(rtol=1e-4, atol=1e-4)  # qd and the obs, which holds velocities


def _tol(field):
    return VEL_TOL if field == "qd" else TOL
# half-width of the uniform hinge offsets each JAX init_state draws
# (pql_tpu/envs/rigid.py:165, :376, :552)
_HINGE_NOISE = {"Ant": 0.1, "Humanoid": 0.05, "Anymal": 0.05}


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HAND_TASKS = ("AllegroHand", "ShadowHand")


def _pendulum(key):  # pql_tpu/envs/classic.py:97-102
    k1, k2 = jax.random.split(key)
    return jnp.stack([jax.random.uniform(k1, (), jnp.float32, -jnp.pi, jnp.pi),
                      jax.random.uniform(k2, (), jnp.float32, -1.0, 1.0)])


def _point_mass(key):  # :136-142: pos, goal
    k1, k2 = jax.random.split(key)
    return jnp.concatenate([jax.random.uniform(k1, (2,), jnp.float32, -1.0, 1.0),
                            jax.random.uniform(k2, (2,), jnp.float32, -1.0, 1.0)])


def _reacher(key):  # :178-186: q from k1, the target's angle from k2, its radius from k3
    k1, k2, k3 = jax.random.split(key, 3)
    return jnp.concatenate([jax.random.uniform(k1, (2,), jnp.float32, -0.1, 0.1),
                            jax.random.uniform(k2, (), jnp.float32, -jnp.pi, jnp.pi)[None],
                            jax.random.uniform(k3, (), jnp.float32, 0.05, 0.2)[None]])


def _ball_balance(key):  # :245-252: tilt, ball
    k1, k2 = jax.random.split(key)
    return jnp.concatenate([jax.random.uniform(k1, (2,), jnp.float32, -0.05, 0.05),
                            jax.random.uniform(k2, (2,), jnp.float32, -0.25, 0.25)])


def _franka(key):  # pql_tpu/envs/manip.py:109-132: joint offsets (k1), cube A (k2), cube B (k3)
    k1, k2, k3 = jax.random.split(key, 3)
    return jnp.concatenate([jax.random.uniform(k1, (7,), jnp.float32, -0.1, 0.1),
                            jax.random.uniform(k2, (2,), jnp.float32, 0.25, 0.45),
                            jax.random.uniform(k3, (2,), jnp.float32, -0.45, -0.25)])


def _bimanual(symmetric):  # pql_tpu/envs/bimanual.py:92-108: q (k_q), the target's uniform bits (k_t), sym (k_sym)
    def one(key):
        k_q, k_t, k_sym = jax.random.split(key, 3)
        sym = jax.random.bernoulli(k_sym).astype(jnp.float32) if symmetric else jnp.zeros((), jnp.float32)
        return jnp.concatenate([jax.random.uniform(k_q, (2, 2), jnp.float32, -0.1, 0.1).reshape(4),
                                jax.random.uniform(k_t, (2, 1), jnp.float32).reshape(2), sym[None]])

    return one


CLASSIC_DRAWS = {"Pendulum": _pendulum, "PointMass": _point_mass, "Reacher": _reacher, "BallBalance": _ball_balance,
                 "FrankaCubeStack": _franka, "BimanualReacher": _bimanual(False),
                 "BimanualReacherSym": _bimanual(True), "ReacherVision": _reacher,
                 "BimanualReacherVision": _bimanual(False)}


def jax_reset_draws(task, keys) -> torch.Tensor:
    """The port's ``draw_reset`` layout filled with the numbers the JAX
    ``task.init_state`` draws at each of ``keys``: the JAX package's
    splits and distributions, one env per key."""
    name = type(task).__name__
    if name == "Cartpole":
        fresh = jax.vmap(task.init_state)(keys)
        return torch.from_numpy(np.array(jnp.stack([fresh[f] for f in ("x", "x_dot", "theta", "theta_dot")], -1)))
    if name in CLASSIC_DRAWS:
        return torch.from_numpy(np.array(jax.vmap(CLASSIC_DRAWS[name])(keys)))
    if name in HAND_TASKS:  # pql_tpu/envs/hand.py:288-302: finger offsets, cube quat, target quat

        def hand(key):
            k1, k2, k3 = jax.random.split(key, 3)
            return jnp.concatenate([jax.random.uniform(k1, (task.n_dof,), jnp.float32, -0.1, 0.1),
                                    jax.random.uniform(k2, (3,)), jax.random.uniform(k3, (3,))])

        return torch.from_numpy(np.array(jax.vmap(hand)(keys)))
    m, w = task.model, _HINGE_NOISE[name]

    def one(key):
        ks = jax.random.split(key, 3 if name == "Anymal" else 2)
        parts = [
            jax.random.uniform(ks[0], (m.nq - 7,), jnp.float32, -w, w),
            jax.random.normal(ks[1], (m.nv,), jnp.float32),
        ]
        if name == "Anymal":
            parts.append(jax.random.uniform(ks[2], (3,), jnp.float32, -1.0, 1.0))
        return jnp.concatenate(parts)

    return torch.from_numpy(np.array(jax.vmap(one)(keys)))


def jax_step_draws(task, keys) -> torch.Tensor | None:
    """The port's ``draw_step`` layout filled with the numbers the JAX
    ``task.dynamics`` draws from each env's dynamics key (the hand's
    ``_rand_quat(rng)``, pql_tpu/envs/hand.py:376); None for a task that
    draws nothing in its dynamics."""
    if type(task).__name__ not in HAND_TASKS:
        return None
    return torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.uniform(k, (3,)))(keys)))


def _np_tree(x):
    return jax.tree_util.tree_map(np.array, x)


def _state(jstate):
    return {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}


@pytest.fixture(scope="module", params=TASKS)
def rollout(request):
    name = request.param
    jt = getattr(jrigid, name)()
    jenv = JVecEnv(jt, E)
    jenv.max_episode_length = MAX_LEN
    step = jax.jit(jenv.step)
    s, _ = jenv.reset(jax.random.PRNGKey(0))
    q = s.state["q"].at[0, 3:7].set(jnp.array([0.0, 1.0, 0.0, 0.0]))  # env 0 upside down
    s = s.replace(state=dict(s.state, q=q))
    rng, key = np.random.RandomState(1), jax.random.PRNGKey(1)
    steps = []
    for _ in range(ROLL):
        key, k = jax.random.split(key)
        action = rng.uniform(-1, 1, (E, jt.action_dim)).astype(np.float32)
        out = step(s, jnp.asarray(action), k)
        _k_dyn, k_reset = jax.random.split(k)
        steps.append(dict(
            state=_np_tree(dict(s.state)), time=np.array(s.time), action=action,
            reset_draw=jax_reset_draws(jt, jenv.env_keys(k_reset, 0)),
            out=_np_tree((dict(out[0].state), out[0].time, out[1], out[2], out[3], out[4]["truncated"])),
        ))
        s = out[0]
    return dict(name=name, jt=jt, pt=getattr(trigid, name)(), steps=steps)


@pytest.mark.parametrize("name", TASKS)
def test_init_state_from_injected_draws(name):
    jt, pt = getattr(jrigid, name)(), getattr(trigid, name)()
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(3), i))(jnp.arange(E))
    want = jax.vmap(jt.init_state)(keys)
    got = pt.init_state(jax_reset_draws(jt, keys))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.array(want[k]), err_msg=k)


@pytest.mark.parametrize("name", TASKS)
def test_draw_reset_shape_and_ranges(name):
    pt = getattr(trigid, name)()
    m = pt.model
    draw = pt.draw_reset(torch.Generator().manual_seed(0), 4096)
    nh = m.nq - 7
    assert draw.shape == (4096, nh + m.nv + (3 if name == "Anymal" else 0))
    assert draw[:, :nh].abs().max() <= pt.init_noise
    assert abs(float(draw[:, nh : nh + m.nv].std()) - 1.0) < 0.02
    if name == "Anymal":
        assert draw[:, -3:].abs().max() <= 1.0
        cmd_max = pt.init_state(draw)["cmd"].abs().amax(0)
        assert (cmd_max <= torch.tensor([2.0, 0.5, 1.0])).all()


def test_rollout_covers_termination_and_truncation(rollout):
    out = [st["out"] for st in rollout["steps"]]
    terminated = [(o[4] > 0) & ~o[5] for o in out]
    assert terminated[0][0], "the upside-down env terminates on the first step"
    assert out[MAX_LEN - 1][5][1:].all() and out[MAX_LEN][5][0], "every env reaches the time limit"


def test_get_obs(rollout):
    jt, pt = rollout["jt"], rollout["pt"]
    for t, st in enumerate(rollout["steps"]):
        want = np.array(jax.vmap(jt.get_obs)({k: jnp.asarray(v) for k, v in st["state"].items()}))
        got = pt.get_obs(_state(st["state"])).numpy()
        assert got.shape == (E, pt.obs_dim)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=f"step {t}")


def test_dynamics_reward_and_terminated(rollout):
    pt = rollout["pt"]
    for t, st in enumerate(rollout["steps"]):
        nxt, reward, terminated, info = pt.dynamics(_state(st["state"]), torch.from_numpy(st["action"]))
        jstate, _, _, jreward, jdone, jtrunc = st["out"]
        assert info == {}
        np.testing.assert_array_equal(terminated.numpy(), (jdone > 0) & ~jtrunc, err_msg=f"step {t}")
        np.testing.assert_allclose(reward.numpy(), jreward, err_msg=f"step {t}", **TOL)
        kept = jdone == 0
        for k, v in jstate.items():
            np.testing.assert_allclose(nxt[k].numpy()[kept], v[kept], err_msg=f"step {t} {k}", **_tol(k))


def test_vec_env_step(rollout):
    pt = rollout["pt"]
    env = VecEnv(pt, E)
    env.max_episode_length = MAX_LEN
    for t, st in enumerate(rollout["steps"]):
        s = VecEnvState(state=_state(st["state"]), time=torch.from_numpy(st["time"]))
        s2, obs, reward, done, info = env.step(s, torch.from_numpy(st["action"]), st["reset_draw"])
        jstate, jtime, jobs, jreward, jdone, jtrunc = st["out"]
        np.testing.assert_array_equal(done.numpy(), jdone, err_msg=f"step {t}")
        np.testing.assert_array_equal(info["truncated"].numpy(), jtrunc, err_msg=f"step {t}")
        np.testing.assert_array_equal(s2.time.numpy(), jtime, err_msg=f"step {t}")
        for k, v in jstate.items():
            np.testing.assert_allclose(s2.state[k].numpy(), v, err_msg=f"step {t} {k}", **_tol(k))
        np.testing.assert_allclose(obs.numpy(), jobs, err_msg=f"step {t} obs", **VEL_TOL)
        np.testing.assert_allclose(reward.numpy(), jreward, err_msg=f"step {t} reward", **TOL)
