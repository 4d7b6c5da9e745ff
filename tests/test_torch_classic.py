"""The ported classic tasks (Pendulum, PointMass, Reacher, BallBalance) against the JAX package, on the CPU.

For each task a JAX ``VecEnv`` of E = 16 envs, with ``max_episode_length``
cut to ``MAX_LEN`` so that every env truncates within the rollout, is reset
from a key and stepped ``ROLL`` times under uniform numpy actions in
[-1.5, 1.5] (so the clamp to ±1 is exercised). BallBalance's env 0 starts at
the tray's rim rolling outwards, so it terminates on the first step. The
port starts from the same reset draws (``jax_reset_draws``: the numbers
each JAX ``init_state`` draws) and runs its own rollout with the same
actions and, at every step, the reset draws rebuilt from the JAX step's
key.

Tolerances (fp32 on both sides, the same elementwise arithmetic):
terminated, done, truncated and the clocks exact; obs, reward, the state and
``success`` within rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pql_tpu.envs.classic as jclassic
import pql_tpu_torch.envs.classic as tclassic
from pql_tpu.envs.base import VecEnv as JVecEnv
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.envs import make_eval_env
from pql_tpu_torch.envs.base import VecEnv
from test_torch_rigid import jax_reset_draws

TASKS = ("Pendulum", "PointMass", "Reacher", "BallBalance")
E = 16
MAX_LEN = 12
ROLL = 2 * MAX_LEN + 3
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rollout(name):
    jt = getattr(jclassic, name)()
    jenv = JVecEnv(jt, E)
    jenv.max_episode_length = MAX_LEN
    key = jax.random.PRNGKey(0)
    s, obs = jenv.reset(key)
    first = jax_reset_draws(jt, jenv.env_keys(key))
    if name == "BallBalance":  # env 0 at the rim, rolling outwards: off the tray on step 1
        st = dict(s.state)
        st["ball"] = st["ball"].at[0].set(jnp.array([0.499, 0.0]))
        st["ball_vel"] = st["ball_vel"].at[0].set(jnp.array([1.0, 0.0]))
        s = s.replace(state=st)
        obs = jax.vmap(jt.get_obs)(st)
    step = jax.jit(jenv.step)
    rng, key = np.random.RandomState(1), jax.random.PRNGKey(1)
    steps = []
    for _ in range(ROLL):
        key, k = jax.random.split(key)
        action = rng.uniform(-1.5, 1.5, (E, jt.action_dim)).astype(np.float32)
        s, obs, reward, done, info = step(s, jnp.asarray(action), k)
        _k_dyn, k_reset = jax.random.split(k)
        steps.append(dict(
            action=action, reset_draw=jax_reset_draws(jt, jenv.env_keys(k_reset)),
            out=jax.tree_util.tree_map(np.array, (dict(s.state), s.time, obs, reward, done, dict(info))),
        ))
    return dict(first=first, steps=steps)


@pytest.fixture(scope="module", params=TASKS)
def rollout(request):
    return request.param, _rollout(request.param)


@pytest.mark.parametrize("name", TASKS)
def test_init_state_from_injected_draws(name):
    jt, pt = getattr(jclassic, name)(), getattr(tclassic, name)()
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(3), i))(jnp.arange(E))
    want = jax.vmap(jt.init_state)(keys)
    got = pt.init_state(jax_reset_draws(jt, keys))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.array(want[k]), err_msg=k, **TOL)
    np.testing.assert_allclose(pt.get_obs(got).numpy(), np.array(jax.vmap(jt.get_obs)(want)), **TOL)


# each column's U(lo, hi) in the JAX init_state (pql_tpu/envs/classic.py)
BOUNDS = {
    "Pendulum": [(-np.pi, np.pi), (-1.0, 1.0)],
    "PointMass": [(-1.0, 1.0)] * 4,
    "Reacher": [(-0.1, 0.1)] * 2 + [(-np.pi, np.pi), (0.05, 0.2)],
    "BallBalance": [(-0.05, 0.05)] * 2 + [(-0.25, 0.25)] * 2,
}


@pytest.mark.parametrize("name", TASKS)
def test_draw_reset_layout_and_ranges(name):
    """The port's draws and the JAX draws have one layout: column by column
    the same uniform range, which the port's 4096 draws fill."""
    pt, jt = getattr(tclassic, name)(), getattr(jclassic, name)()
    draw = pt.draw_reset(torch.Generator().manual_seed(0), 4096)
    jdraw = jax_reset_draws(jt, jax.random.split(jax.random.PRNGKey(0), 256))
    lo, hi = (torch.tensor(b, dtype=torch.float32) for b in zip(*BOUNDS[name]))
    assert draw.shape == (4096, len(BOUNDS[name])) and jdraw.shape == (256, len(BOUNDS[name]))
    for d in (draw, jdraw):
        assert (d >= lo).all() and (d <= hi).all()
    width = hi - lo
    assert (draw.min(0).values < lo + 0.01 * width).all() and (draw.max(0).values > hi - 0.01 * width).all()


def test_rollout_covers_termination_and_truncation(rollout):
    name, r = rollout
    done = np.stack([st["out"][4] for st in r["steps"]])
    truncated = np.stack([st["out"][5]["truncated"] for st in r["steps"]])
    assert truncated[MAX_LEN - 1].all() or name == "BallBalance"
    assert truncated.any(0)[1:].all(), "every env reaches the time limit"
    if name == "BallBalance":
        assert done[0, 0] and not truncated[0, 0], "env 0 falls off the tray on the first step"


def test_vec_env_rollout_matches(rollout):
    name, r = rollout
    env = VecEnv(getattr(tclassic, name)(), E)
    env.max_episode_length = MAX_LEN
    s, obs = env.reset(r["first"])
    if name == "BallBalance":  # the same rim start as the JAX rollout
        s.state["ball"] = s.state["ball"].clone()
        s.state["ball"][0] = torch.tensor([0.499, 0.0])
        s.state["ball_vel"] = s.state["ball_vel"].clone()
        s.state["ball_vel"][0] = torch.tensor([1.0, 0.0])
    for t, st in enumerate(r["steps"]):
        s, obs, reward, done, info = env.step(s, _t(st["action"]), st["reset_draw"])
        jstate, jtime, jobs, jreward, jdone, jinfo = st["out"]
        np.testing.assert_array_equal(done.numpy(), jdone, err_msg=f"step {t}")
        np.testing.assert_array_equal(info["truncated"].numpy(), jinfo["truncated"], err_msg=f"step {t}")
        np.testing.assert_array_equal(s.time.numpy(), jtime, err_msg=f"step {t}")
        np.testing.assert_allclose(obs.numpy(), jobs, err_msg=f"step {t} obs", **TOL)
        np.testing.assert_allclose(reward.numpy(), jreward, err_msg=f"step {t} reward", **TOL)
        for k, v in jstate.items():
            np.testing.assert_allclose(s.state[k].numpy(), v, err_msg=f"step {t} {k}", **TOL)
        assert set(info) == set(jinfo), f"step {t}"
        if "success" in jinfo:
            np.testing.assert_allclose(info["success"].numpy(), jinfo["success"], err_msg=f"step {t}", **TOL)


def test_make_eval_env_has_its_own_task_and_width():
    cfg = make_config("pql", task="PointMass", num_envs=64, eval_num_envs=32)
    env = make_eval_env(cfg)
    assert env.num_envs == 32 and type(env.task).__name__ == "PointMass"
    assert make_eval_env(cfg).task is not env.task
