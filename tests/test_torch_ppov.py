"""The visual PPO agents of the port against the JAX package, on the CPU
(PPOV here, IPPOV in tests/test_torch_ippov.py through the same helpers).

- one ``PPOV.train_iter`` on ReacherVision (4 envs, horizon 4, batch 8, one
  epoch: tests/test_vision.py's size; the ResNet encoder at full width) and
  one ``IPPOV.train_iter`` on BimanualReacherVision (8 envs, batch 16): a
  JAX agent runs one iteration, its state is carried into the port
  (``ppo_state_from_jax`` / ``ma_state_from_jax``) and both run the next
  from the JAX draws (``test_torch_ppo.jax_iteration_draws``), with the
  episodes cut at 3 steps so the auto-reset (and ``q_prev``) runs inside
  the horizon: params, Adam moments, losses, normalizers, obs, dones,
  statistics, counters;
- the eval hooks from the state's env state (``needs_env_state``);
- the refusal of a task without proprio / point cloud (and DDPGV's of a
  task without a camera); the ``ppov``, ``ippov`` and ``ddpgv`` presets
  equal to the JAX ones.

Tolerance rtol 1e-4 / atol 1e-5 with the Adam allowance of
tests/test_torch_pql.py::_assert_close; metrics rtol/atol 1e-4 as
tests/test_torch_ppo.py's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pql_tpu.cfg import make_config as j_make_config
from pql_tpu_torch.algos import get_algo
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.envs.base import VecEnvState
from pql_tpu_torch.utils.convert import load_ppo_state, ma_state_from_jax, params_from_jax, ppo_state_from_jax
from test_torch_ppo import _agents, _gaussian_normals, assert_onpolicy_state, jax_iteration_draws, onpolicy_tree
from test_torch_pql import TOL, _adam, _assert_close, _copy

SIZES = {"ppov": dict(task="ReacherVision", num_envs=4, algo__horizon_len=4, algo__batch_size=8,
                      algo__update_times=1),
         "ippov": dict(task="BimanualReacherVision", num_envs=8, algo__horizon_len=4, algo__batch_size=16,
                       algo__update_times=1)}
MAX_LEN = 3  # episodes end inside the horizon


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normals(algo, E):
    if algo == "ppov":
        return _gaussian_normals((E, 2))
    return lambda ks: {"action_normal": jax.random.normal(ks[0], (E, 2), jnp.float32),
                       "action_normal_left": jax.random.normal(ks[1], (E, 2), jnp.float32)}


def _port_moments(module, opt):
    st = [opt.state[p] for _, p in module.named_parameters()]
    names = [n for n, _ in module.named_parameters()]
    return ({n: s["exp_avg"] for n, s in zip(names, st)}, {n: s["exp_avg_sq"] for n, s in zip(names, st)})


def _converted(algo, before):
    tree = onpolicy_tree(before)
    return ppo_state_from_jax(tree) if algo == "ppov" else ma_state_from_jax(tree)


def one_iteration(algo):
    size = SIZES[algo]
    jcfg, jagent, agent = _agents(algo, **size)
    jagent.env.max_episode_length = agent.env.max_episode_length = MAX_LEN
    js = jagent.init(jax.random.PRNGKey(0))
    js, _ = jagent.train_iter(js)  # moments off their initial values
    before = _copy(js)
    E, H = size["num_envs"], size["algo__horizon_len"]
    draws = jax_iteration_draws(jagent, jcfg, js.rng, _normals(algo, E), H * E)
    js, jmetrics = jagent.train_iter(js)
    after = _copy(js)

    state = agent.init()
    load_ppo_state(state, _converted(algo, before))
    if algo == "ppov":
        assert not hasattr(state, "value_rms") and state.env_state.state.keys() == before.env_state.state.keys()
    state, metrics = agent.train_iter(state, draws)

    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), err_msg=k, rtol=1e-4, atol=1e-4)
    n_updates = jcfg.algo.update_times * H * E // jcfg.algo.batch_size
    bound = 2 * jcfg.algo.actor_lr * n_updates
    if algo == "ppov":
        nets = {"actor": (state.actor, state.actor_opt, after.actor_params, after.actor_opt),
                "critic": (state.critic, state.critic_opt, after.critic_params, after.critic_opt)}
    else:
        assert set(after.params) == set(state.nets) == {"actor", "actor_left", "critic", "critic_left"}
        nets = {k: (state.nets[k], state.opts[k], after.params[k], after.opts[k]) for k in after.params}
    for name, (module, opt, jparams, jopt) in nets.items():
        _assert_close(module.state_dict(), params_from_jax(jparams), name, bound)
        mu, nu = _port_moments(module, opt)
        adam = _adam(jopt)
        _assert_close(mu, params_from_jax(adam.mu), f"{name} mu", 1.0)
        _assert_close(nu, params_from_jax(adam.nu), f"{name} nu", 1.0)
        assert all(int(opt.state[p]["step"]) == int(adam.count) for p in module.parameters())
    assert_onpolicy_state(state, after, algo)
    assert int(after.stats.return_tracker.count) > int(before.stats.return_tracker.count)  # episodes ended
    assert state.update_count == 2 * n_updates and state.env_steps == 2 * H * E


def eval_hook(algo):
    jcfg, jagent, agent = _agents(algo, **SIZES[algo])
    js = _copy(jagent.init(jax.random.PRNGKey(2)))
    state = agent.init()
    load_ppo_state(state, _converted(algo, js))
    obs = np.random.default_rng(3).normal(size=js.obs.shape).astype(np.float32)
    params = js.actor_params if algo == "ppov" else js.params
    want = jagent.eval_actor_apply(params, jnp.asarray(obs), jax.tree_util.tree_map(jnp.asarray, js.env_state))
    assert agent.eval_actor_apply.needs_env_state and jagent.eval_actor_apply.needs_env_state
    with torch.no_grad():
        got = agent.eval_actor_apply(agent.eval_params(state), torch.from_numpy(obs), state.env_state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert isinstance(state.env_state, VecEnvState)


def test_one_iteration_matches_jax():
    one_iteration("ppov")


def test_eval_hook_renders_from_the_env_state():
    eval_hook("ppov")


def test_refusals_and_presets():
    for algo, task in (("ppov", "Cartpole"), ("ippov", "BimanualReacher")):
        with pytest.raises(ValueError, match="needs a vision task exposing proprio/pointcloud"):
            get_algo(algo.upper())(make_config(algo, task=task, num_envs=4, algo__batch_size=8), device="cpu")
    with pytest.raises(ValueError, match="DDPGV needs a camera task"):
        get_algo("DDPGV")(make_config("ddpgv", task="BimanualReacherVision", num_envs=4, algo__batch_size=8,
                                      algo__memory_size=64), device="cpu")
    for algo in ("ppov", "ippov", "ddpgv"):
        want = dataclasses.asdict(j_make_config(algo).algo)
        got = dataclasses.asdict(make_config(algo).algo)
        assert {k: (v, want.get(k, "missing")) for k, v in got.items() if want.get(k, "missing") != v} == {}
        assert got["name"] == algo.upper() and got["encoder_weights"] is None
        assert got["horizon_len"] == (1 if algo == "ddpgv" else 16)
    agent = get_algo("PPOV")(make_config("ppov", **SIZES["ppov"]), device="cpu")
    assert agent.has_camera and agent.init().actor.encoder is not None
