"""PPO of the port against the JAX package, on the CPU.

- ``DiagGaussianMLPPolicy``: mean, sample (the JAX normal injected),
  log-prob and entropy from the same flax params; ``MLPCritic``'s values;
- GAE: the JAX ``PPO._compute_adv`` and the port's ``_advantages`` on one
  random trajectory (terminations and truncations inside the horizon, a
  done final step), with ``use_gae`` and ``value_norm`` each on and off:
  advantages, returns, old values, the value-rms after its three updates;
- population std: the per-minibatch whitening uses ddof 0 (``jnp.std``);
- one ``train_iter``: a JAX PPO runs one iteration; its state is copied to
  numpy and carried into the port (``ppo_state_from_jax``); this
  iteration's draws are rebuilt from ``state.rng`` by the JAX package's own
  splits (``_train_iter``'s three-way split, the rollout's per-step
  ``split(k, 3)``, ``VecEnv.step``'s reset keys, the epochs'
  ``split(k_perm, update_times)`` and ``permutation``); both run the next
  iteration. Cartpole with a 6-step time limit and horizon 8, so episodes
  are truncated inside the horizon; with and without ``value_norm``;
- the ``horizon_len · num_envs % batch_size`` refusal; the eval hook.

Tolerance rtol 1e-4 / atol 1e-5 with the Adam allowance of
tests/test_torch_pql.py::_assert_close.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pql_tpu.algos import get_algo as j_get_algo
from pql_tpu.cfg import make_config as j_make_config
from pql_tpu.envs import make_env as j_make_env
from pql_tpu.models.mlp import DiagGaussianMLPPolicy as JGaussian
from pql_tpu.models.mlp import MLPCritic as JCritic
from pql_tpu_torch.algos import get_algo
from pql_tpu_torch.algos import ma_base
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.models.mlp import DiagGaussianMLPPolicy, MLPCritic
from pql_tpu_torch.utils.convert import load_ppo_state, ma_state_from_jax, params_from_jax, ppo_state_from_jax
from test_torch_pql import TOL, _adam, _assert_close, _copy
from test_torch_rigid import jax_reset_draws, jax_step_draws

SMALL = dict(task="Cartpole", num_envs=16, algo__horizon_len=8, algo__batch_size=32, algo__update_times=2)
MAX_LEN = 6  # episodes are truncated inside the horizon


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tracker(t) -> dict:
    return dict(ring=t.ring, ptr=t.ptr, count=t.count)


def stats_tree(st) -> dict:
    """A numpy JAX EpisodeStats as ``utils/convert.py`` takes it."""
    return dict(current_returns=st.current_returns, current_lengths=st.current_lengths,
                return_tracker=_tracker(st.return_tracker), step_tracker=_tracker(st.step_tracker),
                success_tracker=_tracker(st.success_tracker), detailed_acc=st.detailed_acc,
                detailed_tracker={k: _tracker(t) for k, t in st.detailed_tracker.items()},
                info_acc=st.info_acc, info_tracker={k: _tracker(t) for k, t in st.info_tracker.items()})


def opt_tree(o) -> dict:
    adam = _adam(o)
    return dict(mu=adam.mu, nu=adam.nu, count=int(adam.count))


def rms_tree(r) -> dict:
    return dict(mean=r.mean, var=r.var, count=r.count)


def onpolicy_tree(s) -> dict:
    """The numpy tree ``ppo_state_from_jax`` / ``ma_state_from_jax`` take,
    from a numpy JAX PPO, MAPPO, IPPO, EQSC, PPOV or IPPOV state."""
    tree = dict(obs_rms=rms_tree(s.obs_rms), env_state=dict(state=dict(s.env_state.state), time=s.env_state.time),
                obs=s.obs, dones=s.dones, stats=stats_tree(s.stats), env_steps=s.env_steps,
                update_count=s.update_count)
    if hasattr(s, "value_rms"):  # PPOV's state has none
        tree["value_rms"] = rms_tree(s.value_rms)
    if hasattr(s, "params"):
        tree.update(params=s.params, opts={k: opt_tree(o) for k, o in s.opts.items()})
        if hasattr(s, "value_rms_left"):  # EQSC's state has one value-rms
            tree["value_rms_left"] = rms_tree(s.value_rms_left)
    else:
        tree.update(actor_params=s.actor_params, critic_params=s.critic_params, actor_opt=opt_tree(s.actor_opt),
                    critic_opt=opt_tree(s.critic_opt))
    return tree


def rollout_draws(jenv, keys, normals) -> dict:
    """The rollout draws of ``keys`` (one action key and one env key per
    step): the policy normals from ``normals(k_a)``, the reset and per-step
    draws from ``VecEnv.step``'s split of the env key."""
    out = {}
    for k_a, k_e in keys:
        for name, x in normals(k_a).items():
            out.setdefault(name, []).append(torch.from_numpy(np.array(x)))
        k_dyn, k_reset = jax.random.split(k_e)
        out.setdefault("reset", []).append(jax_reset_draws(jenv.task, jenv.env_keys(k_reset, 0)))
        step = jax_step_draws(jenv.task, jenv.env_keys(k_dyn, 0))
        if step is not None:
            out.setdefault("step", []).append(step)
    return {k: torch.stack(v) for k, v in out.items()}


def jax_iteration_draws(jagent, cfg, rng, normals, rows: int) -> dict:
    """One on-policy iteration's draws, rebuilt from ``state.rng``:
    ``rng, k_roll, k_perm = split(rng, 3)`` (ppo.py:264, ippo.py:306,
    mappo.py:143); per rollout step ``k, k_a, k_e = split(k, 3)`` (IPPO:
    ``k, k_r, k_l, k_e = split(k, 4)``, handled by ``normals`` taking the
    step's key list); one permutation of ``rows`` per epoch key."""
    _, k, k_perm = jax.random.split(rng, 3)
    two_hands = type(jagent).__name__ in ("IPPO", "IPPOV")
    keys = []
    for _ in range(cfg.algo.horizon_len):
        if two_hands:
            k, k_r, k_l, k_e = jax.random.split(k, 4)
            keys.append(((k_r, k_l), k_e))
        else:
            k, k_a, k_e = jax.random.split(k, 3)
            keys.append((k_a, k_e))
    draws = rollout_draws(jagent.env, keys, normals)
    draws["perm"] = torch.stack([torch.from_numpy(np.array(jax.random.permutation(key, rows))).long()
                                 for key in jax.random.split(k_perm, cfg.algo.update_times)])
    return draws


def assert_onpolicy_state(state, after, what):
    """Normalizers, obs, dones, episode statistics and counters of a port
    state against a numpy JAX state."""
    for name in ("obs_rms", "value_rms", "value_rms_left"):
        if hasattr(after, name):
            for k in ("mean", "var", "count"):
                np.testing.assert_allclose(getattr(getattr(state, name), k).numpy(),
                                           getattr(getattr(after, name), k), err_msg=f"{what} {name}.{k}", **TOL)
    np.testing.assert_allclose(state.obs.numpy(), after.obs, err_msg=f"{what} obs", **TOL)
    np.testing.assert_array_equal(state.dones.numpy(), after.dones)
    want = ma_state_from_jax(onpolicy_tree(after))["stats"]
    got = state.stats.state_dict()
    assert set(got["trackers"]) == set(want["trackers"])
    for name, v in want["accumulators"].items():
        np.testing.assert_allclose(got["accumulators"][name].numpy(), v.numpy(), err_msg=name, **TOL)
    for name, t in want["trackers"].items():
        for k in ("ring", "ptr", "count"):
            np.testing.assert_allclose(got["trackers"][name][k].numpy(), t[k].numpy(), err_msg=f"{name}.{k}", **TOL)
    assert (state.env_steps, state.update_count) == (int(after.env_steps), int(after.update_count))


def _gaussian_normals(shape):
    return lambda k_a: {"action_normal": jax.random.normal(k_a, shape, jnp.float32)}


# ------------------------------------------------------------------ models


def test_gaussian_policy_matches_jax():
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(32, 8)).astype(np.float32)
    jmodel = JGaussian(act_dim=3)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)))
    params["params"]["logstd"] = jnp.asarray(rng.uniform(-1.5, 0.5, size=3), jnp.float32)
    model = DiagGaussianMLPPolicy(8, 3)
    model.load_state_dict(params_from_jax(_copy(params)))
    assert model.logstd.dtype == torch.float32

    key = jax.random.PRNGKey(3)
    a_want, lp_want, ent_want = jmodel.apply(params, jnp.asarray(obs), key, method=JGaussian.sample)
    normal = torch.from_numpy(np.array(jax.random.normal(key, (32, 3), jnp.float32)))
    with torch.no_grad():
        mean, log_std = model(torch.from_numpy(obs))
        a, lp, ent = model.sample(torch.from_numpy(obs), normal)
        lp2, ent2 = model.logprob_entropy(torch.from_numpy(obs), torch.from_numpy(np.array(a_want)))
    m_want, ls_want = jmodel.apply(params, jnp.asarray(obs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(m_want), **TOL)
    np.testing.assert_allclose(log_std.detach().numpy(), np.asarray(ls_want), **TOL)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_want), **TOL)
    for got, want in ((lp, lp_want), (ent, ent_want), (lp2, lp_want), (ent2, ent_want)):
        assert got.shape == (32,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_mlp_critic_matches_jax():
    obs = np.random.default_rng(1).normal(size=(64, 11)).astype(np.float32)
    jcritic = JCritic()
    params = jcritic.init(jax.random.PRNGKey(1), jnp.zeros((1, 11)))
    critic = MLPCritic(11)
    critic.load_state_dict(params_from_jax(_copy(params)))
    with torch.no_grad():
        got = critic(torch.from_numpy(obs))
    assert got.shape == (64, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jcritic.apply(params, jnp.asarray(obs))), **TOL)


# --------------------------------------------------------------------- GAE


def _agents(algo, **size):
    jcfg = j_make_config(algo, **size)
    jagent = j_get_algo(jcfg.algo.name)(jcfg, j_make_env(jcfg))
    agent = get_algo(jcfg.algo.name)(make_config(algo, **size), device="cpu")
    return jcfg, jagent, agent


@pytest.mark.parametrize("use_gae", [True, False], ids=["gae", "returns"])
@pytest.mark.parametrize("value_norm", [False, True], ids=["raw", "value_norm"])
def test_gae_matches_jax(use_gae, value_norm):
    T, E = 8, 16
    jcfg, jagent, agent = _agents("ppo", **SMALL, algo__use_gae=use_gae, algo__value_norm=value_norm)
    js = jagent.init(jax.random.PRNGKey(0))
    js, _ = jagent.train_iter(js)  # normalizers off their initial values
    rs = np.random.RandomState(3)
    traj = {
        "obs": rs.randn(T, E, 4).astype(np.float32),
        "dones": (rs.rand(T, E) < 0.2).astype(np.float32),
        "action": rs.randn(T, E, 1).astype(np.float32),
        "logp": rs.randn(T, E).astype(np.float32),
        "reward": rs.randn(T, E).astype(np.float32),
        "value": rs.randn(T, E).astype(np.float32),
        "truncated": (rs.rand(T, E) < 0.15).astype(np.float32),
    }
    traj["truncated"] *= 1.0 - np.roll(traj["dones"], -1, 0)  # a truncation is not also a termination
    final_dones = (rs.rand(E) < 0.3).astype(np.float32)
    js = js.replace(dones=jnp.asarray(final_dones))
    before = _copy(js)
    js2, (b_obs, b_act, b_logp, b_adv, b_ret, b_val) = jagent._compute_adv(
        js, {k: jnp.asarray(v) for k, v in traj.items()})
    after = _copy(js2)

    state = agent.init()
    load_ppo_state(state, ppo_state_from_jax(onpolicy_tree(before)))
    obs_n, act, logp, adv, ret, val = agent._advantages(state, {k: torch.from_numpy(v) for k, v in traj.items()})
    want_obs = np.asarray(js.obs_rms.normalize(b_obs))
    np.testing.assert_allclose(obs_n.numpy(), want_obs, **TOL)
    for got, want, name in ((act, b_act, "action"), (logp, b_logp, "logp"), (adv, b_adv, "adv"),
                            (ret, b_ret, "returns"), (val, b_val, "values")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **TOL)
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(state.value_rms, k).numpy(), getattr(after.value_rms, k), **TOL)
    assert float(after.value_rms.count) > 1.0 if value_norm else float(after.value_rms.count) < 1.0
    assert traj["truncated"].sum() > 0 and traj["dones"].sum() > 0


def test_advantages_are_whitened_by_the_population_std():
    adv = torch.tensor([1.0, 2.0, 4.0, 7.0])
    got = ma_base.normalize_advantages(adv)
    np.testing.assert_allclose(got.numpy(), np.asarray((jnp.asarray(adv.numpy()) - 3.5) / (jnp.std(
        jnp.asarray(adv.numpy())) + 1e-8)), **TOL)
    assert not np.allclose(got.numpy(), ((adv - adv.mean()) / (adv.std() + 1e-8)).numpy(), rtol=1e-3)


# --------------------------------------------------------------- iteration


@pytest.mark.parametrize("extra", [{}, dict(algo__value_norm=True, algo__lambda_entropy=0.01)],
                         ids=["plain", "value_norm"])
def test_one_iteration_matches_jax(extra):
    jcfg, jagent, agent = _agents("ppo", **SMALL, **extra)
    jagent.env.max_episode_length = agent.env.max_episode_length = MAX_LEN
    js = jagent.init(jax.random.PRNGKey(0))
    js, _ = jagent.train_iter(js)  # moments off their initial values
    before = _copy(js)
    A, E = jagent.env.action_dim, jcfg.num_envs
    draws = jax_iteration_draws(jagent, jcfg, js.rng, _gaussian_normals((E, A)), jcfg.algo.horizon_len * E)
    js, jmetrics = jagent.train_iter(js)
    after = _copy(js)

    state = agent.init()
    load_ppo_state(state, ppo_state_from_jax(onpolicy_tree(before)))
    state, metrics = agent.train_iter(state, draws)

    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), err_msg=k, rtol=1e-4, atol=1e-4)
    n_updates = jcfg.algo.update_times * jcfg.algo.horizon_len * E // jcfg.algo.batch_size
    _assert_close(state.actor.state_dict(), params_from_jax(after.actor_params), "actor", 2 * jcfg.algo.actor_lr * n_updates)
    _assert_close(state.critic.state_dict(), params_from_jax(after.critic_params), "critic",
                  2 * jcfg.algo.critic_lr * n_updates)
    assert_onpolicy_state(state, after, "ppo")
    assert int(after.stats.return_tracker.count) > int(before.stats.return_tracker.count)  # episodes ended
    assert state.update_count == 2 * n_updates and state.env_steps == 2 * jcfg.algo.horizon_len * E


def test_batch_divisibility_is_refused():
    with pytest.raises(ValueError, match="must be divisible by batch_size"):
        get_algo("PPO")(make_config("ppo", **dict(SMALL, algo__horizon_len=3)), device="cpu")


def test_eval_hook_is_the_mean():
    jcfg, jagent, agent = _agents("ppo", **SMALL)
    js = _copy(jagent.init(jax.random.PRNGKey(2)))
    state = agent.init()
    load_ppo_state(state, ppo_state_from_jax(onpolicy_tree(js)))
    obs = np.random.default_rng(4).normal(size=(16, 4)).astype(np.float32)
    want = jagent.eval_actor_apply(js.actor_params, jnp.asarray(obs))
    with torch.no_grad():
        got = agent.eval_actor_apply(state.actor, torch.from_numpy(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not hasattr(agent, "warmup")
