"""The off-policy baselines of the port against the JAX package, on the CPU.

- one ``train_iter`` of DDPG (with and without an actor target), SAC and
  CrossQ: a JAX agent runs warm-up and one iteration; its state is copied to
  numpy and carried into the port (``offpolicy_state_from_jax``), this
  iteration's draws are rebuilt from ``state.rng`` by the JAX package's own
  splits (the explore split, the rollout's three-way split per step, the
  update's ``split(k, update_times)`` and per update the sample and target
  keys, SAC's three-way split, ``replay_sample``'s slot and env keys), and
  both run the next iteration. Parameters, targets, ``log_alpha``, the
  BatchNorm statistics, losses, replay, obs-rms, episode statistics and
  counters are compared. PointMass with a warm-up of 98 steps makes every
  episode end in the compared iteration, so the trackers move;
- ``squashed_gaussian_sample_logprob`` and the flax-rule BatchNorm (train
  and eval) on seeded inputs;
- ``EpisodeStats`` against the JAX one in each info mode;
- ``get_algo`` and the config refuse what is not ported.

Tolerance rtol 1e-4 / atol 1e-5 with the Adam allowance of
tests/test_torch_pql.py::_assert_close.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import pre_batchnorm_biases
from pql_tpu.algos import get_algo as j_get_algo
from pql_tpu.cfg import make_config as j_make_config
from pql_tpu.envs import make_env as j_make_env
from pql_tpu.models import distributions as JD
from pql_tpu.models.mlp import DoubleQBatchNorm as JDoubleQBatchNorm
from pql_tpu.ops.noise import per_row_normal
from pql_tpu.utils.trackers import EpisodeStats as JEpisodeStats
from pql_tpu_torch import train
from pql_tpu_torch.algos import get_algo
from pql_tpu_torch.cfg import make_config, parse_cli
from pql_tpu_torch.models.distributions import squashed_gaussian_sample_logprob, tanh_log_det_jacobian
from pql_tpu_torch.models.mlp import BatchNorm, DoubleQBatchNorm
from pql_tpu_torch.utils.convert import load_offpolicy_state, offpolicy_state_from_jax, params_from_jax
from pql_tpu_torch.utils.trackers import EpisodeStats
from test_torch_pql import TOL, _adam, _assert_close, _copy
from test_torch_rigid import jax_reset_draws, jax_step_draws

SMALL = dict(num_envs=16, algo__batch_size=64, algo__memory_size=4096, algo__update_times=2)
EPISODE = dict(SMALL, task="PointMass", algo__warm_up=98)  # every episode ends in the compared iteration


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


def _jax_tree(s) -> dict:
    """The numpy tree ``offpolicy_state_from_jax`` takes, from a numpy JAX state."""

    def opt(o):
        adam = _adam(o)
        return dict(mu=adam.mu, nu=adam.nu, count=int(adam.count))

    st = s.stats
    tree = dict(
        actor_params=s.actor_params, actor_target=s.actor_target, critic_params=s.critic_params,
        critic_target=s.critic_target, actor_opt=opt(s.actor_opt), critic_opt=opt(s.critic_opt),
        obs_rms=dict(mean=s.obs_rms.mean, var=s.obs_rms.var, count=s.obs_rms.count),
        env_state=dict(state=dict(s.env_state.state), time=s.env_state.time), obs=s.obs,
        nstep=dict(obs=s.nstep.obs, action=s.nstep.action, reward=s.nstep.reward, next_obs=s.nstep.next_obs,
                   done=s.nstep.done, count=s.nstep.count),
        replay=dict(data=s.replay.data, ptr=s.replay.ptr, total_writes=s.replay.total_writes),
        stats=dict(current_returns=st.current_returns, current_lengths=st.current_lengths,
                   return_tracker=_tracker(st.return_tracker), step_tracker=_tracker(st.step_tracker),
                   success_tracker=_tracker(st.success_tracker), detailed_acc=st.detailed_acc,
                   detailed_tracker={k: _tracker(t) for k, t in st.detailed_tracker.items()},
                   info_acc=st.info_acc, info_tracker={k: _tracker(t) for k, t in st.info_tracker.items()}),
        env_steps=s.env_steps, update_count=s.update_count,
    )
    if hasattr(s, "log_alpha"):
        tree["log_alpha"] = s.log_alpha
        tree["alpha_opt"] = opt(s.alpha_opt)
    if hasattr(s, "batch_stats"):
        tree["batch_stats"] = s.batch_stats
    return tree


def _jax_draws(jagent, cfg, rng, sac: bool) -> dict:
    """One DDPG/SAC/CrossQ iteration's draws, rebuilt from the state's key as
    ``_explore`` (pql_tpu/algos/ddpg.py:119), ``rollout`` (base.py:181; the action function's
    split, base.py:113, or SAC's policy sample, sac.py:44), ``VecEnv.step``
    (envs/base.py:102) and ``_update`` (ddpg.py:218-219, 163; sac.py:62;
    replay/buffer.py:229-231) split it."""
    E, A, B, U = cfg.num_envs, jagent.env.action_dim, cfg.algo.batch_size, cfg.algo.update_times
    task, split = jagent.env.task, jax.random.split
    rng, k = split(rng)
    explore, reset, step = [], [], []
    for _ in range(cfg.algo.horizon_len):
        k, k_act, k_env = split(k, 3)
        if sac:
            explore.append(jax.random.normal(k_act, (E, A), jnp.float32))
        else:
            explore.append(per_row_normal(split(k_act)[1], (E, A), jnp.float32, 0))
        k_dyn, k_reset = split(k_env)
        reset.append(jax_reset_draws(task, jagent.env.env_keys(k_reset, 0)))
        step.append(jax_step_draws(task, jagent.env.env_keys(k_dyn, 0)))
    _, k = split(rng)
    out = {n: [] for n in ("sample_slot", "sample_env", "target_normal", "next_normal", "actor_normal")}
    for key in split(k, U):
        if sac:
            k_sample, k_next, k_cur = split(key, 3)
            out["next_normal"].append(jax.random.normal(k_next, (B, A), jnp.float32))
            out["actor_normal"].append(jax.random.normal(k_cur, (B, A), jnp.float32))
        else:
            k_sample, k_tgt = split(key)
            out["target_normal"].append(jax.random.normal(k_tgt, (B, A), jnp.float32))
        k_slot, k_env = split(k_sample)
        out["sample_slot"].append(jax.random.randint(k_slot, (B,), 0, 1 << 30))
        out["sample_env"].append(jax.random.randint(k_env, (B,), 0, E))
    t = lambda xs: torch.from_numpy(np.array(jnp.stack(xs)))  # noqa: E731
    draws = {n: t(v) for n, v in out.items() if v}
    draws["sample_slot"], draws["sample_env"] = draws["sample_slot"].long(), draws["sample_env"].long()
    draws["explore_normal"], draws["reset"] = t(explore), torch.stack(reset)
    if step[0] is not None:
        draws["step"] = torch.stack(step)
    return draws


CASES = [
    pytest.param("ddpg", EPISODE, id="ddpg"),
    pytest.param("ddpg", dict(SMALL, task="Cartpole", algo__warm_up=4, algo__no_tgt_actor=False),
                 id="ddpg-actor_target"),
    pytest.param("sac", dict(EPISODE, info_track_keys=("success",), info_track_step=("all-episode",)), id="sac"),
    pytest.param("crossq", dict(EPISODE, info_track_keys=("success",), info_track_step=("all-step",)), id="crossq"),
]


@pytest.mark.parametrize("algo,size", CASES)
def test_one_iteration_matches_jax(algo, size):
    jcfg = j_make_config(algo, **size)
    jagent = j_get_algo(jcfg.algo.name)(jcfg, j_make_env(jcfg))
    jstate, _ = jagent.warmup(jagent.init(jax.random.PRNGKey(0)))
    jstate, _ = jagent.train_iter(jstate)  # moments and targets off their initial values
    before = _copy(jstate)
    draws = _jax_draws(jagent, jcfg, jstate.rng, sac=algo == "sac")
    jstate, jmetrics = jagent.train_iter(jstate)
    after = _copy(jstate)

    agent = get_algo(jcfg.algo.name)(make_config(algo, **size), device="cpu")
    state = agent.init()
    load_offpolicy_state(state, offpolicy_state_from_jax(_jax_tree(before), before.replay.layout))
    state, metrics = agent.train_iter(state, draws)

    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), err_msg=k, **TOL)
    lr, U = jcfg.algo.actor_lr, jcfg.algo.update_times  # actor_lr == critic_lr
    _assert_close(state.actor.state_dict(), params_from_jax(after.actor_params), "actor", 2 * lr * U)
    critic = {k: v for k, v in state.critic.state_dict().items() if not k.endswith((".mean", ".var"))}
    # CrossQ: a train-mode BatchNorm subtracts its batch's mean, so the bias
    # of the Linear before it gets a gradient that is zero but for rounding
    pre_bn = pre_batchnorm_biases(state.critic)
    assert len(pre_bn) == (6 if algo == "crossq" else 0)
    _assert_close(critic, params_from_jax(after.critic_params), "critic", 2 * lr * U, noise=pre_bn)
    if algo == "crossq":
        assert state.critic_target is None
        stats = {k: v for k, v in state.critic.state_dict().items() if k.endswith((".mean", ".var"))}
        want = params_from_jax(after.batch_stats)
        assert set(stats) == set(want) and len(want) == 12  # 2 heads x 3 BatchNorms x (mean, var)
        for k in want:
            np.testing.assert_allclose(stats[k].numpy(), want[k].numpy(), err_msg=k, **TOL)
        assert not np.allclose(after.batch_stats["net_q1"]["BatchNorm_0"]["mean"],
                               before.batch_stats["net_q1"]["BatchNorm_0"]["mean"])
    else:
        _assert_close(state.critic_target.state_dict(), params_from_jax(after.critic_target),
                             "critic_target", 2 * lr * U)
    if state.actor_target is not None:
        _assert_close(state.actor_target.state_dict(), params_from_jax(after.actor_target),
                             "actor_target", 2 * lr * U)
    else:  # no_tgt_actor: the JAX target is the actor
        assert jcfg.algo.no_tgt_actor
    if algo == "sac":
        np.testing.assert_allclose(state.log_alpha.detach().numpy(), after.log_alpha, **TOL)
        assert float(after.log_alpha[0]) != float(before.log_alpha[0])

    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(state.obs_rms, k).numpy(), getattr(after.obs_rms, k), **TOL)
    for name, s, d in after.replay.layout:
        np.testing.assert_allclose(state.replay.field(name).numpy(), after.replay.data[..., s : s + d],
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(state.obs.numpy(), after.obs, **TOL)
    assert (state.replay.ptr, state.replay.total_writes) == (int(after.replay.ptr), int(after.replay.total_writes))
    want_stats = offpolicy_state_from_jax(_jax_tree(after), after.replay.layout)["stats"]
    got_stats = state.stats.state_dict()
    assert set(got_stats["trackers"]) == set(want_stats["trackers"])
    for name, v in want_stats["accumulators"].items():
        np.testing.assert_allclose(got_stats["accumulators"][name].numpy(), v.numpy(), err_msg=name, **TOL)
    for name, t in want_stats["trackers"].items():
        for k in ("ring", "ptr", "count"):
            np.testing.assert_allclose(got_stats["trackers"][name][k].numpy(), t[k].numpy(), err_msg=f"{name}.{k}",
                                       **TOL)
    if algo != "ddpg" or size is EPISODE:
        assert int(after.stats.return_tracker.count) == 16  # every episode ended in the compared iteration
    assert (state.env_steps, state.update_count) == (int(after.env_steps), int(after.update_count))
    assert state.update_count == 2 * U and state.env_steps == (jcfg.algo.warm_up + 2) * jcfg.num_envs


def test_squashed_gaussian_matches_jax():
    rng = np.random.default_rng(0)
    mu = rng.normal(size=(64, 3)).astype(np.float32) * 3.0
    log_std = rng.uniform(-5.0, 2.0, size=(64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    a_want, lp_want = JD.squashed_gaussian_sample_logprob(key, jnp.asarray(mu), jnp.asarray(log_std))
    normal = torch.from_numpy(np.array(jax.random.normal(key, mu.shape, jnp.float32)))
    a, lp = squashed_gaussian_sample_logprob(normal, torch.from_numpy(mu), torch.from_numpy(log_std))
    assert lp.shape == (64, 1)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_want), **TOL)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_want), rtol=1e-4, atol=1e-4)
    u = torch.tensor([-40.0, -10.0, 0.0, 10.0, 40.0])
    got = tanh_log_det_jacobian(u)
    assert torch.isfinite(got).all()  # log(1 - tanh²) is -inf here
    np.testing.assert_allclose(got.numpy(), np.asarray(JD.tanh_log_det_jacobian(jnp.asarray(u.numpy()))), **TOL)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batchnorm_matches_flax(train):
    """One BatchNorm alone, then the CrossQ critic (six of them): outputs,
    and in train mode the committed running statistics (flax momentum 0.9
    on the batch's biased variance), from the same scale, bias and running
    statistics."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(256, 24)) * 3.0 + 1.5).astype(np.float32)
    scale, bias = rng.normal(size=24).astype(np.float32), rng.normal(size=24).astype(np.float32)
    mean, var = rng.normal(size=24).astype(np.float32), rng.uniform(0.5, 2.0, size=24).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}
    y_want, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm(24)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          dict(scale=scale, bias=bias, mean=mean, var=var).items()})
    y = port(torch.from_numpy(x), train)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_want), **TOL)
    if train:
        port.commit()
    for k in ("mean", "var"):  # unchanged in eval mode
        np.testing.assert_allclose(getattr(port, k).numpy(), np.asarray(upd["batch_stats"][k]), **TOL)

    obs, act = rng.normal(size=(128, 6)).astype(np.float32), rng.uniform(-1, 1, size=(128, 2)).astype(np.float32)
    jcritic = JDoubleQBatchNorm()
    jvars = jcritic.init(jax.random.PRNGKey(0), jnp.zeros((1, 6)), jnp.zeros((1, 2)))
    jvars = jax.tree_util.tree_map(lambda v: v + 0.1 * jnp.ones_like(v), jvars)  # stats off their init
    (q1, q2), jupd = jcritic.apply(jvars, jnp.asarray(obs), jnp.asarray(act), train=train, mutable=["batch_stats"])
    critic = DoubleQBatchNorm(6, 2)
    critic.load_state_dict({**params_from_jax(_copy(jvars["params"])), **params_from_jax(_copy(jvars["batch_stats"]))})
    g1, g2 = critic(torch.from_numpy(obs), torch.from_numpy(act), train)
    for g, w in ((g1, q1), (g2, q2)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    if train:
        critic.commit_batch_stats()
    want = params_from_jax(_copy(jupd["batch_stats"]))
    for k, v in want.items():
        np.testing.assert_allclose(critic.state_dict()[k].numpy(), v.numpy(), err_msg=k, rtol=1e-4, atol=1e-4)


def test_episode_stats_match_jax():
    """Random rewards, dones and info over 40 steps of 8 envs, tracker length
    16: return, length and success, two detailed-reward terms, and one info
    key per mode (last, all-episode, all-step)."""
    E, L, T = 8, 16, 40
    rng = np.random.default_rng(2)
    keys, modes = ("a", "b", "c"), ("last", "all-episode", "all-step")
    jst = JEpisodeStats.create(E, L, detailed_keys=("x", "y"), info_keys=keys, info_modes=modes)
    st = EpisodeStats(E, L, detailed_keys=("x", "y"), info_keys=keys, info_modes=modes, device="cpu")
    update = jax.jit(lambda s, r, d, i: s.update(r, d, i))
    for _ in range(T):
        reward = rng.normal(size=E).astype(np.float32)
        done = (rng.uniform(size=E) < 0.2).astype(np.float32)
        info = {"success": (rng.uniform(size=E) < 0.5).astype(np.float32),
                "detailed_reward": {k: rng.normal(size=E).astype(np.float32) for k in ("x", "y")},
                **{k: rng.normal(size=E).astype(np.float32) for k in keys}}
        jst = update(jst, reward, done, info)
        st.update(torch.from_numpy(reward), torch.from_numpy(done),
                  jax.tree_util.tree_map(torch.from_numpy, info))
    jm, m = jst.metrics(), st.metrics()
    assert set(m) == set(jm) == {"train/return", "train/episode_length", "train/success_rate",
                                 "train/detailed_reward/x", "train/detailed_reward/y", "a", "b", "c"}
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k, **TOL)
    for name, t in (("a", jst.info_tracker["a"]), ("c", jst.info_tracker["c"]), ("x", jst.detailed_tracker["x"])):
        got = st.trackers()[f"{'detailed' if name == 'x' else 'info'}/{name}"]
        np.testing.assert_allclose(got.ring.numpy(), np.asarray(t.ring), **TOL)
        assert int(got.count) == int(t.count)
    assert int(st.trackers()["info/c"].count) == E * T  # every step of every env
    np.testing.assert_allclose(st.info_acc["b"].numpy(), np.asarray(jst.info_acc["b"]), **TOL)
    with pytest.raises(ValueError, match="info_track_step"):
        EpisodeStats(E, L, info_keys=("a",), info_modes=("every",), device="cpu")


@pytest.mark.parametrize("name", ["PPOV", "IPPOV", "DDPGV"])
def test_get_algo_refuses_unported(name):
    """DDPGV (the vision tier's off-policy half) is refused by name; PPOV and
    IPPOV, refused until the vision tier's on-policy half was ported, now
    resolve, as does every other name."""
    if name != "DDPGV":
        assert get_algo(name).name == name
        return
    with pytest.raises(NotImplementedError, match=r"'DDPGV' is not ported yet: it comes with the host replay ring"):
        get_algo(name)
    with pytest.raises(NotImplementedError, match=r"not ported yet; ported: \['CrossQ', 'DDPG', 'EQ', 'EQG', 'EQS', "
                                                  r"'EQS4', 'EQSC', 'EQSD', 'EQSD2', 'EQSdata', 'IART', 'IDDPG', "
                                                  r"'IPPO', 'IPPOTeam', 'IPPOTeam2', 'IPPOV', 'MAPPO', 'MP', 'PPO', "
                                                  r"'PPOV', 'PQL', 'QTOTV1', 'QTOTV2', 'SAC'\]"):
        get_algo("NoSuchAgent")


def test_config_refuses_unported(tmp_path):
    with pytest.raises(ValueError, match="Unknown algo 'ddpgv'"):
        parse_cli(["algo=ddpgv"])
    with pytest.raises(NotImplementedError, match="'DDPGV' is not ported yet"):
        train.main(["algo=ddpg", "algo.name=DDPGV", f"logging.out_dir={tmp_path}", "--device=cpu"])
    assert not os.listdir(tmp_path)  # refused before the run directory is made
    with pytest.raises(AttributeError, match="No config field 'mesh_axis'"):
        parse_cli(["algo=ddpg", "mesh_axis=env"])
    cfg = parse_cli(["algo=sac", "info_track_keys=[success]", "algo.alpha=0.2"])
    assert (cfg.algo.name, cfg.algo.act_class, cfg.info_track_keys, cfg.algo.alpha) == (
        "SAC", "TanhDiagGaussianMLPPolicy", ("success",), 0.2)
    assert parse_cli(["algo=crossq"]).algo.cri_class == "DoubleQBatchNorm"
