"""QTOTV1 and QTOTV2 of the port against the JAX package, on the CPU.

- one iteration of each, with ``value_norm`` off and on, from a converted
  JAX state with the JAX draws (IPPO's splits: ``_train_iter``'s three-way
  split, the rollout's ``k, k_r, k_l, k_e = split(k, 4)`` per step, one
  permutation of the H·E rows per epoch key, shared by the three streams);
  episodes truncated at 6 steps inside a horizon of 8: every network (the
  total critic included), the losses, the normalizers (``value_rms_tot``,
  moved three times per iteration and never in the rollout), obs, dones,
  episode statistics and counters;
- the eval hook; the ``same_policy`` refusal; kill and resume bitwise.

Tolerance rtol 1e-4 / atol 1e-5 with the Adam allowance of
tests/test_torch_pql.py::_assert_close.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import state_diffs
from pql_tpu_torch.algos import get_algo
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.utils import checkpoint
from pql_tpu_torch.utils.convert import load_ppo_state, ma_state_from_jax, params_from_jax
from test_torch_ppo import _agents, assert_onpolicy_state, onpolicy_tree, rms_tree, rollout_draws
from test_torch_pql import TOL, _assert_close, _copy

E, H, MAX_LEN = 16, 8, 6
SMALL = dict(task="BimanualReacher", num_envs=E, algo__horizon_len=H, algo__batch_size=32, algo__update_times=2)
NETS = ("actor", "critic", "actor_left", "critic_left", "critic_tot")


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def onpolicy_draws(jagent, cfg, rng, n_keys: int, normals, rows: int) -> dict:
    """One on-policy iteration's draws, rebuilt from ``state.rng``: ``rng,
    k_roll, k_perm = split(rng, 3)``; per rollout step ``k, *k_actions, k_e =
    split(k, n_keys)``, ``normals`` taking the step's action keys; one
    permutation of ``rows`` per epoch key."""
    _, k, k_perm = jax.random.split(rng, 3)
    keys = []
    for _ in range(cfg.algo.horizon_len):
        k, *k_act, k_e = jax.random.split(k, n_keys)
        keys.append((k_act, k_e))
    draws = rollout_draws(jagent.env, keys, normals)
    draws["perm"] = torch.stack([torch.from_numpy(np.array(jax.random.permutation(key, rows))).long()
                                 for key in jax.random.split(k_perm, cfg.algo.update_times)])
    return draws


def ma_tree(s) -> dict:
    """``onpolicy_tree`` of a two-agent JAX state, with QTOT's ``value_rms_tot``."""
    tree = onpolicy_tree(s)
    if getattr(s, "value_rms_tot", None) is not None:  # EQSC's state has none
        tree["value_rms_tot"] = rms_tree(s.value_rms_tot)
    return tree


def _hand_normals(ks):
    a = 2
    return {"action_normal": jax.random.normal(ks[0], (E, a), jnp.float32),
            "action_normal_left": jax.random.normal(ks[1], (E, a), jnp.float32)}


def assert_nets(state, after, names, bound):
    assert set(after.params) == set(names) == set(state.nets)
    for name in names:
        got = {k.split(".", 1)[1]: v for k, v in state.nets.state_dict().items() if k.split(".", 1)[0] == name}
        _assert_close(got, params_from_jax(after.params[name]), name, bound)


@pytest.mark.parametrize("algo", ["qtotv1", "qtotv2"])
@pytest.mark.parametrize("value_norm", [False, True], ids=["raw", "value_norm"])
def test_one_iteration_matches_jax(algo, value_norm):
    jcfg, jagent, agent = _agents(algo, **SMALL, algo__value_norm=value_norm)
    jagent.env.max_episode_length = agent.env.max_episode_length = MAX_LEN
    js, _ = jagent.train_iter(jagent.init(jax.random.PRNGKey(0)))  # moments off their initial values
    before = _copy(js)
    draws = onpolicy_draws(jagent, jcfg, js.rng, 4, _hand_normals, H * E)
    js, jmetrics = jagent.train_iter(js)
    after = _copy(js)

    state = agent.init()
    load_ppo_state(state, ma_state_from_jax(ma_tree(before)))
    state, metrics = agent.train_iter(state, draws)

    assert set(metrics) == set(jmetrics) >= {"train/critic_loss_tot", "train/actor_loss_left"}
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), err_msg=k, rtol=1e-4, atol=1e-4)
    n_updates = jcfg.algo.update_times * H * E // jcfg.algo.batch_size
    assert_nets(state, after, NETS, 2 * jcfg.algo.actor_lr * n_updates)  # actor_lr == critic_lr
    assert_onpolicy_state(state, after, algo)
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(state.value_rms_tot, k).numpy(), getattr(after.value_rms_tot, k),
                                   err_msg=f"value_rms_tot.{k}", **TOL)
    # three updates of H·E values each (bootstrap, returns, old values) when on
    count = float(after.value_rms_tot.count)
    assert count == pytest.approx(float(before.value_rms_tot.count) + (E + 2 * H * E) * value_norm, rel=1e-6)
    assert int(after.stats.return_tracker.count) > int(before.stats.return_tracker.count)  # episodes ended
    assert state.update_count == 2 * n_updates


def test_eval_hook_matches_jax():
    jcfg, jagent, agent = _agents("qtotv2", **dict(SMALL, task="BimanualReacherSym"))
    js = _copy(jagent.init(jax.random.PRNGKey(2)))
    state = agent.init()
    load_ppo_state(state, ma_state_from_jax(ma_tree(js)))
    obs = np.random.default_rng(5).normal(size=(E, 24)).astype(np.float32)
    want = jagent.eval_actor_apply(js.params, jnp.asarray(obs))
    with torch.no_grad():
        got = agent.eval_actor_apply(agent.eval_params(state), torch.from_numpy(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(agent.snapshot_parts(state)[1]) == {"critic", "critic_left", "critic_tot"}


def test_same_policy_is_refused():
    with pytest.raises(ValueError, match="same_policy"):
        get_algo("QTOTV1")(make_config("qtotv1", **SMALL, algo__same_policy=True), device="cpu")


@pytest.mark.parametrize("algo", ["qtotv1", "qtotv2"])
def test_kill_and_resume_bitwise(tmp_path, algo):
    def build():
        cfg = make_config(algo, checkpoint_dir=str(tmp_path / "ckpt"), **SMALL, algo__value_norm=True)
        return get_algo(cfg.algo.name)(cfg, device="cpu"), cfg

    agent, _ = build()
    s, _ = agent.train_iter(agent.init(seed=0))
    checkpoint.save_checkpoint(str(tmp_path / "ckpt" / "state"), s)
    for _ in range(2):
        s, m = agent.train_iter(s)
    agent2, cfg2 = build()
    s2, resumed = checkpoint.maybe_resume_full_state(cfg2, agent2.init(seed=99))
    assert resumed
    for _ in range(2):
        s2, m2 = agent2.train_iter(s2)
    assert state_diffs(s, s2) == [] and all(torch.equal(m[k], m2[k]) for k in m)
    assert "value_rms_tot" in checkpoint.state_dict(s2) and s2.update_count == 3 * 2 * H * E // 32
