"""EQ, EQS, EQG and MP of the port against the JAX package, on the CPU.

- one iteration of EQ (one shared pair, also with ``value_norm`` and on
  BimanualReacherSym), EQS, MP and EQG (also with ``value_norm``) on
  BimanualReacher from a converted JAX state with the JAX draws (IPPO's
  per-step ``split(k, 4)``, PPO's ``split(k, 3)`` for EQG; one permutation
  per epoch key); episodes truncated at 6 steps inside a horizon of 8: every
  network (raw weights; EMLPs 16 wide in both packages, fixture ``narrow``),
  the losses, the normalizers, obs, dones, episode statistics and counters;
- EQ keeps one actor/critic pair, as the JAX agent; the trained policies of
  EQ, EQS and EQG (full width) stay equivariant and their critics invariant
  (tests/test_equivariant.py:207-222);
- the refusals: PQL, DDPG, SAC, CrossQ, PPO, MAPPO and IDDPG take no
  equivariant ``act_class`` / ``cri_class``; ``algo=eqsd|eqsd2`` parse to
  their presets (the agents: tests/test_torch_eqsd*.py);
- the entry point with ``algo=eq``: evals, the best model, a checkpoint;
- no module of the tier imports JAX, flax, optax or the JAX package.

Tolerance rtol 1e-4 / atol 1e-5 with the Adam allowance of
tests/test_torch_pql.py::_assert_close.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pql_tpu.algos import eq as j_eq
from pql_tpu.algos import ma_base as j_ma_base
from pql_tpu.algos import teams as j_teams
from pql_tpu_torch import train
from pql_tpu_torch.algos import eq, get_algo, ma_base, teams
from pql_tpu_torch.cfg import make_config, parse_cli
from pql_tpu_torch.utils import checkpoint
from pql_tpu_torch.utils.convert import load_ppo_state, ma_state_from_jax, params_from_jax, ppo_state_from_jax
from test_torch_ppo import _agents, assert_onpolicy_state, onpolicy_tree
from test_torch_pql import _assert_close, _copy
from test_torch_qtot import _hand_normals, assert_nets, ma_tree, onpolicy_draws

E, H, MAX_LEN = 16, 8, 6
SMALL = dict(num_envs=E, algo__horizon_len=H, algo__batch_size=32, algo__update_times=2)
NETS = {"eq": ("actor", "critic"), "eqs": ("actor", "critic", "actor_left", "critic_left")}
NETS["mp"] = NETS["eqs"]
EMLP_HIDDEN = 16  # the parity runs' EMLP width (fixture ``narrow``)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _narrowed(get_model):
    def get(name):
        cls = get_model(name)
        return functools.partial(cls, hidden_units=EMLP_HIDDEN) if "Equivariant" in name else cls
    return get


@pytest.fixture
def narrow(monkeypatch):
    """Both packages' agents build their equivariant nets EMLP_HIDDEN wide
    (the agents take EMLP's default width, 256, whose flax trace alone takes
    ~80 s per agent on the CPU; the card runs the full width)."""
    for mod in (j_ma_base, j_eq, j_teams, ma_base, eq, teams):
        monkeypatch.setattr(mod, "get_model", _narrowed(mod.get_model))


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _joint_normals(ks):
    return {"action_normal": jax.random.normal(ks[0], (E, 4), jnp.float32)}


CASES = [pytest.param("eq", "BimanualReacher", False, id="eq"),
         pytest.param("eq", "BimanualReacher", True, id="eq-value_norm"),
         pytest.param("eq", "BimanualReacherSym", False, id="eq-sym"),
         pytest.param("eqs", "BimanualReacher", False, id="eqs"),
         pytest.param("mp", "BimanualReacher", True, id="mp-value_norm"),
         pytest.param("eqg", "BimanualReacher", False, id="eqg"),
         pytest.param("eqg", "BimanualReacher", True, id="eqg-value_norm")]


@pytest.mark.parametrize("algo,task,value_norm", CASES)
def test_one_iteration_matches_jax(narrow, algo, task, value_norm):
    jcfg, jagent, agent = _agents(algo, task=task, **SMALL, algo__value_norm=value_norm)
    jagent.env.max_episode_length = agent.env.max_episode_length = MAX_LEN
    js, _ = jagent.train_iter(jagent.init(jax.random.PRNGKey(0)))  # moments off their initial values
    before = _copy(js)
    joint = algo == "eqg"
    draws = onpolicy_draws(jagent, jcfg, js.rng, 3 if joint else 4, _joint_normals if joint else _hand_normals, H * E)
    js, jmetrics = jagent.train_iter(js)
    after = _copy(js)

    state = agent.init()
    load_ppo_state(state, ppo_state_from_jax(onpolicy_tree(before)) if joint else ma_state_from_jax(ma_tree(before)))
    state, metrics = agent.train_iter(state, draws)

    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), err_msg=k, rtol=1e-4, atol=1e-4)
    n_updates = jcfg.algo.update_times * H * E // jcfg.algo.batch_size
    bound = 2 * jcfg.algo.actor_lr * n_updates  # actor_lr == critic_lr
    if joint:
        _assert_close(state.actor.state_dict(), params_from_jax(after.actor_params), "actor", bound)
        _assert_close(state.critic.state_dict(), params_from_jax(after.critic_params), "critic", bound)
    else:
        assert_nets(state, after, NETS[algo], bound)
    assert_onpolicy_state(state, after, algo)
    assert int(after.stats.return_tracker.count) > int(before.stats.return_tracker.count)  # episodes ended
    assert state.update_count == 2 * n_updates


def test_eq_keeps_one_pair(narrow):
    jcfg, jagent, agent = _agents("eq", task="BimanualReacher", **SMALL)
    state = agent.init()
    assert agent.same_policy and set(state.nets) == set(state.opts) == {"actor", "critic"}
    assert set(jagent.init(jax.random.PRNGKey(0)).params) == {"actor", "critic"}
    assert type(state.nets["actor"]).__name__ == "DiagGaussianEquivariantMLPPolicy"
    assert type(state.nets["critic"]).__name__ == "MLPCriticEquivariant"


def _max_equivariance_error(module, x, g_in, g_out=None):
    with torch.no_grad():
        y = module(x)
        y = y[0] if isinstance(y, tuple) else y
        y_g = module(x @ g_in)
        y_g = y_g[0] if isinstance(y_g, tuple) else y_g
    want = y if g_out is None else y @ g_out
    return float((y_g - want).abs().max()) / (1.0 + float(y.abs().max()))


@pytest.mark.parametrize("algo", ["eq", "eqs", "eqg"])
def test_trained_policies_stay_equivariant(algo):
    """After two iterations each actor's mean obeys |μ(x·G_obs) − μ(x)·G_act|
    ≤ 1e-5·(1 + |μ|), and each critic the same with G_act = I."""
    agent = get_algo(algo.upper())(make_config(algo, task="BimanualReacher", **SMALL), device="cpu")
    state = agent.init(seed=3)
    for _ in range(2):
        state, _ = agent.train_iter(state)
    ma = agent.ma
    t = lambda g: torch.tensor(np.asarray(g, np.float32))  # noqa: E731
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(64, 24)).astype(np.float32))
    if algo == "eqg":
        g_obs, g_act = t(ma.joint_obs_gen()), torch.block_diag(t(ma.act_gen()), t(ma.act_gen()))
        nets = {"actor": (state.actor, x, g_obs, g_act), "critic": (state.critic, x, g_obs, None)}
    else:
        nets = {}
        for name, m in state.nets.items():
            side = 1 if name.endswith("_left") else 0
            g_out = t(ma.act_gen()) if name.startswith("actor") else None
            nets[name] = (m, x[:, 12 * side : 12 * side + 12], t(ma.obs_gen(side)), g_out)
    for name, (m, xs, g_in, g_out) in nets.items():
        assert _max_equivariance_error(m, xs, g_in, g_out) <= 1e-5, name
        if g_out is not None:  # the check can fail: the identity on the obs is not the mirror
            assert _max_equivariance_error(m, xs, torch.eye(xs.shape[1]), g_out) > 1e-3, name


@pytest.mark.parametrize("algo,task", [("ppo", "Cartpole"), ("ddpg", "Cartpole"), ("sac", "Cartpole"),
                                       ("crossq", "Cartpole"), ("pql", "Cartpole"), ("mappo", "BimanualReacher"),
                                       ("iddpg", "BimanualReacher")])
@pytest.mark.parametrize("field,name", [("act_class", "DiagGaussianEquivariantMLPPolicy"),
                                        ("cri_class", "MLPCriticEquivariant")])
def test_agents_without_reps_refuse_equivariant_nets(algo, task, field, name):
    cfg = make_config(algo, task=task, num_envs=16, algo__batch_size=32, algo__horizon_len=2, algo__memory_size=256,
                      **{f"algo__{field}": name})
    with pytest.raises(ValueError, match="takes no equivariant network"):
        get_algo(cfg.algo.name)(cfg, device="cpu").init()


def test_eqsd_parse_to_their_presets():
    """``algo=eqsd|eqsd2``: the JAX package's ``_ppo_like`` with the
    equivariant classes (pql_tpu/cfg/config.py:265-266) and the diffusion
    and KL fields at their defaults (:140-146)."""
    for algo, name in (("eqsd", "EQSD"), ("eqsd2", "EQSD2")):
        a = parse_cli([f"algo={algo}"]).algo
        assert (a.name, a.horizon_len, a.batch_size, a.update_times, a.eval_freq) == (name, 16, 32768, 4, 20)
        assert (a.act_class, a.cri_class) == ("DiagGaussianEquivariantMLPPolicy", "MLPCriticEquivariant")
        assert (a.diffusion_iter, a.diffusion, a.kl_max, a.kl_decay_iters) == (5, False, 1.0, 1000)
        assert get_algo(name).name == name
    a = parse_cli(["algo=eqsd", "algo.diffusion=true", "algo.diffusion_iter=3", "algo.kl_decay_iters=10"]).algo
    assert (a.diffusion, a.diffusion_iter, a.kl_decay_iters) == (True, 3, 10)


def test_entry_point_runs_eq(tmp_path):
    """``train.main algo=eq``: 8 envs, horizon 4, evals at iterations 2 and 4,
    a checkpoint at 4, the best model holding the one shared pair."""
    per_iter = 4 * 8
    train.main(["algo=eq", "task=BimanualReacher", "num_envs=8", "algo.horizon_len=4", "algo.batch_size=16",
                "algo.update_times=2", "eval_num_envs=8", "algo.eval_freq=2", "algo.log_freq=1", "checkpoint_freq=4",
                f"max_step={3 * per_iter}", f"checkpoint_dir={tmp_path / 'ckpt'}", "logging.console=false",
                f"logging.out_dir={tmp_path / 'runs'}", "logging.run_name=eq", "--device=cpu"])
    recs = [json.loads(x) for x in open(tmp_path / "runs" / "eq" / "metrics.jsonl")]
    assert [r["step"] // per_iter for r in recs if "eval/return" in r] == [2, 4]
    assert all(np.isfinite(r["train/actor_loss"]) for r in recs if "train/actor_loss" in r)
    best = checkpoint.load_model_snapshot(str(tmp_path / "runs" / "eq" / "best_model"))
    assert {k.split(".")[0] for k in best["actor"]} == {"actor", "critic"}
    assert os.path.exists(tmp_path / "ckpt" / "state" / checkpoint.STATE_FILE)


def test_equivariant_modules_import_no_jax():
    code = (
        "import sys\n"
        "import pql_tpu_torch.models.emlp, pql_tpu_torch.algos.eq, pql_tpu_torch.algos\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'pql_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)
