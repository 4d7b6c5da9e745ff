"""EQSC, EQSdata, EQS4 and the equivariant team agents of the port against
the JAX package, on the CPU.

- one iteration from a converted JAX state with the JAX draws (episodes
  truncated at 6 steps inside a horizon of 8; EMLPs 16 wide in both
  packages, fixture ``narrow``): EQSC (IPPO's per-step ``split(k, 4)``; with
  and without ``value_norm``, whose one value-rms moves at every step and by
  the bootstrap, returns and values); EQSdata (``split(state.rng, 5)``: the
  transformed stream's normals from ``k_tr`` / ``k_tl``, one permutation of
  the doubled 2·H·E rows per epoch for both hands; with ``value_norm``, and
  under ``same_policy`` on the Sym task); EQS4 (per step ``split(k, 6)``,
  four normals; with ``value_norm``, which it ignores); IPPOTeam (its team
  actor equivariant on the joint reps) and IART with the equivariant
  classes; every network, the losses, normalizers, obs, dones, statistics
  and counters;
- EQS4's ``value_norm`` ignored: the run with it on is bitwise the run with
  it off; the eval hooks of EQSC and EQS4 against the JAX ones;
- after two iterations each equivariant actor of EQSC, EQS4 and IPPOTeam
  (full width) stays equivariant, each critic invariant;
- bitwise kill-and-resume of EQSC and EQS4 through ``train_baseline``: a
  ``train.main`` run with evals and a checkpoint, resumed to a later step,
  ends where one uninterrupted run ends.

Tolerance rtol 1e-4 / atol 1e-5 with the Adam allowance of
tests/test_torch_pql.py::_assert_close.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import state_diffs
from pql_tpu_torch import train
from pql_tpu_torch.algos import get_algo
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.utils.convert import load_ppo_state, ma_state_from_jax
from pql_tpu_torch.utils.logging import RunLogger
from test_torch_eq import _max_equivariance_error, narrow  # noqa: F401  (a fixture)
from test_torch_ppo import _agents, assert_onpolicy_state, rollout_draws
from test_torch_pql import TOL, _copy
from test_torch_qtot import _hand_normals, assert_nets, ma_tree, onpolicy_draws
from test_torch_teams import team_draws

E, H, MAX_LEN = 16, 8, 6
SMALL = dict(num_envs=E, algo__horizon_len=H, algo__batch_size=32, algo__update_times=2)
EQ_CLASSES = dict(algo__act_class="DiagGaussianEquivariantMLPPolicy", algo__cri_class="MLPCriticEquivariant")
NETS = {"eqsc": ("actor", "actor_left", "critic"),
        "eqsdata": ("actor", "critic", "actor_left", "critic_left"),
        "eqs4": tuple(f"{k}{s}" for s in ("", "_left", "_op", "_left_op") for k in ("actor", "critic")),
        "ippoteam": ("actor", "actor_left", "critic", "critic_left", "actor_team", "critic_tot", "critic_team"),
        "iart": tuple(f"{k}{s}" for s in ("", "_team") for k in ("actor", "actor_left", "critic", "critic_left"))}
GROUPS = ("", "_left", "_op", "_left_op")


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def eqsdata_draws(jagent, cfg, rng) -> dict:
    """EQSdata's draws (eq.py:364-389): ``rng, k_roll, k_perm, k_tr, k_tl =
    split(rng, 5)``; IPPO's rollout from ``k_roll``; the transformed samples
    [H·E, a] from ``k_tr`` / ``k_tl``; one permutation of 2·H·E rows per
    epoch key, both hands' minibatches from the same one."""
    _, k, k_perm, k_tr, k_tl = jax.random.split(rng, 5)
    keys = []
    for _ in range(cfg.algo.horizon_len):
        k, *k_act, k_e = jax.random.split(k, 4)
        keys.append((k_act, k_e))
    draws = rollout_draws(jagent.env, keys, _hand_normals)
    rows = cfg.algo.horizon_len * cfg.num_envs
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    draws["transform_normal"] = t(jax.random.normal(k_tr, (rows, 2), jnp.float32))
    draws["transform_normal_left"] = t(jax.random.normal(k_tl, (rows, 2), jnp.float32))
    draws["perm"] = torch.stack([t(jax.random.permutation(key, 2 * rows)).long()
                                 for key in jax.random.split(k_perm, cfg.algo.update_times)])
    return draws


def _four_normals(ks):
    return {f"action_normal{s}": jax.random.normal(k, (E, 2), jnp.float32) for s, k in zip(GROUPS, ks)}


def _draws(algo, jagent, jcfg, rng) -> dict:
    if algo == "eqsdata":
        return eqsdata_draws(jagent, jcfg, rng)
    if algo == "eqs4":
        return onpolicy_draws(jagent, jcfg, rng, 6, _four_normals, H * E)
    if algo in ("ippoteam", "iart"):
        return team_draws(jagent, jcfg, rng)
    return onpolicy_draws(jagent, jcfg, rng, 4, _hand_normals, H * E)


CASES = [pytest.param("eqsc", "BimanualReacher", {}, id="eqsc"),
         pytest.param("eqsc", "BimanualReacherSym", dict(algo__value_norm=True), id="eqsc-sym-value_norm"),
         pytest.param("eqsdata", "BimanualReacher", {}, id="eqsdata"),
         pytest.param("eqsdata", "BimanualReacher", dict(algo__value_norm=True), id="eqsdata-value_norm"),
         pytest.param("eqsdata", "BimanualReacherSym", dict(algo__same_policy=True), id="eqsdata-sym-same_policy"),
         pytest.param("eqs4", "BimanualReacher", {}, id="eqs4"),
         pytest.param("eqs4", "BimanualReacherSym", dict(algo__value_norm=True), id="eqs4-sym-value_norm"),
         pytest.param("ippoteam", "BimanualReacherSym", EQ_CLASSES, id="ippoteam-equivariant-sym"),
         pytest.param("iart", "BimanualReacher", EQ_CLASSES, id="iart-equivariant")]


@pytest.mark.parametrize("algo,task,extra", CASES)
def test_one_iteration_matches_jax(narrow, algo, task, extra):  # noqa: F811
    jcfg, jagent, agent = _agents(algo, task=task, **SMALL, **extra)
    jagent.env.max_episode_length = agent.env.max_episode_length = MAX_LEN
    js, _ = jagent.train_iter(jagent.init(jax.random.PRNGKey(0)))  # moments off their initial values
    before = _copy(js)
    draws = _draws(algo, jagent, jcfg, js.rng)
    js, jmetrics = jagent.train_iter(js)
    after = _copy(js)

    state = agent.init()
    load_ppo_state(state, ma_state_from_jax(ma_tree(before)))
    state, metrics = agent.train_iter(state, draws)

    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), err_msg=k, rtol=1e-4, atol=1e-4)
    rows = H * E // 2 if algo in ("ippoteam", "iart") else 2 * H * E if algo == "eqsdata" else H * E
    n_updates = jcfg.algo.update_times * rows // jcfg.algo.batch_size
    names = NETS[algo][:2] if extra.get("algo__same_policy") else NETS[algo]
    assert_nets(state, after, names, 2 * jcfg.algo.actor_lr * n_updates)  # actor_lr == critic_lr
    assert_onpolicy_state(state, after, algo)
    assert int(after.stats.return_tracker.count) > int(before.stats.return_tracker.count)  # episodes ended
    assert state.update_count == 2 * n_updates
    if algo == "eqsc" and extra:  # one value-rms: H steps, the bootstrap, the returns and the values
        assert float(after.value_rms.count) == pytest.approx(float(before.value_rms.count) + 3 * H * E + E, rel=1e-6)
    if algo == "eqs4" and extra:  # the value-rms pair never moves
        assert float(after.value_rms.count) == float(before.value_rms.count) < 1.0
    if algo in ("ippoteam", "iart"):
        assert type(state.nets["actor_team"]).__name__ == "DiagGaussianEquivariantMLPPolicy"


def test_eqs4_ignores_value_norm():
    runs = []
    for value_norm in (False, True):
        agent = get_algo("EQS4")(make_config("eqs4", task="BimanualReacher", **SMALL, algo__value_norm=value_norm),
                                 device="cpu")
        s = agent.init(seed=1)
        ms = []
        for _ in range(2):
            s, m = agent.train_iter(s)
            ms.append(m)
        runs.append((s, ms))
    (s0, m0), (s1, m1) = runs
    assert state_diffs(s0, s1) == []
    assert all(torch.equal(a[k], b[k]) for a, b in zip(m0, m1) for k in a)


@pytest.mark.parametrize("algo", ["eqsc", "eqs4"])
def test_eval_hook_matches_jax(narrow, algo):  # noqa: F811
    jcfg, jagent, agent = _agents(algo, task="BimanualReacherSym", **SMALL)
    js = _copy(jagent.init(jax.random.PRNGKey(2)))
    state = agent.init()
    load_ppo_state(state, ma_state_from_jax(ma_tree(js)))
    obs = np.random.default_rng(5).normal(size=(E, 24)).astype(np.float32)
    want = jagent.eval_actor_apply(js.params, jnp.asarray(obs))
    with torch.no_grad():
        got = agent.eval_actor_apply(agent.eval_params(state), torch.from_numpy(obs))
    assert got.shape == (E, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("algo,extra", [("eqsc", {}), ("eqs4", {}), ("ippoteam", EQ_CLASSES)])
def test_trained_policies_stay_equivariant(algo, extra):
    agent = get_algo({"eqsc": "EQSC", "eqs4": "EQS4", "ippoteam": "IPPOTeam"}[algo])(
        make_config(algo, task="BimanualReacher", **SMALL, **extra), device="cpu")
    state = agent.init(seed=3)
    for _ in range(2):
        state, _ = agent.train_iter(state)
    ma = agent.ma
    t = lambda g: torch.tensor(np.asarray(g, np.float32))  # noqa: E731
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(64, 24)).astype(np.float32))
    g_act = t(ma.act_gen())
    for name, m in state.nets.items():
        central = name in ("critic_tot", "critic_team", "actor_team") or (algo == "eqsc" and name == "critic")
        side = 1 if "_left" in name else 0
        xs, g_in = (x, t(ma.joint_obs_gen())) if central else (x[:, 12 * side : 12 * side + 12], t(ma.obs_gen(side)))
        g_out = None if name.startswith("critic") else torch.block_diag(g_act, g_act) if central else g_act
        assert _max_equivariance_error(m, xs, g_in, g_out) <= 1e-5, name


@pytest.mark.parametrize("algo", ["eqsc", "eqs4"])
def test_kill_and_resume_bitwise_through_the_entry_point(tmp_path, algo):
    """``train.main``: 8 envs, horizon 4, evals every 2 iterations and a full
    checkpoint every 3, stopped after 4 iterations; ``train_baseline`` resumes
    from iteration 3 to 6 and ends bitwise where one run of 6 ends."""
    size = dict(task="BimanualReacherSym", num_envs=8, algo__horizon_len=4, algo__batch_size=16, algo__update_times=2)
    per_iter = 4 * 8
    common = [f"{k.replace('__', '.')}={v}" for k, v in size.items()] + [
        "eval_num_envs=8", "algo.eval_freq=2", "algo.log_freq=1", "checkpoint_freq=3", "logging.console=false",
        f"logging.out_dir={tmp_path / 'runs'}"]
    train.main([f"algo={algo}", *common, f"max_step={3 * per_iter}", f"checkpoint_dir={tmp_path / 'ckpt'}",
                "logging.run_name=first", "--device=cpu"])
    recs = [json.loads(x) for x in open(tmp_path / "runs" / "first" / "metrics.jsonl")]
    assert [r["step"] // per_iter for r in recs if "eval/return" in r] == [2, 4]
    assert (tmp_path / "runs" / "first" / "best_model" / "snapshot.pt").exists()

    def run(name, ckpt):
        cfg = make_config(algo, eval_num_envs=8, checkpoint_dir=str(tmp_path / ckpt), checkpoint_freq=3,
                          max_step=5 * per_iter, logging__out_dir=str(tmp_path / "runs"), logging__run_name=name,
                          logging__console=False, **dict(size, algo__eval_freq=2, algo__log_freq=1))
        logger = RunLogger(cfg)
        try:
            return train.train_baseline(cfg, logger, device="cpu")[1]
        finally:
            logger.close()

    resumed, whole = run("second", "ckpt"), run("whole", "ckpt_whole")
    assert state_diffs(resumed, whole) == []
    assert resumed.env_steps == 6 * per_iter and resumed.update_count == 6 * 2 * per_iter // 16
