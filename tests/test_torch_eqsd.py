"""EQSD of the port with an equivariant team actor against the JAX package,
on the CPU, and what the team-distillation tests share (this file, the
plain-network cases and the entry point in test_torch_eqsd_loop.py, EQSD2
in test_torch_eqsd2.py).

- one iteration of EQSD on BimanualReacher with the equivariant Gaussian
  team actor and with the equivariant diffusion team actor, from a
  converted JAX state with the JAX draws: IPPO's per-step ``split(k, 4)``,
  one permutation per epoch key, and for the diffusion team one
  ``split(state.rng)`` per minibatch for ``team_noise`` / ``team_t``;
  episodes truncated at 6 steps inside a horizon of 8: every network (the
  EMLPs and the equivariant diffusion net 16 wide, its time embedding
  16-dim, in both packages: fixture ``narrow``), the losses, the
  normalizers, obs, dones, episode statistics and counters;
- the eval hook (the hands' actors); a JAX snapshot of EQSD with the
  diffusion team into the port (eval actions and the team's loss);
- no module of the tier imports JAX, flax, optax or the JAX package.

Tolerance rtol 1e-4 / atol 1e-5 with the Adam allowance of
tests/test_torch_pql.py::_assert_close.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pql_tpu.algos import eqsd as j_eqsd
from pql_tpu.algos import ma_base as j_ma_base
from pql_tpu.models import ediffusion as j_ediffusion
from pql_tpu.utils import checkpoint as jckpt
from pql_tpu_torch.algos import eqsd, ma_base, teams
from pql_tpu_torch.models import ediffusion
from pql_tpu_torch.utils import checkpoint
from pql_tpu_torch.utils.convert import load_ppo_state, ma_state_from_jax, snapshot_from_jax
from test_torch_ddpm import _JaxNarrow, _PortNarrow
from test_torch_eq import _narrowed
from test_torch_ppo import _agents, assert_onpolicy_state
from test_torch_pql import TOL, _copy
from test_torch_qtot import _hand_normals, assert_nets, ma_tree, onpolicy_draws

E, H, MAX_LEN = 16, 8, 6
SMALL = dict(task="BimanualReacher", num_envs=E, algo__horizon_len=H, algo__batch_size=32, algo__update_times=2)
PLAIN = dict(algo__act_class="DiagGaussianMLPPolicy", algo__cri_class="MLPCritic")
DIFFUSION = dict(algo__diffusion=True)
HANDS = ("actor", "critic", "actor_left", "critic_left")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def narrow(monkeypatch):
    """Both packages build their equivariant Gaussian nets 16 wide
    (test_torch_eq.py's ``narrow``) and their equivariant diffusion net 16
    wide with a 16-dim time embedding (test_torch_ddpm.py's)."""
    for mod in (j_ma_base, j_eqsd, ma_base, teams, eqsd):
        monkeypatch.setattr(mod, "get_model", _narrowed(mod.get_model))
    monkeypatch.setattr(j_ediffusion, "EquivariantDiffusionNet", _JaxNarrow)
    monkeypatch.setattr(ediffusion, "EquivariantDiffusionNet", _PortNarrow)


def _team_normals(ks):
    half, a = E // 2, 2
    return {"action_normal": jax.random.normal(ks[0], (half, a), jnp.float32),
            "action_normal_left": jax.random.normal(ks[1], (half, a), jnp.float32),
            "action_normal_team": jax.random.normal(ks[2], (half, 2 * a), jnp.float32)}


def eqsd_draws(jagent, cfg, rng) -> dict:
    """One iteration's draws of a JAX EQSD or EQSD2 from ``state.rng``. EQSD:
    IPPO's, and with the diffusion team the minibatch chain (``rng, k =
    split(rng)`` per minibatch from the ``rng`` of ``_train_iter``'s
    three-way split; ``k_noise, k_t = split(k)``, eqsd.py:96)."""
    algo = cfg.algo
    if type(jagent).__name__ == "EQSD2":
        return onpolicy_draws(jagent, cfg, rng, 5, _team_normals, algo.horizon_len * cfg.num_envs // 2)
    rows = algo.horizon_len * cfg.num_envs
    draws = onpolicy_draws(jagent, cfg, rng, 4, _hand_normals, rows)
    if algo.diffusion:
        r, mb = jax.random.split(rng, 3)[0], algo.batch_size
        noise, ts = [], []
        for _ in range(algo.update_times * (rows // mb)):
            r, k = jax.random.split(r)
            k_noise, k_t = jax.random.split(k)
            noise.append(np.array(jax.random.normal(k_noise, (mb, 4), jnp.float32)))
            ts.append(np.array(jax.random.randint(k_t, (mb,), 0, algo.diffusion_iter)))
        shape = (algo.update_times, rows // mb, mb)
        draws["team_noise"] = torch.from_numpy(np.stack(noise)).reshape(*shape, 4)
        draws["team_t"] = torch.from_numpy(np.stack(ts)).long().reshape(shape)
    return draws


def _parity_iteration(jagent, jcfg, agent, js, state):
    """One JAX iteration from ``js`` and one port iteration of ``state`` with
    its draws; the port's networks, losses and state against the JAX ones.
    Returns the new (js, state)."""
    before = _copy(js)
    draws = eqsd_draws(jagent, jcfg, js.rng)
    js, jmetrics = jagent.train_iter(js)
    after = _copy(js)
    if state is None:
        state = agent.init()
        load_ppo_state(state, ma_state_from_jax(ma_tree(before)))
    state, metrics = agent.train_iter(state, draws)
    assert set(metrics) == set(jmetrics) >= {"train/actor_loss_team"}
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), err_msg=k, rtol=1e-4, atol=1e-4)
    n_updates = jcfg.algo.update_times * agent.rows // jcfg.algo.batch_size
    assert_nets(state, after, tuple(after.params), 2 * jcfg.algo.actor_lr * n_updates)  # actor_lr == critic_lr
    assert_onpolicy_state(state, after, jcfg.algo.name)
    assert int(after.stats.return_tracker.count) > int(before.stats.return_tracker.count)  # episodes ended
    assert state.update_count == int(before.update_count) + n_updates
    return js, state


def one_iteration(algo, extra, team):
    """One parity iteration (``_parity_iteration``) of ``algo`` after a JAX
    iteration that moves the moments off their initial values; the team
    actor's class and the networks held."""
    jcfg, jagent, agent = _agents(algo, **SMALL, **extra)
    jagent.env.max_episode_length = agent.env.max_episode_length = MAX_LEN
    js, _ = jagent.train_iter(jagent.init(jax.random.PRNGKey(0)))
    _, state = _parity_iteration(jagent, jcfg, agent, js, None)
    assert type(state.nets["actor_team"]).__name__ == team
    names = HANDS + ("actor_team",) + (("critic_team",) if algo == "eqsd2" else ())
    assert set(state.nets) == set(state.opts) == set(names)
    if algo == "eqsd2":  # the value-rms pair present and unmoved
        assert float(state.value_rms.count) == float(state.value_rms_left.count) < 1.0


def eval_hook(algo, extra):
    """The eval hook on BimanualReacherSym obs against the JAX one."""
    jcfg, jagent, agent = _agents(algo, **dict(SMALL, task="BimanualReacherSym"), **extra)
    js = _copy(jagent.init(jax.random.PRNGKey(2)))
    state = agent.init()
    load_ppo_state(state, ma_state_from_jax(ma_tree(js)))
    obs = np.random.default_rng(5).normal(size=(E, 24)).astype(np.float32)
    want = jagent.eval_actor_apply(js.params, jnp.asarray(obs))
    with torch.no_grad():
        got = agent.eval_actor_apply(agent.eval_params(state), torch.from_numpy(obs))
    assert got.shape == (E, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def snapshot_starts_the_port(tmp_path, algo, extra):
    """A JAX best-model snapshot (``state.params`` and its critics) starts the
    port: the eval actions within 1e-5, and a diffusion team's loss on the
    same draws."""
    jcfg, jagent, agent = _agents(algo, **SMALL, **extra)
    js = jagent.init(jax.random.PRNGKey(0))
    critics = {k: v for k, v in js.params.items() if k.startswith("critic")}
    jckpt.save_model_snapshot(str(tmp_path / "jax_snap"), js.params, critics, js.obs_rms)
    tree = jax.tree_util.tree_map(np.asarray, jckpt.load_model_snapshot(str(tmp_path / "jax_snap")))
    os.makedirs(tmp_path / "port_snap")
    torch.save(snapshot_from_jax(tree), tmp_path / "port_snap" / checkpoint.SNAPSHOT_FILE)
    state = agent.init(seed=3)
    state = checkpoint.restore_into_state(state, checkpoint.load_model_snapshot(str(tmp_path / "port_snap")),
                                          agent.snapshot_parts(state))
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(E, 24)).astype(np.float32)
    obs_n = js.obs_rms.normalize(jnp.asarray(obs))
    want = jagent.eval_actor_apply(js.params, obs_n)
    with torch.no_grad():
        got = agent.eval_actor_apply(agent.eval_params(state), state.obs_rms.normalize(torch.from_numpy(obs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    if jcfg.algo.diffusion:
        act = np.clip(rng.normal(size=(E, 4)), -1, 1).astype(np.float32)
        key = jax.random.PRNGKey(4)
        team = jagent.actor_team
        want_l = team.apply(js.params["actor_team"], jnp.asarray(obs), jnp.asarray(act), key,
                            method=type(team).get_loss)
        k_noise, k_t = jax.random.split(key)
        noise = torch.from_numpy(np.array(jax.random.normal(k_noise, (E, 4), jnp.float32)))
        ts = torch.from_numpy(np.array(jax.random.randint(k_t, (E,), 0, jcfg.algo.diffusion_iter))).long()
        with torch.no_grad():
            got_l = state.nets["actor_team"].get_loss(torch.from_numpy(obs), torch.from_numpy(act), noise, ts)
        np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("extra,team", [({}, "DiagGaussianEquivariantMLPPolicy"),
                                        (DIFFUSION, "EquivariantDiffusionPolicy")], ids=["gaussian", "diffusion"])
def test_one_iteration_matches_jax(narrow, extra, team):
    one_iteration("eqsd", extra, team)


def test_eval_hook_matches_jax(narrow):
    eval_hook("eqsd", DIFFUSION)


def test_snapshot_from_jax_starts_the_port(tmp_path, narrow):
    snapshot_starts_the_port(tmp_path, "eqsd", DIFFUSION)


def test_eqsd_modules_import_no_jax():
    code = (
        "import sys\n"
        "import pql_tpu_torch.ops.ddpm, pql_tpu_torch.models.diffusion, pql_tpu_torch.models.ediffusion\n"
        "import pql_tpu_torch.algos.eqsd, pql_tpu_torch.algos\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'pql_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)
