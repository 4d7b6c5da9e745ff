"""DDPGV of the port against the JAX package, on the CPU.

- one collect and one update on ReacherVision (8 envs, horizon 4, batch
  32; the ResNet actor at full width), with the
  episodes cut at 3 steps so an auto-reset runs inside the horizon: both
  packages warm up their rings with the same chunk, then a JAX state is
  carried into the port (``ddpgv_state_from_jax``) and both run one
  iteration from the JAX draws (``fold_in(rng, u)`` made explicit). The
  rings sample the same rows (both ``default_rng(0)``). The stored chunk:
  equal, but for at most 0.1% of its elements one step off where the fp32
  value before the cast differs in its last bit (the render's pixels by 1
  after round(x·255) at .5, the fp16 rows by one ulp: the point cloud's
  sines and cosines; 1 of 3,840 next_pc elements here); params and Adam moments at
  rtol 1e-4 / atol 1e-5 with the Adam allowance of
  tests/test_torch_pql.py::_assert_close, losses and metrics 1e-4;
- ``train_iter`` through the ring, as tests/test_native.py's
  ``TestDDPGVThroughRing``;
- the eval hook renders from the env state (``needs_env_state``);
- the preset and the ring's layout equal to the JAX agent's;
- the resume as both packages define it: the state holds no ring, so a
  resumed run starts from an empty ring and a fresh sampler, without
  warm-up, and ``_resumed_iter`` subtracts ``warm_up`` × E though DDPGV warms
  up for ``horizon_len`` steps (31 iterations low at the preset).
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pql_tpu.algos.ddpgv import DDPGV as JDDPGV
from pql_tpu.algos.ddpgv import DDPGVState as JDDPGVState
from pql_tpu.cfg import make_config as j_make_config
from pql_tpu.envs import make_env as j_make_env
from pql_tpu.ops.noise import per_row_normal
from pql_tpu_torch import train
from pql_tpu_torch.algos import get_algo
from pql_tpu_torch.algos.ddpgv import DDPGV, DDPGVState
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.envs.base import VecEnvState
from pql_tpu_torch.utils import checkpoint
from pql_tpu_torch.utils.convert import ddpgv_state_from_jax, load_ddpgv_state, params_from_jax
from test_torch_ppo import _tracker, opt_tree, rms_tree, rollout_draws
from test_torch_ppov import _port_moments
from test_torch_pql import TOL, _adam, _assert_close, _copy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(task="ReacherVision", num_envs=8, algo__batch_size=32, algo__memory_size=512, algo__horizon_len=4)
ONE_UPDATE = dict(SIZE, algo__update_times=1)
MAX_LEN = 3  # episodes end inside the horizon
FLIP_SHARE = 1e-3  # share of the stored elements one step (a pixel level, an fp16 ulp) off, at most


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _agents(**size):
    jcfg = j_make_config("ddpgv", **size)
    return jcfg, JDDPGV(jcfg, j_make_env(jcfg)), DDPGV(make_config("ddpgv", **size), device="cpu")


def ddpgv_tree(s) -> dict:
    """The numpy tree ``ddpgv_state_from_jax`` takes, from a numpy JAX DDPGVState."""
    return dict(actor_params=s.actor_params, critic_params=s.critic_params, critic_target=s.critic_target,
                actor_opt=opt_tree(s.actor_opt), critic_opt=opt_tree(s.critic_opt), obs_rms=rms_tree(s.obs_rms),
                env_state=dict(state=dict(s.env_state.state), time=s.env_state.time), obs=s.obs,
                cur_returns=s.cur_returns, cur_lengths=s.cur_lengths, return_tracker=_tracker(s.return_tracker),
                len_tracker=_tracker(s.len_tracker), env_steps=s.env_steps)


def jax_draws(jagent, cfg, rng, random: bool = False) -> dict:
    """A collect's draws rebuilt from ``state.rng`` as ``_collect_impl`` makes
    them (``rng, k_roll = split(rng)``; per step ``k, k_a, k_n, k_e =
    split(k, 4)``: uniform actions from k_a, the mixed noise's per-row
    normals from k_n, the env's from k_e), and for an iteration the update
    normals of ``fold_in(rng', u)`` (``_train_iter``)."""
    E, A, B = cfg.num_envs, jagent.env.action_dim, cfg.algo.batch_size
    rng_next, k = jax.random.split(rng)
    keys = []
    for _ in range(cfg.algo.horizon_len):
        k, k_a, k_n, k_e = jax.random.split(k, 4)
        keys.append(((k_a, k_n), k_e))

    def normals(ks):
        if random:
            return {"action_uniform": jax.random.uniform(ks[0], (E, A), jnp.float32, -1.0, 1.0)}
        return {"explore_normal": per_row_normal(ks[1], (E, A), jnp.float32, 0)}

    draws = rollout_draws(jagent.env, keys, normals)
    if not random:
        draws["target_normal"] = torch.stack([
            torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(rng_next, u), (B, A), jnp.float32)))
            for u in range(cfg.algo.update_times)])
    return draws


def _jax_iteration(jagent, js):
    """``_train_iter`` unrolled, keeping the collected chunk."""
    js, traj = jagent._collect(js)
    traj = {k: np.asarray(v) for k, v in traj.items()}
    jagent.replay.add(traj)
    losses = []
    for u in range(int(jagent.cfg.algo.update_times)):
        batch = {k: jax.device_put(v) for k, v in jagent.replay.sample(jagent.cfg.algo.batch_size).items()}
        js, loss = jagent._update(js, batch, jax.random.fold_in(js.rng, u))
        losses.append(np.asarray(loss))
    return js, traj, np.mean(np.stack(losses), 0)


def _assert_chunk(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype == np.uint8:
            diff = np.abs(g.astype(np.int16) - w.astype(np.int16))
            assert diff.max() <= 1 and (diff > 0).mean() <= FLIP_SHARE, f"{k}: {(diff > 0).sum()} flips"
        else:  # one fp16 ulp, where the fp32 value before the cast sits at a rounding boundary
            off = g != w
            ulp = np.spacing(np.maximum(np.abs(g), np.abs(w)).astype(np.float16))
            assert np.all(np.abs(g.astype(np.float32) - w.astype(np.float32))[off] <= ulp[off]), k
            assert off.mean() <= FLIP_SHARE, f"{k}: {off.sum()} of {off.size} elements off"


def test_one_iteration_matches_jax():
    """One collect and one update (``update_times`` 1), after a JAX
    iteration has moved Adam's moments off zero (a first AdamW step moves
    every element by ±lr, whatever its gradient's size, so a rounding-level
    gradient would decide its sign)."""
    jcfg, jagent, agent = _agents(**ONE_UPDATE)
    jagent.env.max_episode_length = agent.env.max_episode_length = MAX_LEN
    js = jagent.init(jax.random.PRNGKey(0))
    js, traj0 = jagent._collect(js, random=True)  # the warm-up chunk
    traj0 = {k: np.asarray(v) for k, v in traj0.items()}
    jagent.replay.add(traj0)
    js, traj1, _ = _jax_iteration(jagent, js)  # moments off their initial values
    for chunk in (traj0, traj1):  # both rings hold the same rows, and their samplers are level
        agent.replay.add(chunk)
    agent.replay.sample(jcfg.algo.batch_size)
    before = _copy(js)
    draws = jax_draws(jagent, jcfg, js.rng)
    js, jtraj, jlosses = _jax_iteration(jagent, js)
    after = _copy(js)

    state = agent.init()
    load_ddpgv_state(state, ddpgv_state_from_jax(ddpgv_tree(before)))
    written, write = [], agent.ring_write
    agent.ring_write = lambda traj: (written.append(agent.to_host(traj)), write(traj))[1]
    state, metrics = agent.train_iter(state, draws)

    _assert_chunk(written[0], jtraj)
    assert agent.replay.filled == jagent.replay.filled == 3 * SIZE["algo__horizon_len"]
    np.testing.assert_allclose(float(metrics["train/critic_loss"]), jlosses[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(metrics["train/actor_loss"]), jlosses[1], rtol=1e-4, atol=1e-4)
    bound = 2 * jcfg.algo.actor_lr * jcfg.algo.update_times
    for name, module, opt, jparams, jopt in (("actor", state.actor, state.actor_opt, after.actor_params, after.actor_opt),
                                            ("critic", state.critic, state.critic_opt, after.critic_params,
                                             after.critic_opt)):
        _assert_close(module.state_dict(), params_from_jax(jparams), name, bound)
        mu, nu = _port_moments(module, opt)
        adam = _adam(jopt)
        _assert_close(mu, params_from_jax(adam.mu), f"{name} mu", 1.0)
        _assert_close(nu, params_from_jax(adam.nu), f"{name} nu", 1.0)
        assert all(int(opt.state[p]["step"]) == int(adam.count) for p in module.parameters())
    _assert_close(state.critic_target.state_dict(), params_from_jax(after.critic_target), "critic_target", bound)
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(state.obs_rms, k).numpy(), getattr(after.obs_rms, k), err_msg=k, **TOL)
    np.testing.assert_allclose(state.obs.numpy(), after.obs, **TOL)
    for name in ("cur_returns", "cur_lengths"):
        np.testing.assert_allclose(getattr(state, name).numpy(), getattr(after, name), err_msg=name, **TOL)
    for name in ("return_tracker", "len_tracker"):
        t, jt = getattr(state, name), getattr(after, name)
        np.testing.assert_allclose(t.ring.numpy(), jt.ring, err_msg=name, **TOL)
        assert (int(t.ptr), int(t.count)) == (int(jt.ptr), int(jt.count)) and int(jt.count) > 0
    assert state.env_steps == int(after.env_steps) == 3 * SIZE["num_envs"] * SIZE["algo__horizon_len"]
    assert state.update_count == 1


def test_warmup_collect_matches_jax():
    """The warm-up's uniform-action collect from the JAX draws: the same chunk."""
    jcfg, jagent, agent = _agents(**SIZE)
    jagent.env.max_episode_length = agent.env.max_episode_length = MAX_LEN
    js = jagent.init(jax.random.PRNGKey(1))
    draws = jax_draws(jagent, jcfg, js.rng, random=True)
    state = agent.init()
    load_ddpgv_state(state, ddpgv_state_from_jax(ddpgv_tree(_copy(js))))
    _, jtraj = jagent._collect(js, random=True)
    _assert_chunk(agent.to_host(agent.collect(state, draws, random=True)), {k: np.asarray(v) for k, v in jtraj.items()})


def test_trains_through_host_ring():
    """tests/test_native.py::TestDDPGVThroughRing on the port: warm-up
    writes the ring, three iterations grow it, the metrics are finite and
    the stored frames are uint8 in [0, 255]."""
    size = dict(SIZE, algo__warm_up=4)
    agent = get_algo("DDPGV")(make_config("ddpgv", **size), device="cpu")
    state = agent.init(0)
    state, _ = agent.warmup(state)
    filled0 = agent.replay.filled
    assert filled0 == size["algo__horizon_len"]  # one collect of horizon_len steps, not warm_up
    for _ in range(3):
        state, metrics = agent.train_iter(state)
    assert agent.replay.filled == 4 * filled0
    for k, v in metrics.items():
        assert bool(torch.isfinite(v)), f"non-finite {k}"
    batch = agent.replay.sample(16, seed=1)
    assert batch["img"].dtype == np.uint8 and batch["img"].max() <= 255 and batch["img"].max() > 0
    assert state.update_count == 3 * 4  # update_times per iteration


def test_eval_hook_renders_from_the_env_state():
    jcfg, jagent, agent = _agents(**SIZE)
    js = _copy(jagent.init(jax.random.PRNGKey(2)))
    state = agent.init()
    load_ddpgv_state(state, ddpgv_state_from_jax(ddpgv_tree(js)))
    obs = np.random.default_rng(3).normal(size=js.obs.shape).astype(np.float32)
    want = jagent.eval_actor_apply(js.actor_params, jnp.asarray(obs), jax.tree_util.tree_map(jnp.asarray, js.env_state))
    assert agent.eval_actor_apply.needs_env_state and jagent.eval_actor_apply.needs_env_state
    with torch.no_grad():
        got = agent.eval_actor_apply(agent.eval_params(state), torch.from_numpy(obs), state.env_state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert isinstance(state.env_state, VecEnvState) and float(got.abs().max()) <= 1.0


def test_preset_and_ring_layout_match_jax():
    want = dataclasses.asdict(j_make_config("ddpgv").algo)
    got = dataclasses.asdict(make_config("ddpgv").algo)
    assert got == {k: want[k] for k in got}
    assert (got["name"], got["update_times"], got["eval_freq"], got["horizon_len"]) == ("DDPGV", 4, 100, 1)
    _, jagent, agent = _agents(**SIZE)
    assert agent.replay.fields == jagent.replay.fields and agent.replay.dtypes == jagent.replay.dtypes
    assert (agent.replay.slots, agent.replay.num_envs) == (jagent.replay.slots, jagent.replay.num_envs) == (64, 8)
    row = sum(d * agent.replay.dtypes[k].itemsize for k, d in agent.replay.fields.items())
    assert row == 28200  # bytes per (slot, env) row: two 13,824-byte frames and the fp16 rows
    assert max(5_000_000 // 4096, 2) == 1220  # the preset's slots at 4096 envs: 1220 × 4096 × 28,200 B


def _jax_train_script():
    spec = importlib.util.spec_from_file_location("jax_train_script", os.path.join(REPO, "scripts", "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_resume_follows_the_jax_package(tmp_path):
    """Neither package's DDPGV state holds the ring: a restored state is
    bitwise the saved one, the fresh agent's ring is empty and its sampler
    restarts at default_rng(0), and the next iteration refills the ring.
    Both packages' ``_resumed_iter`` subtract ``warm_up`` × E of env steps
    though DDPGV's warm-up is ``horizon_len`` steps: after the warm-up and
    40 iterations at the preset (horizon 1) they both count 9, 31 low."""
    port_fields = {f.name for f in dataclasses.fields(DDPGVState)}
    jax_fields = {f.name for f in dataclasses.fields(JDDPGVState)}
    assert not {"replay", "ring"} & (port_fields | jax_fields)
    assert jax_fields - {"rng", "actor_params", "critic_params"} | {"gen", "update_count", "actor", "critic"} == port_fields

    cfg = make_config("ddpgv", **SIZE)
    agent = DDPGV(cfg, device="cpu")
    state = agent.init(0)
    state, _ = agent.warmup(state)
    state, _ = agent.train_iter(state)
    checkpoint.save_checkpoint(str(tmp_path), state)
    assert "replay" not in checkpoint.state_dict(state)
    fresh = DDPGV(cfg, device="cpu")
    restored = checkpoint.load_checkpoint(str(tmp_path), fresh.init(5))
    for name in ("actor", "critic", "critic_target"):
        for (k, a), b in zip(getattr(state, name).state_dict().items(), getattr(restored, name).state_dict().values()):
            assert torch.equal(a, b), f"{name}.{k}"
    for name in ("actor", "critic"):
        for p, q in zip(getattr(state, name).parameters(), getattr(restored, name).parameters()):
            sa, sb = getattr(state, f"{name}_opt").state[p], getattr(restored, f"{name}_opt").state[q]
            assert all(torch.equal(sa[k], sb[k]) for k in ("exp_avg", "exp_avg_sq", "step"))
    assert all(torch.equal(getattr(state.obs_rms, k), getattr(restored.obs_rms, k)) for k in ("mean", "var", "count"))
    assert restored.env_steps == state.env_steps and fresh.replay.filled == 0
    np.testing.assert_array_equal(fresh.replay._rng.integers(0, 9, 5), np.random.default_rng(0).integers(0, 9, 5))
    restored, metrics = fresh.train_iter(restored)
    assert fresh.replay.filled == SIZE["algo__horizon_len"] and all(bool(torch.isfinite(v)) for v in metrics.values())

    preset = make_config("ddpgv", num_envs=16)
    steps = (preset.algo.horizon_len + 40 * preset.algo.horizon_len) * preset.num_envs
    jscript = _jax_train_script()
    probe = type("S", (), {"env_steps": steps})()
    assert train._resumed_iter(preset, probe, True) == jscript._resumed_iter(j_make_config("ddpgv", num_envs=16),
                                                                            probe, True) == 9
