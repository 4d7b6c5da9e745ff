"""Per-module parity of the port (pql_tpu_torch) with the JAX package.

Each test gives both packages the same inputs, made with numpy from a
seed; where the JAX function draws from a key, the test derives that draw
with the JAX package's own functions and hands it to the port. Tolerances
are fp32 unless stated: rtol 1e-5 / atol 1e-6 where both sides run the
same elementwise arithmetic, looser (stated at the test) where matrix
products or reductions run in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pql_tpu.algos import base as jbase
from pql_tpu.cfg import config as jcfg
from pql_tpu.envs.base import VecEnv as JVecEnv
from pql_tpu.envs.base import handle_timeout as j_handle_timeout
from pql_tpu.envs.classic import Cartpole as JCartpole
from pql_tpu.models import mlp as jmlp
from pql_tpu.ops import distributional as jdist
from pql_tpu.ops import noise as jnoise
from pql_tpu.ops import schedules as jsched
from pql_tpu.ops.running_norm import RunningMeanStd as JRunningMeanStd
from pql_tpu.ops.soft_update import soft_update as j_soft_update
from pql_tpu.replay import buffer as jbuf
from pql_tpu.replay import nstep as jnstep
from pql_tpu.utils.trackers import Tracker as JTracker
from pql_tpu_torch.algos import base as tbase
from pql_tpu_torch.cfg import config as tcfg
from pql_tpu_torch.envs.base import VecEnv, VecEnvState, handle_timeout
from pql_tpu_torch.envs.classic import Cartpole
from pql_tpu_torch.models import mlp as tmlp
from pql_tpu_torch.ops import distributional as tdist
from pql_tpu_torch.ops import noise as tnoise
from pql_tpu_torch.ops.running_norm import RunningMeanStd
from pql_tpu_torch.ops.schedules import schedule_value
from pql_tpu_torch.ops.soft_update import soft_update
from pql_tpu_torch.replay import ReplayBuffer, create_nstep, nstep_scan, replay_slots
from pql_tpu_torch.utils.convert import params_from_jax
from pql_tpu_torch.utils.trackers import Tracker

EXACT = dict(rtol=1e-5, atol=1e-6)
FIELDS = ("x", "x_dot", "theta", "theta_dot")


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _reset_draw(env: JVecEnv, k_reset) -> np.ndarray:
    """Cartpole's fresh states for every env, as JAX's VecEnv draws them."""
    fresh = jax.vmap(env.task.init_state)(env.env_keys(k_reset))
    return np.stack([_np(fresh[k]) for k in FIELDS], -1)


# ------------------------------------------------------------------ cfg


@pytest.mark.parametrize(
    "argv",
    [
        ["algo=pql_d", "task=Cartpole", "num_envs=4096"],
        ["algo=pql", "num_envs=64", "algo.batch_size=512", "algo.noise.std_max=0.5", "max_step=1e5"],
        ["algo=pql_d", "algo.compute_dtype=bfloat16", "algo.use_pallas=false", "algo.max_grad_norm=null"],
        ["algo=pql", "task=PointMass", "eval_num_envs=32", "logging.mode=off", "logging.run_name=r",
         "checkpoint_dir=ckpt", "checkpoint_freq=50", "algo.eval_freq=50", "algo.adaptive_ratios=true",
         "algo.adapt_window=4", "algo.sample_slots=8", "algo.prefetch_batches=true", "artifact=snap",
         "profile_dir=trace", "profile_iters=5"],
        ["algo=ppo", "task=Ant", "task_param=true"],
        ["algo=ppo", "task=FrankaCubeStack", "task_param=true", "algo.lambda_entropy=0.01", "algo.use_gae=false"],
        ["algo=ppo", "task=Humanoid", "task_param=true", "algo.value_clip=false", "algo.ratio_clip=0.1"],
        ["algo=ippo", "task=BimanualReacher", "num_envs=4096", "algo.same_policy=true"],
        ["algo=mappo", "task=BimanualReacherSym", "algo.value_norm=true", "algo.lambda_gae_adv=0.9"],
        ["algo=iddpg", "task=BimanualReacher", "num_envs=4096"],
        ["algo=iddpg", "task=BimanualReacherSym", "algo.noise.type=fixed", "algo.memory_size=409600"],
        ["algo=qtotv1", "task=BimanualReacher", "algo.value_norm=true"],
        ["algo=qtotv2", "task=BimanualReacher"],
        ["algo=iart", "task=BimanualReacher", "num_envs=4096"],
        ["algo=ippoteam", "task=BimanualReacherSym"],
        ["algo=ippoteam2", "task=BimanualReacher", "algo.batch_size=16384"],
        ["algo=eqsd", "task=BimanualReacher", "num_envs=4096", "algo.diffusion=true", "algo.diffusion_iter=3"],
        ["algo=eqsd2", "task=BimanualReacherSym", "algo.kl_max=0.5", "algo.kl_decay_iters=200"],
        ["algo=ppov", "task=ReacherVision", "num_envs=4096", "algo.encoder_weights=trunk.npz"],
        ["algo=ippov", "task=BimanualReacherVision", "algo.batch_size=16384"],
        ["algo=ddpgv", "task=ReacherVision", "num_envs=4096", "algo.memory_size=1000000"],
        ["algo=pql_d", "num_devices=2", "mesh_axis=env", "dist.coordinator_address=localhost:29500",
         "dist.num_processes=2", "dist.process_id=1"],
    ],
)
def test_cfg_parse_cli_matches(argv):
    port = tcfg.to_dict(tcfg.parse_cli(list(argv)))
    ref = jcfg.to_dict(jcfg.parse_cli(list(argv)))

    def restrict(p, r):
        return {k: restrict(v, r[k]) if isinstance(v, dict) else r[k] for k, v in p.items()}

    assert port == restrict(port, ref)


def test_cfg_rejects_knobs_the_port_lacks():
    """The port's config now has every field of the JAX one (the multi-device
    ``dist`` group and ``mesh_axis`` came last), so what it refuses is a key
    neither package has and a value it cannot run (``platform=tpu``)."""
    for j_cls, t_cls in ((jcfg.Config, tcfg.Config), (jcfg.AlgoConfig, tcfg.AlgoConfig),
                         (jcfg.DistConfig, tcfg.DistConfig)):
        assert {f.name for f in dataclasses.fields(t_cls)} == {f.name for f in dataclasses.fields(j_cls)}
    with pytest.raises(AttributeError):
        tcfg.parse_cli(["algo=pql", "mesh_shape=env"])
    with pytest.raises(AttributeError):
        tcfg.parse_cli(["algo=pql", "dist.coordinator=localhost:1"])
    with pytest.raises(ValueError):
        tcfg.parse_cli(["algo=pql", "platform=tpu"])


# ----------------------------------------------------------------- envs


def _cartpole_states(seed, E):
    r = np.random.default_rng(seed)
    s = r.uniform(-0.3, 0.3, size=(E, 4)).astype(np.float32)
    s[0] = [2.99, 3.0, 0.0, 0.0]  # cart leaves the track: fell
    s[1] = [0.0, 0.0, 1.56, 4.0]  # pole falls past pi/2: fell
    s[2, 3] = np.nan  # a blown-up env: obs and reward sanitized
    time = r.integers(0, 400, size=E).astype(np.int32)
    time[3:6] = 499  # time limit this step: truncated (unless fell)
    time[1] = 499  # fell and at the limit: terminated, not truncated
    return s, time


def test_vecenv_cartpole_step_matches():
    E = 16
    s, time = _cartpole_states(0, E)
    actions = np.random.default_rng(1).uniform(-1.5, 1.5, size=(E, 1)).astype(np.float32)
    jenv = JVecEnv(JCartpole(), E)
    jstate = jax.tree_util.tree_map(
        jnp.asarray, type(jenv.reset(jax.random.PRNGKey(0))[0])(state={k: s[:, i] for i, k in enumerate(FIELDS)}, time=time)
    )
    rng = jax.random.PRNGKey(7)
    jst, jobs, jrew, jdone, jinfo = jenv.step(jstate, jnp.asarray(actions), rng)
    _, k_reset = jax.random.split(rng)
    draw = _reset_draw(jenv, k_reset)

    env = VecEnv(Cartpole(), E)
    st = VecEnvState(state={k: _t(s[:, i]) for i, k in enumerate(FIELDS)}, time=_t(time))
    tst, tobs, trew, tdone, tinfo = env.step(st, _t(actions), _t(draw))

    np.testing.assert_allclose(tobs.numpy(), _np(jobs), **EXACT)
    np.testing.assert_allclose(trew.numpy(), _np(jrew), **EXACT)
    np.testing.assert_array_equal(tdone.numpy(), _np(jdone))
    np.testing.assert_array_equal(tinfo["truncated"].numpy(), _np(jinfo["truncated"]))
    np.testing.assert_array_equal(tst.time.numpy(), _np(jst.time))
    for k in FIELDS:
        np.testing.assert_allclose(tst.state[k].numpy(), _np(jst.state[k]), **EXACT)
    assert tdone[:2].tolist() == [1.0, 1.0] and tinfo["truncated"][1].item() is False
    assert tinfo["truncated"][3:6].all()
    np.testing.assert_array_equal(
        handle_timeout(tdone, tinfo).numpy(), _np(j_handle_timeout(jdone, jinfo))
    )


def test_vecenv_reset_matches():
    E = 8
    jenv = JVecEnv(JCartpole(), E)
    key = jax.random.PRNGKey(3)
    jst, jobs = jenv.reset(key)
    draw = _reset_draw(jenv, key)
    st, obs = VecEnv(Cartpole(), E).reset(_t(draw))
    np.testing.assert_array_equal(obs.numpy(), _np(jobs))
    np.testing.assert_array_equal(st.time.numpy(), _np(jst.time))
    assert (np.abs(draw) <= 0.1).all()


def test_cartpole_reset_draw_range():
    gen = torch.Generator().manual_seed(0)
    d = Cartpole().draw_reset(gen, 4096)
    assert d.shape == (4096, 4) and float(d.min()) >= -0.1 and float(d.max()) <= 0.1
    assert abs(float(d.mean())) < 0.01


# ------------------------------------------------------------------ ops


def test_running_norm_matches():
    r = np.random.default_rng(0)
    jr, tr = JRunningMeanStd.create((4,)), RunningMeanStd((4,), device="cpu")
    for i in range(5):
        x = (r.normal(size=(32, 4)) * (i + 1) + i).astype(np.float32)
        jr = jr.update(jnp.asarray(x))
        tr.update(_t(x))
    np.testing.assert_allclose(tr.mean.numpy(), _np(jr.mean), **EXACT)
    np.testing.assert_allclose(tr.var.numpy(), _np(jr.var), rtol=1e-5)
    np.testing.assert_allclose(tr.count.numpy(), _np(jr.count), **EXACT)
    x = (r.normal(size=(16, 4)) * 30).astype(np.float32)
    np.testing.assert_allclose(tr.normalize(_t(x)).numpy(), _np(jr.normalize(x)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tr.normalize_clip(_t(x)).numpy(), _np(jr.normalize_clip(x)), rtol=1e-5, atol=1e-5
    )
    assert float(tr.normalize_clip(_t(x)).abs().max()) <= 5.0


@pytest.mark.parametrize("e_global,start,local", [(16, 0, 16), (16, 8, 8), (1, 0, 1)])
def test_mixed_noise_std_matches(e_global, start, local):
    got = tnoise.mixed_noise_std(e_global, 0.05, 0.8, start, local, device="cpu")
    np.testing.assert_allclose(got.numpy(), _np(jnoise.mixed_noise_std(e_global, 0.05, 0.8, start, local)), **EXACT)


def test_mixed_noise_matches_with_injected_draws():
    E, A = 16, 3
    x = np.random.default_rng(0).uniform(-1, 1, size=(E, A)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jnoise.add_mixed_normal_noise(key, jnp.asarray(x), 0.05, 0.8, out_bounds=(-1.0, 1.0), num_envs_global=E)
    normal = jnoise.per_row_normal(key, (E, A), jnp.float32, 0)
    got = tnoise.add_mixed_normal_noise(_t(x), _t(normal), 0.05, 0.8, out_bounds=(-1.0, 1.0), num_envs_global=E)
    np.testing.assert_allclose(got.numpy(), _np(want), **EXACT)


def test_normal_noise_clips_noise_then_output():
    """Target smoothing order (noise.py:97-101): clip noise to ±0.2, then the sum to ±1."""
    B, A = 64, 2
    x = np.random.default_rng(1).uniform(-1, 1, size=(B, A)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jnoise.add_normal_noise(key, jnp.asarray(x), 0.8, noise_bounds=(-0.2, 0.2), out_bounds=(-1.0, 1.0))
    normal = jax.random.normal(key, (B, A), jnp.float32)
    got = tnoise.add_normal_noise(_t(x), _t(normal), 0.8, noise_bounds=(-0.2, 0.2), out_bounds=(-1.0, 1.0))
    np.testing.assert_allclose(got.numpy(), _np(want), **EXACT)


@pytest.mark.parametrize("decay", [None, "linear", "exp"])
def test_schedule_matches(decay):
    noise = tcfg.NoiseConfig(decay=decay, lin_decay_iters=100)
    jnoise_cfg = jcfg.NoiseConfig(decay=decay, lin_decay_iters=100)
    for step in (0, 1, 37, 99, 100, 5000):
        assert schedule_value(noise, step) == pytest.approx(float(jsched.schedule_value(jnoise_cfg, step)), rel=1e-6)


def test_soft_update_matches():
    tgt = tmlp.MLPNet(3, 2, (8,), gen=torch.Generator().manual_seed(0))
    src = tmlp.MLPNet(3, 2, (8,), gen=torch.Generator().manual_seed(1))
    jt = {k: v.detach().numpy().copy() for k, v in tgt.state_dict().items()}
    js = {k: v.detach().numpy().copy() for k, v in src.state_dict().items()}
    want = j_soft_update(jt, js, 0.05)
    soft_update(tgt, src, 0.05)
    for k, v in tgt.state_dict().items():
        np.testing.assert_allclose(v.numpy(), _np(want[k]), **EXACT)


def test_distributional_ops_match():
    r = np.random.default_rng(0)
    B, A = 40, 51
    logits = r.normal(size=(3, B, A)).astype(np.float32)
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    rew = (3 * r.normal(size=(B, 1))).astype(np.float32)
    done = (r.uniform(size=(B, 1)) < 0.3).astype(np.float32)
    # dense einsum vs dense einsum: same arithmetic, summed in another order
    np.testing.assert_allclose(
        tdist.categorical_projection(_t(p[0]), _t(rew), _t(done), 0.97).numpy(),
        _np(jdist.categorical_projection(p[0], rew, done, 0.97)), atol=1e-6,
    )
    np.testing.assert_allclose(
        tdist.categorical_td_target(_t(p[0]), _t(p[1]), _t(rew), _t(done), 0.97, -10.0, 10.0).numpy(),
        _np(jdist.categorical_td_target(p[0], p[1], rew, done, 0.97, -10.0, 10.0)), atol=1e-6,
    )
    np.testing.assert_allclose(
        tdist.dist_to_q(_t(p[0]), -10.0, 10.0).numpy(), _np(jdist.dist_to_q(p[0], -10.0, 10.0)), atol=1e-5
    )
    pred = p[2].copy()
    pred[0, :3] = [0.0, 1.0, 1e-9]  # exercises the eps clip
    assert tdist.binary_cross_entropy(_t(pred), _t(p[0])).item() == pytest.approx(
        float(jdist.binary_cross_entropy(pred, p[0])), rel=1e-5
    )


# --------------------------------------------------------------- replay


@pytest.mark.parametrize("n", [1, 3])
def test_nstep_scan_matches(n):
    r = np.random.default_rng(n)
    T, E, O, A = 9, 16, 4, 1
    traj = dict(
        obs=r.normal(size=(T, E, O)), action=r.uniform(-1, 1, size=(T, E, A)),
        reward=r.normal(size=(T, E, 1)), next_obs=r.normal(size=(T, E, O)),
        done=(r.uniform(size=(T, E, 1)) < 0.3),
    )
    traj = {k: v.astype(np.float32) for k, v in traj.items()}
    js, jout, jvalid = jnstep.nstep_scan(jnstep.create_nstep(E, O, A, n, 0.99), {k: jnp.asarray(v) for k, v in traj.items()})
    ts, tout, tvalid = nstep_scan(create_nstep(E, O, A, n, 0.99, device="cpu"), {k: list(_t(v)) for k, v in traj.items()})
    for k in traj:
        np.testing.assert_allclose(tout[k].numpy(), _np(jout[k]), **EXACT)
    assert tvalid == [bool(v) for v in _np(jvalid)]
    assert ts.count == int(js.count)
    if n > 1:
        np.testing.assert_array_equal(ts.done.numpy(), _np(js.done))


@pytest.mark.parametrize("memory,E,T", [(5000, 16, 1), (1000, 16, 4), (10, 16, 1)])
def test_replay_slots_matches(memory, E, T):
    assert replay_slots(memory, E, T) == jbuf.replay_slots(memory, E, T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_replay_add_and_sample_match(dtype):
    """Writes wrap the ring; samples with JAX's own indices agree field by
    field (the JAX ring pads rows to 64 columns, the port's does not)."""
    r = np.random.default_rng(0)
    slots, E, O, A, B = 5, 8, 4, 1, 64
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    jr = jbuf.create_replay(slots, E, O, A, obs_dtype=jd, valid_start=2)
    tr = ReplayBuffer(slots, E, O, A, dtype=td, valid_start=2, device="cpu")
    dims = dict(obs=O, action=A, reward=1, next_obs=O, done=1)
    for step in range(8):
        rows = {k: r.normal(size=(1, E, d)).astype(np.float32) for k, d in dims.items()}
        jr = jbuf.replay_add(jr, {k: jnp.asarray(v) for k, v in rows.items()})
        tr.add({k: _t(v) for k, v in rows.items()})
        assert (tr.ptr, tr.total_writes, tr.valid_start) == (int(jr.ptr), int(jr.total_writes), int(jr.valid_start))
        key = jax.random.PRNGKey(step)
        want = jbuf.replay_sample(jr, key, B)
        k_slot, k_env = jax.random.split(key)
        raw = jax.random.randint(k_slot, (B,), 0, 1 << 30)
        env = jax.random.randint(k_env, (B,), 0, E)
        got = tr.sample(_t(raw).long(), _t(env).long())
        for k in dims:
            np.testing.assert_array_equal(got[k].numpy(), _np(want[k]))
    for k in dims:
        np.testing.assert_array_equal(tr.field(k).float().numpy(), _np(jr.field(k).astype(jnp.float32)))


# --------------------------------------------------------------- models


def _flax_params(module, *inputs, seed=0):
    params = module.init(jax.random.PRNGKey(seed), *inputs)
    return params, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("name", ["TanhMLPPolicy", "DoubleQ", "DistributionalDoubleQ"])
def test_models_match_with_converted_params(name):
    """Default widths [512, 256, 128]; fp32 products summed in another
    order: rtol 1e-5, atol 2e-6."""
    r = np.random.default_rng(0)
    O, A, B = 4, 1, 8
    obs = r.normal(size=(B, O)).astype(np.float32)
    act = r.uniform(-1, 1, size=(B, A)).astype(np.float32)
    if name == "TanhMLPPolicy":
        jm, tm = jmlp.TanhMLPPolicy(act_dim=A), tmlp.TanhMLPPolicy(O, A)
        args = (obs,)
    elif name == "DoubleQ":
        jm, tm = jmlp.DoubleQ(), tmlp.DoubleQ(O, A)
        args = (obs, act)
    else:
        jm, tm = jmlp.DistributionalDoubleQ(), tmlp.DistributionalDoubleQ(O, A)
        args = (obs, act)
    params, np_params = _flax_params(jm, *(jnp.asarray(a) for a in args))
    sd = params_from_jax(np_params)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    want = jm.apply(params, *args)
    got = tm(*(_t(a) for a in args))
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.detach().numpy(), _np(w), rtol=1e-5, atol=2e-6)
    if name != "TanhMLPPolicy":
        np.testing.assert_allclose(
            tm.q_min(*(_t(a) for a in args)).detach().numpy(),
            _np(jm.apply(params, *args, method=type(jm).q_min)), rtol=1e-5, atol=2e-5,
        )


def test_bf16_compute_returns_fp32_near_jax():
    """bf16 rounds at other places in the two frameworks: compare at 2e-2."""
    r = np.random.default_rng(1)
    obs = r.normal(size=(8, 4)).astype(np.float32)
    jm, tm = jmlp.TanhMLPPolicy(act_dim=1, dtype=jnp.bfloat16), tmlp.TanhMLPPolicy(4, 1, dtype=torch.bfloat16)
    params, np_params = _flax_params(jm, jnp.asarray(obs))
    tm.load_state_dict(params_from_jax(np_params))
    got = tm(_t(obs))
    assert got.dtype == torch.float32 and all(p.dtype == torch.float32 for p in tm.parameters())
    np.testing.assert_allclose(got.detach().numpy(), _np(jm.apply(params, obs)), atol=2e-2)


def test_linear_init_bounds_from_generator():
    a = tmlp.Linear(64, 8, gen=torch.Generator().manual_seed(0))
    b = tmlp.Linear(64, 8, gen=torch.Generator().manual_seed(0))
    assert torch.equal(a.weight, b.weight) and float(a.weight.detach().abs().max()) <= 1 / 8
    assert a.weight.shape == (8, 64)


# ------------------------------------------------------------- trackers


def test_tracker_matches_below_window():
    r = np.random.default_rng(0)
    jt, tt = JTracker.create(10), Tracker(10, device="cpu")
    for _ in range(12):
        vals = r.normal(size=16).astype(np.float32)
        mask = r.uniform(size=16) < 0.3  # ≤ 10 inserts per update here
        if mask.sum() > 10:
            mask[np.flatnonzero(mask)[10:]] = False
        jt = jt.update(jnp.asarray(vals), jnp.asarray(mask))
        tt.update(_t(vals), _t(mask))
        np.testing.assert_array_equal(tt.ring.numpy(), _np(jt.ring))
        assert (int(tt.ptr), int(tt.count)) == (int(jt.ptr), int(jt.count))
        assert float(tt.mean()) == pytest.approx(float(jt.mean()), rel=1e-6)


def test_tracker_keeps_last_window_in_env_order():
    """The port's rule when more than ``length`` values arrive at once."""
    tt = Tracker(4, device="cpu")
    tt.update(torch.tensor([1.0, 2.0]), torch.tensor([True, True]))  # ptr 2
    vals = torch.arange(10, 20, dtype=torch.float32)
    mask = torch.tensor([True] * 9 + [False])
    tt.update(vals, mask)  # 9 inserts: 10..18 at slots 2,3,0,1,2,3,0,1,2
    # sequential insertion leaves 15, 16, 17, 18 at slots 3, 0, 1, 2
    assert tt.ring.tolist() == [16.0, 17.0, 18.0, 15.0]
    assert (int(tt.ptr), int(tt.count)) == ((2 + 9) % 4, 11)
    assert float(tt.mean()) == pytest.approx(16.5)


# ---------------------------------------------------------- algos/base


def test_build_critic_rewrites_distributional_name():
    cfg = tcfg.make_config("pql_d")
    critic = tbase.build_critic(cfg, 4, 1, torch.Generator().manual_seed(0))
    assert isinstance(critic, tmlp.DistributionalDoubleQ) and critic.num_atoms == 51
    assert type(jbase.build_critic(jcfg.make_config("pql_d"), JVecEnv(JCartpole(), 1))).__name__ == type(critic).__name__
    actor = tbase.build_actor(cfg, 4, 1, torch.Generator().manual_seed(0))
    assert isinstance(actor, tmlp.TanhMLPPolicy)


def test_target_policy_actions_match():
    r = np.random.default_rng(0)
    B = 64
    obs = r.normal(size=(B, 4)).astype(np.float32)
    jcfg_ = jcfg.make_config("pql_d")
    jm = jmlp.TanhMLPPolicy(act_dim=1)
    params, np_params = _flax_params(jm, jnp.asarray(obs))
    key = jax.random.PRNGKey(4)
    want = jbase.target_policy_actions(jcfg_, jm, params, jnp.asarray(obs), key)
    tm = tmlp.TanhMLPPolicy(4, 1)
    tm.load_state_dict(params_from_jax(np_params))
    normal = jax.random.normal(key, (B, 1), jnp.float32)
    got = tbase.target_policy_actions(tcfg.make_config("pql_d"), tm, _t(obs), _t(normal))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["norm_below_clip", "norm_above_clip"])
def test_optimizer_matches_optax_chain(grad_scale):
    """Hand-written clip + torch AdamW vs optax clip_by_global_norm(0.5) +
    adamw over 12 steps, same gradients each step. Same arithmetic in
    another order: rtol 1e-5, atol 1e-6."""
    r = np.random.default_rng(0)
    shapes = {"w": (7, 5), "b": (5,)}
    p0 = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = jbase.build_optimizer(1e-2, 0.5)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jopt = tx.init(jparams)
    tparams = [torch.nn.Parameter(_t(p0[k])) for k in shapes]
    topt = torch.optim.AdamW(tparams, lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    norms = []
    for _ in range(12):
        g = {k: (grad_scale * r.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
        norms.append(np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values())))
        upd, jopt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jopt, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, upd)
        tbase.optimizer_step(topt, tparams, [_t(g[k]) for k in shapes], 0.5)
        for k, tp in zip(shapes, tparams):
            np.testing.assert_allclose(tp.detach().numpy(), _np(jparams[k]), rtol=1e-5, atol=1e-6)
    assert (max(norms) < 0.5) if grad_scale < 1 else (min(norms) > 0.5)


def test_clip_scales_only_above_max():
    g = [torch.tensor([0.3, 0.0]), torch.tensor([0.3])]  # norm 0.424 < 0.5
    tbase.clip_by_global_norm_(g, 0.5)
    assert g[0].tolist() == pytest.approx([0.3, 0.0]) and g[1].tolist() == pytest.approx([0.3])
    g = [torch.tensor([3.0, 0.0]), torch.tensor([4.0])]  # norm 5
    tbase.clip_by_global_norm_(g, 0.5)
    assert g[0].tolist() == pytest.approx([0.3, 0.0]) and g[1].tolist() == pytest.approx([0.4])
