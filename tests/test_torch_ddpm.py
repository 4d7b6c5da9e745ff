"""The port's DDPM schedule and sampler and its diffusion models against the
JAX package, on the CPU.

- the squaredcos_cap_v2 schedule (rtol 1e-6; at T = 100 the small betas,
  1 − ᾱ(i+1)/ᾱ(i) with the ratio near 1, carry the ratio's rounding, a few
  float32 ulps apart where XLA's and torch's cos round differently: atol
  4 · eps there);
- ``ddpm_add_noise`` and ``ddpm_step`` at t = 0, mid and T−1 with the
  x̂₀ clip active, and a full ``ddpm_sample`` with the JAX key chain's draws
  (``split(rng)`` → x_T from ``k_init``, one key per reverse step from
  ``split(k_loop, T)``);
- ``SinusoidalPosEmb``, ``DiffusionNet`` and ``MLPResNet`` (LayerNorm on,
  dropout deterministic), and both policies' ``get_actions`` and
  ``get_loss`` (``split(rng)`` → noise, ``randint(0, T)``) from converted
  flax params loaded with ``strict=True``; the equivariant net 16 wide with
  a 16-dim time embedding in both packages (fixture ``narrow``), the plain
  ``DiffusionNet`` at full width;
- the equivariant ε-field and sampler at full width: transformed cond, x and
  noise give the transformed output, and the identity on the obs does not;
- dropout from an explicit generator, and its refusal without one.

Tolerance rtol 1e-5 / atol 1e-6 unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen

from pql_tpu.models import diffusion as j_diffusion
from pql_tpu.models import ediffusion as j_ediffusion
from pql_tpu.ops import ddpm as j_ddpm
from pql_tpu_torch.algos import ma_base
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.envs import make_env
from pql_tpu_torch.models import diffusion, ediffusion
from pql_tpu_torch.models.emlp import concat_reps
from pql_tpu_torch.ops import ddpm
from pql_tpu_torch.utils.convert import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-6)
NARROW = 16  # the parity runs' EMLP width and time-embedding dim (fixture ``narrow``)


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _JaxNarrow(j_ediffusion.EquivariantDiffusionNet):
    dim: int = NARROW
    hidden_units: int = NARROW


class _PortNarrow(ediffusion.EquivariantDiffusionNet):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **dict(kwargs, dim=NARROW, hidden_units=NARROW))


@pytest.fixture
def narrow(monkeypatch):
    """Both packages' equivariant diffusion nets NARROW wide with a NARROW-dim
    time embedding (a flax trace of the EMLP 512 wide takes minutes on the
    CPU; the card and the port's own equivariance test run the full width)."""
    monkeypatch.setattr(j_ediffusion, "EquivariantDiffusionNet", _JaxNarrow)
    monkeypatch.setattr(ediffusion, "EquivariantDiffusionNet", _PortNarrow)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _reps():
    """BimanualReacher's joint obs rep and the joint (two-hand) action rep."""
    ma = ma_base.MultiAgentCtx(make_env(make_config("eqsd", task="BimanualReacher", num_envs=2)))
    return ma.joint_obs_gen(), concat_reps(ma.act_gen(), ma.act_gen())


def jax_sample_draws(rng, b: int, d: int, T: int):
    """x_T and the per-step noise of ``ddpm_sample(sched, eps_fn, (b, d), rng)``."""
    k_init, k_loop = jax.random.split(rng)
    x_T = jax.random.normal(k_init, (b, d))
    noise = jnp.stack([jax.random.normal(k, (b, d)) for k in jax.random.split(k_loop, T)])
    return _t(x_T), _t(noise)


def jax_loss_draws(rng, b: int, d: int, T: int):
    """The noise and timesteps of ``get_loss(obs, action, rng)``."""
    k_noise, k_t = jax.random.split(rng)
    return (_t(jax.random.normal(k_noise, (b, d), jnp.float32)),
            _t(jax.random.randint(k_t, (b,), 0, T)).long())


# ---------------------------------------------------------------- schedule


@pytest.mark.parametrize("T", [3, 5, 10, 100])
def test_schedule_matches_jax(T):
    want, got = j_ddpm.make_ddpm_schedule(T), ddpm.DDPMSchedule(T)
    assert got.num_timesteps == T
    for name in ("betas", "alphas", "alphas_cumprod"):
        g = getattr(got, name)
        assert g.dtype == torch.float32 and g.shape == (T,)
        atol = 4 * float(np.finfo(np.float32).eps) if (name == "betas" and T == 100) else 0.0
        np.testing.assert_allclose(g.numpy(), _np(getattr(want, name)), rtol=1e-6, atol=atol, err_msg=name)
    assert list(dict(got.named_buffers())) == ["betas", "alphas", "alphas_cumprod"]
    assert got.state_dict() == {}  # non-persistent: no policy's state_dict carries them


def test_add_noise_matches_jax():
    T = 5
    rng = np.random.default_rng(0)
    x0, noise = rng.normal(size=(2, 64, 6)).astype(np.float32)
    ts = rng.integers(0, T, size=64)
    want = j_ddpm.ddpm_add_noise(j_ddpm.make_ddpm_schedule(T), jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(ts))
    got = ddpm.ddpm_add_noise(ddpm.DDPMSchedule(T), _t(x0), _t(noise), _t(ts).long())
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("t", [0, 2, 4], ids=["t0", "mid", "last"])
def test_step_matches_jax_with_the_clip_active(t):
    T = 5
    rng = np.random.default_rng(t)
    sched, jsched = ddpm.DDPMSchedule(T), j_ddpm.make_ddpm_schedule(T)
    # x_t noised from an x₀ of std 1.5, the prediction near its noise: x̂₀
    # beyond [−1, 1] for part of the batch, so the clip is active
    a_bar = float(jsched.alphas_cumprod[t])
    x0_true, eps_true, err = rng.normal(size=(3, 128, 4))
    x_t = (np.sqrt(a_bar) * 1.5 * x0_true + np.sqrt(1 - a_bar) * eps_true).astype(np.float32)
    eps = (eps_true + 0.1 * np.sqrt(a_bar) * err).astype(np.float32)
    x0 = (x_t - np.sqrt(1 - a_bar) * eps) / np.sqrt(a_bar)
    assert 0.1 < float(np.mean(np.abs(x0) > 1.0)) < 0.9
    key = jax.random.PRNGKey(t)
    want = j_ddpm.ddpm_step(jsched, jnp.asarray(eps), t, jnp.asarray(x_t), key)
    noise = _t(jax.random.normal(key, x_t.shape, jnp.float32))
    got = ddpm.ddpm_step(sched, _t(eps), t, _t(x_t), noise)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    if t == 0:  # no noise at the last reverse step
        np.testing.assert_array_equal(got.numpy(), ddpm.ddpm_step(sched, _t(eps), t, _t(x_t), 0 * noise).numpy())


def test_sample_matches_jax():
    """A full reverse diffusion with an ε-field that reads x and t."""
    T, b, d = 5, 64, 4
    w = np.random.default_rng(1).normal(size=(d, d)).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    want = j_ddpm.ddpm_sample(j_ddpm.make_ddpm_schedule(T), lambda x, t: jnp.tanh(x @ w) + 0.1 * t[:, None],
                              (b, d), rng)
    x_T, noise = jax_sample_draws(rng, b, d, T)
    got = ddpm.ddpm_sample(ddpm.DDPMSchedule(T), lambda x, t: torch.tanh(x @ _t(w)) + 0.1 * t[:, None], x_T, noise)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_draw_sample_shapes_and_generator():
    x_T, noise = ddpm.draw_sample(torch.Generator().manual_seed(0), 8, 4, 5)
    assert x_T.shape == (8, 4) and noise.shape == (5, 8, 4)
    x2, n2 = ddpm.draw_sample(torch.Generator().manual_seed(0), 8, 4, 5)
    assert torch.equal(x_T, x2) and torch.equal(noise, n2)


# ------------------------------------------------------------------ models


def test_sinusoidal_pos_emb_matches_jax():
    t = np.array([0.0, 1.0, 2.0, 4.0, 17.0], np.float32)
    for dim in (16, 256):
        want = j_diffusion.SinusoidalPosEmb(dim).apply({}, jnp.asarray(t))
        got = diffusion.SinusoidalPosEmb(dim)(_t(t))
        assert got.shape == (5, dim)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_mish_matches_jax():
    x = np.linspace(-30, 30, 1001, dtype=np.float32)
    np.testing.assert_allclose(diffusion.mish(_t(x)).numpy(), _np(j_diffusion.mish(jnp.asarray(x))), **TOL)


def test_diffusion_net_matches_jax():
    rng = np.random.default_rng(2)
    x, cond = rng.normal(size=(32, 4)).astype(np.float32), rng.normal(size=(32, 24)).astype(np.float32)
    time = rng.integers(0, 5, size=32).astype(np.float32)
    jnet = j_diffusion.DiffusionNet(action_dim=4)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(time), jnp.asarray(cond))
    net = diffusion.DiffusionNet(4, 24, 4)
    net.load_state_dict(params_from_jax(_tree(params)), strict=True)
    want = jnet.apply(params, jnp.asarray(x), jnp.asarray(time), jnp.asarray(cond))
    with torch.no_grad():
        got = net(_t(x), _t(time), _t(cond))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_mlp_resnet_matches_jax():
    """LayerNorm on (flax eps 1e-6; the raw params moved off their init so
    scale and bias count), dropout deterministic."""
    rng = np.random.default_rng(3)
    x = (2.0 * rng.normal(size=(32, 10)) + 1.0).astype(np.float32)
    jnet = j_diffusion.MLPResNet(num_blocks=3, out_dim=3, hidden_dim=16)
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree_util.tree_map(lambda p: p + 0.1 * jnp.asarray(rng.normal(size=p.shape), jnp.float32), params)
    net = diffusion.MLPResNet(3, 10, 3, hidden_dim=16)
    net.load_state_dict(params_from_jax(_tree(params)), strict=True)
    want = jnet.apply(params, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        got = net(_t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_layer_norm_uses_flax_eps():
    """Inputs of variance ~1e-6: torch's default eps (1e-5) would part from flax's 1e-6."""
    x = 1e-3 * np.random.default_rng(4).normal(size=(8, 16)).astype(np.float32)
    want = linen.LayerNorm().apply({"params": {"scale": jnp.ones(16), "bias": jnp.zeros(16)}},
                                            jnp.asarray(x))
    with torch.no_grad():
        got = diffusion.LayerNorm(16)(_t(x))
        torch_default = torch.nn.functional.layer_norm(_t(x), (16,))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert float((torch_default - got).abs().max()) > 1e-2


def test_dropout_takes_an_explicit_generator():
    block = diffusion.MLPResNetBlock(8, dropout_rate=0.5, use_layer_norm=True, gen=torch.Generator().manual_seed(0))
    x = torch.randn(64, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = block(x, deterministic=False, gen=torch.Generator().manual_seed(2))
        b = block(x, deterministic=False, gen=torch.Generator().manual_seed(2))
        c = block(x, deterministic=False, gen=torch.Generator().manual_seed(3))
        off = block(x)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, off)
    with pytest.raises(ValueError, match="needs a generator"):
        block(x, deterministic=False)


def _policies(kind: str):
    """(JAX policy, its params, the port's policy with them loaded strictly)."""
    T = 5
    if kind == "state":
        jpol = j_diffusion.StateDiffusionPolicy(action_dim=4, diffusion_iter=T)
        pol = diffusion.StateDiffusionPolicy(24, 4, T)
    else:
        g_obs, g_act = _reps()
        jpol = j_ediffusion.EquivariantDiffusionPolicy(gen_obs=g_obs, gen_act=g_act, diffusion_iter=T)
        pol = ediffusion.EquivariantDiffusionPolicy(g_obs, g_act, T)
    key = jax.random.PRNGKey(5)
    params = jpol.init(key, jnp.zeros((1, 24)), jnp.zeros((1, 4)), key, method=type(jpol).get_loss)
    pol.load_state_dict(params_from_jax(_tree(params)), strict=True)
    return jpol, params, pol


@pytest.mark.parametrize("kind", ["state", "equivariant"])
def test_policy_get_actions_and_get_loss_match_jax(narrow, kind):
    jpol, params, pol = _policies(kind)
    assert pol.action_dim == pol.sample_dim == 4
    rng = np.random.default_rng(6)
    obs = rng.normal(size=(64, 24)).astype(np.float32)
    action = np.clip(rng.normal(size=(64, 4)), -1, 1).astype(np.float32)
    k_act, k_loss = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
    want_a = jpol.apply(params, jnp.asarray(obs), k_act, method=type(jpol).get_actions)
    want_l = jpol.apply(params, jnp.asarray(obs), jnp.asarray(action), k_loss, method=type(jpol).get_loss)
    x_T, step_noise = jax_sample_draws(k_act, 64, 4, 5)
    noise, ts = jax_loss_draws(k_loss, 64, 4, 5)
    with torch.no_grad():
        got_a = pol.get_actions(_t(obs), x_T, step_noise)
        got_l = pol.get_loss(_t(obs), _t(action), noise, ts)
    np.testing.assert_allclose(got_a.numpy(), _np(want_a), **TOL)
    np.testing.assert_allclose(float(got_l), float(want_l), **TOL)
    assert torch.equal(pol(_t(obs), x_T, step_noise), got_a)


def _equivariance_error(f, x, g_in, g_out):
    y, y_g = f(x), f(tuple(a @ g for a, g in zip(x, g_in)))
    return float((y_g - y @ g_out).abs().max()) / (1.0 + float(y.abs().max()))


def test_equivariant_net_and_sampler_are_equivariant():
    """At full width (EMLP 512 × 5 on 256 + 24 + 4 inputs), raw weights off
    the equivariant subspace: |f(x·G) − f(x)·G_act| ≤ 1e-5·(1 + |f|) for the
    ε-field (x, cond transformed; t invariant) and the sampler (cond, x_T and
    every step's noise transformed); with the obs left as it is, the check
    fails."""
    g_obs, g_act = (torch.tensor(g, dtype=torch.float32) for g in _reps())
    gen = torch.Generator().manual_seed(0)
    pol = ediffusion.EquivariantDiffusionPolicy(tuple(map(tuple, g_obs.numpy())), tuple(map(tuple, g_act.numpy())),
                                                gen=gen)
    assert pol.net.net.layers[1].weight.shape == (512, 512) and pol.net.layers[0].weight.shape == (1024, 256)
    with torch.no_grad():
        for p in pol.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
        obs, x = torch.randn(256, 24, generator=gen), torch.randn(256, 4, generator=gen)
        t = torch.randint(0, 5, (256,), generator=gen).float()
        x_T, noise = ddpm.draw_sample(gen, 256, 4, 5)
        eps_err = _equivariance_error(lambda a: pol.net(a[0], t, a[1]), (x, obs), (g_act, g_obs), g_act)
        sample = lambda a: pol.get_actions(a[0], a[1], a[2])  # noqa: E731
        gs = (g_obs, g_act, g_act)
        sample_err = _equivariance_error(sample, (obs, x_T, noise), gs, g_act)
        broken = _equivariance_error(sample, (obs, x_T, noise), (torch.eye(24), g_act, g_act), g_act)
    assert eps_err <= 1e-5 and sample_err <= 1e-5
    assert broken > 1e-3
