"""The vision tier's models of the port against the JAX package, on the CPU.

- ``models/pointnet.py``: ``MLP``, ``MultiStagePointNetEncoder`` (fed
  negative pre-activations: flax's ``nn.leaky_relu`` slope 0.01, not relu),
  ``StateEncoder`` and ``Encoder`` from the same flax params;
- ``models/visual.py``: ``random_shifts_aug`` (the JAX shifts injected),
  ``fourier_encode``, ``TimestepEmbedder``, ``PointNetEncoderXYZ`` (three
  norm settings); flax ``SAME`` padding on a ramp image (the 7×7/2 stem pads
  (2, 3), the 3×3/2 max pool (0, 1) with −inf); ``ResNet18Trunk`` and
  ``ResEncoder`` on 32×32 and 48×48 frames; the frame-0 no-grad pass against
  one batched pass (same loss, gradients within 1e-6 relative); ``DINOEncoder``
  at depth 1 and 2 (48×48 in 14×14 patches: 4×4 of them) and its refusal of
  ``pretrained``; ``DiagGaussianMLPVPolicy`` with the ResNet encoder at the
  PPOV agent's width (mean, log-std, sample, log-prob, entropy), and
  without a camera;
- ``DiffusionPolicy``: actions and loss from the JAX draws;
- the initializers by distribution; the registry's 22 names.

Tolerance rtol 1e-4 / atol 1e-5 (tests/test_torch_ppo.py's ``TOL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen

from pql_tpu.models import MODEL_REGISTRY as J_REGISTRY
from pql_tpu.models import diffusion as j_diffusion
from pql_tpu.models import pointnet as j_pointnet
from pql_tpu.models import visual as j_visual
from pql_tpu_torch.models import MODEL_REGISTRY, diffusion, pointnet, visual
from pql_tpu_torch.utils.convert import params_from_jax
from test_torch_ddpm import jax_loss_draws, jax_sample_draws
from test_torch_pql import TOL, _copy


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _load(module, params):
    module.load_state_dict(params_from_jax(_copy(params)), strict=True)
    return module


def _close(got, want, what="", **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=what, **(tol or TOL))


def _images(shape, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 1.0, size=shape).astype(np.float32)


# --------------------------------------------------------------- pointnet


def test_mlp_matches_jax():
    x = np.random.default_rng(0).normal(size=(8, 5)).astype(np.float32)
    jm = j_pointnet.MLP(out_dim=3, hidden=(16, 12), act="elu", squash_output=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    m = _load(pointnet.MLP(5, 3, (16, 12), act="elu", squash_output=True), params)
    _close(m(_t(x)), jm.apply(params, jnp.asarray(x)))


def test_multistage_pointnet_uses_the_flax_leaky_slope(monkeypatch):
    """Inputs far off the origin drive the pre-activations negative: the
    port matches flax's nn.leaky_relu (slope 0.01) and a relu would not."""
    pc = (np.random.default_rng(1).normal(size=(4, 40, 3)) * 3.0 - 2.0).astype(np.float32)
    jm = j_pointnet.MultiStagePointNetEncoder(h_dim=16, out_channels=24, num_layers=3)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(pc))
    assert {"conv_in", "layer_0", "global_2", "conv_out"} <= set(params["params"])
    m = _load(pointnet.MultiStagePointNetEncoder(3, h_dim=16, out_channels=24, num_layers=3), params)
    want = jm.apply(params, jnp.asarray(pc))
    _close(m(_t(pc)), want)
    pre = m.conv_in(_t(pc))
    assert float((pre < 0).float().mean()) > 0.2
    monkeypatch.setitem(pointnet.ACTIVATIONS, "leaky_relu", torch.relu)
    assert not np.allclose(m(_t(pc)).detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_state_encoder_and_encoder_match_jax():
    rng = np.random.default_rng(2)
    state, pc = rng.normal(size=(6, 7)).astype(np.float32), rng.normal(size=(6, 40, 3)).astype(np.float32)
    js = j_pointnet.StateEncoder()
    ps = js.init(jax.random.PRNGKey(2), jnp.asarray(state))
    s = _load(pointnet.StateEncoder(7), ps)
    assert s.output_dim == js.output_dim == 64
    _close(s(_t(state)), js.apply(ps, jnp.asarray(state)))
    je = j_pointnet.Encoder(pointcloud_feature_dim=32)
    pe = je.init(jax.random.PRNGKey(3), jnp.asarray(state), jnp.asarray(pc))
    e = _load(pointnet.Encoder(7, pointcloud_feature_dim=32), pe)
    assert e.n_output_channels == je.n_output_channels == 96
    _close(e(_t(state), _t(pc)), je.apply(pe, jnp.asarray(state), jnp.asarray(pc)))


# ---------------------------------------------------------- visual basics


def test_random_shifts_aug_matches_jax():
    x = _images((6, 16, 16, 3), 3)
    key = jax.random.PRNGKey(4)
    want = j_visual.random_shifts_aug(key, jnp.asarray(x), pad=2)
    shifts = _t(jax.random.randint(key, (6, 2), 0, 5)).long()
    assert shifts.min() >= 0 and shifts.max() <= 4
    got = visual.random_shifts_aug(_t(x), shifts, pad=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    drawn = visual.draw_shifts(torch.Generator().manual_seed(0), 1000, 2)
    assert drawn.shape == (1000, 2) and set(drawn.unique().tolist()) == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("include_input", [False, True])
def test_fourier_encode_matches_jax(include_input):
    x = np.random.default_rng(5).normal(size=(3, 5)).astype(np.float32)
    want = j_visual.fourier_encode(jnp.asarray(x), 8, 10.0, include_input)
    got = visual.fourier_encode(_t(x), 8, 10.0, include_input)
    assert got.shape == ((3, 85) if include_input else (3, 80))
    _close(got, want)


def test_timestep_embedder_matches_jax():
    x = np.random.default_rng(6).uniform(0, 1, size=(4, 5)).astype(np.float32)
    jm = j_visual.TimestepEmbedder(d_model=32, freq_dim=16)
    params = jm.init(jax.random.PRNGKey(6), jnp.asarray(x))
    m = _load(visual.TimestepEmbedder(5, 32, freq_dim=16), params)
    _close(m(_t(x)), jm.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("use_layernorm,final_norm", [(False, "none"), (True, "layernorm"), (False, "layernorm")])
def test_pointnet_xyz_matches_jax(use_layernorm, final_norm):
    pc = np.random.default_rng(7).normal(size=(3, 24, 3)).astype(np.float32)
    jm = j_visual.PointNetEncoderXYZ(out_channels=16, use_layernorm=use_layernorm, final_norm=final_norm)
    params = jm.init(jax.random.PRNGKey(7), jnp.asarray(pc))
    m = _load(visual.PointNetEncoderXYZ(3, 16, use_layernorm, final_norm), params)
    got = m(_t(pc))
    _close(got, jm.apply(params, jnp.asarray(pc)))
    _close(m(_t(pc[:, ::-1].copy())), got.detach().numpy(), atol=1e-5)  # invariant to the points' order


# ---------------------------------------------------------- SAME padding


def test_same_padding_on_a_ramp_matches_flax():
    """One-hot kernels read the padded input: the 7×7/2 stem's windows on 48
    start at 2i − 2 (pad (2, 3)), the 3×3/2 max pool's on 24 at 2i (pad (0, 1),
    −inf), the 3×3/2 conv's on 12 at 2i (pad (0, 1)); DINO's 14×14/14 on 48
    pads (4, 4). torch's symmetric k//2 would start them at 2i − 3 and 2i − 1."""
    assert visual.same_pad(48, 7, 2) == (2, 3) and visual.same_pad(24, 3, 2) == (0, 1)
    assert visual.same_pad(12, 3, 2) == (0, 1) and visual.same_pad(12, 1, 2) == (0, 0)
    assert visual.same_pad(48, 14, 14) == (4, 4) and visual.same_pad(12, 3, 1) == (1, 1)
    ramp = np.arange(48 * 48, dtype=np.float32).reshape(1, 48, 48, 1) + 1.0
    for size, k, s in ((48, 7, 2), (12, 3, 2), (12, 1, 2), (48, 14, 14)):
        x = ramp[:, :size, :size]
        kernel = np.zeros((k, k, 1, 1), np.float32)
        kernel[0, 0, 0, 0] = 1.0
        want = linen.Conv(1, (k, k), (s, s), use_bias=False).apply({"params": {"kernel": jnp.asarray(kernel)}},
                                                                    jnp.asarray(x))
        conv = visual.Conv2d(1, 1, k, s)
        with torch.no_grad():
            conv.weight.copy_(_t(kernel.transpose(3, 2, 0, 1)))
            got = conv(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{k}x{k}/{s} on {size}")
    x = ramp[:, :24, :24]
    want = linen.max_pool(jnp.asarray(x), (3, 3), (2, 2), padding="SAME")
    got = visual.max_pool_same(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows_read = (got[0, :, 0, 0].numpy() - 3.0) / 48.0  # the last row of each window (column 2 of 48)
    np.testing.assert_array_equal(rows_read, [2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 23])


# ------------------------------------------------------------ conv nets


@pytest.mark.parametrize("hw", [32, 48])
def test_res_encoder_matches_jax(hw):
    obs = _images((2, 1, 2, hw, hw, 3), hw)
    jm = j_visual.ResEncoder(repr_dim=64, num_cams=1)
    params = jm.init(jax.random.PRNGKey(8), jnp.asarray(obs))
    m = _load(visual.ResEncoder((1, 2, hw, hw, 3), repr_dim=64), params)
    assert m.layers[0].weight.shape[1] == 2 * (hw // 8) ** 2 * 128  # 9,216 inputs at 48
    x = obs.reshape(4, hw, hw, 3)
    want = j_visual.ResNet18Trunk().apply({"params": params["params"]["ResNet18Trunk_0"]}, jnp.asarray(x))
    # atol 3e-5 for the trunk's features (up to ~7): ten fp32 convolutions deep, XLA and
    # oneDNN sum their 576- to 3,136-term dot products in different orders
    _close(m.trunk(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1), want, "trunk", rtol=1e-4, atol=3e-5)
    with torch.no_grad():
        _close(m(_t(obs)), jm.apply(params, jnp.asarray(obs)), "encoder")
    _close(m(_t(obs)), jm.apply(params, jnp.asarray(obs)), "encoder, frame 0 without grad")


def test_frame0_no_grad_is_the_batched_function():
    """The trunk on frame 0 under no_grad and on frames 1.. with autograd
    (the stem recomputed in the backward): the loss and every parameter
    gradient of the one-batch form (stop_gradient on conv[:, :T−1], every
    activation kept), T = 3, within 1e-6 relative. In
    float64: in fp32 the convolutions' rounding depends on the batch size
    (~1e-6 relative on this CPU), which would hide a real difference."""
    obs = _t(_images((2, 2, 3, 32, 32, 3), 9)).double()
    m = visual.ResEncoder((2, 3, 32, 32, 3), repr_dim=32, gen=torch.Generator().manual_seed(0),
                          dtype=torch.float64).double()
    w = torch.randn(2, 64, generator=torch.Generator().manual_seed(1), dtype=torch.float64)

    def batched(obs):
        b, cams, t, h, w_, c = obs.shape
        conv = m.trunk(obs.reshape(-1, h, w_, c).permute(0, 3, 1, 2))
        conv = conv.reshape((b * cams, t) + conv.shape[1:]).permute(0, 1, 3, 4, 2)
        cur = conv[:, 1:]
        feats = torch.cat([cur, cur - conv[:, : t - 1].detach()], 1).reshape(b * cams, -1)
        return m.norm(m.layers[0](feats)).reshape(b, cams * m.repr_dim)

    params = list(m.parameters())
    losses, grads = [], []
    for f in (m, batched):
        loss = torch.sum(w * torch.tanh(f(obs)))
        losses.append(loss.detach())
        grads.append(torch.autograd.grad(loss, params))
    np.testing.assert_allclose(float(losses[0]), float(losses[1]), rtol=1e-6)
    for p, a, b in zip((n for n, _ in m.named_parameters()), *grads):
        assert float((a - b).norm()) <= 1e-6 * float(b.norm()) + 1e-12, p
    assert float(grads[0][0].norm()) > 0


@pytest.mark.parametrize("depth,hw,patch", [(1, 48, 14), (2, 32, 8)])
def test_dino_encoder_matches_jax(depth, hw, patch):
    obs = _images((2, 2, hw, hw, 3), depth)
    jm = j_visual.DINOEncoder(repr_dim=48, num_cams=2, patch=patch, depth=depth)
    params = jm.init(jax.random.PRNGKey(10), jnp.asarray(obs))
    m = _load(visual.DINOEncoder((2, hw, hw, 3), repr_dim=48, patch=patch, depth=depth), params)
    tokens = m.convs[0](_t(obs[:, 0]).permute(0, 3, 1, 2))
    assert tokens.shape[-2:] == (-(-hw // patch),) * 2  # 48 / 14: 4 × 4 patches
    # weights off their init: the attention biases and norm shifts are 0 there
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(lambda p: p + 0.05 * rng.normal(size=p.shape).astype(np.float32), _copy(params))
    _load(m, params)
    _close(m(_t(obs)), jm.apply(params, jnp.asarray(obs)))


def test_dino_pretrained_is_refused():
    with pytest.raises(NotImplementedError, match="torch-hub"):
        visual.DINOEncoder((2, 32, 32, 3), pretrained=True)
    with pytest.raises(NotImplementedError):
        j_visual.DINOEncoder(pretrained=True, patch=8, depth=1).init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 32, 32, 3)))


def _policy_pair(encoder_type, feature_dim, hidden_dim, img, state, pc, init_log_std=-0.5):
    jm = j_visual.DiagGaussianMLPVPolicy(act_dim=2, num_cams=1, encoder_type=encoder_type, feature_dim=feature_dim,
                                         hidden_dim=hidden_dim, init_log_std=init_log_std)
    params = jm.init(jax.random.PRNGKey(12), None if img is None else jnp.asarray(img), jnp.asarray(state),
                     jnp.asarray(pc))
    m = visual.DiagGaussianMLPVPolicy(6, 2, None if img is None else img.shape[1:], feature_dim, hidden_dim,
                                      init_log_std, encoder_type)
    return jm, params, _load(m, params)


@pytest.mark.parametrize("camera", [True, False], ids=["resnet", "no-camera"])
def test_visual_policy_matches_jax(camera):
    """With the camera: the ResNet encoder at its default width and the PPOV
    agent's widths (256, 256) on 48×48 frames; without: narrowed to 32."""
    rng = np.random.default_rng(13)
    state, pc = rng.normal(size=(4, 6)).astype(np.float32), rng.normal(size=(4, 40, 3)).astype(np.float32)
    img = _images((4, 1, 2, 48, 48, 3), 14) if camera else None
    width = 256 if camera else 32
    jm, params, m = _policy_pair("resnet" if camera else None, width, width, img, state, pc)
    args = (None if img is None else jnp.asarray(img), jnp.asarray(state), jnp.asarray(pc))
    targs = (None if img is None else _t(img), _t(state), _t(pc))
    if camera:
        assert m.encoder.layers[0].weight.shape == (1024, 9216)
    mean_w, ls_w = jm.apply(params, *args)
    key = jax.random.PRNGKey(15)
    a_w, lp_w, ent_w = jm.apply(params, *args, key, method=j_visual.DiagGaussianMLPVPolicy.sample)
    lp2_w, ent2_w = jm.apply(params, *args, a_w, method=j_visual.DiagGaussianMLPVPolicy.logprob_entropy)
    normal = _t(jax.random.normal(key, (4, 2), jnp.float32))
    with torch.no_grad():
        mean, ls = m(*targs)
        a, lp, ent = m.sample(*targs, normal)
    lp2, ent2 = m.logprob_entropy(*targs, _t(a_w))
    for got, want, what in ((mean, mean_w, "mean"), (ls, ls_w, "log_std"), (a, a_w, "action"),
                            (lp, lp_w, "logp"), (ent, ent_w, "entropy"), (lp2, lp2_w, "logp of the JAX actions"),
                            (ent2, ent2_w, "entropy")):
        _close(got, want, what, rtol=1e-4, atol=1e-4 if "logp" in what else 1e-5)
    assert m.logstd.dtype == torch.float32 and m.logstd.tolist() == [-0.5, -0.5]


def test_diffusion_policy_matches_jax():
    rng = np.random.default_rng(16)
    state, pc = rng.normal(size=(32, 6)).astype(np.float32), rng.normal(size=(32, 40, 3)).astype(np.float32)
    action = np.clip(rng.normal(size=(32, 2)), -1, 1).astype(np.float32)
    jm = j_diffusion.DiffusionPolicy(action_dim=2, diffusion_iter=5)
    key = jax.random.PRNGKey(17)
    params = jm.init(key, jnp.asarray(state), jnp.asarray(pc), jnp.asarray(action), key,
                     method=j_diffusion.DiffusionPolicy.get_loss)
    m = _load(diffusion.DiffusionPolicy(6, 2, 5), params)
    k_act, k_loss = jax.random.PRNGKey(18), jax.random.PRNGKey(19)
    want_a = jm.apply(params, jnp.asarray(state), jnp.asarray(pc), k_act, method=j_diffusion.DiffusionPolicy.get_actions)
    want_l = jm.apply(params, jnp.asarray(state), jnp.asarray(pc), jnp.asarray(action), k_loss,
                      method=j_diffusion.DiffusionPolicy.get_loss)
    x_T, step_noise = jax_sample_draws(k_act, 32, 2, 5)
    noise, ts = jax_loss_draws(k_loss, 32, 2, 5)
    with torch.no_grad():
        got_a = m.get_actions(_t(state), _t(pc), x_T, step_noise)
        got_l = m.get_loss(_t(state), _t(pc), _t(action), noise, ts)
        assert torch.equal(m(_t(state), _t(pc), x_T, step_noise), got_a)
    _close(got_a, want_a)
    np.testing.assert_allclose(float(got_l), float(want_l), **TOL)


# ---------------------------------------------------------- init, registry


def test_initializers_match_flax_by_distribution():
    """lecun_normal (truncated at ±2σ, σ = √(1/fan_in)/0.8796) for the convs
    and the attention kernels, zero biases, unit norm scales, the log-std at
    init_log_std; the same moments as flax's own draws."""
    g = torch.Generator().manual_seed(0)
    conv = visual.Conv2d(64, 128, 3, gen=g)
    attn = visual.Attention(384, 6, gen=g)
    flax_conv = linen.Conv(128, (3, 3)).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 64)))["params"]["kernel"]
    for w, fan_in, want in ((conv.weight, 576, np.asarray(flax_conv)), (attn.query.weight, 384, None),
                            (attn.out.weight, 384, None)):
        w = w.detach().numpy()
        s = np.sqrt(1.0 / fan_in)
        assert abs(w.std() / s - 1.0) < 0.02 and np.abs(w).max() <= 2 * s / 0.87962566103423978 + 1e-7
        if want is not None:
            assert abs(w.std() / want.std() - 1.0) < 0.02 and abs(np.abs(w).max() / np.abs(want).max() - 1) < 0.02
    assert float(attn.query.bias.abs().max()) == 0.0 and float(attn.out.bias.abs().max()) == 0.0
    gn = visual.GroupNorm(128)
    assert gn.groups == 32 and gn.eps == 1e-6 and float(gn.scale.min()) == 1.0 == float(gn.scale.max())
    assert visual.GroupNorm(16).groups == 16
    pol = visual.DiagGaussianMLPVPolicy(6, 3, None, 32, 32, init_log_std=-1.0, encoder_type=None)
    assert pol.logstd.tolist() == [-1.0] * 3


def test_registry_holds_every_jax_name():
    assert set(MODEL_REGISTRY) == set(J_REGISTRY) and len(MODEL_REGISTRY) == 22
