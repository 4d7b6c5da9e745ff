"""The port's equivariant networks against the JAX package, on the CPU.

- the rep helpers, and ``FiniteGroup``'s orders, words, multiplication
  table and element lists, equal to the JAX ones (C2, C4, D4);
- every layer and wrapper on the same inputs with the JAX init's raw weights
  (converted by ``utils/convert.py``), within rtol 1e-5 / atol 1e-6: the C2
  layers, ``GroupEquivariantLinear`` and ``GroupEMLP`` on C4 (a rotation,
  not symmetric: a transposed projection shows) and D4 (rotation and
  reflection), with equivariant and invariant heads; the Gaussian policy's
  sample, log-prob and entropy;
- exact equivariance and invariance of the port's networks on the CPU
  (|f(x·G_in) − f(x)·G_out| ≤ 1e-5·(1 + |f|));
- three AdamW steps (with the global-norm clip) of the raw parameters
  against optax's ``clip_by_global_norm`` + ``adamw``: the raw weight leaves
  the equivariant subspace, and only the projection in ``forward`` removes
  it, as in the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pql_tpu.models import emlp as jemlp
from pql_tpu_torch.algos import base
from pql_tpu_torch.models import MODEL_REGISTRY, emlp
from pql_tpu_torch.utils.convert import params_from_jax

RTOL, ATOL = 1e-5, 1e-6
SIGNS_IN = (1.0, -1.0, 1.0, -1.0, -1.0, 1.0)
SIGNS_OUT = (-1.0, 1.0)


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def _groups():
    rot = emlp.cyclic_rotation2d(4)
    refl = emlp.sign_rep([1.0, -1.0])
    return {"C2": (dict(obs=[emlp.sign_rep([-1.0, 1.0])], act=[emlp.sign_rep([-1.0, 1.0])])),
            "C4": dict(obs=[rot], act=[rot]),
            "D4": dict(obs=[rot, refl], act=[rot, refl])}


# ------------------------------------------------------------- rep helpers


@pytest.mark.parametrize("name,args", [
    ("sign_rep", (SIGNS_IN,)),
    ("perm_sign_rep", ((2, 0, 1), (1.0, -1.0, 1.0))),
    ("perm_sign_rep", ((1, 0),)),
    ("regular_rep", (3,)),
    ("cyclic_rotation2d", (4,)),
    ("cyclic_rotation2d", (6,)),
    ("concat_reps", (jemlp.sign_rep((1.0, -1.0)), jemlp.regular_rep(2))),
])
def test_rep_helpers_match_jax(name, args):
    assert getattr(emlp, name)(*args) == getattr(jemlp, name)(*args)


def test_check_involution_matches_jax():
    for g in (emlp.sign_rep(SIGNS_IN), emlp.regular_rep(5), emlp.cyclic_rotation2d(4),
              emlp.perm_sign_rep((1, 0), (1.0, -1.0)), emlp.concat_reps(emlp.sign_rep(SIGNS_IN), emlp.regular_rep(2))):
        assert emlp.check_involution(g) == jemlp.check_involution(g)
    assert emlp.check_involution(emlp.regular_rep(5)) and not emlp.check_involution(emlp.cyclic_rotation2d(4))


@pytest.mark.parametrize("group", ["C2", "C4", "D4"])
def test_finite_group_matches_jax(group):
    spaces = _groups()[group]
    got, want = emlp.FiniteGroup(**spaces), jemlp.FiniteGroup(**spaces)
    assert got.order == want.order == {"C2": 2, "C4": 4, "D4": 8}[group]
    assert got.words == want.words and got.mul == want.mul
    for space in spaces:
        np.testing.assert_array_equal(_np(got.elements(space)), _np(want.elements(space)))
    np.testing.assert_array_equal(_np(got.regular_elements(2)), _np(want.regular_elements(2)))
    regs = _np(got.regular_elements(1))
    for i in range(got.order):  # a permutation homomorphism
        for j in range(got.order):
            np.testing.assert_array_equal(regs[i] @ regs[j], regs[got.mul[i][j]])


def test_finite_group_refusals():
    with pytest.raises(ValueError, match="at least one space"):
        emlp.FiniteGroup()
    with pytest.raises(ValueError, match="max_order"):
        emlp.FiniteGroup(max_order=3, obs=[emlp.cyclic_rotation2d(4)])


# ------------------------------------------------------- layers and models


def _c2_cases():
    """(name, JAX module, port module, input dims, call) for every C2 layer
    and wrapper, small widths."""
    g_in, g_out = emlp.sign_rep(SIGNS_IN), emlp.sign_rep(SIGNS_OUT)
    g_perm = emlp.perm_sign_rep((1, 0, 3, 2, 4, 5), (1.0, 1.0, -1.0, -1.0, -1.0, 1.0))
    return {
        "EquivariantLinear": (jemlp.EquivariantLinear(g_in, emlp.regular_rep(3)),
                              emlp.EquivariantLinear(g_in, emlp.regular_rep(3))),
        "EMLP-equivariant": (jemlp.EMLP(g_perm, g_out, hidden_units=16), emlp.EMLP(g_perm, g_out, 16)),
        "EMLP-invariant": (jemlp.EMLP(g_in, 3, hidden_units=16), emlp.EMLP(g_in, 3, 16)),
        "EMLP-3-layers": (jemlp.EMLP(g_in, g_out, hidden_units=10, num_layers=3), emlp.EMLP(g_in, g_out, 10, 3)),
        "EquivariantMLPNet": (jemlp.EquivariantMLPNet(g_in, g_out, 16), emlp.EquivariantMLPNet(g_in, g_out, 16)),
        "TanhEquivariantMLPPolicy": (jemlp.TanhEquivariantMLPPolicy(g_in, g_out, 16),
                                     emlp.TanhEquivariantMLPPolicy(g_in, g_out, 16)),
        "DiagGaussianEquivariantMLPPolicy": (jemlp.DiagGaussianEquivariantMLPPolicy(g_in, g_out, 16),
                                             emlp.DiagGaussianEquivariantMLPPolicy(g_in, g_out, 16)),
        "MLPCriticEquivariant": (jemlp.MLPCriticEquivariant(g_in, 16), emlp.MLPCriticEquivariant(g_in, 16)),
        "DoubleQEquivariant": (jemlp.DoubleQEquivariant(g_in, g_out, 16), emlp.DoubleQEquivariant(g_in, g_out, 16)),
        "DoubleQEquivariant-perm": (jemlp.DoubleQEquivariant(g_perm, g_out, 16),
                                    emlp.DoubleQEquivariant(g_perm, g_out, 16)),
    }


def _inputs(module, n=7, seed=0):
    rng = np.random.default_rng(seed)
    if isinstance(module, emlp.DoubleQEquivariant):
        d_obs = 6
        return (rng.normal(size=(n, d_obs)).astype(np.float32), rng.normal(size=(n, 2)).astype(np.float32))
    d = module.g_in.shape[-1] if isinstance(module, emlp.GroupEquivariantLinear) else _in_dim(module)
    return (rng.normal(size=(n, d)).astype(np.float32),)


def _in_dim(module):
    first = next(m for m in module.modules() if isinstance(m, emlp.GroupEquivariantLinear))
    return first.g_in.shape[-1]


def _load(jmod, port, inputs, seed=1):
    """JAX init (raw, unprojected weights), loaded into the port module."""
    params = jmod.init(jax.random.PRNGKey(seed), *[jnp.asarray(x[:1]) for x in inputs])
    port.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return params


def _close(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(_c2_cases()))
def test_c2_layer_matches_jax(case):
    jmod, port = _c2_cases()[case]
    inputs = _inputs(port)
    params = _load(jmod, port, inputs)
    want = jmod.apply(params, *[jnp.asarray(x) for x in inputs])
    _close(port(*[torch.from_numpy(x) for x in inputs]), want)


def test_gaussian_policy_sample_and_logprob_match_jax():
    g_in, g_out = emlp.sign_rep(SIGNS_IN), emlp.sign_rep(SIGNS_OUT)
    jmod, port = jemlp.DiagGaussianEquivariantMLPPolicy(g_in, g_out, 16), emlp.DiagGaussianEquivariantMLPPolicy(
        g_in, g_out, 16)
    (obs,) = _inputs(port)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(1), jnp.asarray(obs[:1])))
    params["params"]["logstd"] = np.array([-0.3, 0.2], np.float32)  # off its zero init
    port.load_state_dict(params_from_jax(params))
    key = jax.random.PRNGKey(7)
    a, lp, ent = jmod.apply(params, jnp.asarray(obs), key, method=type(jmod).sample)
    normal = torch.from_numpy(np.array(jax.random.normal(key, (obs.shape[0], 2), jnp.float32)))
    _close(port.sample(torch.from_numpy(obs), normal), (a, lp, ent))
    _close(port.logprob_entropy(torch.from_numpy(obs), torch.from_numpy(np.asarray(a))),
           jmod.apply(params, jnp.asarray(obs), a, method=type(jmod).logprob_entropy))
    assert port.act_dim == 2


def _group_cases(group):
    grp = emlp.FiniteGroup(**_groups()[group])
    obs, act = grp.elements("obs"), grp.elements("act")
    reg = grp.regular_elements(2)
    return {
        "GroupEquivariantLinear-in": (jemlp.GroupEquivariantLinear(obs, reg), emlp.GroupEquivariantLinear(obs, reg)),
        "GroupEquivariantLinear-out": (jemlp.GroupEquivariantLinear(reg, act), emlp.GroupEquivariantLinear(reg, act)),
        "GroupEMLP-equivariant": (jemlp.GroupEMLP(obs, act, grp.mul, hidden_units=16, num_layers=3),
                                  emlp.GroupEMLP(obs, act, grp.mul, 16, 3)),
        "GroupEMLP-invariant": (jemlp.GroupEMLP(obs, 3, grp.mul, hidden_units=16, num_layers=3),
                                emlp.GroupEMLP(obs, 3, grp.mul, 16, 3)),
    }


@pytest.mark.parametrize("group", ["C4", "D4"])
@pytest.mark.parametrize("case", ["GroupEquivariantLinear-in", "GroupEquivariantLinear-out", "GroupEMLP-equivariant",
                                  "GroupEMLP-invariant"])
def test_group_layer_matches_jax(group, case):
    jmod, port = _group_cases(group)[case]
    inputs = _inputs(port)
    params = _load(jmod, port, inputs)
    want = jmod.apply(params, *[jnp.asarray(x) for x in inputs])
    _close(port(*[torch.from_numpy(x) for x in inputs]), want)


# ------------------------------------------------------------ equivariance


def _assert_equivariant(f, x, g_in, g_out):
    with torch.no_grad():
        y, y_g = f(x), f(x @ g_in)
    want = y if g_out is None else y @ g_out
    err = float((y_g - want).abs().max())
    assert err <= 1e-5 * (1.0 + float(y.abs().max())), err


@pytest.mark.parametrize("case", sorted(_c2_cases()))
def test_c2_layers_are_exactly_equivariant(case):
    _, port = _c2_cases()[case]
    torch.manual_seed(0)
    with torch.no_grad():  # raw weights far off the subspace
        for p in port.parameters():
            p.normal_()
    inputs = [torch.from_numpy(x) for x in _inputs(port, n=32)]
    if isinstance(port, emlp.DoubleQEquivariant):
        g_o, g_a = port.net_q1.layers[0].g_in[0][:6, :6], port.net_q1.layers[0].g_in[0][6:, 6:]
        q, q_g = port(*inputs), port(inputs[0] @ g_o, inputs[1] @ g_a)
        for a, b in zip(q, q_g):
            assert float((a - b).abs().max()) <= 1e-5 * (1.0 + float(a.abs().max()))
        return
    first = next(m for m in port.modules() if isinstance(m, emlp.GroupEquivariantLinear))
    last = [m for m in port.modules() if isinstance(m, emlp.GroupEquivariantLinear)][-1]
    invariant = any(isinstance(m, emlp.EMLP) and m.head is not None for m in port.modules())
    f = (lambda x: port(x)[0]) if isinstance(port, emlp.DiagGaussianEquivariantMLPPolicy) else port
    _assert_equivariant(f, inputs[0], first.g_in[0], None if invariant else last.g_out[0])


@pytest.mark.parametrize("group", ["C4", "D4"])
def test_group_emlp_is_exactly_equivariant(group):
    grp = emlp.FiniteGroup(**_groups()[group])
    obs = grp.elements("obs")
    eq, inv = emlp.GroupEMLP(obs, grp.elements("act"), grp.mul, 16, 3), emlp.GroupEMLP(obs, 3, grp.mul, 16, 3)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(9, 2)).astype(np.float32))
    for e in obs:
        g = torch.tensor(_np(e))
        _assert_equivariant(eq, x, g, g)
        _assert_equivariant(inv, x, g, None)


def test_group_buffers_follow_the_module_and_stay_out_of_the_state_dict():
    m = emlp.MLPCriticEquivariant(emlp.sign_rep(SIGNS_IN), 16).to(torch.float64)
    assert all("g_in" not in k and "g_out" not in k for k in m.state_dict())
    assert m.net.layers[0].g_in.dtype == torch.float64
    assert set(m.state_dict()) == {f"net.layers.{i}.{p}" for i in range(4) for p in ("weight", "bias")} | {
        "net.head.weight", "net.head.bias"}


def test_registry_holds_the_equivariant_names():
    assert {"EMLP", "EquivariantMLPNet", "TanhEquivariantMLPPolicy", "DiagGaussianEquivariantMLPPolicy",
            "MLPCriticEquivariant", "DoubleQEquivariant"} <= set(MODEL_REGISTRY)
    assert "EquivariantDiffusionPolicy" in MODEL_REGISTRY  # the diffusion tier (tests/test_torch_ddpm.py)
    assert "DiffusionPolicy" in MODEL_REGISTRY  # the vision tier's (tests/test_torch_visual_models.py)


# ------------------------------------------------------ the raw-weight step


def test_adamw_steps_on_the_raw_weight_match_optax():
    """Three steps of clip_by_global_norm(0.5) + adamw(lr 1e-2, wd 0.01) on a
    Gaussian-policy loss: the raw parameters (which leave the equivariant
    subspace: W ≠ its projection) and the outputs match the JAX package."""
    g_in, g_out = emlp.sign_rep(SIGNS_IN), emlp.sign_rep(SIGNS_OUT)
    jmod, port = jemlp.DiagGaussianEquivariantMLPPolicy(g_in, g_out, 16), emlp.DiagGaussianEquivariantMLPPolicy(
        g_in, g_out, 16)
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(32, 6)).astype(np.float32)
    act = rng.normal(size=(32, 2)).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(obs[:1]))
    port.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))

    def jloss(p):
        lp, ent = jmod.apply(p, jnp.asarray(obs), jnp.asarray(act), method=type(jmod).logprob_entropy)
        return -jnp.mean(lp) - 0.01 * jnp.mean(ent)

    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01))
    opt_state = tx.init(params)
    opt = base.build_optimizer(port, 1e-2)
    params_list = list(port.parameters())
    for _ in range(3):
        loss, g = jax.value_and_grad(jloss)(params)
        upd, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, upd)
        lp, ent = port.logprob_entropy(torch.from_numpy(obs), torch.from_numpy(act))
        got = base.descend(opt, params_list, -lp.mean() - 0.01 * ent.mean(), 0.5)
        np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
    layer = port.net.layers[1]
    w_eq, _ = layer.projected()
    assert float((layer.weight - w_eq).abs().max()) > 1e-3  # the raw weight left the subspace
    with torch.no_grad():
        _close(port(torch.from_numpy(obs)), jmod.apply(params, jnp.asarray(obs)))


@pytest.mark.parametrize("name", ["DiagGaussianEquivariantMLPPolicy", "MLPCriticEquivariant"])
def test_default_width_models_match_jax(name):
    """The agents' width: EMLP's default, 256 hidden in 5 linear maps (128
    regular pairs), on BimanualReacher's arm reps."""
    from pql_tpu_torch.envs.bimanual import BimanualReacher

    eq = BimanualReacher.equivariance
    g_obs, g_act = emlp.sign_rep(eq.obs_signs[0]), emlp.sign_rep(eq.act_signs)
    kwargs = dict(gen_in=g_obs, gen_out=g_act) if name.startswith("Diag") else dict(gen_in=g_obs)
    jmod, port = getattr(jemlp, name)(**kwargs), getattr(emlp, name)(**kwargs)
    widths = [m.weight.shape for m in port.modules() if isinstance(m, emlp.Linear)]
    assert len(widths) == 5 and widths[1] == (256, 256)
    inputs = (np.random.default_rng(0).normal(size=(5, 12)).astype(np.float32),)
    params = _load(jmod, port, inputs)
    _close(port(*[torch.from_numpy(x) for x in inputs]), jmod.apply(params, *[jnp.asarray(x) for x in inputs]))
