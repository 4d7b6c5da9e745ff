"""Pretrained encoder weights in the port against the JAX package, on the CPU.

- an ``.npz`` written by the JAX package's ``save_params_npz`` (a PPOV-shaped
  ``DiagGaussianMLPVPolicy`` with the ResNet encoder on 32×32 frames) merges
  into fresh params of both packages with the same report and the same
  outputs; a partial file (the trunk under a suffix, an unknown key, a
  shape mismatch) gives both packages the same report;
- a torchvision-layout ``.pth`` (the real resnet18 key names and shapes,
  synthetic values, as tests/test_pretrained.py:104-160 builds it) through
  ``torchvision_resnet18_rename`` into ``ResEncoder``: same report, same
  weights, same outputs;
- the port's ``save_params_npz`` writes the JAX layout (it loads into the
  JAX policy with ``require_all``);
- ``flax_param_paths`` names exactly the JAX tree's leaves (the policy with
  and without a camera, DINO, ``DiffusionPolicy``);
- an orbax checkpoint directory is refused by name; ``algo.encoder_weights``
  reaches PPOV's actor, and a file that matches nothing fails.

Tolerance rtol 1e-4 / atol 1e-5 (tests/test_torch_ppo.py's ``TOL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pql_tpu.models import diffusion as j_diffusion
from pql_tpu.models import pretrained as j_pretrained
from pql_tpu.models import visual as j_visual
from pql_tpu_torch.algos import get_algo
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.models import diffusion, pretrained, visual
from pql_tpu_torch.utils.convert import flax_param_paths, params_from_jax
import test_pretrained
from test_torch_pql import TOL, _copy

IMG = (1, 2, 32, 32, 3)


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b=2):
    rng = np.random.default_rng(0)
    return (rng.uniform(0, 1, size=(b,) + IMG).astype(np.float32), rng.normal(size=(b, 6)).astype(np.float32),
            rng.normal(size=(b, 40, 3)).astype(np.float32))


def _policies(seed):
    """A JAX PPOV-shaped policy's params from ``seed`` and a fresh port policy."""
    jm = j_visual.DiagGaussianMLPVPolicy(act_dim=2, num_cams=1, feature_dim=256, hidden_dim=256)
    params = jm.init(jax.random.PRNGKey(seed), *map(jnp.asarray, _inputs()))
    m = visual.DiagGaussianMLPVPolicy(6, 2, IMG, 256, 256, gen=torch.Generator().manual_seed(seed))
    return jm, params, m


def _outputs_equal(jm, params, m):
    x = _inputs()
    want = jm.apply(params, *map(jnp.asarray, x))[0]
    with torch.no_grad():
        got = m(*map(torch.from_numpy, x))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _flat_keys(params) -> list[str]:
    return list(j_pretrained._flatten(params))


def test_jax_npz_merges_into_both_packages_alike(tmp_path):
    jm, source, _ = _policies(1)
    path = str(tmp_path / "policy.npz")
    j_pretrained.save_params_npz(path, source)
    _, fresh, m = _policies(2)
    jmerged, jreport = j_pretrained.merge_pretrained(fresh, path, require_all=True)
    report = pretrained.merge_pretrained(m, path, require_all=True)
    assert report == jreport and len(report["loaded"]) == len(_flat_keys(fresh))
    _outputs_equal(jm, jmerged, m)
    m.load_state_dict(params_from_jax(_copy(source)))  # the merged port policy is the source's
    _outputs_equal(jm, source, m)

    trunk = {k: v for k, v in np.load(path).items() if "ResNet18Trunk_0" in k}
    partial = {k.split("encoder/", 1)[1]: v for k, v in trunk.items()}  # suffixes of the params' paths
    partial["nowhere/kernel"] = np.zeros(3, np.float32)
    partial["pi_out/kernel"] = np.zeros((7, 7), np.float32)
    part = str(tmp_path / "partial.npz")
    np.savez(part, **partial)
    _, fresh, m = _policies(3)
    _, jreport = j_pretrained.merge_pretrained(fresh, part)
    report = pretrained.merge_pretrained(m, part)
    assert report == jreport
    assert report["unmatched"] == ["nowhere/kernel"] and report["shape_mismatch"] == [
        "pi_out/kernel: file (7, 7) vs param (256, 2)"]
    assert len(report["loaded"]) == len(trunk)


def test_torchvision_pth_into_res_encoder(tmp_path):
    sd = test_pretrained.TestTorchvisionResNet18Layout._torchvision_state_dict(torch)
    path = str(tmp_path / "resnet18.pth")
    torch.save(sd, path)
    jm = j_visual.ResEncoder(repr_dim=32, num_cams=1)
    obs = np.random.default_rng(4).uniform(0, 1, size=(1,) + IMG).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    m = visual.ResEncoder(IMG, repr_dim=32)
    m.load_state_dict(params_from_jax(_copy(params)))  # the same fc and norm
    jmerged, jreport = j_pretrained.merge_pretrained(params, path, rename=j_pretrained.torchvision_resnet18_rename,
                                                     require_all=True)
    report = pretrained.merge_pretrained(m, path, rename=pretrained.torchvision_resnet18_rename, require_all=True)
    assert report == jreport and len(report["loaded"]) == 30 and "fc/weight" in report["skipped"]
    np.testing.assert_array_equal(m.trunk.convs[0].weight.detach().numpy(), sd["conv1.weight"].numpy())
    want = params_from_jax(_copy(jmerged))
    for k, v in m.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    with torch.no_grad():
        got = m(torch.from_numpy(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(jmerged, jnp.asarray(obs))), **TOL)


def test_port_npz_is_the_jax_layout(tmp_path):
    jm, fresh, m = _policies(5)
    path = str(tmp_path / "port.npz")
    pretrained.save_params_npz(path, m)
    merged, report = j_pretrained.merge_pretrained(fresh, path, require_all=True)
    assert sorted(report["loaded"]) == sorted(_flat_keys(fresh))
    _outputs_equal(jm, merged, m)


def test_flax_param_paths_name_the_jax_leaves():
    x = _inputs()
    cases = []
    jm, params, m = _policies(6)
    cases.append((params, m))
    jm = j_visual.DiagGaussianMLPVPolicy(act_dim=2, encoder_type=None, feature_dim=32, hidden_dim=32)
    cases.append((jm.init(jax.random.PRNGKey(0), None, *map(jnp.asarray, x[1:])),
                  visual.DiagGaussianMLPVPolicy(6, 2, None, 32, 32, encoder_type=None)))
    obs = jnp.zeros((1, 2, 32, 32, 3))
    cases.append((j_visual.DINOEncoder(repr_dim=48, patch=8, depth=2).init(jax.random.PRNGKey(0), obs),
                  visual.DINOEncoder((2, 32, 32, 3), repr_dim=48, patch=8, depth=2)))
    jd = j_diffusion.DiffusionPolicy(action_dim=2)
    key = jax.random.PRNGKey(0)
    cases.append((jd.init(key, jnp.asarray(x[1]), jnp.asarray(x[2]), jnp.zeros((2, 2)), key,
                          method=j_diffusion.DiffusionPolicy.get_loss), diffusion.DiffusionPolicy(6, 2)))
    for params, module in cases:
        got = {"params/" + "/".join(p) for p in flax_param_paths(module).values()}
        assert got == set(_flat_keys(params)), type(module).__name__


def test_orbax_directory_is_refused(tmp_path):
    (tmp_path / "ckpt").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        pretrained.load_weight_file(str(tmp_path / "ckpt"))
    with pytest.raises(ValueError, match="Unsupported weight file"):
        pretrained.load_weight_file(str(tmp_path / "w.safetensors"))


def test_encoder_weights_reach_the_ppov_actor(tmp_path):
    size = dict(task="ReacherVision", num_envs=4, algo__horizon_len=4, algo__batch_size=8, algo__update_times=1)
    donor = get_algo("PPOV")(make_config("ppov", **size, seed=7), device="cpu").init().actor
    path = str(tmp_path / "trunk.npz")
    pretrained.save_params_npz(path, donor.encoder.trunk)  # keys under params/ResNet18Trunk's own leaves
    keys = list(np.load(path))
    np.savez(path, **{"ResNet18Trunk_0/" + k.split("/", 1)[1]: v for k, v in np.load(path).items()})
    actor = get_algo("PPOV")(make_config("ppov", **size, algo__encoder_weights=path), device="cpu").init().actor
    for (name, p), q in zip(actor.encoder.trunk.named_parameters(), donor.encoder.trunk.parameters()):
        assert torch.equal(p, q), name
    assert not torch.equal(actor.pi_1.weight, donor.pi_1.weight) and len(keys) == 30
    np.savez(path, **{"nowhere/kernel": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="matched no params"):
        get_algo("PPOV")(make_config("ppov", **size, algo__encoder_weights=path), device="cpu").init()
