"""The FLOP counts of ``flops/`` against torch's own count of the plain
references' matmuls and convolutions (``FlopCounterMode``) on one iteration
at small shapes."""

import copy
import importlib.util
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import harness
from conftest import BENCH
from reference import plain, pql_plain


def load(kind, name):
    spec = importlib.util.spec_from_file_location(f"t_{kind}_" + name.replace("-", "_"),
                                                  os.path.join(BENCH, kind, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def uniform(shapes: dict, gen) -> dict:
    return {k: (torch.rand(s, generator=gen) - 0.5).requires_grad_(False) for k, s in shapes.items()}


def mlp_shapes(prefix, dims):
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"{prefix}.layers.{i}.weight"], out[f"{prefix}.layers.{i}.bias"] = (b, a), (b,)
    return out


def test_pql_iteration_flops():
    config = copy.deepcopy(harness.load_json("configs", "pql-allegrohand"))
    config.update(hidden=[8, 6], obs_dim=5, action_dim=3)
    traffic = {"args": {"num_envs": 4, "algo.horizon_len": 1, "algo.critic_sample_ratio": 2,
                        "algo.critic_actor_ratio": 2}}
    config["args"]["algo.batch_size"] = 16
    gen = torch.Generator().manual_seed(0)
    w = uniform({**mlp_shapes("actor.net", [5, 8, 6, 3]), **mlp_shapes("critic.net_q1", [8, 8, 6, 1]),
                 **mlp_shapes("critic.net_q2", [8, 8, 6, 1])}, gen)
    actor, critic = plain.sub(w, "actor"), plain.sub(w, "critic")
    for p in (*actor.values(), *critic.values()):
        p.requires_grad_(True)
    fa = lambda o: pql_plain.actor_forward({"actor." + k: v for k, v in actor.items()}, o)  # noqa: E731
    o, a, no = torch.randn(16, 5, generator=gen), torch.rand(16, 3, generator=gen), torch.randn(16, 5, generator=gen)

    def iteration():
        with torch.no_grad():
            fa(torch.randn(4, 5, generator=gen))
        for _ in range(2):  # critic updates
            with torch.no_grad():
                y = plain.q_min(critic, no, fa(no))
            q1, q2 = plain.double_q(critic, o, a)
            plain.grads_of(((q1 - y) ** 2).mean() + ((q2 - y) ** 2).mean(), critic)
        loss = -plain.q_min({k: v.detach() for k, v in critic.items()}, o, fa(o)).mean()  # one actor update
        plain.grads_of(loss, actor)

    assert load("flops", "pql-allegrohand").flops_per_iter(config, traffic) == counted(iteration)


def test_ddpgv_iteration_flops():
    from pql_tpu_torch.models.visual import DiagGaussianMLPVPolicy

    config = copy.deepcopy(harness.load_json("configs", "ddpgv-reachervision"))
    config["task_constants"]["img_shape"] = [1, 2, 16, 16, 3]
    config["critic_hidden"] = [8, 6]
    config["args"]["algo.batch_size"] = 3
    traffic = {"args": {"num_envs": 2, "algo.horizon_len": 1, "algo.update_times": 1}}
    gen = torch.Generator().manual_seed(0)
    policy = DiagGaussianMLPVPolicy(6, 2, img_shape=(1, 2, 16, 16, 3), feature_dim=256, hidden_dim=256, pc_dim=3)
    shapes = {f"actor.{k}": tuple(v.shape) for k, v in policy.named_parameters()}
    shapes.update({**mlp_shapes("critic.net_q1", [12, 8, 6, 1]), **mlp_shapes("critic.net_q2", [12, 8, 6, 1])})
    w = uniform(shapes, gen)
    actor, critic = plain.sub(w, "actor"), plain.sub(w, "critic")
    for p in (*actor.values(), *critic.values()):
        p.requires_grad_(True)
    views = lambda b: (torch.rand(b, 1, 2, 16, 16, 3, generator=gen), torch.randn(b, 6, generator=gen),  # noqa: E731
                       torch.randn(b, 40, 3, generator=gen))
    vision = load("reference", "ddpgv-reachervision")

    def iteration():
        with torch.no_grad():
            vision.act(actor, *views(2))
        obs, act, nxt = torch.randn(3, 10, generator=gen), torch.rand(3, 2, generator=gen), views(3)
        with torch.no_grad():
            y = plain.q_min(critic, obs, vision.act(actor, *nxt))
        q1, q2 = plain.double_q(critic, obs, act)
        plain.grads_of(((q1 - y) ** 2).mean() + ((q2 - y) ** 2).mean(), critic)
        loss = -plain.q_min({k: v.detach() for k, v in critic.items()}, obs, vision.act(actor, *views(3))).mean()
        plain.grads_of(loss, actor)

    want = counted(iteration)
    assert load("flops", "ddpgv-reachervision").flops_per_iter(config, traffic) == pytest.approx(want, rel=0, abs=0)
