"""Tests of the port that need a CUDA card (marker ``gpu``); they skip without one.

This file imports nothing of JAX, so it also runs where JAX is not
installed. On the machine with the card:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(``--noconftest``: tests/conftest.py sets up the JAX CPU mesh.)
"""

import pytest
import torch

from pql_tpu_torch.algos.pql import PQL
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.ops import kernels
from pql_tpu_torch.ops.kernels import c51_td_target, c51_td_target_plain

ATOL = 1e-5  # kernel vs plain version, fp32: i·Δz + v_min vs linspace support, FMA contraction


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, A, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    p1 = torch.softmax(2.0 * torch.randn(B, A, generator=gen, device=dev), -1)
    p2 = torch.softmax(2.0 * torch.randn(B, A, generator=gen, device=dev), -1)
    reward = 3.0 * torch.randn(B, 1, generator=gen, device=dev)
    done = (torch.rand(B, 1, generator=gen, device=dev) < 0.3).float()
    return p1, p2, reward, done


@pytest.mark.gpu
@pytest.mark.parametrize("B", [8192, 300, 1])
def test_c51_kernel_matches_plain(cuda, B):
    p1, p2, rew, done = _inputs(B, 51, cuda, B)
    n0 = kernels.LAUNCHES["c51_td_target"]
    for q in (p2, None):
        got = c51_td_target(p1, q, rew, done, 0.99 ** 3, -10.0, 10.0)
        want = c51_td_target_plain(p1, q, rew, done, 0.99 ** 3, -10.0, 10.0)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= ATOL
    assert kernels.LAUNCHES["c51_td_target"] == n0 + 2
    mass = c51_td_target(p1, None, rew, done, 0.99, -10.0, 10.0).sum(-1)
    assert float((mass - 1.0).abs().max()) <= ATOL


@pytest.mark.gpu
def test_c51_kernel_rejects_strided_input(cuda):
    p1, p2, _, done = _inputs(64, 51, cuda, 0)
    strided = torch.zeros(64, 2, device=cuda)[:, :1]  # a column view, as the replay's reward field
    with pytest.raises(ValueError):
        c51_td_target(p1, p2, strided, done, 0.99, -10.0, 10.0)


@pytest.mark.gpu
def test_pql_d_iteration_on_card_matches_cpu(cuda):
    """One warm-up and two iterations at a small size on the card and the
    CPU, same initial state and draws. The card's path goes through the
    kernel (8 launches per iteration). fp32 sums run in other orders: the
    critic's parameter change must match to 1% of its norm, losses to 1e-3."""
    cfg = make_config("pql_d", num_envs=64, algo__batch_size=256, algo__memory_size=4096, algo__warm_up=8)
    agents = {d: PQL(cfg, device=d) for d in ("cpu", "cuda")}
    states = {d: a.init() for d, a in agents.items()}
    theta0 = torch.cat([p.detach().flatten() for p in states["cpu"].critic.parameters()])
    gen = torch.Generator().manual_seed(1)
    losses = {d: [] for d in agents}
    n0 = kernels.LAUNCHES["c51_td_target"]
    for it in range(3):
        draws = agents["cpu"].draw_iteration(gen, random=(it == 0))
        for d, agent in agents.items():
            step = agent.warmup if it == 0 else agent.train_iter
            states[d], m = step(states[d], {k: v.to(d) for k, v in draws.items()})
            losses[d].append(float(m["train/critic_loss"]))
    assert kernels.LAUNCHES["c51_td_target"] == n0 + 16
    flat = {d: torch.cat([p.detach().cpu().flatten() for p in s.critic.parameters()]) for d, s in states.items()}
    assert float((flat["cuda"] - flat["cpu"]).norm() / (flat["cpu"] - theta0).norm()) <= 1e-2
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-3 * max(abs(b), 1e-6)
