"""Plain PyTorch pieces of the references: networks as functions of a dict
of weights, the optimizer, the running moments, the exploration noise and
the measures that compare two runs. Nothing here imports the program.

Weights are addressed by the names the benchmark drew them under
(``weights.fill``): ``<network>.<path>``, e.g. ``actor.net.layers.0.weight``.
"""

from __future__ import annotations

import contextlib
import math
import statistics

import torch
import torch.nn.functional as F

# --------------------------------------------------------------- precision


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """fp32 matmuls and convolutions (TF32 off), or TF32 for the control."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = saved


# ---------------------------------------------------------------- networks


def sub(w: dict, prefix: str) -> dict:
    """The leaves under ``prefix.`` with the prefix cut."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in w.items() if k.startswith(prefix + ".")}


def linear(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, w[f"{name}.weight"], w[f"{name}.bias"])


def mlp(w: dict, x: torch.Tensor, act=F.elu) -> torch.Tensor:
    """``layers.0 .. layers.n``: act after every layer but the last."""
    n = len([k for k in w if k.startswith("layers.") and k.endswith(".weight")])
    for i in range(n):
        x = linear(w, f"layers.{i}", x)
        if i < n - 1:
            x = act(x)
    return x


def double_q(w: dict, obs: torch.Tensor, act: torch.Tensor):
    """Twin Q heads on concat(obs, act): ``net_q1``, ``net_q2`` ELU MLPs."""
    x = torch.cat([obs, act], -1)
    return mlp(sub(w, "net_q1"), x), mlp(sub(w, "net_q2"), x)


def q_min(w: dict, obs, act):
    q1, q2 = double_q(w, obs, act)
    return torch.minimum(q1, q2)


def layer_norm(x, scale, bias, eps=1e-6):
    """flax LayerNorm: biased variance E[x²] − E[x]² (clamped at 0), eps 1e-6."""
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + eps) * scale) + bias


# --------------------------------------------------------------- optimizer


class AdamW:
    """optax ``clip_by_global_norm(max_norm)`` then ``adamw(lr, 0.9, 0.999,
    1e-8, weight_decay=0.01)`` over every leaf, written out: decoupled
    decay p ← p·(1 − lr·wd), then p ← p − lr·m̂ / (√v̂ + eps)."""

    def __init__(self, params: dict, lr: float, max_norm: float | None, b1=0.9, b2=0.999, eps=1e-8, wd=0.01):
        self.lr, self.max_norm, self.b1, self.b2, self.eps, self.wd = lr, max_norm, b1, b2, eps, wd
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0
        self.first = None  # the clipped gradient of the first step

    def clip(self, grads: dict) -> dict:
        if self.max_norm is None:
            return grads
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        return {k: g * scale for k, g in grads.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict, apply: bool = True) -> None:
        """One step; with ``apply`` False the state moves and the parameters
        do not (a step that leaves its parameters as they were)."""
        grads = self.clip(grads)
        self.t += 1
        if self.first is None:
            self.first = {k: g.clone() for k, g in grads.items()}
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            if apply:
                p.mul_(1.0 - self.lr * self.wd)
                p.addcdiv_(self.m[k], self.v[k].sqrt() / math.sqrt(bc2) + self.eps, value=-self.lr / bc1)


def grads_of(loss: torch.Tensor, params: dict) -> dict:
    keys = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
    return {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(keys, gs)}


@torch.no_grad()
def polyak(target: dict, online: dict, tau: float) -> None:
    for k, t in target.items():
        t.mul_(1.0 - tau).add_(online[k], alpha=tau)


# ------------------------------------------------------------ observations


class RunningMoments:
    """Chan et al.'s running mean and variance of a batch stream: batch
    variance with n − 1, count from 1e-4; normalize by √(var + 1e-4)."""

    def __init__(self, dim: int, device, eps: float = 1e-4):
        self.eps = eps
        self.mean = torch.zeros(dim, device=device)
        self.var = torch.ones(dim, device=device)
        self.count = torch.tensor(eps, device=device)

    def update(self, x: torch.Tensor) -> None:
        n = x.shape[0]
        bm = x.mean(0)
        bv = ((x - bm) ** 2).sum(0) / max(n - 1, 1)
        delta = bm - self.mean
        tot = self.count + n
        m2 = self.var * self.count + bv * n + delta.square() * self.count * n / tot
        self.mean = self.mean + delta * n / tot
        self.var = m2 / tot
        self.count = tot

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / torch.sqrt(self.var + self.eps)

    def normalize_clip(self, x: torch.Tensor, c: float = 5.0) -> torch.Tensor:
        return torch.clamp(self.normalize(x), -c, c)


def mixed_noise_action(mean_action, normal, std_min: float, std_max: float):
    """clamp(a + N·std_e, ±1), std_e = linspace(std_min, std_max, E)[e]."""
    e = mean_action.shape[0]
    std = std_min + (std_max - std_min) / (e - 1) * torch.arange(e, dtype=torch.float32, device=normal.device)
    return torch.clamp(mean_action + normal * std[:, None], -1.0, 1.0)


def smoothed_target_action(mean_action, normal, std: float, bound: float):
    """clamp(a + clamp(std·N, ±bound), ±1): target-policy smoothing."""
    return torch.clamp(mean_action + torch.clamp(normal * std, -bound, bound), -1.0, 1.0)


# ---------------------------------------------------------------- measures


def median_norm(leaves: dict) -> float:
    return statistics.median(float(v.double().norm()) for v in leaves.values())


def kept_leaves(ref_grad: dict) -> list[str]:
    """Leaves whose reference gradient is not nought to rounding: a norm of
    at least a thousandth of the median leaf's. The others (a bias that a
    softmax or a min cancels, an unused ``logstd``) move by round-off and
    weight decay alone, and are left out of the gradient and change gaps."""
    med = median_norm(ref_grad)
    return [k for k, v in ref_grad.items() if float(v.double().norm()) >= 1e-3 * med]


def leaf_gaps(prog: dict, ref: dict, keys: list[str]) -> list[float]:
    """Per leaf |‖prog‖ − ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖): the
    gap of the norms, not the norm of the difference."""
    norms = {k: float(ref[k].double().norm()) for k in keys}
    med = statistics.median(norms.values())
    return [abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], med) for k in keys]


def worst_leaves(prog: dict, ref: dict, keys: list[str], grad: dict, n: int = 3) -> list:
    """The ``n`` leaves of the largest ``leaf_gaps``: [name, gap,
    ‖ref‖, the reference gradient's norm over the median leaf's]."""
    norms = {k: float(ref[k].double().norm()) for k in keys}
    med = statistics.median(norms.values())
    gmed = median_norm(grad)
    rows = [[k, abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], med), norms[k],
             float(grad[k.replace("target.", "critic.", 1)].double().norm()) / gmed] for k in keys]
    return sorted(rows, key=lambda r: -r[1])[:n]


def learner_numbers(side: dict, ref: dict, weights: dict, change_of: str = "worst",
                    details: dict | None = None, median_nets: tuple[str, ...] = ()) -> dict:
    """A side (the program's record, or the reference in its place) against
    the reference, each a dict of ``losses`` [(critic, actor) per iteration],
    ``g1`` (each optimizer's first gradient, clipped, by leaf) and ``params``
    (after the followed iterations; ``target.*`` the critic's target):

    - ``loss_gap``: the worst relative gap of the losses;
    - ``grad_gap``: the worst leaf's gap of the first gradients' norms;
    - ``change_gap``: the parameters' change from the benchmark's weights,
      the worst leaf's gap of the norms, or the median leaf's; the leaves
      of the networks in ``median_nets`` by their median leaf's, the larger
      of that and the others' worst.

    Leaves whose first reference gradient is nought to rounding
    (``kept_leaves``) are left out of both leaf gaps."""
    keep = kept_leaves(ref["g1"])
    start = {**weights, **{"target." + k[len("critic."):]: v for k, v in weights.items() if k.startswith("critic.")}}
    change = lambda p: {k: p[k].double().cpu() - start[k].double().cpu() for k in p}  # noqa: E731
    keep_change = [k for k in ref["params"] if k.replace("target.", "critic.", 1) in keep]
    pairs = lambda ls: [x for pair in ls for x in pair]  # noqa: E731
    changes = leaf_gaps(change(side["params"]), change(ref["params"]), keep_change)
    if median_nets:
        by_median = [g for k, g in zip(keep_change, changes) if k.split(".", 1)[0] in median_nets]
        change_gap = max([statistics.median(by_median)] + [g for k, g in zip(keep_change, changes)
                                                           if k.split(".", 1)[0] not in median_nets])
    else:
        change_gap = max(changes) if change_of == "worst" else statistics.median(changes)
    if details is not None:
        details["change_worst"] = worst_leaves(change(side["params"]), change(ref["params"]), keep_change, ref["g1"])
        details["grad_worst"] = worst_leaves({k: v.cpu() for k, v in side["g1"].items()},
                                             {k: v.cpu() for k, v in ref["g1"].items()}, keep, ref["g1"])
        details["losses"] = [pairs(side["losses"]), pairs(ref["losses"])]
        details["change_median"] = statistics.median(changes)
        details["change_max"] = max(changes)
    return {
        "loss_gap": loss_gap(pairs(side["losses"]), pairs(ref["losses"])),
        "grad_gap": max(leaf_gaps({k: v.cpu() for k, v in side["g1"].items()},
                                  {k: v.cpu() for k, v in ref["g1"].items()}, keep)),
        "change_gap": change_gap,
    }


def loss_gap(prog: list[float], ref: list[float], floor: float = 1e-2) -> float:
    """Worst |prog − ref| / max(|ref|, floor) over the losses compared (the
    floor keeps a loss that crosses zero from reading as a large gap)."""
    return max(abs(p - r) / max(abs(r), floor) for p, r in zip(prog, ref))
