"""The benchmark's own weights, drawn on the card from the run's seed.

Both sides get these: the program (copied into its networks in place, so
its optimizers keep their parameters) and the plain reference (the same
tensors by name). One uniform draw covers every drawn leaf of every
network, in a single call on a generator of the device:

- a weight of two or more dims: U(±1/√fan_in), fan_in = numel / out;
- the bias beside such a weight: U(±1/√fan_in) of that weight;
- a normalisation's ``scale`` 1 and its ``bias`` 0; ``logstd`` 0.
"""

from __future__ import annotations

import math

SEED_MIX = 0x9E3779B97F4A7C15  # keeps this stream apart from the program's own generator of the same seed


def leaf_rule(name: str, params: dict) -> tuple[str, float]:
    """('uniform', bound) or ('const', value) for one named leaf."""
    prefix, _, leaf = name.rpartition(".")
    sibling = lambda k: params.get(f"{prefix}.{k}" if prefix else k)  # noqa: E731
    if leaf == "logstd":
        return "const", 0.0
    if leaf == "scale" or (leaf == "bias" and sibling("scale") is not None):
        return "const", 1.0 if leaf == "scale" else 0.0
    weight = params[name] if leaf != "bias" else sibling("weight")
    if weight is None or weight.dim() < 2:
        raise ValueError(f"no init rule for the leaf {name!r}")
    return "uniform", 1.0 / math.sqrt(weight.numel() // weight.shape[0])


def generator(seed: int, device):
    """The benchmark's generator of a run: on the device, from the seed."""
    import torch

    return torch.Generator(device=device).manual_seed((int(seed) * SEED_MIX + 1) % (1 << 63))


def fill(networks: dict, gen) -> dict:
    """Draw every leaf of ``networks`` ({prefix: nn.Module}) from ``gen``, copy
    it into the module and return {f"{prefix}.{name}": tensor}, a copy of its own."""
    import torch

    named = {f"{p}.{n}": t for p, m in networks.items() for n, t in m.named_parameters()}
    rules = {}
    for p, m in networks.items():
        local = dict(m.named_parameters())
        rules.update({f"{p}.{n}": leaf_rule(n, local) for n in local})
    drawn = [k for k, (kind, _) in rules.items() if kind == "uniform"]
    flat = torch.rand(sum(named[k].numel() for k in drawn), generator=gen, device=gen.device, dtype=torch.float32)
    out, at = {}, 0
    for k, t in named.items():
        kind, v = rules[k]
        if kind == "uniform":
            n = t.numel()
            out[k] = (flat[at:at + n].view_as(t) * 2.0 - 1.0) * v
            at += n
        else:
            out[k] = torch.full_like(t, v)
    with torch.no_grad():
        for k, t in named.items():
            t.copy_(out[k])
    return out
