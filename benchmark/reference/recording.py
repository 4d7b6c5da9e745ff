"""What the adapters take from the program during set-up, shared by the
configurations: copies on the host, the gradient of each optimizer's first
step, and the parameters after the followed iterations. It wraps the
program's objects and reads them; it changes nothing they compute."""

from __future__ import annotations

import torch


def host(x):
    """A copy on the host of a nest of dicts, lists and tuples of tensors."""
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(host(v) for v in x)
    return x.detach().to("cpu", copy=True)


class FirstSteps:
    """The gradient each optimizer got at its first step, worked out from its
    state after that step: Adam's first moment m = (1 − β1)·g (nought where
    the step left no state)."""

    def __init__(self, optimizers: dict):
        self.grads, self._opts = {}, optimizers
        for net, (opt, module) in optimizers.items():
            self._wrap(net, opt, module)

    def _wrap(self, net, opt, module):
        step = opt.step

        def first(*a, **k):
            out = step(*a, **k)
            if net not in self.grads:
                b1 = opt.param_groups[0]["betas"][0]
                self.grads[net] = {f"{net}.{n}": opt.state[p].get("exp_avg", torch.zeros_like(p)) / (1.0 - b1)
                                   for n, p in module.named_parameters()}
            return out

        opt.step = first

    def close(self) -> dict:
        for opt, _ in self._opts.values():
            del opt.step
        return {k: v for g in self.grads.values() for k, v in g.items()}


def params(named_modules: dict) -> dict:
    return {f"{net}.{n}": p.detach().clone() for net, mod in named_modules.items() for n, p in mod.named_parameters()}
