"""Carry weights and PQL state from the JAX package into the port.

Inputs are plain nested dicts of numpy arrays (no JAX object crosses), so
this module imports nothing of JAX:

- ``params_from_jax(tree)`` takes flax params, e.g.
  ``{'params': {'net_q1': {'TorchLinear_0': {'kernel', 'bias'}, ...}}}``
  (the actor's trunk is ``MLPNet_0``), and returns a ``state_dict`` for the
  port's module. A flax kernel is ``[in, out]``; ``nn.Linear`` keeps
  ``[out, in]``.
- ``pql_state_from_jax(tree, layout)`` converts a whole PQL state. ``tree``
  holds, as numpy: ``actor_params``, ``critic_params``, ``critic_target``
  (flax params as above); ``actor_opt`` and ``critic_opt`` as
  ``{'mu', 'nu'}`` (flax params layout) and ``'count'``; ``obs_rms``
  ``{'mean', 'var', 'count'}``; ``env_state`` ``{'state': {field: [E]},
  'time': [E]}``; ``obs``; ``nstep`` ``{'obs', 'action', 'reward',
  'next_obs', 'done', 'count'}``; ``replay`` ``{'data', 'ptr',
  'total_writes'}``; ``cur_returns``, ``cur_lengths``; ``return_tracker``,
  ``len_tracker``, ``success_tracker`` ``{'ring', 'ptr', 'count'}``; and
  ``env_steps``, ``critic_update_count``, ``actor_update_count``.
  ``layout`` is the JAX replay's ((name, start, dim), ...): fields are cut
  out of its packed rows, so its lane padding is dropped.
- ``load_pql_state(state, converted)`` writes such a conversion into a
  port ``PQLState`` (made by ``PQL.init``) in place, on its device.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _module_name(flax_name: str) -> str:
    if flax_name == "MLPNet_0":
        return "net"
    m = re.fullmatch(r"TorchLinear_(\d+)", flax_name)
    return f"layers.{m.group(1)}" if m else flax_name


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Flax params (nested dicts of numpy) → the port module's state_dict."""
    tree = tree.get("params", tree)
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, prefix + [_module_name(key)])
            elif key == "kernel":
                out[".".join(prefix + ["weight"])] = torch.from_numpy(np.array(np.asarray(val).T))
            elif key == "bias":
                out[".".join(prefix + ["bias"])] = torch.from_numpy(np.array(val))
            else:
                raise KeyError(f"unexpected flax leaf {'/'.join(prefix + [key])}")

    walk(tree, [])
    return out


def _opt_from_jax(opt: dict) -> dict:
    return dict(
        exp_avg=params_from_jax(opt["mu"]),
        exp_avg_sq=params_from_jax(opt["nu"]),
        step=int(opt["count"]),
    )


def _tensor(x, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def pql_state_from_jax(tree: dict, layout) -> dict:
    """A whole JAX PQL state (as numpy, see the module doc) → port tensors."""
    data = np.asarray(tree["replay"]["data"])
    fields = {name: _tensor(data[..., s : s + d]) for name, s, d in layout}
    nstep = tree["nstep"]
    return dict(
        actor=params_from_jax(tree["actor_params"]),
        critic=params_from_jax(tree["critic_params"]),
        critic_target=params_from_jax(tree["critic_target"]),
        actor_opt=_opt_from_jax(tree["actor_opt"]),
        critic_opt=_opt_from_jax(tree["critic_opt"]),
        obs_rms={k: _tensor(tree["obs_rms"][k], torch.float32) for k in ("mean", "var", "count")},
        env_state=dict(
            state={k: _tensor(v) for k, v in tree["env_state"]["state"].items()},
            time=_tensor(tree["env_state"]["time"], torch.int32),
        ),
        obs=_tensor(tree["obs"]),
        nstep=dict(
            {k: _tensor(nstep[k]) for k in ("obs", "action", "reward", "next_obs", "done")},
            count=int(nstep["count"]),
        ),
        replay=dict(
            fields=fields, ptr=int(tree["replay"]["ptr"]), total_writes=int(tree["replay"]["total_writes"])
        ),
        cur_returns=_tensor(tree["cur_returns"]),
        cur_lengths=_tensor(tree["cur_lengths"]),
        trackers={
            name: dict(ring=_tensor(t["ring"]), ptr=int(t["ptr"]), count=int(t["count"]))
            for name, t in ((n, tree[n]) for n in ("return_tracker", "len_tracker", "success_tracker"))
        },
        counters={k: int(tree[k]) for k in ("env_steps", "critic_update_count", "actor_update_count")},
    )


@torch.no_grad()
def load_pql_state(state, conv: dict) -> None:
    """Write a ``pql_state_from_jax`` conversion into a port PQLState in place."""
    for name, opt_name in (("actor", "actor_opt"), ("critic", "critic_opt")):
        module, opt = getattr(state, name), getattr(state, opt_name)
        module.load_state_dict(conv[name])
        o = conv[opt_name]
        for pname, p in module.named_parameters():
            opt.state[p] = dict(
                step=torch.tensor(float(o["step"]), dtype=torch.float32),
                exp_avg=o["exp_avg"][pname].to(p.device).clone(),
                exp_avg_sq=o["exp_avg_sq"][pname].to(p.device).clone(),
            )
    state.critic_target.load_state_dict(conv["critic_target"])
    dev = state.obs.device
    for k in ("mean", "var", "count"):
        getattr(state.obs_rms, k).copy_(conv["obs_rms"][k])
    state.env_state.state = {k: v.to(dev) for k, v in conv["env_state"]["state"].items()}
    state.env_state.time = conv["env_state"]["time"].to(dev)
    state.obs = conv["obs"].to(dev)
    for k in ("obs", "action", "reward", "next_obs", "done"):
        setattr(state.nstep, k, conv["nstep"][k].to(dev))
    state.nstep.count = conv["nstep"]["count"]
    replay = state.replay
    for name, s, d in replay.layout:
        replay.data[..., s : s + d] = conv["replay"]["fields"][name].to(dev, replay.data.dtype)
    replay.ptr, replay.total_writes = conv["replay"]["ptr"], conv["replay"]["total_writes"]
    state.cur_returns = conv["cur_returns"].to(dev)
    state.cur_lengths = conv["cur_lengths"].to(dev)
    for name, t in conv["trackers"].items():
        tracker = getattr(state, name)
        tracker.ring.copy_(t["ring"])
        tracker.ptr.fill_(t["ptr"])
        tracker.count.fill_(t["count"])
    for k, v in conv["counters"].items():
        setattr(state, k, v)
