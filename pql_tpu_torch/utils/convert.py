"""Carry weights and PQL, DDPG, SAC, CrossQ, IDDPG, PPO, IPPO, MAPPO, QTOT,
team-agent, equivariant-agent, EQSD / EQSD2, PPOV / IPPOV and DDPGV states
from the JAX package into the port (``ddpgv_state_from_jax`` /
``load_ddpgv_state``: the PPOV actor's tree and DDPG's critic).

Inputs are plain nested dicts of numpy arrays (no JAX object crosses), so
this module imports nothing of JAX:

- ``params_from_jax(tree)`` takes flax params, e.g.
  ``{'params': {'net_q1': {'TorchLinear_0': {'kernel', 'bias'}, ...}}}``
  (the actor's trunk is ``MLPNet_0``), or a dict of such trees by network
  name (IPPO's), and returns a ``state_dict`` for the port's module (or
  ``nn.ModuleDict``). A flax kernel is ``[in, out]``; ``nn.Linear`` keeps
  ``[out, in]``.
- ``pql_state_from_jax(tree, layout)`` converts a whole PQL state. ``tree``
  holds, as numpy: ``actor_params``, ``critic_params``, ``critic_target``
  (flax params as above; a CrossQ critic's ``BatchNorm_i`` ``scale``/``bias``
  map onto ``norms.i``, its ``batch_stats`` ``mean``/``var`` onto the
  running buffers); ``actor_opt`` and ``critic_opt`` as
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
- ``offpolicy_state_from_jax(tree, layout)`` / ``load_offpolicy_state`` do
  the same for the baselines' state: ``actor_params``, ``critic_params``,
  ``actor_target`` and ``critic_target`` where the state has them (flax
  trees), ``actor_opt``/``critic_opt``, ``obs_rms``, ``env_state``, ``obs``,
  ``nstep``, ``replay`` as above; ``stats``, the JAX ``EpisodeStats`` as
  ``{current_returns, current_lengths, return_tracker, step_tracker,
  success_tracker, detailed_acc, detailed_tracker, info_acc, info_tracker}``
  (a tracker ``{'ring', 'ptr', 'count'}``); ``env_steps``, ``update_count``;
  SAC's ``log_alpha`` and ``alpha_opt`` ``{'mu', 'nu', 'count'}`` (arrays
  of shape [1]); CrossQ's ``batch_stats``.
- ``iddpg_state_from_jax(tree, layout)`` / ``load_iddpg_state`` do the same
  for an IDDPG state: ``params`` and ``opts`` by network name (the six
  networks, the four trained ones' Adam states), and the rest as the
  baselines' (its n-step FIFO and replay carry two reward channels).
- ``ppo_state_from_jax(tree)`` / ``load_ppo_state`` do the same for a PPO,
  MAPPO or PPOV state: ``actor_params``, ``critic_params``, ``actor_opt``,
  ``critic_opt``, ``obs_rms``, ``value_rms`` (PPOV's state has none),
  ``env_state``, ``obs``, ``dones``, ``stats`` (as above), ``env_steps``,
  ``update_count``.
  ``ma_state_from_jax(tree)`` converts an IPPO state, whose ``params`` and
  ``opts`` are dicts by network name (``actor``, ``critic``[,
  ``actor_left``, ``critic_left``]; QTOT's ``critic_tot``; the team
  agents' networks; EQS4's eight; EQSC's ``actor``, ``actor_left`` and
  central ``critic``) and which has ``value_rms_left`` too (EQSC's state has
  none), and QTOT's ``value_rms_tot`` (a tree without ``params`` goes to
  ``ppo_state_from_jax``: PPO, MAPPO, EQG); ``load_ppo_state`` writes either
  into the port's state. An EMLP's flax tree maps as ``EMLP_0`` → ``net``,
  ``EquivariantLinear_i`` → ``layers.i`` and its invariant head
  ``TorchLinear_0`` → ``head``. A diffusion net's ``TorchLinear_i`` are
  ``layers.i`` (``DiffusionNet``: 0-1 the time MLP, 2-5 the trunk; the
  equivariant net's time MLP beside its ``EMLP_0`` → ``net``); an
  ``MLPResNetBlock_i`` is ``blocks.i`` with ``LayerNorm_0`` → ``norm``,
  ``TorchLinear_0`` → ``dense1`` and ``dense2``. EQSD's and EQSD2's
  ``actor_team`` (and EQSD2's ``critic_team``) are networks of ``params``
  like the others.
- ``snapshot_from_jax(tree, actor, critic)`` converts the ``{actor, critic,
  obs_rms}`` payload of the JAX ``save_model_snapshot`` (read from its orbax
  directory on the JAX side, as numpy; a two-agent agent's actor and critic
  are dicts of flax trees by network name) into the port's weights-only
  snapshot. ``torch.save`` of the result to ``<dir>/snapshot.pt`` makes a
  directory the port's ``artifact=`` starts from, so a policy trained by
  the JAX package continues in the port.
"""

from __future__ import annotations

import re

import numpy as np
import torch


_SINGLE = {"MLPNet_0": "net", "EMLP_0": "net", "MLP_0": "mlp", "MultiStagePointNetEncoder_0": "pointnet",
           "ResNet18Trunk_0": "trunk"}
_LISTS = dict(TorchLinear="layers", EquivariantLinear="layers", GroupEquivariantLinear="layers", BatchNorm="norms",
              MLPResNetBlock="blocks", _BasicBlock="blocks", Conv="convs", GroupNorm="gns", LayerNorm="lns",
              MultiHeadDotProductAttention="attn")


def _module_name(flax_name: str, siblings=()) -> str:
    """The port's submodule name of a flax module; ``siblings``, the other
    names of its level, tell an EMLP's invariant head (``TorchLinear_0``
    beside ``EquivariantLinear_i``: ``head``) and a residual block's first
    layer (``TorchLinear_0`` beside ``dense2``: ``dense1``) from an MLP's
    layer, and a module's one LayerNorm (``norm``) from several (``lns.i``).
    A diffusion net's ``TorchLinear_i`` beside ``EMLP_0`` is a layer of its
    time MLP."""
    if flax_name in _SINGLE:
        return _SINGLE[flax_name]
    if flax_name == "LayerNorm_0" and "LayerNorm_1" not in siblings:
        return "norm"
    m = re.fullmatch(rf"({'|'.join(_LISTS)})_(\d+)", flax_name)
    if not m:
        return flax_name
    if m.group(1) == "TorchLinear" and any("EquivariantLinear" in s for s in siblings):
        return "head"
    if m.group(1) == "TorchLinear" and "dense2" in siblings:
        return "dense1"
    return f"{_LISTS[m.group(1)]}.{m.group(2)}"


def kernel_to_port(k: np.ndarray) -> np.ndarray:
    """A flax kernel in the port's layout: Dense [in, out] → [out, in]; Conv
    HWIO → OIHW; an attention DenseGeneral's 3-D kernel as it is."""
    if k.ndim == 2:
        return k.T
    if k.ndim == 4:
        return k.transpose(3, 2, 0, 1)
    return k


def kernel_to_flax(w: np.ndarray) -> np.ndarray:
    """The inverse of ``kernel_to_port``."""
    if w.ndim == 2:
        return w.T
    if w.ndim == 4:
        return w.transpose(2, 3, 1, 0)
    return w


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Flax params or batch_stats (nested dicts of numpy) → the port module's
    state_dict entries."""
    tree = tree.get("params", tree)
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            if key == "params":  # a nested tree of params by network name (a two-agent snapshot)
                walk(val, prefix)
            elif isinstance(val, dict):
                walk(val, prefix + [_module_name(key, node)])
            elif key == "kernel":
                out[".".join(prefix + ["weight"])] = torch.from_numpy(np.array(kernel_to_port(np.asarray(val))))
            elif key in ("bias", "scale", "mean", "var", "logstd"):
                out[".".join(prefix + [key])] = torch.from_numpy(np.array(val))
            else:
                raise KeyError(f"unexpected flax leaf {'/'.join(prefix + [key])}")

    walk(tree, [])
    return out


def _flax_path(port_name: str) -> tuple[str, ...]:
    """The flax path of a port parameter name: ``net.layers.0.weight`` ->
    ``('MLPNet_0', 'TorchLinear_0', 'kernel')``."""
    parts, out = port_name.split("."), []
    i = 0
    while i < len(parts):
        if parts[i] == "net":
            out.append("MLPNet_0")
        elif parts[i] == "layers":
            i += 1
            out.append(f"TorchLinear_{parts[i]}")
        elif parts[i] == "weight":
            out.append("kernel")
        else:
            out.append(parts[i])
        i += 1
    return tuple(out)


def _flax_list_name(attr: str, idx: str, child: torch.nn.Module) -> str:
    if attr == "blocks":
        return f"{'MLPResNetBlock' if type(child).__name__ == 'MLPResNetBlock' else '_BasicBlock'}_{idx}"
    kind = {v: k for k, v in _LISTS.items() if k not in ("EquivariantLinear", "GroupEquivariantLinear",
                                                          "MLPResNetBlock")}[attr]
    return f"{kind}_{idx}"


def _flax_single_name(attr: str, child: torch.nn.Module) -> str:
    if attr == "net":
        return {"MLPNet": "MLPNet_0", "EMLP": "EMLP_0"}.get(type(child).__name__, "net")
    if attr in ("dense1", "head"):
        return "TorchLinear_0"
    if attr == "norm":
        return "LayerNorm_0"
    return {v: k for k, v in _SINGLE.items() if v != "net"}.get(attr, attr)


def flax_param_paths(module: torch.nn.Module) -> dict[str, tuple[str, ...]]:
    """The flax path of each parameter of ``module`` (the inverse of
    ``params_from_jax``'s names, by the submodules' types): ``encoder.trunk.
    blocks.2.convs.0.weight`` → ``('encoder', 'ResNet18Trunk_0',
    '_BasicBlock_2', 'Conv_0', 'kernel')``. Covers the MLP, diffusion,
    point-cloud and visual modules (an EMLP's layers are not told from a
    Linear's)."""
    out = {}
    for name, _ in module.named_parameters():
        parts, mod, path, i = name.split("."), module, [], 0
        while i < len(parts) - 1:
            child = getattr(mod, parts[i])
            if isinstance(child, torch.nn.ModuleList):
                sub = child[int(parts[i + 1])]
                path.append(_flax_list_name(parts[i], parts[i + 1], sub))
                mod, i = sub, i + 2
            else:
                path.append(_flax_single_name(parts[i], child))
                mod, i = child, i + 1
        path.append("kernel" if parts[-1] == "weight" else parts[-1])
        out[name] = tuple(path)
    return out


def params_from_jax_flat(flat, module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """A raveled flax param vector (``jax.flatten_util.ravel_pytree``'s
    order: leaves sorted by key at every level, each flattened row-major)
    → ``module``'s state_dict. The JAX PQL keeps its params raveled, so its
    snapshots hold such vectors; ``module`` supplies the names and shapes."""
    flat = np.asarray(flat)
    shapes = {name: tuple(t.shape) for name, t in module.state_dict().items()}
    if flat.size != sum(int(np.prod(s)) for s in shapes.values()):
        raise ValueError(f"flat params of size {flat.size} do not fit {type(module).__name__}")
    out, at = {}, 0
    for name in sorted(shapes, key=_flax_path):
        shape = shapes[name]
        n = int(np.prod(shape))
        leaf = flat[at : at + n]
        at += n
        if name.endswith("weight"):  # a flax kernel is [in, out]
            out[name] = torch.from_numpy(np.array(leaf.reshape(shape[::-1]).T))
        else:
            out[name] = torch.from_numpy(np.array(leaf.reshape(shape)))
    return out


def snapshot_from_jax(tree: dict, actor: torch.nn.Module | None = None,
                      critic: torch.nn.Module | None = None) -> dict:
    """The JAX weights-only snapshot ``{actor, critic, obs_rms}`` (numpy) →
    the port's (``utils/checkpoint.py``). Params are flax trees, or raveled
    vectors as the JAX PQL saves them, which need the port's ``actor`` /
    ``critic`` module for their names and shapes."""

    def params(x, module, what):
        if isinstance(x, dict):
            return params_from_jax(x)
        if module is None:
            raise ValueError(f"the snapshot's {what} params are raveled: pass the port's {what} module")
        return params_from_jax_flat(x, module)

    out = {}
    if "actor" in tree:
        out["actor"] = params(tree["actor"], actor, "actor")
    if "critic" in tree:
        out["critic"] = params(tree["critic"], critic, "critic")
    if "obs_rms" in tree:
        out["obs_rms"] = {k: _tensor(tree["obs_rms"][k], torch.float32) for k in ("mean", "var", "count")}
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


def _rms_from_jax(rms: dict) -> dict:
    return {k: _tensor(rms[k], torch.float32) for k in ("mean", "var", "count")}


def _env_from_jax(tree: dict) -> dict:
    """The obs normalizer, env state and obs of a JAX state."""
    return dict(
        obs_rms=_rms_from_jax(tree["obs_rms"]),
        env_state=dict(
            state={k: _tensor(v) for k, v in tree["env_state"]["state"].items()},
            time=_tensor(tree["env_state"]["time"], torch.int32),
        ),
        obs=_tensor(tree["obs"]),
    )


def _env_parts_from_jax(tree: dict, layout) -> dict:
    """The obs normalizer, env state, obs, n-step FIFO and replay of a JAX state."""
    data = np.asarray(tree["replay"]["data"])
    fields = {name: _tensor(data[..., s : s + d]) for name, s, d in layout}
    nstep = tree["nstep"]
    return dict(
        **_env_from_jax(tree),
        nstep=dict(
            {k: _tensor(nstep[k]) for k in ("obs", "action", "reward", "next_obs", "done")},
            count=int(nstep["count"]),
        ),
        replay=dict(
            fields=fields, ptr=int(tree["replay"]["ptr"]), total_writes=int(tree["replay"]["total_writes"])
        ),
    )


def pql_state_from_jax(tree: dict, layout) -> dict:
    """A whole JAX PQL state (as numpy, see the module doc) → port tensors."""
    return dict(
        actor=params_from_jax(tree["actor_params"]),
        critic=params_from_jax(tree["critic_params"]),
        critic_target=params_from_jax(tree["critic_target"]),
        actor_opt=_opt_from_jax(tree["actor_opt"]),
        critic_opt=_opt_from_jax(tree["critic_opt"]),
        **_env_parts_from_jax(tree, layout),
        cur_returns=_tensor(tree["cur_returns"]),
        cur_lengths=_tensor(tree["cur_lengths"]),
        trackers={
            name: dict(ring=_tensor(t["ring"]), ptr=int(t["ptr"]), count=int(t["count"]))
            for name, t in ((n, tree[n]) for n in ("return_tracker", "len_tracker", "success_tracker"))
        },
        counters={k: int(tree[k]) for k in ("env_steps", "critic_update_count", "actor_update_count")},
    )


def ddpgv_state_from_jax(tree: dict) -> dict:
    """A whole JAX DDPGV state (as numpy) → port tensors: ``actor_params``
    (the PPOV actor's tree), ``critic_params`` and ``critic_target`` (DDPG's
    Double-Q), their optimizers, ``obs_rms``, ``env_state``, ``obs``,
    ``cur_returns``, ``cur_lengths``, ``return_tracker``, ``len_tracker`` and
    ``env_steps``. The host ring is not part of the state."""
    return dict(
        actor=params_from_jax(tree["actor_params"]),
        critic=params_from_jax(tree["critic_params"]),
        critic_target=params_from_jax(tree["critic_target"]),
        actor_opt=_opt_from_jax(tree["actor_opt"]),
        critic_opt=_opt_from_jax(tree["critic_opt"]),
        **_env_from_jax(tree),
        cur_returns=_tensor(tree["cur_returns"]),
        cur_lengths=_tensor(tree["cur_lengths"]),
        trackers={n: dict(ring=_tensor(tree[n]["ring"]), ptr=int(tree[n]["ptr"]), count=int(tree[n]["count"]))
                  for n in ("return_tracker", "len_tracker")},
        counters={"env_steps": int(tree["env_steps"])},
    )


def _tracker_from_jax(t: dict) -> dict:
    return dict(ring=_tensor(t["ring"]), ptr=torch.tensor(int(t["ptr"])), count=torch.tensor(int(t["count"])))


def _stats_from_jax(st: dict) -> dict:
    """A JAX EpisodeStats (numpy) → ``EpisodeStats.state_dict``'s layout."""
    acc = {"returns": _tensor(st["current_returns"]), "lengths": _tensor(st["current_lengths"])}
    trackers = {n: _tracker_from_jax(st[f"{n}_tracker"]) for n in ("return", "step", "success")}
    for kind in ("detailed", "info"):
        acc.update({f"{kind}/{k}": _tensor(v) for k, v in st.get(f"{kind}_acc", {}).items()})
        trackers.update({f"{kind}/{k}": _tracker_from_jax(t) for k, t in st.get(f"{kind}_tracker", {}).items()})
    return dict(accumulators=acc, trackers=trackers)


def offpolicy_state_from_jax(tree: dict, layout) -> dict:
    """A whole JAX DDPG / SAC / CrossQ state (as numpy, see the module doc) → port tensors."""
    out = dict(
        actor=params_from_jax(tree["actor_params"]),
        critic=params_from_jax(tree["critic_params"]),
        actor_opt=_opt_from_jax(tree["actor_opt"]),
        critic_opt=_opt_from_jax(tree["critic_opt"]),
        **_env_parts_from_jax(tree, layout),
        stats=_stats_from_jax(tree["stats"]),
        counters={k: int(tree[k]) for k in ("env_steps", "update_count")},
    )
    for name in ("actor_target", "critic_target"):
        if name in tree:
            out[name] = params_from_jax(tree[name])
    if "batch_stats" in tree:
        out["critic"].update(params_from_jax(tree["batch_stats"]))
    if "log_alpha" in tree:
        o = tree["alpha_opt"]
        out["log_alpha"] = _tensor(tree["log_alpha"], torch.float32)
        out["alpha_opt"] = dict(exp_avg=_tensor(o["mu"]), exp_avg_sq=_tensor(o["nu"]), step=int(o["count"]))
    return out


def iddpg_state_from_jax(tree: dict, layout) -> dict:
    """A whole JAX IDDPG state (as numpy, see the module doc) → port tensors."""
    return dict(
        **_nets_from_jax(tree),
        **_env_parts_from_jax(tree, layout),
        stats=_stats_from_jax(tree["stats"]),
        counters={k: int(tree[k]) for k in ("env_steps", "update_count")},
    )


def _nets_from_jax(tree: dict) -> dict:
    return dict(nets=params_from_jax(tree["params"]), opts={name: _opt_from_jax(o) for name, o in tree["opts"].items()})


def ppo_state_from_jax(tree: dict) -> dict:
    """A whole JAX PPO or MAPPO state (as numpy, see the module doc) → port tensors."""
    return dict(
        actor=params_from_jax(tree["actor_params"]),
        critic=params_from_jax(tree["critic_params"]),
        actor_opt=_opt_from_jax(tree["actor_opt"]),
        critic_opt=_opt_from_jax(tree["critic_opt"]),
        **_onpolicy_parts_from_jax(tree),
    )


def ma_state_from_jax(tree: dict) -> dict:
    """A whole JAX IPPO, QTOT, team-agent, EQ-family or EQSC state (or,
    without ``params``, a MAPPO one) → port tensors."""
    if "params" not in tree:
        return ppo_state_from_jax(tree)
    out = dict(**_nets_from_jax(tree), **_onpolicy_parts_from_jax(tree))
    for name in ("value_rms_left", "value_rms_tot"):
        if tree.get(name) is not None:
            out[name] = _rms_from_jax(tree[name])
    return out


def _onpolicy_parts_from_jax(tree: dict) -> dict:
    return dict(
        **_env_from_jax(tree),
        **({"value_rms": _rms_from_jax(tree["value_rms"])} if tree.get("value_rms") is not None else {}),
        dones=_tensor(tree["dones"]),
        stats=_stats_from_jax(tree["stats"]),
        counters={k: int(tree[k]) for k in ("env_steps", "update_count")},
    )


def _adam_state(opt: torch.optim.Optimizer, p: torch.Tensor, exp_avg, exp_avg_sq, step: int) -> None:
    opt.state[p] = dict(
        step=torch.tensor(float(step), dtype=torch.float32),
        exp_avg=exp_avg.to(p.device).clone(),
        exp_avg_sq=exp_avg_sq.to(p.device).clone(),
    )


def _load_module_opt(module: torch.nn.Module, opt: torch.optim.Optimizer, sd: dict, o: dict) -> None:
    module.load_state_dict(sd)
    for pname, p in module.named_parameters():
        _adam_state(opt, p, o["exp_avg"][pname], o["exp_avg_sq"][pname], o["step"])


def _load_nets(state, conv: dict) -> None:
    """A two-agent state's networks and, for each trained one, its Adam state."""
    state.nets.load_state_dict(conv["nets"])
    for name, o in conv["opts"].items():
        for pname, p in state.nets[name].named_parameters():
            _adam_state(state.opts[name], p, o["exp_avg"][pname], o["exp_avg_sq"][pname], o["step"])


def _load_env(state, conv: dict) -> None:
    dev = state.obs.device
    for name in ("obs_rms", "value_rms", "value_rms_left", "value_rms_tot"):
        if name in conv:
            for k in ("mean", "var", "count"):
                getattr(getattr(state, name), k).copy_(conv[name][k])
    state.env_state.state = {k: v.to(dev) for k, v in conv["env_state"]["state"].items()}
    state.env_state.time = conv["env_state"]["time"].to(dev)
    state.obs = conv["obs"].to(dev)


def _load_env_parts(state, conv: dict) -> None:
    dev = state.obs.device
    _load_env(state, conv)
    for k in ("obs", "action", "reward", "next_obs", "done"):
        setattr(state.nstep, k, conv["nstep"][k].to(dev))
    state.nstep.count = conv["nstep"]["count"]
    replay = state.replay
    for name, s, d in replay.layout:
        replay.data[..., s : s + d] = conv["replay"]["fields"][name].to(dev, replay.data.dtype)
    replay.ptr, replay.total_writes = conv["replay"]["ptr"], conv["replay"]["total_writes"]


@torch.no_grad()
def load_pql_state(state, conv: dict) -> None:
    """Write a ``pql_state_from_jax`` conversion into a port PQLState in place."""
    _load_module_opt(state.actor, state.actor_opt, conv["actor"], conv["actor_opt"])
    _load_module_opt(state.critic, state.critic_opt, conv["critic"], conv["critic_opt"])
    state.critic_target.load_state_dict(conv["critic_target"])
    _load_env_parts(state, conv)
    _load_episodes(state, conv)


def _load_episodes(state, conv: dict) -> None:
    """PQL's or DDPGV's episode accumulators, trackers and counters."""
    dev = state.obs.device
    state.cur_returns = conv["cur_returns"].to(dev)
    state.cur_lengths = conv["cur_lengths"].to(dev)
    for name, t in conv["trackers"].items():
        tracker = getattr(state, name)
        tracker.ring.copy_(t["ring"])
        tracker.ptr.fill_(t["ptr"])
        tracker.count.fill_(t["count"])
    for k, v in conv["counters"].items():
        setattr(state, k, v)


@torch.no_grad()
def load_ddpgv_state(state, conv: dict) -> None:
    """Write a ``ddpgv_state_from_jax`` conversion into a port DDPGVState in place."""
    _load_module_opt(state.actor, state.actor_opt, conv["actor"], conv["actor_opt"])
    _load_module_opt(state.critic, state.critic_opt, conv["critic"], conv["critic_opt"])
    state.critic_target.load_state_dict(conv["critic_target"])
    _load_env(state, conv)
    _load_episodes(state, conv)


@torch.no_grad()
def load_offpolicy_state(state, conv: dict) -> None:
    """Write an ``offpolicy_state_from_jax`` conversion into a port
    OffPolicyState / SACState in place. A state without an actor target
    (``no_tgt_actor``: the JAX one equals the actor) or a critic target
    (CrossQ: the JAX one is unused) ignores the converted one."""
    _load_module_opt(state.actor, state.actor_opt, conv["actor"], conv["actor_opt"])
    _load_module_opt(state.critic, state.critic_opt, conv["critic"], conv["critic_opt"])
    for name in ("actor_target", "critic_target"):
        if getattr(state, name) is not None:
            getattr(state, name).load_state_dict(conv[name])
    _load_env_parts(state, conv)
    state.stats.load_state_dict(conv["stats"])
    if getattr(state, "log_alpha", None) is not None:
        state.log_alpha.copy_(conv["log_alpha"])
        o = conv["alpha_opt"]
        _adam_state(state.alpha_opt, state.log_alpha, o["exp_avg"], o["exp_avg_sq"], o["step"])
    for k, v in conv["counters"].items():
        setattr(state, k, v)


@torch.no_grad()
def load_iddpg_state(state, conv: dict) -> None:
    """Write an ``iddpg_state_from_jax`` conversion into a port IDDPGState in place."""
    _load_nets(state, conv)
    _load_env_parts(state, conv)
    state.stats.load_state_dict(conv["stats"])
    for k, v in conv["counters"].items():
        setattr(state, k, v)


@torch.no_grad()
def load_ppo_state(state, conv: dict) -> None:
    """Write a ``ppo_state_from_jax`` or ``ma_state_from_jax`` conversion into
    a port PPOState, IPPOState (IPPO, QTOT, the team agents, the EQ family)
    or EQSCState in place."""
    if "nets" in conv:
        _load_nets(state, conv)
    else:
        _load_module_opt(state.actor, state.actor_opt, conv["actor"], conv["actor_opt"])
        _load_module_opt(state.critic, state.critic_opt, conv["critic"], conv["critic_opt"])
    _load_env(state, conv)
    state.dones = conv["dones"].to(state.obs.device)
    state.stats.load_state_dict(conv["stats"])
    for k, v in conv["counters"].items():
        setattr(state, k, v)
