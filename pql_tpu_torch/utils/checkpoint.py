"""Checkpoints of the port (port of pql_tpu/utils/checkpoint.py:19-133).

Two kinds, each a directory holding one ``torch.save`` file (the JAX
package writes orbax directories; the formats differ):

- the **full state** (``save_checkpoint`` / ``load_checkpoint``,
  ``<dir>/state.pt``) of a ``PQLState`` or of a baseline's
  ``OffPolicyState`` / ``SACState``: the actor, critic and target weights
  (the actor target where the state has one; a CrossQ critic's BatchNorm
  statistics are its buffers) and the optimizers' ``state_dict``s, SAC's
  ``log_alpha`` and its optimizer, the obs normalizer, the env state and obs,
  the n-step FIFO, the replay ring with its pointer and write count, the
  episode accumulators and trackers (PQL's three, or a baseline's
  ``EpisodeStats``), the generator's state (a CUDA generator's on the card)
  and the counters. ``maybe_resume_full_state`` restores it into a freshly
  built state, and training continues bitwise as if it had not stopped;
- the **weights-only snapshot** (``save_model_snapshot`` /
  ``load_model_snapshot``, ``<dir>/snapshot.pt``): ``{actor, critic,
  obs_rms}``, the reference's best-model payload. ``restore_into_state``
  loads it, the targets from ``actor`` and ``critic``. ``utils/convert.py``'s
  ``snapshot_from_jax`` makes one from a JAX snapshot.

A file is written beside its final name and renamed into place, so a run
stopped during a save keeps the previous checkpoint. Files hold tensors,
numbers and dicts only and are read with ``weights_only=True``.
"""

from __future__ import annotations

import os

import torch

STATE_FILE = "state.pt"
SNAPSHOT_FILE = "snapshot.pt"
_MODULES = ("actor", "critic", "actor_target", "critic_target")  # a state may hold None for a target
_OPTIMIZERS = ("actor_opt", "critic_opt", "alpha_opt")
_TRACKERS = ("return_tracker", "len_tracker", "success_tracker")  # PQL's
_NSTEP = ("obs", "action", "reward", "next_obs", "done")
_COUNTERS = ("env_steps", "critic_update_count", "actor_update_count", "update_count")


def _save(obj, path: str, name: str) -> None:
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, name)
    tmp = final + f".{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, final)


def _load(path: str, name: str):
    file = os.path.join(path, name) if os.path.isdir(path) else path
    return torch.load(file, map_location="cpu", weights_only=True)


def _rms(obs_rms) -> dict[str, torch.Tensor]:
    return {"mean": obs_rms.mean, "var": obs_rms.var, "count": obs_rms.count}


def _present(state, names) -> list[str]:
    return [n for n in names if getattr(state, n, None) is not None]


def state_dict(state) -> dict:
    """Everything of a ``PQLState``, ``OffPolicyState`` or ``SACState`` as
    tensors, numbers and dicts (the live tensors, not copies)."""
    sd = {n: getattr(state, n).state_dict() for n in _present(state, _MODULES + _OPTIMIZERS)}
    sd.update(
        obs_rms=_rms(state.obs_rms),
        env_state=dict(state=dict(state.env_state.state), time=state.env_state.time),
        obs=state.obs,
        nstep=dict({k: getattr(state.nstep, k) for k in _NSTEP}, count=state.nstep.count),
        replay=dict(data=state.replay.data, ptr=state.replay.ptr, total_writes=state.replay.total_writes),
        gen=state.gen.get_state(),
        counters={k: getattr(state, k) for k in _COUNTERS if hasattr(state, k)},
    )
    if hasattr(state, "stats"):  # a baseline's EpisodeStats
        sd["stats"] = state.stats.state_dict()
    else:
        sd.update(cur_returns=state.cur_returns, cur_lengths=state.cur_lengths,
                  trackers={n: dict(ring=getattr(state, n).ring, ptr=getattr(state, n).ptr,
                                    count=getattr(state, n).count) for n in _TRACKERS})
    if getattr(state, "log_alpha", None) is not None:
        sd["log_alpha"] = state.log_alpha.detach()
    return sd


@torch.no_grad()
def load_state_dict(state, sd: dict):
    """Write a ``state_dict`` into a state built for the same config, on its
    device. Modules, optimizers, ``log_alpha``, the normalizer, the replay
    ring and the trackers are written in place; the env state, obs, n-step
    FIFO and accumulators become new tensors (a graphed task copies its
    inputs into its graph's buffers on every step)."""
    dev = state.obs.device
    held = _present(state, _MODULES + _OPTIMIZERS)
    if set(held) != set(sd) & set(_MODULES + _OPTIMIZERS):
        raise ValueError(f"checkpoint holds {sorted(set(sd) & set(_MODULES + _OPTIMIZERS))}, this state {sorted(held)}")
    for name in held:
        getattr(state, name).load_state_dict(sd[name])
    if "log_alpha" in sd:
        state.log_alpha.copy_(sd["log_alpha"])
    for k, v in sd["obs_rms"].items():
        getattr(state.obs_rms, k).copy_(v)
    state.env_state.state = {k: v.to(dev) for k, v in sd["env_state"]["state"].items()}
    state.env_state.time = sd["env_state"]["time"].to(dev)
    state.obs = sd["obs"].to(dev)
    for k in _NSTEP:
        setattr(state.nstep, k, sd["nstep"][k].to(dev))
    state.nstep.count = sd["nstep"]["count"]
    replay = sd["replay"]
    if replay["data"].shape != state.replay.data.shape:
        raise ValueError(f"checkpoint replay ring {tuple(replay['data'].shape)}, "
                         f"this config's {tuple(state.replay.data.shape)}")
    state.replay.data.copy_(replay["data"])
    state.replay.ptr, state.replay.total_writes = replay["ptr"], replay["total_writes"]
    if "stats" in sd:
        state.stats.load_state_dict(sd["stats"])
    else:
        state.cur_returns = sd["cur_returns"].to(dev)
        state.cur_lengths = sd["cur_lengths"].to(dev)
        for name, t in sd["trackers"].items():
            tracker = getattr(state, name)
            for k in ("ring", "ptr", "count"):
                getattr(tracker, k).copy_(t[k])
    state.gen.set_state(sd["gen"])
    for k, v in sd["counters"].items():
        setattr(state, k, v)
    return state


def save_checkpoint(path: str, state) -> None:
    """The full state into ``path/state.pt``."""
    _save(state_dict(state), path, STATE_FILE)


def load_checkpoint(path: str, state):
    """Restore ``path`` (a directory from ``save_checkpoint``) into ``state``."""
    return load_state_dict(state, _load(path, STATE_FILE))


def maybe_resume_full_state(cfg, state):
    """Preemption recovery: if ``cfg.checkpoint_dir/state`` holds a full
    checkpoint, restore it into the freshly built ``state`` and return
    (state, True); else (state, False)."""
    if not cfg.checkpoint_dir:
        return state, False
    path = os.path.join(cfg.checkpoint_dir, "state")
    if not os.path.exists(os.path.join(path, STATE_FILE)):
        return state, False
    return load_checkpoint(path, state), True


def save_model_snapshot(path: str, actor, critic, obs_rms) -> None:
    """Weights-only snapshot ``{actor, critic, obs_rms}`` into ``path/snapshot.pt``
    (the reference save_model payload, model_util.py:24-41)."""
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
    _save({"actor": cpu(actor.state_dict()), "critic": cpu(critic.state_dict()), "obs_rms": cpu(_rms(obs_rms))},
          path, SNAPSHOT_FILE)


def load_model_snapshot(path: str) -> dict:
    """A snapshot saved by ``save_model_snapshot`` (a directory, or its
    file), as CPU tensors. ``wandb-artifact://entity/project/name:tag``
    resolves through the wandb Artifact API first (reference load_model,
    model_util.py:9-21)."""
    prefix = "wandb-artifact://"
    if path.startswith(prefix):
        try:
            import wandb  # noqa: PLC0415
        except ImportError as e:
            raise ImportError(
                f"artifact={path} needs the wandb package; pass a local checkpoint directory instead"
            ) from e
        path = wandb.Api().artifact(path[len(prefix) :]).download()
    return _load(path, SNAPSHOT_FILE)


def _load_weights(module: torch.nn.Module, weights: dict) -> None:
    """Load ``weights`` into ``module``; buffers it lacks (a JAX CrossQ
    snapshot holds no BatchNorm statistics) keep the module's values, as the
    JAX package's ``restore_into_state`` keeps its fresh ``batch_stats``."""
    missing = set(module.state_dict()) - set(weights)
    params = {n for n, _ in module.named_parameters()}
    if missing & params:
        raise KeyError(f"snapshot lacks parameters {sorted(missing & params)[:4]}")
    module.load_state_dict({**module.state_dict(), **weights})


@torch.no_grad()
def restore_into_state(state, snapshot: dict):
    """Weights-only resume: the actor, the critic and the targets the state
    has (from ``actor`` and ``critic``), and the obs normalizer; optimizers
    and all else stay fresh (reference train_baselines.py:33-37,
    pql_v_learner.py:44-45)."""
    rms = snapshot.get("obs_rms")
    if rms is not None:
        for k in ("mean", "var", "count"):
            getattr(state.obs_rms, k).copy_(torch.as_tensor(rms[k]))
    for name in ("actor", "critic"):
        if name in snapshot:
            for module in (getattr(state, name), getattr(state, f"{name}_target", None)):
                if module is not None:
                    _load_weights(module, snapshot[name])
    return state
