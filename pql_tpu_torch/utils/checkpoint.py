"""Checkpoints of the port (port of pql_tpu/utils/checkpoint.py:19-133).

Two kinds, each a directory holding one ``torch.save`` file (the JAX
package writes orbax directories; the formats differ):

- the **full state** (``save_checkpoint`` / ``load_checkpoint``,
  ``<dir>/state.pt``) of a ``PQLState``, of a baseline's ``OffPolicyState``
  / ``SACState`` / ``IDDPGState`` or of an on-policy ``PPOState`` (PPO,
  MAPPO, EQG) / ``IPPOState`` (IPPO, QTOT, the team agents, EQ, EQS, EQS4,
  EQSdata, MP, EQSD, EQSD2) / ``EQSCState``, or of a ``DDPGVState``: the actor, critic
  and target weights (the actor target where the state has one; a CrossQ
  critic's BatchNorm statistics are its buffers; a two-agent state's
  ``nets``, IDDPG's targets among them) and the optimizers' ``state_dict``s
  (a two-agent state's ``opts``), SAC's ``log_alpha`` and its optimizer, the obs normalizer and
  the value normalizers, the env state, obs and (on-policy) the dones, the
  n-step FIFO and the replay ring with its pointer and write count
  (off-policy), the episode accumulators and trackers (PQL's three, or an
  ``EpisodeStats``; DDPGV's two), the generator's state (a CUDA generator's on the card)
  and the counters. ``maybe_resume_full_state`` restores it into a freshly
  built state, and training continues bitwise as if it had not stopped.
  DDPGV's host ring is not part of its state, in either package: its run
  resumes with an empty ring and a fresh sampler;
- the **weights-only snapshot** (``save_model_snapshot`` /
  ``load_model_snapshot``, ``<dir>/snapshot.pt``): ``{actor, critic,
  obs_rms}``, the reference's best-model payload, of the modules the
  agent's ``snapshot_parts`` names. ``restore_into_state`` loads it, the
  targets from ``actor`` and ``critic``. ``utils/convert.py``'s
  ``snapshot_from_jax`` makes one from a JAX snapshot.

A multi-process PQL run (``parallel/``) writes one full-state file per rank,
``<dir>/state.rank<r>-of-<W>.pt``, each holding that rank's env slice, ring
and n-step FIFO beside the replicated weights, optimizers, normalizer,
trackers and generator; every rank waits for the others' saves. It resumes
on the same world size only: each rank reads its own file, and the ranks
check that they found their files and restored the same counters.

A file is written beside its final name and renamed into place, so a run
stopped during a save keeps the previous checkpoint. Files hold tensors,
numbers and dicts only and are read with ``weights_only=True``.
"""

from __future__ import annotations

import os

import torch

from pql_tpu_torch.parallel.distributed import host_barrier, rank, same_on_all_ranks, world_size

STATE_FILE = "state.pt"
SNAPSHOT_FILE = "snapshot.pt"
_MODULES = ("actor", "critic", "actor_target", "critic_target", "nets")  # a state may hold None for a target
_OPTIMIZERS = ("actor_opt", "critic_opt", "alpha_opt", "opts")  # opts: a dict of optimizers
_NORMS = ("obs_rms", "value_rms", "value_rms_left", "value_rms_tot")
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


def _sd(x) -> dict:
    """A module's or optimizer's ``state_dict``, or a dict of them."""
    return {k: v.state_dict() for k, v in x.items()} if isinstance(x, dict) else x.state_dict()


def _load_sd(x, sd: dict) -> None:
    if not isinstance(x, dict):
        x.load_state_dict(sd)
        return
    if set(sd) != set(x):
        raise ValueError(f"checkpoint holds {sorted(sd)}, this state {sorted(x)}")
    for k, v in x.items():
        v.load_state_dict(sd[k])


def state_dict(state) -> dict:
    """Everything of a ``PQLState``, ``OffPolicyState``, ``SACState``,
    ``IDDPGState``, ``PPOState`` or ``IPPOState`` as tensors, numbers and dicts (the live
    tensors, not copies)."""
    sd = {n: _sd(getattr(state, n)) for n in _present(state, _MODULES + _OPTIMIZERS)}
    sd.update({n: _rms(getattr(state, n)) for n in _present(state, _NORMS)})
    sd.update(
        env_state=dict(state=dict(state.env_state.state), time=state.env_state.time),
        obs=state.obs,
        gen=state.gen.get_state(),
        counters={k: getattr(state, k) for k in _COUNTERS if hasattr(state, k)},
    )
    if hasattr(state, "dones"):  # on-policy
        sd["dones"] = state.dones
    if hasattr(state, "replay"):  # off-policy
        sd.update(nstep=dict({k: getattr(state.nstep, k) for k in _NSTEP}, count=state.nstep.count),
                  replay=dict(data=state.replay.data, ptr=state.replay.ptr, total_writes=state.replay.total_writes))
    if hasattr(state, "stats"):  # an EpisodeStats
        sd["stats"] = state.stats.state_dict()
    else:
        sd.update(cur_returns=state.cur_returns, cur_lengths=state.cur_lengths,
                  trackers={n: dict(ring=getattr(state, n).ring, ptr=getattr(state, n).ptr,
                                    count=getattr(state, n).count) for n in _present(state, _TRACKERS)})
    if getattr(state, "log_alpha", None) is not None:
        sd["log_alpha"] = state.log_alpha.detach()
    return sd


@torch.no_grad()
def load_state_dict(state, sd: dict):
    """Write a ``state_dict`` into a state built for the same config, on its
    device. Modules, optimizers, ``log_alpha``, the normalizers, the replay
    ring and the trackers are written in place; the env state, obs, dones,
    n-step FIFO and accumulators become new tensors (a graphed task copies
    its inputs into its graph's buffers on every step)."""
    dev = state.obs.device
    kinds = _MODULES + _OPTIMIZERS
    held = _present(state, kinds)
    if set(held) != set(sd) & set(kinds):
        raise ValueError(f"checkpoint holds {sorted(set(sd) & set(kinds))}, this state {sorted(held)}")
    for name in held:
        _load_sd(getattr(state, name), sd[name])
    if "log_alpha" in sd:
        state.log_alpha.copy_(sd["log_alpha"])
    for name in _present(state, _NORMS):
        for k, v in sd[name].items():
            getattr(getattr(state, name), k).copy_(v)
    state.env_state.state = {k: v.to(dev) for k, v in sd["env_state"]["state"].items()}
    state.env_state.time = sd["env_state"]["time"].to(dev)
    state.obs = sd["obs"].to(dev)
    if "dones" in sd:
        state.dones = sd["dones"].to(dev)
    if "replay" in sd:
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


def state_file() -> str:
    """This process's full-state file name: ``state.pt``, or one per rank."""
    w = world_size()
    return STATE_FILE if w == 1 else f"state.rank{rank()}-of-{w}.pt"


def save_checkpoint(path: str, state) -> None:
    """The full state into ``path/state.pt`` (``state_file()`` on several ranks)."""
    _save(state_dict(state), path, state_file())
    host_barrier()


def load_checkpoint(path: str, state):
    """Restore ``path`` (a directory from ``save_checkpoint``) into ``state``."""
    state = load_state_dict(state, _load(path, state_file()))
    counters = [getattr(state, k) for k in _COUNTERS if hasattr(state, k)]
    if not same_on_all_ranks(counters, state.obs.device):
        raise ValueError(f"the ranks' checkpoints in {path} hold different counters (a save cut between ranks)")
    return state


def maybe_resume_full_state(cfg, state):
    """Preemption recovery: if ``cfg.checkpoint_dir/state`` holds a full
    checkpoint, restore it into the freshly built ``state`` and return
    (state, True); else (state, False)."""
    if not cfg.checkpoint_dir:
        return state, False
    path = os.path.join(cfg.checkpoint_dir, "state")
    found = os.path.exists(os.path.join(path, state_file()))
    if not same_on_all_ranks([int(found)], state.obs.device):
        raise ValueError(f"{path} holds the full-state files of some ranks only (this run: {world_size()} ranks)")
    if not found:
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
def restore_into_state(state, snapshot: dict, parts=None):
    """Weights-only resume: ``parts``, the modules the agent saves as the
    snapshot's actor and critic (its ``snapshot_parts(state)``; by default
    the state's actor and critic), and the targets the state has take
    ``actor`` and ``critic``; the obs normalizer its own; optimizers and all
    else stay fresh (reference train_baselines.py:33-37,
    pql_v_learner.py:44-45)."""
    rms = snapshot.get("obs_rms")
    if rms is not None:
        for k in ("mean", "var", "count"):
            getattr(state.obs_rms, k).copy_(torch.as_tensor(rms[k]))
    for name, module in zip(("actor", "critic"), parts or (state.actor, state.critic)):
        if name in snapshot:
            for m in (module, getattr(state, f"{name}_target", None)):
                if m is not None:
                    _load_weights(m, snapshot[name])
    return state
