"""Training entry point of the port (scripts/train.py: ``train_pql``, :126-245,
and ``train_baseline``, :260-314, chosen by ``algo.name`` as at :328-331).

    python -m pql_tpu_torch.train algo=pql_d task=Cartpole num_envs=4096 max_time=600
    python -m pql_tpu_torch.train algo=pql_d task=Cartpole num_envs=4096 max_step=20000000 \\
        checkpoint_dir=runs/ckpt logging.out_dir=runs
    python -m pql_tpu_torch.train algo=pql task=Ant num_envs=64 algo.batch_size=256 \\
        algo.memory_size=100000 max_step=20000 --device=cpu
    python -m pql_tpu_torch.train algo=pql_d task=AllegroHand num_envs=16384 \\
        algo.memory_size=2000000 max_time=600
    python -m pql_tpu_torch.train algo=ddpg task=Cartpole num_envs=16 algo.batch_size=1024 \\
        algo.memory_size=1000000 max_time=600
    python -m pql_tpu_torch.train algo=sac task=Ant num_envs=4096 max_time=600   # or algo=crossq
    python -m pql_tpu_torch.train algo=ppo task=Ant task_param=true max_time=600
    python -m pql_tpu_torch.train algo=ippo task=BimanualReacher num_envs=4096 max_time=600   # or algo=mappo
    python -m pql_tpu_torch.train algo=iddpg task=BimanualReacher num_envs=4096 max_time=600
    python -m pql_tpu_torch.train algo=iart task=BimanualReacher num_envs=4096 max_time=600
        # or algo=qtotv1, qtotv2, ippoteam, ippoteam2
    python -m pql_tpu_torch.train algo=eq task=BimanualReacher num_envs=4096 max_time=600
        # or algo=eqs, eqg, eqsc, eqsdata, eqs4, mp
    python -m pql_tpu_torch.train algo=eqsd task=BimanualReacher num_envs=4096 algo.diffusion=true max_time=600
        # or algo=eqsd without algo.diffusion, or algo=eqsd2
    python -m pql_tpu_torch.train algo=ppov task=ReacherVision num_envs=4096 max_time=600
    python -m pql_tpu_torch.train algo=ippov task=BimanualReacherVision num_envs=4096 max_time=600

A PQL run, as the JAX package's:

- startup: ``artifact=`` starts from a weights-only snapshot; then, if
  ``checkpoint_dir/state`` holds a full checkpoint, the run resumes from it
  (no warm-up, the iteration and step counters continue) and says so on
  stdout; else ``warm_up`` steps of uniform actions;
- ``train_block`` calls until ``max_step`` total env steps (if set) or
  ``max_time`` seconds, counted on the host;
- every ``algo.log_freq`` iterations a metrics record with
  ``speed/env_steps``, ``speed/critic_updates``, ``speed/actor_updates`` and
  the measured ``speed/env_steps_per_s``;
- every ``algo.eval_freq`` iterations an eval of ``eval_num_envs`` envs,
  dispatched on a snapshot of the actor, critic and normalizer cloned at
  dispatch and resolved at the next eval (or at the end); a new best
  ``eval/return`` saves that snapshot to ``run_dir/best_model``. With
  ``algo.adaptive_ratios`` each eval return feeds the ratio controller;
- every ``checkpoint_freq`` iterations (500 if unset) a full checkpoint to
  ``checkpoint_dir/state``, when ``checkpoint_dir`` is set;
- with ``profile_dir``, a ``torch.profiler`` Chrome trace of
  ``profile_iters`` iterations from iteration 2 on.

A DDPG, SAC, CrossQ, IDDPG, PPO, IPPO, MAPPO, QTOTV1, QTOTV2, IART,
IPPOTeam, IPPOTeam2, EQ, EQS, EQG, EQSC, EQSdata, EQS4, MP, EQSD, EQSD2, PPOV
or IPPOV run (``train_baseline``), as the JAX package's: the
same start (artifact, full-state resume, else the warm-up of an agent that
has one: the off-policy agents; the on-policy agents have none), then one
``train_iter`` per iteration until the stop check; every ``algo.log_freq``
iterations a metrics record with the measured ``speed/env_steps_per_s``;
every ``algo.eval_freq`` iterations an eval run at once on the live actor
(a two-agent agent's: all its networks) and normalizer, a new best
``eval/return`` saving them and the critics to ``run_dir/best_model``; the periodic full checkpoint
as above. ``env_steps`` counts total env steps.

Records go to ``logging.out_dir/run_name/metrics.jsonl`` and the console
(``utils/logging.py``). The run is on the card unless ``--device=cpu`` (or
``platform=cpu``; a ``platform`` that contradicts ``--device`` is an
error). An fp32 config turns TF32 off for cuBLAS and cuDNN, and cuDNN
runs deterministic algorithms (``algos/base.py::set_precision``).
"""

from __future__ import annotations

import copy
import os
import sys
import time

import torch

from pql_tpu_torch.algos import get_algo
from pql_tpu_torch.algos.base import set_precision
from pql_tpu_torch.algos.pql import PQL
from pql_tpu_torch.cfg import parse_cli, platform_device, to_dict
from pql_tpu_torch.envs import make_eval_env
from pql_tpu_torch.utils.checkpoint import (
    load_model_snapshot,
    maybe_resume_full_state,
    restore_into_state,
    save_checkpoint,
    save_model_snapshot,
)
from pql_tpu_torch.utils.evaluator import Evaluator
from pql_tpu_torch.utils.logging import RunLogger
from pql_tpu_torch.utils.ratio_control import RatioController

EVAL_SEED_OFFSET = 1  # the eval draws' generator: seed + 1, apart from the loop's


class _Every:
    """Fire once whenever the iteration counter crosses a multiple of
    ``freq``, for any iteration stride (a ``%`` gate with ``it +=
    iters_per_call`` fires only every lcm(iters_per_call, freq) iterations,
    and never again from a misaligned resumed counter)."""

    def __init__(self, freq: int, it0: int = 0):
        self.freq = max(int(freq), 1)
        self.bucket = it0 // self.freq

    def __call__(self, it: int) -> bool:
        bucket = it // self.freq
        if bucket > self.bucket:
            self.bucket = bucket
            return True
        return False


def _resumed_iter(cfg, state, resumed: bool, has_warmup: bool = True, per_env: bool = False) -> int:
    """Outer-loop iteration count implied by a resumed env_steps counter,
    excluding warm-up (``warm_up`` sim steps × num_envs). ``per_env``: the
    counter holds steps per env (PQL)."""
    if not resumed:
        return 0
    envs = 1 if per_env else cfg.num_envs
    warm_steps = (getattr(cfg.algo, "warm_up", 0) if has_warmup else 0) * envs
    steps_per_iter = cfg.algo.horizon_len * envs
    return max(0, int(state.env_steps) - warm_steps) // steps_per_iter


def _checkpoint_gate(cfg, it0: int) -> _Every:
    """checkpoint_dir without a checkpoint_freq saves every 500 iterations:
    a directory that never receives a state cannot resume."""
    return _Every(cfg.checkpoint_freq or 500, it0)


def _maybe_full_checkpoint(cfg, gate: _Every, it: int, state) -> None:
    """The periodic full-state checkpoint, when checkpoint_dir is set."""
    if cfg.checkpoint_dir and gate(it):
        save_checkpoint(os.path.join(cfg.checkpoint_dir, "state"), state)


class _ProfilerHook:
    """A torch.profiler Chrome trace of ``profile_iters`` iterations from
    iteration 2 on, into ``profile_dir/trace.json``; once per run."""

    def __init__(self, cfg, device: torch.device):
        self.cfg = cfg
        self.activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            self.activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = None
        self.count = 0
        self.done = False

    def tick(self, it: int) -> None:
        if not self.cfg.profile_dir or self.done:
            return
        if self.prof is None and it >= 2:
            self.prof = torch.profiler.profile(activities=self.activities)
            self.prof.start()
        elif self.prof is not None:
            self.count += 1
            if self.count >= self.cfg.profile_iters:
                self.close()

    def close(self) -> None:
        """Write a trace still open when the run ends before profile_iters ticks."""
        if self.prof is None:
            return
        self.prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(self.cfg.profile_dir, "trace.json"))
        self.prof, self.done = None, True


def train_pql(cfg, logger: RunLogger, device: str | torch.device = "cuda"):
    """The PQL loop; returns the agent and its final state."""
    agent = PQL(cfg, device)
    dev = agent.device
    state, resumed, evaluator, eval_gen = _start(cfg, agent, agent.init(), dev)
    if resumed:
        print(f"resumed the full state from {os.path.join(cfg.checkpoint_dir, 'state')} at env step "
              f"{state.env_steps * cfg.num_envs} (no warm-up)", flush=True)
    else:
        state, _ = agent.warmup(state)

    ratio_ctl = None
    if cfg.algo.adaptive_ratios:
        ratio_ctl = RatioController(
            int(cfg.algo.critic_sample_ratio),
            cfg.algo.critic_actor_ratio,
            window=cfg.algo.adapt_window,
            factor=cfg.algo.adapt_factor,
            max_ratio=cfg.algo.adapt_max_ratio,
        )
        if cfg.algo.adapt_precompile:
            rungs = agent.precompile_ratio_ladder(state, factor=cfg.algo.adapt_factor,
                                                  max_ratio=cfg.algo.adapt_max_ratio)
            logger.log({"adapt/precompiled_rungs": float(len(rungs))}, step=0)

    best_ret = float("-inf")
    # one eval in flight at a time: (handle, dispatch step, snapshot), resolved
    # at the next eval event. The snapshot is cloned at dispatch: the
    # optimizers update the live parameters in place.
    pending_eval = None

    def _flush_eval():
        nonlocal pending_eval, best_ret
        if pending_eval is None:
            return
        handle, ev_step, (snap_actor, snap_critic, snap_rms) = pending_eval
        pending_eval = None
        eval_metrics = Evaluator.resolve(handle)
        if ratio_ctl is not None:
            new_ratios = ratio_ctl.update(eval_metrics["eval/return"])
            if new_ratios is not None:
                agent.set_ratios(*new_ratios)
                eval_metrics["train/critic_sample_ratio"] = new_ratios[0]
        logger.log(eval_metrics, step=ev_step)
        if eval_metrics["eval/return"] > best_ret and logger.run_dir:
            best_ret = eval_metrics["eval/return"]
            best_dir = os.path.join(logger.run_dir, "best_model")
            save_model_snapshot(best_dir, snap_actor, snap_critic, snap_rms)
            logger.log_artifact(best_dir, f"{cfg.task}_{cfg.algo.name}_model")

    it = _resumed_iter(cfg, state, resumed, per_env=True)
    log_gate = _Every(cfg.algo.log_freq, it)
    eval_gate = _Every(cfg.algo.eval_freq, it)
    ckpt_gate = _checkpoint_gate(cfg, it)
    last_log, last_steps = time.time(), state.env_steps * cfg.num_envs
    profiler = _ProfilerHook(cfg, dev)
    try:
        while True:
            state, metrics = agent.train_block(state)
            it += agent.iters_per_call
            # env_steps (per env) and the update counters are Python integers:
            # the host-side step counter, so the gates and the stop check never
            # wait for the device
            steps = state.env_steps * cfg.num_envs
            profiler.tick(it)
            if log_gate(it):
                host = {k: float(v) for k, v in metrics.items()}
                host["speed/env_steps"] = steps
                host["speed/critic_updates"] = state.critic_update_count
                host["speed/actor_updates"] = state.actor_update_count
                # measured rate: Δ(counter)/Δt, never inferred from frequencies
                now = time.time()
                host["speed/env_steps_per_s"] = (steps - last_steps) / max(now - last_log, 1e-9)
                last_log, last_steps = now, steps
                logger.log(host, step=steps)
            if eval_gate(it):
                _flush_eval()  # resolve the previous eval
                snap = (copy.deepcopy(state.actor), copy.deepcopy(state.critic), copy.deepcopy(state.obs_rms))
                handle = evaluator.eval_policy_async(snap[0], snap[2], eval_gen)
                pending_eval = (handle, steps, snap)
            _maybe_full_checkpoint(cfg, ckpt_gate, it, state)
            if evaluator.check_if_should_stop(steps):
                _flush_eval()  # drain the eval in flight before exiting
                break
    finally:
        profiler.close()
    return agent, state


def _start(cfg, agent, state, dev):
    """Artifact, then full-state resume, then warm-up unless resumed; the
    evaluator and its generator. Returns (state, resumed, evaluator, eval_gen)."""
    if cfg.artifact:  # weights-only start (reference model_util.py:9-21)
        state = restore_into_state(state, load_model_snapshot(cfg.artifact), agent.snapshot_parts(state))
    state, resumed = maybe_resume_full_state(cfg, state)
    evaluator = Evaluator(cfg, make_eval_env(cfg), agent.eval_actor_apply, dev)
    eval_gen = torch.Generator(device=dev).manual_seed(cfg.seed + EVAL_SEED_OFFSET)
    return state, resumed, evaluator, eval_gen


def train_baseline(cfg, logger: RunLogger, device: str | torch.device = "cuda"):
    """The synchronous loop of every agent but PQL (scripts/train.py:260-314);
    returns the agent and its final state."""
    agent = get_algo(cfg.algo.name)(cfg, device)
    dev = agent.device
    has_warmup = hasattr(agent, "warmup")
    state, resumed, evaluator, eval_gen = _start(cfg, agent, agent.init(), dev)
    if resumed:
        print(f"resumed the full state from {os.path.join(cfg.checkpoint_dir, 'state')} at env step "
              f"{state.env_steps} (no warm-up)", flush=True)
    elif has_warmup:
        state, _ = agent.warmup(state)

    best_ret = float("-inf")
    it = _resumed_iter(cfg, state, resumed, has_warmup=has_warmup)  # env_steps counts total env steps
    log_gate = _Every(cfg.algo.log_freq, it)
    eval_gate = _Every(cfg.algo.eval_freq, it)
    ckpt_gate = _checkpoint_gate(cfg, it)
    last_log, last_steps = time.time(), state.env_steps
    profiler = _ProfilerHook(cfg, dev)
    try:
        while True:
            state, metrics = agent.train_iter(state)
            it += 1
            steps = state.env_steps  # a Python integer: the gates never wait for the device
            profiler.tick(it)
            if log_gate(it):
                host = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                host["speed/env_steps_per_s"] = (steps - last_steps) / max(now - last_log, 1e-9)
                last_log, last_steps = now, steps
                logger.log(host, step=steps)
            if eval_gate(it):  # synchronous, on the live actor and normalizer
                eval_metrics = evaluator.eval_policy(agent.eval_params(state), state.obs_rms, eval_gen)
                logger.log(eval_metrics, step=steps)
                if eval_metrics["eval/return"] > best_ret and logger.run_dir:
                    best_ret = eval_metrics["eval/return"]
                    save_model_snapshot(os.path.join(logger.run_dir, "best_model"),
                                        *agent.snapshot_parts(state), state.obs_rms)
            _maybe_full_checkpoint(cfg, ckpt_gate, it, state)
            if evaluator.check_if_should_stop(steps):
                break
    finally:
        profiler.close()
    return agent, state


def main(argv: list[str]) -> None:
    device, overrides = None, []
    for arg in argv:
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            overrides.append(arg)
    cfg = parse_cli(overrides)
    by_platform = platform_device(cfg.platform)
    if by_platform is not None and device is not None and torch.device(device).type != by_platform:
        raise SystemExit(f"platform={cfg.platform} contradicts --device={device}")
    device = device or by_platform or "cuda"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device found (pass --device=cpu to run on the CPU)")
    get_algo(cfg.algo.name)  # an unported algo.name fails before the run directory is made
    set_precision(cfg)
    train = train_pql if cfg.algo.name == "PQL" else train_baseline
    logger = RunLogger(cfg, to_dict(cfg))
    try:
        train(cfg, logger, device)
    finally:
        logger.close()


if __name__ == "__main__":
    main(sys.argv[1:])
