"""Training entry point of the port (mirrors scripts/train.py::train_pql).

    python -m pql_tpu_torch.train algo=pql_d task=Cartpole num_envs=4096 max_time=600
    python -m pql_tpu_torch.train algo=pql task=Cartpole max_step=2000000 --device=cuda
    python -m pql_tpu_torch.train algo=pql task=Ant num_envs=64 algo.batch_size=256 \
        algo.memory_size=100000 max_step=20000 --device=cpu
    python -m pql_tpu_torch.train algo=pql_d task=AllegroHand num_envs=16384 \
        algo.memory_size=2000000 max_time=600
    python -m pql_tpu_torch.train algo=pql task=AllegroHand num_envs=64 algo.batch_size=256 \
        algo.memory_size=100000 max_step=20000 --device=cpu

Warm-up, then ``train_block`` calls until ``max_step`` total env steps (if
set) or ``max_time`` seconds, with one JSON line of metrics on stdout every
``algo.log_freq`` iterations, including ``speed/env_steps``,
``speed/critic_updates``, ``speed/actor_updates`` and the measured
``speed/env_steps_per_s``. The evaluator, checkpoints, best-model
snapshots and logger sinks are not ported yet.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from pql_tpu_torch.algos.pql import PQL
from pql_tpu_torch.cfg import parse_cli


def train_pql(cfg, device: str = "cuda") -> None:
    agent = PQL(cfg, device)
    state = agent.init()
    state, _ = agent.warmup(state)
    start = time.time()
    it, log_bucket = 0, 0
    last_log, last_steps = start, state.env_steps * cfg.num_envs
    log_freq = max(int(cfg.algo.log_freq), 1)
    while True:
        state, metrics = agent.train_block(state)
        it += agent.iters_per_call
        steps = state.env_steps * cfg.num_envs  # per-env counter × envs, as in the JAX loop
        if it // log_freq > log_bucket:  # fires for any iters_per_call stride
            log_bucket = it // log_freq
            rec = {k: float(v) for k, v in metrics.items()}
            now = time.time()
            rec.update({
                "step": steps,
                "time": now - start,
                "speed/env_steps": steps,
                "speed/critic_updates": state.critic_update_count,
                "speed/actor_updates": state.actor_update_count,
                "speed/env_steps_per_s": (steps - last_steps) / max(now - last_log, 1e-9),
            })
            last_log, last_steps = now, steps
            print(json.dumps(rec), flush=True)
        if cfg.max_step is not None:
            if steps > cfg.max_step:
                break
        elif time.time() - start > cfg.max_time:
            break


def main(argv: list[str]) -> None:
    device = "cuda"
    overrides = []
    for arg in argv:
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            overrides.append(arg)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device found (pass --device=cpu to run on the CPU)")
    train_pql(parse_cli(overrides), device)


if __name__ == "__main__":
    main(sys.argv[1:])
