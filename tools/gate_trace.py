#!/usr/bin/env python3
"""Eval-return traces of the Cartpole learning gate, per seed.

    python3 tools/gate_trace.py --package=port --device=cuda --seeds 0 1 2 3 4
    python3 tools/gate_trace.py --package=port --device=cpu --seeds 0 1 2
    python3 tools/gate_trace.py --package=jax --seeds 0 1 2     # the JAX package, on the CPU

The configuration is the gate's (tests/test_learning.py:37-59,
``chip_smoke.LEARNING_GATE``): PQL on Cartpole, 256 envs, 32 eval envs,
batch 1024, memory 2e5, warm-up 16; the JAX package on a one-device mesh.
Every ``--every`` iterations up to ``--iters`` it prints one JSON line:
package, device, seed, iteration, seconds since warm-up, train/return and
the deterministic policy's eval/return and eval/episode_length (eval draws
from seed 123 in both packages, each with its own generator). The gate
itself reads iteration 150.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import LEARNING_GATE  # noqa: E402


def trace_port(seed: int, device: str, iters: int, every: int):
    import torch
    from pql_tpu_torch.algos.pql import PQL
    from pql_tpu_torch.cfg import make_config
    from pql_tpu_torch.envs import make_eval_env
    from pql_tpu_torch.utils.evaluator import Evaluator

    cfg = make_config("pql", seed=seed, **LEARNING_GATE)
    agent = PQL(cfg, device=device)
    state, _ = agent.warmup(agent.init())
    ev = Evaluator(cfg, make_eval_env(cfg), agent.eval_actor_apply, device)
    t0 = time.perf_counter()
    for it in range(1, iters + 1):
        state, m = agent.train_iter(state)
        if it % every == 0:
            r = ev.eval_policy(state.actor, state.obs_rms, torch.Generator(device=device).manual_seed(123))
            yield it, time.perf_counter() - t0, float(m["train/return"]), r


def trace_jax(seed: int, iters: int, every: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pql_tpu.algos.pql import PQL
    from pql_tpu.cfg import make_config
    from pql_tpu.envs import make_eval_env
    from pql_tpu.parallel import make_mesh
    from pql_tpu.utils.evaluator import Evaluator

    cfg = make_config("pql", seed=seed, **LEARNING_GATE)
    agent = PQL(cfg, mesh=make_mesh(1))
    state, _ = agent.warmup(agent.init(jax.random.PRNGKey(seed)))
    ev = Evaluator(cfg, make_eval_env(cfg), agent.eval_actor_apply)
    t0 = time.perf_counter()
    for it in range(1, iters + 1):
        state, m = agent.train_iter(state)
        if it % every == 0:
            r = ev.eval_policy(state.actor_params, state.obs_rms, jax.random.PRNGKey(123))
            yield it, time.perf_counter() - t0, float(m["train/return"]), r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--device", default="cuda", help="the port's device (the JAX package runs on the CPU)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--every", type=int, default=25)
    args = ap.parse_args(argv)
    device = "cpu" if args.package == "jax" else args.device
    for seed in args.seeds:
        steps = (trace_jax(seed, args.iters, args.every) if args.package == "jax"
                 else trace_port(seed, device, args.iters, args.every))
        for it, secs, train_ret, r in steps:
            print(json.dumps(dict(package=args.package, device=device, seed=seed, iteration=it, seconds=secs,
                                  train_return=train_ret, **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
