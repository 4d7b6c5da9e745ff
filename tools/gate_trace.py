#!/usr/bin/env python3
"""Eval-return traces of the Cartpole learning gates, per seed.

    python3 tools/gate_trace.py --package=port --device=cuda --seeds 0 1 2 3 4
    python3 tools/gate_trace.py --package=port --device=cpu --algo=pql_d --seeds 0 1 2
    python3 tools/gate_trace.py --package=jax --algo=ddpg --iters=250 --seeds 0 1 2   # the JAX package, on the CPU

The configurations are the JAX package's gates (``chip_smoke.GATES``):
PQL and PQL-D on Cartpole with 256 envs, 32 eval envs, batch 1024, memory
2e5, warm-up 16 (tests/test_learning.py:37-59; the JAX PQL on a one-device
mesh), read at iteration 150; DDPG with 64 envs, 32 eval envs, batch 512,
memory 1e5, warm-up 32, 8 updates per iteration (tests/test_learning.py:
67-84), read at iteration 250. Every ``--every`` iterations up to
``--iters`` it prints one JSON line: package, algo, device, seed,
iteration, seconds since warm-up, train/return and the deterministic
policy's eval/return and eval/episode_length (eval draws from seed 123 in
both packages, each with its own generator).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import GATES  # noqa: E402


def trace_port(algo: str, seed: int, device: str, iters: int, every: int):
    import torch
    from pql_tpu_torch.algos import get_algo
    from pql_tpu_torch.cfg import make_config
    from pql_tpu_torch.envs import make_eval_env
    from pql_tpu_torch.utils.evaluator import Evaluator

    cfg = make_config(algo, seed=seed, **GATES[algo][0])
    agent = get_algo(cfg.algo.name)(cfg, device=device)
    state, _ = agent.warmup(agent.init())
    ev = Evaluator(cfg, make_eval_env(cfg), agent.eval_actor_apply, device)
    t0 = time.perf_counter()
    for it in range(1, iters + 1):
        state, m = agent.train_iter(state)
        if it % every == 0:
            r = ev.eval_policy(state.actor, state.obs_rms, torch.Generator(device=device).manual_seed(123))
            yield it, time.perf_counter() - t0, float(m["train/return"]), r


def trace_jax(algo: str, seed: int, iters: int, every: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pql_tpu.algos import get_algo
    from pql_tpu.cfg import make_config
    from pql_tpu.envs import make_env, make_eval_env
    from pql_tpu.parallel import make_mesh
    from pql_tpu.utils.evaluator import Evaluator

    cfg = make_config(algo, seed=seed, **GATES[algo][0])
    if cfg.algo.name == "PQL":
        agent = get_algo("PQL")(cfg, mesh=make_mesh(1))
    else:
        agent = get_algo(cfg.algo.name)(cfg, make_env(cfg))
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
    ap.add_argument("--algo", choices=sorted(GATES), default="pql")
    ap.add_argument("--device", default="cuda", help="the port's device (the JAX package runs on the CPU)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--iters", type=int, default=None, help="default: the gate's iterations + 50")
    ap.add_argument("--every", type=int, default=25)
    args = ap.parse_args(argv)
    device = "cpu" if args.package == "jax" else args.device
    iters = args.iters or GATES[args.algo][1] + 50
    for seed in args.seeds:
        steps = (trace_jax(args.algo, seed, iters, args.every) if args.package == "jax"
                 else trace_port(args.algo, seed, device, iters, args.every))
        for it, secs, train_ret, r in steps:
            print(json.dumps(dict(package=args.package, algo=args.algo, device=device, seed=seed, iteration=it,
                                  seconds=secs, train_return=train_ret, **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
