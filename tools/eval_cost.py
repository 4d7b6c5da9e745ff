#!/usr/bin/env python3
"""Cost of one eval call of the port on a task, at its eval width.

    python3 tools/eval_cost.py --task Ant --calls 2
    python3 tools/eval_cost.py --task Cartpole --device cpu --envs 16

Builds ``algo=pql task=<task>`` with random weights from ``--seed``, an
``Evaluator`` over ``make_eval_env`` (``eval_num_envs`` = ``--envs``) and
times ``--calls`` evals of ``max_episode_length`` steps each: the host time
to enqueue the rollout and the wall time until its floats are read. The
first call of a rigid or hand task on a card also captures the eval env's
CUDA graph, so it is reported apart. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    import torch
    from pql_tpu_torch.algos.pql import PQL
    from pql_tpu_torch.cfg import make_config
    from pql_tpu_torch.envs import make_eval_env
    from pql_tpu_torch.utils.evaluator import Evaluator

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="Ant")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--envs", type=int, default=150)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sync = torch.cuda.synchronize if torch.device(args.device).type == "cuda" else (lambda: None)
    cfg = make_config("pql", task=args.task, eval_num_envs=args.envs, num_envs=args.envs, algo__batch_size=256,
                      algo__memory_size=10 * args.envs)
    agent = PQL(cfg, device=args.device)
    state = agent.init(seed=args.seed)
    ev = Evaluator(cfg, make_eval_env(cfg), agent.eval_actor_apply, args.device)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    calls = []
    for _ in range(args.calls):
        sync()
        t0 = time.perf_counter()
        handle = ev.eval_policy_async(state.actor, state.obs_rms, gen)
        enqueue = time.perf_counter() - t0
        out = Evaluator.resolve(handle)
        calls.append(dict(enqueue_s=enqueue, wall_s=time.perf_counter() - t0, **out))
    card = torch.cuda.get_device_name(0) if torch.device(args.device).type == "cuda" else "cpu"
    print(json.dumps(dict(task=args.task, device=card, eval_envs=args.envs, steps=ev.env.max_episode_length,
                          first_call=calls[0], later_calls=calls[1:])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
