"""Update-ratio sweep (port of scripts/ratio_sweep.py).

PQL's critic:sim and critic:actor update ratios are exact integers of the
iteration (``critic_sample_ratio`` × ``horizon_len`` critic updates and
``critic_sample_ratio // critic_actor_ratio`` × ``horizon_len`` actor updates);
the reference's feedback controller adapts them at runtime (reference
scripts/train_pql.py:127-158). This script sweeps ratio points (the JAX
package's BASELINE config 4: "AllegroHand PQL, 8192 envs, actor/critic
update-ratio sweep") and reports, per point:

- env-steps/s (the throughput cost of heavier learner phases),
- critic/actor updates per second,
- the train-return learning slope over the window,
- final train + eval return.

    python -m pql_tpu_torch.ratio_sweep task=AllegroHand num_envs=8192 \\
        sweep=8:2,4:2,16:2,8:4,2:1 seconds_per_point=240 \\
        out=runs/ratio_sweep_allegro.json [--device=cpu]

Any other key=value pairs are forwarded to the config CLI. Each point builds
a fresh PQL agent with the point's ratios (where the JAX package re-jits),
warms it up, runs one settling ``train_block``, then times ``train_block``
calls for ``seconds_per_point`` seconds on the host clock. The three rates
are deltas over that window: the env steps (the per-env counter, as in the
JAX script), the critic and the actor updates. The policy is evaluated once at the end of the point,
from a generator seeded ``seed + 1`` (the port's rule for eval draws; the
JAX script uses key 1) on one eval env that the points share (on the card
its graph is captured once). One JSON line per point, the same keys as the JAX
script's, and with ``out=`` the same table file. Runs on the card unless
``--device=cpu``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from pql_tpu_torch.algos.base import set_precision
from pql_tpu_torch.algos.pql import PQL
from pql_tpu_torch.cfg import entry_device, parse_cli, require_card
from pql_tpu_torch.envs import make_eval_env
from pql_tpu_torch.utils.evaluator import EVAL_SEED_OFFSET, Evaluator


def run_point(cfg, critic_sample_ratio: int, critic_actor_ratio: int, seconds: float,
              device: str | torch.device = "cuda", eval_env=None) -> tuple[dict, dict]:
    """One ratio point: (its JSON record, the window's counts: iterations,
    env steps per env, critic and actor updates, seconds; and the seconds
    of the point's setup (agent, warm-up, settling block) and of its eval).
    ``eval_env``: the eval
    env (``make_eval_env(cfg)`` if None), which a sweep shares over its
    points so that a task on the card captures its eval graph once."""
    cfg.algo.critic_sample_ratio = critic_sample_ratio
    cfg.algo.critic_actor_ratio = critic_actor_ratio
    t_setup = time.perf_counter()
    agent = PQL(cfg, device)  # a fresh agent with the point's ratios
    state = agent.init()
    state, _ = agent.warmup(state)

    # settle
    state, metrics = agent.train_block(state)
    float(metrics["train/return"])  # waits for the device
    setup_s = time.perf_counter() - t_setup

    returns: list[tuple[float, float]] = []  # (t, train_return)
    t0 = time.perf_counter()
    # all three rates are deltas over the same timed window (warm-up and
    # settle excluded); env_steps counts steps per env
    steps0 = state.env_steps
    cri0, act0, calls = state.critic_update_count, state.actor_update_count, 0
    while time.perf_counter() - t0 < seconds:
        state, metrics = agent.train_block(state)
        calls += 1
        returns.append((time.perf_counter() - t0, float(metrics["train/return"])))
    dt = time.perf_counter() - t0
    steps = state.env_steps - steps0
    critic_updates = state.critic_update_count - cri0
    actor_updates = state.actor_update_count - act0

    t_eval = time.perf_counter()
    evaluator = Evaluator(cfg, eval_env or make_eval_env(cfg), agent.eval_actor_apply, agent.device)
    gen = torch.Generator(device=agent.device).manual_seed(cfg.seed + EVAL_SEED_OFFSET)
    eval_metrics = evaluator.eval_policy(agent.eval_params(state), state.obs_rms, gen)
    eval_s = time.perf_counter() - t_eval

    # learning slope: least-squares fit of train_return over the window
    slope = 0.0
    if len(returns) >= 2:
        t = np.array([r[0] for r in returns])
        y = np.array([r[1] for r in returns])
        slope = float(np.polyfit(t, y, 1)[0])

    record = {
        "critic_sample_ratio": critic_sample_ratio,
        "critic_actor_ratio": critic_actor_ratio,
        "seconds": round(dt, 1),
        "env_steps_per_s": round(steps / dt, 1),
        "critic_updates_per_s": round(critic_updates / dt, 1),
        "actor_updates_per_s": round(actor_updates / dt, 1),
        "train_return_final": returns[-1][1] if returns else None,
        "train_return_slope_per_s": round(slope, 4),
        "eval_return": float(eval_metrics["eval/return"]),
    }
    window = dict(iterations=calls * agent.iters_per_call, env_steps=steps, critic_updates=critic_updates,
                  actor_updates=actor_updates, seconds=dt, setup_s=setup_s, eval_s=eval_s)
    return record, window


def main(argv: list[str]) -> list[dict]:
    sweep = "8:2,4:2,16:2,8:4,8:1"
    seconds = 240.0
    out = None
    device = None
    rest = []
    for a in argv:
        if a.startswith("sweep="):
            sweep = a.split("=", 1)[1]
        elif a.startswith("seconds_per_point="):
            seconds = float(a.split("=", 1)[1])
        elif a.startswith("out="):
            out = a.split("=", 1)[1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    cfg = parse_cli(rest)
    cfg.logging.mode = "off"
    device = torch.device(entry_device(cfg, device))
    require_card(device)
    set_precision(cfg)

    points = []
    for spec in sweep.split(","):
        cs, ca = spec.split(":")
        points.append((int(cs), int(ca)))

    results, eval_env = [], make_eval_env(cfg)
    for cs, ca in points:
        print(f"--- ratio point critic:sim={cs} critic:actor={ca} ---", flush=True)
        r, _ = run_point(cfg, cs, ca, seconds, device, eval_env)
        print(json.dumps(r), flush=True)
        results.append(r)

    table = {
        "task": cfg.task,
        "num_envs": cfg.num_envs,
        "batch_size": cfg.algo.batch_size,
        "seconds_per_point": seconds,
        "points": results,
    }
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(table, f, indent=2)
        print(f"wrote {out}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
