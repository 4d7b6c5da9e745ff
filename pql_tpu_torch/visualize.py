"""Roll a trained policy and report its return (port of scripts/visualize.py:
load the actor and the obs normalizer from a saved model snapshot, run
episode batches, print the return).

    python -m pql_tpu_torch.visualize algo=pql task=Cartpole \\
        artifact=runs/<run>/best_model num_envs=16 episodes=3 [--device=cpu]

There is no on-screen viewer: "visualization" is a batched deterministic
rollout with per-episode statistics, as in the JAX package. The agent is
built as ``train.py`` builds it, the snapshot (a ``best_model`` directory
that ``train.main`` wrote, or its file) restored into its fresh state, and
each episode batch is one ``Evaluator`` rollout of ``num_envs`` envs whose
draws come from one generator seeded ``seed + 1``, the port's rule for
eval draws. Runs on the card unless ``--device=cpu`` (or ``platform=cpu``).
"""

from __future__ import annotations

import sys

import torch

from pql_tpu_torch.algos import get_algo
from pql_tpu_torch.algos.base import set_precision
from pql_tpu_torch.cfg import Config, entry_device, parse_cli, require_card
from pql_tpu_torch.envs import make_env
from pql_tpu_torch.utils.checkpoint import load_model_snapshot, restore_into_state
from pql_tpu_torch.utils.evaluator import EVAL_SEED_OFFSET, Evaluator


def main(argv: list[str]) -> list[dict[str, float]]:
    """Print one line per episode batch; returns their eval metrics."""
    episodes, device, rest = 1, None, []
    for arg in argv:
        if arg.startswith("episodes="):
            episodes = int(arg.split("=", 1)[1])
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    cfg = parse_cli(rest, base=Config(num_envs=16, eval_num_envs=16))
    if not cfg.artifact:
        raise SystemExit("pass artifact=<path to a saved model snapshot>")
    device = torch.device(entry_device(cfg, device))
    require_card(device)
    set_precision(cfg)

    agent = get_algo(cfg.algo.name)(cfg, device)
    state = agent.init()
    state = restore_into_state(state, load_model_snapshot(cfg.artifact), agent.snapshot_parts(state))

    evaluator = Evaluator(cfg, make_env(cfg), agent.eval_actor_apply, device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed + EVAL_SEED_OFFSET)
    out = []
    for ep in range(episodes):
        metrics = evaluator.eval_policy(agent.eval_params(state), state.obs_rms, gen)
        print(
            f"episode batch {ep}: return={metrics['eval/return']:.2f} "
            f"length={metrics['eval/episode_length']:.1f}",
            flush=True,
        )
        out.append(metrics)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
