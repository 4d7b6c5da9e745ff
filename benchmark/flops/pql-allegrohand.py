"""Model FLOPs of one PQL iteration (Double-Q critic, tanh actor), from the
networks' shapes: GEMMs only (elementwise work, the physics and the replay
are not model FLOPs).

- sim: the actor on E rows, ``horizon_len`` times;
- each critic update at batch B: the actor and both target heads on the
  next obs (no gradient), both online heads forward and backward (weight
  gradients; input gradients below the first layer);
- each actor update: the actor and both heads forward, the heads' input
  gradients (no weight gradients: only the actor is updated), the actor's
  weight gradients.
"""

from __future__ import annotations

import importlib.util
import os

_spec = importlib.util.spec_from_file_location("bench_flops_mlp", os.path.join(os.path.dirname(__file__), "mlp.py"))
mlp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mlp)


def counts(config: dict, traffic: dict) -> dict:
    a = {**config["args"], **traffic["args"]}
    h = int(a["algo.horizon_len"])
    ratio = int(a["algo.critic_sample_ratio"])
    return dict(E=int(a["num_envs"]), H=h, B=int(a["algo.batch_size"]), n_critic=ratio * h,
                n_actor=max(ratio // int(a["algo.critic_actor_ratio"]), 1) * h)


def flops_per_iter(config: dict, traffic: dict) -> float:
    c = counts(config, traffic)
    obs, act, hidden = config["obs_dim"], config["action_dim"], config["hidden"]
    actor = [obs, *hidden, act]
    head = [obs + act, *hidden, 1]
    B = c["B"]
    sim = c["H"] * mlp.forward(actor, c["E"])
    critic_update = (mlp.forward(actor, B) + 2 * mlp.forward(head, B)
                     + 2 * (mlp.forward(head, B) + mlp.backward(head, B)))
    actor_update = (mlp.forward(actor, B) + 2 * mlp.forward(head, B)
                    + 2 * mlp.backward(head, B, weights=False, input_grad=True) + mlp.backward(actor, B))
    return float(sim + c["n_critic"] * critic_update + c["n_actor"] * actor_update)
