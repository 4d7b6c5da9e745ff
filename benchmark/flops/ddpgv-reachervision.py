"""Model FLOPs of one DDPGV iteration, from the networks' shapes: the
convolutions (2·out·in·k²) and GEMMs (2·rows·in·out) only (normalisations,
pooling, the render and the host ring are not model FLOPs).

The visual actor's forward on one sample: the trunk (ResNet-18 stem, layer1
and layer2) on each of the T frames, the encoder's fc, the PointNet on the
cloud's points, the proprio MLP and the policy head. Its backward, where the
actor is updated, runs through the trunk of frames 1..T−1 only (frame 0
enters under a stopped gradient) and needs no gradient of the images or
of the cloud's coordinates; a recomputed stem is not counted.

- collect: the actor on E samples, ``horizon_len`` times;
- each update at batch B: the actor (no gradient) and both target heads on
  the next sample; both online heads forward and backward; the actor
  forward and backward, through both heads' input gradients.
"""

from __future__ import annotations

import importlib.util
import os

_spec = importlib.util.spec_from_file_location("bench_flops_mlp", os.path.join(os.path.dirname(__file__), "mlp.py"))
mlp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mlp)

STAGES = ((64, 64, 1), (64, 64, 1), (64, 128, 2), (128, 128, 1))  # ResNet-18 layer1 and layer2 blocks


def out_size(n: int, stride: int) -> int:
    return -(-n // stride)


def conv_flops(hw: int, cin: int, cout: int, k: int) -> int:
    """One conv on one sample whose output is hw × hw."""
    return 2 * hw * hw * cout * cin * k * k


def trunk_convs(size: int, channels: int) -> list[tuple[int, int]]:
    """(forward FLOPs, input-gradient FLOPs) of each conv of the trunk on one frame."""
    out = []
    hw = out_size(size, 2)
    stem = conv_flops(hw, channels, 64, 7)
    out.append((stem, 0))  # the frame needs no gradient
    hw = out_size(hw, 2)  # max pool
    for cin, cout, stride in STAGES:
        o = out_size(hw, stride)
        convs = [conv_flops(o, cin, cout, 3), conv_flops(o, cout, cout, 3)]
        if stride != 1 or cin != cout:
            convs.append(conv_flops(o, cin, cout, 1))
        out += [(f, f) for f in convs]
        hw = o
    return out


def actor_flops(config: dict, rows: int, grad: bool) -> int:
    """The visual actor's forward on ``rows`` samples, plus its backward with ``grad``."""
    cams, t, size, _, channels = config["task_constants"]["img_shape"]
    convs = trunk_convs(size, channels)
    hw = out_size(out_size(out_size(size, 2), 2), 2)
    feats = 2 * (t - 1) * hw * hw * 128
    p = config["pointnet"]
    pc_points = config["task_constants"]["link_points"] * 2 + config["task_constants"]["target_points"]
    h = p["h_dim"]
    per_point = [(3, h)] + [(h, h), (2 * h, h)] * p["layers"] + [(h * p["layers"], p["out"])]
    fd, hd = config["feature_dim"], config["hidden_dim"]
    heads = [[feats, config["repr_dim"]], [cams * config["repr_dim"], fd]]
    state_mlp = [config["proprio_dim"], *p["state_mlp"]]
    policy = [fd + p["out"] + p["state_mlp"][-1], hd, hd, config["action_dim"]]
    fwd = rows * (cams * t * sum(f for f, _ in convs) + sum(2 * pc_points * i * o for i, o in per_point))
    fwd += sum(mlp.forward(d, rows) for d in (*heads, state_mlp, policy))
    if not grad:
        return fwd
    # weight gradients of every layer; input gradients of all but the data-fed first ones
    bwd = rows * cams * (t - 1) * sum(f + g for f, g in convs)
    bwd += rows * (sum(2 * pc_points * i * o for i, o in per_point) + sum(2 * pc_points * i * o
                                                                          for i, o in per_point[1:]))
    bwd += mlp.backward(heads[0], rows, input_grad=True) + mlp.backward(heads[1], rows, input_grad=True)
    bwd += mlp.backward(state_mlp, rows) + mlp.backward(policy, rows, input_grad=True)
    return fwd + bwd


def flops_per_iter(config: dict, traffic: dict) -> float:
    a = {**config["args"], **traffic["args"]}
    e, h, b, u = int(a["num_envs"]), int(a["algo.horizon_len"]), int(a["algo.batch_size"]), int(a["algo.update_times"])
    head = [config["obs_dim"] + config["action_dim"], *config["critic_hidden"], 1]
    collect = h * actor_flops(config, e, grad=False)
    update = (actor_flops(config, b, grad=False) + 2 * mlp.forward(head, b)
              + 2 * (mlp.forward(head, b) + mlp.backward(head, b))
              + actor_flops(config, b, grad=True) + 2 * mlp.forward(head, b)
              + 2 * mlp.backward(head, b, weights=False, input_grad=True))
    return float(collect + u * update)
