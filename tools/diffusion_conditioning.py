#!/usr/bin/env python3
"""How sensitive the diffusion and vision tiers' card-vs-CPU checks are to rounding, on the CPU.

    python3 tools/diffusion_conditioning.py --seeds 42 0   # ~1-2 min per seed on 8 cores
    python3 tools/diffusion_conditioning.py --refs vision --seeds 42 0 1 2

Two measurements, each printed as one JSON line:

1. ``reference_runs``: for each of chip_smoke's ``EQSD_REF`` runs
   (``--refs vision``: ``VISION_REF``, the PPOV and IPPOV runs; two
   iterations at its small size, the draws from a generator seeded 1, as
   ``card_vs_cpu`` makes them) at each ``--seeds`` value, the largest change
   of any network's two-iteration step, relative to the step's norm, when
   every initial weight is scaled by (1 + ε·z), z standard normal, for ε in
   ``PERTURBATIONS``. A run whose steps move by more than the card-vs-CPU
   check's 1% under such a change sits on a branch boundary (a PPO clip) and
   cannot tell a fault of the card from rounding.
2. ``sampler`` (``--refs eqsd``): both diffusion policies at full width on
   BimanualReacher's joint reps, 4096 rows, fp32 against float64 on the
   same draws, relative to 1 + |a|: at their init and with every weight
   moved by N(0, 0.05²).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import EQSD_REF, VISION_REF  # noqa: E402
from pql_tpu_torch.algos import get_algo  # noqa: E402
from pql_tpu_torch.algos.ma_base import MultiAgentCtx  # noqa: E402
from pql_tpu_torch.cfg import make_config  # noqa: E402
from pql_tpu_torch.envs import make_env  # noqa: E402
from pql_tpu_torch.models.diffusion import StateDiffusionPolicy  # noqa: E402
from pql_tpu_torch.models.ediffusion import EquivariantDiffusionPolicy  # noqa: E402
from pql_tpu_torch.models.emlp import concat_reps  # noqa: E402
from pql_tpu_torch.ops.ddpm import draw_sample  # noqa: E402

PERTURBATIONS = (1e-7, -1e-7, 3e-7)


REFS = {"eqsd": EQSD_REF, "vision": VISION_REF}


def _nets(agent, state) -> dict[str, torch.nn.Module]:
    """Each network of the state, as ``card_vs_cpu`` holds them."""
    actor, critic = agent.snapshot_parts(state)
    return dict(actor) if isinstance(actor, torch.nn.ModuleDict) else {"actor": actor, "critic": critic}


def _flat(nets) -> dict[str, torch.Tensor]:
    return {k: torch.cat([p.detach().flatten() for p in m.parameters()]) for k, m in nets.items()}


def _two_iterations(cfg, eps: float) -> tuple[dict, dict]:
    """(initial, final) flat weights of each network after two iterations
    from initial weights scaled by (1 + eps·z)."""
    agent = get_algo(cfg.algo.name)(cfg, device="cpu")
    state = agent.init()
    z = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in _nets(agent, state).values():
            for p in m.parameters():
                p.mul_(1 + eps * torch.randn(p.shape, generator=z))
    theta0 = _flat(_nets(agent, state))
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        state, _ = agent.train_iter(state, agent.draw_iteration(gen))
    return theta0, _flat(_nets(agent, state))


def reference_runs(seeds, refs=EQSD_REF) -> dict:
    out = {}
    for seed in seeds:
        for algo, kwargs in refs:
            cfg = make_config(algo, **dict(kwargs, seed=kwargs.get("seed", 42) if seed is None else seed))
            theta0, base = _two_iterations(cfg, 0.0)
            worst = {}
            for eps in PERTURBATIONS:
                _, moved = _two_iterations(cfg, eps)
                for k in base:
                    rel = float((moved[k] - base[k]).norm() / (base[k] - theta0[k]).norm())
                    worst[k] = max(worst.get(k, 0.0), rel)
            label = f"seed {cfg.seed} {algo}" + (" diffusion" if kwargs.get("algo__diffusion") else "") + (
                " plain" if kwargs.get("algo__act_class") == "DiagGaussianMLPPolicy" else "")
            out[label] = worst
            print(json.dumps({"run": label, "largest_step_change": worst}), file=sys.stderr, flush=True)
    return out


def sampler(rows: int = 4096) -> dict:
    ma = MultiAgentCtx(make_env(make_config("eqsd", task="BimanualReacher", num_envs=2)))
    g_obs, g_act = ma.joint_obs_gen(), concat_reps(ma.act_gen(), ma.act_gen())
    out = {}
    for moved in (0.0, 0.05):
        gen = torch.Generator().manual_seed(0)
        for name, pol in (("EquivariantDiffusionPolicy", EquivariantDiffusionPolicy(g_obs, g_act, gen=gen)),
                          ("StateDiffusionPolicy", StateDiffusionPolicy(24, 4, gen=gen))):
            with torch.no_grad():
                for p in pol.parameters():
                    p.add_(moved * torch.randn(p.shape, generator=gen))
            obs = torch.randn(rows, 24, generator=gen)
            x_T, noise = draw_sample(gen, rows, 4, pol.sched.num_timesteps)
            wide = copy.deepcopy(pol).double()
            for m in wide.modules():
                if hasattr(m, "compute_dtype"):
                    m.compute_dtype = torch.float64
            with torch.no_grad():
                a32 = pol.get_actions(obs, x_T, noise).double()
                a64 = wide.get_actions(obs.double(), x_T.double(), noise.double())
                eps = pol.net(x_T, torch.full((rows,), float(pol.sched.num_timesteps - 1)), obs)
            out[f"{name} weights moved by {moved}"] = dict(
                fp32_vs_fp64_rel=float((a32 - a64).abs().max()) / (1.0 + float(a64.abs().max())),
                eps_max_abs_at_last_step=float(eps.abs().max()))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+",
                    help="the runs' seeds (default: 42 and 0 for eqsd, each run's own for vision)")
    ap.add_argument("--refs", choices=sorted(REFS), default="eqsd")
    args = ap.parse_args()
    seeds = args.seeds or ([42, 0] if args.refs == "eqsd" else [None])
    print(json.dumps({"reference_runs": reference_runs(seeds, REFS[args.refs]), "perturbations": PERTURBATIONS}))
    if args.refs == "eqsd":
        print(json.dumps({"sampler": sampler()}))


if __name__ == "__main__":
    main()
