#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits nonzero without them. Phases, one JSON
line each:

1. device    — card name, device count, nvidia-smi name and power limit;
2. build     — nvcc builds every ``pql_tpu_torch/csrc/*.cu`` for sm_90a;
3. kernel_check — each kernel against its plain PyTorch version on the
   card (tolerance 1e-5) on the main path's shape and edge cases, two
   launches bitwise equal, and by CUDA events around CUDA-graph replays its
   warm time (``ms``: the same inputs, resident in L2, as on the main path),
   its cold time (``ms_cold``: input sets rotated past the L2), the cold time
   of one elementwise pass over the same bytes (``same_bytes_ms``), the plain
   version's time and the bound;
4. reference — two PQL-D iterations at a small size on the card and on
   the CPU from the same state with the same draws;
5. main_path — ``algo=pql_d task=Cartpole num_envs=4096`` at full width
   (batch 8192, memory 5e6, hidden [512, 256, 128], 51 atoms): warm-up and
   training iterations on the card, with the kernels' launch counts; the
   same run with ``algo.use_pallas=false`` (plain projection) is timed in
   alternating blocks beside it;
6. physics_check — Ant, Humanoid and Anymal at 4096 envs: a rollout of
   ``PHYS_ROLL`` auto-resetting steps on the card from seeded draws under
   uniform actions, then one control step three ways from its last state: the
   captured CUDA graph, eager on the card (bitwise equal to the graph) and
   eager on the CPU (within ``STEP_TOL``); the graph's kernel ms, its replay
   period and host launch ms, the eager step's wall ms and the kernel
   launches of one control step;
7. ant_main_path — ``algo=pql task=Ant num_envs=4096`` at full width
   (batch 8192, memory 5e6, fp32, reward scale 0.01): warm-up and at least
   20 iterations, with ms/iter, env-steps/s and, from a short profiled
   window, device ms/iter split into the sim graph and the rest;
8. hand_physics_check — AllegroHand and ShadowHand at 8192 envs, as
   physics_check (with the hand's per-step draws, its tolerances and
   ``HAND_MAX_FLIPS``), plus the graph's capture and instantiate seconds,
   the engaged contact pairs and the goals reached;
9. allegro_main_path — ``algo=pql task=AllegroHand num_envs=8192`` (batch
   8192, memory 5e6: ring 610 × 8192 × 124 fp32), as ant_main_path;
10. allegro_pqld_main_path — ``algo=pql_d task=AllegroHand num_envs=16384
   algo.memory_size=2000000`` (ring 122 × 16384 × 124 fp32, 51 atoms), as
   ant_main_path, with ``c51_td_target`` launched 8 times per iteration;
11. entry_path — the entry point, ``pql_tpu_torch.train.main``, with
   ``algo=pql_d task=Cartpole num_envs=4096`` at full width for
   ``ENTRY_CALLS`` × 4 iterations, with evals, full checkpoints and a best
   model into a directory under ``build/``: the eval records at the
   predicted iterations, the files, ``c51_td_target`` 8 launches per
   iteration; ms per eval call, checkpoint bytes, save and load seconds, and
   ms/iter of the logged intervals with and without an eval or a save;
12. resume_check — the same configuration: warm-up, ``RESUME_K``
   iterations, a full checkpoint, ``RESUME_M`` more; a fresh agent of
   another seed resumes and runs the same ``RESUME_M``: bitwise equal in
   every tensor (params, target, optimizer moments, replay, generator,
   counters); then ``set_ratios(16, 2)`` on both and one iteration each:
   counters 16:8, ``c51_td_target`` 16 launches per iteration, still bitwise;
13. sampling_options — two iterations from one state with one set of
   draws with ``algo.prefetch_batches`` off and on: bitwise equal; then a few
   iterations with ``algo.sample_slots=8``: finite losses, exact counters;
14. learning_gate — the JAX package's Cartpole gate (tests/test_learning.py:
   37-59, ``LEARNING_GATE``): PQL seed 0 must reach eval return > 250 after
   150 iterations; PQL-D seed 0 is printed, unchecked;
15. baseline_reference — warm-up and two iterations of DDPG, SAC and CrossQ
   at a small size on the card and on the CPU, same state and draws;
16. baseline_main_path — DDPG Cartpole @16 (the JAX bench's
   cartpole_ddpg_16) for 202 iterations, and DDPG, SAC and CrossQ on Ant
   @4096 for 11 iterations each after the warm-up, at full width: ms/iter,
   env-steps/s, 8 updates per iteration, device ms/iter (sim graph and
   learner on Ant);
17. baseline_entry_path — ``train.main`` with DDPG Cartpole @16: evals at
   the predicted iterations, the best model and checkpoint, and a resumed run
   bitwise equal to an uninterrupted one;
18. ddpg_learning_gate — the JAX package's DDPG gate (tests/test_learning.py:
   62-84, ``DDPG_GATE``): seed 0's best eval return at iterations 200, 225
   and 250 must exceed 400; seed 1 is printed.

Each main path, and each of phases 11, 12, 14 and 16-18, resets the kernels'
launch counts just before it drives the port and reads them just after. Then the ``{"kernels": [...]}`` line, the nvidia-smi
line, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits nonzero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

MAIN_WARM_ITERS = 5  # untimed iterations of each route first
MAIN_BLOCKS = 8  # timed blocks, alternating kernel and plain routes
MAIN_BLOCK_ITERS = 10  # iterations per timed block
PROFILED_ITERS = 5  # iterations under torch.profiler after the timed ones
TOL = 1e-5  # kernel vs plain version, fp32 (ulp-level: support by i*dz+v_min vs linspace, FMA)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
COLD_SETS = 32  # input sets rotated for cold times: 32 x 5.08 MB = 163 MB, over 3x the 50 MB L2
RIGID_TASKS = ("Ant", "Humanoid", "Anymal")
PHYS_ENVS = 4096
PHYS_ROLL = 50  # control steps before the compared one
PHYS_REPS = 20  # graph replays per timing
PHYS_TIMINGS = 5  # timings per task
# Card against CPU, one control step (eager, fp32): the tolerances of the
# CPU parity tests against the JAX package (tests/test_torch_physics.py,
# tests/test_torch_rigid.py): rtol 1e-4 with atol 1e-5 on positions,
# anchors and the reward, 1e-4 on velocities; terminated exact. The card
# rounds differently (FMA contraction inside ops, its own sin/cos, division
# by a scalar as a reciprocal product), so an env whose contact or
# termination test sits within rounding of its threshold may take the
# other branch: at most PHYS_MAX_FLIPS of the 4096 envs may differ beyond
# the tolerance, and every such env is reported.
STEP_TOL = {"q": (1e-4, 1e-5), "qd": (1e-4, 1e-4), "contact": (1e-4, 1e-5), "cmd": (0.0, 0.0),
            "reward": (1e-4, 1e-5)}
PHYS_MAX_FLIPS = 4
ANT_WARM_ITERS = 5  # untimed iterations after the warm-up
ANT_BLOCKS = 4  # timed blocks of ANT_BLOCK_ITERS iterations
ANT_BLOCK_ITERS = 5
HAND_TASKS = ("AllegroHand", "ShadowHand")
HAND_ENVS = 8192
# The hand's tolerances, card against CPU, are those of its CPU parity tests
# (tests/test_torch_hand.py): as STEP_TOL, with the reached-goal flag exact,
# the target as positions, velocities at atol 1e-3 and the cube's angular
# velocity at 1e-2 (its tiny inertia under capped finger contacts makes
# each substep's increments tens of rad/s, which cancel; two fp32 steps
# differ by up to ~7e-3 rad/s). At most HAND_MAX_FLIPS of the 8192 envs may
# differ beyond them, each reported.
HAND_STEP_TOL = {"q": (1e-4, 1e-5), "qd": (1e-4, 1e-3), "contact": (1e-4, 1e-5), "target": (1e-4, 1e-5),
                 "reward": (1e-4, 1e-5), "success": (0.0, 0.0)}
HAND_CUBE_W_ATOL = 1e-2
HAND_MAX_FLIPS = 8
HAND_WARM_ITERS = 2  # untimed iterations after the warm-up
HAND_BLOCKS = 3  # timed blocks of HAND_BLOCK_ITERS iterations
HAND_BLOCK_ITERS = 3
HAND_PROFILED_ITERS = 2
ENTRY_ARGV = ("algo=pql_d", "task=Cartpole", "num_envs=4096")
ENTRY_CALLS = 8  # train_block calls of iters_per_call = 4 iterations
ENTRY_EVAL_FREQ = 8  # evals at iterations 8, 16, 24, 32
ENTRY_CKPT_FREQ = 12  # full checkpoints at iterations 12, 24
EVAL_TIMINGS = 3  # timed eval calls after the entry run
RESUME_K, RESUME_M = 3, 3  # iterations before the checkpoint and after it
SLOT_ITERS = 3  # iterations with algo.sample_slots=8
# the JAX package's gate (tests/test_learning.py:37-59): eval return > 250
# after warm-up and 150 iterations of PQL on Cartpole from seed 0
LEARNING_GATE = dict(task="Cartpole", num_envs=256, eval_num_envs=32, algo__batch_size=1024,
                     algo__memory_size=200_000, algo__warm_up=16, logging__mode="off")
LEARNING_ITERS = 150
LEARNING_THRESHOLD = 250.0
# the JAX package's DDPG gate (tests/test_learning.py:62-84): eval return > 400
# after warm-up and 250 iterations of DDPG on Cartpole from seed 0. Read here
# as the best of the evals at iterations 200, 225 and 250: a learned DDPG
# policy's eval return dips by ~110 at single evals (seed 0 on the card:
# 499.67, 385.49, 499.74 at iterations 225, 250, 275; PERF.md §6)
DDPG_GATE = dict(task="Cartpole", num_envs=64, eval_num_envs=32, algo__batch_size=512,
                 algo__memory_size=100_000, algo__warm_up=32, algo__update_times=8, logging__mode="off")
DDPG_ITERS = 250
DDPG_EVALS = (200, 225, 250)
DDPG_THRESHOLD = 400.0
DDPG_GATE_SEEDS = (0, 1)  # seed 0 is checked, seed 1 printed
# algo -> (configuration, iterations, threshold, the iterations whose best eval return the gate reads)
GATES = {"pql": (LEARNING_GATE, LEARNING_ITERS, LEARNING_THRESHOLD, (LEARNING_ITERS,)),
         "pql_d": (LEARNING_GATE, LEARNING_ITERS, LEARNING_THRESHOLD, (LEARNING_ITERS,)),
         "ddpg": (DDPG_GATE, DDPG_ITERS, DDPG_THRESHOLD, DDPG_EVALS)}
BASELINE_ALGOS = ("ddpg", "sac", "crossq")
BASELINE_REF = dict(num_envs=64, algo__batch_size=256, algo__memory_size=64 * 64, algo__warm_up=8)
# the JAX bench's cartpole_ddpg_16 (bench.py:156-164): the Cartpole baseline cell and the entry point's
DDPG_CARTPOLE_ARGV = ("algo=ddpg", "task=Cartpole", "num_envs=16", "algo.batch_size=1024", "algo.memory_size=1000000")
DDPG_CARTPOLE_DEPTH = (8, 4, 48, 2)  # warm, blocks x iterations timed, profiled: 202 iterations
BASELINE_ANT_DEPTH = (2, 2, 4, 1)  # 11 iterations after the warm-up
BASELINE_ENTRY_ITERS = (24, 30)  # the first run stops after 24 iterations, the resumed one after 30
BASELINE_ENTRY_EVAL_FREQ = 12  # evals at iterations 12, 24 (and 36 on no run)
BASELINE_ENTRY_CKPT_FREQ = 12
SMOKE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed(fn, *args):
    """(fn(*args), host seconds it took): each phase's line carries its
    ``wall_s``, to show where the script's time limit goes."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fns, iters: int, reps: int = 5) -> float:
    """Mean device time of one call: ``iters`` calls, cycling through the
    callables ``fns``, captured in one CUDA graph and replayed ``reps`` times
    between CUDA events, so the host's launch overhead (Python, ctypes) does
    not leave the device idle between calls and enter the time. One callable
    re-reads the same inputs, which stay in the 50 MB L2 (warm); callables on
    distinct input sets whose bytes together exceed the L2 read each set from
    device memory (cold)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as graph capture requires
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(iters):
            fns[k % len(fns)]()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def _self_device_us(row) -> float:
    # the attribute's name changed across torch versions
    return float(getattr(row, "self_device_time_total", getattr(row, "self_cuda_time_total", 0.0)))


def c51_logit_scale(A: int) -> float:
    """Scale of the N(0, 1) logits of the test distributions. The kernel and
    its plain version build pos in fp32 in different orders (support i·Δz +
    v_min vs linspace, FMA), so pos may differ by 2 ulps and a weight by
    2 ulp(pos)·p: 1.5e-5·p once pos passes 64 (A > 65). Logits N(0, 1) keep
    the peak p there near 0.2, so a 1e-5 check holds; below, N(0, 4)."""
    return 2.0 if A <= 65 else 1.0


C51_CASES = ("random", "clip_low", "clip_high", "done", "frac_done", "int_pos", "gamma_one")


def c51_case(case: str, B: int, A: int, dev, gen, v_min: float = -10.0, v_max: float = 10.0):
    """Inputs (p1, p2, reward, done, gamma) of one c51_td_target case, drawn
    with ``gen`` on ``dev``:

    random     r ~ 3·N(0, 1), done ~ Bernoulli(0.3), gamma = 0.99^3 (the main path's);
    clip_low   r <= -20: every target clipped at v_min;
    clip_high  r >= 20: every target clipped at v_max;
    done       done = 1: (1 - d)·gamma = 0, all sources share one pos;
    frac_done  done ~ U(0, 1);
    int_pos    done = 1, r in {v_min, z_(A//2), v_max}: pos exactly 0, A//2, A-1;
    gamma_one  gamma = 1.
    """
    import torch

    s = c51_logit_scale(A)
    p1 = torch.softmax(s * torch.randn(B, A, generator=gen, device=dev), -1)
    p2 = torch.softmax(s * torch.randn(B, A, generator=gen, device=dev), -1)
    reward = 3.0 * torch.randn(B, 1, generator=gen, device=dev)
    done = (torch.rand(B, 1, generator=gen, device=dev) < 0.3).float()
    gamma = 0.99 ** 3
    far = 20.0 + 10.0 * torch.rand(B, 1, generator=gen, device=dev)
    if case == "clip_low":
        reward = -far
    elif case == "clip_high":
        reward = far
    elif case == "done":
        done = torch.ones_like(done)
    elif case == "frac_done":
        done = torch.rand(B, 1, generator=gen, device=dev)
    elif case == "int_pos":
        dz = torch.tensor((v_max - v_min) / (A - 1), dtype=torch.float32)
        z_mid = float(torch.tensor(float(A // 2)) * dz + v_min)
        choice = torch.randint(0, 3, (B, 1), generator=gen, device=dev)
        reward = torch.tensor([v_min, z_mid, v_max], device=dev)[choice]
        done = torch.ones_like(done)
    elif case == "gamma_one":
        gamma = 1.0
    elif case != "random":
        raise ValueError(f"unknown c51 case {case!r}")
    return p1, p2, reward, done, gamma


def check_c51(dev) -> dict:
    """c51_td_target against its plain version on the card, on the main
    path's shape and the edge cases, then its warm and cold times."""
    import torch
    from pql_tpu_torch.ops.kernels import c51_td_target, c51_td_target_plain

    A, gamma, v_min, v_max = 51, 0.99 ** 3, -10.0, 10.0
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {}
    for B in (8192, 300, 1):  # the main path's batch, a ragged last block, one row
        for a in (2, 21, 51, 101):
            for case in C51_CASES:
                p1, p2, reward, done, g = c51_case(case, B, a, dev, gen)
                for mode, q in (("twin", p2), ("single", None)):
                    got = c51_td_target(p1, q, reward, done, g, v_min, v_max)
                    want = c51_td_target_plain(p1, q, reward, done, g, v_min, v_max)
                    torch.cuda.synchronize()
                    check(got.shape == (B, a) and bool(torch.isfinite(got).all()), f"c51 {case} {mode} B={B} A={a}")
                    errs[f"{case}_{mode}_B{B}_A{a}"] = float((got - want).abs().max())
        p1, _, reward, done, _ = c51_case("random", B, A, dev, gen)
        mass = c51_td_target(p1, None, reward, done, gamma, v_min, v_max).sum(-1)
        errs[f"mass_B{B}"] = float((mass - 1.0).abs().max())
    # integer pos: done = 1, r = 0 puts all mass on atom 25 (z = 0)
    p1, _, _, _, _ = c51_case("random", 64, A, dev, gen)
    zeros, ones = torch.zeros(64, 1, device=dev), torch.ones(64, 1, device=dev)
    out = c51_td_target(p1, p1, zeros, ones, gamma, v_min, v_max)
    onehot = torch.zeros_like(out)
    onehot[:, 25] = 1.0
    errs["integer_pos"] = float((out - onehot).abs().max())
    max_err = max(errs.values())
    worst = max(errs, key=errs.get)
    check(max_err <= TOL, f"c51_td_target disagrees with its plain version: {worst} {errs[worst]:.3g}")

    B = 8192
    sets = [c51_case("random", B, A, dev, gen) for _ in range(COLD_SETS)]
    p1, p2, reward, done, _ = sets[0]
    for q in (p2, None):
        first = c51_td_target(p1, q, reward, done, gamma, v_min, v_max)
        again = c51_td_target(p1, q, reward, done, gamma, v_min, v_max)
        check(torch.equal(first, again), "two c51_td_target launches on the same inputs differ")
    ms = cuda_ms([lambda: c51_td_target(p1, p2, reward, done, gamma, v_min, v_max)], 200)
    ms_cold = cuda_ms([lambda s=s: c51_td_target(s[0], s[1], s[2], s[3], gamma, v_min, v_max) for s in sets],
                      10 * COLD_SETS)
    buf = torch.empty_like(p1)
    same_bytes_ms = cuda_ms([lambda s=s: torch.add(s[0], s[1], out=buf) for s in sets], 10 * COLD_SETS)
    plain_ms = cuda_ms([lambda: c51_td_target_plain(p1, p2, reward, done, gamma, v_min, v_max)], 20)
    # least work: read p1, p2, r, d once, write out once; the scatter form of
    # the projection needs ~13 fp32 operations per (row, source atom) per twin
    nbytes = 4 * (2 * B * A + 2 * B + B * A)
    flops = 2 * 13 * B * A + B * A
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOPS
    return dict(
        name="c51_td_target", cases=len(errs), worst_case=worst, max_abs_err=max_err, deterministic=True,
        ms=ms, ms_cold=ms_cold, same_bytes_ms=same_bytes_ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bytes=nbytes, flops=flops, library_ms=None,
    )


def reference_phase(dev) -> dict:
    """Two PQL-D iterations at a small size on the card and on the CPU, from
    the same initial state (drawn on the CPU from the seed) with the same
    draws. The card's path runs the CUDA kernel, the CPU's its plain version."""
    import torch
    from pql_tpu_torch.algos.pql import PQL
    from pql_tpu_torch.cfg import make_config

    cfg = make_config("pql_d", num_envs=64, algo__batch_size=256, algo__memory_size=64 * 64,
                      algo__warm_up=8)
    agents = {d: PQL(cfg, device=d) for d in ("cpu", dev)}
    states = {d: a.init() for d, a in agents.items()}
    theta0 = torch.cat([p.detach().flatten() for p in states["cpu"].critic.parameters()])
    gen = torch.Generator().manual_seed(1)
    losses = {d: [] for d in agents}
    for it in range(3):
        draws = agents["cpu"].draw_iteration(gen, random=(it == 0))
        for d, agent in agents.items():
            step = agent.warmup if it == 0 else agent.train_iter
            states[d], m = step(states[d], {k: v.to(d) for k, v in draws.items()})
            losses[d].append(float(m["train/critic_loss"]))
    flat = {d: torch.cat([p.detach().float().cpu().flatten() for p in s.critic.parameters()])
            for d, s in states.items()}
    rel_step = float((flat[dev] - flat["cpu"]).norm() / (flat["cpu"] - theta0).norm())
    loss_err = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(losses[dev], losses["cpu"]))
    replay_err = float((states[dev].replay.data.cpu() - states["cpu"].replay.data).abs().max())
    # fp32 on both; sums run in other orders, so parameters drift apart at
    # the level of rounding: the card's parameter change must match the
    # CPU's to 1% of its norm, losses to 1e-3 relative
    check(rel_step <= 1e-2, f"card vs CPU critic step differs by {rel_step:.3g} of its norm")
    check(loss_err <= 1e-3, f"card vs CPU critic loss differs by {loss_err:.3g} relative")
    check(replay_err <= 1e-4, f"card vs CPU replay differs by {replay_err:.3g}")
    return dict(critic_step_rel_err=rel_step, critic_loss_rel_err=loss_err, replay_max_abs_err=replay_err)


def main_path(dev, smi: str) -> dict:
    """The port's main path at full width, through the kernel, with the same
    run through the plain projection (``algo.use_pallas=false``) timed in
    alternating blocks beside it: kernel, plain, plain, kernel, ..."""
    import statistics

    import torch
    from pql_tpu_torch.algos.pql import PQL
    from pql_tpu_torch.cfg import parse_cli
    from pql_tpu_torch.ops import kernels

    argv = ["algo=pql_d", "task=Cartpole", "num_envs=4096"]
    runs = {}
    for route, use_pallas in (("kernel", "true"), ("plain", "false")):
        cfg = parse_cli(argv + [f"algo.use_pallas={use_pallas}"])
        runs[route] = dict(agent=PQL(cfg, device=dev), losses=[], block_ms=[])
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for r in runs.values():
        r["state"], _ = r["agent"].warmup(r["agent"].init())

    def run(r, n):
        for _ in range(n):
            r["state"], m = r["agent"].train_iter(r["state"])
            r["losses"].append(torch.stack([m["train/critic_loss"], m["train/actor_loss"]]))

    for r in runs.values():
        run(r, MAIN_WARM_ITERS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    for route in ("kernel", "plain", "plain", "kernel") * (MAIN_BLOCKS // 2):
        t1 = time.perf_counter()
        run(runs[route], MAIN_BLOCK_ITERS)
        torch.cuda.synchronize()
        runs[route]["block_ms"].append(1e3 * (time.perf_counter() - t1) / MAIN_BLOCK_ITERS)
    launches = dict(kernels.LAUNCHES)

    iters = MAIN_WARM_ITERS + MAIN_BLOCKS * MAIN_BLOCK_ITERS
    cfg, state = runs["kernel"]["agent"].cfg, runs["kernel"]["state"]
    for route, r in runs.items():
        losses = torch.stack(r["losses"]).cpu()
        check(bool(torch.isfinite(losses).all()), f"non-finite loss on the main path ({route})")
        st = r["state"]
        check(st.critic_update_count == 8 * iters and st.actor_update_count == 4 * iters,
              f"counters {st.critic_update_count}:{st.actor_update_count} after {iters} iterations ({route})")
        check(st.replay.total_writes == cfg.algo.warm_up + iters, f"replay writes ({route})")
        for name in ("return_tracker", "len_tracker"):
            check(bool(torch.isfinite(getattr(st, name).mean())), f"{name} mean ({route})")
    check(launches["c51_td_target"] == 8 * iters,
          f"c51_td_target launched {launches['c51_td_target']} times in {iters} iterations")

    # device time by kernel over a short window (torch.profiler; CUPTI)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        run(runs["kernel"], PROFILED_ITERS)
        torch.cuda.synchronize()
        profiled_wall_ms = 1e3 * (time.perf_counter() - t1) / PROFILED_ITERS
    rows = sorted(prof.key_averages(), key=lambda r: -_self_device_us(r))
    # device time = kernel events only: an operator's row repeats the time of
    # the kernels it launched, and a record_function range (the optimizer's
    # step) appears on the device as a span that includes idle gaps
    on_device = [r for r in rows if r.device_type == DeviceType.CUDA]
    kernel_rows = [r for r in on_device if not getattr(r, "is_user_annotation", False)]
    op_rows = [r for r in rows if r.device_type != DeviceType.CUDA]
    device_ms = sum(_self_device_us(r) for r in kernel_rows) / 1e3 / PROFILED_ITERS

    def per_iter(rs, n):
        return [dict(name=r.key[:60], device_ms_per_iter=_self_device_us(r) / 1e3 / PROFILED_ITERS,
                     calls_per_iter=r.count / PROFILED_ITERS) for r in rs[:n]]

    c51_rows = [r for r in kernel_rows if "c51_td_target_kernel" in r.key]
    c51_us = sum(_self_device_us(r) for r in c51_rows) / max(sum(r.count for r in c51_rows), 1)
    ms = {route: statistics.median(r["block_ms"]) for route, r in runs.items()}
    return dict(
        config=" ".join(argv) + " (batch 8192, memory 5e6, hidden [512,256,128], 51 atoms, fp32)",
        card=smi, iterations=iters, setup_s=setup_s,
        ms_per_iter=ms["kernel"], env_steps_per_s=1e3 * cfg.num_envs / ms["kernel"],
        block_ms_per_iter={route: r["block_ms"] for route, r in runs.items()},
        block_ms_quartiles={route: statistics.quantiles(r["block_ms"], n=4) for route, r in runs.items()},
        plain_route_ms_per_iter=ms["plain"], plain_route_env_steps_per_s=1e3 * cfg.num_envs / ms["plain"],
        critic_loss_last=float(runs["kernel"]["losses"][-1][0]),
        actor_loss_last=float(runs["kernel"]["losses"][-1][1]),
        critic_updates=state.critic_update_count, actor_updates=state.actor_update_count,
        launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        profiled_wall_ms_per_iter=profiled_wall_ms, profiled_device_ms_per_iter=device_ms,
        profiled_device_busy_share=device_ms / profiled_wall_ms,
        c51_kernel_device_us_in_profile=c51_us,
        top_kernels=per_iter(kernel_rows, 10),
        top_ops_by_attributed_device_time=per_iter(op_rows, 8),
    )


def _kernel_launches(prof) -> int:
    """Device kernel launches in a profile (kernel rows of key_averages)."""
    from torch.autograd import DeviceType

    return sum(r.count for r in prof.key_averages()
               if r.device_type == DeviceType.CUDA and not getattr(r, "is_user_annotation", False))


def graph_kernel_nodes(graph) -> tuple[int, int]:
    """(kernel nodes, all nodes) of a captured ``torch.cuda.CUDAGraph`` made
    with ``keep_graph=True``, counted by libcuda (cuGraphGetNodes,
    cuGraphNodeGetType): the kernel launches of one replay. A profile of an
    eager step of ~100k launches may lose kernel records (62,491 of 99,948
    in one run), a count of the graph's nodes does not."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphGetNodes.restype = ctypes.c_int
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    cuda.cuGraphNodeGetType.restype = ctypes.c_int
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0, "cuGraphGetNodes (count)")
    nodes = (ctypes.c_void_p * n.value)()
    check(cuda.cuGraphGetNodes(handle, ctypes.cast(nodes, ctypes.c_void_p), ctypes.byref(n)) == 0,
          "cuGraphGetNodes (nodes)")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0, "cuGraphNodeGetType")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels, n.value


def step_tol(task) -> dict:
    """Per state field (and reward, flags): (rtol, atol), atol a float or a
    per-column tensor; the rigid tasks' STEP_TOL or the hand's."""
    import torch

    if type(task).__name__ not in HAND_TASKS:
        return STEP_TOL
    tol = dict(HAND_STEP_TOL)
    atol = torch.full((task.model.nv,), HAND_STEP_TOL["qd"][1])
    atol[task.cube_v : task.cube_v + 3] = HAND_CUBE_W_ATOL
    tol["qd"] = (HAND_STEP_TOL["qd"][0], atol)
    return tol


def envs_beyond_tol(got: dict, want: dict, tol: dict, E: int):
    """Envs where any compared field of the card's step differs from the
    CPU's beyond ``tol`` (or terminated differs), and each field's largest
    error over the other envs."""
    keys = [k for k in tol if k in want]
    err = {k: (got[k].cpu().float() - want[k].float()).abs().reshape(E, -1) for k in keys}
    off = got["terminated"].cpu() != want["terminated"]
    for k in keys:
        rtol, atol = tol[k]
        off |= (err[k] > atol + rtol * want[k].float().abs().reshape(E, -1)).any(-1)
    ok = ~off
    return [int(i) for i in off.nonzero().flatten()], {k: float(err[k][ok].max()) if ok.any() else None for k in keys}


def physics_check(dev, tasks, E: int, max_flips: int) -> dict:
    """Each task at E envs: roll out PHYS_ROLL steps of its VecEnv on the
    card (control steps through the graph, auto-reset, the task's per-step
    draws if it has them) from seeded draws under uniform actions, then take
    one control step from the last state three ways — graphed on the card,
    eager on the card, eager on the CPU — and time the graph and the eager
    step, and count one step's kernel launches (the graph's kernel nodes)."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pql_tpu_torch.envs import VecEnv, make_task

    out = {}
    for name in tasks:
        task = make_task(name)
        env = VecEnv(task, E)
        gen = torch.Generator().manual_seed(0)
        s, _ = env.reset(task.draw_reset(gen, E).to(dev))
        actions = (torch.rand(PHYS_ROLL + 1, E, task.action_dim, generator=gen) * 2.0 - 1.0).to(dev)
        resets = torch.stack([task.draw_reset(gen, E) for _ in range(PHYS_ROLL)]).to(dev)
        if hasattr(task, "draw_step"):
            step_draws = list(torch.stack([task.draw_step(gen, E) for _ in range(PHYS_ROLL + 1)]).to(dev))
        else:
            step_draws = [None] * (PHYS_ROLL + 1)
        t0 = time.perf_counter()
        for t in range(PHYS_ROLL):  # with auto-reset, so fallen envs restart
            s, _, _, _, _ = env.step(s, actions[t], resets[t], step_draws[t])
        torch.cuda.synchronize()
        roll_s = time.perf_counter() - t0
        state = s.state
        action = actions[PHYS_ROLL]
        draw = () if step_draws[PHYS_ROLL] is None else (step_draws[PHYS_ROLL],)
        graphed = task.dynamics(state, action, *draw)
        eager = task.control_step(state, action, *draw)
        cpu = task.control_step({k: v.cpu() for k, v in state.items()}, action.cpu(), *(x.cpu() for x in draw))
        torch.cuda.synchronize()

        def fields(res):
            nxt, reward, terminated, info = res
            return dict(nxt, reward=reward, terminated=terminated, **info)

        g, e, c = fields(graphed), fields(eager), fields(cpu)
        for k in g:
            check(torch.equal(g[k], e[k]), f"{name}: graphed and eager steps differ in {k}")
        check(bool(torch.isfinite(g["q"]).all()), f"{name}: non-finite q after {PHYS_ROLL} steps")
        flips, max_err = envs_beyond_tol(g, c, step_tol(task), E)
        check(len(flips) <= max_flips, f"{name}: card and CPU differ beyond tolerance in envs {flips}")

        graph = task._graphs[(E, action.device)]
        # back-to-back replays between CUDA events: the replay period, which is
        # the graph's kernel time unless the host's launch of the next replay
        # (graph_replay_host_ms) leaves the device waiting; PHYS_TIMINGS means
        # of PHYS_REPS replays show the spread within this call
        period_ms = []
        for _ in range(PHYS_TIMINGS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(PHYS_REPS):
                graph.graph.replay()
            end.record()
            torch.cuda.synchronize()
            period_ms.append(start.elapsed_time(end) / PHYS_REPS)
        submit_ms = []  # host time of one replay call (the graph's launch), the device idle
        for _ in range(PHYS_TIMINGS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            graph.graph.replay()
            submit_ms.append(1e3 * (time.perf_counter() - t1))
        torch.cuda.synchronize()
        eager_ms = []
        for _ in range(3):
            t1 = time.perf_counter()
            task.control_step(state, action, *draw)
            torch.cuda.synchronize()
            eager_ms.append(1e3 * (time.perf_counter() - t1))
        launches, nodes = graph_kernel_nodes(graph.graph)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            graph.graph.replay()
            torch.cuda.synchronize()
        replay_in_profile = _kernel_launches(prof)
        check(replay_in_profile >= 0.99 * launches, f"{name}: the profiler does not trace the graph's kernels")
        # the graph's device time: its kernels' durations in a profile of one replay
        graph_kernel_ms = sum(_self_device_us(r) for r in prof.key_averages()
                              if r.device_type == DeviceType.CUDA) / 1e3
        out[name] = dict(
            envs=E, rollout_steps=PHYS_ROLL, rollout_s=roll_s, graphed_equals_eager_bitwise=True,
            card_vs_cpu_max_abs_err=max_err, card_vs_cpu_envs_beyond_tol=flips, terminated=int(g["terminated"].sum()),
            engaged_pairs=int((g["contact"][:, 3::4] > 0.5).sum()),
            graph_kernel_ms=graph_kernel_ms, graph_replay_period_ms=statistics.median(period_ms),
            graph_replay_period_ms_timings=period_ms, graph_replay_host_ms=statistics.median(submit_ms),
            graph_build_s=graph.build_s, eager_wall_ms=statistics.median(eager_ms),
            launches_per_control_step=launches, graph_nodes=nodes, graph_replay_kernels_in_profile=replay_in_profile,
        )
        if "success" in g:
            out[name]["goals_reached"] = int(g["success"].sum())
    return out


def rigid_main_path(dev, smi: str, argv: list[str], warm_iters: int, blocks: int, block_iters: int,
                    profiled_iters: int) -> dict:
    """A PQL path on a rigid-body or hand task at full width: warm-up, then
    ``warm_iters`` + ``blocks`` x ``block_iters`` iterations timed in blocks,
    then a profiled window of ``profiled_iters``, whose kernel time is the
    device time of whole iterations (the profiler traces the graph's kernels:
    one replay profiled alone must show at least 99% of the graph's kernel
    nodes). That replay's kernel time is the sim's share.
    CUDA events around every control step of the timed blocks (input copies,
    graph replay, output clones) give the sim's span on the stream, which
    also holds any time the device waits for the host to submit the graph.
    The kernels' launch counts are reset before the path runs and read
    after it."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pql_tpu_torch.algos.pql import PQL
    from pql_tpu_torch.cfg import parse_cli
    from pql_tpu_torch.ops import kernels

    cfg = parse_cli(argv)
    agent = PQL(cfg, device=dev)
    task, E, label = agent.env.task, cfg.num_envs, f"{cfg.task}@{cfg.num_envs}"
    sim_events = []
    graphed = task.dynamics

    def timed_dynamics(state, action, *draw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = graphed(state, action, *draw)
        end.record()
        sim_events.append((start, end))
        return res

    task.dynamics = timed_dynamics
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state = agent.init()
    # ring: memory // E slots of obs + action + reward + next_obs + done fp32 columns
    ring = (int(cfg.algo.memory_size) // E, E, 2 * agent.obs_dim + agent.action_dim + 2)
    check(tuple(state.replay.data.shape) == ring, f"{label} replay ring {tuple(state.replay.data.shape)}, want {ring}")
    state, _ = agent.warmup(state)
    losses, block_ms = [], []

    def run(n):
        nonlocal state
        for _ in range(n):
            state, m = agent.train_iter(state)
            losses.append(torch.stack([m["train/critic_loss"], m["train/actor_loss"]]))

    run(warm_iters)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps_before = len(sim_events)
    for _ in range(blocks):
        t1 = time.perf_counter()
        run(block_iters)
        torch.cuda.synchronize()
        block_ms.append(1e3 * (time.perf_counter() - t1) / block_iters)
    timed = sim_events[steps_before:]
    sim_span_ms = sum(s.elapsed_time(e) for s, e in timed) / len(timed)  # one control step per iteration
    task.dynamics = graphed

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        run(profiled_iters)
        torch.cuda.synchronize()
        profiled_wall_ms = 1e3 * (time.perf_counter() - t1) / profiled_iters
    launches = dict(kernels.LAUNCHES)
    iters = warm_iters + blocks * block_iters + profiled_iters
    lo = torch.stack(losses).cpu()
    check(bool(torch.isfinite(lo).all()), f"non-finite loss on the {label} path")
    check(state.critic_update_count == 8 * iters and state.actor_update_count == 4 * iters,
          f"{label} counters {state.critic_update_count}:{state.actor_update_count} after {iters} iterations")
    check(state.replay.total_writes == cfg.algo.warm_up + iters, f"{label} replay writes")
    for name in ("return_tracker", "len_tracker", "success_tracker"):
        check(bool(torch.isfinite(getattr(state, name).mean())), f"{label} {name} mean")
    check(len(sim_events) == cfg.algo.warm_up + iters - profiled_iters, f"{len(sim_events)} control steps")
    if cfg.algo.distl and cfg.algo.use_pallas:
        check(launches["c51_td_target"] == 8 * iters,
              f"c51_td_target launched {launches['c51_td_target']} times in {iters} iterations of {label}")

    rows = sorted(prof.key_averages(), key=lambda r: -_self_device_us(r))
    kernel_rows = [r for r in rows if r.device_type == DeviceType.CUDA
                   and not getattr(r, "is_user_annotation", False)]
    kernel_ms = sum(_self_device_us(r) for r in kernel_rows) / 1e3 / profiled_iters
    graph = task._graphs[(E, torch.device(dev))]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as gprof:
        graph.graph.replay()
        torch.cuda.synchronize()
    graph_kernels, _ = graph_kernel_nodes(graph.graph)
    check(_kernel_launches(gprof) >= 0.99 * graph_kernels,
          f"the profiler does not trace the {label} graph's kernels: no sim/learner split")
    sim_ms = sum(_self_device_us(r) for r in gprof.key_averages() if r.device_type == DeviceType.CUDA) / 1e3
    ms = statistics.median(block_ms)
    return dict(
        config=" ".join(argv) + f" (batch {cfg.algo.batch_size}, memory {cfg.algo.memory_size:g}, fp32, "
                                f"reward scale {cfg.algo.reward_scale:g})",
        replay_ring=list(ring), replay_ring_gb=state.replay.data.numel() * 4 / 1e9,
        card=smi, iterations=iters, setup_s=setup_s, graph_build_s=graph.build_s,
        ms_per_iter=ms, env_steps_per_s=1e3 * E / ms, block_ms_per_iter=block_ms,
        critic_loss_last=float(lo[-1][0]), actor_loss_last=float(lo[-1][1]),
        critic_updates=state.critic_update_count, actor_updates=state.actor_update_count,
        replay_writes=state.replay.total_writes, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        train_return=float(state.return_tracker.mean()), episode_length=float(state.len_tracker.mean()),
        success_rate=float(state.success_tracker.mean()), launches=launches,
        profiled_wall_ms_per_iter=profiled_wall_ms, sim_span_ms_per_iter=sim_span_ms,
        device_ms_per_iter=kernel_ms, sim_graph_device_ms_per_iter=sim_ms,
        learner_and_rest_device_ms_per_iter=kernel_ms - sim_ms, device_busy_share=kernel_ms / ms,
        launches_per_control_step=graph_kernels,
        top_kernels=[dict(name=r.key[:60], device_ms_per_iter=_self_device_us(r) / 1e3 / profiled_iters,
                          calls_per_iter=r.count / profiled_iters) for r in kernel_rows[:10]],
    )


def state_diffs(a, b) -> list[str]:
    """Paths of the entries of two PQL states' ``state_dict``s that are not
    bitwise equal."""
    from pql_tpu_torch.utils.checkpoint import state_dict

    import torch

    out = []

    def walk(x, y, path):
        if isinstance(x, dict):
            if set(x) != set(y):
                out.append(path)
                return
            for k in x:
                walk(x[k], y[k], f"{path}.{k}")
        elif isinstance(x, (list, tuple)):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}[{i}]")
        elif isinstance(x, torch.Tensor):
            if x.shape != y.shape or not torch.equal(x, y.to(x.device)):
                out.append(path)
        elif x != y:
            out.append(path)

    walk(state_dict(a), state_dict(b), "state")
    return out


def copy_state(src, dst):
    """``dst`` (a fresh state of the same config) made a deep copy of ``src``,
    through one ``torch.save`` in memory."""
    import io

    import torch
    from pql_tpu_torch.utils import checkpoint

    buf = io.BytesIO()
    torch.save(checkpoint.state_dict(src), buf)
    buf.seek(0)
    return checkpoint.load_state_dict(dst, torch.load(buf, map_location="cpu", weights_only=True))


def entry_path(dev, smi: str) -> dict:
    """``pql_tpu_torch.train.main`` at full width, with evals, full
    checkpoints and a best model in ``SMOKE_DIR/entry``; then the eval's and
    the checkpoint's costs at that width."""
    import shutil
    import statistics
    from unittest import mock

    import torch
    from pql_tpu_torch import train
    from pql_tpu_torch.algos.pql import PQL
    from pql_tpu_torch.cfg import parse_cli
    from pql_tpu_torch.envs import make_eval_env
    from pql_tpu_torch.ops import kernels
    from pql_tpu_torch.utils import checkpoint
    from pql_tpu_torch.utils.evaluator import Evaluator

    root = os.path.join(SMOKE_DIR, "entry")
    shutil.rmtree(root, ignore_errors=True)
    cfg = parse_cli(list(ENTRY_ARGV))
    ipc, warm, E = cfg.algo.iters_per_call, cfg.algo.warm_up, cfg.num_envs
    iters = ENTRY_CALLS * ipc
    argv = list(ENTRY_ARGV) + [
        f"max_step={(warm + (iters - ipc)) * E}", f"algo.eval_freq={ENTRY_EVAL_FREQ}", f"algo.log_freq={ipc}",
        f"checkpoint_dir={root}/ckpt", f"checkpoint_freq={ENTRY_CKPT_FREQ}", f"logging.out_dir={root}/runs",
        "logging.run_name=entry", "logging.console=false", f"--device={dev}",
    ]
    saves = []
    save = train.save_checkpoint

    def timed_save(path, state):
        t1 = time.perf_counter()
        save(path, state)
        saves.append(time.perf_counter() - t1)

    kernels.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(train, "save_checkpoint", timed_save):
        train.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    run_dir = os.path.join(root, "runs", "entry")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    it_of = lambda step: (step // E - warm) // cfg.algo.horizon_len  # noqa: E731
    eval_its = [it for it in range(ipc, iters + 1, ipc) if it // ENTRY_EVAL_FREQ > (it - ipc) // ENTRY_EVAL_FREQ]
    ckpt_its = [it for it in range(ipc, iters + 1, ipc) if it // ENTRY_CKPT_FREQ > (it - ipc) // ENTRY_CKPT_FREQ]
    evals = [r for r in recs if "eval/return" in r]
    check([it_of(r["step"]) for r in evals] == eval_its,
          f"eval records at iterations {[it_of(r['step']) for r in evals]}, predicted {eval_its}")
    check(all(math.isfinite(r["eval/return"]) and math.isfinite(r["eval/episode_length"]) for r in evals),
          "non-finite eval record")
    check(len(saves) == len(ckpt_its) == 2, f"{len(saves)} checkpoints, predicted at iterations {ckpt_its}")
    ckpt_file = os.path.join(root, "ckpt", "state", checkpoint.STATE_FILE)
    best = os.path.join(run_dir, "best_model")
    check(os.path.exists(ckpt_file) and os.path.exists(os.path.join(best, checkpoint.SNAPSHOT_FILE)),
          "the checkpoint or the best model is missing")
    ckpt_bytes = os.path.getsize(ckpt_file)
    check(launches["c51_td_target"] == 8 * iters,
          f"c51_td_target launched {launches['c51_td_target']} times in {iters} iterations of the entry point")
    # ms/iter of each logged interval (log_freq = iters_per_call: one train_block);
    # an interval holds the eval dispatch or the save made after the log before it
    speed = [r for r in recs if "speed/env_steps_per_s" in r]
    ms = {it_of(r["step"]): 1e3 * E / r["speed/env_steps_per_s"] for r in speed}
    busy = set(eval_its) | set(ckpt_its)
    clean = [v for it, v in ms.items() if it > ipc and it - ipc not in busy]
    with_eval = [v for it, v in ms.items() if it - ipc in eval_its]
    with_save = [v for it, v in ms.items() if it - ipc in ckpt_its and it - ipc not in eval_its]

    agent = PQL(cfg, device=dev)
    state = agent.init()
    t1 = time.perf_counter()
    checkpoint.load_checkpoint(os.path.join(root, "ckpt", "state"), state)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    check(state.critic_update_count == 8 * ckpt_its[-1], "the loaded checkpoint's counters")
    checkpoint.restore_into_state(state, checkpoint.load_model_snapshot(best))
    ev = Evaluator(cfg, make_eval_env(cfg), agent.eval_actor_apply, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    eval_ms, enqueue_ms = [], []
    for _ in range(EVAL_TIMINGS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        handle = ev.eval_policy_async(state.actor, state.obs_rms, gen)
        enqueue_ms.append(1e3 * (time.perf_counter() - t1))
        out = Evaluator.resolve(handle)
        eval_ms.append(1e3 * (time.perf_counter() - t1))
        check(math.isfinite(out["eval/return"]), "non-finite eval return")
    shutil.rmtree(root, ignore_errors=True)
    return dict(
        config=" ".join(argv[:3]) + f" (batch {cfg.algo.batch_size}, memory {cfg.algo.memory_size:g}, 51 atoms; "
                                    f"{ENTRY_CALLS} train_block calls of {ipc})",
        card=smi, wall_s_of_main=wall_s, iterations=iters, eval_iterations=eval_its, checkpoint_iterations=ckpt_its,
        eval_returns=[r["eval/return"] for r in evals], eval_episode_lengths=[r["eval/episode_length"] for r in evals],
        launches=launches, checkpoint_bytes=ckpt_bytes, checkpoint_save_s=saves,
        checkpoint_load_s=load_s, eval_envs=cfg.eval_num_envs, eval_steps=ev.env.max_episode_length,
        eval_ms_per_call=statistics.median(eval_ms), eval_ms_per_call_timings=eval_ms,
        eval_enqueue_ms=statistics.median(enqueue_ms),
        ms_per_iter_by_interval=ms, ms_per_iter_without_eval_or_save=statistics.median(clean),
        ms_per_iter_after_eval=statistics.median(with_eval), ms_per_iter_after_save=statistics.median(with_save),
        ms_per_iter_all=statistics.mean(v for it, v in ms.items() if it > ipc),
    )


def resume_check(dev) -> dict:
    """Kill and resume at full width, bitwise; then ``set_ratios(16, 2)``."""
    import shutil

    import torch
    from pql_tpu_torch.algos.pql import PQL
    from pql_tpu_torch.cfg import parse_cli
    from pql_tpu_torch.ops import kernels
    from pql_tpu_torch.utils import checkpoint

    path = os.path.join(SMOKE_DIR, "resume", "state")
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    kernels.reset_launches()
    agent = PQL(parse_cli(list(ENTRY_ARGV)), device=dev)
    s, _ = agent.warmup(agent.init())
    for _ in range(RESUME_K):
        s, _ = agent.train_iter(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(path, s)
    save_s = time.perf_counter() - t0
    for _ in range(RESUME_M):
        s, _ = agent.train_iter(s)

    agent2 = PQL(parse_cli(list(ENTRY_ARGV) + ["seed=7"]), device=dev)
    s2 = agent2.init()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.load_checkpoint(path, s2)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for _ in range(RESUME_M):
        s2, _ = agent2.train_iter(s2)
    diffs = state_diffs(s, s2)
    check(not diffs, f"the resumed run differs from the uninterrupted one in {diffs[:8]}")
    launches = dict(kernels.LAUNCHES)
    its = 2 * (RESUME_K + RESUME_M) - RESUME_K
    check(launches["c51_td_target"] == 8 * its, f"c51_td_target launched {launches['c51_td_target']} in {its} iterations")

    counts = [(s.critic_update_count, s.actor_update_count), (s2.critic_update_count, s2.actor_update_count)]
    kernels.reset_launches()
    for a in (agent, agent2):
        a.set_ratios(16, 2)
    s, _ = agent.train_iter(s)
    s2, _ = agent2.train_iter(s2)
    ratio_launches = kernels.LAUNCHES["c51_td_target"]
    kernels.LAUNCHES["c51_td_target"] += launches["c51_td_target"]  # the path's total
    for (c0, a0), st in zip(counts, (s, s2)):
        check((st.critic_update_count - c0, st.actor_update_count - a0) == (16, 8),
              "counters after set_ratios(16, 2) did not advance 16:8")
    check(ratio_launches == 2 * 16, f"c51_td_target launched {ratio_launches} times in 2 iterations at 16:8")
    diffs = state_diffs(s, s2)
    check(not diffs, f"after set_ratios the runs differ in {diffs[:8]}")
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    return dict(config=" ".join(ENTRY_ARGV), iterations_before_save=RESUME_K, iterations_after=RESUME_M,
                bitwise_equal=True, save_s=save_s, load_s=load_s,
                counters_after=[s.critic_update_count, s.actor_update_count],
                c51_launches_per_iter_after_set_ratios=ratio_launches // 2, launches=dict(kernels.LAUNCHES))


def sampling_options(dev) -> dict:
    """``prefetch_batches`` bitwise at full width; ``sample_slots=8`` trains."""
    import torch
    from pql_tpu_torch.algos.pql import PQL
    from pql_tpu_torch.cfg import parse_cli

    base = PQL(parse_cli(list(ENTRY_ARGV)), device=dev)
    s0, _ = base.warmup(base.init())
    gen = torch.Generator(device=dev).manual_seed(5)
    draws = [base.draw_iteration(gen) for _ in range(2)]
    runs = {}
    for prefetch in ("false", "true"):
        agent = PQL(parse_cli(list(ENTRY_ARGV) + [f"algo.prefetch_batches={prefetch}"]), device=dev)
        st = copy_state(s0, agent.init())
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for d in draws:
            st, m = agent.train_iter(st, d)
            losses.append(torch.stack([m["train/critic_loss"], m["train/actor_loss"]]))
        torch.cuda.synchronize()
        runs[prefetch] = (st, torch.stack(losses), 1e3 * (time.perf_counter() - t0) / len(draws))
    diffs = state_diffs(runs["false"][0], runs["true"][0])
    check(not diffs and torch.equal(runs["false"][1], runs["true"][1]),
          f"prefetch_batches differs from per-update gathers in {diffs[:8]}")
    prefetch_ms = {p: r[2] for p, r in runs.items()}  # two iterations each: not a comparison
    del runs, s0, base

    agent = PQL(parse_cli(list(ENTRY_ARGV) + ["algo.sample_slots=8"]), device=dev)
    check(agent.sample_slots == 8, "sample_slots=8 did not select the window")
    st, _ = agent.warmup(agent.init())
    losses = []
    for _ in range(SLOT_ITERS):
        st, m = agent.train_iter(st)
        losses.append(torch.stack([m["train/critic_loss"], m["train/actor_loss"]]))
    lo = torch.stack(losses).cpu()
    check(bool(torch.isfinite(lo).all()), "non-finite loss with sample_slots=8")
    check((st.critic_update_count, st.actor_update_count) == (8 * SLOT_ITERS, 4 * SLOT_ITERS),
          "counters with sample_slots=8")
    return dict(config=" ".join(ENTRY_ARGV), prefetch_bitwise_equal=True, prefetch_iterations=len(draws),
                ms_per_iter_by_prefetch=prefetch_ms, sample_slots=8, sample_slots_iterations=SLOT_ITERS, sample_slots_losses=lo.tolist())


def learning_gate_evals(algo: str, seed: int, device, at: tuple[int, ...]) -> dict[int, float]:
    """Eval returns of the JAX package's Cartpole gate configuration for
    ``algo`` (``GATES``) from ``seed``, after warm-up and each number of
    iterations in ``at``, by the port's Evaluator with draws from seed 123."""
    import torch
    from pql_tpu_torch.algos import get_algo
    from pql_tpu_torch.cfg import make_config
    from pql_tpu_torch.envs import make_eval_env
    from pql_tpu_torch.utils.evaluator import Evaluator

    cfg = make_config(algo, seed=seed, **GATES[algo][0])
    agent = get_algo(cfg.algo.name)(cfg, device=device)
    state, _ = agent.warmup(agent.init())
    ev = Evaluator(cfg, make_eval_env(cfg), agent.eval_actor_apply, device)
    out = {}
    for it in range(1, max(at) + 1):
        state, _ = agent.train_iter(state)
        if it in at:
            gen = torch.Generator(device=device).manual_seed(123)
            out[it] = ev.eval_policy(state.actor, state.obs_rms, gen)["eval/return"]
    return out


def learning_gate_return(algo: str, seed: int, device, iters: int | None = None) -> float:
    """The statistic a gate reads: the best eval return at its iterations
    (``GATES``), or the eval return after ``iters`` iterations."""
    return max(learning_gate_evals(algo, seed, device, GATES[algo][3] if iters is None else (iters,)).values())


def learning_gate(dev) -> dict:
    """PQL seed 0 must pass the gate; PQL-D seed 0 is printed (seeds 1-4:
    ``tools/gate_trace.py``)."""
    from pql_tpu_torch.ops import kernels

    out, launches = {}, {}
    for algo, seed in (("pql", 0), ("pql_d", 0)):
        kernels.reset_launches()
        t0 = time.perf_counter()
        ret = learning_gate_return(algo, seed, dev)
        out[f"{algo} seed {seed}"] = dict(eval_return=ret, wall_s=time.perf_counter() - t0)
        if algo == "pql_d":
            launches = dict(kernels.LAUNCHES)
            check(launches["c51_td_target"] == 8 * LEARNING_ITERS, "c51_td_target launches in the PQL-D run")
    check(out["pql seed 0"]["eval_return"] > LEARNING_THRESHOLD,
          f"PQL failed the Cartpole gate: eval return {out['pql seed 0']['eval_return']} <= {LEARNING_THRESHOLD}")
    return dict(config=LEARNING_GATE, iterations=LEARNING_ITERS, threshold=LEARNING_THRESHOLD, checked="pql seed 0",
                runs=out, launches=launches)


def pre_batchnorm_biases(module) -> set[str]:
    """Names of the Linear biases that a BatchNorm follows (CrossQ's critic):
    in train mode it subtracts its batch's mean, so their gradient is zero
    but for rounding, and each Adam step moves them by up to the learning
    rate in an arbitrary direction, on the card and on the CPU alike."""
    from pql_tpu_torch.models.mlp import MLPNet

    return {f"{name}.layers.{i}.bias" for name, m in module.named_modules()
            if isinstance(m, MLPNet) and m.norms is not None for i in range(len(m.norms))}


def baseline_reference(dev) -> dict:
    """Warm-up and two iterations of DDPG, SAC and CrossQ at a small size on
    the card and on the CPU, from the same initial state (drawn on the CPU
    from the seed) with the same draws: each parameter step (actor, critic,
    SAC's log α, CrossQ's BatchNorm statistics) within 1% of its norm, losses
    within 1e-3 (relative; absolute below 1), the replay within 1e-4. The
    pre-BatchNorm biases of CrossQ's critic are held to the Adam bound alone
    (``pre_batchnorm_biases``)."""
    import torch
    from pql_tpu_torch.algos import get_algo
    from pql_tpu_torch.cfg import make_config

    out = {}
    for algo in BASELINE_ALGOS:
        cfg = make_config(algo, **BASELINE_REF)
        agents = {d: get_algo(cfg.algo.name)(cfg, device=d) for d in ("cpu", dev)}
        states = {d: a.init() for d, a in agents.items()}
        noisy = pre_batchnorm_biases(states["cpu"].critic)

        def parts(st):
            p = {f"{n}.{k}": v for n in ("actor", "critic") for k, v in getattr(st, n).named_parameters()}
            p.update({f"critic.{k}": v for k, v in st.critic.named_buffers()})
            if getattr(st, "log_alpha", None) is not None:
                p["log_alpha"] = st.log_alpha
            return {k: v.detach().float().cpu().clone() for k, v in p.items()}

        theta0 = parts(states["cpu"])
        gen = torch.Generator().manual_seed(1)
        losses = {d: [] for d in agents}
        for it in range(3):
            draws = agents["cpu"].draw_iteration(gen, random=(it == 0))
            for d, agent in agents.items():
                step = agent.warmup if it == 0 else agent.train_iter
                states[d], m = step(states[d], {k: v.to(d) for k, v in draws.items()})
                if it:
                    losses[d] += [float(m["train/critic_loss"]), float(m["train/actor_loss"])]
        got, want = parts(states[dev]), parts(states["cpu"])
        groups = {"actor": [], "critic": [], "critic_batchnorm_stats": [], "log_alpha": []}
        for k in want:
            if k.removeprefix("critic.") in noisy:
                continue
            g = ("critic_batchnorm_stats" if k.endswith((".mean", ".var")) else k.split(".")[0])
            groups[g].append(k)
        rel = {g: float(torch.cat([(got[k] - want[k]).flatten() for k in ks]).norm()
                        / torch.cat([(want[k] - theta0[k]).flatten() for k in ks]).norm())
               for g, ks in groups.items() if ks}
        updates = 2 * cfg.algo.update_times
        noise_err = max((float((got[f"critic.{k}"] - want[f"critic.{k}"]).abs().max()) for k in noisy), default=0.0)
        loss_err = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(losses[dev], losses["cpu"]))
        replay_err = float((states[dev].replay.data.cpu() - states["cpu"].replay.data).abs().max())
        for g, r in rel.items():
            check(r <= 1e-2, f"{algo}: card vs CPU {g} step differs by {r:.3g} of its norm")
        check(noise_err <= 2 * cfg.algo.critic_lr * updates, f"{algo}: pre-BatchNorm biases differ by {noise_err:.3g}")
        check(loss_err <= 1e-3, f"{algo}: card vs CPU loss differs by {loss_err:.3g}")
        check(replay_err <= 1e-4, f"{algo}: card vs CPU replay differs by {replay_err:.3g}")
        check(states[dev].update_count == updates and states["cpu"].update_count == updates, f"{algo} counters")
        out[algo] = dict(step_rel_err=rel, loss_rel_err=loss_err, replay_max_abs_err=replay_err,
                         pre_batchnorm_bias_max_abs_err=noise_err if noisy else None)
    return dict(config=BASELINE_REF, iterations=2, runs=out)


def baseline_run(dev, smi: str, argv, warm_iters: int, blocks: int, block_iters: int, profiled_iters: int,
                 sim_ms: float | None = None) -> dict:
    """A DDPG, SAC or CrossQ path at full width: warm-up, then ``warm_iters``
    + ``blocks`` x ``block_iters`` iterations timed in blocks, then a profiled
    window of ``profiled_iters`` whose kernel time is the device time of
    whole iterations; on a rigid task one replay of the control step's graph,
    profiled alone, is the sim's share (or ``sim_ms``, that of another run's
    graph of the same task and envs). The kernels' launch counts are reset
    before the path runs and read after it."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pql_tpu_torch.algos import get_algo
    from pql_tpu_torch.cfg import parse_cli
    from pql_tpu_torch.ops import kernels

    cfg = parse_cli(list(argv))
    agent = get_algo(cfg.algo.name)(cfg, device=dev)
    E, label = cfg.num_envs, f"{cfg.algo.name} {cfg.task}@{cfg.num_envs}"
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state = agent.init()
    ring = (int(cfg.algo.memory_size) // E, E, 2 * agent.obs_dim + agent.action_dim + 2)
    check(tuple(state.replay.data.shape) == ring, f"{label} replay ring {tuple(state.replay.data.shape)}, want {ring}")
    state, _ = agent.warmup(state)
    losses, block_ms = [], []

    def run(n):
        nonlocal state
        for _ in range(n):
            state, m = agent.train_iter(state)
            losses.append(torch.stack([m["train/critic_loss"], m["train/actor_loss"]]))

    run(warm_iters)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    for _ in range(blocks):
        t1 = time.perf_counter()
        run(block_iters)
        torch.cuda.synchronize()
        block_ms.append(1e3 * (time.perf_counter() - t1) / block_iters)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        run(profiled_iters)
        torch.cuda.synchronize()
        profiled_wall_ms = 1e3 * (time.perf_counter() - t1) / profiled_iters
    launches = dict(kernels.LAUNCHES)
    iters = warm_iters + blocks * block_iters + profiled_iters
    lo = torch.stack(losses).cpu()
    check(bool(torch.isfinite(lo).all()), f"non-finite loss on the {label} path")
    check(cfg.algo.update_times == 8 and state.update_count == 8 * iters,
          f"{label}: {state.update_count} updates after {iters} iterations")
    check(state.env_steps == (cfg.algo.warm_up + iters) * E and state.replay.total_writes == cfg.algo.warm_up + iters,
          f"{label} env steps / replay writes")
    trackers = {k: float(v) for k, v in state.stats.metrics().items()}
    check(all(math.isfinite(v) for v in trackers.values()), f"{label} trackers {trackers}")

    t1 = time.perf_counter()
    kernel_rows = [r for r in prof.key_averages() if r.device_type == DeviceType.CUDA
                   and not getattr(r, "is_user_annotation", False)]
    kernel_ms = sum(_self_device_us(r) for r in kernel_rows) / 1e3 / profiled_iters
    profile_read_s = time.perf_counter() - t1
    ms = statistics.median(block_ms)
    out = dict(
        config=" ".join(argv) + f" (batch {cfg.algo.batch_size}, memory {cfg.algo.memory_size:g}, "
                                f"update_times {cfg.algo.update_times}, fp32, reward scale {cfg.algo.reward_scale:g})",
        replay_ring=list(ring), replay_ring_gb=state.replay.data.numel() * 4 / 1e9, card=smi, iterations=iters,
        setup_s=setup_s, ms_per_iter=ms, env_steps_per_s=1e3 * E / ms, block_ms_per_iter=block_ms,
        critic_loss_last=float(lo[-1][0]), actor_loss_last=float(lo[-1][1]), update_count=state.update_count,
        env_steps=state.env_steps, replay_writes=state.replay.total_writes,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, trackers=trackers, launches=launches,
        profiled_wall_ms_per_iter=profiled_wall_ms, device_ms_per_iter=kernel_ms, device_busy_share=kernel_ms / ms,
        profile_read_s=profile_read_s,
    )
    if getattr(state, "log_alpha", None) is not None:
        out["log_alpha"] = float(state.log_alpha.detach())
    graphs = getattr(agent.env.task, "_graphs", None)
    if graphs and sim_ms is not None:
        out.update(sim_graph_device_ms_per_iter=sim_ms, learner_and_rest_device_ms_per_iter=kernel_ms - sim_ms,
                   sim_graph_measured_in="the first Ant run (the same task, envs and graph)")
    elif graphs:
        graph = graphs[(E, torch.device(dev))]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as gprof:
            graph.graph.replay()
            torch.cuda.synchronize()
        graph_kernels, _ = graph_kernel_nodes(graph.graph)
        check(_kernel_launches(gprof) >= 0.99 * graph_kernels,
              f"the profiler does not trace the {label} graph's kernels: no sim/learner split")
        sim_ms = sum(_self_device_us(r) for r in gprof.key_averages() if r.device_type == DeviceType.CUDA) / 1e3
        out.update(sim_graph_device_ms_per_iter=sim_ms, learner_and_rest_device_ms_per_iter=kernel_ms - sim_ms,
                   launches_per_control_step=graph_kernels)
    return out


def baseline_main_path(dev, smi: str) -> dict:
    """DDPG on Cartpole @16 (the JAX bench's cartpole_ddpg_16) for 207
    iterations, then DDPG, SAC and CrossQ on Ant @4096 (batch 8192, memory
    5e6: ring 1220 x 4096 x 78 fp32; CrossQ's critic sees 16,384 rows per
    update) for 12 iterations each after the warm-up."""
    import torch

    runs, sim_ms = {}, None
    for argv, depth in [(DDPG_CARTPOLE_ARGV, DDPG_CARTPOLE_DEPTH)] + [
            ((f"algo={a}", "task=Ant", "num_envs=4096"), BASELINE_ANT_DEPTH) for a in BASELINE_ALGOS]:
        t0 = time.perf_counter()
        r = baseline_run(dev, smi, argv, *depth, sim_ms=sim_ms)
        sim_ms = r.get("sim_graph_device_ms_per_iter")
        r["wall_s"] = time.perf_counter() - t0
        runs[" ".join(argv[:3])] = r
        torch.cuda.empty_cache()
    return dict(runs=runs)


def baseline_entry_path(dev, smi: str) -> dict:
    """``pql_tpu_torch.train.main`` with DDPG on Cartpole @16 for
    ``BASELINE_ENTRY_ITERS[0]`` iterations, with evals, full checkpoints and
    a best model in ``SMOKE_DIR/baseline_entry``: the eval records at the
    predicted iterations and the files; then ``train_baseline`` resumes from
    the checkpoint to ``BASELINE_ENTRY_ITERS[1]`` iterations without a
    warm-up, and ends bitwise where one uninterrupted run of as many
    iterations ends."""
    import contextlib
    import io
    import shutil
    import statistics

    import torch
    from pql_tpu_torch import train
    from pql_tpu_torch.cfg import parse_cli
    from pql_tpu_torch.ops import kernels
    from pql_tpu_torch.utils import checkpoint
    from pql_tpu_torch.utils.logging import RunLogger

    root = os.path.join(SMOKE_DIR, "baseline_entry")
    shutil.rmtree(root, ignore_errors=True)
    cfg = parse_cli(list(DDPG_CARTPOLE_ARGV))
    E, warm = cfg.num_envs, cfg.algo.warm_up
    first, total = BASELINE_ENTRY_ITERS
    common = list(DDPG_CARTPOLE_ARGV) + [
        f"algo.eval_freq={BASELINE_ENTRY_EVAL_FREQ}", "algo.log_freq=4", f"checkpoint_freq={BASELINE_ENTRY_CKPT_FREQ}",
        f"logging.out_dir={root}/runs", "logging.console=false"]
    kernels.reset_launches()
    t0 = time.perf_counter()
    train.main(common + [f"max_step={(warm + first - 1) * E}", f"checkpoint_dir={root}/ckpt",
                         "logging.run_name=first", f"--device={dev}"])
    torch.cuda.synchronize()
    wall_first = time.perf_counter() - t0
    run_dir = os.path.join(root, "runs", "first")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    it_of = lambda step: step // E - warm  # noqa: E731
    evals = [r for r in recs if "eval/return" in r]
    eval_its = list(range(BASELINE_ENTRY_EVAL_FREQ, first + 1, BASELINE_ENTRY_EVAL_FREQ))
    check([it_of(r["step"]) for r in evals] == eval_its,
          f"eval records at iterations {[it_of(r['step']) for r in evals]}, predicted {eval_its}")
    check(all(math.isfinite(r["eval/return"]) for r in evals), "non-finite eval record")
    ckpt_file = os.path.join(root, "ckpt", "state", checkpoint.STATE_FILE)
    check(os.path.exists(ckpt_file) and os.path.exists(os.path.join(run_dir, "best_model", checkpoint.SNAPSHOT_FILE)),
          "the checkpoint or the best model is missing")
    speed = [r for r in recs if "speed/env_steps_per_s" in r]
    ms = {it_of(r["step"]): 1e3 * E / r["speed/env_steps_per_s"] for r in speed}

    def run(name, ckpt):
        c = parse_cli(common + [f"max_step={(warm + total - 1) * E}", f"checkpoint_dir={root}/{ckpt}",
                                f"logging.run_name={name}"])
        logger = RunLogger(c)
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                state = train.train_baseline(c, logger, dev)[1]
        finally:
            logger.close()
        return state, out.getvalue()

    t0 = time.perf_counter()
    resumed, printed = run("second", "ckpt")
    wall_resumed = time.perf_counter() - t0
    check(f"at env step {(warm + first) * E} (no warm-up)" in printed, f"the rerun did not resume: {printed[-200:]!r}")
    whole, _ = run("whole", "ckpt_whole")
    diffs = state_diffs(resumed, whole)
    check(not diffs, f"the resumed baseline run differs from the uninterrupted one in {diffs[:8]}")
    check(resumed.update_count == 8 * total, f"{resumed.update_count} updates after {total} iterations")
    launches = dict(kernels.LAUNCHES)
    ckpt_bytes = os.path.getsize(ckpt_file)
    shutil.rmtree(root, ignore_errors=True)
    return dict(
        config=" ".join(DDPG_CARTPOLE_ARGV), card=smi, iterations_first=first, iterations_resumed=total,
        eval_iterations=eval_its, eval_returns=[r["eval/return"] for r in evals], bitwise_equal_after_resume=True,
        checkpoint_bytes=ckpt_bytes, wall_s_first=wall_first, wall_s_resumed=wall_resumed,
        ms_per_iter_by_interval=ms, ms_per_iter_median=statistics.median(ms.values()), launches=launches,
    )


def ddpg_learning_gate(dev) -> dict:
    """The JAX package's DDPG gate: seed 0's best eval return at iterations
    ``DDPG_EVALS`` must pass; seed 1 is printed (seeds 2-4:
    ``tools/gate_trace.py``)."""
    from pql_tpu_torch.ops import kernels

    out = {}
    kernels.reset_launches()
    for seed in DDPG_GATE_SEEDS:
        t0 = time.perf_counter()
        evals = learning_gate_evals("ddpg", seed, dev, DDPG_EVALS)
        out[f"ddpg seed {seed}"] = dict(eval_returns=evals, best=max(evals.values()), wall_s=time.perf_counter() - t0)
    ret = out["ddpg seed 0"]["best"]
    check(ret > DDPG_THRESHOLD, f"DDPG failed the Cartpole gate: best eval return {ret} <= {DDPG_THRESHOLD}")
    return dict(config=DDPG_GATE, iterations=DDPG_ITERS, evals_at=DDPG_EVALS, threshold=DDPG_THRESHOLD,
                checked="ddpg seed 0, best of the evals", runs=out, launches=dict(kernels.LAUNCHES))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pql_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda:0"
    smi = nvidia_smi_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    emit(dict(phase="device", kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda))

    t0 = time.perf_counter()
    built = kernels.build_kernels()
    emit(dict(phase="build", seconds=time.perf_counter() - t0, sources=built))

    c51, s = timed(check_c51, dev)
    checks = [c51]
    emit(dict(phase="kernel_check", card=smi, wall_s=s, kernels=checks))
    ref, s = timed(reference_phase, dev)
    emit(dict(phase="reference", wall_s=s, **ref))
    main, s = timed(main_path, dev, smi)
    emit(dict(phase="main_path", wall_s=s, **main))
    phys, s = timed(physics_check, dev, RIGID_TASKS, PHYS_ENVS, PHYS_MAX_FLIPS)
    emit(dict(phase="physics_check", card=smi, wall_s=s, tasks=phys))
    ant, s = timed(rigid_main_path, dev, smi, ["algo=pql", "task=Ant", "num_envs=4096"], ANT_WARM_ITERS,
                   ANT_BLOCKS, ANT_BLOCK_ITERS, PROFILED_ITERS)
    emit(dict(phase="ant_main_path", wall_s=s, **ant))
    hand, s = timed(physics_check, dev, HAND_TASKS, HAND_ENVS, HAND_MAX_FLIPS)
    emit(dict(phase="hand_physics_check", card=smi, wall_s=s, tasks=hand))
    hand_depth = (HAND_WARM_ITERS, HAND_BLOCKS, HAND_BLOCK_ITERS, HAND_PROFILED_ITERS)
    allegro, s = timed(rigid_main_path, dev, smi, ["algo=pql", "task=AllegroHand", "num_envs=8192"], *hand_depth)
    emit(dict(phase="allegro_main_path", wall_s=s, **allegro))
    allegro_d, s = timed(rigid_main_path, dev, smi, ["algo=pql_d", "task=AllegroHand", "num_envs=16384",
                                                     "algo.memory_size=2000000"], *hand_depth)
    emit(dict(phase="allegro_pqld_main_path", wall_s=s, **allegro_d))
    entry, s = timed(entry_path, dev, smi)
    emit(dict(phase="entry_path", wall_s=s, **entry))
    resume, s = timed(resume_check, dev)
    emit(dict(phase="resume_check", wall_s=s, **resume))
    sampling, s = timed(sampling_options, dev)
    emit(dict(phase="sampling_options", wall_s=s, **sampling))
    gate, s = timed(learning_gate, dev)
    emit(dict(phase="learning_gate", card=smi, wall_s=s, **gate))
    bref, s = timed(baseline_reference, dev)
    emit(dict(phase="baseline_reference", wall_s=s, **bref))
    bmain, s = timed(baseline_main_path, dev, smi)
    emit(dict(phase="baseline_main_path", wall_s=s, **bmain))
    bentry, s = timed(baseline_entry_path, dev, smi)
    emit(dict(phase="baseline_entry_path", wall_s=s, **bentry))
    bgate, s = timed(ddpg_learning_gate, dev)
    emit(dict(phase="ddpg_learning_gate", card=smi, wall_s=s, **bgate))

    by_path = {"pql_d Cartpole@4096": main["launches"], "pql_d AllegroHand@16384": allegro_d["launches"],
               "pql_d Cartpole@4096 entry point": entry["launches"],
               "pql_d Cartpole@4096 resume check": resume["launches"],
               "pql_d Cartpole@256 learning run": gate["launches"],
               **{f"{name} (baseline)": r["launches"] for name, r in bmain["runs"].items()},
               "algo=ddpg Cartpole@16 entry point": bentry["launches"],
               "ddpg Cartpole@64 learning runs": bgate["launches"]}
    emit({"kernels": [
        dict(name=c["name"], route="cuda", source=kernels.KERNELS[c["name"]]["source"],
             replaces=kernels.KERNELS[c["name"]]["replaces"],
             launches=sum(n[c["name"]] for n in by_path.values()),
             launches_by_path={p: n[c["name"]] for p, n in by_path.items()},
             max_abs_err=c["max_abs_err"], ms=c["ms"], ms_cold=c["ms_cold"], same_bytes_ms=c["same_bytes_ms"],
             plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"], library_ms=c["library_ms"])
        for c in checks
    ]})
    check("jax" not in sys.modules and "pql_tpu" not in sys.modules, "JAX or pql_tpu was imported")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
