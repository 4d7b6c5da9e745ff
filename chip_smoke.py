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
   ant_main_path, with ``c51_td_target`` launched 8 times per iteration.

Each main path resets the kernels' launch counts just before it runs and
reads them just after. Then the ``{"kernels": [...]}`` line, the nvidia-smi
line, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits nonzero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
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

    by_path = {"pql_d Cartpole@4096": main["launches"], "pql_d AllegroHand@16384": allegro_d["launches"]}
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
