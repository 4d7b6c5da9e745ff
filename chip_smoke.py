#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on the GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --entry   # only the CLI acceptance runs (ENTRY_RUNS)
    python3 chip_smoke.py --hand    # only the hand's phases 8-10
    python3 chip_smoke.py --clip-adamw   # only clip_adamw_step's build and check

Needs one CUDA card and nvcc; exits nonzero without them. Phases, one JSON
line each:

1. device    — card name, device count, nvidia-smi name and power limit;
2. build     — nvcc builds every ``pql_tpu_torch/csrc/*.cu`` for sm_90a (but
   ``hand_step.cu``, built around each hand's generated header in phase 8);
3. kernel_check — each kernel against its plain PyTorch version on the
   card (tolerance 1e-5; ``clip_adamw_step`` bit for bit, ``check_clip_adamw``)
   on the main path's shape and edge cases, two launches bitwise equal, and
   by CUDA events around CUDA-graph replays its warm time (``ms``: the same
   inputs, resident in L2, as on the main path), its cold time (``ms_cold``:
   input sets rotated past the L2), the cold time of one elementwise pass
   over the same bytes (``same_bytes_ms``), the plain version's time and the
   bound;
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
   window, device ms/iter split into the sim graph (on the hand: the fused
   kernel) and the rest;
8. hand_physics_check — the hand's fused step kernel
   (``csrc/hand_step.cu``, ``hand_kernel_check``): its cold build (nvcc's
   seconds, ptxas's registers and spills), then AllegroHand at 8192 and
   16384 envs and ShadowHand at 8192: a rollout through the kernel (one
   launch a control step, no graph), one control step against the eager
   step on the card (``HAND_KERNEL_TOL``) and on the CPU (the hand's
   tolerances and ``HAND_MAX_FLIPS``), the kernel's ms by CUDA events at
   blocks of 32, 64 and 128 threads, the eager step captured as a CUDA graph
   as the plain time, the bound (traced ops over 67 TFLOP/s, bytes over
   3.35 TB/s), the engaged contact pairs and the goals reached;
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
   cartpole_ddpg_16) for 54 iterations, and DDPG, SAC and CrossQ on Ant
   @4096 for 11 iterations each after the warm-up, at full width: ms/iter,
   env-steps/s, 8 updates per iteration, device ms/iter (sim graph and
   learner on Ant);
17. baseline_entry_path — ``train.main`` with DDPG Cartpole @16: evals at
   the predicted iterations, the best model and checkpoint, and a resumed run
   bitwise equal to an uninterrupted one;
18. ddpg_learning_gate — the JAX package's DDPG gate (tests/test_learning.py:
   62-84, ``DDPG_GATE``): seed 0's best eval return at iterations 200, 225
   and 250 must exceed 400;
19. ppo_reference — two iterations of PPO (value_norm), IPPO (two pairs, and
   one under same_policy) and MAPPO at a small size on the card and on the
   CPU, same state and draws: parameter steps within 1%, losses 1e-3;
20. ppo_main_path — ``algo=ppo task=Ant task_param=true`` (4096 envs,
   horizon 16, batch 32768, 4 epochs) and ``algo=ppo task=FrankaCubeStack
   task_param=true`` (8192 envs, horizon 32, batch 16384, 5 epochs), hidden
   [512, 256, 128], fp32: updates = epochs × minibatches × iterations, H·E
   env steps per iteration, finite losses and trackers; ms/iter,
   env-steps/s, the sim graph's device ms per iteration against the
   learner's, the busy share of a profiled window, peak memory;
21. franka_physics_check — FrankaCubeStack at 8192 envs, as physics_check
   (``FRANKA_STEP_TOL``, ``FRANKA_MAX_FLIPS``);
22. two_agent_main_path — ``algo=ippo`` and ``algo=mappo`` on
   BimanualReacher @4096 and ``algo=ippo algo.same_policy=true`` on
   BimanualReacherSym @4096, as ppo_main_path; the Sym task's mirrored share
   within 0.5 ± 0.05;
23. ppo_entry_path — ``train.main algo=ppo task=Cartpole`` @4096: no
   warm-up, evals at iterations 4 and 8, the best model and checkpoint; the
   resumed run starts at iteration 9 and ends bitwise equal to an
   uninterrupted one;
24. ippo_learning_gate — IPPO seed 0 on the JAX package's two-agent quick
   check (``IPPO_GATE``: BimanualReacher, 1024 envs, batch 4096):
   train/success_rate after 50 iterations must reach 0.95;
25. two_agent_reference — IDDPG's warm-up and two iterations, and two
   iterations of QTOTV1 (value_norm), QTOTV2, IART, IPPOTeam (Sym task) and
   IPPOTeam2, at a small size on the card and on the CPU, same state and
   draws (``card_vs_cpu``: parameter steps within 1%, losses 1e-3, IDDPG's
   replay 1e-4);
26. iddpg_main_path — ``algo=iddpg task=BimanualReacher num_envs=4096`` at
   its preset (batch 8192, memory 5e6: ring 1220 x 4096 x 55 fp32, 8
   updates of both hands per iteration): warm-up and 36 iterations, as
   baseline_main_path, with the replay's columns 28-29 holding two distinct
   reward channels;
27. team_main_path — QTOTV1, QTOTV2, IART, IPPOTeam and IPPOTeam2 on
   BimanualReacher @4096 and IPPOTeam on BimanualReacherSym @4096 at their
   presets (horizon 16, batch 32768, 4 epochs), as two_agent_main_path (a
   profiled window on QTOTV1, IART and IPPOTeam only);
28. iddpg_entry_path — ``train.main`` with IDDPG on BimanualReacher @4096,
   the ring cut to 100 slots (``IDDPG_ENTRY_ARGV``): warm-up, an eval and a
   checkpoint at iteration 12, the best model, the run resumed to 15 bitwise
   equal to an uninterrupted one, and the seconds of one more save and load
   of the full state;
29. eq_reference — the EMLP layers at full width on BimanualReacher's reps
   and ``GroupEMLP`` on C4 and D4 (equivariant and invariant heads) on the
   card against the CPU with the same raw weights, and equivariant on the
   card under every group element; two iterations of EQ, EQS, EQG, EQSC,
   EQSdata, EQS4 and MP, and of IPPOTeam and IART with the equivariant
   classes, card vs CPU (``card_vs_cpu``), then each trained equivariant
   network's |f(x·G_in) − f(x)·G_out| ≤ 1e-5·(1 + |f|) on the card (G_out = I
   for a critic);
30. eq_main_path — EQ, EQS, EQG, EQSC, EQSdata, EQS4 and MP on
   BimanualReacher @4096, EQ on BimanualReacherSym @4096 and IPPOTeam with
   the equivariant team actor @4096, at the presets (horizon 16, batch
   32768, 4 epochs, EMLP 256 x 5, fp32; EQSdata twice the minibatches), as
   two_agent_main_path with a profiled window on EQ, EQSC and EQS4 only,
   and the equivariance check above on every trained network at full width;
31. eq_entry_path — ``train.main algo=eqs4 task=BimanualReacher
   num_envs=4096`` through ppo_entry_path: an eval and a checkpoint at
   iteration 4, the best model, resumed to 6 bitwise equal to an
   uninterrupted run, the checkpoint's bytes and save and load seconds;
32. eqsd_reference — two iterations of EQSD with each of its four team
   actors (diffusion or Gaussian, equivariant or plain) and of EQSD2
   (equivariant and plain), networks at full width, card vs CPU
   (``card_vs_cpu``), then each trained equivariant network, the diffusion
   team's ε-field and sampler among them, within 1e-5·(1 + |f|) of exact
   equivariance on the card; both diffusion policies' DDPM samplers at 4096
   rows card vs CPU from the same draws within 1e-5·(1 + |a|), with the ms
   of one sample;
33. eqsd_main_path — EQSD (equivariant Gaussian, equivariant diffusion and
   plain diffusion teams) and EQSD2 (equivariant and plain) on
   BimanualReacher @4096 at the presets (horizon 16, batch 32768, 4 epochs,
   diffusion_iter 5, fp32), as two_agent_main_path with a profiled window
   on the equivariant diffusion team only, and the equivariance check above
   at full width;
34. eqsd_entry_path — ``train.main algo=eqsd algo.diffusion=true
   task=BimanualReacher num_envs=4096`` through ppo_entry_path: an eval and
   a checkpoint at iteration 4, resumed to 6 bitwise equal to an
   uninterrupted run;
35. vision_reference — each module of the vision tier (the point-cloud
   encoders, ``PointNetEncoderXYZ``, ``TimestepEmbedder``, ``ResEncoder``,
   ``DINOEncoder``, the PPOV actor) and the vision tasks' views at 4096 envs
   on the card against the CPU (``VISION_TOL``·(1 + |f|) for the conv nets,
   ``EQ_TOL`` for the rest); two iterations of PPOV (ReacherVision) and IPPOV
   (BimanualReacherVision) at a small size, card vs CPU (``card_vs_cpu``);
   ``DiffusionPolicy``'s sampler at 4096 rows card vs CPU, with its ms;
36. vision_main_path — ``algo=ppov task=ReacherVision num_envs=4096`` and
   ``algo=ippov task=BimanualReacherVision num_envs=4096`` at the presets
   (horizon 16, batch 32768, 4 epochs: 8 updates per iteration; fp32
   without TF32), as two_agent_main_path: ms/iter, device ms, busy share,
   peak memory, the render's ms per step and the memory it adds, and the
   trunk ops' share of the profiled device time (``TRUNK_OPS``);
37. vision_entry_path — ``train.main algo=ppov task=ReacherVision
   num_envs=4096`` through ppo_entry_path: an eval (rendered from the eval
   env's state) and a checkpoint at iteration 1, resumed to 2 bitwise equal
   to an uninterrupted run, the checkpoint's bytes and save and load seconds.

38. ddpgv_reference — the port's host ring built on this machine, its
   gather bitwise numpy fancy indexing at ``default_rng(0)``'s indices, the
   pinned-staging gather and host-to-device copies bitwise the CPU batch;
   the warm-up and two iterations of DDPGV at ``DDPGV_REF``'s size card vs
   CPU (``card_vs_cpu``, at the seed tools/diffusion_conditioning.py
   measures as well-conditioned);
39. ddpgv_main_path — ``algo=ddpgv task=ReacherVision num_envs=4096`` at the
   preset (batch 8192, 4 updates per iteration, memory 5e6: host ring 1220 ×
   4096 × 28,200 B, ~140.9 GB of virtual host memory): ms/iter, device ms
   and busy share, the render's ms per step, the gather, copy and write
   ms of the host hop, peak device memory, host RSS and threads;
40. ddpgv_entry_path — ``train.main algo=ddpgv`` @4096: an eval of 150
   rendering envs and a checkpoint at iteration 2, the checkpoint restored
   bitwise, the resume as the JAX package defines it (no ring in the state,
   no warm-up, the ring refilled);
41. dist_one_rank — PQL-D Cartpole @4096 through ``parallel.initialize``
   with a one-rank NCCL group: bitwise equal to the run without a group, 8
   ``c51_td_target`` launches per iteration, the all-reduce of the critic's
   gradient timed;
42. legacy_contact_check — the legacy viscous groups (``ground_contacts``,
   ``sphere_box_contacts``, ``box_ground_contacts``) in both forms and the
   per-pair anchored loops (``*_anchored_s``) on seeded states
   (``legacy_states``) of the Ant @4096 and the AllegroHand @8192 that reach
   every branch (separated, penetrating, capped, pressed apart, Coulomb and
   viscous friction, fresh touch, sticking, sliding, a sphere inside the
   box; counted on the card): the matrix form against the scalar form, the
   loops against the vectorized groups, the card against the CPU; each
   form's kernel nodes and graph ms; one Ant control step with
   ``ground_contacts_s`` as its contact function, graphed, bitwise its eager
   step and within STEP_TOL of the CPU's, its nodes and replay ms;
43. contact_lab — every scene of ``pql_tpu_torch.contact_lab`` on the card
   (one env each, each scene's control step a captured graph): verdict,
   numbers and printed lines, wall seconds, control steps and graph nodes
   per control step; every scene outside ``KNOWN_REGRESSIONS`` must pass;
44. visualize_path — ``train.main`` (PQL-D Cartpole @4096, ``VIS_ITERS``
   iterations with evals) writes a best model; ``pql_tpu_torch.visualize``
   rolls it for ``VIS_EPISODES`` episode batches; its printed lines and
   returns equal those of an ``Evaluator`` built from the same snapshot
   with the same generator; ms per episode batch;
45. ratio_sweep — ``pql_tpu_torch.ratio_sweep.main`` on AllegroHand @8192
   (``algo=pql``) at ``SWEEP_POINTS``, ``SWEEP_SECONDS`` each: per point the
   JAX script's JSON keys, exactly cs critic and cs/ca actor updates per
   iteration over the window, env-steps/s and the three rates, the eval
   return, the table file, 0 ``c51_td_target`` launches.

``--entry`` runs ``ENTRY_RUNS`` instead: PPO Ant, IPPO and PPOV
ReacherVision through ppo_entry_path, IDDPG at its full preset (ring 5e6)
through baseline_entry_path.

Each main path, and each of phases 11, 12, 14, 16-18, 20-41, 44 and 45, resets the
kernels' launch counts just before it drives the port and reads them just
after (0 ``c51_td_target`` launches on every on-policy path). Then the ``{"kernels": [...]}`` line, the nvidia-smi
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

import numpy as np

from pql_tpu_torch.envs.rigid import graph_kernel_nodes

MAIN_WARM_ITERS = 5  # untimed iterations of each route first
MAIN_BLOCKS = 4  # timed blocks, alternating kernel and plain routes
MAIN_BLOCK_ITERS = 10  # iterations per timed block
PROFILED_ITERS = 5  # iterations under torch.profiler after the timed ones
TOL = 1e-5  # kernel vs plain version, fp32 (ulp-level: support by i*dz+v_min vs linspace, FMA)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
COLD_SETS = 32  # input sets rotated for cold times: 32 x 5.08 MB = 163 MB, over 3x the 50 MB L2
# PQL's networks on AllegroHand: the critic's (400,386 elements) and the actor's (193,936) parameter shapes
CLIP_ADAMW_SHAPES = {
    "critic": [(512, 69), (512,), (256, 512), (256,), (128, 256), (128,), (1, 128), (1,)] * 2,
    "actor": [(512, 53), (512,), (256, 512), (256,), (128, 256), (128,), (16, 128), (16,)],
}
# The kernel's squared norm is at most 25 fp32 roundings deep (8 fmas a thread, two 8-level butterflies, one
# add of the partials for up to 256 blocks), so its square root is within (25 / 2 + 1) * 2**-24 = 8.0e-7 of the
# exact norm; a full chunk of 2,048 squares lost or doubled moves it by ~2.5e-3 at these shapes.
CLIP_NORM_RTOL = 1e-6
CLIP_ADAMW_COLD_SETS = 8  # 8 x 11.2 MB (the critic's) = 90 MB, past the 50 MB L2
RIGID_TASKS = ("Ant", "Humanoid", "Anymal")
PHYS_ENVS = 4096
PHYS_ROLL = 50  # control steps before the compared one
PHYS_REPS = 5  # graph replays per timing
PHYS_TIMINGS = 3  # timings per task
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
# FrankaCubeStack's, card against CPU: STEP_TOL on the arm and the reward,
# the cubes as positions, the grasp and success flags exact; at most
# FRANKA_MAX_FLIPS of the 8192 envs may differ beyond them (a grasp test
# within rounding of its 0.05 range may take the other branch), each reported.
FRANKA_STEP_TOL = {"q": (1e-4, 1e-5), "qd": (1e-4, 1e-4), "cube_a": (1e-4, 1e-5), "cube_b": (1e-4, 1e-5),
                   "grasped": (0.0, 0.0), "reward": (1e-4, 1e-5), "success": (0.0, 0.0)}
FRANKA_ENVS = 8192
FRANKA_MAX_FLIPS = 8
HAND_WARM_ITERS = 2  # untimed iterations after the warm-up
HAND_BLOCKS = 3  # timed blocks of HAND_BLOCK_ITERS iterations
HAND_BLOCK_ITERS = 3
HAND_PROFILED_ITERS = 1
ENTRY_ARGV = ("algo=pql_d", "task=Cartpole", "num_envs=4096")
ENTRY_CALLS = 8  # train_block calls of iters_per_call = 4 iterations
ENTRY_EVAL_FREQ = 8  # evals at iterations 8, 16, 24, 32
ENTRY_CKPT_FREQ = 12  # full checkpoints at iterations 12, 24
EVAL_TIMINGS = 1  # timed eval calls after the entry run
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
DDPG_GATE_SEEDS = (0,)  # the checked seed (tools/gate_trace.py traces seeds 1-4)
# the JAX package's two-agent quick check (its verify notes: algo=ippo
# task=BimanualReacher num_envs=1024 algo.batch_size=4096, "train/success_rate
# should reach ~1.0"): PPO's preset otherwise, horizon 16, 4 epochs
IPPO_GATE = dict(task="BimanualReacher", num_envs=1024, eval_num_envs=32, algo__batch_size=4096,
                 logging__mode="off")
# read at iteration 50, where the CPU traces of both packages (seeds 0-2,
# tools/gate_trace.py --algo=ippo; PERF.md §6) read success rates 0.99-1.00
IPPO_ITERS = 50
IPPO_THRESHOLD = 0.95
# algo -> (configuration, iterations, threshold, the iterations whose best eval return the gate reads)
GATES = {"pql": (LEARNING_GATE, LEARNING_ITERS, LEARNING_THRESHOLD, (LEARNING_ITERS,)),
         "pql_d": (LEARNING_GATE, LEARNING_ITERS, LEARNING_THRESHOLD, (LEARNING_ITERS,)),
         "ddpg": (DDPG_GATE, DDPG_ITERS, DDPG_THRESHOLD, DDPG_EVALS),
         "ippo": (IPPO_GATE, IPPO_ITERS, IPPO_THRESHOLD, (IPPO_ITERS,))}
BASELINE_ALGOS = ("ddpg", "sac", "crossq")
BASELINE_REF = dict(num_envs=64, algo__batch_size=256, algo__memory_size=64 * 64, algo__warm_up=8)
# the JAX bench's cartpole_ddpg_16 (bench.py:156-164): the Cartpole baseline cell and the entry point's
DDPG_CARTPOLE_ARGV = ("algo=ddpg", "task=Cartpole", "num_envs=16", "algo.batch_size=1024", "algo.memory_size=1000000")
DDPG_CARTPOLE_DEPTH = (4, 4, 12, 2)  # warm, blocks x iterations timed, profiled: 54 iterations
BASELINE_ANT_DEPTH = (2, 2, 4, 1)  # 11 iterations after the warm-up
BASELINE_ENTRY_ITERS = (24, 30)  # the first run stops after 24 iterations, the resumed one after 30
BASELINE_ENTRY_EVAL_FREQ = 12  # evals at iterations 12, 24 (and 36 on no run)
BASELINE_ENTRY_CKPT_FREQ = 12
# the on-policy tier: small card-vs-CPU runs, then the full-width paths
# (PPO's task presets; the two-agent presets at 4096 envs) as (argv, depth:
# warm, blocks x iterations timed, profiled)
PPO_REF = [("ppo", dict(task="Cartpole", algo__value_norm=True)), ("ippo", dict(task="BimanualReacher")),
           ("ippo", dict(task="BimanualReacherSym", algo__same_policy=True)), ("mappo", dict(task="BimanualReacher"))]
PPO_REF_SIZE = dict(num_envs=64, algo__horizon_len=8, algo__batch_size=128, algo__update_times=2)
PPO_PATHS = [(("algo=ppo", "task=Ant", "task_param=true"), (1, 1, 2, 1)),
             (("algo=ppo", "task=FrankaCubeStack", "task_param=true"), (1, 1, 2, 1))]
TWO_AGENT_PATHS = [(("algo=ippo", "task=BimanualReacher", "num_envs=4096"), (2, 2, 3, 1)),
                   (("algo=mappo", "task=BimanualReacher", "num_envs=4096"), (2, 2, 3, 1)),
                   (("algo=ippo", "task=BimanualReacherSym", "num_envs=4096", "algo.same_policy=true"), (2, 2, 3, 1))]
SYM_TRACKER_BAND = (0.45, 0.55)  # the mirrored share of BimanualReacherSym's episodes
# the rest of the two-agent tier: small card-vs-CPU runs, IDDPG at its preset
# (batch 8192, memory 5e6: ring 1220 x 4096 x 55 fp32) and the five on-policy
# agents at theirs (horizon 16, batch 32768, 4 epochs), each @4096
TWO_AGENT_REF = [("iddpg", dict(BASELINE_REF, task="BimanualReacher")),
                 ("qtotv1", dict(PPO_REF_SIZE, task="BimanualReacher", algo__value_norm=True)),
                 ("qtotv2", dict(PPO_REF_SIZE, task="BimanualReacher")),
                 ("iart", dict(PPO_REF_SIZE, task="BimanualReacher")),
                 ("ippoteam", dict(PPO_REF_SIZE, task="BimanualReacherSym")),
                 ("ippoteam2", dict(PPO_REF_SIZE, task="BimanualReacher"))]
IDDPG_ARGV = ("algo=iddpg", "task=BimanualReacher", "num_envs=4096")
IDDPG_DEPTH = (4, 3, 10, 2)  # warm, blocks x iterations timed, profiled: 36 iterations after the warm-up
# (a profiled window on QTOTV1, IART and IPPOTeam only: the script's time
# limit holds the equivariant tier too)
TEAM_PATHS = [((f"algo={a}", "task=BimanualReacher", "num_envs=4096"), (1, 2, 1, int(a in ("qtotv1", "iart",
                                                                                          "ippoteam"))))
              for a in ("qtotv1", "qtotv2", "iart", "ippoteam", "ippoteam2")] + [
              (("algo=ippoteam", "task=BimanualReacherSym", "num_envs=4096"), (1, 2, 1, 0))]
# the entry point's IDDPG run: the ring cut to 100 slots (409,600 transitions)
# to keep the script's checkpoints small, stopped after 12 iterations (an eval
# and a checkpoint at 12) and resumed to 15; ``--entry`` runs the full 5e6 ring
IDDPG_ENTRY_ARGV = IDDPG_ARGV + ("algo.memory_size=409600",)
IDDPG_ENTRY_ITERS = (12, 15)
# the equivariant tier: the EMLP layers and small card-vs-CPU runs of every
# agent (EMLP at full width), then the full-width paths at the presets
# (horizon 16, batch 32768, 4 epochs, EMLP 256 x 5) @4096 as (argv, depth), a
# profiled window on EQ, EQSC and EQS4 only; the entry point with EQS4
EQ_TOL = 1e-5  # |f(x·G_in) − f(x)·G_out| and card vs CPU, relative to 1 + |f|: fp32 without TF32
EQ_CLASSES = dict(algo__act_class="DiagGaussianEquivariantMLPPolicy", algo__cri_class="MLPCriticEquivariant")
EQ_REF = [(a, dict(PPO_REF_SIZE, task="BimanualReacher")) for a in ("eq", "eqs", "eqg", "eqsc", "eqsdata", "eqs4",
                                                                    "mp")] + [
    ("ippoteam", dict(PPO_REF_SIZE, task="BimanualReacherSym", **EQ_CLASSES)),
    ("iart", dict(PPO_REF_SIZE, task="BimanualReacher", **EQ_CLASSES))]
EQ_PATHS = [((f"algo={a}", "task=BimanualReacher", "num_envs=4096"), (1, 1, 3, int(a in ("eq", "eqsc", "eqs4"))))
            for a in ("eq", "eqs", "eqg", "eqsc", "eqsdata", "eqs4", "mp")] + [
    (("algo=eq", "task=BimanualReacherSym", "num_envs=4096"), (1, 1, 3, 0)),
    (("algo=ippoteam", "task=BimanualReacher", "num_envs=4096", "algo.act_class=DiagGaussianEquivariantMLPPolicy",
      "algo.cri_class=MLPCriticEquivariant"), (1, 1, 3, 0))]
EQ_ENTRY_ARGV = ("algo=eqs4", "task=BimanualReacher", "num_envs=4096")
EQ_ENTRY_ITERS = (4, 6)  # an eval and a checkpoint at 4, resumed to 6
# the diffusion tier: small card-vs-CPU runs of EQSD with each of its four
# team actors and of EQSD2 (equivariant and plain; networks at full width:
# the equivariant diffusion net an EMLP 512 x 5 on 256 + 24 + 4 inputs, the
# plain one a [1024, 512, 256] Mish trunk), the DDPM sampler at 4096 rows,
# then the full-width paths at the presets (horizon 16, batch 32768, 4
# epochs, diffusion_iter 5) @4096 as (argv, depth), a profiled window on the
# equivariant diffusion team only; the entry point with it. The reference
# runs take seed 0: at the default seed (42) EQSD with the equivariant
# diffusion team crosses a PPO clip boundary within rounding in its second
# iteration, so a 1e-7 relative change of its initial weights moves the right
# critic's step by 1.3% of its norm on the CPU alone; at seed 0 no step of
# the six moves by more than 2e-4 under such a change
# (tools/diffusion_conditioning.py)
PLAIN_ARGV = ("algo.act_class=DiagGaussianMLPPolicy", "algo.cri_class=MLPCritic")
PLAIN_CLASSES = dict(algo__act_class="DiagGaussianMLPPolicy", algo__cri_class="MLPCritic")
EQSD_REF = [(a, dict(PPO_REF_SIZE, task="BimanualReacher", seed=0, **extra))
            for a, extra in (("eqsd", {}), ("eqsd", dict(algo__diffusion=True)),
                             ("eqsd", dict(algo__diffusion=True, **PLAIN_CLASSES)), ("eqsd", PLAIN_CLASSES),
                             ("eqsd2", {}), ("eqsd2", PLAIN_CLASSES))]
SAMPLE_ROWS = 4096
SAMPLE_REPS = 5  # timed sampler calls after one untimed
EQSD_ARGV = ("algo=eqsd", "task=BimanualReacher", "num_envs=4096")
EQSD_PATHS = [(EQSD_ARGV, (1, 1, 3, 0)), (EQSD_ARGV + ("algo.diffusion=true",), (1, 1, 3, 1)),
              (EQSD_ARGV + ("algo.diffusion=true",) + PLAIN_ARGV, (1, 1, 3, 0)),
              (("algo=eqsd2", "task=BimanualReacher", "num_envs=4096"), (1, 1, 3, 0)),
              (("algo=eqsd2", "task=BimanualReacher", "num_envs=4096") + PLAIN_ARGV, (1, 1, 3, 0))]
EQSD_ENTRY_ARGV = EQSD_ARGV + ("algo.diffusion=true",)
EQSD_ENTRY_ITERS = (4, 6)  # an eval and a checkpoint at 4, resumed to 6
# the vision tier: modules card vs CPU (the conv nets within VISION_TOL·(1 + |f|): ten fp32 convolutions
# deep, cuDNN and oneDNN sum in different orders; the others within EQ_TOL), short PPOV / IPPOV runs
# (card_vs_cpu), then PPOV ReacherVision and IPPOV BimanualReacherVision @4096 at the presets
VISION_TOL = 1e-4
VISION_ROWS = 64  # the modules' batch card vs CPU
# One update per iteration and seeds whose runs are well-conditioned: the PointNet actors' max over
# points and Adam's normalization of their many near-zero gradient elements make a run's two-iteration
# step move by 1-20% of its norm under a 1e-7 change of the initial weights at most sizes and seeds, on
# the CPU alone (tools/diffusion_conditioning.py --refs vision); these move by <= 0.05% (PERF.md, PR 11).
VISION_REF = [("ppov", dict(task="ReacherVision", num_envs=16, algo__horizon_len=8, algo__batch_size=128,
                            algo__update_times=1, seed=3)),
              ("ippov", dict(task="BimanualReacherVision", num_envs=8, algo__horizon_len=4, algo__batch_size=32,
                             algo__update_times=1, seed=0))]
# DDPGV card vs CPU: one update per iteration at a seed that
# tools/diffusion_conditioning.py --refs vision measures as well-conditioned
# under a change of the weights and of the rendered frames (seed 3: 0.28% and
# 0.063% of the actor's step; seed 0 moved 4.3% card vs CPU, PERF.md §6)
DDPGV_REF = [("ddpgv", dict(task="ReacherVision", num_envs=16, algo__horizon_len=2, algo__batch_size=64,
                            algo__memory_size=1024, algo__update_times=1, seed=3))]
VISION_PATHS = [(("algo=ppov", "task=ReacherVision", "num_envs=4096"), (1, 1, 1, 1)),
                (("algo=ippov", "task=BimanualReacherVision", "num_envs=4096"), (1, 1, 2, 1))]
TRUNK_OPS = r"convolution|group_norm|max_pool2d"  # the ops of the ResNet trunk alone (the other nets have none)
RENDER_REPS = 5
VISION_ENTRY_ARGV = ("algo=ppov", "task=ReacherVision", "num_envs=4096")
VISION_ENTRY_ITERS = (1, 2)  # an eval and a checkpoint at 1, resumed to 2 (~8.4 s per iteration)
VISION_ENTRY_FREQ = 1
# the vision tier's off-policy half and multi-process PQL
DDPGV_ARGV = ("algo=ddpgv", "task=ReacherVision", "num_envs=4096")  # batch 8192, 4 updates, memory 5e6
DDPGV_DEPTH = (1, 1, 3, 1)  # warm, blocks x iterations timed, profiled: 5 iterations after the warm-up
DDPGV_ROW_BYTES = 28200  # one (slot, env) row of the host ring: two 13,824-byte frames and the fp16 rows
HOP_REPS = 5  # timed gathers and copies of the host hop
DDPGV_ENTRY_ITERS = (2, 4)  # an eval and a checkpoint at 2; the resumed run stops at env step 5 x E
RING_CHECK = (8, 64, 512)  # slots, envs, batch of the host ring's check against numpy
DIST_ARGV = ("algo=pql_d", "task=Cartpole", "num_envs=4096")
DIST_ITERS = 3
ALLREDUCE_REPS = 20
PPO_ENTRY_ARGV = ("algo=ppo", "task=Cartpole")  # 4096 envs, horizon 16, batch 32768, 4 epochs
PPO_ENTRY_ITERS = (8, 12)  # the first run stops after 8 iterations, the resumed one after 12
PPO_ENTRY_EVAL_FREQ = 4  # and the checkpoint period
# ``python3 chip_smoke.py --entry``: the CLI acceptance runs; the on-policy
# ones through ppo_entry_path, stopped after 4 iterations and resumed to 6
# (an eval at 4), IDDPG (a warm-up) through baseline_entry_path
ENTRY_RUNS = [(("algo=ppo", "task=Ant", "task_param=true"), (4, 6)),
              (("algo=ippo", "task=BimanualReacher", "num_envs=4096"), (4, 6)),
              (VISION_ENTRY_ARGV, (4, 6)),
              (IDDPG_ARGV, BASELINE_ENTRY_ITERS)]
# The legacy contacts and the per-pair anchored loops (phase 42): seeded
# states of the Ant and the AllegroHand at the main paths' widths. Card
# against CPU: wrenches within the force a STEP_TOL (HAND_STEP_TOL) error of
# position and velocity makes through the model's spring and damper (rtol
# 1e-4, atol kp·q_atol + kd·qd_atol), the contact state within its
# "contact" tolerance, at most PHYS_MAX_FLIPS (HAND_MAX_FLIPS) envs beyond
# them; the matrix form against the scalar form within 2e-3 (the JAX
# package's bound for its two forms, tests/test_scalar_physics.py); the
# per-pair loops against the vectorized groups within the JAX package's
# bound for them (tests/test_contact_anchored.py: wrenches 1e-4, contact
# state 1e-5).
LEGACY_TASKS = {"Ant": PHYS_ENVS, "AllegroHand": HAND_ENVS}
LEGACY_FORMS_TOL = 2e-3
ANCHORED_TOL = dict(rtol=1e-4, atol=1e-4)
ANCHORED_STATE_ATOL = 1e-5
LEGACY_REPS = 20  # graph replays per form timing
# The lab (phase 43), visualize (44) and the ratio sweep (45)
VIS_ARGV = ("algo=pql_d", "task=Cartpole", "num_envs=4096")
VIS_ITERS = 8  # two train_block calls of 4; evals at 4 and 8 write the best model
VIS_EPISODES = 3
SWEEP_ARGV = ("task=AllegroHand", "num_envs=8192")  # algo=pql, fp32 (README's ratio sweep)
SWEEP_POINTS = "8:2,4:2,16:2"
SWEEP_SECONDS = 2.0
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
    from pql_tpu_torch.envs.rigid import collected_gc

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as graph capture requires
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with collected_gc(), torch.cuda.graph(graph):
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


def check_clip_adamw(dev) -> dict:
    """clip_adamw_step at the critic's and the actor's shapes: against its
    plain version bit for bit with the norm under the max; with clipping on,
    bit for bit once the plain clip takes the kernel's norm, that norm within
    ``CLIP_NORM_RTOL`` of the fp64 one, and within ``TOL`` of the plain
    version with its own norm (``max_abs_err``); two launches bitwise equal;
    then its warm and cold times, one copy of the same bytes, the plain tail
    captured as one graph (and its kernel nodes), and the bound. Results by
    shape; the critic's on top."""
    import torch
    from pql_tpu_torch.algos.base import capture_graph
    from pql_tpu_torch.ops.kernels import clip_adamw_step, clip_adamw_step_plain

    hyper = (5e-4, (0.9, 0.999), 1e-8, 0.01)
    max_norm = 0.5
    gen = torch.Generator(device=dev).manual_seed(0)
    adam = torch.tensor([-5e-4 / (1 - 0.9 ** 7), (1 - 0.999 ** 7) ** 0.5], device=dev)

    def draw(shapes, scale):
        r = lambda sh: torch.randn(sh, generator=gen, device=dev)  # noqa: E731
        return ([r(sh) for sh in shapes], [r(sh) * scale for sh in shapes], [r(sh) * 1e-2 for sh in shapes],
                [r(sh).square() * 1e-4 for sh in shapes])

    def clone(ts):
        return [[t.clone() for t in x] for x in ts]

    def same(a, b):
        return all(torch.equal(x, y) for xa, ya in zip(a, b) for x, y in zip(xa, ya))

    out = {}
    for name, shapes in CLIP_ADAMW_SHAPES.items():
        n = sum(math.prod(sh) for sh in shapes)
        got = draw(shapes, 1e-4)  # the norm under the max
        want, again = clone(got), clone(got)
        clip_adamw_step(*got, adam, max_norm, *hyper)
        clip_adamw_step(*again, adam, max_norm, *hyper)
        clip_adamw_step_plain(*want, adam, max_norm, *hyper)
        torch.cuda.synchronize()
        check(same(got, want), f"clip_adamw_step {name}: not the plain version bit for bit under the max")
        check(same(got, again), f"clip_adamw_step {name}: two launches differ")
        got = draw(shapes, 1.0)  # clipped: a norm of ~600 against the max's 0.5
        want, own = clone(got), clone(got)
        norm = clip_adamw_step(*got, adam, max_norm, *hyper)
        clipped = [torch.where(norm < max_norm, g, g / norm * max_norm) for g in want[1]]
        clip_adamw_step_plain(want[0], clipped, want[2], want[3], adam, None, *hyper)
        plain_norm = clip_adamw_step_plain(*own, adam, max_norm, *hyper)  # the plain clip, its own norm
        torch.cuda.synchronize()
        check(same([got[0], got[2], got[3]], [want[0], want[2], want[3]]),
              f"clip_adamw_step {name}: not the plain step of the gradients its norm clips")
        exact = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in want[1])))
        norm_rel_err = abs(float(norm) - exact) / exact
        plain_rel_err = abs(float(plain_norm) - exact) / exact
        check(norm_rel_err <= CLIP_NORM_RTOL,
              f"clip_adamw_step {name}: norm {float(norm)} is {norm_rel_err:.3g} off the fp64 norm {exact}")
        max_abs_err = max(float((a - b).abs().max()) for i in (0, 2, 3) for a, b in zip(got[i], own[i]))
        check(max_abs_err <= TOL, f"clip_adamw_step {name}: {max_abs_err:.3g} off the plain version with clipping on")

        sets = [draw(shapes, 1.0) for _ in range(CLIP_ADAMW_COLD_SETS)]
        ms = cuda_ms([lambda: clip_adamw_step(*sets[0], adam, max_norm, *hyper)], 200)
        ms_cold = cuda_ms([lambda s=s: clip_adamw_step(*s, adam, max_norm, *hyper) for s in sets],
                          10 * CLIP_ADAMW_COLD_SETS)
        flat = [torch.empty(7 * n // 2, device=dev) for _ in range(2 * CLIP_ADAMW_COLD_SETS)]  # 14n B each way
        same_bytes_ms = cuda_ms([lambda k=k: flat[2 * k + 1].copy_(flat[2 * k]) for k in range(CLIP_ADAMW_COLD_SETS)],
                                10 * CLIP_ADAMW_COLD_SETS)
        plain_ms = cuda_ms([lambda: clip_adamw_step_plain(*sets[0], adam, max_norm, *hyper)], 20)
        plain_nodes = capture_graph(lambda: clip_adamw_step_plain(*sets[0], adam, max_norm, *hyper), dev)[2]
        nbytes = 28 * n  # g, p, m, v read once and p, m, v written once, fp32
        flops = 16 * n  # the square, the clip's two, AdamW's ~13 an element
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOPS
        out[name] = dict(tensors=len(shapes), elements=n, max_abs_err=max_abs_err, norm_rel_err=norm_rel_err,
                         plain_norm_rel_err=plain_rel_err,
                         ms=ms, ms_cold=ms_cold, same_bytes_ms=same_bytes_ms, plain_ms=plain_ms,
                         plain_kernel_nodes=plain_nodes, kernel_nodes=2, bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations", bytes=nbytes, flops=flops)
        del sets, flat
    critic = out["critic"]
    return dict(name="clip_adamw_step", max_abs_err=max(o["max_abs_err"] for o in out.values()), deterministic=True,
                shapes=out,
                **{k: critic[k] for k in ("ms", "ms_cold", "same_bytes_ms", "plain_ms", "bound_ms", "bound_by")},
                library_ms=None)


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
    # two routes, 12 updates an iteration of two launches each, but each optimizer's first (``opt.step()``)
    check(launches["clip_adamw_step"] == 2 * 2 * (12 * iters - 2),
          f"clip_adamw_step launched {launches['clip_adamw_step']} times in {iters} iterations of two routes")

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


def device_records(prof) -> tuple[int, float]:
    """(records, µs) of the device's work in a profile (kernels, copies and
    sets; user annotations aside), summed over the raw Kineto events. The
    same count and time as the device rows of ``key_averages`` without
    building a Python event per record (``tools/profile_read.py``: a PPO
    Ant iteration, 437,844 records and 490.038 ms either way, read in
    1.5 s against 28.8 s on an NVIDIA H100 80GB HBM3 at 700 W, torch 2.11)."""
    from torch.autograd import DeviceType

    n, us = 0, 0.0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            n += 1
            us += e.duration_ns() / 1e3
    return n, us


def step_tol(task) -> dict:
    """Per state field (and reward, flags): (rtol, atol), atol a float or a
    per-column tensor; the rigid tasks' STEP_TOL, FrankaCubeStack's or the hand's."""
    import torch

    if type(task).__name__ == "FrankaCubeStack":
        return FRANKA_STEP_TOL
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
        replay_in_profile, replay_us = device_records(prof)
        check(replay_in_profile >= 0.99 * launches, f"{name}: the profiler does not trace the graph's kernels")
        # the graph's device time: its kernels' durations in a profile of one replay
        graph_kernel_ms = replay_us / 1e3
        out[name] = dict(
            envs=E, rollout_steps=PHYS_ROLL, rollout_s=roll_s, graphed_equals_eager_bitwise=True,
            card_vs_cpu_max_abs_err=max_err, card_vs_cpu_envs_beyond_tol=flips, terminated=int(g["terminated"].sum()),
            engaged_pairs=int((g["contact"][:, 3::4] > 0.5).sum()) if "contact" in g else None,
            graph_kernel_ms=graph_kernel_ms, graph_replay_period_ms=statistics.median(period_ms),
            graph_replay_period_ms_timings=period_ms, graph_replay_host_ms=statistics.median(submit_ms),
            graph_build_s=graph.build_s, eager_wall_ms=statistics.median(eager_ms),
            launches_per_control_step=launches, graph_nodes=nodes, graph_replay_kernels_in_profile=replay_in_profile,
        )
        if "success" in g:
            out[name]["goals_reached"] = int(g["success"].sum())
        if "grasped" in g:
            out[name]["grasped"] = int(g["grasped"].sum())
    return out


HAND_KERNEL_ENVS = (8192, 16384)
HAND_KERNEL_BLOCKS = (32, 64, 128)
HAND_KERNEL_REPS = 20  # back-to-back launches a timing
HAND_KERNEL_TIMINGS = 5
# the fused kernel against the eager step, |Δ| / (1 + |eager|), and the goal
# distance within which success may flip (tests/test_torch_hand_kernel.py says why)
HAND_KERNEL_TOL, HAND_KERNEL_CUBE_V_TOL, HAND_GOAL_MARGIN = 1e-5, 2e-3, 1e-6
PEAK_FP32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12  # one H100 SXM (NVIDIA's data sheet)


def hand_step_bytes(task) -> int:
    """Bytes one env's control step needs: its rows of q, qd, the contact
    state, the target, the action and the draw read once; q, qd, the
    contact state and the target, the reward, terminated and success written once."""
    m, nc = task.model, 4 * task.n_contact_pairs
    return 4 * (m.nq + m.nv + nc + 4 + m.nu + 3) + 4 * (m.nq + m.nv + nc + 4) + 4 + 1 + 4


def hand_kernel_gaps(task, state: dict, got: dict, want: dict, target_atol: float = 0.0) -> tuple[list[int], dict]:
    """The envs where a hand step ``got`` differs from the eager step ``want``
    (both from ``state``) beyond ``HAND_KERNEL_TOL`` in |Δ| / (1 + |eager|)
    over q, qd, the contact state and the reward (the cube's six velocities:
    ``HAND_KERNEL_CUBE_V_TOL``), in where a value is NaN, in terminated or
    success, or in the target beyond ``target_atol``, but for an env whose
    goal distance after the step lies within ``HAND_GOAL_MARGIN`` of the
    success tolerance; and each field's largest gap over the other envs."""
    import torch

    from pql_tpu_torch.envs.hand import rot_dist

    got = {k: v.cpu() for k, v in got.items()}
    want = {k: v.cpu() for k, v in want.items()}
    n, cq = want["q"].shape[0], task.cube_q
    near = (rot_dist(want["q"][:, cq + 3 : cq + 7], state["target"].cpu()) - task.success_tolerance).abs()
    off = torch.zeros(n, dtype=torch.bool)
    gaps = {}
    for k in ("q", "qd", "contact", "reward"):
        g, w = got[k].float().reshape(n, -1), want[k].float().reshape(n, -1)
        gap = ((g - w).abs() / (1.0 + w.abs())).nan_to_num(0.0)
        tol = torch.full(gap.shape[-1:], HAND_KERNEL_TOL)
        if k == "qd":
            tol[task.cube_v : task.cube_v + 6] = HAND_KERNEL_CUBE_V_TOL
        off |= (gap > tol).any(-1) | (torch.isnan(g) != torch.isnan(w)).any(-1)
        gaps[k] = gap
    for k in ("terminated", "success", "target"):
        diff = (got[k] != want[k]) if k != "target" else ((got[k] - want[k]).abs() > target_atol)
        off |= diff.reshape(n, -1).any(-1) & (near > HAND_GOAL_MARGIN)
    ok = ~off
    cube = torch.zeros(gaps["qd"].shape[-1], dtype=torch.bool)
    cube[task.cube_v : task.cube_v + 6] = True
    gaps["qd_cube"], gaps["qd"] = gaps["qd"][:, cube], gaps["qd"][:, ~cube]
    rest = {k: float(v[ok].max()) if bool(ok.any()) else None for k, v in gaps.items()}
    return [int(i) for i in off.nonzero().flatten()], rest


def hand_kernel_check(dev, smi: str, tasks=HAND_TASKS, envs=HAND_KERNEL_ENVS) -> dict:
    """The hand's fused step kernel: its build from cold (nvcc's seconds,
    ptxas's registers and spills), then at each env count one control step
    from a state rolled out through it (auto-reset, per-step draws) against
    the eager step on the card and on the CPU; its device time by CUDA
    events at each block size; the eager step captured as a CUDA graph
    (what the card ran before) as the plain time; the bound: the traced ops
    over 67 TFLOP/s and the bytes over 3.35 TB/s."""
    import statistics

    import torch

    from pql_tpu_torch.envs import VecEnv, make_task
    from pql_tpu_torch.envs.rigid import GraphedStep
    from pql_tpu_torch.ops import kernels

    out = {}
    for name in tasks:
        task = make_task(name)
        t0 = time.perf_counter()
        header = kernels.hand_step_header(task)
        trace_s = time.perf_counter() - t0
        build = kernels.build_hand_step(header)
        progs = task.kernel_programs
        ops = task.substeps * progs["substep"].op_count() + progs["finish"].op_count()
        res = dict(trace_and_emit_s=trace_s, build_s=build["seconds"],
                   ptxas=[ln for ln in build["ptxas"].splitlines() if "hand_control_step" in ln or "Used" in ln
                          or "spill" in ln],
                   ops_per_env=ops, ops_per_substep=progs["substep"].op_count(), bytes_per_env=hand_step_bytes(task),
                   by_envs={})
        for E in (envs if name == "AllegroHand" else envs[:1]):
            gen = torch.Generator().manual_seed(0)
            env = VecEnv(task, E)
            s, _ = env.reset(task.draw_reset(gen, E).to(dev))
            n0 = kernels.LAUNCHES["hand_control_step"]
            for _ in range(PHYS_ROLL):
                a = (torch.rand(E, task.action_dim, generator=gen) * 2.0 - 1.0).to(dev)
                s, *_ = env.step(s, a, task.draw_reset(gen, E).to(dev), task.draw_step(gen, E).to(dev))
            check(kernels.LAUNCHES["hand_control_step"] == n0 + PHYS_ROLL, f"{name}@{E}: one launch a control step")
            check(not task._graphs, f"{name}@{E}: a graph was captured on the kernel's path")
            state = s.state
            action = (torch.rand(E, task.action_dim, generator=gen) * 2.0 - 1.0).to(dev)
            draw = task.draw_step(gen, E).to(dev)

            def fields(r):
                nxt, reward, terminated, info = r
                return dict(nxt, reward=reward, terminated=terminated, **info)

            got = fields(task.dynamics(state, action, draw))
            eager = fields(task.control_step(state, action, draw))
            cpu = fields(task.control_step({k: v.cpu() for k, v in state.items()}, action.cpu(), draw.cpu()))
            torch.cuda.synchronize()
            off, gaps = hand_kernel_gaps(task, state, got, eager)
            off_cpu, _ = hand_kernel_gaps(task, state, cpu, eager)
            # no farther from the eager card step than the eager CPU step is, and at most 0.2% of the envs
            check(len(off) <= len(off_cpu) and len(off) <= E // 500,
                  f"{name}@{E}: kernel and eager step differ beyond tolerance in envs {off} (the CPU's: {off_cpu})")
            flips, cpu_err = envs_beyond_tol(got, cpu, step_tol(task), E)
            check(len(flips) <= HAND_MAX_FLIPS * E // 8192, f"{name}@{E}: kernel and CPU differ in envs {flips}")

            def period_ms(fn, reps):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(reps):
                    fn()
                end.record()
                torch.cuda.synchronize()
                return start.elapsed_time(end) / reps

            kernel_ms = {block: [] for block in HAND_KERNEL_BLOCKS}
            for _ in range(HAND_KERNEL_TIMINGS):  # the block sizes in turns
                for block in HAND_KERNEL_BLOCKS:
                    kernel_ms[block].append(period_ms(
                        lambda: kernels.hand_control_step(task, state, action, draw, block=block), HAND_KERNEL_REPS))
            graph = GraphedStep(task.control_step, state, action, draw)
            graph_ms = [period_ms(graph.graph.replay, 3) for _ in range(HAND_KERNEL_TIMINGS)]
            bound_ops_ms = 1e3 * ops * E / PEAK_FP32_FLOPS
            bound_bytes_ms = 1e3 * hand_step_bytes(task) * E / PEAK_BYTES_S
            chosen = statistics.median(kernel_ms[kernels.hand_block(E)])
            res["by_envs"][E] = dict(
                kernel_vs_eager=gaps, kernel_vs_eager_envs_off=off, cpu_vs_eager_envs_off=off_cpu,
                kernel_vs_cpu_max_abs_err=cpu_err, kernel_vs_cpu_envs_beyond_tol=flips,
                terminated=int(got["terminated"].sum()), goals_reached=int(got["success"].sum()),
                engaged_pairs=int((got["contact"][:, 3::4] > 0.5).sum()),
                kernel_ms_by_block={b: statistics.median(v) for b, v in kernel_ms.items()},
                kernel_ms_timings=kernel_ms, block=kernels.hand_block(E), kernel_ms=chosen,
                graph_replay_ms=statistics.median(graph_ms), graph_replay_ms_timings=graph_ms,
                graph_kernel_nodes=graph.kernels, graph_build_s=graph.build_s,
                bound_ms=max(bound_ops_ms, bound_bytes_ms), bound_ops_ms=bound_ops_ms, bound_bytes_ms=bound_bytes_ms,
                bound_by="operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
                roofline_pct=100.0 * max(bound_ops_ms, bound_bytes_ms) / chosen)
            del graph
        out[name] = res
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
    check(launches["clip_adamw_step"] == 2 * (12 * iters - 2),
          f"clip_adamw_step launched {launches['clip_adamw_step']} times in {iters} iterations of {label}")

    rows = sorted(prof.key_averages(), key=lambda r: -_self_device_us(r))
    kernel_rows = [r for r in rows if r.device_type == DeviceType.CUDA
                   and not getattr(r, "is_user_annotation", False)]
    kernel_ms = sum(_self_device_us(r) for r in kernel_rows) / 1e3 / profiled_iters
    graph = task._graphs.get((E, torch.device(dev)))
    if graph is None:  # the hand's fused step kernel: one launch a control step
        check(launches["hand_control_step"] == cfg.algo.warm_up + iters, f"{label}: hand_control_step launches")
        graph_kernels = 1
        sim_ms = sum(_self_device_us(r) for r in kernel_rows if "hand_control_step" in r.key) / 1e3 / profiled_iters
    else:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as gprof:
            graph.graph.replay()
            torch.cuda.synchronize()
        graph_kernels = graph.kernels
        replay_records, replay_us = device_records(gprof)
        check(replay_records >= 0.99 * graph_kernels,
              f"the profiler does not trace the {label} graph's kernels: no sim/learner split")
        sim_ms = replay_us / 1e3
    ms = statistics.median(block_ms)
    return dict(
        config=" ".join(argv) + f" (batch {cfg.algo.batch_size}, memory {cfg.algo.memory_size:g}, fp32, "
                                f"reward scale {cfg.algo.reward_scale:g})",
        replay_ring=list(ring), replay_ring_gb=state.replay.data.numel() * 4 / 1e9,
        card=smi, iterations=iters, setup_s=setup_s, graph_build_s=None if graph is None else graph.build_s,
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
    channels = 2 if cfg.algo.name == "IDDPG" else 1  # IDDPG's reward channels, one per hand
    ring = (int(cfg.algo.memory_size) // E, E, 2 * agent.obs_dim + agent.action_dim + channels + 1)
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
    t1 = time.perf_counter()
    kernel_ms = device_records(prof)[1] / 1e3 / profiled_iters
    profile_read_s = time.perf_counter() - t1
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
    if channels > 1:
        start, dim = state.replay.field_range("reward")
        reward = state.replay.field("reward")[: state.replay.filled]
        check(dim == 2 and not torch.equal(reward[..., 0], reward[..., 1]),
              f"{label}: replay columns {start}-{start + dim - 1} do not hold two distinct reward channels")
        out.update(updates_per_iter=f"{cfg.algo.update_times} x 2 hands", replay_reward_columns=[start, start + 1],
                   replay_reward_channel_means=reward.mean(dim=(0, 1)).tolist(),
                   replay_reward_channels_differ_share=float((reward[..., 0] != reward[..., 1]).float().mean()))
    graphs = getattr(agent.env.task, "_graphs", None)
    if graphs and sim_ms is not None:
        out.update(sim_graph_device_ms_per_iter=sim_ms, learner_and_rest_device_ms_per_iter=kernel_ms - sim_ms,
                   sim_graph_measured_in="the first Ant run (the same task, envs and graph)")
    elif graphs:
        graph = graphs[(E, torch.device(dev))]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as gprof:
            graph.graph.replay()
            torch.cuda.synchronize()
        graph_kernels = graph.kernels
        replay_records, replay_us = device_records(gprof)
        check(replay_records >= 0.99 * graph_kernels,
              f"the profiler does not trace the {label} graph's kernels: no sim/learner split")
        sim_ms = replay_us / 1e3
        out.update(sim_graph_device_ms_per_iter=sim_ms, learner_and_rest_device_ms_per_iter=kernel_ms - sim_ms,
                   launches_per_control_step=graph_kernels)
    return out


def baseline_main_path(dev, smi: str) -> dict:
    """DDPG on Cartpole @16 (the JAX bench's cartpole_ddpg_16) for 54
    iterations, then DDPG, SAC and CrossQ on Ant @4096 (batch 8192, memory
    5e6: ring 1220 x 4096 x 78 fp32; CrossQ's critic sees 16,384 rows per
    update) for 11 iterations each after the warm-up."""
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


def timed_save_load(path: str, src, dst) -> tuple[float, float]:
    """Seconds of one more full-state save of ``src`` to ``path`` and of its
    load into ``dst`` (a state of the same config), each to the card's end."""
    import torch
    from pql_tpu_torch.utils import checkpoint

    t0 = time.perf_counter()
    checkpoint.save_checkpoint(path, src)
    torch.cuda.synchronize()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    checkpoint.load_checkpoint(path, dst)
    torch.cuda.synchronize()
    return save_s, time.perf_counter() - t0


def baseline_entry_path(dev, smi: str, argv=DDPG_CARTPOLE_ARGV, iters=BASELINE_ENTRY_ITERS) -> dict:
    """``pql_tpu_torch.train.main`` with ``argv`` (an agent with a warm-up; by
    default DDPG on Cartpole @16) for ``iters[0]`` iterations, with evals,
    full checkpoints and a best model in ``SMOKE_DIR/baseline_entry``: the
    eval records at the predicted iterations and the files; then
    ``train_baseline`` resumes from the checkpoint to ``iters[1]``
    iterations without a warm-up, and ends bitwise where one uninterrupted
    run of as many iterations ends. One more save and load of the final
    state are timed."""
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
    cfg = parse_cli(list(argv))
    E, warm = cfg.num_envs, cfg.algo.warm_up
    first, total = iters
    common = list(argv) + [
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
    check(not diffs, f"the resumed {cfg.algo.name} run differs from the uninterrupted one in {diffs[:8]}")
    check(resumed.update_count == cfg.algo.update_times * total,
          f"{resumed.update_count} updates after {total} iterations")
    launches = dict(kernels.LAUNCHES)
    ckpt_bytes = os.path.getsize(ckpt_file)
    save_s, load_s = timed_save_load(os.path.join(root, "timed"), resumed, whole)
    shutil.rmtree(root, ignore_errors=True)
    return dict(
        config=" ".join(argv) + f" (memory_size {cfg.algo.memory_size:g}: replay ring "
                                f"{list(resumed.replay.data.shape)})", card=smi, iterations_first=first,
        iterations_resumed=total,
        eval_iterations=eval_its, eval_returns=[r["eval/return"] for r in evals], bitwise_equal_after_resume=True,
        checkpoint_bytes=ckpt_bytes, checkpoint_save_s=save_s, checkpoint_load_s=load_s, wall_s_first=wall_first,
        wall_s_resumed=wall_resumed, ms_per_iter_by_interval=ms, ms_per_iter_median=statistics.median(ms.values()),
        launches=launches,
    )


def ddpg_learning_gate(dev) -> dict:
    """The JAX package's DDPG gate: seed 0's best eval return at iterations
    ``DDPG_EVALS`` must pass (seeds 1-4: ``tools/gate_trace.py``)."""
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


def ippo_learning_gate(dev) -> dict:
    """IPPO seed 0 on the JAX package's two-agent quick check (``IPPO_GATE``):
    ``train/success_rate`` after ``IPPO_ITERS`` iterations must reach
    ``IPPO_THRESHOLD``; the rate every 10 iterations and the final eval
    return are printed."""
    import torch
    from pql_tpu_torch.algos import get_algo
    from pql_tpu_torch.cfg import make_config
    from pql_tpu_torch.envs import make_eval_env
    from pql_tpu_torch.ops import kernels
    from pql_tpu_torch.utils.evaluator import Evaluator

    kernels.reset_launches()
    cfg = make_config("ippo", seed=0, **IPPO_GATE)
    agent = get_algo(cfg.algo.name)(cfg, device=dev)
    state, trace = agent.init(), {}
    t0 = time.perf_counter()
    for it in range(1, IPPO_ITERS + 1):
        state, m = agent.train_iter(state)
        if it % 10 == 0:
            trace[it] = float(m["train/success_rate"])
    wall_s = time.perf_counter() - t0
    ev = Evaluator(cfg, make_eval_env(cfg), agent.eval_actor_apply, dev)
    ret = ev.eval_policy(agent.eval_params(state), state.obs_rms, torch.Generator(device=dev).manual_seed(123))["eval/return"]
    check(trace[IPPO_ITERS] >= IPPO_THRESHOLD,
          f"IPPO seed 0: train/success_rate {trace[IPPO_ITERS]} < {IPPO_THRESHOLD} after {IPPO_ITERS} iterations")
    return dict(config=IPPO_GATE, iterations=IPPO_ITERS, threshold=IPPO_THRESHOLD, checked="ippo seed 0",
                success_rate_by_iteration=trace, eval_return=ret, train_wall_s=wall_s,
                launches=dict(kernels.LAUNCHES))


def card_vs_cpu(dev, refs, after=None) -> dict:
    """For each (algo, config overrides) of ``refs``: the warm-up of an agent
    that has one, then two iterations, at a small size on the card and on
    the CPU, from the same initial state (drawn on the CPU from the seed)
    with the same draws: each network's parameter step within 1% of its
    norm, losses within 1e-3 (relative; absolute below 1), a replay ring
    within 1e-4. A dict of networks (a two-agent agent's) is held network
    by network, IDDPG's targets included. ``after(agent, state)``, when
    given, checks the card's final state and returns a dict for the run."""
    import torch
    from pql_tpu_torch.algos import get_algo
    from pql_tpu_torch.cfg import make_config

    out = {}
    for algo, kwargs in refs:
        cfg = make_config(algo, **kwargs)
        agents = {d: get_algo(cfg.algo.name)(cfg, device=d) for d in ("cpu", dev)}
        states = {d: a.init() for d, a in agents.items()}

        def parts(st):  # each network's parameters, flat; a dict of networks holds them all
            actor, critic = agents["cpu"].snapshot_parts(st)
            mods = actor if isinstance(actor, torch.nn.ModuleDict) else {"actor": actor, "critic": critic}
            return {g: torch.cat([p.detach().float().cpu().flatten() for p in m.parameters()]) for g, m in mods.items()}

        theta0 = parts(states["cpu"])
        gen = torch.Generator().manual_seed(1)
        if hasattr(agents["cpu"], "warmup"):
            draws = agents["cpu"].draw_iteration(gen, random=True)
            for d, agent in agents.items():
                states[d], _ = agent.warmup(states[d], {k: v.to(d) for k, v in draws.items()})
        losses = {d: [] for d in agents}
        for _ in range(2):
            draws = agents["cpu"].draw_iteration(gen)
            for d, agent in agents.items():
                states[d], m = agent.train_iter(states[d], {k: v.to(d) for k, v in draws.items()})
                losses[d] += [float(v) for k, v in sorted(m.items()) if "_loss" in k]
        got, want = parts(states[dev]), parts(states["cpu"])
        rel = {g: float((got[g] - want[g]).norm() / (want[g] - theta0[g]).norm()) for g in want}
        loss_err = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(losses[dev], losses["cpu"]))
        obs_err = float((states[dev].obs.cpu() - states["cpu"].obs).abs().max())
        label = f"{algo} {kwargs}"
        for g, r in rel.items():
            check(r <= 1e-2, f"{label}: card vs CPU {g} step differs by {r:.3g} of its norm")
        check(loss_err <= 1e-3, f"{label}: card vs CPU loss differs by {loss_err:.3g}")
        check(states[dev].update_count == states["cpu"].update_count > 0, f"{label} counters")
        run = dict(step_rel_err=rel, loss_rel_err=loss_err, obs_max_abs_err=obs_err, updates=states[dev].update_count)
        if hasattr(states["cpu"], "replay"):
            err = float((states[dev].replay.data.cpu() - states["cpu"].replay.data).abs().max())
            check(err <= 1e-4, f"{label}: card vs CPU replay differs by {err:.3g}")
            run["replay_max_abs_err"] = err
        if after is not None:
            run.update(after(agents[dev], states[dev]))
        out[f"{algo} {kwargs['task']}" + (" same_policy" if "algo__same_policy" in kwargs else "")
            + (" diffusion" if kwargs.get("algo__diffusion") else "")
            + (f" {kwargs['algo__act_class']}" if "algo__act_class" in kwargs else "")] = run
    return out


def ppo_reference(dev) -> dict:
    """Two iterations of PPO (value_norm), IPPO (two pairs, and one pair
    under same_policy on the Sym task) and MAPPO at a small size on the card
    and on the CPU (``card_vs_cpu``)."""
    runs = card_vs_cpu(dev, [(algo, dict(PPO_REF_SIZE, **extra)) for algo, extra in PPO_REF])
    return dict(config=PPO_REF_SIZE, iterations=2, runs=runs)


def two_agent_reference(dev) -> dict:
    """The warm-up and two iterations of IDDPG, and two iterations of QTOTV1
    (value_norm), QTOTV2, IART, IPPOTeam (on the Sym task) and IPPOTeam2, at
    a small size on the card and on the CPU (``card_vs_cpu``); the kernels'
    launch counts are reset before and read after."""
    from pql_tpu_torch.ops import kernels

    kernels.reset_launches()
    runs = card_vs_cpu(dev, TWO_AGENT_REF)
    return dict(config=dict(TWO_AGENT_REF), iterations=2, runs=runs, launches=dict(kernels.LAUNCHES))


def onpolicy_run(dev, smi: str, argv, warm_iters: int, blocks: int, block_iters: int, profiled_iters: int,
                 after=None, trunk_ops: str | None = None) -> dict:
    """An on-policy agent's path at full width through the agent:
    ``warm_iters`` + ``blocks`` x ``block_iters`` iterations timed in blocks,
    then a profiled window of ``profiled_iters`` (none when 0) whose kernel
    time is the device time of whole iterations; on a graphed task one replay of the
    control step's graph, profiled alone, times H control steps of the sim
    (the window must hold at least 99% of their kernels), and CUDA events
    around each control step give the sim's span on the stream. The
    kernels' launch counts are reset before the path runs and read after.
    ``after(agent, state)``, when given, checks the final state and returns
    a dict for the run's line. ``trunk_ops``, a regex of op names, adds the
    device ms those ops launch in the profiled window and their share."""
    import re
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pql_tpu_torch.algos import get_algo
    from pql_tpu_torch.cfg import parse_cli
    from pql_tpu_torch.ops import kernels

    cfg = parse_cli(list(argv))
    agent = get_algo(cfg.algo.name)(cfg, device=dev)
    task, E, H = agent.env.task, cfg.num_envs, cfg.algo.horizon_len
    label = f"{cfg.algo.name} {cfg.task}@{E}"
    sim_events, graphed = [], task.dynamics

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
    losses, block_ms, loss_keys = [], [], []

    def run(n):
        nonlocal state
        for _ in range(n):
            state, m = agent.train_iter(state)
            loss_keys[:] = sorted(k for k in m if "_loss" in k)
            losses.append(torch.stack([m[k] for k in loss_keys]))

    run(warm_iters)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps_before = len(sim_events)
    for _ in range(blocks):
        t1 = time.perf_counter()
        run(block_iters)
        torch.cuda.synchronize()
        block_ms.append(1e3 * (time.perf_counter() - t1) / block_iters)
    timed_steps = sim_events[steps_before:]
    sim_span_ms = sum(a.elapsed_time(b) for a, b in timed_steps) / (blocks * block_iters)
    task.dynamics = graphed
    if profiled_iters:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            run(profiled_iters)
            torch.cuda.synchronize()
            profiled_wall_ms = 1e3 * (time.perf_counter() - t1) / profiled_iters
    launches = dict(kernels.LAUNCHES)
    iters = warm_iters + blocks * block_iters + profiled_iters
    n_mb = agent.rows // cfg.algo.batch_size
    lo = torch.stack(losses).cpu()
    check(bool(torch.isfinite(lo).all()), f"non-finite loss on the {label} path")
    check(state.update_count == cfg.algo.update_times * n_mb * iters,
          f"{label}: {state.update_count} updates after {iters} iterations of {cfg.algo.update_times} x {n_mb}")
    check(state.env_steps == H * E * iters, f"{label} env steps {state.env_steps}")
    check(launches["c51_td_target"] == 0, f"{label} launched c51_td_target")
    trackers = {k: float(v) for k, v in state.stats.metrics().items()}
    check(all(math.isfinite(v) for v in trackers.values()), f"{label} trackers {trackers}")

    ms = statistics.median(block_ms)
    out = dict(
        config=" ".join(argv) + f" (envs {E}, horizon {H}, batch {cfg.algo.batch_size}, epochs "
                                f"{cfg.algo.update_times}, {n_mb} minibatches, value_norm {cfg.algo.value_norm}, "
                                f"fp32, reward scale {cfg.algo.reward_scale:g})",
        card=smi, iterations=iters, setup_s=setup_s, ms_per_iter=ms, env_steps_per_s=1e3 * H * E / ms,
        block_ms_per_iter=block_ms, losses_last=dict(zip(loss_keys, lo[-1].tolist())),
        update_count=state.update_count, updates_per_iter=cfg.algo.update_times * n_mb, env_steps=state.env_steps,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, trackers=trackers, launches=launches,
        sim_span_ms_per_iter=sim_span_ms,
    )
    if hasattr(task, "get_symmetry"):
        out["symmetry_tracker_mean"] = float(agent.env.symmetry_tracker(state.env_state).mean())
    if after is not None:
        out.update(after(agent, state))
    if not profiled_iters:
        return out
    t1 = time.perf_counter()
    window_launches, window_us = device_records(prof)
    kernel_ms = window_us / 1e3 / profiled_iters
    out.update(profiled_wall_ms_per_iter=profiled_wall_ms, device_ms_per_iter=kernel_ms,
               device_busy_share=kernel_ms / ms, kernel_launches_per_iter=window_launches / profiled_iters,
               profile_read_s=time.perf_counter() - t1)
    if trunk_ops:
        trunk_ms = sum(_self_device_us(r) for r in prof.key_averages() if r.device_type == DeviceType.CPU
                       and re.search(trunk_ops, r.key)) / 1e3 / profiled_iters
        out.update(trunk_ops=trunk_ops, trunk_device_ms_per_iter=trunk_ms, trunk_share_of_device=trunk_ms / kernel_ms)
    graphs = getattr(task, "_graphs", None)
    if graphs:
        graph = graphs[(E, torch.device(dev))]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as gprof:
            graph.graph.replay()
            torch.cuda.synchronize()
        graph_kernels = graph.kernels
        replay_records, replay_us = device_records(gprof)
        check(replay_records >= 0.99 * graph_kernels,
              f"the profiler does not trace the {label} graph's kernels: no sim/learner split")
        check(window_launches >= 0.99 * H * graph_kernels * profiled_iters,
              f"the {label} profile window lost kernel records: {window_launches} for {H} x {graph_kernels} graph nodes")
        sim_ms = H * replay_us / 1e3
        out.update(sim_graph_device_ms_per_iter=sim_ms, learner_and_rest_device_ms_per_iter=kernel_ms - sim_ms,
                   launches_per_control_step=graph_kernels, graph_build_s=graph.build_s)
    return out


def onpolicy_paths(dev, smi: str, paths, after=None, trunk_ops: str | None = None) -> dict:
    """``onpolicy_run`` of each (argv, depth) in ``paths``, one after another."""
    import torch

    runs = {}
    for argv, depth in paths:
        t0 = time.perf_counter()
        r = onpolicy_run(dev, smi, argv, *depth, after=after, trunk_ops=trunk_ops)
        r["wall_s"] = time.perf_counter() - t0
        runs[" ".join(argv)] = r
        torch.cuda.empty_cache()
    return dict(runs=runs)


def ppo_main_path(dev, smi: str) -> dict:
    """PPO at full width on Ant @4096 (horizon 16, batch 32768, 4 epochs) and
    FrankaCubeStack @8192 (horizon 32, batch 16384, 5 epochs), the task
    presets of ``task_param``."""
    return onpolicy_paths(dev, smi, PPO_PATHS)


def two_agent_main_path(dev, smi: str) -> dict:
    """IPPO and MAPPO on BimanualReacher @4096 and IPPO under same_policy on
    BimanualReacherSym @4096 (the presets: horizon 16, batch 32768, 4
    epochs); the Sym task's mirrored share within ``SYM_TRACKER_BAND``."""
    out = onpolicy_paths(dev, smi, TWO_AGENT_PATHS)
    _check_sym_share(out["runs"])
    return out


def _check_sym_share(runs: dict) -> None:
    """The mirrored share of each Sym-task run within ``SYM_TRACKER_BAND``."""
    lo, hi = SYM_TRACKER_BAND
    for name, r in runs.items():
        if "Sym" in name:
            check(lo <= r["symmetry_tracker_mean"] <= hi, f"{name}: mirrored share {r['symmetry_tracker_mean']}")


def iddpg_main_path(dev, smi: str) -> dict:
    """IDDPG on BimanualReacher @4096 at its preset (batch 8192, memory 5e6:
    ring 1220 x 4096 x 55 fp32, 8 updates of both hands per iteration):
    warm-up and 36 iterations, as ``baseline_run``, with the replay's two
    reward channels (columns 28-29) checked distinct; no ``c51_td_target``
    launch."""
    r = baseline_run(dev, smi, IDDPG_ARGV, *IDDPG_DEPTH)
    check(r["launches"]["c51_td_target"] == 0, "the IDDPG path launched c51_td_target")
    check(r["replay_reward_columns"] == [28, 29], f"IDDPG reward columns {r['replay_reward_columns']}")
    return r


def team_main_path(dev, smi: str) -> dict:
    """QTOTV1, QTOTV2, IART, IPPOTeam and IPPOTeam2 on BimanualReacher @4096
    and IPPOTeam on BimanualReacherSym @4096 at their presets (horizon 16,
    batch 32768, 4 epochs: QTOT 2 minibatches of the H·E rows, the team
    agents 1 of the H·E/2), as ``two_agent_main_path``."""
    out = onpolicy_paths(dev, smi, TEAM_PATHS)
    _check_sym_share(out["runs"])
    return out


def ppo_entry_path(dev, smi: str, argv=PPO_ENTRY_ARGV, iters=PPO_ENTRY_ITERS, freq: int = PPO_ENTRY_EVAL_FREQ) -> dict:
    """``pql_tpu_torch.train.main`` with ``argv`` (an agent without a
    warm-up; by default PPO on Cartpole @4096) for ``iters[0]`` iterations,
    with evals, full checkpoints and a best model in ``SMOKE_DIR/ppo_entry``:
    the eval records at the predicted iterations and the files; then
    ``train_baseline`` resumes from the checkpoint to ``iters[1]``
    iterations at the predicted iteration, and ends bitwise where one
    uninterrupted run of as many iterations ends. ``iters[0]`` is a multiple
    of ``freq``, the eval and checkpoint period (``PPO_ENTRY_EVAL_FREQ``)."""
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

    root = os.path.join(SMOKE_DIR, "ppo_entry")
    shutil.rmtree(root, ignore_errors=True)
    cfg = parse_cli(list(argv))
    per_iter = cfg.num_envs * cfg.algo.horizon_len
    first, total = iters
    common = list(argv) + [
        f"algo.eval_freq={freq}", "algo.log_freq=1", f"checkpoint_freq={freq}",
        f"logging.out_dir={root}/runs", "logging.console=false"]
    kernels.reset_launches()
    t0 = time.perf_counter()
    train.main(common + [f"max_step={(first - 1) * per_iter}", f"checkpoint_dir={root}/ckpt",
                         "logging.run_name=first", f"--device={dev}"])
    torch.cuda.synchronize()
    wall_first = time.perf_counter() - t0
    run_dir = os.path.join(root, "runs", "first")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    it_of = lambda step: step // per_iter  # noqa: E731  (no warm-up)
    evals = [r for r in recs if "eval/return" in r]
    eval_its = list(range(freq, first + 1, freq))
    check([it_of(r["step"]) for r in evals] == eval_its,
          f"eval records at iterations {[it_of(r['step']) for r in evals]}, predicted {eval_its}")
    check(all(math.isfinite(r["eval/return"]) for r in evals), "non-finite eval record")
    speed = [r for r in recs if "speed/env_steps_per_s" in r]
    check(it_of(speed[0]["step"]) == 1, f"the first record at env step {speed[0]['step']}: a warm-up ran")
    ckpt_file = os.path.join(root, "ckpt", "state", checkpoint.STATE_FILE)
    check(os.path.exists(ckpt_file) and os.path.exists(os.path.join(run_dir, "best_model", checkpoint.SNAPSHOT_FILE)),
          "the checkpoint or the best model is missing")
    ms = {it_of(r["step"]): 1e3 * per_iter / r["speed/env_steps_per_s"] for r in speed}

    def run(name, ckpt):
        c = parse_cli(common + [f"max_step={(total - 1) * per_iter}", f"checkpoint_dir={root}/{ckpt}",
                                f"logging.run_name={name}"])
        logger = RunLogger(c)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                agent, state = train.train_baseline(c, logger, dev)
        finally:
            logger.close()
        return agent, state, buf.getvalue()

    t0 = time.perf_counter()
    agent, resumed, printed = run("second", "ckpt")
    wall_resumed = time.perf_counter() - t0
    check(f"at env step {first * per_iter} (no warm-up)" in printed, f"the rerun did not resume: {printed[-200:]!r}")
    with open(os.path.join(root, "runs", "second", "metrics.jsonl")) as f:
        resumed_its = [it_of(json.loads(line)["step"]) for line in f]
    check(min(resumed_its) == first + 1, f"the resumed run logged from iteration {min(resumed_its)}")
    _, whole, _ = run("whole", "ckpt_whole")
    diffs = state_diffs(resumed, whole)
    check(not diffs, f"the resumed {cfg.algo.name} run differs from the uninterrupted one in {diffs[:8]}")
    n_mb = agent.rows // cfg.algo.batch_size
    check(resumed.update_count == cfg.algo.update_times * n_mb * total, f"{resumed.update_count} updates")
    launches = dict(kernels.LAUNCHES)
    check(launches["c51_td_target"] == 0, f"the {cfg.algo.name} entry path launched c51_td_target")
    ckpt_bytes = os.path.getsize(ckpt_file)
    save_s, load_s = timed_save_load(os.path.join(root, "timed"), resumed, whole)
    shutil.rmtree(root, ignore_errors=True)
    return dict(
        config=" ".join(argv) + f" (envs {cfg.num_envs}, horizon {cfg.algo.horizon_len}, batch "
                                          f"{cfg.algo.batch_size})", card=smi,
        iterations_first=first, iterations_resumed=total, eval_iterations=eval_its,
        eval_returns=[r["eval/return"] for r in evals], resumed_from_iteration=first, bitwise_equal_after_resume=True,
        checkpoint_bytes=ckpt_bytes, checkpoint_save_s=save_s, checkpoint_load_s=load_s, wall_s_first=wall_first,
        wall_s_resumed=wall_resumed, ms_per_iter_by_interval=ms, ms_per_iter_median=statistics.median(ms.values()),
        launches=launches,
    )


def eq_nets(agent, state) -> dict:
    """Each equivariant network of an agent's state with the task's reps it
    must obey: name -> (module, G_in, G_out or None for an invariant one).
    A network on the joint obs (EQG's pair, EQSC's critic, IPPOTeam's
    ``actor_team``, ``critic_tot`` and ``critic_team``) takes the joint rep
    and an actor there emits the joint action; the others one hand's view
    (``_left`` in the name: the left hand's) and action."""
    import torch
    from pql_tpu_torch.models.emlp import EMLP, GroupEquivariantLinear

    from pql_tpu_torch.models.diffusion import DDPMPolicy

    ma = agent.ma
    rep = lambda g: torch.tensor(g, dtype=torch.float32, device=agent.device)  # noqa: E731
    g_act = rep(ma.act_gen())
    nets = state.nets if hasattr(state, "nets") else {"actor": state.actor, "critic": state.critic}
    out = {}
    for name, m in nets.items():
        if not any(isinstance(x, EMLP) for x in m.modules()) or isinstance(m, DDPMPolicy):
            continue
        first = next(x for x in m.modules() if isinstance(x, GroupEquivariantLinear))
        central = first.weight.shape[1] == ma.shared_obs_dim
        g_in = rep(ma.joint_obs_gen()) if central else rep(ma.obs_gen(1 if "_left" in name else 0))
        g_out = None if name.startswith("critic") else torch.block_diag(g_act, g_act) if central else g_act
        out[name] = (m, g_in, g_out)
    return out


def diffusion_errors(policy, g_obs, g_act, gen, rows: int = 4096) -> dict:
    """The equivariance errors of an ``EquivariantDiffusionPolicy`` on
    ``rows`` standard-normal inputs: its ε-field, |ε̂(x·G_act, t, c·G_obs) −
    ε̂(x, t, c)·G_act|, at timesteps drawn from [0, T), and its sampler,
    |a(c·G_obs, x_T·G_act, noise·G_act) − a(c, x_T, noise)·G_act|, each
    relative to 1 + its largest output."""
    import torch

    from pql_tpu_torch.ops.ddpm import draw_sample

    dev, d, T = g_act.device, g_act.shape[0], policy.sched.num_timesteps
    x = torch.randn(rows, d, generator=gen, device=dev)
    obs = torch.randn(rows, g_obs.shape[0], generator=gen, device=dev)
    t = torch.randint(0, T, (rows,), generator=gen, device=dev).float()
    x_T, noise = draw_sample(gen, rows, d, T)
    with torch.no_grad():
        eps, eps_g = policy.net(x, t, obs), policy.net(x @ g_act, t, obs @ g_obs)
        act, act_g = policy.get_actions(obs, x_T, noise), policy.get_actions(obs @ g_obs, x_T @ g_act, noise @ g_act)
    rel = lambda y, y_g: float((y_g - y @ g_act).abs().max()) / (1.0 + float(y.abs().max()))  # noqa: E731
    return {"eps": rel(eps, eps_g), "sampler": rel(act, act_g)}


def equivariance_errors(agent, state, rows: int = 4096) -> dict:
    """|f(x·G_in) − f(x)·G_out|_max / (1 + |f(x)|_max) of each equivariant
    network of the state (``eq_nets``; an actor's mean, G_out = I for a
    critic) on ``rows`` standard-normal inputs on its device, and an
    equivariant diffusion team's ε-field and sampler (``diffusion_errors``,
    on the joint reps); each within ``EQ_TOL``. An agent whose act_class or
    cri_class is equivariant has at least one such network, and no other
    agent has one."""
    import torch

    from pql_tpu_torch.models.ediffusion import EquivariantDiffusionPolicy

    gen = torch.Generator(device=agent.device).manual_seed(0)
    errs = {}
    for name, (m, g_in, g_out) in eq_nets(agent, state).items():
        x = torch.randn(rows, g_in.shape[0], generator=gen, device=agent.device)
        with torch.no_grad():
            y, y_g = m(x), m(x @ g_in)
        y, y_g = (y[0], y_g[0]) if isinstance(y, tuple) else (y, y_g)
        want = y if g_out is None else y @ g_out
        errs[name] = float((y_g - want).abs().max()) / (1.0 + float(y.abs().max()))
    nets = state.nets if hasattr(state, "nets") else {}
    for name, m in nets.items():
        if isinstance(m, EquivariantDiffusionPolicy):
            rep = lambda g: torch.tensor(g, dtype=torch.float32, device=agent.device)  # noqa: E731
            g_act = rep(agent.ma.act_gen())
            d_errs = diffusion_errors(m, rep(agent.ma.joint_obs_gen()), torch.block_diag(g_act, g_act), gen, rows)
            errs.update({f"{name} {k}": v for k, v in d_errs.items()})
    for name, err in errs.items():
        check(err <= EQ_TOL, f"{agent.name} {name}: equivariance error {err:.3g} > {EQ_TOL}")
    algo = agent.cfg.algo
    check(bool(errs) == any("Equivariant" in c for c in (algo.act_class, algo.cri_class)),
          f"{agent.name}: equivariant networks {sorted(errs)}")
    return dict(equivariance_err=errs)


def eq_layer_check(dev) -> dict:
    """The EMLP layers at full width (256 hidden, 5 linear maps) on
    BimanualReacher's arm reps, and ``GroupEMLP`` on C4 and D4 (a rotation
    by π/2 and a reflection of the plane), each with an equivariant and an
    invariant head: raw weights drawn N(0, 0.1²) (off the equivariant
    subspace), then the same module on the card and on the CPU on the same
    4096 inputs within ``EQ_TOL`` (relative to 1 + |f|), and equivariant on
    the card under every group element."""
    import copy

    import torch
    from pql_tpu_torch.envs.bimanual import BimanualReacher
    from pql_tpu_torch.models import emlp

    spec = BimanualReacher.equivariance
    g_obs, g_act = emlp.sign_rep(spec.obs_signs[0]), emlp.sign_rep(spec.act_signs)
    rot, refl = emlp.cyclic_rotation2d(4), emlp.sign_rep([1.0, -1.0])
    c4, d4 = emlp.FiniteGroup(obs=[rot], act=[rot]), emlp.FiniteGroup(obs=[rot, refl], act=[rot, refl])
    gen = torch.Generator().manual_seed(0)
    nets = {"EMLP C2 equivariant": (emlp.EMLP(g_obs, g_act, gen=gen), [g_obs], [g_act]),
            "EMLP C2 invariant": (emlp.EMLP(g_obs, 1, gen=gen), [g_obs], None),
            "DiagGaussianEquivariantMLPPolicy": (emlp.DiagGaussianEquivariantMLPPolicy(g_obs, g_act, gen=gen),
                                                 [g_obs], [g_act]),
            "MLPCriticEquivariant": (emlp.MLPCriticEquivariant(g_obs, gen=gen), [g_obs], None)}
    for gname, grp in (("C4", c4), ("D4", d4)):
        obs, act = grp.elements("obs"), grp.elements("act")
        nets[f"GroupEMLP {gname} equivariant"] = (emlp.GroupEMLP(obs, act, grp.mul, gen=gen), obs, act)
        nets[f"GroupEMLP {gname} invariant"] = (emlp.GroupEMLP(obs, 3, grp.mul, gen=gen), obs, None)
    out = {}
    for name, (net, elems_in, elems_out) in nets.items():
        with torch.no_grad():
            for p in net.parameters():
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
        first = lambda y: y[0] if isinstance(y, tuple) else y  # noqa: E731
        x = torch.randn(4096, len(elems_in[0]), generator=gen)
        card = copy.deepcopy(net).to(dev)
        with torch.no_grad():
            want, got = first(net(x)), first(card(x.to(dev))).cpu()
            err = float((got - want).abs().max()) / (1.0 + float(want.abs().max()))
            check(err <= EQ_TOL, f"{name}: card vs CPU {err:.3g}")
            eq_err = 0.0
            y = first(card(x.to(dev)))
            for k, e in enumerate(elems_in):
                g_in = torch.tensor(e, dtype=torch.float32, device=dev)
                y_g = first(card(x.to(dev) @ g_in))
                target = y if elems_out is None else y @ torch.tensor(elems_out[k], dtype=torch.float32, device=dev)
                eq_err = max(eq_err, float((y_g - target).abs().max()) / (1.0 + float(y.abs().max())))
            check(eq_err <= EQ_TOL, f"{name}: equivariance error on the card {eq_err:.3g}")
        out[name] = dict(card_vs_cpu_rel_err=err, equivariance_err=eq_err, group_order=len(elems_in))
    return out


def eq_reference(dev) -> dict:
    """The EMLP layers card vs CPU (``eq_layer_check``); two iterations of
    EQ, EQS, EQG, EQSC, EQSdata, EQS4 and MP, and of IPPOTeam and IART with
    the equivariant classes, at a small size (EMLP at full width) on the
    card and on the CPU (``card_vs_cpu``), then the equivariance of each
    trained equivariant network on the card (``equivariance_errors``); the
    kernels' launch counts are reset before and read after."""
    from pql_tpu_torch.ops import kernels

    kernels.reset_launches()
    layers = eq_layer_check(dev)
    runs = card_vs_cpu(dev, EQ_REF, after=equivariance_errors)
    return dict(config=dict(EQ_REF), iterations=2, layers=layers, runs=runs, launches=dict(kernels.LAUNCHES))


def eq_main_path(dev, smi: str) -> dict:
    """EQ, EQS, EQG, EQSC, EQSdata, EQS4 and MP on BimanualReacher @4096, EQ
    on BimanualReacherSym @4096 and IPPOTeam with the equivariant team actor
    @4096, at their presets (horizon 16, batch 32768, 4 epochs, EMLP 256 x 5,
    fp32), as ``two_agent_main_path`` (a profiled window on EQ, EQSC and
    EQS4 only), and each trained network's equivariance on the card at full
    width (``equivariance_errors``)."""
    out = onpolicy_paths(dev, smi, EQ_PATHS, after=equivariance_errors)
    _check_sym_share(out["runs"])
    return out


def sampler_check(dev) -> dict:
    """The DDPM sampler of both diffusion policies at full width on
    BimanualReacher's joint reps (``EquivariantDiffusionPolicy``: EMLP 512 x
    5; ``StateDiffusionPolicy``: the [1024, 512, 256] trunk), as an agent
    builds them from a seed: ``SAMPLE_ROWS`` rows on the card and on the CPU
    from the same obs, x_T and step noise within ``EQ_TOL``·(1 + |a|); the
    equivariant policy's ε-field and sampler equivariant on the card
    (``diffusion_errors``); the card's ms per sample (CUDA events around
    ``SAMPLE_REPS`` calls after one untimed), with the card's name and power
    limit beside it in the phase's line. (The step at t = T−1 divides by
    √ᾱ ≈ 0.0097, so the sampler's fp32 error grows with |ε̂|: weights moved
    by N(0, 0.05²), |ε̂| ~ 1, put the CPU's own fp32 result 5e-5 from its
    float64 one.)"""
    import copy

    import torch
    from pql_tpu_torch.algos.ma_base import MultiAgentCtx
    from pql_tpu_torch.cfg import make_config
    from pql_tpu_torch.envs import make_env
    from pql_tpu_torch.models.diffusion import StateDiffusionPolicy
    from pql_tpu_torch.models.ediffusion import EquivariantDiffusionPolicy
    from pql_tpu_torch.models.emlp import concat_reps
    from pql_tpu_torch.ops.ddpm import draw_sample

    ma = MultiAgentCtx(make_env(make_config("eqsd", task="BimanualReacher", num_envs=2)))
    g_obs, g_act = ma.joint_obs_gen(), concat_reps(ma.act_gen(), ma.act_gen())
    gen = torch.Generator().manual_seed(0)
    policies = {"EquivariantDiffusionPolicy": EquivariantDiffusionPolicy(g_obs, g_act, gen=gen),
                "StateDiffusionPolicy": StateDiffusionPolicy(24, 4, gen=gen)}
    out = {}
    for name, pol in policies.items():
        obs = torch.randn(SAMPLE_ROWS, 24, generator=gen)
        x_T, noise = draw_sample(gen, SAMPLE_ROWS, 4, pol.sched.num_timesteps)
        card = copy.deepcopy(pol).to(dev)
        args = (obs.to(dev), x_T.to(dev), noise.to(dev))
        with torch.no_grad():
            want, got = pol.get_actions(obs, x_T, noise), card.get_actions(*args).cpu()
            err = float((got - want).abs().max()) / (1.0 + float(want.abs().max()))
            check(err <= EQ_TOL, f"{name}: sampler card vs CPU {err:.3g}")
            card.get_actions(*args)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(SAMPLE_REPS):
                card.get_actions(*args)
            end.record()
            torch.cuda.synchronize()
        out[name] = dict(card_vs_cpu_rel_err=err, sample_ms=start.elapsed_time(end) / SAMPLE_REPS,
                         rows=SAMPLE_ROWS, steps=pol.sched.num_timesteps)
        if isinstance(pol, EquivariantDiffusionPolicy):
            rep = lambda g: torch.tensor(g, dtype=torch.float32, device=dev)  # noqa: E731
            errs = diffusion_errors(card, rep(g_obs), rep(g_act), torch.Generator(device=dev).manual_seed(1))
            for k, v in errs.items():
                check(v <= EQ_TOL, f"{name}: {k} equivariance error on the card {v:.3g}")
            out[name]["equivariance_err"] = errs
    return out


def eqsd_reference(dev, smi: str) -> dict:
    """Two iterations of EQSD with each of its four team actors and of EQSD2
    (equivariant and plain) at a small size (networks at full width) on the
    card and on the CPU (``card_vs_cpu``), then each trained equivariant
    network's equivariance on the card, the diffusion team's ε-field and
    sampler among them (``equivariance_errors``); the sampler card vs CPU at
    ``SAMPLE_ROWS`` rows (``sampler_check``); the kernels' launch counts are
    reset before and read after."""
    from pql_tpu_torch.ops import kernels

    kernels.reset_launches()
    runs = card_vs_cpu(dev, EQSD_REF, after=equivariance_errors)
    sampler = sampler_check(dev)
    return dict(config=[f"{a} {k}" for a, k in EQSD_REF], iterations=2, card=smi, runs=runs, sampler=sampler,
                launches=dict(kernels.LAUNCHES))


def eqsd_main_path(dev, smi: str) -> dict:
    """EQSD with the equivariant Gaussian, the equivariant diffusion and the
    plain diffusion team, and EQSD2 equivariant and plain, on
    BimanualReacher @4096 at the presets (horizon 16, batch 32768, 4 epochs,
    diffusion_iter 5, fp32: EQSD 2 minibatches of the H·E rows, EQSD2 1 of
    the H·E/2), as ``two_agent_main_path`` with a profiled window on the
    equivariant diffusion team only, and every trained equivariant network's
    equivariance on the card at full width (``equivariance_errors``)."""
    return onpolicy_paths(dev, smi, EQSD_PATHS, after=equivariance_errors)


def _rel_err(got, want) -> float:
    return float((got.float().cpu() - want.float()).abs().max()) / (1.0 + float(want.abs().max()))


def vision_module_check(dev, envs: int = 4096) -> dict:
    """Each module of the vision tier, drawn on the CPU from a seed, on the
    card and on the CPU on the same ``VISION_ROWS`` inputs: the point-cloud
    encoders, ``PointNetEncoderXYZ`` (LayerNorms on), ``TimestepEmbedder``,
    ``ResEncoder`` (48×48, repr 1024), ``DINOEncoder`` (ViT-S/14 shape, depth
    4), the PPOV actor; the ReacherVision render, proprio and cloud and the
    BimanualReacherVision views at ``envs`` envs. The conv nets within
    ``VISION_TOL``·(1 + |f|), the rest within ``EQ_TOL``."""
    import copy

    import torch
    from pql_tpu_torch.envs import make_task
    from pql_tpu_torch.models import pointnet, visual

    gen = torch.Generator().manual_seed(0)
    n = VISION_ROWS
    state, pc = torch.randn(n, 6, generator=gen), torch.randn(n, 40, 3, generator=gen)
    frames = torch.rand(n, 1, 2, 48, 48, 3, generator=gen)
    cases = {
        "MultiStagePointNetEncoder": (pointnet.MultiStagePointNetEncoder(gen=gen), (pc,), EQ_TOL),
        "Encoder": (pointnet.Encoder(6, 128, gen=gen), (state, pc), EQ_TOL),
        "PointNetEncoderXYZ": (visual.PointNetEncoderXYZ(3, 1024, True, "layernorm", gen=gen), (pc,), EQ_TOL),
        "TimestepEmbedder": (visual.TimestepEmbedder(6, 256, gen=gen), (torch.rand(n, 6, generator=gen),), EQ_TOL),
        "ResEncoder": (visual.ResEncoder((1, 2, 48, 48, 3), gen=gen), (frames,), VISION_TOL),
        "DINOEncoder": (visual.DINOEncoder((2, 48, 48, 3), gen=gen), (torch.rand(n, 2, 48, 48, 3, generator=gen),),
                        VISION_TOL),
        "DiagGaussianMLPVPolicy": (visual.DiagGaussianMLPVPolicy(6, 2, (1, 2, 48, 48, 3), 256, 256, gen=gen),
                                   (frames, state, pc), VISION_TOL),
    }
    out = {}
    with torch.no_grad():
        for name, (m, args, tol) in cases.items():
            first = lambda y: y[0] if isinstance(y, tuple) else y  # noqa: E731
            want = first(m(*args))
            got = first(copy.deepcopy(m).to(dev)(*(a.to(dev) for a in args)))
            err = _rel_err(got, want)
            check(err <= tol, f"{name}: card vs CPU {err:.3g} > {tol}")
            out[name] = dict(card_vs_cpu_rel_err=err, tol=tol)
        for task_name in ("ReacherVision", "BimanualReacherVision"):
            task = make_task(task_name)
            st = task.init_state(task.draw_reset(torch.Generator().manual_seed(1), envs))
            st, *_ = task.dynamics(st, torch.rand(envs, task.action_dim, generator=gen) * 2 - 1)
            card = {k: v.to(dev) for k, v in st.items()}
            for view in ("proprio", "pointcloud", "render"):
                if hasattr(task, view):
                    err = _rel_err(getattr(task, view)(card), getattr(task, view)(st))
                    check(err <= EQ_TOL, f"{task_name}.{view}: card vs CPU {err:.3g}")
                    out[f"{task_name}.{view}"] = dict(card_vs_cpu_rel_err=err, tol=EQ_TOL, envs=envs)
    return out


def diffusion_policy_check(dev) -> dict:
    """The vision tier's ``DiffusionPolicy`` (point-cloud ``Encoder`` + the
    [1024, 512, 256] ``DiffusionNet``) at ``SAMPLE_ROWS`` rows: its DDPM
    sampler on the card and on the CPU from the same draws within
    ``EQ_TOL``·(1 + |a|), and the card's ms per sample (CUDA events around
    ``SAMPLE_REPS`` calls after one untimed)."""
    import copy

    import torch
    from pql_tpu_torch.models.diffusion import DiffusionPolicy
    from pql_tpu_torch.ops.ddpm import draw_sample

    gen = torch.Generator().manual_seed(0)
    pol = DiffusionPolicy(6, 2, gen=gen)
    state, pc = torch.randn(SAMPLE_ROWS, 6, generator=gen), torch.randn(SAMPLE_ROWS, 40, 3, generator=gen)
    x_T, noise = draw_sample(gen, SAMPLE_ROWS, 2, pol.sched.num_timesteps)
    card = copy.deepcopy(pol).to(dev)
    args = (state.to(dev), pc.to(dev), x_T.to(dev), noise.to(dev))
    with torch.no_grad():
        err = _rel_err(card.get_actions(*args), pol.get_actions(state, pc, x_T, noise))
        check(err <= EQ_TOL, f"DiffusionPolicy: sampler card vs CPU {err:.3g}")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(SAMPLE_REPS):
            card.get_actions(*args)
        end.record()
        torch.cuda.synchronize()
    return dict(card_vs_cpu_rel_err=err, sample_ms=start.elapsed_time(end) / SAMPLE_REPS, rows=SAMPLE_ROWS,
                steps=pol.sched.num_timesteps)


def vision_reference(dev, smi: str) -> dict:
    """The vision tier card vs CPU: each module (``vision_module_check``);
    two iterations of PPOV on ReacherVision and IPPOV on
    BimanualReacherVision at a small size (the ResNet encoder at full width;
    ``card_vs_cpu``: steps within 1% of their norms, losses 1e-3); the
    ``DiffusionPolicy`` sampler at 4096 rows; the kernels' launch counts are
    reset before and read after."""
    from pql_tpu_torch.ops import kernels

    kernels.reset_launches()
    modules = vision_module_check(dev)
    runs = card_vs_cpu(dev, VISION_REF)
    sampler = diffusion_policy_check(dev)
    return dict(config=[f"{a} {k}" for a, k in VISION_REF], iterations=2, card=smi, modules=modules, runs=runs,
                diffusion_policy_sampler=sampler, launches=dict(kernels.LAUNCHES))


def render_cost(agent, state) -> dict:
    """A camera task's render at the run's env count: ms per call (CUDA
    events around ``RENDER_REPS`` calls after one untimed; a rollout step
    renders once) and the memory one call adds at its peak; 8 updates per
    iteration."""
    import torch

    out = {}
    check(agent.cfg.algo.update_times * agent.rows // agent.cfg.algo.batch_size == 8,
          f"{agent.name}: not 8 updates per iteration")
    task = agent.env.task
    if hasattr(task, "render"):
        st = state.env_state.state
        task.render(st)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(RENDER_REPS):
            img = task.render(st)
        end.record()
        torch.cuda.synchronize()
        check(tuple(img.shape[1:]) == task.visual_spec["img"] and float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
              f"render {tuple(img.shape)} outside [0, 1]")
        out.update(render_ms_per_step=start.elapsed_time(end) / RENDER_REPS,
                   render_peak_extra_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
    return out


def vision_main_path(dev, smi: str) -> dict:
    """PPOV on ReacherVision @4096 (ResNet-18 trunk through layer2 on 2
    frames of 48×48, GroupNorm, fp32 without TF32) and IPPOV on
    BimanualReacherVision @4096, at the presets (horizon 16, batch 32768, 4
    epochs: 8 updates per iteration), as ``two_agent_main_path``, with the
    render's cost and, in the profiled window, the trunk ops' share of the
    device time (none on IPPOV, which has no camera)."""
    out = onpolicy_paths(dev, smi, VISION_PATHS, after=render_cost, trunk_ops=TRUNK_OPS)
    for name, r in out["runs"].items():
        check((r["trunk_device_ms_per_iter"] > 0) == ("task=ReacherVision" in name),
              f"{name}: trunk ops' device time {r['trunk_device_ms_per_iter']}")
    return out


def host_ring_check(dev) -> dict:
    """The port's ``HostReplay`` built here: a ring of ``RING_CHECK`` slots
    × envs written past its end, three batches bitwise equal to numpy fancy
    indexing of a mirror at ``default_rng(0)``'s (slot, env) draws; then two
    DDPGV agents (``DDPGV_REF``'s size) on the card and on the CPU with the
    same rows in their rings: three batches through the card's pinned
    staging sets and host-to-device copies bitwise equal to the CPU's."""
    import numpy as np
    import torch
    from pql_tpu_torch.algos.ddpgv import DDPGV
    from pql_tpu_torch.cfg import make_config
    from pql_tpu_torch.native import HostReplay, library_path

    slots, E, B = RING_CHECK
    rng = np.random.default_rng(0)
    fields, dtypes = {"img": 13824, "obs": 20, "done": 1}, {"img": np.uint8, "obs": np.float16, "done": np.float16}
    rows = {k: (rng.integers(0, 256, (slots + 3, E, d), dtype=np.uint8) if dtypes[k] == np.uint8
                else rng.normal(size=(slots + 3, E, d)).astype(dtypes[k])) for k, d in fields.items()}
    ring = HostReplay(slots, E, fields, dtypes)
    ring.add({k: v[:slots] for k, v in rows.items()})
    ring.add({k: v[slots:] for k, v in rows.items()})  # wraps: slots 0-2 rewritten
    mirror = {k: np.concatenate([v[slots:], v[3:slots]]) for k, v in rows.items()}
    draw = np.random.default_rng(0)
    for _ in range(3):
        got = ring.sample(B)
        slot, env = draw.integers(0, slots, B, dtype=np.int64), draw.integers(0, E, B, dtype=np.int64)
        for k in fields:
            check(np.array_equal(got[k], mirror[k][slot, env]), f"host ring gather of {k} differs from numpy")
    cfg = make_config("ddpgv", **DDPGV_REF[0][1])
    agents = {d: DDPGV(cfg, device=d) for d in ("cpu", dev)}
    chunk = {k: (rng.integers(0, 256, (3, cfg.num_envs, d), dtype=np.uint8) if agents["cpu"].replay.dtypes[k] == np.uint8
                 else rng.normal(size=(3, cfg.num_envs, d)).astype(np.float16))
             for k, d in agents["cpu"].replay.fields.items()}
    for a in agents.values():
        a.replay.add(chunk)
    for u in range(3):  # both staging sets, the first one twice
        got, want = agents[dev].fetch_batch(u), agents["cpu"].fetch_batch(u)
        for k in want:
            check(got[k].device.type == "cuda" and torch.equal(got[k].cpu(), want[k]),
                  f"pinned gather + copy of {k} differs from the CPU batch")
    staged = agents[dev]._staging_set(0)[0]
    check(all(t.is_pinned() for t in staged.values()), "the staging buffers are not pinned")
    return dict(library=str(library_path().relative_to(os.path.dirname(os.path.abspath(__file__)))),
                gather_bitwise_numpy=True, indices_bitwise_default_rng=True, pinned_h2d_bitwise_cpu=True,
                ring=list(RING_CHECK))


def ddpgv_reference(dev, smi: str) -> dict:
    """The host ring on this machine (``host_ring_check``) and the warm-up
    and two iterations of DDPGV at ``DDPGV_REF``'s size card vs CPU
    (``card_vs_cpu``: steps within 1% of their norms, losses 1e-3); the
    kernels' launch counts are reset before and read after."""
    from pql_tpu_torch.ops import kernels

    kernels.reset_launches()
    ring = host_ring_check(dev)
    runs = card_vs_cpu(dev, DDPGV_REF)
    return dict(config=[f"{a} {k}" for a, k in DDPGV_REF], card=smi, host_ring=ring, runs=runs,
                launches=dict(kernels.LAUNCHES))


def _proc_status(key: str) -> int:
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) for line in f if line.startswith(key + ":"))


def host_memory() -> dict:
    """The host's memory and overcommit policy, as ``free`` and
    /proc/sys/vm/overcommit_memory report them (GB)."""
    with open("/proc/meminfo") as f:
        info = {line.split(":")[0]: int(line.split()[1]) for line in f}
    with open("/proc/sys/vm/overcommit_memory") as f:
        policy = int(f.read())
    gb = lambda key: info[key] / 1e6 if key in info else None  # noqa: E731
    return dict(mem_total_gb=gb("MemTotal"), mem_available_gb=gb("MemAvailable"), commit_limit_gb=gb("CommitLimit"),
                committed_gb=gb("Committed_AS"), overcommit_memory=policy)


def host_hop(agent, state) -> dict:
    """DDPGV's host hop at the run's sizes, each part alone: the gather of
    one batch into a pinned staging set (host clock, median of
    ``HOP_REPS``), its copies to the card (CUDA events) and one collect's
    copies back (host clock to the card's end), and the ring write."""
    import statistics

    import torch

    dev = agent.device
    B = agent.cfg.algo.batch_size
    host, _ = agent._staging_set(0)
    gather, h2d = [], []
    for _ in range(HOP_REPS):
        t0 = time.perf_counter()
        agent.replay.sample(B, out=host)
        gather.append(1e3 * (time.perf_counter() - t0))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        batch = {k: v.to(dev, non_blocking=True) for k, v in host.items()}
        end.record()
        torch.cuda.synchronize()
        h2d.append(start.elapsed_time(end))
    batch_bytes = sum(v.numel() * v.element_size() for v in batch.values())
    traj = agent.collect(state, agent.draw_iteration(state.gen))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = agent.to_host(traj)
    d2h_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    agent.replay.add(rows)
    write_ms = 1e3 * (time.perf_counter() - t0)
    h2d_ms = statistics.median(h2d)
    return dict(batch_rows=B, batch_bytes=batch_bytes, gather_ms=statistics.median(gather), gather_ms_all=gather,
                h2d_ms=h2d_ms, h2d_gb_per_s=batch_bytes / h2d_ms / 1e6, h2d_ms_all=h2d,
                collect_bytes=sum(v.numel() * v.element_size() for v in rows.values()), d2h_ms=d2h_ms,
                ring_write_ms=write_ms,
                hop_ms_per_iter=agent.update_times * (statistics.median(gather) + h2d_ms) + d2h_ms + write_ms)


def ddpgv_main_path(dev, smi: str) -> dict:
    """DDPGV on ReacherVision @4096 at its preset (batch 8192, 4 updates per
    iteration, horizon 1, memory 5e6: host ring 1220 × 4096 × 28,200 B, the
    ResNet actor at full width, fp32): the warm-up and ``DDPGV_DEPTH``
    iterations, ms/iter in timed blocks, device ms and busy share from a
    profiled window, the render's ms per step, the host hop
    (``host_hop``), peak device memory, host RSS and threads, and the host's
    memory as the ring was made."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pql_tpu_torch.algos import get_algo
    from pql_tpu_torch.cfg import parse_cli
    from pql_tpu_torch.ops import kernels

    warm_iters, blocks, block_iters, profiled_iters = DDPGV_DEPTH
    cfg = parse_cli(list(DDPGV_ARGV))
    E, label = cfg.num_envs, "DDPGV ReacherVision@4096"
    mem = host_memory()
    threads0 = len(os.listdir("/proc/self/task"))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    agent = get_algo(cfg.algo.name)(cfg, device=dev)
    ring = agent.replay
    ring_gb = ring.slots * E * DDPGV_ROW_BYTES / 1e9
    check(sum(d * ring.dtypes[k].itemsize for k, d in ring.fields.items()) == DDPGV_ROW_BYTES,
          f"{label}: ring row of {DDPGV_ROW_BYTES} bytes expected")
    threads_ring = len(os.listdir("/proc/self/task"))
    state = agent.init()
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
    check(state.update_count == cfg.algo.update_times * iters == 4 * iters,
          f"{label}: {state.update_count} updates after {iters} iterations")
    check(state.env_steps == (1 + iters) * E and ring.filled == 1 + iters,
          f"{label}: env steps {state.env_steps}, ring filled {ring.filled} after the warm-up and {iters}")
    trackers = {n: float(getattr(state, n).mean()) for n in ("return_tracker", "len_tracker")}
    check(all(math.isfinite(v) for v in trackers.values()), f"{label} trackers {trackers}")
    check(launches["c51_td_target"] == 0, f"{label}: c51_td_target launched")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernel_rows = [r for r in prof.key_averages() if r.device_type == DeviceType.CUDA
                   and not getattr(r, "is_user_annotation", False)]
    device_ms = sum(_self_device_us(r) for r in kernel_rows) / 1e3 / profiled_iters
    task, st = agent.env.task, state.env_state.state
    task.render(st)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(RENDER_REPS):
        task.render(st)
    end.record()
    torch.cuda.synchronize()
    render_ms = start.elapsed_time(end) / RENDER_REPS
    hop = host_hop(agent, state)
    ms = statistics.median(block_ms)
    return dict(
        config=" ".join(DDPGV_ARGV) + f" (batch {cfg.algo.batch_size}, update_times {cfg.algo.update_times}, "
                                      f"horizon {cfg.algo.horizon_len}, memory {cfg.algo.memory_size:g}, fp32)",
        card=smi, host_memory=mem, ring=[ring.slots, E, DDPGV_ROW_BYTES], ring_virtual_gb=ring_gb,
        ring_written_gb=ring.filled * E * DDPGV_ROW_BYTES / 1e9, iterations=iters, setup_s=setup_s,
        ms_per_iter=ms, env_steps_per_s=1e3 * E / ms, block_ms_per_iter=block_ms,
        critic_loss_last=float(lo[-1][0]), actor_loss_last=float(lo[-1][1]), update_count=state.update_count,
        trackers=trackers, profiled_wall_ms_per_iter=profiled_wall_ms, device_ms_per_iter=device_ms,
        device_busy_share=device_ms / profiled_wall_ms, render_ms_per_step=render_ms, host_hop=hop,
        peak_mem_gb=peak_gb, host_rss_gb=_proc_status("VmRSS") / 1e6,
        threads=dict(before_ring=threads0, after_ring=threads_ring, now=len(os.listdir("/proc/self/task")),
                     cpu_count=os.cpu_count(), ring_fields=len(ring.fields)),
        launches=launches)


def ddpgv_entry_path(dev, smi: str, argv=DDPGV_ARGV, iters=DDPGV_ENTRY_ITERS) -> dict:
    """``train.main`` with ``argv`` for ``iters[0]`` iterations: an eval of
    ``eval_num_envs`` rendering envs and a full checkpoint at the last one,
    the best model; the checkpoint restored into a fresh agent bitwise
    (params, optimizers, normalizer: DDPGV's state holds no ring); then
    ``train_baseline`` resumes it as the JAX package does (no warm-up, an
    empty ring refilled one collect per iteration, ``_resumed_iter`` counting
    from ``warm_up`` × E) and stops after env step (1 + iters[1]) × E."""
    import contextlib
    import io
    import shutil

    import torch
    from pql_tpu_torch import train
    from pql_tpu_torch.algos import get_algo
    from pql_tpu_torch.cfg import parse_cli
    from pql_tpu_torch.ops import kernels
    from pql_tpu_torch.utils import checkpoint
    from pql_tpu_torch.utils.logging import RunLogger

    root = os.path.join(SMOKE_DIR, "ddpgv_entry")
    shutil.rmtree(root, ignore_errors=True)
    first, total = iters
    cfg = parse_cli(list(argv))
    E = cfg.num_envs
    common = list(argv) + [f"algo.eval_freq={first}", "algo.log_freq=1", f"checkpoint_freq={first}",
                           f"logging.out_dir={root}/runs", "logging.console=false", f"checkpoint_dir={root}/ckpt"]
    kernels.reset_launches()
    t0 = time.perf_counter()
    train.main(common + [f"max_step={(1 + first) * E - 1}", "logging.run_name=first", f"--device={dev}"])
    torch.cuda.synchronize()
    wall_first = time.perf_counter() - t0
    run_dir = os.path.join(root, "runs", "first")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    evals = [r for r in recs if "eval/return" in r]
    check([r["step"] for r in evals] == [(1 + first) * E] and math.isfinite(evals[0]["eval/return"]),
          f"eval records {[(r['step'], r['eval/return']) for r in evals]}, predicted one at {(1 + first) * E}")
    ckpt = os.path.join(root, "ckpt", "state")
    ckpt_file = os.path.join(ckpt, checkpoint.STATE_FILE)
    check(os.path.exists(ckpt_file) and os.path.exists(os.path.join(run_dir, "best_model", checkpoint.SNAPSHOT_FILE)),
          "the checkpoint or the best model is missing")
    saved = torch.load(ckpt_file, map_location="cpu", weights_only=True)
    check("replay" not in saved, "a DDPGV checkpoint holds a ring")
    fresh = get_algo(cfg.algo.name)(cfg, device=dev)
    t1 = time.perf_counter()
    restored = checkpoint.load_checkpoint(ckpt, fresh.init(seed=cfg.seed + 1))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    now = checkpoint.state_dict(restored)
    for name in ("actor", "critic", "critic_target", "actor_opt", "critic_opt", "obs_rms"):
        diffs = []

        def walk(x, y, path):
            if isinstance(x, dict):
                for k in x:
                    walk(x[k], y[k], f"{path}.{k}")
            elif torch.is_tensor(x):
                if not torch.equal(x.cpu(), y):
                    diffs.append(path)
            elif x != y:
                diffs.append(path)

        walk(now[name], saved[name], name)
        check(not diffs, f"restored {name} differs from the saved one in {diffs[:4]}")
    check(fresh.replay.filled == 0, "a fresh agent's ring is not empty")
    del fresh, restored
    torch.cuda.empty_cache()

    c = parse_cli(common + [f"max_step={(1 + total) * E - 1}", "logging.run_name=second"])
    logger = RunLogger(c)
    out = io.StringIO()
    t1 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            agent, resumed = train.train_baseline(c, logger, dev)
    finally:
        logger.close()
    wall_resumed = time.perf_counter() - t1
    check(f"at env step {(1 + first) * E} (no warm-up)" in out.getvalue(), f"no resume: {out.getvalue()[-200:]!r}")
    check(agent.replay.filled == total - first and resumed.env_steps == (1 + total) * E,
          f"the resumed ring holds {agent.replay.filled} slots, env steps {resumed.env_steps}")
    check(train._resumed_iter(c, resumed, True) == max(0, 1 + total - cfg.algo.warm_up),
          "the resumed iteration count does not follow the JAX package's rule")
    launches = dict(kernels.LAUNCHES)
    ckpt_bytes = os.path.getsize(ckpt_file)
    shutil.rmtree(root, ignore_errors=True)
    return dict(config=" ".join(argv) + f" (eval_num_envs {cfg.eval_num_envs}, memory {cfg.algo.memory_size:g})",
                card=smi, iterations_first=first, env_step_resumed_at=(1 + first) * E,
                iterations_after_resume=total - first, eval_return=evals[0]["eval/return"],
                restored_bitwise=True, ring_filled_after_resume=total - first,
                resumed_iteration_count=train._resumed_iter(c, resumed, True), checkpoint_bytes=ckpt_bytes,
                checkpoint_load_s=load_s, wall_s_first=wall_first, wall_s_resumed=wall_resumed, launches=launches)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_one_rank(dev, smi: str, argv=DIST_ARGV, iters: int = DIST_ITERS) -> dict:
    """PQL-D through ``parallel.initialize`` with a one-rank NCCL group
    (``num_devices=1``, ``dist.num_processes=1``, ``dist.process_id=0``):
    the warm-up and ``iters`` iterations bitwise equal to the same run
    without a process group, ``c51_td_target`` 8 launches per iteration,
    ``update_sharded`` on the group within ``EQ_TOL`` of ``update`` (on the
    card ``update`` divides by Python scalars, which CUDA does as a multiply
    by the reciprocal, and ``update_sharded`` by tensors), and the CUDA-event
    time of an all-reduce of the critic's gradient (one flat fp32 tensor)."""
    import torch
    import torch.distributed as dist
    from pql_tpu_torch import parallel
    from pql_tpu_torch.algos.pql import PQL
    from pql_tpu_torch.cfg import parse_cli
    from pql_tpu_torch.ops import kernels
    from pql_tpu_torch.ops.running_norm import RunningMeanStd

    keys = ["num_devices=1", "dist.num_processes=1", "dist.process_id=0",
            f"dist.coordinator_address=localhost:{free_port()}"]

    def run():
        agent = PQL(parse_cli(list(argv) + keys), device=dev)
        state, _ = agent.warmup(agent.init())
        for _ in range(iters):
            state, _ = agent.train_iter(state)
        torch.cuda.synchronize()
        return state

    check(not dist.is_initialized(), "a process group is already up")
    alone = run()
    t0 = time.perf_counter()
    check(parallel.initialize(parse_cli(list(argv) + keys), dev), "no process group")
    init_s = time.perf_counter() - t0
    try:
        check(dist.get_backend() == "nccl" and parallel.world_size() == 1, f"backend {dist.get_backend()}")
        kernels.reset_launches()
        grouped = run()
        launches = dict(kernels.LAUNCHES)
        diffs = state_diffs(alone, grouped)
        check(not diffs, f"the one-rank group's run differs from the run without a group in {diffs[:8]}")
        check(launches["c51_td_target"] == 8 * iters, f"c51_td_target launched {launches['c51_td_target']} times")
        x = torch.randn(4096, 4, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        a, b = RunningMeanStd((4,), device=dev), RunningMeanStd((4,), device=dev)
        a.update(x)
        b.update_sharded(x)
        rms_err = max(_rel_err(getattr(b, k), getattr(a, k).cpu()) for k in ("mean", "var", "count"))
        check(rms_err <= EQ_TOL, f"update_sharded on one rank {rms_err:.3g} from update")
        flat = torch.cat([p.detach().reshape(-1) for p in grouped.critic.parameters()])
        for _ in range(3):
            dist.all_reduce(flat)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(ALLREDUCE_REPS):
            dist.all_reduce(flat)
        end.record()
        torch.cuda.synchronize()
        allreduce_ms = start.elapsed_time(end) / ALLREDUCE_REPS
    finally:
        parallel.shutdown()
    return dict(config=" ".join(argv) + " " + " ".join(keys[:3]), card=smi, iterations=iters, init_s=init_s,
                bitwise_equal_without_group=True, update_sharded_rel_err=rms_err, launches=launches,
                critic_grad_bytes=flat.numel() * 4,
                allreduce_ms=allreduce_ms, backend="nccl", world_size=1)


def _quat_to_mat_np(quat):
    w, x, y, z = np.moveaxis(quat, -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def legacy_states(task, E: int, seed: int = 0):
    """(q, qd, contact state) float32 numpy states of a task at E envs that
    reach every branch of its contact groups (the CPU tests' constructions,
    tests/test_torch_legacy_contact.py and tests/test_torch_contact_hand.py).

    Ant: the free base from 10 cm under the ground to 60 cm over it, any
    orientation (half near upright), hinges across and past their limits,
    velocities N(0, 2-3): spheres separated, penetrating, capped, pressed
    apart faster than the spring pushes, with Coulomb-limited and viscous
    friction. AllegroHand: envs with e % 8 in 0..4 put one finger sphere
    inside the cube nearest the x, y or z face, just outside a face or just
    outside a corner; the others drop the cube near the palm. Every pair's
    anchor lies 1e-6 to 1e-2 m off its tracked point, engaged at random."""
    import torch
    from pql_tpu_torch.envs.hand import CUBE_HALF
    from pql_tpu_torch.physics import contact as tc
    from pql_tpu_torch.physics import dynamics as td

    rng = np.random.RandomState(seed)
    m = task.model
    cols = lambda a: [torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(a.shape[1])]  # noqa: E731
    arr = lambda x: np.stack([arr(y) for y in x]) if isinstance(x, list) else (  # noqa: E731
        x.numpy() if isinstance(x, torch.Tensor) else np.full(E, x))
    if not hasattr(task, "cube"):
        q = np.tile(np.asarray(m.neutral_q(), np.float64), (E, 1))
        quat = rng.normal(size=(E, 4))
        quat[: E // 2] = [1.0, 0.0, 0.0, 0.0] + 0.2 * quat[: E // 2]
        q[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
        q[:, 2] = rng.uniform(-0.1, 0.6, E)
        q[:, 7:] = rng.uniform(-1.5, 1.5, (E, m.nq - 7))
        qd = rng.normal(0.0, 2.0, (E, m.nv))
        qd[:, 3:6] = rng.normal(0.0, 3.0, (E, 3))
        R, p, _, _ = td._kin_s(m, cols(q))
        points = np.stack([arr(p[g.body]).T + np.einsum("rce,c->er", arr(R[g.body]), np.asarray(g.offset))
                           for g in m.geoms], 1)
    else:
        n_dof, cq, ng = task.n_dof, task.cube_q, len(m.geoms)
        lo, hi = m.limit_lo[:n_dof], m.limit_hi[:n_dof]
        q = np.zeros((E, m.nq))
        q[:, :n_dof] = lo + (hi - lo) * rng.uniform(0.05, 0.95, (E, n_dof))
        quat = rng.normal(size=(E, 4))
        quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
        q[:, cq + 3 : cq + 7] = quat
        R, p, _, _ = td._kin_s(m, cols(q))
        centres = np.stack([arr(p[g.body]).T + np.einsum("rce,c->er", arr(R[g.body]), np.asarray(g.offset))
                            for g in m.geoms], 1)
        h, r = CUBE_HALF, m.geoms[0].radius
        Rb, kind, e = _quat_to_mat_np(quat), np.arange(E) % 8, np.arange(E)
        s = rng.choice([-1.0, 1.0], (E, 3))
        local = s * rng.uniform(0.0, 0.5, (E, 3)) * h
        inside = kind <= 2
        local[e[inside], kind[inside]] = s[e[inside], kind[inside]] * 0.8 * h
        face = kind == 3
        local[face] = s[face] * rng.uniform(0.0, 0.7, (face.sum(), 3)) * h
        local[e[face], e[face] % 3] = s[e[face], e[face] % 3] * (h + 0.5 * r)
        corner = kind == 4
        local[corner] = s[corner] * (h + 0.3 * r)
        j = rng.randint(ng, size=E)
        q[:, cq : cq + 3] = centres[e, j] - np.einsum("erc,ec->er", Rb, local)
        drop = kind >= 5
        q[drop, cq : cq + 3] = np.concatenate([rng.uniform(-0.05, 0.05, (drop.sum(), 2)),
                                               rng.uniform(0.0, 0.06, (drop.sum(), 1))], -1)
        qd = np.concatenate([rng.normal(0.0, 2.0, (E, n_dof)), rng.normal(0.0, 0.3, (E, 6))], -1)
        pos = q[:, cq : cq + 3]
        rel = np.einsum("erc,ejr->ejc", Rb, centres - pos[:, None])
        corners = pos[:, None] + np.einsum("erc,jc->ejr", Rb, np.asarray(tc._CORNER_SIGNS) * h)
        points = np.concatenate([centres, rel, corners], 1)  # the hand's pair slots
    off = rng.normal(size=points.shape)
    off *= (10.0 ** rng.uniform(-6, -2, points.shape[:2]))[..., None] / np.linalg.norm(off, axis=-1, keepdims=True)
    engaged = rng.randint(0, 2, points.shape[:2])
    cs = np.concatenate([points + off, engaged[..., None]], -1).reshape(E, -1)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)  # noqa: E731
    return f32(q), f32(qd), f32(cs)


def graph_cost(fn, reps: int = LEGACY_REPS) -> dict:
    """``fn()`` captured in one CUDA graph (warm-up off the capture first):
    its kernel nodes (libcuda) and the mean ms of ``reps`` replays between
    CUDA events. Raises if the function cannot be captured."""
    import torch
    from pql_tpu_torch.envs.rigid import collected_gc

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with collected_gc(), torch.cuda.graph(graph):
        fn()
    kernels, _ = graph_kernel_nodes(graph)
    check(kernels > 0, "an empty graph: the function launched nothing on the capturing stream")
    graph.instantiate()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return dict(kernel_nodes=kernels, ms=start.elapsed_time(end) / reps)


def _branch_spies(counts: dict):
    """Patches of the port's contact cores that count, per branch, the pairs
    that took it (torch ops on the inputs; eager calls only: a trace for the
    hand's generated kernel, whose inputs are symbols, passes straight to the
    core)."""
    from unittest import mock

    import torch
    from pql_tpu_torch.physics import contact as tc
    from pql_tpu_torch.physics import scalar_algebra as sa
    from pql_tpu_torch.physics.codegen import Sym

    def add(name, mask):
        counts[name] = counts.get(name, 0) + int(mask.sum())

    viscous_core, anchored_core, in_box = tc._contact_force_s, tc._anchored_force_s, tc._sphere_in_box_s

    def viscous(depth, normal, vel, kp, kd, mu, cap, ref):
        if any(isinstance(x, Sym) for x in (depth, *normal, *vel)):
            return viscous_core(depth, normal, vel, kp, kd, mu, cap, ref)
        d = tc._col(depth, ref)
        vn = sa.v3_dot(vel, normal)
        raw = kp * d - kd * vn
        vt = sa.v3_norm(sa.v3_sub(vel, sa.v3_scale(normal, vn))) + 1e-6
        active, fn = d > 0.0, torch.clamp(raw, 0.0, cap)
        add("viscous_separated", ~active)
        add("viscous_penetrating", active)
        add("viscous_capped", active & (raw > cap))
        add("viscous_pulled_apart", active & (raw < 0.0))
        add("viscous_coulomb_limited", active & (raw > 0.0) & (mu * fn < 2.0 * kd * vt))
        add("viscous_damped", active & (raw > 0.0) & (mu * fn > 2.0 * kd * vt))
        return viscous_core(depth, normal, vel, kp, kd, mu, cap, ref)

    def anchored(depth, normal, vel, dx, engaged, pp):
        if any(isinstance(x, Sym) for x in (depth, *normal, *vel)):
            return anchored_core(depth, normal, vel, dx, engaged, pp)
        force, dxt_new, active = anchored_core(depth, normal, vel, dx, engaged, pp)
        act, eng = active > 0.5, engaged > 0.5
        moved = sa.v3_norm(sa.v3_sub(dxt_new, sa.v3_sub(dx, sa.v3_scale(normal, sa.v3_dot(dx, normal)))))
        add("anchored_separated", ~act)
        add("anchored_fresh_touch", act & ~eng)
        add("anchored_sticking", act & eng & (moved == 0.0))
        add("anchored_sliding", act & eng & (moved > 0.0))
        return force, dxt_new, active

    def sphere_in_box(local, half, radius):
        if any(isinstance(x, Sym) for x in local):
            return in_box(local, half, radius)
        add("sphere_inside_box", (torch.abs(local[0]) < half[0]) & (torch.abs(local[1]) < half[1])
            & (torch.abs(local[2]) < half[2]))
        return in_box(local, half, radius)

    return [mock.patch.object(tc, "_contact_force_s", viscous), mock.patch.object(tc, "_anchored_force_s", anchored),
            mock.patch.object(tc, "_sphere_in_box_s", sphere_in_box)]


def legacy_contact_check(dev, smi: str) -> dict:
    """The legacy viscous groups in both forms and the per-pair anchored
    loops on seeded states (``legacy_states``) of the Ant @4096 (the ground
    group) and the AllegroHand @8192 (all three groups): the matrix form
    against the scalar form and the loops against the vectorized groups on
    the card, the card against the CPU, the branches reached; each form's
    kernel nodes and graph ms; then one Ant control step (``physics_substeps``
    with ``ground_contacts_s``) graphed, bitwise its eager step and within
    STEP_TOL of the CPU's."""
    import contextlib
    import statistics

    import torch
    from pql_tpu_torch.envs import make_task
    from pql_tpu_torch.envs.hand import CUBE_HALF
    from pql_tpu_torch.envs.rigid import GraphedStep
    from pql_tpu_torch.physics import contact as tc
    from pql_tpu_torch.physics import dynamics as td
    from pql_tpu_torch.physics.contact import add_fext_s

    cpu = torch.device("cpu")
    out = {}
    for name, E in LEGACY_TASKS.items():
        task = make_task(name)
        m = task.model
        tol = step_tol(task)
        q_atol, qd_atol = tol["q"][1], HAND_STEP_TOL["qd"][1] if name in HAND_TASKS else tol["qd"][1]
        force_tol = (1e-4, m.contact_kp * q_atol + m.contact_kd * qd_atol)
        max_flips = HAND_MAX_FLIPS if name in HAND_TASKS else PHYS_MAX_FLIPS
        q, qd, cs = legacy_states(task, E, seed=0)

        def kin(device):
            cols = lambda a: [torch.from_numpy(np.ascontiguousarray(a[:, i])).to(device) for i in range(a.shape[1])]  # noqa: E731
            R, p, X, S = td._kin_s(m, cols(q))
            v = td._vel_s(m, X, S, cols(qd))
            ref = cols(q)[0]
            st = lambda c: c if isinstance(c, torch.Tensor) else torch.full_like(ref, c)  # noqa: E731
            Rm = torch.stack([torch.stack([torch.stack([st(c) for c in row], -1) for row in Rb], -2) for Rb in R], -3)
            pm = torch.stack([torch.stack([st(c) for c in pb], -1) for pb in p], -2)
            vm = torch.stack([torch.stack([st(c) for c in vb], -1) for vb in v], -2)
            return R, p, v, cols(cs), (Rm, pm, vm)

        def wrench(f, ref):
            return torch.stack([torch.stack([c if isinstance(c, torch.Tensor) else torch.full_like(ref, c)
                                             for c in row], -1) for row in f], -2)

        def column_stack(cols_, ref):
            return torch.stack([c if isinstance(c, torch.Tensor) else torch.full_like(ref, c) for c in cols_], -1)

        groups = {"ground": (lambda k: tc.ground_contacts(m, *k[4]), lambda k: tc.ground_contacts_s(m, *k[:3]))}
        card_dev = torch.empty(0, device=dev).device  # cuda:<index> as the tensors report it
        pairs = {d: tc.ground_pairs(m, task._pp_ground, d) for d in (card_dev, cpu)}
        anchored = {"ground anchored": (
            lambda k: _stateful_call(tc.ground_anchored_s, m, k, 0, task._pp_ground),
            lambda k: _stateful_call(tc.ground_anchored_v, m, k, 0, pairs[k[3][0].device]),
        )}
        if name in HAND_TASKS:
            cube, half = task.cube, [CUBE_HALF] * 3

            def half_t(k):
                return torch.full((3,), CUBE_HALF, device=k[3][0].device)

            groups["sphere_box"] = (lambda k: tc.sphere_box_contacts(m, *k[4], cube, half_t(k)),
                                    lambda k: tc.sphere_box_contacts_s(m, *k[:3], cube, half))
            groups["box_ground"] = (lambda k: (tc.box_ground_contacts(m, *k[4], cube, half_t(k)), None),
                                    lambda k: (tc.box_ground_contacts_s(m, *k[:3], cube, half), None))

            def scalar_loops(k):
                R, p, v, cs_ = k[:4]
                cs_new = list(cs_)
                f1, idx = tc.ground_anchored_s(m, R, p, v, cs_, cs_new, 0, task._pp_ground)
                f2, idx = tc.sphere_box_anchored_s(m, R, p, v, cube, half, cs_, cs_new, idx, task._pp_cube)
                f3, _ = tc.box_ground_anchored_s(m, R, p, v, cube, half, cs_, cs_new, idx, task._pp_corner)
                return add_fext_s(f1, f2, f3), cs_new

            anchored = {"hand contact function": (scalar_loops, lambda k: task._contact_fn(task._on(k[3][0].device))(
                m, *k[:4]))}

        def evaluate(device, spies=False):
            counts = {}
            with contextlib.ExitStack() as stack:
                for patch in (_branch_spies(counts) if spies else []):
                    stack.enter_context(patch)
                k = kin(device)
                ref = k[3][0]
                res = {}
                for g, (mat_fn, sc_fn) in groups.items():
                    fm, mm = mat_fn(k)
                    fs, ms = sc_fn(k)
                    res[g] = dict(matrix=fm, scalar=wrench(fs, ref), mags_matrix=mm,
                                  mags_scalar=None if ms is None else column_stack(ms, ref))
                for g, (loop_fn, vec_fn) in anchored.items():
                    fl, csl = loop_fn(k)
                    fv, csv = vec_fn(k)
                    res[g] = dict(loops=wrench(fl, ref), loops_cs=column_stack(csl, ref),
                                  vectorized=wrench(fv, ref), vectorized_cs=column_stack(csv, ref))
            return res, counts

        card, counts = evaluate(torch.device(dev), spies=True)
        host, _ = evaluate(cpu)
        torch.cuda.synchronize()
        checks, flips = {}, {}
        for g, r in card.items():
            if "matrix" in r:
                err = float((r["matrix"] - r["scalar"]).abs().max())
                check(err <= LEGACY_FORMS_TOL, f"{name} {g}: matrix and scalar forms {err:.3g} apart")
                checks[f"{g} matrix vs scalar"] = err
                if r["mags_matrix"] is not None:
                    err = float((r["mags_matrix"] - r["mags_scalar"]).abs().max())
                    check(err <= LEGACY_FORMS_TOL, f"{name} {g}: magnitudes of the two forms {err:.3g} apart")
                fields = {"matrix": force_tol, "scalar": force_tol}
            else:
                ferr = (r["loops"] - r["vectorized"]).abs()
                check(bool((ferr <= ANCHORED_TOL["atol"] + ANCHORED_TOL["rtol"] * r["vectorized"].abs()).all()),
                      f"{name} {g}: per-pair loops and vectorized groups {float(ferr.max()):.3g} apart")
                cerr = float((r["loops_cs"] - r["vectorized_cs"]).abs().max())
                check(cerr <= ANCHORED_STATE_ATOL, f"{name} {g}: contact states {cerr:.3g} apart")
                checks[f"{g} loops vs vectorized"] = dict(wrench=float(ferr.max()), contact_state=cerr)
                fields = {"loops": force_tol, "loops_cs": tol["contact"], "vectorized": force_tol,
                          "vectorized_cs": tol["contact"]}
            got = {k: v.reshape(E, -1) for k, v in r.items() if k in fields}
            want = {k: host[g][k].reshape(E, -1) for k in got}
            got["terminated"] = want["terminated"] = torch.zeros(E, dtype=torch.bool)
            off, max_err = envs_beyond_tol(got, want, fields, E)
            check(len(off) <= max_flips, f"{name} {g}: card and CPU differ beyond tolerance in envs {off}")
            flips[g] = dict(envs_beyond_tol=off, max_abs_err=max_err)
        for branch in ("viscous_separated", "viscous_penetrating", "viscous_capped", "viscous_pulled_apart",
                       "viscous_coulomb_limited", "viscous_damped", "anchored_separated", "anchored_fresh_touch",
                       "anchored_sticking", "anchored_sliding") + (("sphere_inside_box",) if name in HAND_TASKS else ()):
            check(counts.get(branch, 0) > 0, f"{name}: no pair took the branch {branch}")

        k = kin(torch.device(dev))
        costs = {}
        for g, (mat_fn, sc_fn) in groups.items():
            costs[f"{g} matrix"] = graph_cost(lambda: mat_fn(k))
            costs[f"{g} scalar"] = graph_cost(lambda: sc_fn(k))
        for g, (loop_fn, vec_fn) in anchored.items():
            costs[f"{g} per-pair loops"] = graph_cost(lambda: loop_fn(k))
            costs[f"{g} vectorized"] = graph_cost(lambda: vec_fn(k))
        out[name] = dict(envs=E, branches=counts, forms=checks, card_vs_cpu=flips, card=smi, form_costs=costs,
                         force_tol=force_tol)

    # one Ant control step with the legacy ground contacts as its contact function
    task = make_task("Ant")
    E = LEGACY_TASKS["Ant"]
    gen = torch.Generator().manual_seed(0)
    state = task.init_state(task.draw_reset(gen, E).to(dev))
    state = {k: v for k, v in state.items() if k != "contact"}
    action = (torch.rand(E, task.action_dim, generator=gen) * 2.0 - 1.0).to(dev)

    def legacy_step(st, a):
        q2, qd2 = td.physics_substeps(task.model, st["q"], st["qd"], a, task.substeps,
                                      contact_fn=lambda m, R, p, v: tc.ground_contacts_s(m, R, p, v)[0])
        return {"q": q2, "qd": qd2}, q2[:, 2], ~torch.isfinite(q2).all(-1), {}

    graphed_step = GraphedStep(legacy_step, state, action)
    g_out = graphed_step(state, action)
    e_out = legacy_step(state, action)
    c_out = legacy_step({k: v.cpu() for k, v in state.items()}, action.cpu())
    torch.cuda.synchronize()
    for key in ("q", "qd"):
        check(torch.equal(g_out[0][key], e_out[0][key]), f"the legacy Ant step: graphed and eager differ in {key}")
    got = dict(g_out[0], terminated=g_out[2])
    want = dict(c_out[0], terminated=c_out[2])
    step_off, step_err = envs_beyond_tol(got, want, {k: STEP_TOL[k] for k in ("q", "qd")}, E)
    check(len(step_off) <= PHYS_MAX_FLIPS, f"the legacy Ant step: card and CPU differ beyond STEP_TOL in {step_off}")
    nodes = graphed_step.kernels
    period = []
    for _ in range(PHYS_TIMINGS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(PHYS_REPS):
            graphed_step.graph.replay()
        end.record()
        torch.cuda.synchronize()
        period.append(start.elapsed_time(end) / PHYS_REPS)
    eager_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        legacy_step(state, action)
        torch.cuda.synchronize()
        eager_ms.append(1e3 * (time.perf_counter() - t1))
    out["ant_legacy_control_step"] = dict(
        envs=E, graphed_equals_eager_bitwise=True, card_vs_cpu_envs_beyond_tol=step_off,
        card_vs_cpu_max_abs_err=step_err, launches_per_control_step=nodes,
        graph_replay_period_ms=statistics.median(period), graph_replay_period_ms_timings=period,
        eager_wall_ms=statistics.median(eager_ms), graph_build_s=graphed_step.build_s, card=smi)
    return out


def _stateful_call(fn, m, k, base, pairs):
    """A stateful ground group on the kinematics ``k`` = (R, p, v, cs, …):
    (f_ext, the new contact state columns)."""
    cs_new = list(k[3])
    f, _ = fn(m, k[0], k[1], k[2], k[3], cs_new, base, pairs)
    return f, cs_new


def contact_lab_phase(dev, smi: str) -> dict:
    """Every scene of ``pql_tpu_torch.contact_lab`` on the card, its printed
    lines kept: verdict, numbers, wall seconds, control steps and the kernel
    nodes of each captured control step it replayed. Fails if a scene
    outside ``KNOWN_REGRESSIONS`` fails."""
    import contextlib
    import io

    import torch
    from pql_tpu_torch import contact_lab

    scenes, verdicts = {}, {}
    for name, scene in contact_lab.SCENARIOS.items():
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = scene(dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        verdicts[name] = res.ok
        nodes = [s.kernels for s in res.steps]
        scenes[name] = dict(ok=res.ok, numbers=res.numbers, wall_s=wall, control_steps=res.control_steps,
                            graph_kernel_nodes_per_control_step=sorted(set(nodes)), graphs_captured=len(nodes),
                            printed=buf.getvalue().strip().splitlines())
    bad, known = contact_lab.gate(verdicts)
    check(not bad, f"lab scenes outside KNOWN_REGRESSIONS fail: {bad}")
    return dict(card=smi, scenes=scenes, failing_known_regressions=known, all_pass_but_known=True)


def visualize_path(dev, smi: str) -> dict:
    """``train.main`` (PQL-D Cartpole @4096, VIS_ITERS iterations with evals)
    writes a best model; ``pql_tpu_torch.visualize`` rolls it for
    VIS_EPISODES episode batches; an ``Evaluator`` built from the same
    snapshot with the same generator must print and return the same."""
    import contextlib
    import io
    import shutil

    import torch
    from pql_tpu_torch import train, visualize
    from pql_tpu_torch.algos import get_algo
    from pql_tpu_torch.cfg import Config, parse_cli
    from pql_tpu_torch.envs import make_env
    from pql_tpu_torch.ops import kernels
    from pql_tpu_torch.utils.checkpoint import load_model_snapshot, restore_into_state
    from pql_tpu_torch.utils.evaluator import Evaluator

    root = os.path.join(SMOKE_DIR, "visualize")
    shutil.rmtree(root, ignore_errors=True)
    cfg = parse_cli(list(VIS_ARGV))
    ipc, warm, E = cfg.algo.iters_per_call, cfg.algo.warm_up, cfg.num_envs
    argv = list(VIS_ARGV) + [f"max_step={(warm + VIS_ITERS - ipc) * E}", f"algo.eval_freq={ipc}",
                             f"logging.out_dir={root}/runs", "logging.run_name=vis", "logging.console=false",
                             f"--device={dev}"]
    kernels.reset_launches()
    t0 = time.perf_counter()
    train.main(argv)
    torch.cuda.synchronize()
    train_s, train_launches = time.perf_counter() - t0, dict(kernels.LAUNCHES)
    check(train_launches["c51_td_target"] == 8 * VIS_ITERS, f"c51_td_target {train_launches} in train.main")
    best = os.path.join(root, "runs", "vis", "best_model")
    check(os.path.isdir(best), "train.main wrote no best model")

    vis_argv = [VIS_ARGV[0], VIS_ARGV[1], f"artifact={best}", f"episodes={VIS_EPISODES}", f"--device={dev}"]
    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        printed_metrics = visualize.main(vis_argv)
    torch.cuda.synchronize()
    vis_s, vis_launches = time.perf_counter() - t0, dict(kernels.LAUNCHES)
    check(vis_launches["c51_td_target"] == 0, "visualize launched the C51 kernel")
    lines = buf.getvalue().strip().splitlines()
    check(len(lines) == VIS_EPISODES == len(printed_metrics), f"visualize printed {lines}")

    # the same snapshot and generator, by hand
    vcfg = parse_cli(vis_argv[:3], base=Config(num_envs=16, eval_num_envs=16))
    agent = get_algo(vcfg.algo.name)(vcfg, dev)
    state = agent.init()
    state = restore_into_state(state, load_model_snapshot(best), agent.snapshot_parts(state))
    ev = Evaluator(vcfg, make_env(vcfg), agent.eval_actor_apply, dev)
    gen = torch.Generator(device=dev).manual_seed(vcfg.seed + 1)
    want, ms = [], []
    for _ in range(VIS_EPISODES):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want.append(ev.eval_policy(agent.eval_params(state), state.obs_rms, gen))
        ms.append(1e3 * (time.perf_counter() - t1))
    for ep, (line, got, w) in enumerate(zip(lines, printed_metrics, want)):
        check(got == w, f"episode batch {ep}: visualize {got} vs the Evaluator {w}")
        expect = f"episode batch {ep}: return={w['eval/return']:.2f} length={w['eval/episode_length']:.1f}"
        check(line == expect, f"printed {line!r}, expected {expect!r}")
        check(math.isfinite(w["eval/return"]), "non-finite eval return")
    shutil.rmtree(root, ignore_errors=True)
    return dict(config=" ".join(VIS_ARGV) + f", {VIS_ITERS} iterations through train.main", card=smi,
                train_main_s=train_s, visualize_s=vis_s, printed=lines, returns=[w["eval/return"] for w in want],
                equal_to_evaluator=True, ms_per_episode_batch=ms, eval_envs=ev.env.num_envs,
                eval_steps=ev.env.max_episode_length, launches=vis_launches, train_main_launches=train_launches)


def ratio_sweep_phase(dev, smi: str) -> dict:
    """``pql_tpu_torch.ratio_sweep.main`` on AllegroHand @8192 (algo=pql)
    at SWEEP_POINTS for SWEEP_SECONDS each: per point exactly cs and cs/ca
    updates per iteration (horizon 1) over the timed window, the printed
    JSON record with the JAX script's keys, finite rates and eval return,
    0 ``c51_td_target`` launches, and the table file."""
    import contextlib
    import io
    from unittest import mock

    import torch
    from pql_tpu_torch import ratio_sweep
    from pql_tpu_torch.cfg import parse_cli
    from pql_tpu_torch.ops import kernels

    keys = ["critic_sample_ratio", "critic_actor_ratio", "seconds", "env_steps_per_s", "critic_updates_per_s",
            "actor_updates_per_s", "train_return_final", "train_return_slope_per_s", "eval_return"]
    windows, launches = [], []
    measure = ratio_sweep.run_point

    def recorded(cfg, cs, ca, seconds, device="cuda", eval_env=None):
        kernels.reset_launches()
        t0 = time.perf_counter()
        record, window = measure(cfg, cs, ca, seconds, device, eval_env)
        torch.cuda.synchronize()
        windows.append(dict(window, point_wall_s=time.perf_counter() - t0))
        launches.append(dict(kernels.LAUNCHES))
        torch.cuda.empty_cache()
        return record, window

    out_file = os.path.join(SMOKE_DIR, "ratio_sweep.json")
    argv = list(SWEEP_ARGV) + [f"sweep={SWEEP_POINTS}", f"seconds_per_point={SWEEP_SECONDS}", f"out={out_file}",
                               f"--device={dev}"]
    buf = io.StringIO()
    with mock.patch.object(ratio_sweep, "run_point", recorded), contextlib.redirect_stdout(buf):
        results = ratio_sweep.main(argv)
    printed = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    check(printed == results, "the printed records differ from the returned ones")
    with open(out_file) as f:
        table = json.load(f)
    check(list(table) == ["task", "num_envs", "batch_size", "seconds_per_point", "points"]
          and table["points"] == results, "the table file")
    horizon = parse_cli(list(SWEEP_ARGV)).algo.horizon_len
    points = []
    for spec, r, w, n in zip(SWEEP_POINTS.split(","), results, windows, launches):
        cs, ca = (int(x) for x in spec.split(":"))
        check(list(r) == keys, f"point {spec}: keys {list(r)}")
        it = w["iterations"]
        check(it > 0 and w["critic_updates"] == cs * horizon * it and w["actor_updates"] == max(cs // ca, 1) * horizon * it,
              f"point {spec}: {w['critic_updates']} critic and {w['actor_updates']} actor updates in {it} iterations")
        check(w["env_steps"] == it * horizon, f"point {spec}: {w['env_steps']} env steps per env")
        check(all(math.isfinite(r[k]) for k in keys if r[k] is not None), f"point {spec}: non-finite {r}")
        check(n["c51_td_target"] == 0, f"point {spec}: c51_td_target launched {n['c51_td_target']} times")
        points.append(dict(record=r, window=w, critic_updates_per_iter=w["critic_updates"] / it,
                           actor_updates_per_iter=w["actor_updates"] / it,
                           ms_per_iter=1e3 * w["seconds"] / it,
                           all_env_steps_per_s=w["env_steps"] * table["num_envs"] / w["seconds"], launches=n))
    os.remove(out_file)
    return dict(config=" ".join(SWEEP_ARGV) + f" algo=pql sweep={SWEEP_POINTS} seconds_per_point={SWEEP_SECONDS}",
                card=smi, points=points, launches={k: sum(n[k] for n in launches) for k in launches[0]})


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pql_tpu_torch.ops import kernels

    from pql_tpu_torch.algos.base import set_precision
    from pql_tpu_torch.cfg import make_config

    set_precision(make_config("pql"))  # fp32 without TF32, deterministic cuDNN, as train.main sets them
    dev = "cuda:0"
    smi = nvidia_smi_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    emit(dict(phase="device", kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda))
    if argv == ["--entry"]:
        from pql_tpu_torch.algos import get_algo
        from pql_tpu_torch.cfg import parse_cli

        for run_argv, iters in ENTRY_RUNS:
            warms = hasattr(get_algo(parse_cli(list(run_argv)).algo.name), "warmup")
            r, s = timed(baseline_entry_path if warms else ppo_entry_path, dev, smi, run_argv, iters)
            emit(dict(phase="entry_run", wall_s=s, **r))
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
        return 0
    if argv == ["--hand"]:
        hand, s = timed(hand_kernel_check, dev, smi)
        emit(dict(phase="hand_physics_check", card=smi, wall_s=s, tasks=hand))
        hand_depth = (HAND_WARM_ITERS, HAND_BLOCKS, HAND_BLOCK_ITERS, HAND_PROFILED_ITERS)
        for phase, run_argv in (("allegro_main_path", ["algo=pql", "task=AllegroHand", "num_envs=8192"]),
                                ("allegro_pqld_main_path", ["algo=pql_d", "task=AllegroHand", "num_envs=16384",
                                                            "algo.memory_size=2000000"])):
            r, s = timed(rigid_main_path, dev, smi, run_argv, *hand_depth)
            emit(dict(phase=phase, wall_s=s, **r))
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
        return 0
    if argv == ["--clip-adamw"]:
        t0 = time.perf_counter()
        built = kernels.build_source(kernels.CSRC / "clip_adamw.cu")
        emit(dict(phase="build", seconds=time.perf_counter() - t0, sources={"clip_adamw": built}))
        tail, s = timed(check_clip_adamw, dev)
        emit(dict(phase="kernel_check", card=smi, wall_s=s, kernels=[tail]))
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
        return 0
    check(not argv, f"unknown arguments {argv} (none, --entry, --hand or --clip-adamw)")

    t0 = time.perf_counter()
    built = kernels.build_kernels()
    emit(dict(phase="build", seconds=time.perf_counter() - t0, sources=built))

    c51, s = timed(check_c51, dev)
    tail, s_tail = timed(check_clip_adamw, dev)
    checks = [c51, tail]
    s += s_tail
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
    hand, s = timed(hand_kernel_check, dev, smi)
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
    pref, s = timed(ppo_reference, dev)
    emit(dict(phase="ppo_reference", wall_s=s, **pref))
    pmain, s = timed(ppo_main_path, dev, smi)
    emit(dict(phase="ppo_main_path", wall_s=s, **pmain))
    franka, s = timed(physics_check, dev, ("FrankaCubeStack",), FRANKA_ENVS, FRANKA_MAX_FLIPS)
    emit(dict(phase="franka_physics_check", card=smi, wall_s=s, tasks=franka))
    pairs, s = timed(two_agent_main_path, dev, smi)
    emit(dict(phase="two_agent_main_path", wall_s=s, **pairs))
    pentry, s = timed(ppo_entry_path, dev, smi)
    emit(dict(phase="ppo_entry_path", wall_s=s, **pentry))
    igate, s = timed(ippo_learning_gate, dev)
    emit(dict(phase="ippo_learning_gate", card=smi, wall_s=s, **igate))
    tref, s = timed(two_agent_reference, dev)
    emit(dict(phase="two_agent_reference", wall_s=s, **tref))
    imain, s = timed(iddpg_main_path, dev, smi)
    emit(dict(phase="iddpg_main_path", wall_s=s, **imain))
    tmain, s = timed(team_main_path, dev, smi)
    emit(dict(phase="team_main_path", wall_s=s, **tmain))
    ientry, s = timed(baseline_entry_path, dev, smi, IDDPG_ENTRY_ARGV, IDDPG_ENTRY_ITERS)
    emit(dict(phase="iddpg_entry_path", wall_s=s, **ientry))
    eref, s = timed(eq_reference, dev)
    emit(dict(phase="eq_reference", card=smi, wall_s=s, **eref))
    emain, s = timed(eq_main_path, dev, smi)
    emit(dict(phase="eq_main_path", wall_s=s, **emain))
    eentry, s = timed(ppo_entry_path, dev, smi, EQ_ENTRY_ARGV, EQ_ENTRY_ITERS)
    emit(dict(phase="eq_entry_path", wall_s=s, **eentry))
    dref, s = timed(eqsd_reference, dev, smi)
    emit(dict(phase="eqsd_reference", wall_s=s, **dref))
    dmain, s = timed(eqsd_main_path, dev, smi)
    emit(dict(phase="eqsd_main_path", wall_s=s, **dmain))
    dentry, s = timed(ppo_entry_path, dev, smi, EQSD_ENTRY_ARGV, EQSD_ENTRY_ITERS)
    emit(dict(phase="eqsd_entry_path", wall_s=s, **dentry))
    vref, s = timed(vision_reference, dev, smi)
    emit(dict(phase="vision_reference", wall_s=s, **vref))
    vmain, s = timed(vision_main_path, dev, smi)
    emit(dict(phase="vision_main_path", wall_s=s, **vmain))
    ventry, s = timed(ppo_entry_path, dev, smi, VISION_ENTRY_ARGV, VISION_ENTRY_ITERS, VISION_ENTRY_FREQ)
    emit(dict(phase="vision_entry_path", wall_s=s, **ventry))
    gref, s = timed(ddpgv_reference, dev, smi)
    emit(dict(phase="ddpgv_reference", wall_s=s, **gref))
    torch.cuda.empty_cache()
    gmain, s = timed(ddpgv_main_path, dev, smi)
    emit(dict(phase="ddpgv_main_path", wall_s=s, **gmain))
    torch.cuda.empty_cache()
    gentry, s = timed(ddpgv_entry_path, dev, smi)
    emit(dict(phase="ddpgv_entry_path", wall_s=s, **gentry))
    one_rank, s = timed(dist_one_rank, dev, smi)
    emit(dict(phase="dist_one_rank", wall_s=s, **one_rank))
    legacy, s = timed(legacy_contact_check, dev, smi)
    emit(dict(phase="legacy_contact_check", wall_s=s, **legacy))
    lab, s = timed(contact_lab_phase, dev, smi)
    emit(dict(phase="contact_lab", wall_s=s, **lab))
    vis, s = timed(visualize_path, dev, smi)
    emit(dict(phase="visualize_path", wall_s=s, **vis))
    sweep, s = timed(ratio_sweep_phase, dev, smi)
    emit(dict(phase="ratio_sweep", wall_s=s, **sweep))

    by_path = {"pql_d Cartpole@4096": main["launches"], "pql_d AllegroHand@16384": allegro_d["launches"],
               "pql_d Cartpole@4096 entry point": entry["launches"],
               "pql_d Cartpole@4096 resume check": resume["launches"],
               "pql_d Cartpole@256 learning run": gate["launches"],
               **{f"{name} (baseline)": r["launches"] for name, r in bmain["runs"].items()},
               "algo=ddpg Cartpole@16 entry point": bentry["launches"],
               "ddpg Cartpole@64 learning runs": bgate["launches"],
               **{f"{name} (on-policy)": r["launches"] for name, r in {**pmain["runs"], **pairs["runs"]}.items()},
               "algo=ppo Cartpole@4096 entry point": pentry["launches"],
               "ippo BimanualReacher@1024 learning run": igate["launches"],
               "two-agent card-vs-CPU reference runs": tref["launches"],
               "algo=iddpg BimanualReacher@4096": imain["launches"],
               **{f"{name} (team)": r["launches"] for name, r in tmain["runs"].items()},
               "algo=iddpg BimanualReacher@4096 entry point": ientry["launches"],
               "equivariant card-vs-CPU reference runs": eref["launches"],
               **{f"{name} (equivariant)": r["launches"] for name, r in emain["runs"].items()},
               "algo=eqs4 BimanualReacher@4096 entry point": eentry["launches"],
               "diffusion-tier card-vs-CPU reference runs": dref["launches"],
               **{f"{name} (diffusion tier)": r["launches"] for name, r in dmain["runs"].items()},
               "algo=eqsd algo.diffusion=true BimanualReacher@4096 entry point": dentry["launches"],
               "vision card-vs-CPU reference runs": vref["launches"],
               **{f"{name} (vision tier)": r["launches"] for name, r in vmain["runs"].items()},
               "algo=ppov ReacherVision@4096 entry point": ventry["launches"],
               "ddpgv card-vs-CPU reference runs": gref["launches"],
               "algo=ddpgv ReacherVision@4096": gmain["launches"],
               "algo=ddpgv ReacherVision@4096 entry point": gentry["launches"],
               "pql_d Cartpole@4096 one-rank NCCL group": one_rank["launches"],
               "pql_d Cartpole@4096 train.main writing the visualized model": vis["train_main_launches"],
               "visualize of the pql_d Cartpole model": vis["launches"],
               "pql AllegroHand@8192 ratio sweep": sweep["launches"]}
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
    sys.exit(main(sys.argv[1:]))
