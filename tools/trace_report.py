#!/usr/bin/env python3
"""The program's spans in a benchmark cell: device idle by layer, closure and cost.

    python3 tools/trace_report.py --workload allegro-pql-8k-r8 --seed 7
    python3 tools/trace_report.py --workload allegro-pql-8k-r8 --seed 7 --timed off
    python3 tools/trace_report.py --microbench

Runs the cell as a ``--trace 1`` run of ``benchmark/run.py`` does (set-up,
an untraced stretch of at least 6 s and 4 iterations, three profiled
iterations), then reads the tracer's records (``pql_tpu_torch/utils/trace.py``)
of the four unprofiled iterations before the last unprofiled one ahead of
the profiled window (that last one ends in the harness's synchronize and
the profiler's start). Prints one JSON line:

- ``idle_ms``: each layer's device idle ms per iteration: the median of its
  top-level spans' device-clock ms, less its device busy ms per profiled
  iteration (``tracing.Summary.device_s_by_layer``; a layer with no device
  record is busy 0 ms); ``iteration`` takes the period less the layers'
  spans. Unclamped: a negative value says the profiled and the unprofiled
  iterations disagree. In a layer that replays a CUDA graph it also holds
  the device's own gaps between the graph's kernels, which the profile's
  busy time leaves out (compare ``graph_replay_ms`` below);
- ``closure``: the idle sum against ``device.idle_share`` × the untraced ms
  per iteration (within max(3 ms, 10%)), and the device-clock period
  against the untraced ms per iteration (within 5%), and whether each
  iteration's top-level spans tile its period in order;
- ``graph_kernels_per_iter`` against libcuda's count of the graph's kernel
  nodes, on a graphed task; the learner's graphs on PQL on the card:
  ``learner_graph_kernels_per_iter`` (kernel nodes replayed an iteration,
  ``learner.graph_kernels``) against each graph's count, and each graph's
  capture seconds (``setup.learner_capture``), and ``clip_adamw_steps_per_iter``, the launches of
  the clip and AdamW kernel pair (``learner.clip_adamw_steps``, two an update, counted through
  the replays); ``fused_steps_per_iter``, the launches of the
  hand's fused step kernel (``env.fused_steps``), on the hand; ``hostring_host_ms`` (host ms of
  ``replay.ring_add`` and ``replay.gather``) on DDPGV;
- the host self ms of every span and the counters of the read iterations;
- what checks the busy time: the profile's device records per iteration
  (the graph's kernel nodes, the learner's launches and the rest: none
  lost), and the graphed step replayed alone by CUDA events, each replay
  after an idle card and several back to back (the card's clock ramps up
  from idle).

``--timed on|off`` instead runs the cell as a ``--trace 0`` run does (a
``--seconds`` window), with the tracer on or off (``trace.enable(False)``),
and prints the benchmark's result line: runs alternating between the two
measure the tracer's cost end to end. ``--microbench`` prints the tracer's
host µs on an idle stream: an iteration's start, one top-level span with its
two events, one nested span, and an iteration of PQL's span shape with
empty bodies, on and off. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)

LAYERS = ("env", "replay", "learner", "iteration")
WINDOW_ITERS = 4
HOSTRING_SPANS = ("replay.ring_add", "replay.gather")
# one PQL iteration at horizon 1 on a graphed task, its learner phases replayed: (top-level span, its nested spans)
LEARNER_REPLAY = ("learner.graph_in", "learner.graph_replay")
PQL_SHAPE = (("env.sim", ("env.actor", "env.graph_in", "env.graph_replay", "env.graph_out", "env.track",
                          "env.track")),
             ("replay.nstep", ()), ("replay.add", ()), ("learner.critic", LEARNER_REPLAY),
             ("learner.actor", LEARNER_REPLAY))


def window(records: list) -> list:
    """The four unprofiled iterations before the last unprofiled one ahead
    of the first profiled iteration (all of them without a profiled one)."""
    ahead = []
    for r in records:
        if r.iteration < 0:
            continue
        if r.profiled:
            break
        ahead.append(r)
    return ahead[:-1][-WINDOW_ITERS:]


def busy_ms(summary, layer: str) -> float:
    return summary.device_s_by_layer.get(layer, 0.0) * 1e3 / summary.iters


def idle_ms(rows: list, summary) -> dict | None:
    """Each layer's device idle ms per iteration; None where a record has no device clock."""
    dev = [r.device_ms() for r in rows]
    if not dev or any(d is None for d in dev):
        return None
    return {L: statistics.median(d.get(L, 0.0) for d in dev) - busy_ms(summary, L) for L in LAYERS}


def period_ms(rows: list) -> float | None:
    periods = [r.period_ms for r in rows]
    return None if not periods or None in periods else statistics.median(periods)


def counter_per_iter(rows: list, counter: str) -> float | None:
    counts = [r.counters.get(counter) for r in rows]
    return None if not counts or None in counts else statistics.median(counts)


def hostring_host_ms(rows: list) -> float | None:
    if not rows:
        return None
    host = [r.host_ms() for r in rows]
    if not all(any(s in h for s in HOSTRING_SPANS) for h in host):
        return None
    return statistics.median(sum(h.get(s, 0.0) for s in HOSTRING_SPANS) for h in host)


def tiles(record) -> bool:
    """The record's top-level device segments lie in order inside its period."""
    at = 0.0
    for s in record.spans:
        if s.parent < 0 and s.dev is not None:
            if s.dev[0] < at or s.dev[1] < s.dev[0]:
                return False
            at = s.dev[1]
    return record.period_ms is not None and at <= record.period_ms


def closure(idle: dict, period: float, idle_share: float, untraced_ms: float) -> dict:
    want = idle_share / 100.0 * untraced_ms
    total = sum(idle.values())
    return dict(idle_sum_ms=total, idle_share_ms=want, idle_held=abs(total - want) <= max(3.0, 0.1 * abs(want)),
                period_ms=period, untraced_ms=untraced_ms, period_held=abs(period - untraced_ms) <= 0.05 * untraced_ms)


def device_records_per_iter(prof, iters: int) -> float:
    """Kernel, copy and set records in the profile per profiled iteration."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()) / iters


def graph_replay_ms(graph, reps: int = 5) -> dict:
    """Device ms of the captured step replayed alone by CUDA events: each
    replay after an idle card, and ``reps`` replays back to back."""
    import torch

    def timed(n: int) -> float:
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    return dict(alone=[timed(1) for _ in range(reps)], back_to_back=timed(reps))


def measure(cell_name: str, seed: int) -> dict:
    """One traced run of the cell; returns its line."""
    import harness
    import tracing

    from pql_tpu_torch.ops.graphs import graph_kernel_nodes
    from pql_tpu_torch.utils import trace

    trace.reset()
    bench = harness.load_benchmark(ROOT)
    cell = harness.find_cell(bench, cell_name)
    traffic = harness.load_json("traffic", cell["traffic"])
    setup = harness.set_up(cell["config"], traffic, seed, "cuda")
    agent, state = setup["agent"], setup["state"]
    print(f"untraced from {time.time()!r}", file=sys.stderr)
    state, n, wall = harness.timed_window(agent, state, harness.UNTRACED_MIN_S, "cuda", harness.UNTRACED_MIN_ITERS)
    print(f"traced from {time.time()!r}", file=sys.stderr)
    state, prof, ranges = harness.traced_window(agent, state, setup["adapter"], harness.TRACE_ITERS)
    print(f"traced to {time.time()!r}", file=sys.stderr)
    summary = tracing.summarize(prof, harness.TRACE_ITERS, ranges)
    records_per_iter = device_records_per_iter(prof, harness.TRACE_ITERS)
    del prof
    summary.untraced_s_per_iter = wall / n
    idle_share = harness.load_module("metrics", "device.idle_share").read(summary)
    records = trace.recent(sync=True)
    rows = window(records)
    idle, period = idle_ms(rows, summary), period_ms(rows)
    untraced_ms = 1e3 * wall / n
    line = dict(cell=cell_name, seed=seed, card=harness.device_info("cuda", 1)["kind"],
                power_limit_w=harness.power_limit_w(), untraced_iters=n, untraced_ms=untraced_ms,
                iterations_read=[r.iteration for r in rows], idle_ms=idle, idle_share=idle_share,
                busy_ms={L: busy_ms(summary, L) for L in LAYERS},
                device_ms=[r.device_ms() for r in rows], tiled=[tiles(r) for r in rows],
                learner_launches_per_iter=summary.launches_by_layer.get("learner", 0) / summary.iters,
                host_ms={k: statistics.median(r.host_ms().get(k, 0.0) for r in rows)
                         for k in sorted({k for r in rows for k in r.host_ms()})},
                counters={k: statistics.median(r.counters.get(k, 0) for r in rows)
                          for k in sorted({k for r in rows for k in r.counters})},
                profiled_iterations=[r.iteration for r in records if r.profiled],
                device_records_per_profiled_iter=records_per_iter)
    if idle is not None and period is not None and idle_share is not None:
        line["closure"] = closure(idle, period, idle_share, untraced_ms)
    graphs = list(getattr(agent.env.task, "_graphs", {}).values())
    if graphs:
        line.update(graph_kernels_per_iter=counter_per_iter(rows, "env.graph_kernels"),
                    graph_kernel_nodes=[graph_kernel_nodes(g.graph)[0] for g in graphs],
                    graph_replay_ms=graph_replay_ms(graphs[0].graph))
    learner = getattr(agent, "_graphs", None)  # PQL's phase graphs
    phases = {} if learner is None else {"/".join(map(str, k)): g for k, g in learner.graphs.items() if g is not None}
    if phases:
        line.update(learner_graph_kernels_per_iter=counter_per_iter(rows, "learner.graph_kernels"),
                    clip_adamw_steps_per_iter=counter_per_iter(rows, "learner.clip_adamw_steps"),
                    learner_graph_kernel_nodes={k: g.kernels for k, g in phases.items()},
                    learner_capture_s={k: g.build_s["capture"] for k, g in phases.items()})
    fused = counter_per_iter(rows, "env.fused_steps")
    if fused is not None:
        line["fused_steps_per_iter"] = fused
    hostring = hostring_host_ms(rows)
    if hostring is not None:
        line["hostring_host_ms"] = hostring
    return line


def microbench(iters: int = 2000, rounds: int = 5) -> dict:
    """Host µs of the tracer's pieces on the card with an idle stream:
    medians over ``rounds`` interleaved rounds of ``iters`` iterations."""
    import torch

    from pql_tpu_torch.utils import trace

    def round_us(body, on: bool = True) -> float:
        trace.enable(on)
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(iters):
            trace.iteration("cuda")
            body()
        us = (time.perf_counter_ns() - t0) / iters / 1e3
        trace.enable(True)
        trace.recent(sync=True)
        return us

    def top():
        with trace.span("bench.top"):
            pass

    def nested():
        with trace.span("bench.top"):
            with trace.span("bench.nested"):
                pass

    def pql_shape():
        for name, inner in PQL_SHAPE:
            with trace.span(name):
                for sub in inner:
                    with trace.span(sub):
                        pass
                if inner:
                    layer = name.split(".", 1)[0]
                    trace.count(f"{layer}.graph_replays")
                    trace.count(f"{layer}.graph_kernels", 1)

    kinds = dict(base=(lambda: None, True), top=(top, True), nested=(nested, True), pql=(pql_shape, True),
                 pql_off=(pql_shape, False))
    round_us(pql_shape)  # fills the event pool
    got = {k: [] for k in kinds}
    for _ in range(rounds):
        for k, (body, on) in kinds.items():
            got[k].append(round_us(body, on))
    med = {k: statistics.median(v) for k, v in got.items()}
    return dict(card=torch.cuda.get_device_name(0), iteration_us=med["base"],
                top_span_with_events_us=med["top"] - med["base"], nested_span_us=med["nested"] - med["top"],
                pql_iteration_us=med["pql"], pql_iteration_off_us=med["pql_off"],
                light_tier_us=med["pql"] - med["pql_off"], rounds=got)


def timed(cell_name: str, seed: int, seconds: float, on: bool) -> dict:
    """The benchmark's timed run of the cell with the tracer on or off."""
    import harness

    from pql_tpu_torch.utils import trace

    trace.enable(on)
    bench = harness.load_benchmark(ROOT)
    result = harness.run_cell(bench, harness.find_cell(bench, cell_name), seed, seconds, False, time.perf_counter())
    return dict(result, tracer="on" if on else "off")


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--timed", choices=("on", "off"), help="a timed run with the tracer on or off")
    p.add_argument("--seconds", type=float, default=30.0, help="the --timed window")
    p.add_argument("--microbench", action="store_true")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    if args.microbench:
        line = microbench()
    elif args.workload is None or args.seed is None:
        p.error("--workload and --seed name the cell's run")
    elif args.timed:
        line = timed(args.workload, args.seed, args.seconds, args.timed == "on")
    else:
        line = measure(args.workload, args.seed)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
