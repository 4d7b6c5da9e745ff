#!/usr/bin/env python3
"""Read one profiled training iteration two ways and compare them.

    python3 tools/profile_read.py [algo=ppo task=Ant task_param=true] ...

Builds the agent of the given config on the card, runs one iteration, then
profiles a second one. Its device work (kernels, copies and sets; user
annotations aside) is summed twice: over the raw Kineto events
(``chip_smoke.device_records``) and over the device rows of
``key_averages``. Prints one JSON line with both (records, µs, read seconds)
and the seconds the profiler took to stop; on a graphed task the same for
one replay of the control step's graph, beside its kernel nodes. Exits 1 if
the two reads disagree. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_ARGV = ("algo=ppo", "task=Ant", "task_param=true")


def key_average_records(prof) -> tuple[int, float]:
    """(records, µs) of the device rows of ``key_averages``."""
    from torch.autograd import DeviceType

    import chip_smoke

    rows = [r for r in prof.key_averages() if r.device_type == DeviceType.CUDA
            and not getattr(r, "is_user_annotation", False)]
    return sum(r.count for r in rows), sum(chip_smoke._self_device_us(r) for r in rows)


def both_reads(prof) -> dict:
    import chip_smoke

    t0 = time.perf_counter()
    raw = chip_smoke.device_records(prof)
    t1 = time.perf_counter()
    averaged = key_average_records(prof)
    t2 = time.perf_counter()
    return dict(raw=dict(records=raw[0], us=raw[1], read_s=t1 - t0),
                key_averages=dict(records=averaged[0], us=averaged[1], read_s=t2 - t1),
                agree=raw[0] == averaged[0] and abs(raw[1] - averaged[1]) <= 1e-6 * max(averaged[1], 1.0))


def main(argv: list[str]) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from pql_tpu_torch.algos import get_algo
    from pql_tpu_torch.algos.base import set_precision
    from pql_tpu_torch.cfg import parse_cli
    from pql_tpu_torch.ops.graphs import graph_kernel_nodes

    if not torch.cuda.is_available():
        print("profile_read: no CUDA device", file=sys.stderr)
        return 1
    argv = argv or list(DEFAULT_ARGV)
    cfg = parse_cli(list(argv))
    set_precision(cfg)
    dev = "cuda:0"
    agent = get_algo(cfg.algo.name)(cfg, device=dev)
    state = agent.init()
    state, _ = agent.train_iter(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = agent.train_iter(state)
        torch.cuda.synchronize()
    out = dict(config=" ".join(argv), card=chip_smoke.nvidia_smi_line(), torch=torch.__version__,
               profiled_s=time.perf_counter() - t0, window=both_reads(prof))
    graphs = getattr(agent.env.task, "_graphs", None)
    if graphs:
        graph = graphs[(cfg.num_envs, torch.device(dev))]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as gprof:
            graph.graph.replay()
            torch.cuda.synchronize()
        out.update(graph_kernel_nodes=graph_kernel_nodes(graph.graph)[0], replay=both_reads(gprof))
    print(json.dumps(out), flush=True)
    return 0 if out["window"]["agree"] and out.get("replay", {}).get("agree", True) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
