"""The benchmark's general flow, the same for every cell.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration and a
traffic mix. Everything that belongs to one of them is found by its name:

- ``configs/<config>.json``: the agent (``algo``, ``task``), the arguments
  that pin every hyperparameter the run uses (``args``, handed to the port's
  ``parse_cli``), the constants the plain reference needs, and the limit of
  each number that decides ``correct`` (``limits``);
- ``traffic/<traffic>.json``: the load (env count, update ratios) as more
  ``args``;
- ``reference/<config>.py``: the adapter between this flow and the agent
  (which networks the benchmark fills, what it records of the first
  iterations, which methods the traced run wraps in ranges) and the plain
  reference that follows those iterations;
- ``flops/<config>.py``: the model FLOPs of one iteration;
- ``metrics/<metric>.py``: one per-layer metric, read from the traced window.

A run: build the agent with ``parse_cli``, ``get_algo``, ``init`` (then the
networks get the benchmark's own weights and the envs the benchmark's own
first episodes, drawn on the card from the seed), ``warmup``, and
``CHECK_ITERS`` calls of ``train_iter`` that the reference follows later;
then the window, then the check.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

CHECK_ITERS = 3  # training iterations the plain reference follows
TRACE_ITERS = 3  # iterations of a traced window
UNTRACED_MIN_S, UNTRACED_MIN_ITERS = 6.0, 4  # the traced run's untraced stretch lasts both
PEAK_FP32_FLOPS = 67e12  # one H100 SXM, fp32 outside the tensor cores (NVIDIA's data sheet)
HERE = os.path.dirname(os.path.abspath(__file__))


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have {[c['name'] for c in bench['workloads']]}")


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark, by path (names may hold '-' and '.')."""
    path = os.path.join(HERE, kind, f"{name}.py")
    mod_name = f"bench_{kind}_" + "".join(ch if ch.isalnum() else "_" for ch in name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def cli_value(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    return repr(v) if isinstance(v, float) else str(v)


def cell_argv(config: dict, traffic: dict, seed: int) -> list[str]:
    """The port's CLI arguments of a cell: the algorithm's preset first, then
    every pinned value of the configuration and the traffic."""
    argv = [f"algo={config['algo']}", f"task={config['task']}"]
    for args in (config["args"], traffic["args"]):
        argv += [f"{k}={cli_value(v)}" for k, v in args.items()]
    return argv + [f"seed={seed}"]


def build(config: dict, traffic: dict, seed: int, device: str):
    """(cfg, agent, state) through the port's normal path."""
    from pql_tpu_torch.algos import get_algo
    from pql_tpu_torch.algos.base import set_precision
    from pql_tpu_torch.cfg import parse_cli

    cfg = parse_cli(cell_argv(config, traffic, seed))
    set_precision(cfg)
    agent = get_algo(cfg.algo.name)(cfg, device)
    return cfg, agent, agent.init(seed)


def set_up(config_name: str, traffic: dict, seed: int, device: str, config: dict | None = None):
    """Build the cell's agent, give it the benchmark's weights, warm it up
    and run the iterations the reference follows, recording them. Returns a
    dict with everything later stages need. ``config`` replaces the
    configuration file's contents (the tests' small sizes)."""
    import weights

    config = load_json("configs", config_name) if config is None else config
    adapter = load_module("reference", config_name)
    marks = [("start", time.perf_counter())]
    cfg, agent, state = build(config, traffic, seed, device)
    marks.append(("build", time.perf_counter()))
    gen = weights.generator(seed, device)
    w = weights.fill(adapter.networks(state), gen)
    adapter.load_weights(state, w)
    start_draw = adapter.reset_envs(agent, state, gen, config)
    rec = adapter.Recorder(agent, state)
    rec.data["start_draw"] = start_draw.clone()
    try:
        state, _ = agent.warmup(state)
        synchronize(device)
        marks.append(("weights_episodes_warmup", time.perf_counter()))
        for i in range(CHECK_ITERS):
            state, metrics = agent.train_iter(state)
            rec.after_iter(i, state, metrics)
    finally:
        rec.close()
    marks.append(("followed_iterations", time.perf_counter()))
    print("set-up stages (s): " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])),
          file=sys.stderr)
    return dict(config=config, traffic=traffic, adapter=adapter, cfg=cfg, agent=agent, state=state,
                weights=w, record=rec.data)


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed_window(agent, state, seconds: float, device, min_iters: int = 1):
    """Whole ``train_iter`` calls until ``seconds`` have passed on the host
    clock and ``min_iters`` calls were made, then a synchronize: (state,
    iterations, wall seconds). Nothing else runs in the window."""
    n, t0 = 0, time.perf_counter()
    while n < min_iters or time.perf_counter() - t0 < seconds:
        state, _ = agent.train_iter(state)
        n += 1
    synchronize(device)
    return state, n, time.perf_counter() - t0


def traced_window(agent, state, adapter, iters: int):
    """One untraced iteration, then ``iters`` iterations under the profiler
    with the adapter's layer ranges around the agent's methods. Returns
    (state, the profile, the names of the ranges installed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    state, _ = agent.train_iter(state)
    torch.cuda.synchronize()
    names, undo = adapter.install_spans(agent, state, record_function)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("bench.window"):
                for _ in range(iters):
                    state, _ = agent.train_iter(state)
                torch.cuda.synchronize()
    finally:
        undo()
    return state, prof, names


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def check(setup: dict, device: str) -> tuple[bool, dict]:
    """The numbers compared and their limits; correct when every number is
    finite and within its limit."""
    numbers = setup["adapter"].check(setup["record"], setup["weights"], setup["config"], setup["traffic"], device)
    limits = setup["config"]["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def print_checks(checks: dict) -> None:
    for name, c in checks.items():
        verdict = "ok" if math.isfinite(c["value"]) and c["value"] <= c["limit"] else "OVER"
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)


def free() -> None:
    """Collect what the caller dropped of the program, and return the cached
    blocks it held."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def device_info(device, chips: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def memory_peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated()) if torch.device(device).type == "cuda" else 0


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, start: float, device: str = "cuda",
             config: dict | None = None, traffic: dict | None = None) -> dict:
    """One run of a cell; returns the result line as a dict. ``config`` and
    ``traffic`` replace the files' contents (the tests' small sizes)."""
    import tracing

    traffic = load_json("traffic", cell["traffic"]) if traffic is None else traffic
    setup = set_up(cell["config"], traffic, seed, device, config)
    agent, state = setup.pop("agent"), setup.pop("state")
    steps_per_iter = setup["adapter"].env_steps_per_iter(setup["cfg"])
    synchronize(device)
    setup_s = time.perf_counter() - start
    dev_info = device_info(device, int(cell["chips"]))
    breakdown = None
    if trace:
        # the profiler slows the host (a hand iteration: 2.5x), so the whole
        # step's rate and the device's idle share take an untraced stretch of
        # the same run, the per-layer device times the traced window
        state, n, wall = timed_window(agent, state, UNTRACED_MIN_S, device, UNTRACED_MIN_ITERS)
        iters = TRACE_ITERS
        state, prof, ranges = traced_window(agent, state, setup["adapter"], iters)
        summary = tracing.summarize(prof, iters, ranges)
        del prof
        summary.untraced_s_per_iter = wall / n
        summary.flops_per_iter = load_module("flops", cell["config"]).flops_per_iter(setup["config"], traffic)
        summary.peak_flops = PEAK_FP32_FLOPS
        metrics = read_per_layer(bench, cell, summary)
        dev_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        breakdown = summary.breakdown()
        attempted = n + iters
        print(f"set-up {setup_s!r} s; untraced: {n} iterations in {wall!r} s; traced: {iters} in "
              f"{summary.window_s!r} s, device busy {summary.busy_s!r} s, the profiler's buffer-flush stalls "
              f"{summary.flush_gap_s!r} s of its idle time; power limit {power_limit_w()} W (step.mfu against "
              f"{PEAK_FP32_FLOPS:.3g} FLOP/s fp32)", file=sys.stderr)
    else:
        state, n, wall = timed_window(agent, state, seconds, device)
        metrics = {"env_steps_per_s": {"value": n * steps_per_iter / wall, "unit": "env-steps/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        attempted = n
        print(f"window: {n} iterations in {wall!r} s; set-up {setup_s!r} s", file=sys.stderr)
    dev_info["memory_peak_bytes"] = memory_peak(device)
    dev_info["power_limit_w"] = power_limit_w()
    del agent, state
    free()
    correct, checks = check(setup, device)
    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def read_per_layer(bench: dict, cell: dict, summary) -> dict:
    """Each per-layer metric of the benchmark that lists this cell, read by
    ``metrics/<name>.py``. A reader that finds nothing to read returns None;
    for a metric that lists the cell, or lists none, that ends the run: the
    code it reads has left the path it was written for."""
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        value = load_module("metrics", m["name"]).read(summary)
        if value is None:
            raise RuntimeError(f"the per-layer metric {m['name']} found nothing to read in {cell['name']}")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
