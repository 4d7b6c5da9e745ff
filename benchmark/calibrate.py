#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python benchmark/calibrate.py --workload <name> --seeds 1 2 3 [--control] [--faults]

For each seed, in one process: the cell's set-up at its own size (the
agent built, weighted, warmed up and driven through the followed
iterations), then the numbers compared for

- the program (the lower readings);
- with ``--control``, the reference put in the program's place in TF32
  (the control: the precision below the configuration's fp32);
- with ``--faults``, the reference put in the program's place with each
  fault of the configuration's reference planted (its ``FAULTS``).

Prints one JSON line per seed and a last line with the largest program
reading and the smallest control and fault readings of each number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for path in (ROOT, HERE):
    if path not in sys.path:
        sys.path.insert(0, path)


def readings_for_seed(cell: dict, seed: int, device: str, control: bool, faults: bool,
                      config: dict | None = None, traffic: dict | None = None) -> dict:
    import harness

    traffic = harness.load_json("traffic", cell["traffic"]) if traffic is None else traffic
    setup = harness.set_up(cell["config"], traffic, seed, device, config)
    del setup["agent"], setup["state"]
    harness.free()
    adapter, args = setup["adapter"], (setup["record"], setup["weights"], setup["config"], setup["traffic"], device)
    details = {}
    out = {"seed": seed, "program": adapter.readings(*args, details=details), "details": details}
    if control:
        out["control"] = adapter.readings(*args, control=True)
    if faults:
        out["faults"] = {f: adapter.readings(*args, fault=f) for f in adapter.FAULTS}
    return out


def summary(lines: list[dict]) -> dict:
    names = lines[0]["program"].keys()
    s = {"program_max": {k: max(line["program"][k] for line in lines) for k in names}}
    if "control" in lines[0]:
        s["control_min"] = {k: min(line["control"][k] for line in lines) for k in names}
    if "faults" in lines[0]:
        s["faults_min"] = {f: {k: min(line["faults"][f][k] for line in lines) for k in names}
                           for f in lines[0]["faults"]}
    return s


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import harness

    cell = harness.find_cell(harness.load_benchmark(ROOT), args.workload)
    lines = []
    for seed in args.seeds:
        line = readings_for_seed(cell, seed, args.device, args.control, args.faults)
        lines.append(line)
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, **summary(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
