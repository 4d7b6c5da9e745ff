#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of
the checkout. The run builds the cell's agent through the port's normal path,
drives it through its first training iterations (which the plain reference
follows afterwards), times ``--seconds`` of ``train_iter`` (``--trace 0``) or
profiles a short window of it (``--trace 1``), checks what the first
iterations produced against the plain reference, and prints one JSON line.
It needs as many CUDA cards as the cell asks for, and exits 1 without a
result line otherwise.
"""

from __future__ import annotations

import time

START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# Every build and kernel cache of the program lives at a fixed path inside
# the checkout, so only a cell's first run in a checkout builds anything.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)

for path in (ROOT, HERE):
    if path not in sys.path:
        sys.path.insert(0, path)

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pql_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names among the loaded modules that the port's runs must not
    load (the JAX stack and the JAX package), compared whole: ``pql_tpu_torch``
    is not ``pql_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & set(FORBIDDEN_MODULES))


def parse_args(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: list[str]) -> int:
    args = parse_args(argv)
    import harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell {args.workload} needs {cell['chips']} CUDA card(s); found {found}", file=sys.stderr)
        return 1
    result = harness.run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), START, device="cuda")
    found = forbidden_loaded()
    if found:
        print(f"the run loaded modules it must not: {found}", file=sys.stderr)
        return 1
    harness.print_checks(result["checks"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
