"""The port's runs load no JAX and not the JAX package: top-level module
names compared whole (``pql_tpu_torch`` begins with ``pql_tpu``)."""

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

import run  # noqa: E402  (benchmark/run.py)


@pytest.mark.parametrize("modules, found", [
    ({"pql_tpu_torch", "pql_tpu_torch.algos.pql", "torch"}, []),
    ({"pql_tpu.algos", "pql_tpu_torch"}, ["pql_tpu"]),
    ({"jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "jaxtyping"}, ["flax", "jax", "jaxlib"]),
    ({"pql_tpu_bench", "jax_like"}, []),
])
def test_forbidden_names_compare_whole_top_level_names(modules, found):
    assert run.forbidden_loaded(modules) == found


TINY_RUN = r"""
import json, sys, time
sys.path[:0] = [{root!r}, {bench!r}]
import torch
torch.set_num_threads(2)
import harness, run
bench = harness.load_benchmark({root!r})
loaded = set()
for cell in bench["workloads"]:
    config = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    small = {{"algo.batch_size": 16, "algo.memory_size": 64, "algo.warm_up": 4}}
    config["args"].update({{k: v for k, v in small.items() if k in config["args"]}})
    traffic["args"]["num_envs"] = 8
    harness.run_cell(bench, cell, 7, 0.2, False, time.perf_counter(), "cpu", config, traffic)
    for m in bench["per_layer"]:
        harness.load_module("metrics", m["name"])
    harness.load_module("flops", cell["config"])
print(json.dumps(sorted(sys.modules)))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Every module a run of each cell loads (CPU, tiny sizes): the flow, the
    adapters and references, the metric readers, the FLOP counts, the port."""
    code = TINY_RUN.format(root=ROOT, bench=BENCH)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    modules = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "pql_tpu_torch" in modules and "torch" in modules
    assert run.forbidden_loaded(modules) == []
