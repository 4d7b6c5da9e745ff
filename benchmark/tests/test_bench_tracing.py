"""The trace's reduction refuses a window in which an installed range ran
too seldom, and a run refuses a listed per-layer metric that finds nothing
to read (CPU)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import harness
import tracing
from conftest import ROOT


def cpu_trace(calls: int):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            for _ in range(calls):
                with record_function("env.sim"):
                    torch.ones(8).sum()
    return prof


def test_every_installed_range_runs_once_an_iteration():
    s = tracing.summarize(cpu_trace(2), 2, ("env.sim",))
    assert s.host_s_by_range["env.sim"] > 0
    with pytest.raises(RuntimeError, match="learner.critic"):
        tracing.summarize(cpu_trace(2), 2, ("env.sim", "learner.critic"))
    with pytest.raises(RuntimeError, match="env.sim"):
        tracing.summarize(cpu_trace(1), 2, ("env.sim",))


def test_a_listed_metric_with_nothing_to_read_ends_the_run():
    bench = harness.load_benchmark(ROOT)
    cell = harness.find_cell(bench, "allegro-pql-8k-r8")
    with pytest.raises(RuntimeError, match="found nothing to read"):
        harness.read_per_layer(bench, cell, tracing.Summary(iters=3))
