"""A whole run of each cell at a tiny size on the CPU, past the look for a
card: the result line's keys, ``correct`` true for the port as it is, and
``correct`` false with the timed path broken underneath it in each way a
training cell can be broken (one chip: no exchange between chips)."""

import math
import time

import numpy as np
import pytest
import torch

import harness

from conftest import ROOT

TINY = {"algo.batch_size": 16, "algo.memory_size": 64, "algo.warm_up": 4}


def tiny_run(workload: str, seed: int = 11):
    torch.set_num_threads(2)
    bench = harness.load_benchmark(ROOT)
    cell = harness.find_cell(bench, workload)
    config = harness.load_json("configs", cell["config"])
    config["args"].update({k: v for k, v in TINY.items() if k in config["args"]})
    traffic = harness.load_json("traffic", cell["traffic"])
    traffic["args"]["num_envs"] = 8
    return harness.run_cell(bench, cell, seed, 0.2, False, time.perf_counter(), "cpu", config, traffic)


CELLS = ["allegro-pql-8k-r8", "reacher-ddpgv-4k-u4"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct_and_prints_the_contract_keys(workload):
    r = tiny_run(workload, seed=2**31 + 5)
    assert r["correct"], r["checks"]
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert r["attempted"] >= 1 and all(math.isfinite(m["value"]) for m in r["metrics"].values())
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


def no_step(self, closure=None):
    """An optimizer step that leaves every parameter as it was."""
    return None


def first_half_twice(x: torch.Tensor) -> torch.Tensor:
    """A batch whose second half repeats its first: every mean over it is
    the mean over the first half alone."""
    h = x.shape[0] // 2
    return torch.cat([x[:h], x[:h]]) if x.shape[0] % 2 == 0 else x


def half_rows(rows):
    def half(self, index):
        out = rows(self, index)
        return first_half_twice(out) if out.dim() == 2 else out
    return half


def altered_reward(step):
    def altered(self, *a, **k):
        s, obs, reward, done, info = step(self, *a, **k)
        return s, obs, reward * 1.1, done, info
    return altered


def half_host_batch(fetch):
    def half(self, u):
        return {k: first_half_twice(v) for k, v in fetch(self, u).items()}
    return half


def plant(monkeypatch, fault: str, workload: str):
    from pql_tpu_torch.algos.ddpgv import DDPGV
    from pql_tpu_torch.envs.base import VecEnv
    from pql_tpu_torch.replay.buffer import ReplayBuffer

    if fault == "unchanged_state":
        monkeypatch.setattr(torch.optim.AdamW, "step", no_step)
    elif fault == "half_batch" and workload.startswith("allegro"):
        monkeypatch.setattr(ReplayBuffer, "rows", half_rows(ReplayBuffer.rows))
    elif fault == "half_batch":
        monkeypatch.setattr(DDPGV, "fetch_batch", half_host_batch(DDPGV.fetch_batch))
    elif fault == "altered_answer":
        monkeypatch.setattr(VecEnv, "step", altered_reward(VecEnv.step))


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_answer"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    plant(monkeypatch, fault, workload)
    r = tiny_run(workload)
    assert not r["correct"], r["checks"]


def test_the_half_batch_fault_means_over_the_first_half():
    class R:
        def rows(self, index):
            return torch.arange(8 * 3.0).view(8, 3)
    out = half_rows(R.rows)(R(), None)
    np.testing.assert_array_equal(out.mean(0).numpy(), R().rows(None)[:4].mean(0).numpy())


def no_contact_forces(contact_fn):
    def make(self, c):
        fn = contact_fn(self, c)

        def dropped(m, R_wb, p_wb, v, cs):
            f_ext, cs_new = fn(m, R_wb, p_wb, v, cs)
            return [[x * 0.0 for x in body] for body in f_ext], cs_new
        return dropped
    return make


@pytest.mark.parametrize("fault", ["contacts_dropped", "substep_missing"])
def test_broken_hand_physics_is_not_correct(monkeypatch, fault):
    from pql_tpu_torch.envs.hand import AllegroHand

    if fault == "contacts_dropped":
        monkeypatch.setattr(AllegroHand, "_contact_fn", no_contact_forces(AllegroHand._contact_fn))
    else:
        monkeypatch.setattr(AllegroHand, "substeps", AllegroHand.substeps - 1)
    r = tiny_run("allegro-pql-8k-r8")
    assert not r["correct"], r["checks"]
    assert r["checks"]["physics_gap"]["value"] > r["checks"]["physics_gap"]["limit"], r["checks"]
