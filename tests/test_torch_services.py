"""The entry point's services against the JAX package's, on the CPU.

- ``RatioController``: the port's copy and the JAX one give the same output
  on every trace: the cases of tests/test_utils.py:259-300 and a
  ``hypothesis`` sweep of return traces;
- ``_Every`` and ``_resumed_iter``: the cases of tests/test_train_loop.py:22-74;
- ``RunLogger``: the files and record keys the JAX logger writes, ``off``
  and the wandb fallback;
- ``train_pql``: a tiny PointMass run with ``iters_per_call=16`` and
  ``eval_freq=100`` evaluates exactly twice, at iterations 112 and 208
  (tests/test_train_loop.py:91-121), and logs a measured speed; with
  ``profile_dir`` it writes one profiler trace.
"""

import json
import os
import sys
import time

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pql_tpu.cfg import make_config as j_make_config  # noqa: E402
from pql_tpu.utils.logging import RunLogger as JRunLogger  # noqa: E402
from pql_tpu.utils.ratio_control import RatioController as JRatioController  # noqa: E402
from pql_tpu_torch.cfg import make_config, to_dict  # noqa: E402
from pql_tpu_torch.train import _Every, _resumed_iter, train_pql  # noqa: E402
from pql_tpu_torch.utils.logging import RunLogger  # noqa: E402
from pql_tpu_torch.utils.ratio_control import RatioController  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- ratio control


def _run_both(trace, **kw):
    """Outputs of the port's and the JAX controller on one trace, and their final ratios."""
    out = []
    for cls in (RatioController, JRatioController):
        ctl = cls(8, 2, window=4, **kw)
        out.append(([ctl.update(r) for r in trace], ctl.critic_sample_ratio))
    assert out[0] == out[1], trace
    return out[0]


def test_ratio_no_escalation_while_improving():
    outs, ratio = _run_both([0.0, 10.0, 20.0, 30.0, 40.0, 50.0, 60.0, 70.0])
    assert all(o is None for o in outs) and ratio == 8


def test_ratio_escalates_on_stall():
    outs, ratio = _run_both([0.0, 100.0] + [101.0] * 4)
    assert [o for o in outs if o] == [(16, 2)] and ratio == 16


def test_ratio_cap_respected():
    _, ratio = _run_both([0.0, 100.0] + [100.0] * 30, max_ratio=16)
    assert ratio == 16


def test_ratio_window_resets_after_escalation():
    outs, ratio = _run_both([0.0, 100.0] + [100.0] * 4 + [100.0] * 4)
    assert outs[5] == (16, 2) and outs[6:9] == [None] * 3 and outs[9] == (32, 2) and ratio == 32


@settings(max_examples=200, deadline=None)
@given(
    trace=st.lists(st.floats(-1e4, 1e4, allow_nan=False), min_size=0, max_size=60),
    window=st.integers(1, 8), factor=st.integers(2, 4), max_ratio=st.integers(8, 128),
    min_improvement=st.floats(0.0, 0.5),
)
def test_ratio_controller_matches_jax_on_any_trace(trace, window, factor, max_ratio, min_improvement):
    kw = dict(window=window, factor=factor, max_ratio=max_ratio, min_improvement=min_improvement)
    port, ref = RatioController(8, 2, **kw), JRatioController(8, 2, **kw)
    for r in trace:
        assert port.update(r) == ref.update(r)
    assert (port.critic_sample_ratio, port.critic_actor_ratio) == (ref.critic_sample_ratio, ref.critic_actor_ratio)


# ------------------------------------------------------------- loop gates


@pytest.mark.parametrize("freq,it0,its,fired", [
    (100, 0, range(16, 401, 16), [112, 208, 304, 400]),  # stride 16
    (10, 0, range(1, 51), [10, 20, 30, 40, 50]),  # stride 1 = modulo
    (10, 37, range(41, 81, 4), [41, 53, 61, 73]),  # resumed, misaligned counter
    (0, 0, range(1, 4), [1, 2, 3]),  # freq 0 treated as 1
])
def test_every_fires_on_crossings(freq, it0, its, fired):
    gate = _Every(freq, it0=it0)
    assert [it for it in its if gate(it)] == fired


def test_every_fires_once_per_bucket():
    gate = _Every(10)
    assert gate(10) and not gate(10)


class _S:
    def __init__(self, steps):
        self.env_steps = steps


class _Cfg:
    class algo:
        horizon_len = 4
        warm_up = 8
        log_freq = 1

    num_envs = 16


@pytest.mark.parametrize("steps,resumed,per_env,want", [
    (768, True, False, 10),  # warm-up 8 × 16 = 128 steps, then 10 iterations of 4 × 16
    (768, False, False, 0),
    (64, True, False, 0),  # clamped at 0
    (48, True, True, 10),  # per-env counter: 8 warm-up steps + 10 × 4
])
def test_resumed_iter(steps, resumed, per_env, want):
    assert _resumed_iter(_Cfg, _S(steps), resumed=resumed, per_env=per_env) == want


# ------------------------------------------------------------------ logger


def _log_three(logger):
    logger.log({"train/return": 1.5, "speed/env_steps": 128}, step=128)
    logger.log({"eval/return": torch.tensor(2.0)}, step=256)
    logger.log_artifact(logger.run_dir or "", "name")  # nothing outside wandb mode
    logger.close()


def test_run_logger_writes_what_the_jax_logger_writes(tmp_path):
    kw = dict(task="PointMass", logging__out_dir=str(tmp_path), logging__console=False)
    jcfg = j_make_config("pql", logging__run_name="jax", **kw)
    cfg = make_config("pql", logging__run_name="port", **kw)
    _log_three(JRunLogger(jcfg, {"x": 1}))
    _log_three(RunLogger(cfg, to_dict(cfg)))
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir)) == ["config.json", "metrics.jsonl"]
    jrecs = [json.loads(x) for x in (jdir / "metrics.jsonl").read_text().splitlines()]
    precs = [json.loads(x) for x in (pdir / "metrics.jsonl").read_text().splitlines()]
    assert [sorted(r) for r in precs] == [sorted(r) for r in jrecs]
    assert [(r["step"], r.get("eval/return")) for r in precs] == [(128, None), (256, 2.0)]
    assert json.loads((pdir / "config.json").read_text())["algo"]["eval_freq"] == 200


def test_run_logger_off_writes_nothing(tmp_path):
    cfg = make_config("pql", logging__mode="off", logging__out_dir=str(tmp_path))
    logger = RunLogger(cfg, to_dict(cfg))
    _log_three(logger)
    assert logger.run_dir is None and os.listdir(tmp_path) == []


def test_run_logger_wandb_falls_back_to_local(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # the package cannot be imported
    cfg = make_config("pql", logging__mode="wandb", logging__out_dir=str(tmp_path), logging__run_name="r")
    logger = RunLogger(cfg, to_dict(cfg))
    assert logger.mode == "local"
    _log_three(logger)
    assert (tmp_path / "r" / "metrics.jsonl").exists()
    assert "step 128 | train/return=1.5" in capsys.readouterr().out


# --------------------------------------------------------------- the loop


class _CapturingLogger:
    run_dir = None

    def __init__(self):
        self.records = []

    def log(self, metrics, step):
        self.records.append((dict(metrics), step, time.time()))


def test_train_pql_eval_cadence_and_speed_with_stride():
    """iters_per_call 16 and eval_freq 100: evals at iterations 112 and 208
    (not 400), at their dispatch steps; the logged env_steps_per_s matches
    the records' own clock within 5%."""
    cfg = make_config(
        "pql", task="PointMass", num_envs=8, eval_num_envs=8, algo__batch_size=32, algo__memory_size=1024,
        algo__warm_up=4, algo__iters_per_call=16, algo__eval_freq=100, algo__log_freq=10,
        logging__mode="off",
        max_step=1800,  # warm-up 4 × 8 = 32 steps + 14 calls × 128 steps = 1824 > 1800
    )
    logger = _CapturingLogger()
    agent, state = train_pql(cfg, logger, device="cpu")
    evals = [(m, s) for m, s, _ in logger.records if "eval/return" in m]
    assert [s for _, s in evals] == [32 + 112 * 8, 32 + 208 * 8]
    assert all(set(m) == {"eval/return", "eval/episode_length"} for m, _ in evals)
    assert (state.critic_update_count, state.actor_update_count) == (8 * 224, 4 * 224)
    speed = [(m, s, t) for m, s, t in logger.records if "speed/env_steps_per_s" in m]
    assert len(speed) >= 3
    for (m0, s0, t0), (m1, s1, t1) in zip(speed, speed[1:]):
        assert m1["speed/env_steps_per_s"] == pytest.approx((s1 - s0) / (t1 - t0), rel=0.05)


def test_train_pql_writes_one_profiler_trace(tmp_path):
    """profile_dir: a Chrome trace of profile_iters iterations from
    iteration 2 on, written once (also when the run ends first)."""
    for iters, name in ((4, "short"), (12, "long")):  # ends inside the window / after it
        cfg = make_config(
            "pql", task="PointMass", num_envs=8, eval_num_envs=8, algo__batch_size=32, algo__memory_size=1024,
            algo__warm_up=4, algo__iters_per_call=1, logging__mode="off", profile_dir=str(tmp_path / name),
            profile_iters=5, max_step=4 * 8 + (iters - 1) * 8,
        )
        train_pql(cfg, _CapturingLogger(), device="cpu")
        trace = tmp_path / name / "trace.json"
        assert trace.exists() and "traceEvents" in json.loads(trace.read_text())
