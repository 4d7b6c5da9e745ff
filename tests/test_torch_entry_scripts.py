"""The port's visualize and ratio-sweep entry points (pql_tpu_torch.visualize,
pql_tpu_torch.ratio_sweep) against the JAX scripts (scripts/visualize.py,
scripts/ratio_sweep.py), and the JAX package's learning report
(scripts/learning_report.py, run unchanged) on a run of the port, on the
CPU at tiny sizes.

- ``visualize``: refuses a run without ``artifact=`` with the JAX script's
  message, refuses the card where there is none; on the best model of a
  CPU ``train.main`` run its returns equal (exactly) those of an
  ``Evaluator`` from the same snapshot with a generator seeded ``seed + 1``,
  and it prints the JAX script's line per episode batch.
- ``ratio_sweep``: two points on a tiny Cartpole update exactly cs critic
  and cs/ca actor times per iteration over the timed window; the records
  and the table file carry the JAX script's keys, in its order (read from
  the script's source).
- ``scripts/learning_report.py`` renders the port run's row from its
  ``metrics.jsonl`` and ``config.json``.
- The lab, ``visualize`` and ``ratio_sweep`` take their device rule from
  the config package and load no training entry point
  (``pql_tpu_torch.train``) and nothing of JAX.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from pql_tpu_torch import ratio_sweep, train, visualize
from pql_tpu_torch.algos import get_algo
from pql_tpu_torch.cfg import Config, parse_cli
from pql_tpu_torch.envs import make_env
from pql_tpu_torch.utils.checkpoint import load_model_snapshot, restore_into_state
from pql_tpu_torch.utils.evaluator import Evaluator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["algo=pql", "task=Cartpole", "num_envs=16", "algo.batch_size=64", "algo.memory_size=4096",
        "algo.warm_up=4", "algo.iters_per_call=1"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script_source(name):
    with open(os.path.join(ROOT, "scripts", name)) as f:
        return f.read()


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A CPU ``train.main`` run with evals: its run directory (best model,
    metrics.jsonl, config.json)."""
    root = tmp_path_factory.mktemp("port_run")
    train.main(TINY + ["algo.eval_freq=4", "eval_num_envs=4", "max_step=200", f"logging.out_dir={root}",
                       "logging.run_name=tiny", "logging.console=false", "--device=cpu"])
    return os.path.join(root, "tiny")


def test_visualize_refuses_without_artifact_as_the_jax_script():
    tree = ast.parse(_script_source("visualize.py"))
    messages = [n.args[0].value for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "SystemExit" and n.args and isinstance(n.args[0], ast.Constant)]
    assert messages == ["pass artifact=<path to a saved model snapshot>"]
    with pytest.raises(SystemExit) as e:
        visualize.main(["algo=pql", "task=Cartpole", "--device=cpu"])
    assert str(e.value) == messages[0]


def test_visualize_refuses_a_missing_card(run_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        visualize.main(["algo=pql", "task=Cartpole", f"artifact={run_dir}/best_model"])


def test_visualize_equals_the_evaluator_from_the_same_snapshot(run_dir, capsys):
    best = os.path.join(run_dir, "best_model")
    argv = ["algo=pql", "task=Cartpole", f"artifact={best}", "num_envs=8", "algo.memory_size=4096"]
    got = visualize.main(argv + ["episodes=2", "--device=cpu"])
    lines = capsys.readouterr().out.splitlines()

    cfg = parse_cli(argv, base=Config(num_envs=16, eval_num_envs=16))
    agent = get_algo(cfg.algo.name)(cfg, "cpu")
    state = agent.init()
    state = restore_into_state(state, load_model_snapshot(best), agent.snapshot_parts(state))
    snap = load_model_snapshot(best)
    for k, v in snap["actor"].items():
        assert torch.equal(state.actor.state_dict()[k], v), k
    ev = Evaluator(cfg, make_env(cfg), agent.eval_actor_apply, "cpu")
    assert ev.env.num_envs == 8
    gen = torch.Generator().manual_seed(cfg.seed + 1)
    want = [ev.eval_policy(agent.eval_params(state), state.obs_rms, gen) for _ in range(2)]
    assert got == want
    # the JAX script's line (scripts/visualize.py:59-62)
    assert lines == [f"episode batch {i}: return={w['eval/return']:.2f} length={w['eval/episode_length']:.1f}"
                     for i, w in enumerate(want)]
    assert 'f"episode batch {ep}: return={metrics[\'eval/return\']:.2f} "' in _script_source("visualize.py")


def _jax_sweep_keys():
    """The record keys of scripts/ratio_sweep.py::run_point and its table keys, from its source."""
    tree = ast.parse(_script_source("ratio_sweep.py"))
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    record = [r.value for r in ast.walk(fns["run_point"]) if isinstance(r, ast.Return)][-1]
    table = [n.value for n in ast.walk(fns["main"]) if isinstance(n, ast.Assign)
             and getattr(n.targets[0], "id", None) == "table"][0]
    return [k.value for k in record.keys], [k.value for k in table.keys]


def test_ratio_sweep_counts_and_keys(tmp_path, capsys, monkeypatch):
    record_keys, table_keys = _jax_sweep_keys()
    windows = []
    measure = ratio_sweep.run_point

    def recorded(*a, **k):
        record, window = measure(*a, **k)
        windows.append(window)
        return record, window

    monkeypatch.setattr(ratio_sweep, "run_point", recorded)
    out = tmp_path / "sweep.json"
    results = ratio_sweep.main(TINY[1:] + ["eval_num_envs=4", "sweep=8:2,4:1", "seconds_per_point=0.2",
                                           f"out={out}", "--device=cpu"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert printed == results and len(results) == 2
    for (cs, ca), r, w in zip([(8, 2), (4, 1)], results, windows):
        assert list(r) == record_keys
        assert (r["critic_sample_ratio"], r["critic_actor_ratio"]) == (cs, ca)
        assert w["iterations"] >= 1
        assert w["critic_updates"] == cs * w["iterations"]  # horizon_len 1
        assert w["actor_updates"] == (cs // ca) * w["iterations"]
        assert w["env_steps"] == w["iterations"]  # the per-env counter, as the JAX script reads it
        assert r["env_steps_per_s"] == round(w["env_steps"] / w["seconds"], 1)
        assert r["critic_updates_per_s"] == round(w["critic_updates"] / w["seconds"], 1)
    with open(out) as f:
        table = json.load(f)
    assert list(table) == table_keys and table["points"] == results
    assert (table["task"], table["num_envs"], table["batch_size"], table["seconds_per_point"]) == ("Cartpole", 16, 64, 0.2)


def test_ratio_sweep_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        ratio_sweep.main(TINY[1:] + ["sweep=8:2"])


def test_learning_report_reads_a_port_run(run_dir, tmp_path):
    out = tmp_path / "LEARNING.md"
    res = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "learning_report.py"), run_dir, f"out={out}"],
                         capture_output=True, text=True, timeout=120, check=True)
    assert "wrote" in res.stdout
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if "eval/return" in r]
    assert evals
    best = round(max(r["eval/return"] for r in evals), 2)
    final = round(evals[-1]["eval/return"], 2)
    row = f"| Cartpole | PQL | 16 | {int(evals[-1]['step']):,} | {round(evals[-1]['time'], 1):.0f} s | {best} | {final} | — | — |"
    assert row in out.read_text().splitlines()


@pytest.mark.parametrize("module", ["pql_tpu_torch.contact_lab", "pql_tpu_torch.visualize",
                                    "pql_tpu_torch.ratio_sweep"])
def test_entry_tools_load_no_training_entry(module):
    code = (f"import sys, {module}; "
            "bad = [m for m in sys.modules if m == 'pql_tpu_torch.train' or m == 'jax' or m.startswith('pql_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
