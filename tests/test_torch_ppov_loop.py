"""PPOV and IPPOV through the port's entry point, and the entry point's
precision and device settings, on the CPU.

- ``python -m pql_tpu_torch.train algo=ppov task=ReacherVision`` and
  ``algo=ippov task=BimanualReacherVision`` at a small size: evals rendered
  from the eval env's state, the best model and a checkpoint; resumed to a
  later step, the run ends bitwise where one uninterrupted run ends;
- ``train.main`` turns TF32 off for cuBLAS and cuDNN on an fp32 config
  (``algos/base.py::set_precision``; PyTorch's cuDNN default is on), and
  leaves the flags alone for bf16; it makes cuDNN deterministic either way;
- ``platform``: ``cpu`` picks the CPU, ``gpu``/``cuda`` the card, ``tpu`` is
  refused by name, and a ``platform`` that contradicts ``--device`` fails;
- no module of the port and not ``chip_smoke.py`` imports JAX, flax, optax,
  orbax or the JAX package (a grep of their import lines).
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from chip_smoke import state_diffs
from pql_tpu_torch import train
from pql_tpu_torch.algos.base import set_precision
from pql_tpu_torch.cfg import make_config, parse_cli, platform_device
from pql_tpu_torch.utils import checkpoint
from pql_tpu_torch.utils.logging import RunLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"ppov": dict(task="ReacherVision", num_envs=4, algo__horizon_len=4, algo__batch_size=8,
                      algo__update_times=2),
         "ippov": dict(task="BimanualReacherVision", num_envs=8, algo__horizon_len=4, algo__batch_size=16,
                       algo__update_times=2)}


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tf32_flags():
    """Restore the process-wide cuBLAS / cuDNN flags after a test that sets them."""
    b = torch.backends
    saved = b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic
    yield
    b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic = saved


@pytest.mark.parametrize("algo", ["ppov", "ippov"])
def test_kill_and_resume_bitwise_through_the_entry_point(tmp_path, algo):
    """``train.main``: evals every 2 iterations (2 eval envs), a full
    checkpoint every 3, stopped after 4 iterations; ``train_baseline``
    resumes from iteration 3 to 6 and ends bitwise where one run of 6 ends."""
    size = SIZES[algo]
    per_iter = size["num_envs"] * 4
    common = [f"{k.replace('__', '.')}={v}" for k, v in size.items()] + [
        "eval_num_envs=2", "algo.eval_freq=2", "algo.log_freq=1", "checkpoint_freq=3", "logging.console=false",
        f"logging.out_dir={tmp_path / 'runs'}"]
    train.main([f"algo={algo}", *common, f"max_step={3 * per_iter}", f"checkpoint_dir={tmp_path / 'ckpt'}",
                "logging.run_name=first", "--device=cpu"])
    recs = [json.loads(x) for x in open(tmp_path / "runs" / "first" / "metrics.jsonl")]
    evals = [r for r in recs if "eval/return" in r]
    assert [r["step"] // per_iter for r in evals] == [2, 4] and all(np.isfinite(r["eval/return"]) for r in evals)
    best = checkpoint.load_model_snapshot(str(tmp_path / "runs" / "first" / "best_model"))
    assert any(".trunk." in k for k in best["actor"]) == (algo == "ppov")

    def run(name, ckpt):
        cfg = make_config(algo, eval_num_envs=2, checkpoint_dir=str(tmp_path / ckpt), checkpoint_freq=3,
                          max_step=5 * per_iter, logging__out_dir=str(tmp_path / "runs"), logging__run_name=name,
                          logging__console=False, **dict(size, algo__eval_freq=2, algo__log_freq=1))
        logger = RunLogger(cfg)
        try:
            return train.train_baseline(cfg, logger, device="cpu")[1]
        finally:
            logger.close()

    resumed, whole = run("second", "ckpt"), run("whole", "ckpt_whole")
    assert state_diffs(resumed, whole) == []
    assert resumed.env_steps == 6 * per_iter and resumed.update_count == 6 * 2 * per_iter // size["algo__batch_size"]
    assert "q_prev" in resumed.env_state.state or algo == "ippov"


@pytest.mark.parametrize("dtype,want", [("float32", False), ("bfloat16", True)])
def test_main_sets_the_precision_policy(tmp_path, tf32_flags, dtype, want):
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    train.main(["algo=ppo", "task=PointMass", "num_envs=4", "algo.horizon_len=2", "algo.batch_size=8",
                "algo.update_times=1", "max_step=8", "eval_num_envs=2", f"algo.compute_dtype={dtype}",
                "logging.mode=off", f"logging.out_dir={tmp_path}", "--device=cpu"])
    assert torch.backends.cuda.matmul.allow_tf32 is want and torch.backends.cudnn.allow_tf32 is want
    assert torch.backends.cudnn.deterministic is True  # bitwise resume of a convolution's backward
    torch.backends.cudnn.allow_tf32 = True
    set_precision(make_config("ppov"))
    assert torch.backends.cudnn.allow_tf32 is False


def test_platform_names_the_device(tmp_path, monkeypatch):
    assert platform_device(None) is None
    assert [platform_device(p) for p in ("cpu", "gpu", "cuda", "GPU")] == ["cpu", "cuda", "cuda", "cuda"]
    assert parse_cli(["algo=ppo", "platform=cpu"]).platform == "cpu"
    with pytest.raises(ValueError, match="platform=tpu"):
        parse_cli(["algo=ppo", "platform=tpu"])
    with pytest.raises(ValueError, match="Unknown platform"):
        parse_cli(["algo=ppo", "platform=metal"])
    base = ["algo=ppo", "task=PointMass", "num_envs=4", "algo.horizon_len=2", "algo.batch_size=8",
            "algo.update_times=1", "max_step=8", "eval_num_envs=2", "logging.mode=off", f"logging.out_dir={tmp_path}"]
    with pytest.raises(SystemExit, match="contradicts --device=cpu"):
        train.main(base + ["platform=gpu", "--device=cpu"])
    seen = []
    monkeypatch.setattr(train, "train_baseline", lambda cfg, logger, device: seen.append(device))
    train.main(base + ["platform=cpu"])
    train.main(base + ["platform=cpu", "--device=cpu"])
    assert seen == ["cpu", "cpu"]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            train.main(base + ["platform=cuda"])


def test_the_port_imports_nothing_of_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|pql_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "pql_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    hits = {os.path.relpath(f, REPO): m.group(0).strip() for f in files for m in pattern.finditer(open(f).read())}
    assert len(files) > 50 and hits == {}
