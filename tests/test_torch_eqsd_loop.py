"""EQSD with the plain-network team actors, and both team-distillation
agents through the entry point, on the CPU.

- one iteration of EQSD with the ``StateDiffusionPolicy`` team (its
  ``DiffusionNet`` at full width, [1024, 512, 256]) and with the plain
  Gaussian team against the JAX package from a converted JAX state with the
  JAX draws, as test_torch_eqsd.py;
- ``python -m pql_tpu_torch.train algo=eqsd algo.diffusion=true`` and
  ``algo=eqsd2`` at full width (the equivariant diffusion net 512 wide):
  evals, the best model and a checkpoint; resumed to a later step, the run
  ends bitwise where one uninterrupted run ends (the team actor's AdamW
  state and the generator are part of the state).

Tolerance rtol 1e-4 / atol 1e-5 with the Adam allowance of
tests/test_torch_pql.py::_assert_close.
"""

import json

import numpy as np
import pytest

from chip_smoke import state_diffs
from pql_tpu_torch import train
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.utils import checkpoint
from pql_tpu_torch.utils.logging import RunLogger
from test_torch_eqsd import DIFFUSION, PLAIN, _one_thread, one_iteration  # noqa: F401  (_one_thread: a fixture)


@pytest.mark.parametrize("extra,team", [(dict(DIFFUSION, **PLAIN), "StateDiffusionPolicy"),
                                        (PLAIN, "DiagGaussianMLPPolicy")], ids=["diffusion", "gaussian"])
def test_one_iteration_matches_jax(extra, team):
    one_iteration("eqsd", extra, team)


@pytest.mark.parametrize("algo,extra", [("eqsd", DIFFUSION), ("eqsd2", {})], ids=["eqsd-diffusion", "eqsd2"])
def test_kill_and_resume_bitwise_through_the_entry_point(tmp_path, algo, extra):
    """``train.main``: 8 envs, horizon 4, evals every 2 iterations and a full
    checkpoint every 3, stopped after 4 iterations; ``train_baseline``
    resumes from iteration 3 to 6 and ends bitwise where one run of 6 ends."""
    size = dict(task="BimanualReacher", num_envs=8, algo__horizon_len=4, algo__batch_size=16, algo__update_times=2,
                **extra)
    per_iter, rows = 4 * 8, 4 * 8 // (2 if algo == "eqsd2" else 1)
    common = [f"{k.replace('__', '.')}={v}" for k, v in size.items()] + [
        "eval_num_envs=8", "algo.eval_freq=2", "algo.log_freq=1", "checkpoint_freq=3", "logging.console=false",
        f"logging.out_dir={tmp_path / 'runs'}"]
    train.main([f"algo={algo}", *common, f"max_step={3 * per_iter}", f"checkpoint_dir={tmp_path / 'ckpt'}",
                "logging.run_name=first", "--device=cpu"])
    recs = [json.loads(x) for x in open(tmp_path / "runs" / "first" / "metrics.jsonl")]
    assert [r["step"] // per_iter for r in recs if "eval/return" in r] == [2, 4]
    assert all(np.isfinite(r["train/actor_loss_team"]) for r in recs if "train/actor_loss_team" in r)
    best = checkpoint.load_model_snapshot(str(tmp_path / "runs" / "first" / "best_model"))
    assert "actor_team" in {k.split(".")[0] for k in best["actor"]}

    def run(name, ckpt):
        cfg = make_config(algo, eval_num_envs=8, checkpoint_dir=str(tmp_path / ckpt), checkpoint_freq=3,
                          max_step=5 * per_iter, logging__out_dir=str(tmp_path / "runs"), logging__run_name=name,
                          logging__console=False, **dict(size, algo__eval_freq=2, algo__log_freq=1))
        logger = RunLogger(cfg)
        try:
            return train.train_baseline(cfg, logger, device="cpu")[1]
        finally:
            logger.close()

    resumed, whole = run("second", "ckpt"), run("whole", "ckpt_whole")
    assert state_diffs(resumed, whole) == []
    assert resumed.opts["actor_team"].state  # the team actor's AdamW moments came back
    assert resumed.env_steps == 6 * per_iter and resumed.update_count == 6 * 2 * rows // 16
