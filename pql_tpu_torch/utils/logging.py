"""Logging facade: console + JSONL metrics, wandb if available (port of
pql_tpu/utils/logging.py:18-84).

The default sink is a local JSONL file per run, ``out_dir/run_name/
metrics.jsonl`` (one dict per log call, with ``step`` and ``time``), beside
``config.json``, plus a console line; with ``cfg.logging.mode='wandb'`` and
the package importable, wandb takes the same calls. ``off`` writes nothing.
The JAX logger's multi-host gating is not ported (the port refuses
``num_devices`` > 1).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class RunLogger:
    def __init__(self, cfg, cfg_dict: dict | None = None):
        self.cfg = cfg
        self.mode = cfg.logging.mode
        self.start_time = time.time()
        self._wandb = None
        self._file = None
        self.run_dir = None
        if self.mode == "off":
            return
        run_name = cfg.logging.run_name or f"{cfg.task}_{cfg.algo.name}_{int(self.start_time)}"
        self.run_dir = os.path.join(cfg.logging.out_dir, run_name)
        os.makedirs(self.run_dir, exist_ok=True)
        if self.mode == "wandb":
            try:
                import wandb  # noqa: PLC0415

                self._wandb = wandb.init(project=cfg.logging.project, name=run_name, config=cfg_dict)
            except ImportError:
                self.mode = "local"
        if self._wandb is None:
            self._file = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")
            if cfg_dict is not None:
                with open(os.path.join(self.run_dir, "config.json"), "w") as f:
                    json.dump(cfg_dict, f, indent=2, default=str)

    def log(self, metrics: dict[str, Any], step: int) -> None:
        if self.mode == "off":
            return
        metrics = {k: float(v) for k, v in metrics.items()}
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self._file is not None:
            rec = {"step": int(step), "time": time.time() - self.start_time, **metrics}
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self.cfg.logging.console:
            parts = " | ".join(f"{k}={v:.4g}" for k, v in metrics.items())
            print(f"[{time.time() - self.start_time:8.1f}s] step {step} | {parts}", flush=True)

    def log_artifact(self, dir_path: str, name: str, type: str = "model") -> None:
        """Persist a snapshot directory as a wandb Artifact; nothing outside
        wandb mode (local runs already have the directory on disk)."""
        if self._wandb is None:
            return
        import wandb  # noqa: PLC0415

        art = wandb.Artifact(name, type=type)
        art.add_dir(dir_path)
        self._wandb.log_artifact(art)

    def close(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        if self._file is not None:
            self._file.close()
