"""Dataclass configuration tree for the PyTorch port.

A copy of the PQL part of ``pql_tpu.cfg.config``, kept here so the port
imports nothing of the JAX package. The CLI grammar is the same:

    python -m pql_tpu_torch.train algo=pql_d task=Cartpole num_envs=4096 algo.batch_size=8192

Only the fields the port's PQL path reads are kept, so an override of a
knob the port does not implement fails with "No config field" instead of
being ignored. The device is an argument of the entry points, not a
config field.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any


@dataclass
class NoiseConfig:
    """Exploration-noise block (reference pql/cfg/algo/pql_algo.yaml:26-34)."""

    type: str = "mixed"  # 'fixed' | 'mixed'
    decay: str | None = None  # None | 'linear' | 'exp'
    exp_decay_rate: float = 0.99
    lin_decay_iters: int = 10000
    std_max: float = 0.8
    std_min: float = 0.05
    tgt_pol_std: float = 0.8
    tgt_pol_noise_bound: float = 0.2


@dataclass
class AlgoConfig:
    """PQL / PQL-D hyperparameters (actor_critic.yaml + pql_algo.yaml)."""

    name: str = "PQL"
    actor_lr: float = 5e-4
    critic_lr: float = 5e-4
    batch_size: int = 8192
    reward_scale: float = 1.0
    max_grad_norm: float | None = 0.5
    tracker_len: int = 100
    obs_norm: bool = True
    handle_timeout: bool = True
    log_freq: int = 2
    horizon_len: int = 1
    memory_size: int = 5_000_000
    nstep: int = 3
    tau: float = 0.05
    gamma: float = 0.99
    warm_up: int = 32
    act_class: str = "TanhMLPPolicy"
    cri_class: str = "DoubleQ"
    noise: NoiseConfig = field(default_factory=NoiseConfig)
    critic_actor_ratio: int = 2
    critic_sample_ratio: int = 8
    # runtime ratio adaptation is not ported yet; PQL refuses True
    adaptive_ratios: bool = False
    # --- PQL-D distributional ---
    distl: bool = False
    v_min: float = -10.0
    v_max: float = 10.0
    num_atoms: int = 51
    compute_dtype: str = "float32"  # network compute dtype; params stay fp32
    replay_dtype: str = "float32"
    # iterations per train_block call (a Python loop in the port)
    iters_per_call: int = 4
    # use the hand-written CUDA kernel for the C51 target projection
    use_pallas: bool = True
    # not ported yet; PQL refuses non-defaults
    sample_slots: int = 0
    prefetch_batches: bool = False


def _algo_presets() -> dict[str, dict[str, Any]]:
    return {
        "pql": dict(name="PQL"),
        "pql_d": dict(name="PQL", distl=True),
    }


@dataclass
class Config:
    task: str = "Cartpole"
    algo: AlgoConfig = field(default_factory=AlgoConfig)
    num_envs: int = 4096
    seed: int = 42
    max_step: int | None = None
    max_time: float = 3600.0  # seconds
    # multi-device is not ported yet; PQL refuses anything but None or 1
    num_devices: int | None = None


TASK_REWARD_SCALE: dict[str, float] = {
    "AllegroHand": 0.01,
    "Ant": 0.01,
    "Humanoid": 0.01,
    "Anymal": 1.0,
    "FrankaCubeStack": 0.1,
    "ShadowHand": 0.01,
    "BallBalance": 0.1,
}

TASK_MAX_TIME: dict[str, float] = {
    "AllegroHand": 4800,
    "Ant": 3600,
    "Humanoid": 3600,
    "Anymal": 1800,
    "FrankaCubeStack": 3600,
    "ShadowHand": 4800,
    "BallBalance": 3600,
}


def preprocess_config(cfg: Config) -> Config:
    """Per-task reward_scale / max_time tables, applied only where the user
    kept the default (reference common.py:148-182)."""
    if cfg.task in TASK_REWARD_SCALE and cfg.algo.reward_scale == 1.0:
        cfg.algo.reward_scale = TASK_REWARD_SCALE[cfg.task]
    if cfg.task in TASK_MAX_TIME and cfg.max_time == 3600.0:
        cfg.max_time = TASK_MAX_TIME[cfg.task]
    return cfg


def algo_config(name: str) -> AlgoConfig:
    presets = _algo_presets()
    key = name.lower()
    if key not in presets:
        raise ValueError(f"Unknown algo '{name}'. Available: {sorted(presets)}")
    cfg = AlgoConfig()
    for k, v in presets[key].items():
        setattr(cfg, k, v)
    return cfg


def _coerce(value: str, ref: Any) -> Any:
    """Coerce a CLI string to the type of the existing field value."""
    if value.lower() in ("null", "none"):
        return None
    if isinstance(ref, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(ref, int):
        return int(float(value))
    if isinstance(ref, float):
        return float(value)
    if ref is None:
        try:
            f = float(value)
            return int(f) if f.is_integer() and "." not in value else f
        except ValueError:
            return value
    return value


def _set_dotted(cfg: Any, key: str, value: str) -> None:
    parts = key.split(".")
    obj = cfg
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise AttributeError(f"No config group '{p}' in override '{key}'")
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise AttributeError(f"No config field '{key}'")
    setattr(obj, leaf, _coerce(value, getattr(obj, leaf)))


def parse_cli(argv: list[str], base: Config | None = None) -> Config:
    """Parse ``key=value`` overrides; ``algo=<name>`` selects the group first."""
    cfg = base or Config()
    rest = []
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"Expected key=value override, got '{arg}'")
        k, v = arg.split("=", 1)
        if k == "algo":
            cfg.algo = algo_config(v)
        else:
            rest.append((k, v))
    for k, v in rest:
        _set_dotted(cfg, k, v)
    return preprocess_config(cfg)


def make_config(algo: str = "pql", **overrides: Any) -> Config:
    """Programmatic construction: make_config('pql_d', num_envs=16, algo__batch_size=64)."""
    cfg = Config(algo=algo_config(algo))
    for k, v in overrides.items():
        obj = cfg
        parts = k.split("__")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        setattr(obj, parts[-1], v)
    return preprocess_config(cfg)


def to_dict(cfg: Any) -> Any:
    if is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg
