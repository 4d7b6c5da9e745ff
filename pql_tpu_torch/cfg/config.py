"""Dataclass configuration tree for the PyTorch port.

A copy of the PQL, off-policy baseline (DDPG, SAC, CrossQ, IDDPG),
on-policy (PPO, IPPO, MAPPO, QTOTV1/V2, IART, IPPOTeam/IPPOTeam2),
equivariant (EQ, EQG, EQS, EQS4, MP, EQSC, EQSdata), team-distillation
(EQSD, EQSD2) and visual (PPOV, IPPOV) parts of ``pql_tpu.cfg.config``,
kept here so the port imports nothing of the JAX package. The CLI grammar is the same:

    python -m pql_tpu_torch.train algo=pql_d task=Cartpole num_envs=4096 algo.batch_size=8192
    python -m pql_tpu_torch.train algo=ddpg task=Cartpole num_envs=16 algo.batch_size=1024
    python -m pql_tpu_torch.train algo=ppo task=Ant task_param=true

Only the fields the port's agents read are kept,
so an override of a knob the port does not implement fails with "No config
field" instead of being ignored. The device is an argument of the entry points
(``--device=``); the JAX package's ``platform`` field is accepted as another
way to name it: ``cpu``, or ``gpu``/``cuda`` for the card (``platform_device``);
``tpu`` is refused.
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
class LoggingConfig:
    """Logging sinks (reference pql/cfg/logging/default.yaml)."""

    mode: str = "local"  # 'local' (JSONL+console) | 'wandb' (if installed) | 'off'
    project: str = "pql_tpu"
    run_name: str | None = None
    out_dir: str = "runs"
    console: bool = True


@dataclass
class AlgoConfig:
    """PQL / PQL-D, DDPG / SAC / CrossQ and PPO / IPPO / MAPPO hyperparameters
    (actor_critic.yaml, pql_algo.yaml, ddpg_algo.yaml, sac_algo.yaml,
    ppo_algo.yaml)."""

    name: str = "PQL"
    actor_lr: float = 5e-4
    critic_lr: float = 5e-4
    batch_size: int = 8192
    reward_scale: float = 1.0
    max_grad_norm: float | None = 0.5
    tracker_len: int = 100
    obs_norm: bool = True
    value_norm: bool = False  # PPO family: a running norm of the critic's targets
    handle_timeout: bool = True
    log_freq: int = 2
    eval_freq: int = 200
    horizon_len: int = 1
    memory_size: int = 5_000_000
    nstep: int = 3
    tau: float = 0.05
    gamma: float = 0.99
    warm_up: int = 32
    act_class: str = "TanhMLPPolicy"
    cri_class: str = "DoubleQ"
    # the baselines: updates per iteration; the live actor as the target policy
    update_times: int = 8
    no_tgt_actor: bool = True
    noise: NoiseConfig = field(default_factory=NoiseConfig)
    critic_actor_ratio: int = 2
    critic_sample_ratio: int = 8
    # on an eval-return stall, escalate critic_sample_ratio ×adapt_factor up
    # to adapt_max_ratio through PQL.set_ratios (utils/ratio_control.py)
    adaptive_ratios: bool = False
    adapt_window: int = 6
    adapt_factor: int = 2
    adapt_max_ratio: int = 32
    # accepted for the JAX package's CLI; eager PyTorch has nothing to compile
    adapt_precompile: bool = True
    # --- PQL-D distributional ---
    distl: bool = False
    v_min: float = -10.0
    v_max: float = 10.0
    num_atoms: int = 51
    # --- SAC: a fixed temperature, or None to learn log α ---
    alpha: float | None = None
    alpha_lr: float = 5e-3
    # --- PPO (ppo_algo.yaml) ---
    use_gae: bool = True
    value_clip: bool = True
    lambda_gae_adv: float = 0.95
    lambda_entropy: float = 0.0
    ratio_clip: float = 0.2
    # --- IPPO: one actor/critic pair for both hands, on the summed losses ---
    same_policy: bool = False
    # --- EQSD: the team actor, a diffusion policy of diffusion_iter DDPM
    # steps or a Gaussian; EQSD2: the KL weight, kl_max → 0 over kl_decay_iters
    diffusion_iter: int = 5
    diffusion: bool = False
    kl_max: float = 1.0
    kl_decay_iters: int = 1000
    # a local pretrained-weight file for the vision encoders (.npz / .pth;
    # models/pretrained.py), merged into PPOV's actor at init
    encoder_weights: str | None = None
    compute_dtype: str = "float32"  # network compute dtype; params stay fp32
    replay_dtype: str = "float32"
    # iterations per train_block call (a Python loop in the port)
    iters_per_call: int = 4
    # use the hand-written CUDA kernel for the C51 target projection
    use_pallas: bool = True
    # replay sampling: 0 = iid (slot, env) pairs; n > 0 = a shared window of
    # batch/n consecutive envs in each of n random slots (replay/buffer.py)
    sample_slots: int = 0
    # gather every batch of a learner phase in one row gather before it
    prefetch_batches: bool = False


# ppo_algo.yaml; the two-agent agents reuse it with the agent swapped (the
# JAX package's _ppo_like for QTOT, the team agents and the EQ family)
_ON_POLICY = dict(horizon_len=16, batch_size=32768, act_class="DiagGaussianMLPPolicy", cri_class="MLPCritic",
                  eval_freq=20, update_times=4)
# the equivariant agents' pair (the JAX package's _eq_presets); MP and EQSdata keep the plain nets
_EQ_MODELS = dict(act_class="DiagGaussianEquivariantMLPPolicy", cri_class="MLPCriticEquivariant")


def _algo_presets() -> dict[str, dict[str, Any]]:
    return {
        "pql": dict(name="PQL", eval_freq=200),
        "pql_d": dict(name="PQL", distl=True, eval_freq=200),
        "ddpg": dict(name="DDPG", eval_freq=100, update_times=8),
        "sac": dict(name="SAC", act_class="TanhDiagGaussianMLPPolicy", eval_freq=100, update_times=8),
        "crossq": dict(name="CrossQ", cri_class="DoubleQBatchNorm", eval_freq=100, update_times=8),
        "ppo": dict(_ON_POLICY, name="PPO"),
        "ippo": dict(_ON_POLICY, name="IPPO"),
        "mappo": dict(_ON_POLICY, name="MAPPO"),
        "iddpg": dict(name="IDDPG", eval_freq=100, update_times=8),
        "qtotv1": dict(_ON_POLICY, name="QTOTV1"),
        "qtotv2": dict(_ON_POLICY, name="QTOTV2"),
        "iart": dict(_ON_POLICY, name="IART"),
        "ippoteam": dict(_ON_POLICY, name="IPPOTeam"),
        "ippoteam2": dict(_ON_POLICY, name="IPPOTeam2"),
        "eq": dict(_ON_POLICY, name="EQ", **_EQ_MODELS),
        "eqg": dict(_ON_POLICY, name="EQG", **_EQ_MODELS),
        "eqs": dict(_ON_POLICY, name="EQS", **_EQ_MODELS),
        "eqs4": dict(_ON_POLICY, name="EQS4", **_EQ_MODELS),
        "mp": dict(_ON_POLICY, name="MP"),
        "eqsc": dict(_ON_POLICY, name="EQSC", **_EQ_MODELS),
        "eqsdata": dict(_ON_POLICY, name="EQSdata"),
        "eqsd": dict(_ON_POLICY, name="EQSD", **_EQ_MODELS),
        "eqsd2": dict(_ON_POLICY, name="EQSD2", **_EQ_MODELS),
        "ppov": dict(_ON_POLICY, name="PPOV"),
        "ippov": dict(_ON_POLICY, name="IPPOV"),
    }



@dataclass
class Config:
    task: str = "Cartpole"
    algo: AlgoConfig = field(default_factory=AlgoConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    num_envs: int = 4096
    eval_num_envs: int = 150
    seed: int = 42
    max_step: int | None = None
    max_time: float = 3600.0  # seconds
    artifact: str | None = None  # weights-only snapshot to start from
    # info-dict tracking of the baselines: keys and their modes ('last',
    # 'all-episode' or 'all-step'; 'last' for every key when None)
    info_track_keys: tuple[str, ...] | None = None
    info_track_step: tuple[str, ...] | None = None
    # PPO: the per-task presets of PPO_TASK_PRESETS (reference isaac_param)
    task_param: bool = False
    # multi-device is not ported yet; PQL refuses anything but None or 1
    num_devices: int | None = None
    # full-state checkpoint directory (resumed from if it holds one) and the
    # save period in outer iterations (0 = every 500 when a directory is set)
    checkpoint_dir: str | None = None
    checkpoint_freq: int = 0
    # torch.profiler Chrome trace of profile_iters iterations (None = off)
    profile_dir: str | None = None
    profile_iters: int = 20
    # the JAX package's backend choice, read as the device: 'cpu', or
    # 'gpu'/'cuda' for the card (platform_device; 'tpu' is refused)
    platform: str | None = None


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


PPO_TASK_PRESETS: dict[str, dict[str, Any]] = {
    "Ant": dict(num_envs=4096, batch_size=32768, horizon_len=16, update_times=4),
    "Humanoid": dict(num_envs=4096, batch_size=32768, horizon_len=32, update_times=5, value_norm=True),
    "Anymal": dict(num_envs=4096, batch_size=32768, horizon_len=16, update_times=5),
    "AllegroHand": dict(num_envs=16384, batch_size=32768, horizon_len=8, update_times=5, value_norm=True),
    "ShadowHand": dict(num_envs=16384, batch_size=32768, horizon_len=8, update_times=5, value_norm=True),
    "FrankaCubeStack": dict(num_envs=8192, batch_size=16384, horizon_len=32, update_times=5),
}


_PLATFORM_DEVICES = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def platform_device(platform: str | None) -> str | None:
    """The device type a ``platform`` value names (None for None)."""
    if platform is None:
        return None
    key = platform.lower()
    if key == "tpu":
        raise ValueError("platform=tpu: the port runs on a CUDA card or the CPU (platform=gpu|cuda|cpu)")
    if key not in _PLATFORM_DEVICES:
        raise ValueError(f"Unknown platform {platform!r}; want one of {sorted(_PLATFORM_DEVICES)}")
    return _PLATFORM_DEVICES[key]


def preprocess_config(cfg: Config) -> Config:
    """Per-task reward_scale / max_time tables, applied only where the user
    kept the default (reference common.py:148-182); with ``task_param`` a
    PPO run takes its task's PPO_TASK_PRESETS entry (common.py:246-275)."""
    if cfg.task in TASK_REWARD_SCALE and cfg.algo.reward_scale == 1.0:
        cfg.algo.reward_scale = TASK_REWARD_SCALE[cfg.task]
    if cfg.task in TASK_MAX_TIME and cfg.max_time == 3600.0:
        cfg.max_time = TASK_MAX_TIME[cfg.task]
    if cfg.algo.name == "PPO" and cfg.task_param and cfg.task in PPO_TASK_PRESETS:
        for k, v in PPO_TASK_PRESETS[cfg.task].items():
            setattr(cfg if k == "num_envs" else cfg.algo, k, v)
    platform_device(cfg.platform)  # a bad platform fails at parse time
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
    if isinstance(ref, tuple) or (ref is None and value[:1] in "[("):  # info_track_keys=[a,b]
        return tuple(v for v in value.strip("[]()").split(",") if v)
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
