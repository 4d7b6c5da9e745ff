"""Configuration tree of the port (a copy of the PQL part of pql_tpu.cfg)."""

from pql_tpu_torch.cfg.config import (
    AlgoConfig,
    Config,
    LoggingConfig,
    NoiseConfig,
    algo_config,
    entry_device,
    make_config,
    parse_cli,
    platform_device,
    require_card,
    to_dict,
)

__all__ = [
    "AlgoConfig",
    "Config",
    "LoggingConfig",
    "NoiseConfig",
    "algo_config",
    "entry_device",
    "make_config",
    "parse_cli",
    "platform_device",
    "require_card",
    "to_dict",
]
