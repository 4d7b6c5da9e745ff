"""Configuration tree of the port (a copy of the PQL part of pql_tpu.cfg)."""

from pql_tpu_torch.cfg.config import (
    AlgoConfig,
    Config,
    NoiseConfig,
    algo_config,
    make_config,
    parse_cli,
    to_dict,
)

__all__ = [
    "AlgoConfig",
    "Config",
    "NoiseConfig",
    "algo_config",
    "make_config",
    "parse_cli",
    "to_dict",
]
