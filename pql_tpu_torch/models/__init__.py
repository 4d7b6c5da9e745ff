"""Model registry of the port (name → class, as ``algo.act_class`` / ``algo.cri_class`` name them)."""

from pql_tpu_torch.models.mlp import (
    DiagGaussianMLPPolicy,
    DistributionalDoubleQ,
    DoubleQ,
    DoubleQBatchNorm,
    MLPCritic,
    MLPNet,
    TanhDiagGaussianMLPPolicy,
    TanhMLPPolicy,
)

MODEL_REGISTRY = {
    "MLPNet": MLPNet,
    "TanhMLPPolicy": TanhMLPPolicy,
    "DiagGaussianMLPPolicy": DiagGaussianMLPPolicy,
    "TanhDiagGaussianMLPPolicy": TanhDiagGaussianMLPPolicy,
    "DoubleQ": DoubleQ,
    "DoubleQBatchNorm": DoubleQBatchNorm,
    "DistributionalDoubleQ": DistributionalDoubleQ,
    "MLPCritic": MLPCritic,
}


def get_model(name: str):
    if name not in MODEL_REGISTRY:
        raise KeyError(f"Unknown model '{name}'. Ported so far: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


__all__ = ["MODEL_REGISTRY", "get_model", "MLPNet", "TanhMLPPolicy", "DiagGaussianMLPPolicy",
           "TanhDiagGaussianMLPPolicy", "DoubleQ", "DoubleQBatchNorm", "DistributionalDoubleQ", "MLPCritic"]
