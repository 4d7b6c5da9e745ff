"""Model registry of the port (name → class, as ``algo.act_class`` / ``algo.cri_class`` name them).

The plain MLPs, the equivariant tier and the state-conditioned diffusion
models of the JAX registry (pql_tpu/models/__init__.py:39-62), 18 of its
22 names; ``DiffusionPolicy`` and the point-cloud and visual encoders
(``Encoder``, ``StateEncoder``, ``MultiStagePointNetEncoder``) come with the
vision tier. ``FiniteGroup``, ``GroupEquivariantLinear`` and ``GroupEMLP``
are exported, not registered, as in the JAX package."""

from pql_tpu_torch.models.diffusion import DiffusionNet, MLPResNet, StateDiffusionPolicy
from pql_tpu_torch.models.ediffusion import EquivariantDiffusionPolicy
from pql_tpu_torch.models.emlp import (
    EMLP,
    DiagGaussianEquivariantMLPPolicy,
    DoubleQEquivariant,
    EquivariantMLPNet,
    FiniteGroup,
    GroupEMLP,
    GroupEquivariantLinear,
    MLPCriticEquivariant,
    TanhEquivariantMLPPolicy,
)
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
    "EMLP": EMLP,
    "EquivariantMLPNet": EquivariantMLPNet,
    "TanhEquivariantMLPPolicy": TanhEquivariantMLPPolicy,
    "DiagGaussianEquivariantMLPPolicy": DiagGaussianEquivariantMLPPolicy,
    "MLPCriticEquivariant": MLPCriticEquivariant,
    "DoubleQEquivariant": DoubleQEquivariant,
    "DiffusionNet": DiffusionNet,
    "StateDiffusionPolicy": StateDiffusionPolicy,
    "MLPResNet": MLPResNet,
    "EquivariantDiffusionPolicy": EquivariantDiffusionPolicy,
}


def get_model(name: str):
    if name not in MODEL_REGISTRY:
        raise KeyError(f"Unknown model '{name}'. Ported so far: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


__all__ = ["MODEL_REGISTRY", "get_model", "MLPNet", "TanhMLPPolicy", "DiagGaussianMLPPolicy",
           "TanhDiagGaussianMLPPolicy", "DoubleQ", "DoubleQBatchNorm", "DistributionalDoubleQ", "MLPCritic", "EMLP",
           "EquivariantMLPNet", "TanhEquivariantMLPPolicy", "DiagGaussianEquivariantMLPPolicy",
           "MLPCriticEquivariant", "DoubleQEquivariant", "FiniteGroup", "GroupEquivariantLinear", "GroupEMLP",
           "DiffusionNet", "StateDiffusionPolicy", "MLPResNet", "EquivariantDiffusionPolicy"]
