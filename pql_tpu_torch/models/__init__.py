"""Model registry of the port (name → class, as ``algo.act_class`` / ``algo.cri_class`` name them).

All 22 names of the JAX registry (pql_tpu/models/__init__.py:39-62): the
plain MLPs, the equivariant tier, the diffusion policies (the vision
tier's ``DiffusionPolicy`` among them) and the point-cloud encoders
(``MultiStagePointNetEncoder``, ``StateEncoder``, ``Encoder``).
``FiniteGroup``, ``GroupEquivariantLinear`` and ``GroupEMLP`` are exported,
not registered, as in the JAX package; so are the visual encoders and
policy of ``models/visual.py``."""

from pql_tpu_torch.models.diffusion import DiffusionNet, DiffusionPolicy, MLPResNet, StateDiffusionPolicy
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
from pql_tpu_torch.models.pointnet import Encoder, MultiStagePointNetEncoder, StateEncoder

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
    "DiffusionPolicy": DiffusionPolicy,
    "MultiStagePointNetEncoder": MultiStagePointNetEncoder,
    "StateEncoder": StateEncoder,
    "Encoder": Encoder,
}


def get_model(name: str):
    if name not in MODEL_REGISTRY:
        raise KeyError(f"Unknown model '{name}'. Ported so far: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


__all__ = ["MODEL_REGISTRY", "get_model", "MLPNet", "TanhMLPPolicy", "DiagGaussianMLPPolicy",
           "TanhDiagGaussianMLPPolicy", "DoubleQ", "DoubleQBatchNorm", "DistributionalDoubleQ", "MLPCritic", "EMLP",
           "EquivariantMLPNet", "TanhEquivariantMLPPolicy", "DiagGaussianEquivariantMLPPolicy",
           "MLPCriticEquivariant", "DoubleQEquivariant", "FiniteGroup", "GroupEquivariantLinear", "GroupEMLP",
           "DiffusionNet", "StateDiffusionPolicy", "MLPResNet", "EquivariantDiffusionPolicy", "DiffusionPolicy",
           "MultiStagePointNetEncoder", "StateEncoder", "Encoder"]
