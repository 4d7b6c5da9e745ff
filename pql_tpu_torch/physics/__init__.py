"""The rigid-body engine, ported (pql_tpu/physics): a reduced-coordinate
articulated dynamics engine (CRBA + RNEA + anchored penalty contacts) on
per-env [E] tensors. The JAX package's ``ground_contacts`` and
``sphere_box_contacts`` (legacy viscous contacts) are not ported yet.
"""

from pql_tpu_torch.physics.model import RigidBodyModel, Geom, FREE, HINGE
from pql_tpu_torch.physics.dynamics import fd_step, fwd_kinematics, mass_matrix, body_velocities

__all__ = [
    "RigidBodyModel",
    "Geom",
    "FREE",
    "HINGE",
    "fd_step",
    "fwd_kinematics",
    "mass_matrix",
    "body_velocities",
]
