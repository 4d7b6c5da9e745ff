"""The rigid-body engine, ported (pql_tpu/physics): a reduced-coordinate
articulated dynamics engine (CRBA + RNEA + penalty contacts) on per-env [E]
tensors: the anchored contact groups of the tasks, their per-pair loops,
and the legacy viscous contacts (``ground_contacts``,
``sphere_box_contacts``) of the JAX package. ``codegen`` records the
scalar algebra's ops on symbolic columns, for a kernel with one thread per
env (the hand's fused control step).
"""

from pql_tpu_torch.physics.model import RigidBodyModel, Geom, FREE, HINGE
from pql_tpu_torch.physics.dynamics import fd_step, fwd_kinematics, mass_matrix, body_velocities
from pql_tpu_torch.physics.contact import ground_contacts, sphere_box_contacts

__all__ = [
    "RigidBodyModel",
    "Geom",
    "FREE",
    "HINGE",
    "fd_step",
    "fwd_kinematics",
    "mass_matrix",
    "body_velocities",
    "ground_contacts",
    "sphere_box_contacts",
]
