"""Kernel and graph launches (``cudaLaunchKernel`` and its kin,
``cudaGraphLaunch``) made on the host under the ``learner`` range, per
iteration: the learner's host dispatch. Moves ``env_steps_per_s``."""


def read(s):
    v = s.launches_by_layer.get("learner")
    return None if v is None else v / s.iters
