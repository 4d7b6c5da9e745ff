"""Device ms per iteration of the work launched under the ``learner`` range:
the critic and actor phases (PQL) or the updates (DDPGV), optimizer steps and
polyak averaging included. Moves ``env_steps_per_s``."""


def read(s):
    v = s.device_s_by_layer.get("learner")
    return None if v is None else v * 1e3 / s.iters
