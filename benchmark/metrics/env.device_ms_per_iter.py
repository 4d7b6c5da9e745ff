"""Device ms per iteration of the work launched under the ``env`` range: the
AllegroHand control step's CUDA graph (PQL's ``_sim_phase``), or the Reacher
step and its render (DDPGV's ``collect``). Moves ``env_steps_per_s``."""


def read(s):
    v = s.device_s_by_layer.get("env")
    return None if v is None else v * 1e3 / s.iters
