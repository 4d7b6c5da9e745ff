"""IPPOV of the port against the JAX package, on the CPU: one
``IPPOV.train_iter`` on BimanualReacherVision (8 envs, horizon 4, batch 16,
one epoch; per-hand point-cloud actors, privileged critics) from a
converted JAX state with the JAX draws, and the eval hook; the helpers and
the tolerances are tests/test_torch_ppov.py's."""

from test_torch_ppov import _one_thread, eval_hook, one_iteration  # noqa: F401  (_one_thread: a fixture)


def test_one_iteration_matches_jax():
    one_iteration("ippov")


def test_eval_hook_renders_from_the_env_state():
    eval_hook("ippov")
