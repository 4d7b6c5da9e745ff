"""pql_tpu_torch — the PyTorch/CUDA port of pql_tpu, for one NVIDIA H100.

A second package beside the JAX one, with the same layout so each module's
counterpart is easy to find: ``cfg``, ``envs`` (Cartpole and the rigid
locomotion tasks, whose control step is a captured CUDA graph on the
card), ``physics`` (the rigid-body engine), ``ops`` (with the hand-written
CUDA kernel bound in ``ops/kernels.py``, sources in ``csrc/``), ``replay``,
``models``, ``algos`` and ``utils``. It imports torch and numpy and nothing
of JAX.

Entry points (``train``, ``contact_lab``, ``visualize``, ``ratio_sweep``,
each ``python -m pql_tpu_torch.<name>``) run on ``device="cuda"``; only an
explicit ``device="cpu"`` runs on the CPU (the tests do). Nothing falls back to the CPU when no
card is found.
"""
