"""Share of an iteration in which no device operation (kernel, copy or set)
runs, in %: 1 − (device busy seconds per traced iteration, from the union of
the operations' intervals) / (wall seconds of an untraced iteration of the
same run). The profiler's own stalls (``Buffer Flush``) stretch the traced
window, so its length is not the base. Moves ``env_steps_per_s``."""


def read(s):
    if not s.untraced_s_per_iter or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.iters / s.untraced_s_per_iter)
