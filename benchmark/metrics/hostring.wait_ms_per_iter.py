"""Host ms per iteration inside DDPGV's ``ring_write`` (the copy back to
the host and the native ring's write) and ``fetch_batch`` (the native
gather into pinned staging and the copy to the card), the host ring's share
of an iteration. Both ranges open after a ``synchronize`` (the adapter's
``install_spans``), so they hold the ring's own host time, not waits for the
device. Moves ``env_steps_per_s``; read where those ranges exist."""

RANGES = ("replay.ring_write", "replay.fetch_batch")


def read(s):
    held = [s.host_s_by_range[r] for r in RANGES if r in s.host_s_by_range]
    return None if not held else sum(held) * 1e3 / s.iters
