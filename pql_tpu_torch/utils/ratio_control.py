"""Host-side adaptive update-ratio controller for PQL (a copy of the pure
logic of pql_tpu/utils/ratio_control.py:31-72, so the port imports nothing
of the JAX package).

The controller watches the eval-return trace and escalates
``critic_sample_ratio`` multiplicatively when it stalls; the trainer applies
the new ratios through ``PQL.set_ratios``. Params, optimizer, replay,
generator and counters carry over.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class RatioController:
    """Escalate critic_sample_ratio when the eval-return trace stalls.

    A stall = over the last ``window`` evals, the best return improved by
    less than ``min_improvement`` (relative to the spread seen so far,
    with an absolute floor to survive flat zero-reward starts).
    """

    critic_sample_ratio: int
    critic_actor_ratio: int
    window: int = 6
    factor: int = 2
    max_ratio: int = 32
    min_improvement: float = 0.05  # fraction of the all-time return spread

    _returns: list = field(default_factory=list)
    _lo: float = float("inf")
    _hi: float = float("-inf")

    def update(self, eval_return: float) -> tuple[int, int] | None:
        """Feed one eval return; returns new (critic_sample_ratio,
        critic_actor_ratio) when an escalation should be applied, else None."""
        self._lo = min(self._lo, eval_return)
        self._hi = max(self._hi, eval_return)
        self._returns.append(eval_return)
        if len(self._returns) < self.window:
            return None
        recent = self._returns[-self.window :]
        older_best = max(self._returns[: -self.window], default=recent[0])
        spread = max(self._hi - self._lo, 1e-6)
        improved = (max(recent) - older_best) / spread
        if improved >= self.min_improvement:
            return None
        if self.critic_sample_ratio * self.factor > self.max_ratio:
            return None  # at the cap: nothing left to escalate
        self.critic_sample_ratio *= self.factor
        # restart the stall window at the new operating point
        self._returns.clear()
        return (self.critic_sample_ratio, self.critic_actor_ratio)
