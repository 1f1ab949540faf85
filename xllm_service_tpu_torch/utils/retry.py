"""The retry and backoff policy of the worker's cluster loops.

A copy of the JAX package's ``utils/retry.py`` ``RetryPolicy``:
exponential backoff with full jitter (a fleet of workers retrying a
restarted master spreads over [0, delay] instead of synchronizing on the
backoff boundary), a per-use attempt budget, a delay cap and
stop-event-aware sleeping. Registration retries with it at boot, and
heartbeat sends back off with it while the master does not answer.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``delay(k)`` for attempt k (0-based) = min(base * multiplier**k,
    max_delay), scaled by ``1 - jitter * U[0,1)``. ``max_attempts``
    bounds a whole retry loop."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5          # fraction of each delay randomized away

    def delay(self, attempt: int) -> float:
        """The (jittered) delay before retry ``attempt`` (0-based)."""
        # Multiplicative, not multiplier**attempt: an unbounded attempt
        # counter (a master down for hours) would overflow float pow.
        d = min(self.base_delay_s, self.max_delay_s)
        if self.multiplier > 1.0:
            for _ in range(max(attempt, 0)):
                d *= self.multiplier
                if d >= self.max_delay_s:
                    d = self.max_delay_s
                    break
        if self.jitter > 0:
            d *= 1.0 - self.jitter * random.random()
        return max(d, 0.0)

    def sleep(self, attempt: int, stop_event=None,
              deadline: Optional[float] = None) -> bool:
        """Wait out attempt ``attempt``'s backoff, cut at ``deadline``
        (monotonic). Returns False when the deadline has passed or
        ``stop_event`` is set (the caller abandons the retry loop);
        waiting on it keeps shutdown responsive."""
        d = self.delay(attempt)
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            d = min(d, remaining)
        if stop_event is not None:
            return not stop_event.wait(d)
        time.sleep(d)
        return True
