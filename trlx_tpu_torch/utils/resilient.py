"""Retry with backoff and a circuit breaker for the train loop's two
external calls, the tracker backend and the user's reward function (port
of the part of trlx_tpu.utils.resilient those calls use).

  compute_backoff  doubling from a base delay, capped, +-jitter.
  retry_call       re-tries a failing call with that backoff; the final
                   failure re-raises, so the caller decides whether the
                   call is load-bearing (reward_fn) or droppable
                   (tracker.log). The sleep and the jitter RNG are
                   injectable, so tests never really sleep.
  CircuitBreaker   closed -> open after N consecutive failures; open
                   rejects until ``reset_timeout`` has passed, then lets
                   one half-open probe through. ``reset_timeout=0`` gives
                   one un-retried probe per call (the tracker's circuit).

The per-attempt deadline (`call_with_deadline`) and the fallback reward
(`ResilientCaller`, `train.resilient_io`) come with the robustness tier
(ROADMAP queue 1, item [10]).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

# jitter from an OS-entropy RNG, not the `random` module that set_seed
# seeds with the run's seed: relaunched jobs must not back off in lockstep
_JITTER_RNG = random.Random()


class ChaosFault(RuntimeError):
    """An injected fault (utils/chaos.py), type-distinct so tests can tell
    injected failures from real ones."""


class CircuitOpenError(RuntimeError):
    """The circuit breaker rejected the call without attempting it."""


def compute_backoff(attempt: int, base_delay: float, max_delay: float = 8.0, jitter: float = 0.25,
                    rng: Optional[random.Random] = None) -> float:
    """Delay before re-try number ``attempt`` (0-based): doubling from
    ``base_delay``, capped at ``max_delay``, +-``jitter`` fraction."""
    rng = rng or _JITTER_RNG
    delay = min(base_delay * (2 ** attempt), max_delay)
    delay *= 1.0 + rng.uniform(-jitter, jitter)
    return max(delay, 0.0)


def retry_call(fn: Callable, *args, retries: int = 3, base_delay: float = 0.5, max_delay: float = 8.0,
               jitter: float = 0.25, description: Optional[str] = None, sleep: Callable[[float], None] = time.sleep,
               rng: Optional[random.Random] = None, **kwargs):
    """``fn(*args, **kwargs)``, re-tried ``retries`` times after the first
    attempt with `compute_backoff` delays; the final failure re-raises."""
    what = description or getattr(fn, "__name__", repr(fn))
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            if attempt >= retries:
                logger.error("%s failed after %d attempts: %s", what, attempt + 1, e)
                raise
            delay = compute_backoff(attempt, base_delay, max_delay, jitter, rng)
            logger.warning("%s failed (attempt %d/%d): %s; retrying in %.2fs", what, attempt + 1, retries + 1,
                           e, delay)
            sleep(delay)


class CircuitBreaker:
    """Consecutive-failure circuit with half-open recovery.

    Closed: every call is allowed. After ``failure_threshold`` consecutive
    ``record_failure`` calls it opens: ``allow()`` is False until
    ``reset_timeout`` seconds pass on ``clock``, then one half-open probe
    is allowed; ``record_success`` closes the circuit, ``record_failure``
    re-opens it."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 3, reset_timeout: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self._clock = clock
        self._failures = 0
        self._state = self.CLOSED
        self._opened_at = 0.0

    @property
    def state(self) -> str:
        if self._state == self.OPEN and self._clock() - self._opened_at >= self.reset_timeout:
            return self.HALF_OPEN
        return self._state

    @property
    def is_closed(self) -> bool:
        return self.state == self.CLOSED

    def allow(self) -> bool:
        """Whether a call may proceed (open -> half-open once the reset
        timeout has passed)."""
        st = self.state
        if st == self.HALF_OPEN:
            self._state = self.HALF_OPEN
            return True
        return st == self.CLOSED

    def record_success(self) -> None:
        self._failures = 0
        self._state = self.CLOSED

    def record_failure(self) -> None:
        self._failures += 1
        if self._state == self.HALF_OPEN or self._failures >= self.failure_threshold:
            self._state = self.OPEN
            self._opened_at = self._clock()
