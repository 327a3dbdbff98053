"""Bounded retry for transient I/O (counterpart of
paddle_tpu/resilience/retry.py): capped exponential backoff with
seeded jitter, bounded by a deadline. Checkpoint save and restore wrap
every file operation in :func:`retry_io`; a transient ``OSError`` costs
a short backoff, while deterministic errors (checksum mismatches,
enforce failures) propagate at once. ``pt_retry_total`` counts absorbed
faults and ``pt_retry_exhausted_total`` operations that failed after the
budget, both only while telemetry is enabled."""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

from .. import telemetry
from ..core.enforce import enforce

T = TypeVar("T")


@telemetry.cached_instruments
def _retry_metrics(reg):
    return {
        "retries": reg.counter(
            "pt_retry_total",
            "transient I/O errors absorbed by resilience.retry"),
        "exhausted": reg.counter(
            "pt_retry_exhausted_total",
            "operations that failed after the full retry budget"),
    }


class RetryPolicy:
    """Up to ``max_attempts`` tries, sleeping ``base_delay_s * 2^k``
    (capped at ``max_delay_s``) plus up to ``jitter`` of that, never
    past ``deadline_s`` in all. The jitter's RNG is seeded, so the same
    failure schedule backs off the same way every run."""

    def __init__(self, max_attempts: int = 4, base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0, deadline_s: float = 30.0,
                 retry_on: Tuple[Type[BaseException], ...] = (OSError,),
                 jitter: float = 0.5, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        enforce(max_attempts >= 1, "max_attempts must be >= 1, got %s",
                max_attempts)
        enforce(deadline_s > 0, "deadline_s must be > 0, got %s",
                deadline_s)
        self.max_attempts = max_attempts
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.deadline_s = deadline_s
        self.retry_on = tuple(retry_on)
        self.jitter = jitter
        self.seed = seed
        self._rng = random.Random(seed)
        self._sleep = sleep

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based)."""
        base = min(self.base_delay_s * (2.0 ** (attempt - 1)),
                   self.max_delay_s)
        return base * (1.0 + self.jitter * self._rng.random())


DEFAULT_POLICY = RetryPolicy()


def retry_io(fn: Callable[[], T], *, policy: Optional[RetryPolicy] = None,
             what: str = "io") -> T:
    """Run ``fn`` under ``policy`` (default :data:`DEFAULT_POLICY`),
    retrying only ``policy.retry_on`` errors; the last error re-raises
    once the attempts run out or the next backoff would cross the
    deadline. ``what`` names the operation."""
    policy = policy or DEFAULT_POLICY
    t0 = time.monotonic()
    attempt = 0
    while True:
        try:
            return fn()
        except policy.retry_on:
            attempt += 1
            delay = policy.backoff_s(attempt)
            if (attempt >= policy.max_attempts
                    or time.monotonic() - t0 + delay > policy.deadline_s):
                if telemetry.enabled():
                    _retry_metrics()["exhausted"].inc()
                raise
            if telemetry.enabled():
                _retry_metrics()["retries"].inc()
            policy._sleep(delay)
