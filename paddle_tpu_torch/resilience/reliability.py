"""Request reliability plane (counterpart of
paddle_tpu/resilience/reliability.py, the same header and decisions):
deadlines, retry budgets, hedging, quarantine.

The serving fleet already survives *crash* failures (SIGKILL chaos, death
failover, elastic restart).  This module covers the harder case: a replica
that is merely **slow or wedged** — SIGSTOP, GC stall, compile storm, a bad
host.  Four classic tail-tolerance mechanisms, all deterministic on CPU via
the FaultInjector (``router.latency`` / ``replica.wedge`` points):

**End-to-end deadlines.**  A :class:`Deadline` is minted at ``Router.submit``
from the request's SLO class and propagated on every hop: in-process via a
contextvar (:func:`bind` / :func:`current`, same shape as trace binding),
cross-process via the ``X-PT-Deadline`` header beside ``X-PT-Trace``, and
through the ``KVHandoff`` npz wire for disaggregated prefill.  Expired work
is dropped with a typed :class:`DeadlineExceededError` — a cause-labeled
shed, never silently computed.  Deadlines are *absolute wall-clock* epochs
(``time.time``) so they survive process boundaries; skew between hosts on
one box is negligible versus second-scale budgets.

**Retry budgets.**  Router retries draw from a token bucket
(:class:`RetryBudget`) refilled as a fraction of successful requests —
the SRE "retry budget" pattern.  When the bucket is dry a failed request
degrades to a single typed :class:`RetryBudgetExhaustedError` instead of
amplifying a replica failure into a retry storm.

**Hedged dispatch.**  Short requests stuck past an adaptive p95 latency
threshold (:class:`LatencyTracker`) get a second dispatch on another
replica; the first result wins and the loser's result is discarded.

**Gray-failure quarantine.**  Per-replica :class:`ReplicaHealth` scores —
dispatch-latency EWMA vs the fleet median, queue-depth outliers, and
consecutive timeouts — drive a circuit breaker (closed → open → half-open
probe with a cheap warmed request).  Quarantined replicas leave placement
and affinity but keep draining in-flight work; the autoscaler reads
quarantine as capacity loss.

Zero-cost when disabled: ``Router(reliability=None)`` (the default) leaves
only ``is None`` checks on the hot path, the same discipline as telemetry.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time

from ..core import EnforceError

__all__ = [
    "DEADLINE_HEADER",
    "Deadline",
    "DeadlineExceededError",
    "RetryBudgetExhaustedError",
    "RetryBudget",
    "LatencyTracker",
    "ReplicaHealth",
    "ReliabilityConfig",
    "ReliabilityPlane",
    "bind",
    "current",
    "statusz_section",
]

# Kept in sync with telemetry.tracing.TRACE_HEADER ("X-PT-Trace") — the
# deadline rides beside the trace context on every HTTP hop.
DEADLINE_HEADER = "X-PT-Deadline"


class DeadlineExceededError(EnforceError):
    """Request's end-to-end deadline expired before it could complete."""

    http_status = 504


class RetryBudgetExhaustedError(EnforceError):
    """Retry budget is dry: the failure is surfaced instead of retried."""

    http_status = 503


class Deadline:
    """Absolute wall-clock deadline carried with one request end-to-end.

    ``t_end`` is a ``time.time()`` epoch so the value means the same thing
    in the router process, an HTTP replica worker, and a prefill worker.
    """

    __slots__ = ("t_end",)

    def __init__(self, t_end):
        self.t_end = float(t_end)

    @classmethod
    def after(cls, budget_s):
        """Mint a deadline ``budget_s`` seconds from now."""
        return cls(time.time() + float(budget_s))

    def remaining(self):
        """Seconds left (negative once expired)."""
        return self.t_end - time.time()

    def expired(self):
        return time.time() >= self.t_end

    def check(self, what="request"):
        """Raise :class:`DeadlineExceededError` if expired."""
        over = time.time() - self.t_end
        if over >= 0.0:
            raise DeadlineExceededError(
                f"deadline exceeded for {what}: {over * 1e3:.1f} ms past budget"
            )

    def to_header(self):
        return repr(self.t_end)

    @classmethod
    def from_header(cls, header):
        """Parse an ``X-PT-Deadline`` header value; None on garbage."""
        try:
            return cls(float(header))
        except (TypeError, ValueError):
            return None

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Deadline(remaining={self.remaining():+.3f}s)"


# -- in-process propagation (mirrors telemetry.tracing bind/current) ---------

_current: contextvars.ContextVar = contextvars.ContextVar(
    "pt_deadline", default=None
)


@contextlib.contextmanager
def bind(deadline):
    """Bind ``deadline`` as the ambient deadline for the enclosed work."""
    tok = _current.set(deadline)
    try:
        yield deadline
    finally:
        _current.reset(tok)


def current():
    """The ambient :class:`Deadline`, or None when unbound/disabled."""
    return _current.get()


# -- retry budget ------------------------------------------------------------


class RetryBudget:
    """Token bucket bounding retry amplification, SRE-style.

    Each retry spends one token; each *successful* request refills
    ``refill_fraction`` of a token (so sustained retries are bounded to
    roughly that fraction of successful traffic).  Starts full: a burst of
    up to ``capacity`` retries is always available after quiet periods.
    """

    def __init__(self, capacity=10.0, refill_fraction=0.1):
        self.capacity = float(capacity)
        self.refill_fraction = float(refill_fraction)
        self.tokens = float(capacity)
        self.spent = 0
        self.exhausted = 0
        self._mu = threading.Lock()

    def take(self):
        """Spend one token; False (and counted) when the bucket is dry."""
        with self._mu:
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                self.spent += 1
                return True
            self.exhausted += 1
            return False

    def note_success(self):
        with self._mu:
            self.tokens = min(self.capacity, self.tokens + self.refill_fraction)

    def snapshot(self):
        with self._mu:
            return {
                "tokens": round(self.tokens, 3),
                "capacity": self.capacity,
                "spent": self.spent,
                "exhausted": self.exhausted,
            }


# -- adaptive hedge threshold ------------------------------------------------


class LatencyTracker:
    """Ring buffer of request latencies exposing an adaptive quantile.

    Used for the hedge trigger: a request older than ``threshold()``
    (fleet p95 by default) is presumed stuck and worth hedging.
    """

    def __init__(self, window=256, min_samples=20, quantile=0.95):
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.quantile = float(quantile)
        self._buf = [0.0] * self.window
        self._n = 0
        self._i = 0
        self._mu = threading.Lock()

    def observe(self, seconds):
        with self._mu:
            self._buf[self._i] = float(seconds)
            self._i = (self._i + 1) % self.window
            if self._n < self.window:
                self._n += 1

    def threshold(self):
        """Current quantile latency, or None until warm."""
        with self._mu:
            if self._n < self.min_samples:
                return None
            vals = sorted(self._buf[: self._n])
        k = min(len(vals) - 1, int(self.quantile * len(vals)))
        return vals[k]

    def count(self):
        with self._mu:
            return self._n


# -- per-replica circuit breaker --------------------------------------------


class ReplicaHealth:
    """Gray-failure score + circuit breaker for one replica.

    States: ``closed`` (healthy) → ``open`` (quarantined; no placement)
    → ``half_open`` (one cheap probe in flight) → ``closed`` on probe
    success or back to ``open`` on failure.
    """

    def __init__(self, name, alpha=0.3):
        self.name = name
        self.alpha = float(alpha)
        self.state = "closed"
        self.latency_ewma = None  # dispatch→first-result latency, seconds
        self.queue_ewma = None  # replica-reported queue depth
        self.timeouts = 0  # consecutive timeouts/errors
        self.samples = 0
        self.t_open = 0.0  # monotonic time the breaker opened
        self.opened_count = 0
        self.last_reason = None

    def note_latency(self, seconds):
        s = float(seconds)
        if self.latency_ewma is None:
            self.latency_ewma = s
        else:
            self.latency_ewma += self.alpha * (s - self.latency_ewma)
        self.samples += 1
        self.timeouts = 0

    def note_queue(self, depth):
        d = float(depth)
        if self.queue_ewma is None:
            self.queue_ewma = d
        else:
            self.queue_ewma += self.alpha * (d - self.queue_ewma)

    def note_timeout(self):
        self.timeouts += 1

    def trip(self, reason):
        self.state = "open"
        self.t_open = time.monotonic()
        self.opened_count += 1
        self.last_reason = reason
        self.timeouts = 0

    def probe_due(self, cooldown_s, now=None):
        if self.state != "open":
            return False
        now = time.monotonic() if now is None else now
        return (now - self.t_open) >= cooldown_s

    def half_open(self):
        self.state = "half_open"

    def close(self):
        self.state = "closed"
        self.latency_ewma = None
        self.queue_ewma = None
        self.timeouts = 0
        self.samples = 0

    def reopen(self):
        """Failed half-open probe: back to open, cooldown restarts."""
        self.state = "open"
        self.t_open = time.monotonic()

    def snapshot(self):
        return {
            "state": self.state,
            "latency_ewma_s": (
                round(self.latency_ewma, 6) if self.latency_ewma is not None else None
            ),
            "queue_ewma": (
                round(self.queue_ewma, 3) if self.queue_ewma is not None else None
            ),
            "timeouts": self.timeouts,
            "samples": self.samples,
            "opened": self.opened_count,
            "reason": self.last_reason,
        }


# -- plane -------------------------------------------------------------------


class ReliabilityConfig:
    """Knobs for the reliability plane.  All times in seconds."""

    def __init__(
        self,
        deadline_s=None,
        deadline_factor=10.0,
        retry_budget=10.0,
        retry_refill=0.1,
        hedge=True,
        hedge_factor=1.0,
        hedge_min_samples=20,
        hedge_max_new=64,
        outlier_factor=3.0,
        min_outlier_latency_s=0.05,
        consecutive_timeouts=3,
        quarantine_cooldown_s=2.0,
        probe_timeout_s=5.0,
        ewma_alpha=0.3,
    ):
        # Default request budget; None → deadline_factor × the SLO class
        # target TTFT (and no deadline at all when neither is set).
        self.deadline_s = deadline_s
        self.deadline_factor = float(deadline_factor)
        self.retry_budget = float(retry_budget)
        self.retry_refill = float(retry_refill)
        self.hedge = bool(hedge)
        self.hedge_factor = float(hedge_factor)
        self.hedge_min_samples = int(hedge_min_samples)
        self.hedge_max_new = int(hedge_max_new)
        self.outlier_factor = float(outlier_factor)
        # Ignore outlier math below this absolute latency: a 3x outlier on
        # a 2 ms fleet median is noise, not gray failure.
        self.min_outlier_latency_s = float(min_outlier_latency_s)
        self.consecutive_timeouts = int(consecutive_timeouts)
        self.quarantine_cooldown_s = float(quarantine_cooldown_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.ewma_alpha = float(ewma_alpha)


class ReliabilityPlane:
    """Aggregate reliability state for one Router.

    Owns the retry budget, the fleet latency tracker feeding the hedge
    threshold, and per-replica breakers.  The Router consults it at
    submit/dispatch/requeue/poll time; everything here is thread-safe and
    cheap (no locks held across I/O).
    """

    def __init__(self, config=None):
        self.config = config if config is not None else ReliabilityConfig()
        self.budget = RetryBudget(
            capacity=self.config.retry_budget,
            refill_fraction=self.config.retry_refill,
        )
        self.latency = LatencyTracker(min_samples=self.config.hedge_min_samples)
        self._health = {}
        self._mu = threading.Lock()
        # Counters mirrored into telemetry when enabled; kept locally so
        # /statusz works (and tests can assert) with telemetry off.
        self.deadline_exceeded = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.quarantines = 0

    # -- deadlines ----------------------------------------------------------

    def deadline_for(self, target_ttft_s=None, budget_s=None):
        """Mint the Deadline for a new request, or None when unbudgeted.

        Priority: explicit per-class ``budget_s`` → config ``deadline_s``
        → ``deadline_factor`` × the SLO target TTFT.
        """
        if budget_s is None:
            budget_s = self.config.deadline_s
        if budget_s is None and target_ttft_s:
            budget_s = self.config.deadline_factor * float(target_ttft_s)
        if budget_s is None:
            return None
        return Deadline.after(budget_s)

    # -- per-replica health --------------------------------------------------

    def health(self, name):
        with self._mu:
            h = self._health.get(name)
            if h is None:
                h = self._health[name] = ReplicaHealth(
                    name, alpha=self.config.ewma_alpha
                )
            return h

    def drop(self, name):
        with self._mu:
            self._health.pop(name, None)

    def fleet_median_latency(self):
        """Median dispatch-latency EWMA across closed replicas, or None.

        Even-sized fleets take the LOWER middle: in a 2-replica fleet
        the upper middle IS the slow replica, which would make its own
        outlier test vacuous.
        """
        with self._mu:
            vals = sorted(
                h.latency_ewma
                for h in self._health.values()
                if h.latency_ewma is not None and h.state == "closed"
            )
        if not vals:
            return None
        return vals[(len(vals) - 1) // 2]

    def quarantine_reason(self, health, fleet_median=None):
        """Why ``health`` should trip now, or None if it looks fine.

        Signals, in priority order: consecutive timeouts, dispatch-latency
        EWMA outlier vs the fleet median, queue-depth outlier vs fleet
        median queue depth.  Outlier math requires ≥ 2 scored replicas so a
        lone replica can never self-quarantine.
        """
        cfg = self.config
        if health.state != "closed":
            return None
        if health.timeouts >= cfg.consecutive_timeouts:
            return f"timeouts={health.timeouts}"
        if fleet_median is None:
            fleet_median = self.fleet_median_latency()
        if (
            fleet_median is not None
            and health.latency_ewma is not None
            and health.samples >= 3
            and health.latency_ewma >= cfg.min_outlier_latency_s
            and health.latency_ewma > cfg.outlier_factor * fleet_median
        ):
            with self._mu:
                n_scored = sum(
                    1 for h in self._health.values() if h.latency_ewma is not None
                )
            if n_scored >= 2:
                return (
                    f"latency_outlier ewma={health.latency_ewma:.3f}s "
                    f"median={fleet_median:.3f}s"
                )
        q_med = self._fleet_median_queue()
        if (
            q_med is not None
            and health.queue_ewma is not None
            and health.queue_ewma >= 2.0
            and health.queue_ewma > cfg.outlier_factor * max(q_med, 1.0)
        ):
            return f"queue_outlier ewma={health.queue_ewma:.1f} median={q_med:.1f}"
        return None

    def _fleet_median_queue(self):
        with self._mu:
            vals = sorted(
                h.queue_ewma
                for h in self._health.values()
                if h.queue_ewma is not None and h.state == "closed"
            )
        if len(vals) < 2:
            return None
        return vals[(len(vals) - 1) // 2]

    # -- hedging -------------------------------------------------------------

    def hedge_threshold(self):
        """Adaptive hedge trigger in seconds, or None while cold/disabled."""
        if not self.config.hedge:
            return None
        t = self.latency.threshold()
        if t is None:
            return None
        return t * self.config.hedge_factor

    # -- introspection -------------------------------------------------------

    def statusz(self):
        with self._mu:
            health = {n: h.snapshot() for n, h in sorted(self._health.items())}
        return {
            "budget": self.budget.snapshot(),
            "hedge_threshold_s": self.hedge_threshold(),
            "latency_samples": self.latency.count(),
            "deadline_exceeded": self.deadline_exceeded,
            "hedges": self.hedges,
            "hedge_wins": self.hedge_wins,
            "quarantines": self.quarantines,
            "replicas": health,
        }


def statusz_section():
    """Placeholder-free /statusz hook: reliability state lives per-Router
    (see ``Router.stats()``); this module-level section only documents the
    header contract so operators can discover it."""
    return {"deadline_header": DEADLINE_HEADER}
