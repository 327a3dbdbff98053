"""Deterministic fault injection (counterpart of
paddle_tpu/resilience/faults.py): the substrate the chaos tests drive
to show that a kill or a torn write at any checkpoint step resumes at
the last committed one.

A :class:`FaultInjector` holds per-point rules (raise, corrupt, delay)
on a seeded, repeatable schedule and is armed process-wide with
``inj.arm()`` or ``with inj:``. Call-sites resolve :func:`active` once
per operation and pass their I/O through :meth:`FaultInjector.fire`;
with no injector armed they see ``None`` and do nothing else.

Injection points (:data:`POINTS`), the JAX package's:

- ``ckpt.write``    each checkpoint leaf file write
- ``ckpt.manifest`` the manifest write
- ``ckpt.stage``    a coordinated save's stage phase
  (``CheckpointManager(coordinator=)``)
- ``ckpt.commit``   a coordinated save's commit phase (same)
- ``restore.read``  each checkpoint file read
- ``step.nan``      the training step's loss (corrupt -> NaN)
- ``io.slow``       any checkpoint file I/O (delay rules)
- ``fleet.notice``  each poll of the fleet controller's notice watcher
  (a ``corrupt`` rule is a synthetic preemption notice)
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, Optional

from ..core.enforce import enforce

POINTS = ("ckpt.write", "ckpt.manifest", "ckpt.stage", "ckpt.commit",
          "restore.read", "step.nan", "io.slow", "fleet.notice")

_ACTIVE: Optional["FaultInjector"] = None
_LOCK = threading.Lock()


class FaultError(OSError):
    """The default injected error: an OSError, so the retry layer treats
    it as the transient I/O fault it simulates."""


class FaultInjector:
    """Seeded, deterministic fault schedule over named points.

    Rules (one per point, the latest :meth:`on` wins): ``at=(3, 5)``
    fires on those 1-based call indices; ``prob=0.2`` fires with that
    probability from the injector's own seeded RNG; ``times=N`` caps the
    fires (None = unlimited); with neither ``at`` nor ``prob`` every call
    fires. Effects: ``error=`` raise it (class or instance; default
    :class:`FaultError`), ``delay_s=`` sleep first, ``corrupt=True`` flip
    one byte of the payload instead of raising (``step.nan``: poison the
    loss)."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = random.Random(seed)
        self._rules: Dict[str, Dict[str, Any]] = {}
        self.calls: Dict[str, int] = {p: 0 for p in POINTS}
        self.fired: Dict[str, int] = {p: 0 for p in POINTS}

    def on(self, point: str, *, error=None, prob: float = 0.0, at=(),
           times: Optional[int] = None, delay_s: float = 0.0,
           corrupt: bool = False,
           match: Optional[str] = None) -> "FaultInjector":
        """Install the rule for ``point`` (returns self). ``match``: fire
        only when the call-site's ``path`` contains this substring."""
        enforce(point in POINTS, "unknown injection point %r (have %s)",
                point, ", ".join(POINTS))
        enforce(0.0 <= prob <= 1.0, "prob must be in [0, 1], got %s", prob)
        self._rules[point] = {
            "error": error, "prob": float(prob),
            "at": frozenset(int(i) for i in at), "times": times,
            "delay_s": float(delay_s), "corrupt": bool(corrupt),
            "match": match,
        }
        return self

    def arm(self) -> "FaultInjector":
        """Make this the process's active injector (one at a time)."""
        global _ACTIVE
        with _LOCK:
            enforce(_ACTIVE is None or _ACTIVE is self,
                    "another FaultInjector is already armed")
            _ACTIVE = self
        return self

    def disarm(self) -> None:
        global _ACTIVE
        with _LOCK:
            if _ACTIVE is self:
                _ACTIVE = None

    def __enter__(self) -> "FaultInjector":
        return self.arm()

    def __exit__(self, *exc) -> None:
        self.disarm()

    def _should_fire(self, rule, n: int) -> bool:
        if rule["times"] is not None and rule["times"] <= 0:
            return False
        if rule["at"]:
            return n in rule["at"]
        if rule["prob"] > 0.0:
            return self._rng.random() < rule["prob"]
        return True

    def fire(self, point: str, *, data: Optional[bytes] = None,
             path: Optional[str] = None):
        """Run ``point``'s rule for this call: returns ``data`` (one byte
        flipped under ``corrupt``) when given, else whether it fired;
        raising rules raise. Every call advances the point's index,
        whether or not a rule fires."""
        self.calls[point] = n = self.calls.get(point, 0) + 1
        rule = self._rules.get(point)
        quiet = data if data is not None else False
        if rule is None or (rule["match"] is not None and (
                path is None or rule["match"] not in path)):
            return quiet
        if not self._should_fire(rule, n):
            return quiet
        if rule["times"] is not None:
            rule["times"] -= 1
        self.fired[point] = self.fired.get(point, 0) + 1
        if rule["delay_s"] > 0.0:
            time.sleep(rule["delay_s"])
        if rule["corrupt"]:
            if data is not None:
                data = bytes(data)
                i = len(data) // 2
                return data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]
            return True
        if rule["error"] is not None or not rule["delay_s"]:
            err = rule["error"]
            if err is None:
                err = FaultError(f"injected fault at {point} (call {n}, "
                                 f"path={path})")
            elif isinstance(err, type):
                err = err(f"injected fault at {point} (call {n})")
            raise err
        return data if data is not None else True


def active() -> Optional[FaultInjector]:
    """The armed injector, or None."""
    return _ACTIVE
