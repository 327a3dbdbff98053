"""Preemption-safe shutdown (counterpart of
paddle_tpu/resilience/preemption.py): the SIGTERM/SIGINT grace handler.

:class:`PreemptionHandler` turns the signal into a checked flag. A loop
that opts in (``TrainLoop.run(preemption=...)``) finishes the step in
flight, writes a final checkpoint and exits with a ``preempted`` status
instead of dying mid-save; ``BatchedDecoder.run(preemption=...)`` stops
admitting and drains the requests in flight. The signal handler only
sets an Event. No handler is installed unless asked."""

from __future__ import annotations

import signal
import threading
from typing import Optional, Sequence

from .. import telemetry

_ACTIVE: Optional["PreemptionHandler"] = None


@telemetry.cached_instruments
def _preempt_metrics(reg):
    return {
        "signals": reg.counter(
            "pt_preemptions_total",
            "preemption signals received by the grace handler"),
        "clean_exits": reg.counter(
            "pt_preempt_clean_exits_total",
            "drive loops that exited cleanly after a preemption "
            "signal (final checkpoint written / requests drained)"),
    }


class PreemptionHandler:
    """Grace handler for ``signals`` (default SIGTERM and SIGINT).

    ``install()`` swaps the process handlers in (main thread only, a
    CPython rule of ``signal.signal``) and makes this the ambient handler
    (:func:`active`); ``uninstall()`` restores what was there.
    ``requested()`` is what loops poll between steps; ``request()`` sets
    the flag without a signal (notices, tests)."""

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,
                                                 signal.SIGINT)):
        self.signals = tuple(signals)
        self.received_signal: Optional[int] = None
        self._requested = threading.Event()
        self._counted = False
        self._prev: Optional[dict] = None
        self._prev_active: Optional["PreemptionHandler"] = None

    def install(self) -> "PreemptionHandler":
        global _ACTIVE
        if self._prev is not None:
            return self
        prev = {s: signal.getsignal(s) for s in self.signals}
        for s in self.signals:
            signal.signal(s, self._on_signal)
        self._prev = prev
        self._prev_active, _ACTIVE = _ACTIVE, self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        if self._prev is None:
            return
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev = None
        if _ACTIVE is self:
            _ACTIVE = self._prev_active
        self._prev_active = None

    @property
    def installed(self) -> bool:
        return self._prev is not None

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _on_signal(self, signum, frame) -> None:
        # async-signal-safe: record and set, nothing else
        self.received_signal = signum
        self._requested.set()

    def request(self) -> None:
        """Flag a preemption without a signal."""
        self._requested.set()

    def requested(self) -> bool:
        r = self._requested.is_set()
        if r and not self._counted and telemetry.enabled():
            # counted here, never in _on_signal: the counter takes a lock
            # the interrupted thread may hold
            self._counted = True
            _preempt_metrics()["signals"].inc()
        return r

    def clear(self) -> None:
        """Reset the flag (a new run after a handled preemption)."""
        self._requested.clear()
        self.received_signal = None
        self._counted = False

    def statusz(self) -> dict:
        return {"installed": self.installed,
                "requested": self.requested(),
                "received_signal": self.received_signal,
                "signals": [int(s) for s in self.signals]}


def active() -> Optional[PreemptionHandler]:
    """The installed ambient handler, or None."""
    return _ACTIVE
