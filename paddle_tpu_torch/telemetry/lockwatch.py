"""Runtime lock-order watchdog (counterpart of
paddle_tpu/telemetry/lockwatch.py): the dynamic companion to a static
lock-order model.

The static pass names every lock order that is *structurally possible*;
this module records the orders that actually *execute*. A
:class:`WatchedLock` wraps a real ``threading.Lock``/``RLock`` and, when
the watchdog is enabled, records each acquisition against the acquiring
thread's held set: acquiring B while holding A adds the edge ``A -> B``
to the process-global order graph, stamped with a bounded witness stack.
The first acquisition that closes a cycle (B taken under A after some
thread took A under B) is a **real inversion** — the watchdog reports it
with BOTH witness stacks (the acquisition that just closed the cycle and
the prior acquisition that established the reverse path), which is the
pair of call paths a deadlock postmortem takes hours to reconstruct.

:meth:`LockOrderWatchdog.verify_static` closes the loop with the static
plane: feed it a static ``(A, B) -> witness`` edge map (the JAX
package's ``analysis.concurrency.lock_order_graph`` produces one; the
port carries no static pass of its own) and it reports every observed edge the static model missed ("unmodeled"
— the pass's blind spots, usually a lock passed across modules) next to
the inversions.

Zero-cost when disabled (the telemetry discipline): a
:class:`WatchedLock` with no watchdog enabled delegates straight to the
wrapped lock — one module-global ``is None`` check, no recording, no
stack capture, no fault-point consultation (test-pinned). The
``lock.acquire`` fault-injection point (``resilience/faults.py``) fires
only while the watchdog is enabled: chaos tests arm a seeded delay rule
on one lock name to force two racing threads into a deterministic
inversion window, then assert the watchdog caught it with both stacks.

Usage::

    from paddle_tpu_torch.telemetry import lockwatch
    wd = lockwatch.enable()
    a = lockwatch.WatchedLock("Router._mu")
    b = lockwatch.WatchedLock("Replica._mu")
    ... run the workload under test ...
    wd.violations          # inversions, with witness stack pairs
    wd.verify_static(static_edges)
    lockwatch.disable()
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core.enforce import enforce

# process-global watchdog; None = disabled (the zero-cost gate every
# WatchedLock checks — one global read, nothing else, when off)
_WATCHDOG: Optional["LockOrderWatchdog"] = None

# frames kept per witness stack (bounded: a watchdog that OOMs the
# process it watches has failed at its one job)
_STACK_LIMIT = 16


def _capture_stack() -> List[str]:
    """Bounded, pre-rendered witness stack for the CURRENT call site
    (this module's own frames trimmed)."""
    frames = traceback.format_stack(limit=_STACK_LIMIT)
    return [f.rstrip() for f in frames
            if "telemetry/lockwatch" not in f.replace("\\", "/")]


class LockOrderWatchdog:
    """Process-global acquisition-order recorder + cycle detector.

    ``raise_on_inversion=True`` raises :class:`LockOrderError` at the
    acquisition that closes the cycle (tests); the default records into
    :attr:`violations` and lets the workload run — an inversion is a
    *future* deadlock, and killing the present run is the caller's
    policy decision.
    """

    def __init__(self, raise_on_inversion: bool = False):
        self.raise_on_inversion = raise_on_inversion
        self._mu = threading.Lock()
        # (A, B) -> first-witness record for "B acquired while A held"
        self._edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._counts: Dict[Tuple[str, str], int] = {}
        self._tls = threading.local()
        self.violations: List[Dict[str, Any]] = []

    # -- per-thread held stack ----------------------------------------------

    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    # -- recording ----------------------------------------------------------

    def note_acquire(self, name: str) -> None:
        """Called by :class:`WatchedLock` AFTER the underlying acquire
        succeeded. Records edges from every lock this thread already
        holds and checks each new edge for a cycle."""
        held = self._held()
        new_edges = [(h, name) for h in held if h != name]
        held.append(name)
        if not new_edges:
            return
        stack = _capture_stack()
        tname = threading.current_thread().name
        with self._mu:
            for edge in new_edges:
                self._counts[edge] = self._counts.get(edge, 0) + 1
                known = edge in self._edges
                if not known:
                    self._edges[edge] = {
                        "edge": edge, "thread": tname, "stack": stack}
                    self._check_cycle_locked(edge, stack, tname)

    def note_release(self, name: str) -> None:
        held = self._held()
        # release order may not mirror acquire order (lock A, lock B,
        # release A): drop the LAST occurrence
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def _check_cycle_locked(self, edge: Tuple[str, str],
                            stack: List[str], tname: str) -> None:
        """Does the graph now reach edge[0] from edge[1]? BFS over the
        small edge set; on a hit, record the violation with both
        witness stacks (the closing edge's and the reverse path's
        first edge's)."""
        a, b = edge
        adj: Dict[str, List[str]] = {}
        for (x, y) in self._edges:
            adj.setdefault(x, []).append(y)
        path = self._path_locked(adj, b, a)
        if path is None:
            return
        back_edges = list(zip(path, path[1:]))
        prior = self._edges.get(back_edges[0])
        violation = {
            "cycle": [a, b] if len(path) == 2 else [a] + path,
            "edge": edge,
            "thread": tname,
            "witness": stack,
            "prior_edge": back_edges[0],
            "prior_thread": prior["thread"] if prior else None,
            "prior_witness": prior["stack"] if prior else [],
        }
        self.violations.append(violation)
        if self.raise_on_inversion:
            raise LockOrderError(
                f"lock-order inversion: {a} -> {b} (thread {tname}) "
                f"closes a cycle against {back_edges[0]} (thread "
                f"{violation['prior_thread']}); see .violations for "
                f"both witness stacks")

    @staticmethod
    def _path_locked(adj: Dict[str, List[str]], start: str,
                     goal: str) -> Optional[List[str]]:
        work = [(start, [start])]
        seen = {start}
        while work:
            cur, p = work.pop(0)
            for nxt in adj.get(cur, ()):
                if nxt == goal:
                    return p + [nxt]
                if nxt not in seen:
                    seen.add(nxt)
                    work.append((nxt, p + [nxt]))
        return None

    # -- reporting ----------------------------------------------------------

    def edges(self) -> Dict[Tuple[str, str], int]:
        """Observed acquisition-order edges -> acquisition count."""
        with self._mu:
            return dict(self._counts)

    def report(self) -> Dict[str, Any]:
        with self._mu:
            return {
                "edges": {f"{a} -> {b}": n
                          for (a, b), n in sorted(self._counts.items())},
                "violations": list(self.violations),
            }

    def verify_static(self, static_graph: Dict[Tuple[str, str], Any],
                      ) -> Dict[str, Any]:
        """Validate the static lock graph against observed reality.

        ``static_graph``: the ``(A, B) -> witness`` mapping from
        a static lock-order pass (or any edge set using the same lock names
        as the WatchedLocks).
        Returns ``unmodeled`` (edges that EXECUTED but the static pass
        never predicted — its blind spots, each with the runtime
        witness) and ``violations`` (the inversions). An empty
        ``unmodeled`` list means the static graph is a sound
        over-approximation of everything this run did."""
        static_edges = set(static_graph)
        with self._mu:
            unmodeled = [
                {"edge": e, "thread": rec["thread"],
                 "witness": rec["stack"]}
                for e, rec in sorted(self._edges.items())
                if e not in static_edges]
            return {"unmodeled": unmodeled,
                    "violations": list(self.violations)}


class LockOrderError(RuntimeError):
    """Raised (opt-in) at the acquisition that closes an order cycle."""


class WatchedLock:
    """A named lock that reports acquisition order to the enabled
    watchdog — and is EXACTLY the wrapped lock when none is enabled.

    ``name`` should match the static model's naming
    (``<module>:<Class.attr>``) when the run will be verified against
    a static lock-order graph;
    free-form names work for standalone watching. ``lock`` defaults to
    a fresh ``threading.Lock``; pass an ``RLock`` for re-entrant
    sections (re-acquiring the same name under itself records no
    self-edge)."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str, lock=None):
        enforce(bool(name), "WatchedLock needs a non-empty name")
        self.name = name
        self._lock = lock if lock is not None else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1
                ) -> bool:
        wd = _WATCHDOG
        if wd is None:  # disabled: delegate, record NOTHING
            return self._lock.acquire(blocking, timeout)
        from ..resilience import faults as _faults

        inj = _faults.active()
        if inj is not None:
            # chaos sequencing: a seeded delay rule on one lock name
            # stretches its acquire window so racing threads interleave
            # deterministically (raising rules model acquisition
            # failure paths)
            inj.fire("lock.acquire", path=self.name)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            try:
                wd.note_acquire(self.name)
            except LockOrderError:
                # raise-policy: the caller's `with` never enters, so
                # nobody would release — hand the lock back before
                # propagating (the violation is already recorded)
                wd.note_release(self.name)
                self._lock.release()
                raise
        return ok

    def release(self) -> None:
        wd = _WATCHDOG
        self._lock.release()
        if wd is not None:
            wd.note_release(self.name)

    def __enter__(self) -> "WatchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        fn = getattr(self._lock, "locked", None)
        if fn is not None:
            return bool(fn())
        # RLock grows .locked() only in 3.14 — approximate: owned by
        # this thread, or unacquirable (held elsewhere)
        owned = getattr(self._lock, "_is_owned", None)
        if owned is not None and owned():
            return True
        if self._lock.acquire(blocking=False):
            self._lock.release()
            return False
        return True


# ---------------------------------------------------------------------------
# module-level switch (the telemetry enable/disable discipline)
# ---------------------------------------------------------------------------


def enable(raise_on_inversion: bool = False) -> LockOrderWatchdog:
    """Install (or return) the process watchdog. Idempotent unless the
    policy changes — two disagreeing enables are a test bug, surfaced
    loudly."""
    global _WATCHDOG
    if _WATCHDOG is not None:
        enforce(_WATCHDOG.raise_on_inversion == raise_on_inversion,
                "lockwatch already enabled with raise_on_inversion=%s",
                _WATCHDOG.raise_on_inversion)
        return _WATCHDOG
    _WATCHDOG = LockOrderWatchdog(raise_on_inversion=raise_on_inversion)
    return _WATCHDOG


def disable() -> None:
    global _WATCHDOG
    _WATCHDOG = None


def active() -> Optional[LockOrderWatchdog]:
    """The enabled watchdog, or None (the common case — WatchedLock
    gates every recording behind this)."""
    return _WATCHDOG
