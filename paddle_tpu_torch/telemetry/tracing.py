"""Distributed request tracing (counterpart of
paddle_tpu/telemetry/tracing.py, the same header, span records and
chrome-trace merge, so either package reads the other's output): trace
contexts, cross-process span collection, and fleet fan-in merge.

The per-process span profiler (``telemetry.trace``) answers "what did
THIS process do recently"; this module answers the fleet question a
multi-replica serving deployment actually debugs with: *what happened
to request X, across every process it touched*. One request = one
**trace**: a 16-hex ``trace_id`` minted once at admission (the router)
plus a parent-span chain, propagated through every hop —

- in-process calls via a thread-local binding (:func:`bind` /
  :func:`current`),
- HTTP hops via the ``X-PT-Trace`` header (:data:`TRACE_HEADER`,
  ``TraceContext.to_header``/``from_header`` — a W3C-traceparent-shaped
  ``trace_id-span_id-flags`` triple),
- the prefill→decode ``serving.KVHandoff`` wire form (the handoff
  carries its producer's context, so in-process disaggregation needs
  no transport header).

Completed spans land in a bounded per-process ring
(:func:`spans`; served by ``/tracez``), each stamped with real
``pid``/``tid``/thread-name so the merged view gets proper lanes.

**Clock alignment.** Span timestamps are ``time.perf_counter_ns()``
(monotonic, process-local — meaningless across processes). Every
process therefore exports a clock handshake (:func:`clock`): one
``(wall_ns, perf_ns)`` pair sampled together. A merger rebases each
process's spans by ``wall_ns - perf_ns``, putting every span on the
shared wall clock; :func:`merge_chrome_trace` does exactly that and
emits one chrome-trace with ``process_name``/``thread_name`` metadata
lanes per (pid, tid).

**Sampling.** Head-based: the admission edge draws once per request
(:func:`new_trace`, rate :func:`sample_rate` — env ``PT_TRACE_SAMPLE``,
default 1.0) and the decision rides the context everywhere; an
unsampled context makes every downstream span/event a no-op, so the
enabled-but-load-shy configuration is one knob.

**Zero cost when disabled.** Instrumented call-sites check
``telemetry.enabled()`` before calling anything here (the same
contract as metrics — pinned by test); on top of that, spans with no
bound/sampled context are inert objects that record nothing.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

from . import metrics as _metrics

# the one wire header every cross-process hop carries (HTTP form)
TRACE_HEADER = "X-PT-Trace"

RING_SPANS = 4096  # completed spans kept per process (bounded)

_lock = threading.Lock()
_ring: "deque[Dict[str, Any]]" = deque(maxlen=RING_SPANS)
_tls = threading.local()

_sample_rate = float(os.environ.get("PT_TRACE_SAMPLE", "1.0"))


def sample_rate() -> float:
    """Head-based sampling probability (0..1) new traces are minted
    with. Default 1.0 (every request traced); env ``PT_TRACE_SAMPLE``
    or :func:`set_sample_rate` tune it for load."""
    return _sample_rate


def set_sample_rate(rate: float) -> None:
    global _sample_rate
    _sample_rate = min(1.0, max(0.0, float(rate)))


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class TraceContext:
    """One request's identity at one point in its span tree:
    ``trace_id`` (constant for the request's whole life) +
    ``span_id`` (the parent for whatever happens next) + the head-based
    ``sampled`` decision. Immutable by convention — children are new
    contexts minted by :class:`TraceSpan`."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)

    def to_header(self) -> str:
        """``trace_id-span_id-flags`` (flags: 01 sampled / 00 not)."""
        return (f"{self.trace_id}-{self.span_id}-"
                f"{'01' if self.sampled else '00'}")

    def __repr__(self) -> str:
        return f"TraceContext({self.to_header()})"


def from_header(header: Optional[str]) -> Optional[TraceContext]:
    """Parse the :data:`TRACE_HEADER` value; malformed headers return
    None (a bad peer must degrade to untraced, never 500 the hop)."""
    if not header:
        return None
    parts = str(header).strip().split("-")
    if len(parts) != 3 or not parts[0] or not parts[1]:
        return None
    return TraceContext(parts[0], parts[1], parts[2] == "01")


def new_trace(rate: Optional[float] = None,
              sampled: Optional[bool] = None) -> TraceContext:
    """Mint a request's root context (the admission edge). The
    sampling draw happens HERE, once — everything downstream just
    honors the flag."""
    if sampled is None:
        r = _sample_rate if rate is None else float(rate)
        sampled = r >= 1.0 or random.random() < r
    return TraceContext(_new_id(8), _new_id(4), sampled)


# -- thread-local binding ---------------------------------------------------

def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def current() -> Optional[TraceContext]:
    """The context bound to this thread (innermost), or None."""
    s = getattr(_tls, "stack", None)
    return s[-1] if s else None


@contextlib.contextmanager
def bind(ctx: Optional[TraceContext]):
    """Bind ``ctx`` as this thread's current context for the block
    (``None`` = no-op). The server edge (``DebugServer.do_POST``) and
    the router's dispatch path use this so everything they call —
    including HTTP clients adding the outbound header — sees the
    request's context without threading it through every signature."""
    if ctx is None:
        yield None
        return
    s = _stack()
    s.append(ctx)
    try:
        yield ctx
    finally:
        if s and s[-1] is ctx:
            s.pop()
        elif ctx in s:
            s.remove(ctx)


def _append(rec: Dict[str, Any]) -> None:
    with _lock:
        _ring.append(rec)


class TraceSpan:
    """One timed span on a request's tree. Inert (records nothing,
    allocates one small object) unless telemetry is enabled AND a
    sampled context is in scope — explicit ``ctx=`` beats the
    thread-local binding. While open, the span's own id is bound as
    the current context, so nested spans/hops parent correctly."""

    __slots__ = ("name", "args", "_given", "_ctx", "_span_id",
                 "_parent", "_t0")

    def __init__(self, name: str, ctx: Optional[TraceContext] = None,
                 **args: Any):
        self.name = name
        self.args = args
        self._given = ctx
        self._ctx: Optional[TraceContext] = None
        self._span_id = ""
        self._parent: Optional[str] = None
        self._t0 = 0

    def __enter__(self) -> "TraceSpan":
        ctx = self._given if self._given is not None else current()
        if (ctx is None or not ctx.sampled
                or not _metrics.enabled()):
            return self
        self._span_id = _new_id(4)
        self._parent = ctx.span_id
        self._ctx = TraceContext(ctx.trace_id, self._span_id, True)
        _stack().append(self._ctx)
        self._t0 = time.perf_counter_ns()
        return self

    def annotate(self, **kv: Any) -> "TraceSpan":
        """Attach args mid-span (e.g. the replica a dispatch landed
        on). No-op on an inert span."""
        if self._ctx is not None:
            self.args.update(kv)
        return self

    @property
    def context(self) -> Optional[TraceContext]:
        """The span's own context while open (for manual propagation);
        None when inert."""
        return self._ctx

    def __exit__(self, *exc) -> bool:
        if self._ctx is None:
            return False
        t1 = time.perf_counter_ns()
        s = _stack()
        if s and s[-1] is self._ctx:
            s.pop()
        elif self._ctx in s:
            s.remove(self._ctx)
        _append({
            "name": self.name,
            "trace_id": self._ctx.trace_id,
            "span_id": self._span_id,
            "parent_id": self._parent,
            "ts_ns": self._t0,
            "dur_ns": t1 - self._t0,
            "pid": os.getpid(),
            "tid": _tid(),
            "thread": threading.current_thread().name,
            "args": dict(self.args),
        })
        self._ctx = None
        return False


def _tid() -> int:
    try:
        return threading.get_native_id()
    except AttributeError:  # pragma: no cover (py<3.8)
        return threading.get_ident() % 100000


def span(name: str, ctx: Optional[TraceContext] = None,
         **args: Any) -> TraceSpan:
    return TraceSpan(name, ctx=ctx, **args)


def event(name: str, ctx: Optional[TraceContext] = None,
          **args: Any) -> None:
    """Record one INSTANT event. With a context (explicit or bound) it
    rides that trace; with none it records untraced (``trace_id``
    None) — the fleet-controller preempt-agreement events use this
    form, tagged by rank, so a fleet fan-in shows them on each rank's
    lane. No-op while telemetry is disabled or the context is
    unsampled."""
    if not _metrics.enabled():
        return
    if ctx is None:
        ctx = current()
    if ctx is not None and not ctx.sampled:
        return
    _append({
        "name": name,
        "trace_id": ctx.trace_id if ctx else None,
        "span_id": _new_id(4),
        "parent_id": ctx.span_id if ctx else None,
        "ts_ns": time.perf_counter_ns(),
        "dur_ns": 0,
        "instant": True,
        "pid": os.getpid(),
        "tid": _tid(),
        "thread": threading.current_thread().name,
        "args": dict(args),
    })


# -- collection + fan-in ----------------------------------------------------

def spans(trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Snapshot of the span ring (optionally filtered to one trace)."""
    with _lock:
        out = list(_ring)
    if trace_id is not None:
        out = [s for s in out if s.get("trace_id") == trace_id]
    return out


def total() -> int:
    return len(_ring)


def reset() -> None:
    with _lock:
        _ring.clear()


def clock() -> Dict[str, int]:
    """The clock-offset handshake: one (wall, monotonic) pair sampled
    together. A merger aligns this process's span timestamps onto the
    shared wall clock via ``wall_ns - perf_ns``."""
    return {"wall_ns": time.time_ns(),
            "perf_ns": time.perf_counter_ns()}


def collection(trace_id: Optional[str] = None,
               proc: Optional[str] = None) -> Dict[str, Any]:
    """This process's mergeable trace bundle: spans + clock handshake
    + pid — the /tracez payload shape :func:`merge_chrome_trace`
    consumes."""
    return {"proc": proc or f"pid{os.getpid()}",
            "pid": os.getpid(),
            "clock": clock(),
            "spans": spans(trace_id)}


def merge_chrome_trace(collections: Iterable[Dict[str, Any]],
                       path: Optional[str] = None) -> Dict[str, Any]:
    """Merge per-process trace collections into ONE chrome-trace dict
    with proper pid/tid lanes.

    Each collection is a :func:`collection` bundle (or a replica's
    /tracez JSON — ``trace_spans`` is accepted as the span key). Span
    timestamps are rebased per collection via its clock handshake, so
    spans from different OS processes land on one shared timeline;
    ``process_name``/``thread_name`` metadata events label the lanes.
    ``path`` (optional) atomically writes the JSON there too."""
    import json as _json

    events: List[Dict[str, Any]] = []
    procs: Dict[int, str] = {}
    threads: Dict[tuple, str] = {}
    for c in collections:
        if not isinstance(c, dict):
            continue
        rows = c.get("spans")
        if rows is None:
            rows = c.get("trace_spans") or []
        clk = c.get("clock") or {}
        off = int(clk.get("wall_ns", 0)) - int(clk.get("perf_ns", 0))
        pid = int(c.get("pid") or 0)
        procs.setdefault(pid, str(c.get("proc") or f"pid {pid}"))
        for s in rows:
            tid = int(s.get("tid") or 0)
            tname = s.get("thread")
            if tname:
                threads.setdefault((pid, tid), tname)
            args = dict(s.get("args") or {})
            args["trace_id"] = s.get("trace_id")
            args["span_id"] = s.get("span_id")
            args["parent"] = s.get("parent_id")
            ev: Dict[str, Any] = {
                "name": s.get("name"), "cat": "request",
                "ts": (int(s.get("ts_ns", 0)) + off) / 1e3,
                "pid": pid, "tid": tid, "args": args,
            }
            if s.get("instant"):
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = int(s.get("dur_ns", 0)) / 1e3
            events.append(ev)
    meta: List[Dict[str, Any]] = []
    for pid, name in sorted(procs.items()):
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "tid": 0, "args": {"name": name}})
    for (pid, tid), name in sorted(threads.items()):
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": tid, "args": {"name": name}})
    events.sort(key=lambda e: e["ts"])
    trace = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
    if path:
        from ..utils.atomic import atomic_write_text

        atomic_write_text(path, _json.dumps(trace))
    return trace
