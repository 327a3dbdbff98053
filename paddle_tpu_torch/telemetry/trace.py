"""Nestable span tracing (counterpart of paddle_tpu/telemetry/trace.py,
the same chrome-trace and JSONL exports).

One span machinery for the whole framework: RAII/context-manager spans
(reference: paddle/fluid/platform/profiler.h:81 RecordEvent) collected
host-side with monotonic timestamps and a thread-local nesting stack,
exported as

- chrome-trace JSON (``export_chrome_trace`` — the historical
  tools/timeline.py contract, preserved verbatim), and
- a structured JSONL event log (``export_jsonl`` — one JSON object per
  line with monotonic ns timestamps, name, duration, pid/tid, nesting
  depth and parent span; greppable/streamable where chrome-trace is
  load-the-whole-file).

Device-side tracing goes through ``torch.profiler`` (CUPTI on the
card): ``start_profiler(device_trace_dir=)`` starts a
``torch.profiler.profile`` with CPU and CUDA activities, and while
collection is on every span also enters ``torch.profiler.
record_function``, so it is named in a device capture as the JAX
package's ``TraceAnnotation`` names it in an XPlane trace.

``core/profiler.py`` is a thin shim over this module. Compat invariant:
``_events`` is only ever mutated IN PLACE (never rebound); the shim
imports the list object itself.

Span durations optionally feed a metrics histogram: pass
``histogram=`` (a ``metrics.Histogram``) and the span observes its own
duration when telemetry is enabled — one timer, both sinks.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import metrics as _metrics

_lock = threading.Lock()
_events: List[Dict[str, Any]] = []   # in-place mutation only (shim compat)
_enabled = False
_tls = threading.local()


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def _tid() -> int:
    try:
        return threading.get_native_id()
    except AttributeError:  # pragma: no cover (py<3.8)
        return threading.get_ident() % 100000


class Span:
    """Context-manager span; nests via a thread-local stack and also
    annotates device traces (``torch.profiler.record_function``) so spans
    appear in a profiler capture's timeline."""

    __slots__ = ("name", "cat", "histogram", "_t0", "_ann", "_depth",
                 "_parent", "_pushed")

    def __init__(self, name: str, cat: str = "host", histogram=None):
        self.name = name
        self.cat = cat
        self.histogram = histogram
        self._t0 = 0.0
        self._ann = None
        self._depth = 0
        self._parent = None
        self._pushed = False

    def __enter__(self):
        if _enabled:
            stack = _stack()
            self._depth = len(stack)
            self._parent = stack[-1].name if stack else None
            stack.append(self)
            self._pushed = True
            import torch.profiler  # lazy: only on an enabled trace path

            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._ann is not None:
            self._ann.__exit__(*exc)
            self._ann = None
        if self._pushed:
            # pop by identity, and even when collection was stopped
            # mid-span — an `if _enabled` guard here would leak the
            # stack entry and corrupt depth/parent for this thread in
            # every later profiler window
            self._pushed = False
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:
                stack.remove(self)
        if _enabled:
            with _lock:
                _events.append({
                    "name": self.name,
                    "cat": self.cat,
                    "ph": "X",
                    "ts": self._t0 / 1e3,  # chrome trace wants µs
                    "dur": (t1 - self._t0) / 1e3,
                    "pid": os.getpid(),
                    # REAL OS thread id: spans from named worker
                    # threads (pt-reader-*, pt-ckpt-async-writer,
                    # pt-fleet-watcher) must land in their own chrome
                    # lanes — the old get_ident()%100000 hash collided
                    # and carried no name
                    "tid": _tid(),
                    "args": {"depth": self._depth,
                             "parent": self._parent,
                             "thread": threading.current_thread().name},
                })
        if self.histogram is not None and _metrics.enabled():
            self.histogram.observe((t1 - self._t0) / 1e9)
        return False


# historical names, kept as the same objects (API.spec / shim compat)
RecordEvent = Span


def record_event(name: str) -> Span:
    return Span(name)


def span(name: str, cat: str = "host", histogram=None) -> Span:
    return Span(name, cat, histogram)


def tracing() -> bool:
    return _enabled


# the running device capture: (torch.profiler.profile, its directory)
_device: Optional[tuple] = None


def device_activities() -> list:
    """The profiler activities of a device capture: the CPU, and CUDA
    when a card is visible."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def start_profiler(device_trace_dir: Optional[str] = None) -> None:
    """Begin collecting host spans; with ``device_trace_dir`` also start
    a ``torch.profiler.profile`` over the CPU and CUDA activities, whose
    chrome trace :func:`stop_profiler` writes into that directory."""
    global _enabled, _device
    with _lock:
        _events.clear()
    _enabled = True
    if device_trace_dir:
        import torch.profiler

        prof = torch.profiler.profile(activities=device_activities())
        prof.start()
        _device = (prof, device_trace_dir)


def stop_profiler(timeline_path: Optional[str] = None,
                  device_trace: bool = False) -> List[Dict[str, Any]]:
    """Stop collection; optionally write chrome-trace JSON
    (tools/timeline.py analog). ``device_trace`` stops the device
    capture and writes its trace as ``<dir>/device_trace.json``."""
    global _enabled, _device
    _enabled = False
    if device_trace and _device is not None:
        prof, out_dir = _device
        _device = None
        prof.stop()
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir,
                                              "device_trace.json"))
    with _lock:
        events = list(_events)
    if timeline_path:
        export_chrome_trace(events, timeline_path)
    return events


def get_events() -> List[Dict[str, Any]]:
    """Copy of the collected span list (running or stopped)."""
    with _lock:
        return list(_events)


def reset() -> None:
    """Drop collected spans without toggling collection."""
    with _lock:
        _events.clear()


def export_chrome_trace(events: List[Dict[str, Any]], path: str) -> None:
    """Chrome-trace JSON with proper lanes: thread_name/process_name
    METADATA events are emitted for every (pid, tid) seen, so spans
    from named worker threads (pt-reader-*, pt-ckpt-async-writer,
    pt-fleet-watcher, ...) render in their own labeled lane instead of
    interleaving anonymously."""
    from ..utils.atomic import atomic_write_text

    meta: List[Dict[str, Any]] = []
    seen_pids: set = set()
    seen_tids: set = set()
    for e in events:
        pid, tid = e.get("pid"), e.get("tid")
        if pid is not None and pid not in seen_pids:
            seen_pids.add(pid)
            meta.append({"ph": "M", "name": "process_name",
                         "pid": pid, "tid": 0,
                         "args": {"name": f"pid {pid}"}})
        tname = (e.get("args") or {}).get("thread")
        if tname and (pid, tid) not in seen_tids:
            seen_tids.add((pid, tid))
            meta.append({"ph": "M", "name": "thread_name",
                         "pid": pid, "tid": tid,
                         "args": {"name": tname}})
    atomic_write_text(path, json.dumps(
        {"traceEvents": meta + list(events), "displayTimeUnit": "ms"}))


def export_jsonl(events: List[Dict[str, Any]], path: str) -> None:
    """Structured event log: one JSON object per line, monotonic ns
    timestamps (``ts_ns``/``dur_ns``), nesting depth + parent."""
    with open(path, "w") as f:
        for e in events:
            args = e.get("args", {})
            f.write(json.dumps({
                "name": e["name"],
                "cat": e.get("cat", "host"),
                "ts_ns": int(e["ts"] * 1e3),
                "dur_ns": int(e["dur"] * 1e3),
                "pid": e["pid"],
                "tid": e["tid"],
                "depth": args.get("depth", 0),
                "parent": args.get("parent"),
            }) + "\n")


@contextlib.contextmanager
def profiler(timeline_path: Optional[str] = None,
             device_trace_dir: Optional[str] = None):
    """``with profiler("/tmp/timeline.json"):`` — fluid.profiler.profiler
    analog."""
    start_profiler(device_trace_dir)
    try:
        yield
    finally:
        stop_profiler(timeline_path,
                      device_trace=device_trace_dir is not None)
