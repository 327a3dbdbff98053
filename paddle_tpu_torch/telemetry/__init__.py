"""paddle_tpu_torch.telemetry — framework-wide metrics, tracing and live
diagnostics (counterpart of paddle_tpu/telemetry/, the same metric
names, labels, headers, ``/statusz`` sections and on-disk formats, so a
dashboard, a trace merger or a peer process of either package reads the
other's output). The pieces:

- ``metrics``: process-global :class:`MetricsRegistry` with typed
  :class:`Counter` / :class:`Gauge` / :class:`Histogram`.
- ``trace``: nestable spans (``RecordEvent``), chrome-trace and JSONL
  export; ``start_profiler(device_trace_dir=)`` adds a
  ``torch.profiler`` capture.
- ``tracing``: request trace contexts (``X-PT-Trace``), cross-process
  span collection and the fleet's merged chrome trace.
- ``recompile``: per-call-site signature fingerprints (a first-seen
  signature counts as a "compile").
- ``export``: Prometheus / OpenMetrics text, ``summary()``.
- ``server``: the debug HTTP endpoint (/metrics /healthz /readyz
  /statusz /tracez /memz /profilez, /podz with a fleet controller) —
  opt-in via ``TrainLoop.run(debug_port=)``,
  ``serving.BatchedDecoder.run(debug_port=)`` or ``server.start()``.
- ``costs``: the program cost ledger (FLOPs and bytes of each program's
  first real call, MFU, arithmetic intensity, roofline verdict).
- ``profiling``: the goodput ledger, the bounded ``/profilez`` capture,
  the ``PT-PERF-80x`` regression sentinel.
- ``diag``: device memory (``torch.cuda`` stats per card) and the
  :class:`FlightRecorder`.
- ``lockwatch``: the runtime lock-order watchdog.

Everything is OFF by default and zero-cost when off: instrumented call
sites check :func:`enabled` (one module-global bool) before any dict
work, and instruments only ever record host-side scalars, never a value
that would wait for the card.

Usage::

    import paddle_tpu_torch.telemetry as telemetry
    telemetry.enable()          # or PT_TELEMETRY=1
    ... serve / train ...
    print(telemetry.summary())              # human table
    text = telemetry.prometheus_text()      # /metrics payload
"""

from __future__ import annotations

from . import (costs, diag, export, lockwatch, metrics, profiling,
               recompile, server, trace, tracing)
from .diag import (AnomalyHalt, FlightRecorder, device_memory,
                   peak_memory_bytes)
from .export import (openmetrics_text, prometheus_text, summary,
                     write_textfile)
from .metrics import (Counter, DEFAULT_BUCKETS, Gauge, Histogram,
                      MetricsRegistry, cached_instruments, disable,
                      enable, enabled, log_buckets, registry)
from .recompile import RecompileTracker, fingerprint
from .server import DebugServer
from .trace import (RecordEvent, Span, export_chrome_trace, export_jsonl,
                    span)
from .tracing import (TRACE_HEADER, TraceContext, TraceSpan,
                      merge_chrome_trace, new_trace)

__all__ = [
    "AnomalyHalt", "Counter", "DEFAULT_BUCKETS", "DebugServer",
    "FlightRecorder", "Gauge", "Histogram",
    "MetricsRegistry", "RecompileTracker", "RecordEvent", "Span",
    "TRACE_HEADER", "TraceContext", "TraceSpan",
    "cached_instruments", "costs", "device_memory", "diag",
    "disable", "enable", "enabled", "export", "export_chrome_trace",
    "export_jsonl", "fingerprint", "log_buckets",
    "lockwatch", "merge_chrome_trace", "metrics", "new_trace",
    "openmetrics_text", "peak_memory_bytes", "profiling",
    "prometheus_text", "recompile", "registry", "reset", "server",
    "span", "summary", "trace", "tracing", "write_textfile",
]


def reset() -> None:
    """Full telemetry reset: drop every metric, span, trace, and
    signature fingerprint (tests / between benchmark phases). Leaves
    the enabled flag as-is."""
    registry().reset()
    trace.reset()
    tracing.reset()
    recompile.tracker().reset()
    costs.reset()
    profiling.reset()
