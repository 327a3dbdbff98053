"""Thin shim over ``paddle_tpu_torch.telemetry.trace`` (counterpart of
paddle_tpu/core/profiler.py): the span machinery lives there; this module
keeps the historical import surface.

Parity targets: the RAII ``RecordEvent``, the ``profiler`` context and
the chrome-trace export. ``_events``/``_lock`` are re-exported as the
objects themselves: the list is mutated in place only, so these aliases
never go stale.
"""

from __future__ import annotations

from ..telemetry.trace import (RecordEvent, Span, _events, _lock,
                               export_chrome_trace, export_jsonl,
                               get_events, profiler, record_event, span,
                               start_profiler, stop_profiler)

__all__ = [
    "RecordEvent", "Span", "export_chrome_trace", "export_jsonl",
    "get_events", "profiler", "record_event", "span", "start_profiler",
    "stop_profiler",
]
