"""Exporters (counterpart of paddle_tpu/telemetry/export.py, byte for
byte the same exposition): Prometheus text format + human-readable
summary table.

``prometheus_text()`` renders the registry in the Prometheus exposition
format (text/plain; version 0.0.4): HELP/TYPE headers, ``_total``
counter convention respected as-is (callers name counters with the
suffix), histograms as cumulative ``_bucket{le=...}`` series plus
``_sum``/``_count``. Serve it from any HTTP handler or dump it to a
file for node-exporter's textfile collector.

``summary()`` renders the same registry as an aligned text table with
count/mean/p50/p99 for histograms — the operator's one-call view after
a serving or training run.
"""

from __future__ import annotations

import math
from typing import Optional

from ._atomic import atomic_write_text
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      registry as _registry)


def _fmt_val(v: float) -> str:
    if not math.isfinite(v):
        # Prometheus exposition spellings; int(inf/nan) would raise
        # and take the whole scrape down with it
        return "NaN" if math.isnan(v) else (
            "+Inf" if v > 0 else "-Inf")
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_le(b: float) -> str:
    # Prometheus le labels: shortest repr that round-trips
    return _fmt_val(b) if b == int(b) else repr(float(b))


def _fmt_exemplar(ex) -> str:
    """OpenMetrics exemplar suffix for a _bucket sample:
    ``# {trace_id="..."} value timestamp`` — the tail-latency
    breadcrumb linking a histogram bucket to the distributed trace
    that produced its slowest recent sample. Only rendered on the
    OPENMETRICS exposition (``prometheus_text(exemplars=True)`` /
    :func:`openmetrics_text`): the syntax is illegal in the classic
    text format, where one suffixed line would make a strict parser
    (node-exporter's textfile collector included) drop the WHOLE
    exposition."""
    if not ex:
        return ""
    return (f' # {{trace_id="{ex["trace_id"]}"}} '
            f'{repr(float(ex["value"]))} {repr(float(ex["ts"]))}')


def prometheus_text(reg: Optional[MetricsRegistry] = None, *,
                    exemplars: bool = False) -> str:
    reg = reg or _registry()
    out = []
    seen_headers = set()
    for m in reg.collect():
        if m.name not in seen_headers:
            seen_headers.add(m.name)
            if m.desc:
                out.append(f"# HELP {m.name} {m.desc}")
            out.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, (Counter, Gauge)):
            out.append(f"{m.full_name} {_fmt_val(m.value)}")
        elif isinstance(m, Histogram):
            snap = m.snapshot()
            base_labels = dict(m.labels)
            ex = m.exemplars() if exemplars else {}
            acc = 0
            for i, (bound, c) in enumerate(zip(snap["buckets"],
                                               snap["counts"])):
                acc += c
                lbl = dict(base_labels, le=_fmt_le(bound))
                inner = ",".join(
                    f'{k}="{v}"' for k, v in sorted(lbl.items()))
                out.append(f"{m.name}_bucket{{{inner}}} {acc}"
                           + _fmt_exemplar(ex.get(i)))
            inner = ",".join(f'{k}="{v}"' for k, v in sorted(
                dict(base_labels, le="+Inf").items()))
            out.append(f"{m.name}_bucket{{{inner}}} {snap['count']}"
                       + _fmt_exemplar(ex.get(len(snap["buckets"]))))
            suffix = ("{" + ",".join(
                f'{k}="{v}"' for k, v in sorted(base_labels.items()))
                + "}") if base_labels else ""
            out.append(f"{m.name}_sum{suffix} {repr(snap['sum'])}")
            out.append(f"{m.name}_count{suffix} {snap['count']}")
    return "\n".join(out) + ("\n" if out else "")


def openmetrics_text(reg: Optional[MetricsRegistry] = None) -> str:
    """The OpenMetrics form of the exposition: exemplar suffixes on
    histogram ``_bucket`` lines (the tail-latency trace-id
    breadcrumbs) plus the required ``# EOF`` terminator. This is what
    the debug server's ``/metrics`` serves; the classic form
    (:func:`prometheus_text`, no exemplars) stays the textfile /
    plain-scraper format."""
    return prometheus_text(reg, exemplars=True) + "# EOF\n"


def write_textfile(path: str,
                   reg: Optional[MetricsRegistry] = None) -> str:
    """Write the Prometheus exposition to ``path`` ATOMICALLY — the
    node-exporter textfile-collector contract. The collector re-reads
    the file on its own schedule, so a plain ``open(...).write`` races
    it: a scrape landing mid-write reads a torn exposition (phantom
    counter resets). Same-dir temp
    file + ``os.replace`` makes every read all-or-nothing. CLASSIC
    format on purpose — the textfile collector rejects OpenMetrics
    exemplar syntax, and one suffixed line would drop the whole file.
    Returns ``path``."""
    return atomic_write_text(path, prometheus_text(reg),
                             prefix=".pt_metrics_")


def summary(reg: Optional[MetricsRegistry] = None) -> str:
    """Aligned human table of every instrument with data."""
    reg = reg or _registry()
    rows = []
    for m in reg.collect():
        if isinstance(m, Counter):
            rows.append((m.full_name, "counter", _fmt_val(m.value),
                         "", "", "", m.unit))
        elif isinstance(m, Gauge):
            rows.append((m.full_name, "gauge", f"{m.value:.6g}",
                         "", "", "", m.unit))
        elif isinstance(m, Histogram):
            if not m.count:
                rows.append((m.full_name, "histogram", "0",
                             "", "", "", m.unit))
                continue
            rows.append((m.full_name, "histogram", str(m.count),
                         f"{m.mean:.6g}", f"{m.percentile(0.5):.6g}",
                         f"{m.percentile(0.99):.6g}", m.unit))
    if not rows:
        return ""
    header = ("metric", "type", "count/value", "mean", "p50", "p99",
              "unit")
    widths = [max(len(header[i]), *(len(r[i]) for r in rows))
              for i in range(len(header))]
    lines = [
        "  ".join(h.ljust(w) for h, w in zip(header, widths)).rstrip(),
        "  ".join("-" * w for w in widths),
    ]
    for r in rows:
        lines.append("  ".join(
            c.ljust(w) for c, w in zip(r, widths)).rstrip())
    return "\n".join(lines) + "\n"
