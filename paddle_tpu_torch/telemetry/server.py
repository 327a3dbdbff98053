"""Debug HTTP server (counterpart of paddle_tpu/telemetry/server.py,
the same endpoints, payload sections, headers and status codes) — the
live half of the diagnostics plane.

A stdlib-``http.server`` endpoint on a daemon thread serving the
telemetry the rest of the package already collects (nothing here adds
measurement cost; it only exposes what the instruments hold):

- ``/metrics``  Prometheus exposition (``export.prometheus_text``) —
  point a scraper at it.
- ``/healthz``  liveness JSON: uptime plus the age of the last training
  step / serving request heartbeat (``note()``) — and, when the owning
  loop attached a readiness provider (``set_ready``), a ``ready``
  field. Liveness and readiness are distinct signals: a draining or
  not-yet-warmed serving replica is alive (do not restart it) but not
  ready (stop placing sessions on it).
- ``/readyz``   readiness probe: 200 ``{"ready": true}`` /
  503 ``{"ready": false}`` — the k8s-style binary form of the same
  provider, so a router's health check is one status-code test.
- ``/statusz``  backend + device inventory (each visible card's name,
  count and compute capability, or the CPU), uptime, telemetry state,
  the recompile-tracker report, and any status providers the owning
  loop attached (``add_status`` — e.g. the input pipeline's live
  prefetch depth).
- ``/tracez``   ring of recent completed spans as JSON (populated while
  ``trace.start_profiler()`` collection is on) PLUS the distributed
  request-tracing view: the process's trace-span ring and its
  clock-offset handshake (``telemetry.tracing``). ``?trace_id=``
  filters to one trace; with a fan-in provider attached
  (:meth:`DebugServer.set_trace_fanin` — the router /
  FleetController), ``?trace_id=`` aggregates matching spans from
  EVERY peer into one clock-aligned merged chrome-trace.
- ``/memz``     per-device memory (``diag.device_memory``): each card's
  ``torch.cuda.memory_stats``, the live-tensor fallback with no card.
- ``/podz``     pod-level fleet view (only when a
  ``resilience.FleetController`` is attached via :meth:`DebugServer.
  set_fleet` — ``TrainLoop.run(controller=..., debug_port=...)`` wires
  it): fans out to every rank's /healthz + /statusz + /memz through
  the fleet transport and renders one aggregate (per-rank heartbeat
  age, last committed step, preempt state).

Started opt-in from ``TrainLoop.run(debug_port=...)`` and
``serving.BatchedDecoder.run(debug_port=...)`` (or standalone via
:func:`start`); ``port=0`` binds an ephemeral port (``srv.port`` tells
you which). Binds 127.0.0.1 by default — this is an operator debug
plane, not a public API; put a real proxy in front for anything else.

``start()`` ENABLES telemetry process-wide: opting into the debug port
is opting into the instrumentation it serves (a metrics endpoint over a
disabled registry would scrape empty forever and read as "all quiet").
With no server started, the module is inert: the ``note()`` heartbeat
hook instrumented call-sites invoke is one empty-list check.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from . import metrics as _metrics
from . import recompile as _recompile
from . import trace as _trace
from . import tracing as _tracing

TRACEZ_SPANS = 256  # /tracez shows at most this many most-recent spans

_ACTIVE: List["DebugServer"] = []


def active() -> List["DebugServer"]:
    """Servers currently running in this process."""
    return list(_ACTIVE)


def note(kind: str = "step") -> None:
    """BROADCAST heartbeat for call-sites that don't own a server (the
    static Executor; anything running next to a standalone
    ``server.start()``): stamps every running server's
    ``last_<kind>_age_s`` clock — except loop-OWNED servers
    (``owned=True``: the ``TrainLoop``/``BatchedDecoder`` debug_port
    servers), which only their owning loop stamps via ``srv.note``;
    skipping them here means a co-resident Executor or second loop can
    never mask an owned loop's stall on its own /healthz. One list
    check when no server runs — safe on hot paths that already passed
    the enabled-flag gate."""
    if not _ACTIVE:
        return
    now = time.monotonic()
    for s in list(_ACTIVE):
        if not s.owned:
            s._last[kind] = now


class DebugServer:
    """One debug endpoint bound to ``host:port`` (port 0 = ephemeral).

    ``start()`` binds, spawns the daemon serving thread, registers the
    server for :func:`note` heartbeats, and enables telemetry;
    ``stop()`` shuts the listener down and JOINS the thread — callers
    that started a server own its shutdown (the reader-hygiene standard:
    no leaked daemon threads after ``run()`` returns)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 run_config: Optional[Dict[str, Any]] = None,
                 owned: bool = False):
        self.host = host
        self._want_port = int(port)
        # owned=True (the TrainLoop/BatchedDecoder debug_port servers):
        # only the owning loop stamps this server's heartbeats —
        # broadcast note() skips it, so a co-resident Executor or
        # second loop can never mask this loop's stall on /healthz
        self.owned = owned
        self.run_config: Dict[str, Any] = dict(run_config or {})
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._bound_port: Optional[int] = None
        self._t0 = 0.0
        self._last: Dict[str, float] = {}
        self._status: Dict[str, Callable[[], Any]] = {}
        self._fleet: Optional[Callable[[], Any]] = None
        self._ready: Optional[Callable[[], bool]] = None
        self._posts: Dict[str, Callable[[bytes], Any]] = {}
        self._sse: Dict[str, Callable[[bytes], Any]] = {}
        self._trace_fanin: Optional[Callable[[Optional[str]], Any]] = \
            None

    # -- wiring -------------------------------------------------------------

    def note(self, kind: str = "step") -> None:
        """Stamp THIS server's ``last_<kind>_age_s`` clock (the owning
        loop's heartbeat; module-level :func:`note` broadcasts)."""
        self._last[kind] = time.monotonic()

    def add_status(self, name: str, provider: Callable[[], Any]) -> None:
        """Attach a zero-arg callable whose return value is embedded in
        /statusz under ``status[name]`` (evaluated per scrape; failures
        render as an error string, never a 500)."""
        self._status[name] = provider

    def set_fleet(self, provider: Callable[[], Any]) -> None:
        """Mount a pod-level aggregation provider on ``/podz``
        (normally ``FleetController.podz`` — evaluated per scrape, so
        the view is live). Without one, /podz answers 404."""
        self._fleet = provider

    def set_trace_fanin(
            self, provider: Callable[[Optional[str]], Any]) -> None:
        """Mount a FLEET trace-aggregation provider on
        ``/tracez?trace_id=`` (and ``/tracez?fanin=1``):
        ``provider(trace_id)`` fans out to every peer's /tracez,
        aligns clocks, and returns one merged chrome-trace view
        (``Router.trace_fanin`` / ``FleetController.tracez_fanout``).
        Without one, /tracez?trace_id= filters the LOCAL ring only."""
        self._trace_fanin = provider

    def set_ready(self, provider: Callable[[], bool]) -> None:
        """Attach the READINESS provider (placement gate, distinct from
        liveness): serves ``/readyz`` (200/503) and the ``ready`` field
        of ``/healthz``. Evaluated per probe; a provider failure reads
        as not-ready (fail closed — a router must never place onto a
        replica whose readiness can't be established)."""
        self._ready = provider

    def add_post(self, path: str, handler: Callable[[bytes], Any]) -> None:
        """Mount a POST handler at ``path`` (absolute, e.g.
        ``/submit``): ``handler(body_bytes)`` returns a JSON-able
        object, or ``(content_type, bytes)`` for a binary response —
        the serving-replica control surface (submit/inject/drain/
        config) rides the same port as the debug endpoints. Handler
        exceptions answer 400 with the error string (a bad request
        must not read as a dead replica)."""
        self._posts[path] = handler

    def add_sse(self, path: str,
                handler: Callable[[bytes], Any]) -> None:
        """Mount a STREAMING POST handler at ``path``:
        ``handler(body_bytes)`` returns an iterator of JSON-able
        records, each written as one ``data: <json>`` SSE event and
        FLUSHED immediately (per-token streaming — a buffered token is
        a token the client doesn't have). The response carries no
        Content-Length; the stream ends when the iterator does
        (connection close delimits). The incoming ``X-PT-Trace``
        header is bound for the iterator's whole life and echoed onto
        the response headers, so every span the stream produces — and
        the client's view of it — stays on the request's trace."""
        self._sse[path] = handler

    @property
    def port(self) -> int:
        """The bound port — survives stop() so a caller that kept the
        server object can still report which port it served."""
        return self._bound_port or self._want_port

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def url(self, path: str = "/") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def start(self) -> "DebugServer":
        if self._httpd is not None:
            return self
        handler = _make_handler(self)
        # bind FIRST: a taken port must fail without flipping the
        # process-wide telemetry switch on for a server that never ran
        self._httpd = ThreadingHTTPServer((self.host, self._want_port),
                                          handler)
        try:
            self._bound_port = self._httpd.server_address[1]
            self._httpd.daemon_threads = True
            self._t0 = time.monotonic()
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.1},
                daemon=True, name="pt-debug-server")
            self._thread.start()
        except BaseException:
            # a failed thread spawn must not strand the bound socket
            self._httpd.server_close()
            self._httpd = None
            self._thread = None
            raise
        # only once the server is actually serving: a start() that
        # failed anywhere above leaves the process-wide switch untouched
        _metrics.enable()  # the port IS the telemetry opt-in (docstring)
        _ACTIVE.append(self)
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        try:
            _ACTIVE.remove(self)
        except ValueError:
            pass
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "DebugServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- endpoint payloads (run on handler threads) -------------------------

    def _age(self, kind: str) -> Optional[float]:
        t = self._last.get(kind)
        return None if t is None else round(time.monotonic() - t, 3)

    def ready(self) -> Optional[bool]:
        """Readiness via the attached provider (None = no provider:
        plain liveness servers have no placement semantics). Provider
        failures fail CLOSED (not ready)."""
        if self._ready is None:
            return None
        try:
            return bool(self._ready())
        except Exception:
            return False

    def healthz(self) -> Dict[str, Any]:
        out = {
            "status": "ok",
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "last_step_age_s": self._age("step"),
            "last_request_age_s": self._age("request"),
            "pid": os.getpid(),
        }
        ready = self.ready()
        if ready is not None:
            out["ready"] = ready
        return out

    def statusz(self) -> Dict[str, Any]:
        devices = _devices()
        status = {}
        for name, fn in self._status.items():
            try:
                status[name] = fn()
            except Exception as e:
                status[name] = f"<status provider failed: {e!r}>"
        # fault-tolerance plane: ambient preemption-handler + armed
        # fault-injector state (lazy import — resilience pulls in
        # telemetry, so a top-level import here would cycle)
        try:
            from .. import resilience as _resilience

            resilience = _resilience.statusz()
        except Exception as e:  # /statusz must render regardless
            resilience = f"<resilience status failed: {e!r}>"
        # tail-latency exemplars: each histogram's highest populated
        # bucket with a recorded trace id — the /statusz row that
        # links a p99 straight to its cross-process timeline
        # (/tracez?trace_id=...)
        exemplars = {}
        for m in _metrics.registry().collect():
            top = (m.top_exemplar()
                   if isinstance(m, _metrics.Histogram) else None)
            if top:
                exemplars[m.full_name] = top
        # performance-attribution plane: the program cost ledger
        # (FLOPs/HBM/roofline per cached executable), the goodput
        # decomposition, and the regression sentinel's alarms
        try:
            from . import costs as _costs
            from . import profiling as _profiling

            costs = _costs.statusz_section()
            goodput = _profiling.goodput().snapshot()
            perf = _profiling.statusz_section()
        except Exception as e:  # /statusz must render regardless
            costs = goodput = perf = f"<costs status failed: {e!r}>"
        # kernel tuning-table staleness (PT-TUNE-501): stale
        # dtype-keyed entries visible without grepping logs (lazy
        # import — the kernels' table must not load for a bare server)
        try:
            from ..ops.kernels import tuning as _tuning

            tuning = {"stale_dtype_findings": [
                str(d) for d in _tuning.stale_dtype_findings()]}
        except Exception as e:
            tuning = f"<tuning status failed: {e!r}>"
        return {
            "backend": devices[0]["platform"],
            "device_count": len(devices),
            "devices": devices,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "telemetry_enabled": _metrics.enabled(),
            "tracing": _trace.tracing(),
            "recompile": _recompile.tracker().stats(),
            "resilience": resilience,
            "costs": costs,
            "goodput": goodput,
            "perf": perf,
            "tuning": tuning,
            "exemplars": exemplars,
            "status": status,
            "run_config": self.run_config,
        }

    def tracez(self, trace_id: Optional[str] = None) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            # the clock-offset handshake + pid the fleet fan-in
            # aligns/lanes this process's spans with
            "pid": os.getpid(),
            "proc": (self.run_config.get("role")
                     or f"pid{os.getpid()}"),
            "clock": _tracing.clock(),
            "trace_total": _tracing.total(),
            "trace_spans": _tracing.spans(trace_id),
        }
        if trace_id is None:
            # the historical profiler-ring view rides along on the
            # unfiltered scrape
            events = _trace.get_events()
            out["tracing"] = _trace.tracing()
            out["total"] = len(events)
            out["spans"] = events[-TRACEZ_SPANS:]
        return out

    def memz(self) -> Dict[str, Any]:
        from . import diag

        return {"devices": diag.device_memory(),
                "peak_mem_bytes": diag.peak_memory_bytes()}


def _devices() -> List[Dict[str, Any]]:
    """The /statusz device inventory: each visible card (id, name,
    platform ``gpu``, compute capability, this process's rank), or one
    CPU entry when there is none."""
    import torch

    rank = 0
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        rank = torch.distributed.get_rank()
    if not torch.cuda.is_available():
        return [{"id": 0, "kind": "cpu", "platform": "cpu",
                 "process_index": rank}]
    out = []
    for i in range(torch.cuda.device_count()):
        major, minor = torch.cuda.get_device_capability(i)
        out.append({"id": i, "kind": torch.cuda.get_device_name(i),
                    "platform": "gpu", "capability": f"{major}.{minor}",
                    "process_index": rank})
    return out


def _make_handler(server: DebugServer):
    class Handler(BaseHTTPRequestHandler):
        # scrapes are frequent; stock per-request stderr logging would
        # drown the training logs
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _send(self, code: int, body: str,
                  ctype: str = "application/json") -> None:
            data = body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", ctype + "; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler contract)
            raw, _, query = self.path.partition("?")
            path = raw.rstrip("/") or "/"
            try:
                if path == "/metrics":
                    # OpenMetrics on the wire: exemplar suffixes are
                    # only legal under this content type — a classic
                    # text/plain parser handed one would drop the
                    # whole scrape (write_textfile stays classic)
                    from .export import openmetrics_text

                    self._send(200, openmetrics_text(),
                               "application/openmetrics-text; "
                               "version=1.0.0")
                elif path == "/healthz":
                    self._send(200, json.dumps(server.healthz()))
                elif path == "/readyz":
                    ready = server.ready()
                    if ready is None:
                        self._send(404, json.dumps(
                            {"error": "no readiness provider attached "
                                      "(DebugServer.set_ready)"}))
                    else:
                        self._send(200 if ready else 503,
                                   json.dumps({"ready": ready}))
                elif path == "/statusz":
                    self._send(200, json.dumps(server.statusz(),
                                               default=str))
                elif path == "/tracez":
                    from urllib.parse import parse_qs

                    qs = parse_qs(query)
                    tid = (qs.get("trace_id") or [None])[0]
                    # ``local=1`` forces the LOCAL view even when a
                    # fan-in provider is mounted — it is what the
                    # fan-out itself requests from peers, so two
                    # aggregators (e.g. every fleet rank mounts one)
                    # can never recurse into each other's fan-ins
                    if (server._trace_fanin is not None
                            and "local" not in qs
                            and (tid or "fanin" in qs)):
                        # fleet aggregation: fan out to every peer,
                        # align clocks, one merged chrome-trace
                        self._send(200, json.dumps(
                            server._trace_fanin(tid), default=str))
                    else:
                        self._send(200, json.dumps(server.tracez(tid),
                                                   default=str))
                elif path == "/memz":
                    self._send(200, json.dumps(server.memz(),
                                               default=str))
                elif path == "/profilez/artifact":
                    # off-host capture download: stream one /profilez
                    # artifact directory as a tar (GET ?id=<artifact>)
                    from urllib.parse import parse_qs

                    from . import profiling as _profiling

                    aid = (parse_qs(query).get("id") or [None])[0]
                    try:
                        ctype, data = _profiling.artifact_tar(aid)
                    except Exception as e:
                        self._send(404, json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}))
                    else:
                        self.send_response(200)
                        self.send_header("Content-Type", ctype)
                        self.send_header(
                            "Content-Disposition",
                            f'attachment; filename="{aid}.tar"')
                        self.send_header("Content-Length",
                                         str(len(data)))
                        self.end_headers()
                        self.wfile.write(data)
                elif path == "/podz":
                    if server._fleet is None:
                        self._send(404, json.dumps({
                            "error": "no fleet controller attached "
                                     "(TrainLoop.run(controller=..., "
                                     "debug_port=...))"}))
                    else:
                        self._send(200, json.dumps(server._fleet(),
                                                   default=str))
                elif path == "/":
                    endpoints = ["/metrics", "/healthz", "/statusz",
                                 "/tracez", "/memz"]
                    if server._ready is not None:
                        endpoints.append("/readyz")
                    if server._fleet is not None:
                        endpoints.append("/podz")
                    endpoints.extend(sorted(set(server._posts)
                                            | set(server._sse)))
                    self._send(200, json.dumps(
                        {"endpoints": endpoints}))
                else:
                    self._send(404, json.dumps(
                        {"error": f"no such endpoint: {path}"}))
            except BrokenPipeError:
                pass  # scraper went away mid-response
            except Exception:
                # a broken scrape must report, not kill the handler
                # thread silently
                try:
                    self._send(500, json.dumps(
                        {"error": traceback.format_exc()}))
                except Exception:
                    pass

        def _send_sse(self, events, ctx=None) -> None:
            """Chunked SSE writer: one ``data: <json>`` event per
            record, FLUSHED per record — a token buffered here is a
            token the client doesn't have yet. The request's trace
            context is echoed onto the response via ``to_header`` so
            the hop — and the
            client's stream reader — stays on the request's trace.
            No Content-Length: the iterator's end (connection close)
            delimits the stream."""
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/event-stream; charset=utf-8")
            self.send_header("Cache-Control", "no-cache")
            if ctx is not None:
                self.send_header(_tracing.TRACE_HEADER,
                                 ctx.to_header())
            self.end_headers()
            try:
                for ev in events:
                    self.wfile.write(
                        b"data: "
                        + json.dumps(ev, default=str).encode("utf-8")
                        + b"\n\n")
                    self.wfile.flush()  # per-token: never buffer
            except (BrokenPipeError, ConnectionResetError):
                pass  # client hung up mid-stream
            finally:
                close = getattr(events, "close", None)
                if close is not None:
                    close()

        def do_POST(self):  # noqa: N802 (BaseHTTPRequestHandler contract)
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            fn = server._posts.get(path)
            sse = server._sse.get(path)
            if fn is None and sse is None:
                self._send(404, json.dumps(
                    {"error": f"no such POST endpoint: {path}"}))
                return
            try:
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                # cross-process trace propagation: an incoming
                # X-PT-Trace header binds the request's context for
                # the handler's duration (and records the server-side
                # hop span), so spans the handler produces parent
                # onto the caller's tree — the one choke point every
                # POST endpoint (submit/inject/prefill/drain/config)
                # rides through.
                hdr = self.headers.get(_tracing.TRACE_HEADER)
                ctx = (_tracing.from_header(hdr)
                       if hdr and _metrics.enabled() else None)
                # cross-process DEADLINE propagation: an incoming
                # X-PT-Deadline (stamped beside the trace header by
                # the router's _trace_headers) binds the request's
                # remaining end-to-end budget for the handler, so a
                # replica-side submit inherits it through
                # reliability.current(). A CORRECTNESS header — parsed
                # and bound whether or not telemetry is enabled
                # (lazy import: resilience must not load unless a
                # deadline actually arrives).
                dhdr = self.headers.get("X-PT-Deadline")
                dl = None
                if dhdr:
                    from ..resilience import reliability as _rel

                    dl = _rel.Deadline.from_header(dhdr)
                    cm_dl = (_rel.bind(dl) if dl is not None
                             else contextlib.nullcontext())
                else:
                    cm_dl = contextlib.nullcontext()
                if sse is not None:
                    # streaming endpoint: the context stays bound for
                    # the ITERATOR's whole life (tokens produce spans
                    # too), and rides the response headers back
                    if ctx is not None:
                        with cm_dl, _tracing.bind(ctx), \
                                _tracing.span("http.POST " + path,
                                              path=path):
                            self._send_sse(sse(body), ctx)
                    else:
                        with cm_dl:
                            self._send_sse(sse(body))
                    return
                if ctx is not None:
                    with cm_dl, _tracing.bind(ctx), \
                            _tracing.span("http.POST " + path,
                                          path=path):
                        out = fn(body)
                else:
                    with cm_dl:
                        out = fn(body)
                if (isinstance(out, tuple) and len(out) == 2
                        and isinstance(out[1], (bytes, bytearray))):
                    ctype, data = out
                    data = bytes(data)
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    self._send(200, json.dumps(out, default=str))
            except BrokenPipeError:
                pass  # caller went away mid-response
            except Exception as e:
                # a handler error is the CALLER's problem (bad request,
                # typed enforce failure) — answer 400 with the message;
                # only transport breakage should look like a dead
                # replica to a router's health check. A handler may
                # carry its own status on the exception type (e.g.
                # profiling.CaptureBusyError.http_status = 409 for the
                # one-capture-in-flight contract).
                try:
                    code = getattr(type(e), "http_status", 400)
                    if not (isinstance(code, int) and 400 <= code < 600):
                        code = 400
                    self._send(code, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}))
                except Exception:
                    pass

    return Handler


def start(port: int = 0, host: str = "127.0.0.1",
          run_config: Optional[Dict[str, Any]] = None) -> DebugServer:
    """Start a debug server (module-level convenience). Caller owns
    ``stop()``."""
    return DebugServer(port=port, host=host, run_config=run_config).start()
