"""Performance attribution (counterpart of
paddle_tpu/telemetry/profiling.py, the same ledger, state machine,
diagnostics and baseline files): the goodput ledger, on-demand device
capture, and the step-time regression sentinel.

**Goodput ledger** (:func:`goodput`): splits a training step's wall time
into host-input-wait / dispatch / device-compute / checkpoint-stall
buckets (TrainLoop feeds it per step by host stamps, as the JAX
package does: dispatch is the host time of the step's call, device
compute the rest up to the nan guard's loss read, which fences the
step, so no synchronize of its own) and a serving tick into active-slot-tokens vs
arena capacity. ``pt_goodput_ratio`` = useful time (dispatch + device
compute) over everything, per role; the decomposition rides
``/statusz``'s ``goodput`` section.

**On-demand device capture** (:func:`make_profilez`): ``POST /profilez``
on any DebugServer runs ONE bounded ``torch.profiler`` capture (CPU and,
with a card, CUDA activities). The contract is the JAX package's state
machine: 404 when not mounted, 409 while a capture is in flight (one
per process, a non-blocking lock), 200 with the artifact path. The
window is capped by ``PT_PROFILEZ_CAP_MS`` (default 5000); the
profiler's own start (Kineto's first start can take seconds) is timed
apart and does not count against it. The trace lands in a temp
directory that is renamed into place only once written, so the
artifact directory existing MEANS the capture completed. The profiler is
process-global and its CPU side thread-local: a capture started on the
server's thread sees every thread's CUDA kernels (CUPTI) but only its
own CPU ops, so the answer lists the CUDA kernels it holds, and on a
card a capture that holds no device activity is an error
(:class:`CaptureEmptyError`), never a CPU-only trace that passes.
:func:`profilez_fanout` fans one request out to a fleet, peers
captured concurrently.

**Regression sentinel** (:func:`sentinel`): rolling per-(program,
backend) baselines of measured step/ITL time, persisted next to the
checkpoints they describe. A measurement past the band over the
baseline EWMA emits ONE typed diagnostic per (program, backend):
``PT-PERF-801`` (train step) / ``PT-PERF-802`` (serving ITL). The
port's backend key is the card's kind (``gpu:NVIDIA H100 80GB HBM3``)
or ``cpu``, so CPU runs and card runs never share a baseline.

Everything here is zero-cost while telemetry is disabled: the
TrainLoop/serving call sites check ``telemetry.enabled()`` first.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from . import metrics as _metrics

# ---------------------------------------------------------------------------
# Goodput ledger
# ---------------------------------------------------------------------------

_GOODPUT_BUCKETS = ("input_wait", "dispatch", "device_compute",
                    "checkpoint_stall")


@_metrics.cached_instruments
def _goodput_metrics(reg):
    return {
        "train": reg.gauge(
            "pt_goodput_ratio",
            "useful device time / total step wall time",
            labels={"role": "train"}),
        "serving": reg.gauge(
            "pt_goodput_ratio",
            "active-slot-tokens / arena token capacity",
            labels={"role": "serving"}),
        "buckets": {b: reg.counter(
            "pt_goodput_seconds_total",
            "cumulative step-time decomposition by bucket",
            unit="s", labels={"bucket": b})
            for b in _GOODPUT_BUCKETS},
    }


class GoodputLedger:
    """Accumulates the step-time decomposition. Thread-safe (the
    checkpoint-stall bucket can land from an async-save join while a
    serving tick reports from another thread)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with getattr(self, "_lock", threading.Lock()):
            self._buckets = {k: 0.0 for k in _GOODPUT_BUCKETS}
            self._steps = 0
            self._tick_tokens = 0
            self._tick_capacity = 0
            self._ticks = 0

    def note_step(self, *, input_wait: float = 0.0,
                  dispatch: float = 0.0, device_compute: float = 0.0,
                  checkpoint_stall: float = 0.0) -> None:
        """One training step's bucket split (seconds each)."""
        with self._lock:
            self._buckets["input_wait"] += input_wait
            self._buckets["dispatch"] += dispatch
            self._buckets["device_compute"] += device_compute
            self._buckets["checkpoint_stall"] += checkpoint_stall
            self._steps += 1
            ratio = self._train_ratio_locked()
        if _metrics.enabled():
            m = _goodput_metrics()
            if ratio is not None:
                m["train"].set(ratio)
            for b, v in (("input_wait", input_wait),
                         ("dispatch", dispatch),
                         ("device_compute", device_compute),
                         ("checkpoint_stall", checkpoint_stall)):
                if v > 0:
                    m["buckets"][b].inc(v)

    def note_checkpoint_stall(self, seconds: float) -> None:
        """A blocking checkpoint save outside the per-step split (the
        TrainLoop's periodic save happens after the step's buckets
        already landed)."""
        with self._lock:
            self._buckets["checkpoint_stall"] += seconds
        if seconds > 0 and _metrics.enabled():
            _goodput_metrics()["buckets"]["checkpoint_stall"].inc(seconds)

    def note_tick(self, active_tokens: int, capacity_tokens: int) -> None:
        """One serving tick: tokens the arena actually advanced vs the
        tokens it could have at full occupancy."""
        with self._lock:
            self._tick_tokens += int(active_tokens)
            self._tick_capacity += int(capacity_tokens)
            self._ticks += 1
            cap = self._tick_capacity
            ratio = self._tick_tokens / cap if cap else None
        if ratio is not None and _metrics.enabled():
            _goodput_metrics()["serving"].set(ratio)

    def _train_ratio_locked(self) -> Optional[float]:
        total = sum(self._buckets.values())
        if total <= 0:
            return None
        useful = (self._buckets["dispatch"]
                  + self._buckets["device_compute"])
        return useful / total

    def snapshot(self) -> Dict[str, Any]:
        """The /statusz ``goodput`` section (per-bucket seconds +
        derived ratios)."""
        with self._lock:
            out: Dict[str, Any] = {
                "steps": self._steps,
                "buckets_s": {k: round(v, 6)
                              for k, v in self._buckets.items()},
            }
            ratio = self._train_ratio_locked()
            if ratio is not None:
                out["train_goodput_ratio"] = round(ratio, 4)
            if self._ticks:
                out["serving_ticks"] = self._ticks
                out["active_slot_tokens"] = self._tick_tokens
                out["capacity_tokens"] = self._tick_capacity
                if self._tick_capacity:
                    out["serving_goodput_ratio"] = round(
                        self._tick_tokens / self._tick_capacity, 4)
            return out


_goodput = GoodputLedger()


def goodput() -> GoodputLedger:
    """The process-global goodput ledger."""
    return _goodput


# ---------------------------------------------------------------------------
# On-demand device capture (/profilez)
# ---------------------------------------------------------------------------

class CaptureBusyError(RuntimeError):
    """A device capture is already in flight (one per process). The
    DebugServer maps this to HTTP 409 via ``http_status``."""

    http_status = 409


class CaptureEmptyError(RuntimeError):
    """A capture on a card recorded no CUDA kernel, or none of the
    kernels the request required (HTTP 422: the trace is no evidence)."""

    http_status = 422


def _hard_cap_ms() -> int:
    try:
        return int(os.environ.get("PT_PROFILEZ_CAP_MS", "5000"))
    except ValueError:
        return 5000


_capture_lock = threading.Lock()


def device_kernels(trace_path: str) -> Dict[str, int]:
    """{CUDA kernel name: launches} of a chrome trace that
    ``torch.profiler`` exported (its ``kernel`` category events)."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    out: Dict[str, int] = {}
    for e in events:
        if e.get("cat") == "kernel" and e.get("ph") == "X":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def capture_device_trace(out_dir: str, duration_ms: float = 500,
                         require: Optional[List[str]] = None
                         ) -> Dict[str, Any]:
    """Run ONE bounded ``torch.profiler`` capture into ``out_dir``
    (``trace.json``, chrome format).

    Raises :class:`CaptureBusyError` (-> 409) if a capture is already
    running in this process. ``duration_ms`` is clamped to
    ``PT_PROFILEZ_CAP_MS``. With a card the capture must hold CUDA
    kernels, and every substring in ``require`` must name one of them,
    else :class:`CaptureEmptyError` and no artifact. The trace lands in
    a ``.tmp-<pid>`` dir renamed into place after the export."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..core.enforce import enforce

    enforce(duration_ms > 0, "profilez duration_ms must be > 0, got %s",
            duration_ms)
    duration_ms = min(float(duration_ms), float(_hard_cap_ms()))
    if not _capture_lock.acquire(blocking=False):
        raise CaptureBusyError(
            "a device capture is already in flight in this process "
            "(one concurrent capture; retry after it lands)")
    try:
        card = torch.cuda.is_available()
        out_dir = os.path.abspath(out_dir)
        parent = os.path.dirname(out_dir) or "."
        os.makedirs(parent, exist_ok=True)
        tmp = f"{out_dir}.tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if card else [])
        t0 = time.perf_counter()
        prof = profile(activities=acts)
        prof.start()
        t_started = time.perf_counter()
        try:
            time.sleep(duration_ms / 1e3)
        finally:
            t_window = time.perf_counter()
            prof.stop()
        t_stopped = time.perf_counter()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        kernels = device_kernels(path)
        missing = [r for r in (require or [])
                   if not any(r in k for k in kernels)]
        if card and (not kernels or missing):
            shutil.rmtree(tmp, ignore_errors=True)
            raise CaptureEmptyError(
                f"the capture of {duration_ms:.0f} ms on "
                f"{torch.cuda.get_device_name(0)} recorded "
                f"{sum(kernels.values())} CUDA kernel launches"
                + (f", none named {missing}" if missing else ""))
        os.replace(tmp, out_dir)
        return {"artifact": out_dir,
                "artifact_id": os.path.basename(out_dir),
                "pid": os.getpid(),
                "device": (torch.cuda.get_device_name(0) if card
                           else "cpu"),
                "duration_ms": round(duration_ms, 3),
                "start_ms": round((t_started - t0) * 1e3, 3),
                "window_ms": round((t_window - t_started) * 1e3, 3),
                "stop_ms": round((t_stopped - t_window) * 1e3, 3),
                "wall_ms": round((time.perf_counter() - t0) * 1e3, 3),
                "device_kernels": kernels}
    finally:
        _capture_lock.release()


def capture_busy() -> bool:
    """Whether a capture is in flight (non-destructive peek)."""
    if _capture_lock.acquire(blocking=False):
        _capture_lock.release()
        return False
    return True


def artifact_base_dir() -> str:
    """Where /profilez captures land by default (``PT_PROFILEZ_DIR`` or
    a temp-dir subdirectory) — the root ``GET /profilez/artifact``
    serves from."""
    return os.environ.get("PT_PROFILEZ_DIR") or os.path.join(
        tempfile.gettempdir(), "pt_profilez")


def _default_artifact_dir() -> str:
    return os.path.join(artifact_base_dir(),
                        f"capture-{os.getpid()}-{int(time.time())}")


def artifact_tar(artifact_id: Optional[str]) -> tuple:
    """``GET /profilez/artifact?id=<basename>`` backend: one completed
    capture directory under :func:`artifact_base_dir`, packed as a tar
    in memory. Returns ``(content_type, payload_bytes)``.

    The id is enforced to a bare directory name — a path separator or
    dot-dot would let the download endpoint read outside the artifact
    root."""
    import io
    import tarfile

    from ..core.enforce import enforce

    enforce(bool(artifact_id),
            "profilez artifact id is required (GET ?id=<basename>)")
    enforce(os.path.basename(artifact_id) == artifact_id
            and artifact_id not in (".", ".."),
            "profilez artifact id must be a bare directory name, got %r",
            artifact_id)
    path = os.path.join(artifact_base_dir(), artifact_id)
    enforce(os.path.isdir(path), "no profilez artifact %r under %s "
            "(POST /profilez to capture one)", artifact_id,
            artifact_base_dir())
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        tar.add(path, arcname=artifact_id)
    return "application/x-tar", buf.getvalue()


def make_profilez(default_dir: Optional[str] = None
                  ) -> Callable[[bytes], Dict[str, Any]]:
    """Build the ``POST /profilez`` handler for ``DebugServer.add_post``.

    Body (all optional): ``{"duration_ms": 500, "out_dir": "...",
    "require": ["kernel name substring", ...]}``.
    Unmounted -> the server's stock 404; busy -> 409
    (:class:`CaptureBusyError.http_status`); success -> 200 with the
    artifact path."""

    def handler(body: bytes) -> Dict[str, Any]:
        req = json.loads(body) if body else {}
        duration = float(req.get("duration_ms", 500))
        out_dir = req.get("out_dir") or default_dir \
            or _default_artifact_dir()
        return capture_device_trace(out_dir, duration,
                                    require=req.get("require"))

    return handler


def profilez_fanout(peer_urls: List[str], body: bytes, *,
                    local_result: Optional[Dict[str, Any]] = None,
                    timeout_margin_s: float = 10.0) -> Dict[str, Any]:
    """One request profiles a fleet: POST ``body`` to every peer's
    ``/profilez`` CONCURRENTLY (captures must overlap in time to be a
    fleet profile) and merge with this process's own capture.

    Peers answering 409 or unreachable degrade to rows in ``errors``
    keyed by url — a half-profiled fleet is still an answer. The
    per-peer timeout is the requested duration plus
    ``timeout_margin_s`` (a capture HOLDS the connection for its whole
    duration, unlike the 2s /tracez scrapes)."""
    from concurrent.futures import ThreadPoolExecutor
    from urllib.request import Request, urlopen

    req = json.loads(body) if body else {}
    duration_s = min(float(req.get("duration_ms", 500)),
                     float(_hard_cap_ms())) / 1e3
    timeout = duration_s + timeout_margin_s
    captures: List[Dict[str, Any]] = []
    errors: Dict[str, str] = {}
    if local_result is not None:
        captures.append(local_result)

    def fetch(url):
        r = Request(url.rstrip("/") + "/profilez", data=body or b"{}",
                    headers={"Content-Type": "application/json"})
        with urlopen(r, timeout=timeout) as resp:
            return json.loads(resp.read())

    if peer_urls:
        with ThreadPoolExecutor(
                max_workers=min(8, len(peer_urls)),
                thread_name_prefix="pt-profilez-fetch") as ex:
            futs = {url: ex.submit(fetch, url) for url in peer_urls}
            for url, fut in futs.items():
                try:
                    captures.append(fut.result(timeout=timeout + 5))
                except Exception as e:
                    errors[url] = f"{type(e).__name__}: {e}"
    return {"captures": captures, "errors": errors,
            "fleet": len(captures)}


# ---------------------------------------------------------------------------
# Regression sentinel
# ---------------------------------------------------------------------------

_PERF_CODES = {"step": "PT-PERF-801", "itl": "PT-PERF-802"}


@_metrics.cached_instruments
def _perf_metrics(reg):
    return {
        "regressions": reg.counter(
            "pt_perf_regressions_total",
            "measurements that drifted past the baseline band"),
    }


class RegressionSentinel:
    """Rolling per-(program, backend) time baselines with a typed alarm.

    ``observe`` feeds a measured seconds-per-step (or per-token for
    ``kind="itl"``); the first ``min_samples`` observations seed an
    EWMA baseline, after which a measurement above ``baseline * (1 +
    band)`` emits the typed diagnostic ONCE per (program, backend) and
    is NOT folded into the baseline (a regression must not become the
    new normal). Degraded measurements never touch the math."""

    def __init__(self, *, band: float = 0.5, min_samples: int = 5,
                 alpha: float = 0.2):
        self._lock = threading.Lock()
        self.band = float(band)
        self.min_samples = int(min_samples)
        self.alpha = float(alpha)
        self._baselines: Dict[str, Dict[str, Any]] = {}
        self._warned: set = set()
        self._diagnostics: List[Any] = []
        self._path: Optional[str] = None

    @staticmethod
    def _key(program: str, backend: str) -> str:
        return f"{program}|{backend}"

    def attach(self, path: str) -> None:
        """Persist baselines at ``path`` (the TrainLoop passes a file
        next to its checkpoint dir). Existing baselines load now; every
        ``save()`` rewrites atomically."""
        with self._lock:
            self._path = path
        if os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
                with self._lock:
                    for k, v in data.get("baselines", {}).items():
                        self._baselines.setdefault(k, v)
            except (OSError, ValueError):
                pass  # a torn baseline file must never fail a run

    def save(self) -> None:
        """Atomic rewrite of the attached baseline file (no-op when
        unattached)."""
        with self._lock:
            path = self._path
            data = {"baselines": dict(self._baselines)}
        if path is None:
            return
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            fd, tmp = tempfile.mkstemp(
                dir=os.path.dirname(path) or ".", suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(data, f, indent=1)
            os.replace(tmp, path)
        except OSError:
            pass

    def seed(self, program: str, backend: str, seconds: float, *,
             kind: str = "step") -> None:
        """Pre-arm a baseline from an external record (a bench history).

        A seeded baseline starts PAST the ``min_samples`` warmup — the
        whole point is alarming on the very first measurement of a
        fresh session. An existing (observed or previously seeded)
        baseline is never overwritten."""
        if seconds is None or seconds <= 0:
            return
        key = self._key(program, backend)
        with self._lock:
            self._baselines.setdefault(
                key, {"ewma": float(seconds), "n": self.min_samples,
                      "kind": kind, "seeded": True})

    def observe(self, program: str, backend: str, seconds: float, *,
                kind: str = "step", degraded: bool = False):
        """Feed one measurement; returns the emitted Diagnostic (or
        None). ``degraded=True`` rows are dropped before any baseline
        math — a degraded run must not poison (or alarm against)
        an accelerator baseline."""
        if degraded or seconds <= 0:
            return None
        key = self._key(program, backend)
        with self._lock:
            base = self._baselines.get(key)
            if base is None:
                self._baselines[key] = {"ewma": float(seconds), "n": 1,
                                        "kind": kind}
                return None
            if base["n"] < self.min_samples:
                a = self.alpha
                base["ewma"] = (1 - a) * base["ewma"] + a * seconds
                base["n"] += 1
                return None
            limit = base["ewma"] * (1.0 + self.band)
            if seconds <= limit:
                a = self.alpha
                base["ewma"] = (1 - a) * base["ewma"] + a * seconds
                base["n"] += 1
                return None
            if key in self._warned:
                return None
            self._warned.add(key)
            ewma = base["ewma"]
        diag = self._emit(program, backend, kind, seconds, ewma)
        return diag

    def _emit(self, program, backend, kind, seconds, ewma):
        from ..analysis.diagnostics import Diagnostic

        code = _PERF_CODES.get(kind, _PERF_CODES["step"])
        what = ("step time" if kind == "step"
                else "inter-token latency")
        diag = Diagnostic(
            code=code, severity="warning",
            message=(f"{program} [{backend}] {what} regressed: "
                     f"{seconds * 1e3:.2f}ms vs baseline "
                     f"{ewma * 1e3:.2f}ms "
                     f"(band +{self.band * 100:.0f}%)"),
            hint=("POST /profilez for a device capture of the slow "
                  "program; compare /statusz costs for a recompile or "
                  "sharding drift; delete the baseline file to re-arm "
                  "after an intentional change"),
            var=program)
        with self._lock:
            self._diagnostics.append(diag)
        if _metrics.enabled():
            _perf_metrics()["regressions"].inc()
        print(f"[pt-perf] {diag}", file=sys.stderr)
        return diag

    def diagnostics(self) -> List[Any]:
        """Every emitted diagnostic (the /statusz ``perf`` source)."""
        with self._lock:
            return list(self._diagnostics)

    def baselines(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in self._baselines.items()}

    def reset(self) -> None:
        with self._lock:
            self._baselines.clear()
            self._warned.clear()
            self._diagnostics.clear()
            self._path = None


_sentinel = RegressionSentinel()


def sentinel() -> RegressionSentinel:
    """The process-global regression sentinel."""
    return _sentinel


# Reserved key of a bench history file for sentinel baselines (the JAX
# package's BENCH_HISTORY.json layout): the underscore keeps it out of
# the metric namespace.
SENTINEL_HISTORY_KEY = "_sentinel"


def seed_sentinel_from_history(path: str) -> int:
    """Arm the process sentinel from a bench history file's reserved
    ``"_sentinel"`` section (the JAX package's layout), so a bench
    session alarms on step-time drift against the LAST
    session's timings instead of needing ``min_samples`` warmup runs of
    its own. Returns the number of baselines seeded; a missing file,
    torn JSON, or absent section seeds zero and never raises."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return 0
    rows = data.get(SENTINEL_HISTORY_KEY) if isinstance(data, dict) \
        else None
    if not isinstance(rows, dict):
        return 0
    s = sentinel()
    n = 0
    for key, row in rows.items():
        try:
            program, backend = key.split("|", 1)
            ewma = float(row["ewma"])
        except (AttributeError, KeyError, TypeError, ValueError):
            continue  # one malformed row must not block the rest
        s.seed(program, backend, ewma,
               kind=row.get("kind", "step") if isinstance(row, dict)
               else "step")
        n += 1
    return n


def sentinel_history_entry() -> Dict[str, Dict[str, Any]]:
    """The ``"_sentinel"`` section a bench writes into its history:
    the current baselines keyed ``program|backend``, trimmed to the
    fields :func:`seed_sentinel_from_history` reads back."""
    return {k: {"ewma": v["ewma"], "n": v["n"],
                "kind": v.get("kind", "step")}
            for k, v in sentinel().baselines().items()}


def statusz_section() -> Dict[str, Any]:
    """The /statusz ``perf`` section: sentinel alarms + baseline
    count."""
    s = sentinel()
    return {"regressions": [str(d) for d in s.diagnostics()],
            "baselines": len(s.baselines()),
            "capture_busy": capture_busy()}


def reset() -> None:
    """Tests: fresh goodput ledger + sentinel (capture lock untouched —
    a live capture owns it)."""
    _goodput.reset()
    _sentinel.reset()


__all__ = ["CaptureBusyError", "CaptureEmptyError", "GoodputLedger", "RegressionSentinel",
           "SENTINEL_HISTORY_KEY", "artifact_base_dir", "artifact_tar",
           "capture_busy", "capture_device_trace", "device_kernels",
           "goodput",
           "make_profilez", "profilez_fanout", "reset",
           "seed_sentinel_from_history", "sentinel",
           "sentinel_history_entry", "statusz_section"]
