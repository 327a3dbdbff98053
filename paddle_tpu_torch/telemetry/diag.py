"""Training flight recorder and device-memory monitor (counterpart of
paddle_tpu/telemetry/diag.py, the same recorder, policies and dump
bundle).

The post-mortem half of the live diagnostics plane (``server`` is the
live half): when a training run NaNs or a serving process stalls, the
evidence (the last N steps of loss, grad norm and step time, the metrics
registry, the signature report, device memory) is gone by the time
anyone looks, unless something was recording it all along.

Two pieces:

- :func:`device_memory` / :func:`peak_memory_bytes`: per-card memory
  from ``torch.cuda.memory_stats(i)`` and ``max_memory_allocated(i)``
  for every visible card. On a card the entry always carries those
  stats: a failing read raises instead of degrading to a view that
  would read as the allocator's. With no card there are no stats: the
  one CPU entry says so (``memory_stats: None``, the JAX package's
  contract) and carries ``live_array_bytes``, the bytes of the live
  tensors the garbage collector can see (an allocation view, labeled
  as such).
- :class:`FlightRecorder`: a ring buffer of the last N steps (loss,
  grad norm, loss scale, step time, input queue depth) plus an anomaly
  watch (non-finite loss or grad norm, a grad-norm spike against the
  running mean, a step-time stall) that on a trigger writes ONE JSON
  dump bundle atomically and returns the configured policy
  (``record`` / ``skip_step`` / ``halt``) for the caller to apply.

Off by default and zero-cost when off: call sites consult the recorder
only behind the ``telemetry.enabled()`` check, and the recorder only
ever sees host Python scalars, never a tensor on the card.
"""

from __future__ import annotations

import gc
import json
import math
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import metrics as _metrics
from . import recompile as _recompile
from ._atomic import atomic_write_text

POLICIES = ("record", "skip_step", "halt")

# the PJRT names the JAX package's memory entries carry, read from the
# caching allocator (a dashboard of either package reads both)
_PJRT_KEYS = (("bytes_in_use", "allocated_bytes.all.current"),
              ("peak_bytes_in_use", "allocated_bytes.all.peak"),
              ("bytes_reserved", "reserved_bytes.all.current"),
              ("peak_bytes_reserved", "reserved_bytes.all.peak"),
              ("num_allocs", "allocation.all.allocated"))


class AnomalyHalt(RuntimeError):
    """Raised by a caller applying the ``halt`` policy after a
    FlightRecorder anomaly (the dump bundle is already on disk)."""


# ---------------------------------------------------------------------------
# device-memory monitor
# ---------------------------------------------------------------------------

def _cards() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def live_tensor_bytes() -> int:
    """Bytes of the live CPU tensors the garbage collector can see, each
    storage once (the CPU fallback view: framework-visible allocations,
    not an allocator's accounting)."""
    import torch

    seen = set()
    total = 0
    for obj in gc.get_objects():
        # type(), not isinstance(): the latter reads __class__, which
        # some module proxies answer with a deprecation warning
        if not issubclass(type(obj), torch.Tensor) or \
                obj.device.type != "cpu":
            continue
        try:
            st = obj.untyped_storage()
        except (RuntimeError, NotImplementedError):
            continue     # a tensor with no storage (meta, sparse, ...)
        key = st.data_ptr()
        if key in seen:
            continue
        seen.add(key)
        total += int(st.nbytes())
    return total


def card_memory_stats(i: int) -> Dict[str, int]:
    """``torch.cuda.memory_stats(i)`` with the PJRT key names added,
    plus the card's total memory as ``bytes_limit``."""
    import torch

    raw = {k: int(v) for k, v in torch.cuda.memory_stats(i).items()}
    stats = {name: raw.get(key, 0) for name, key in _PJRT_KEYS}
    stats["bytes_limit"] = int(torch.cuda.get_device_properties(i)
                               .total_memory)
    stats.update(raw)
    return stats


def device_memory() -> List[Dict[str, Any]]:
    """Per-device memory report: one entry per visible card with its
    allocator stats under ``memory_stats``; with no card, one CPU entry
    with ``memory_stats`` None and the :func:`live_tensor_bytes`
    fallback under ``live_array_bytes``, so a reader can always tell
    which accounting it is seeing."""
    import torch

    n = _cards()
    if n == 0:
        return [{"id": 0, "platform": "cpu", "kind": "cpu",
                 "memory_stats": None,
                 "live_array_bytes": live_tensor_bytes()}]
    return [{"id": i, "platform": "gpu",
             "kind": torch.cuda.get_device_name(i),
             "memory_stats": card_memory_stats(i)} for i in range(n)]


def peak_memory_bytes() -> Optional[int]:
    """The largest ``torch.cuda.max_memory_allocated(i)`` over the
    visible cards; None with no card. Strictly the peak: neither the
    live-tensor fallback nor an instantaneous reading is a high-water
    mark."""
    import torch

    n = _cards()
    if n == 0:
        return None
    return max(int(torch.cuda.max_memory_allocated(i)) for i in range(n))


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def _finite(v) -> Optional[float]:
    """Host float or None; never raises (a recorder must not take the
    training loop down over a weird scalar)."""
    if v is None:
        return None
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


class FlightRecorder:
    """Ring buffer of recent training steps + anomaly watch + dump.

    ``record_step`` appends one host-scalar entry, runs the anomaly
    checks, and on a trigger writes the dump bundle and returns the
    configured policy string (``record`` / ``skip_step`` / ``halt``) for
    the caller to apply; on a clean step it returns None. The recorder
    never applies policy itself.

    Anomaly checks (host floats only):

    - ``nan_loss`` / ``nan_grad_norm``: non-finite loss or grad norm.
    - ``grad_spike``: grad-norm > ``grad_spike_factor`` x the running
      mean of the previous grad norms, after ``warmup_steps`` samples.
    - ``step_stall``: step time > ``stall_factor`` x the running mean
      of the previous step times, after ``warmup_steps`` samples.

    Dumps are rate-limited to ``max_dumps`` per recorder; anomalies are
    logged to ``anomalies`` (bounded to the most recent
    ``MAX_ANOMALIES``; ``anomalies_total`` counts all). ``dump()`` can
    also be called by hand (reason="manual").
    """

    MAX_ANOMALIES = 1000  # kept records; anomalies_total counts beyond

    def __init__(self, dump_dir: str = ".", *, capacity: int = 256,
                 policy: str = "record", grad_spike_factor: float = 10.0,
                 stall_factor: float = 10.0, warmup_steps: int = 20,
                 max_dumps: int = 3,
                 run_config: Optional[Dict[str, Any]] = None):
        if policy not in POLICIES:
            raise ValueError(
                f"policy must be one of {POLICIES}, got {policy!r}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.dump_dir = dump_dir
        self.policy = policy
        self.grad_spike_factor = float(grad_spike_factor)
        self.stall_factor = float(stall_factor)
        self.warmup_steps = int(warmup_steps)
        self.max_dumps = int(max_dumps)
        self.run_config: Dict[str, Any] = dict(run_config or {})
        self.ring: deque = deque(maxlen=int(capacity))
        self.anomalies: List[Dict[str, Any]] = []
        self.anomalies_total = 0
        self.dumps: List[str] = []
        # running means over every FINITE sample, flagged spikes
        # included, so a regime change converges instead of flagging
        # forever; non-finite values never enter
        self._gn_sum = 0.0
        self._gn_n = 0
        self._dt_sum = 0.0
        self._dt_n = 0

    # -- recording ----------------------------------------------------------

    def record_step(self, step: int, *, loss=None, grad_norm=None,
                    loss_scale=None, step_time=None, queue_depth=None,
                    **extra) -> Optional[str]:
        """Record one step; returns the policy string on anomaly, else
        None. All values must already be host scalars: read them BEFORE
        calling (the recorder never touches device tensors)."""
        entry: Dict[str, Any] = {"step": int(step), "ts": time.time()}
        loss = _finite(loss)
        grad_norm = _finite(grad_norm)
        step_time = _finite(step_time)
        if loss is not None:
            entry["loss"] = loss
        if grad_norm is not None:
            entry["grad_norm"] = grad_norm
        if loss_scale is not None:
            entry["loss_scale"] = _finite(loss_scale)
        if step_time is not None:
            entry["step_time_s"] = step_time
        if queue_depth is not None:
            entry["queue_depth"] = int(queue_depth)
        for k, v in extra.items():
            entry[k] = _finite(v) if isinstance(v, (int, float)) else v
        anomaly = self._detect(loss, grad_norm, step_time)
        if anomaly:
            entry["anomaly"] = anomaly
        self.ring.append(entry)
        if grad_norm is not None and math.isfinite(grad_norm):
            self._gn_sum += grad_norm
            self._gn_n += 1
        if step_time is not None and math.isfinite(step_time):
            self._dt_sum += step_time
            self._dt_n += 1
        if anomaly is None:
            return None
        record = {"step": int(step), "kind": anomaly, "ts": entry["ts"],
                  "policy": self.policy}
        self.anomalies_total += 1
        if len(self.anomalies) >= self.MAX_ANOMALIES:
            self.anomalies.pop(0)
        self.anomalies.append(record)
        if len(self.dumps) < self.max_dumps:
            try:
                record["dump"] = self.dump(reason=anomaly)
            except (OSError, TypeError, ValueError) as e:
                # the recorder observes the run, it must never kill it:
                # a full disk or unwritable dump_dir degrades to a noted
                # failure, and the policy still applies
                record["dump_error"] = repr(e)
        return self.policy

    def halt_error(self, context: str) -> AnomalyHalt:
        """The exception a caller applying the ``halt`` policy raises,
        naming the anomaly and THIS anomaly's dump fate."""
        last = self.anomalies[-1] if self.anomalies else {}
        if "dump" in last:
            where = f"(dump: {last['dump']})"
        elif "dump_error" in last:
            where = f"(dump failed: {last['dump_error']})"
        else:
            where = "(no dump: rate-limited)"
        return AnomalyHalt(
            f"flight recorder halt at {context}: {last.get('kind')} "
            f"{where}")

    def _detect(self, loss, grad_norm, step_time) -> Optional[str]:
        if loss is not None and not math.isfinite(loss):
            return "nan_loss"
        if grad_norm is not None and not math.isfinite(grad_norm):
            return "nan_grad_norm"
        if (grad_norm is not None and self._gn_n >= self.warmup_steps
                and self._gn_sum > 0
                and grad_norm > self.grad_spike_factor
                * (self._gn_sum / self._gn_n)):
            return "grad_spike"
        if (step_time is not None and self._dt_n >= self.warmup_steps
                and self._dt_sum > 0
                and step_time > self.stall_factor
                * (self._dt_sum / self._dt_n)):
            return "step_stall"
        return None

    # -- dumping ------------------------------------------------------------

    def bundle(self, reason: str = "manual") -> Dict[str, Any]:
        """The dump payload as a dict: recorder ring, metrics snapshot,
        signature report, device memory, run config, anomaly log."""
        try:
            mem = device_memory()
        except RuntimeError as e:  # a wedged card must not kill the dump
            mem = [{"error": repr(e)}]
        return {
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
            "last_step": (self.ring[-1]["step"] if self.ring else None),
            "run_config": self.run_config,
            "ring": list(self.ring),
            "anomalies": list(self.anomalies),
            "anomalies_total": self.anomalies_total,
            "metrics": _metrics.registry().snapshot(),
            "recompile": _recompile.tracker().stats(),
            "device_memory": mem,
        }

    def dump(self, reason: str = "manual") -> str:
        """Write the bundle to ``dump_dir`` atomically (same-dir temp
        file + ``os.replace``: a reader sees a complete bundle or no
        file). Returns the final path."""
        os.makedirs(self.dump_dir, exist_ok=True)
        step = self.ring[-1]["step"] if self.ring else 0
        path = os.path.join(
            self.dump_dir,
            f"pt_flight_{reason}_step{step}_pid{os.getpid()}"
            f"_{len(self.dumps)}.json")
        # histogram snapshots carry tuples and +/-inf; default=str keeps
        # any exotic run_config value from killing the dump
        atomic_write_text(path, json.dumps(self.bundle(reason),
                                           default=str),
                          prefix=".pt_flight_")
        self.dumps.append(path)
        return path
