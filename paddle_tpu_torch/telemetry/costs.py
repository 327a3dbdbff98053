"""Program cost ledger (counterpart of paddle_tpu/telemetry/costs.py, the
same records, gauges and ``/statusz`` section): what every program
costs, counted once and attributed from then on.

A "program" here is what the JAX package compiles and the port runs
eagerly: the training step (``train.step``), the serving tick
(``serving.step[k=...]``) and each prefill bucket. The JAX ledger lowers
a program once per fingerprint and reads XLA's ``cost_analysis()``
without running it. The port has nothing to lower, and a tick writes its
caches in place, so nothing may run twice: the ledger counts the FIRST
REAL call of each program (:func:`counting` around it) with
``utils.flops.counting``:

- FLOPs: every aten op by ``torch.utils.flop_counter``'s rules, plus
  each hand kernel's FLOPs reckoned from its shapes (the convention of
  the plain path's products, so the kernels and the plain versions give
  one count);
- bytes (``hbm_bytes``): each aten op's input and output bytes, views
  aside, plus each hand kernel's own (each input read once, each output
  written once). Eager PyTorch fuses nothing, so every op really reads
  and writes HBM; the sum is an ESTIMATE of the traffic (the caching of
  L2 is not seen), not XLA's post-fusion figure.

From a record plus a measured wall time the ledger derives MFU
(program FLOPs / (wall x the card's peak)), the arithmetic intensity
(FLOPs per byte) and the roofline verdict (``compute_bound`` when the
intensity clears the card's ridge point, peak FLOP/s / peak HBM byte/s;
``hbm_bound`` below it). The peak table is ``utils.flops``'s (H100 SXM:
989 TFLOP/s bf16, 3.35 TB/s); an unknown backend, the CPU first, gets
an explicitly ``nominal`` row so the verdict still renders, flagged,
never passed off as silicon.

Call sites go through :func:`counting`, which is zero-cost while
telemetry is off (one ``enabled()`` check) and a dict lookup once the
program is known. Benches call :func:`analyze_callable` directly (an
explicit opt-in). Gauges: ``pt_program_flops`` / ``pt_program_hbm_bytes``
(per program) and ``pt_step_mfu`` (set by :func:`observe_step`).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional

from . import metrics as _metrics

# nominal fallback row (flagged, never recorded as a card number): a
# present-day server core complex, order-of-magnitude only, so the
# roofline section renders on CPU runs with the `nominal` flag set
_CPU_PEAK_FLOPS = 2e11
_CPU_PEAK_BYTES_PER_S = 50e9

_NULL_CM = contextlib.nullcontext()


def backend_key(device: Optional[Any] = None) -> str:
    """The backend a measurement keys on: ``gpu:<the card's name>`` for
    a card (None: card 0 when one is visible), else ``cpu``."""
    from ..utils.flops import device_kind

    kind = device_kind(device)
    return "cpu" if kind is None else f"gpu:{kind}"


def backend_peaks(device: Optional[Any] = None) -> Dict[str, Any]:
    """Peak FLOP/s (bf16) and HBM byte/s for ``device`` (default: card 0
    when one is visible). Always answers: an unknown backend gets the
    nominal CPU row with ``nominal=True``. ``PT_PEAK_FLOPS`` /
    ``PT_PEAK_HBM_BYTES`` override either column (absolute units)."""
    import os

    from ..utils import flops as _flops

    kind = _flops.device_kind(device)
    peak_flops = _flops.device_peak_flops(kind or "cpu")
    peak_bytes = None
    for key, bw in _flops.HBM_BYTES_PER_S.items():
        if key in (kind or "").lower():
            peak_bytes = bw
            break
    env_bw = os.environ.get("PT_PEAK_HBM_BYTES")
    if env_bw:
        try:
            peak_bytes = float(env_bw)
        except ValueError:
            pass
    nominal = peak_flops is None or peak_bytes is None
    if peak_flops is None:
        peak_flops = _CPU_PEAK_FLOPS
    if peak_bytes is None:
        peak_bytes = _CPU_PEAK_BYTES_PER_S
    return {"backend": "cpu" if kind is None else "gpu",
            "device_kind": kind,
            "peak_flops": peak_flops,
            "peak_hbm_bytes_per_s": peak_bytes,
            "ridge_flops_per_byte": peak_flops / peak_bytes,
            "nominal": nominal}


def roofline(flops: Optional[float], hbm_bytes: Optional[float],
             device: Optional[Any] = None) -> Dict[str, Any]:
    """Roofline placement of one program: arithmetic intensity against
    the backend's ridge point. ``verdict`` is ``"compute_bound"`` /
    ``"hbm_bound"`` / ``"unknown"`` (either side missing)."""
    peaks = backend_peaks(device)
    out = {"intensity_flops_per_byte": None,
           "ridge_flops_per_byte": round(
               peaks["ridge_flops_per_byte"], 2),
           "verdict": "unknown", "nominal": peaks["nominal"]}
    if flops and hbm_bytes:
        intensity = flops / hbm_bytes
        out["intensity_flops_per_byte"] = round(intensity, 3)
        out["verdict"] = ("compute_bound"
                          if intensity >= peaks["ridge_flops_per_byte"]
                          else "hbm_bound")
    return out


# ---------------------------------------------------------------------------
# The ledger
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_LEDGER: Dict[str, Dict[str, Any]] = {}  # program name -> record


@_metrics.cached_instruments
def _cost_metrics(reg):
    return {
        "mfu": reg.gauge(
            "pt_step_mfu",
            "model-FLOPs utilization of the last observed step "
            "(ledger FLOPs / wall / chip peak)"),
    }


def _analysis(count, n_partitions: int) -> Dict[str, Any]:
    """Ledger fields from a ``utils.flops.CostCount``: FLOPs and bytes
    of this process's share, times ``n_partitions``."""
    scale = float(max(1, n_partitions))
    return {"flops": (count.flops * scale) if count.flops > 0 else None,
            "hbm_bytes": (count.bytes * scale) if count.bytes > 0 else None,
            "peak_temp_bytes": None, "argument_bytes": None,
            "output_bytes": None,
            "activation_bytes": int(count.activation_bytes),
            "aten_ops": count.ops, "kernel_calls": dict(count.kernels),
            "bytes_source": "estimate: aten ops' inputs and outputs plus "
                            "the hand kernels' own"}


def _register(name: str, analysis: Dict[str, Any], *, origin: str,
              n_partitions: int, fingerprint: Optional[str],
              device=None) -> Dict[str, Any]:
    rec = dict(analysis)
    rec["analyzed"] = True
    rec["program"] = name
    rec["origin"] = origin
    rec["backend"] = backend_key(device)
    rec["n_partitions"] = int(max(1, n_partitions))
    rec["fingerprint"] = fingerprint
    rec["roofline"] = roofline(rec.get("flops"), rec.get("hbm_bytes"),
                               device)
    with _lock:
        stub = _LEDGER.get(name)
        if stub is not None and stub.get("origin") == "aot":
            # a provenance stub keeps its origin and artifact
            rec["origin"] = "aot"
            rec["artifact_id"] = stub.get("artifact_id")
        _LEDGER[name] = rec
    if _metrics.enabled():
        reg = _metrics.registry()
        if rec.get("flops"):
            reg.gauge("pt_program_flops",
                      "XLA cost-model FLOPs per dispatch",
                      labels={"program": name}).set(rec["flops"])
        if rec.get("hbm_bytes"):
            reg.gauge("pt_program_hbm_bytes",
                      "XLA cost-model bytes accessed per dispatch",
                      labels={"program": name}).set(rec["hbm_bytes"])
    return rec


def known(name: str) -> bool:
    """Whether ``name`` has its numbers in the ledger."""
    with _lock:
        rec = _LEDGER.get(name)
        return rec is not None and bool(rec.get("analyzed"))


@contextlib.contextmanager
def _count_and_register(name, origin, n_partitions, fingerprint, device):
    from ..utils.flops import counting as _counting

    with _counting() as count:
        yield count
    _register(name, _analysis(count, n_partitions), origin=origin,
              n_partitions=n_partitions, fingerprint=fingerprint,
              device=device)


def counting(name: str, *, n_partitions: int = 1, origin: str = "eager",
             fingerprint: Optional[str] = None, device=None):
    """Context manager for an instrumented call site: the block is the
    program's real call, and the first one while telemetry is on is
    counted and registered as ``name`` (a block that raises registers
    nothing). Zero-cost while telemetry is off; an inert context once
    the program is known. ``device``: where the program runs (its
    backend key and peak row)."""
    if not _metrics.enabled() or known(name):
        return _NULL_CM
    return _count_and_register(name, origin, n_partitions, fingerprint,
                               device)


def ensure_program(name: str, fn, args: tuple = (),
                   kwargs: Optional[dict] = None, *,
                   n_partitions: int = 1, origin: str = "eager",
                   fingerprint: Optional[str] = None, device=None):
    """``fn(*args, **kwargs)`` under :func:`counting` (the JAX package's
    entry, which lowers without running; here the call is the program's
    real call, so its result is returned)."""
    with counting(name, n_partitions=n_partitions, origin=origin,
                  fingerprint=fingerprint, device=device):
        return fn(*args, **(kwargs or {}))


def analyze_callable(name: str, fn, *args, n_partitions: int = 1,
                     origin: str = "bench", device=None,
                     **kwargs) -> Dict[str, Any]:
    """Explicit analysis and registration, the bench path: runs
    ``fn(*args, **kwargs)`` once under the count whatever the telemetry
    flag (calling it IS the opt-in) and returns the record. A known
    program is returned as recorded, without running ``fn``."""
    from ..utils.flops import count_call

    with _lock:
        if name in _LEDGER and _LEDGER[name].get("analyzed"):
            return dict(_LEDGER[name])
    _, count = count_call(fn, *args, **kwargs)
    return _register(name, _analysis(count, n_partitions), origin=origin,
                     n_partitions=n_partitions, fingerprint=None,
                     device=device)


def note_aot_program(name: str, *, artifact_id=None) -> None:
    """Mark a program's provenance as ahead-of-time before its first
    counted call lands the numbers. Zero-cost while telemetry is off."""
    if not _metrics.enabled():
        return
    with _lock:
        rec = _LEDGER.setdefault(
            name, {"program": name, "flops": None, "hbm_bytes": None,
                   "peak_temp_bytes": None, "roofline": None})
        rec["origin"] = "aot"
        rec["artifact_id"] = artifact_id


def get(name: str) -> Optional[Dict[str, Any]]:
    """The registered record for ``name`` (None when unknown)."""
    with _lock:
        rec = _LEDGER.get(name)
        return dict(rec) if rec else None


def derive_mfu(name: str, seconds: float, *,
               n_devices: int = 1) -> Optional[float]:
    """MFU of one call of ``name`` taking ``seconds``, from the ledger's
    FLOPs and the card's bf16 peak. None when the program is unknown,
    uncounted, or ran where the peak table has no row (the CPU: the
    nominal row is for rooflines, not MFU)."""
    from ..utils import flops as _flops

    rec = get(name)
    if not rec or not rec.get("flops") or seconds <= 0:
        return None
    backend = rec.get("backend", "cpu")
    if not backend.startswith("gpu:"):
        return None
    return _flops.mfu(rec["flops"] / seconds, device=backend[4:],
                      n_devices=max(n_devices, rec.get("n_partitions", 1)))


def observe_step(name: str, seconds: float, *,
                 n_devices: int = 1) -> Optional[float]:
    """Record a measured step time against program ``name``: sets the
    ``pt_step_mfu`` gauge from the ledger-derived MFU and returns it.
    Zero-cost while telemetry is off."""
    if not _metrics.enabled():
        return None
    m = derive_mfu(name, seconds, n_devices=n_devices)
    if m is not None:
        _cost_metrics()["mfu"].set(m)
    return m


def ledger() -> Dict[str, Dict[str, Any]]:
    """Snapshot of every registered record (copies)."""
    with _lock:
        return {k: dict(v) for k, v in _LEDGER.items()}


def statusz_section() -> Dict[str, Any]:
    """The /statusz ``costs`` section: the whole ledger plus the peak
    row the verdicts were judged against."""
    return {"programs": ledger(), "peaks": backend_peaks()}


def reset() -> None:
    """Drop every record (tests / between bench phases)."""
    with _lock:
        _LEDGER.clear()


__all__ = ["analyze_callable", "backend_key", "backend_peaks", "counting",
           "derive_mfu", "ensure_program", "get", "known", "ledger",
           "note_aot_program", "observe_step", "reset", "roofline",
           "statusz_section"]
