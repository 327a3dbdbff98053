"""Signature tracker (counterpart of paddle_tpu/telemetry/recompile.py,
the same counters and report).

The JAX package fingerprints the abstract signature of each jitted
dispatch, and a never-seen signature there is a trace and an XLA
compile. The port compiles nothing per signature: its step and tick run
eagerly, and the hand kernels are built once per source. So in the port
a "compile" is a first-seen signature at a call site, the point where a
program of the JAX package would have compiled, and a "recompile" a new
signature at a site that already had one: a shape or dtype drift in a
feed, a weight swap between serving runs, a new prompt bucket. The names
stay the JAX package's (``pt_jit_compiles_total``,
``pt_jit_recompiles_total``, labeled per site), so one dashboard reads
both. Repeated same-shape calls are set-membership hits, and the whole
``record()`` call is skipped while telemetry is disabled.

Host-side only: fingerprints read ``.shape``/``.dtype`` duck-typed,
never values, so tracked arguments may be tensors (on the card or not),
numpy arrays or Python scalars; reading a shape never waits for the
card.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

from . import metrics as _metrics


class Opaque:
    """Pre-computed fingerprint component: participates by VALUE.

    For a large subtree that only changes at known moments (a serving
    weight snapshot taken once per ``run()``), fingerprint it there, wrap
    ``hash(fp)`` in an Opaque and pass that to ``record`` every tick:
    O(1) per dispatch instead of re-walking every leaf."""

    __slots__ = ("token",)

    def __init__(self, token):
        self.token = token


def fingerprint(tree: Any) -> Tuple:
    """Hashable abstract signature of a pytree of arrays/scalars:
    container structure + (shape, dtype) per array leaf, type name per
    scalar leaf. Values never participate (except :class:`Opaque`
    tokens, which are values by construction)."""
    if isinstance(tree, Opaque):
        return ("o", tree.token)
    if isinstance(tree, dict):
        return ("d",) + tuple(
            (k, fingerprint(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return ("l",) + tuple(fingerprint(v) for v in tree)
    shape = getattr(tree, "shape", None)
    dtype = getattr(tree, "dtype", None)
    if shape is not None and dtype is not None:
        return ("a", tuple(shape), str(dtype))
    return ("s", type(tree).__name__)


class RecompileTracker:
    """Per-call-site signature sets + compile/recompile counters."""

    def __init__(self, registry=None):
        self._sites: Dict[str, set] = {}
        self._calls: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._registry = registry

    def _reg(self):
        return self._registry or _metrics.registry()

    def record(self, site: str, *args: Any, **kwargs: Any) -> bool:
        """Record one dispatch at ``site`` with ``args``/``kwargs`` as
        the traced arguments. Returns True when the signature is new
        (i.e. this dispatch pays a trace+compile)."""
        fp = fingerprint((args, kwargs)) if (args or kwargs) else ("0",)
        with self._lock:
            seen = self._sites.get(site)
            if seen is None:
                seen = self._sites[site] = set()
            self._calls[site] = self._calls.get(site, 0) + 1
            if fp in seen:
                return False
            first = not seen
            seen.add(fp)
        reg = self._reg()
        reg.counter("pt_jit_compiles_total",
                    "new jitted-call signatures (trace+compile events)",
                    labels={"site": site}).inc()
        if not first:
            reg.counter(
                "pt_jit_recompiles_total",
                "jitted-call signature CHANGES at an already-compiled "
                "site (silent retraces)", labels={"site": site}).inc()
        return True

    def recompiles(self, site: str) -> int:
        """Recompile count for one site (signatures seen beyond the
        first; 0 for an unknown site)."""
        with self._lock:
            seen = self._sites.get(site)
            return max(0, len(seen) - 1) if seen else 0

    def stats(self) -> Dict[str, dict]:
        with self._lock:
            return {s: {"signatures": len(v),
                        "calls": self._calls.get(s, 0),
                        "recompiles": max(0, len(v) - 1)}
                    for s, v in self._sites.items()}

    def reset(self) -> None:
        with self._lock:
            self._sites.clear()
            self._calls.clear()


_tracker = RecompileTracker()


def tracker() -> RecompileTracker:
    return _tracker


def record(site: str, *args: Any, **kwargs: Any) -> bool:
    """Module-level shorthand on the process-global tracker. Call-sites
    still guard with ``telemetry.enabled()`` first — this does dict
    work."""
    return _tracker.record(site, *args, **kwargs)
