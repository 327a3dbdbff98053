"""FLOPs accounting and MFU (counterpart of paddle_tpu/utils/flops.py).

MFU = (model FLOPs executed per second) / (the card's peak FLOP/s). The
JAX package reads the FLOPs from XLA's cost model over the lowered
program. The port has no program to lower: it counts one real call.
:func:`count_call` runs the call under a ``TorchDispatchMode`` that
counts every aten op by the rules of ``torch.utils.flop_counter`` (the
registry ``FlopCounterMode`` counts with: matmuls, convolutions and the
library's attention ops; elementwise ops count no FLOPs) and sums each
op's input and output bytes, views aside.

The hand kernels launch through ``ctypes``, so no dispatch mode sees
them. Each kernel wrapper is wrapped by :func:`costed`, which adds the
kernel's FLOPs, reckoned from its shapes, and its own bytes (each input
read once, each output written once), and hides the wrapper's body from
the mode, so the plain version a wrapper runs on CPU tensors is not
counted a second time. Attention is reckoned by the convention the plain
path's products give: QK^T and PV, 2 x B x H x Tq x Tk x D each, over
the whole score matrix (causal or not, as the plain path computes it);
the backward's four products (dP, dQ for dq; dV, dK for dk/dv) twice
that. So a step counts the same FLOPs whether the kernels or the plain
versions run; XLA also counts elementwise FLOPs, so the JAX package's
count of the same step is somewhat larger.

Peak numbers are the card's dense peak for the type feeding its tensor
cores. Override with ``PT_PEAK_FLOPS`` (absolute FLOP/s) on a card not in
the table.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# Dense peak FLOP/s per card by device-name substring (lowercased),
# NVIDIA's data sheet for the H100 SXM at its 700 W limit. float32 is the
# 3xTF32 products the flash kernels run (three TF32 products a float32
# one), the port's float32 bound; a card below 700 W runs below these.
_PEAK = {
    "h100": {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12,
             "float32": 495e12 / 3, "int8": 1979e12},
}
# HBM bytes/s by the same substrings (H100 SXM: 3.35 TB/s)
HBM_BYTES_PER_S = {"h100": 3.35e12}


def device_kind(device: Optional[Any] = None) -> Optional[str]:
    """The card's name for ``device`` (None: card 0), or None for the
    CPU or when no card is visible. ``device`` may be an index, a
    ``torch.device``, a device string or a card's name."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device
    if device is None:
        if not torch.cuda.is_available():
            return None
        return torch.cuda.get_device_name(0)
    dev = torch.device(device) if not isinstance(device, int) else \
        torch.device("cuda", device)
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_name(dev.index or 0)


def device_peak_flops(device: Optional[Any] = None,
                      dtype: str = "bf16") -> Optional[float]:
    """Peak FLOP/s for ``device`` (default: card 0) in ``dtype`` (bf16,
    fp16, tf32, float32 or int8). None when unknown (the CPU first):
    callers then omit MFU rather than report a bogus one."""
    env = os.environ.get("PT_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass  # malformed override: fall back to the table
    kind = (device_kind(device) or "").lower()
    for key, peaks in _PEAK.items():
        if key in kind:
            return peaks.get(dtype, peaks["bf16"])
    return None


def _unavailable(what: str):
    from ..core.enforce import InvalidArgumentError

    raise InvalidArgumentError(
        f"{what} configures JAX's persistent compilation cache; the port "
        f"compiles no program per call (its kernels are built once per "
        f"source into build/kernels), so it has no torch meaning")


def _harden_cache_writes() -> None:
    """Raises: the JAX package patches its compile cache's writes."""
    _unavailable("_harden_cache_writes")


def enable_compile_cache(path: Optional[str] = None) -> Optional[str]:
    """Raises: the JAX package points its compile cache at a directory."""
    _unavailable("enable_compile_cache")


# ---------------------------------------------------------------------------
# counting one call
# ---------------------------------------------------------------------------

class CostCount:
    """What one counted call did: ``flops``, ``bytes`` (aten ops' and
    hand kernels' inputs and outputs), ``ops`` (aten ops seen),
    ``kernels`` ({wrapper name: calls}) and ``activation_bytes`` (the
    outputs of the aten ops that allocate, the activations' upper
    bound)."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.activation_bytes = 0
        self.kernels: Dict[str, int] = {}


_LIVE = [0]    # modes open in the process: the zero-cost check


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in a tree (args, kwargs, outputs)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _backend_kernel(func, args, kwargs) -> bool:
    """Whether ``func`` has a kernel of its own for the device of its
    first tensor argument (the kernel an uncounted call would run)."""
    dev = next((t.device.type for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)), "cpu")
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), "CUDA" if dev == "cuda" else "CPU")


class _CostMode(TorchDispatchMode):
    """Counts each aten op into a :class:`CostCount`."""

    def __init__(self, count: CostCount):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rule = flop_registry.get(func._overloadpacket)
        if rule is None and not _backend_kernel(func, args, kwargs):
            # a composite op with no kernel of its own (matmul, einsum,
            # linear under inference mode) counts as the ops it decomposes
            # into, as FlopCounterMode counts it; an op with a backend
            # kernel runs it, so a counted call computes bit for bit what
            # an uncounted one does
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        c = self.count
        c.ops += 1
        if rule is not None:
            c.flops += float(rule(*args, **kwargs, out_val=out))
        if not func.is_view:
            moved = tensor_bytes(out)
            c.bytes += tensor_bytes(args) + tensor_bytes(kwargs) + moved
            if not func._schema.is_mutable:
                c.activation_bytes += moved
        return out


def _active() -> Optional[CostCount]:
    """The count of the innermost mode on this thread's dispatch stack
    (the autograd engine's threads inherit it), or None."""
    if not _LIVE[0]:
        return None
    for m in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(m, _CostMode):
            return m.count
    return None


@contextlib.contextmanager
def counting():
    """Count every aten op and hand kernel run inside the block (a
    backward inside it counts too); yields the :class:`CostCount`. The
    block's work is the real one: its effects happen once."""
    count = CostCount()
    _LIVE[0] += 1
    try:
        with _CostMode(count):
            yield count
    finally:
        _LIVE[0] -= 1


def count_call(fn: Callable, *args, **kwargs) -> Tuple[Any, CostCount]:
    """Run ``fn(*args, **kwargs)`` once under :func:`counting`; returns
    (its result, the count)."""
    with counting() as count:
        out = fn(*args, **kwargs)
    return out, count


def costed(cost: Callable[..., Tuple[float, int]]):
    """Decorator for a hand kernel's wrapper: while a count runs,
    ``cost(*args, **kwargs)`` gives the kernel's (FLOPs, input bytes),
    the outputs' bytes are added after the call, and the wrapper's body
    runs with the dispatch modes off (on a CPU tensor it runs the plain
    version, whose ops must not count twice). Outside a count it is one
    list read."""

    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            count = _active()
            if count is None:
                return fn(*args, **kwargs)
            flops, nbytes = cost(*args, **kwargs)
            with _disable_current_modes():
                out = fn(*args, **kwargs)
            count.flops += float(flops)
            count.bytes += nbytes + tensor_bytes(out)
            count.kernels[fn.__name__] = count.kernels.get(fn.__name__, 0) + 1
            return out

        return wrapper

    return wrap


def attention_flops(b: int, h: int, tq: int, tk: int, d: int) -> float:
    """One of attention's two products over the whole score matrix:
    2 x B x H x Tq x Tk x D (the forward is two, the backward four)."""
    return 2.0 * b * h * tq * tk * d


def lowered_flops(fn: Callable, *args, n_partitions: int = 1,
                  **kwargs) -> Optional[float]:
    """GLOBAL FLOPs of one call of ``fn(*args)``: counted over the real
    call (see the module docstring), times ``n_partitions`` when the call
    is one rank's share of a program spanning that many. None when it
    counts none. Unlike the JAX package, which lowers without running,
    this runs ``fn``: an error of the call propagates."""
    _, count = count_call(fn, *args, **kwargs)
    if count.flops <= 0:
        return None
    return count.flops * max(1, n_partitions)


def mfu(flops_per_sec: Optional[float], device: Optional[Any] = None,
        dtype: str = "bf16", n_devices: int = 1) -> Optional[float]:
    """Model-FLOPs utilization in [0, 1], or None when either side is
    unknown. ``flops_per_sec`` is the GLOBAL rate, so the peak scales by
    ``n_devices`` when the work spans several cards."""
    if not flops_per_sec:
        return None
    peak = device_peak_flops(device, dtype=dtype)
    if not peak:
        return None
    return flops_per_sec / (peak * max(1, n_devices))
