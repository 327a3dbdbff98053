"""Memory-usage estimation (counterpart of paddle_tpu/utils/memory.py;
reference: python/paddle/fluid/contrib/memory_usage_calc.py, which
estimates a program's training memory from variable shapes so users size
batch and devices before running).

Two modes:
  - static: parameter, gradient and optimizer-slot accounting from the
    module's state (exact), plus an activation estimate: the bytes of
    every tensor one forward's aten ops allocate, seen by a dispatch
    mode (an upper bound: nothing is freed or fused in the count);
  - measured (the JAX package's "compiled" mode, whose numbers come from
    XLA's buffer assignment): :func:`memory_usage` runs one step on the
    card and reads ``torch.cuda.max_memory_allocated``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_OPT_SLOTS = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 2, "lamb": 2,
              "adagrad": 1, "adadelta": 2, "rmsprop": 2, "ftrl": 2}


def owned_on_device(x):
    """A tensor that owns its memory: a CPU tensor is cloned, since it
    may share storage with a numpy array (``torch.from_numpy`` aliases,
    as the JAX CPU client aliases aligned numpy arrays), and an update in
    place would then write the caller's array. A card tensor was copied
    onto the card and passes through, as does anything not a tensor."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cpu":
        return x
    return x.clone()


def bytes_of_tree(tree) -> int:
    """Exact byte count of a tree (dicts, lists, tuples) of tensors or
    arrays."""
    from torch.utils._pytree import tree_leaves

    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            total += (int(np.prod(leaf.shape, dtype=np.int64))
                      * np.dtype(leaf.dtype).itemsize)
    return total


def format_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.2f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n:.2f} TiB"


def activation_bytes(fn, *example_args) -> int:
    """Upper-bound activation footprint of ``fn(*example_args)``: the
    bytes every allocating aten op of one call produces (views and
    in-place updates aside), run under ``torch.no_grad()``."""
    from .flops import count_call

    with torch.no_grad():
        _, count = count_call(fn, *example_args)
    return int(count.activation_bytes)


def estimate_training_memory(model, example_args, optimizer: str = "adam",
                             dtype_bytes=None,
                             num_devices: int = 1) -> Dict[str, Any]:
    """Estimate per-device training memory for a Layer model.

    Returns dict of byte counts: params, grads, optimizer_state,
    activations_upper_bound, total, and human-readable strings.
    ``num_devices``: with pure DP the params replicate (divide only the
    activations); pass sharded trees to ``bytes_of_tree`` directly for
    TP/ZeRO accounting."""
    params = dict(model.named_parameters())
    p_bytes = bytes_of_tree(params)
    slots = _OPT_SLOTS.get(optimizer.lower(), 2)
    opt_bytes = p_bytes * slots
    grad_bytes = p_bytes
    act_bytes = activation_bytes(model, *example_args)
    act_bytes //= max(num_devices, 1)  # dp shards the batch
    total = p_bytes + grad_bytes + opt_bytes + act_bytes
    return {
        "params_bytes": p_bytes,
        "grads_bytes": grad_bytes,
        "optimizer_state_bytes": opt_bytes,
        "activations_upper_bound_bytes": act_bytes,
        "total_bytes": total,
        "summary": (f"params {format_bytes(p_bytes)} + grads "
                    f"{format_bytes(grad_bytes)} + opt({optimizer}) "
                    f"{format_bytes(opt_bytes)} + activations<= "
                    f"{format_bytes(act_bytes)} = {format_bytes(total)}"),
    }


def memory_usage(fn, *args, **kwargs) -> Dict[str, int]:
    """Measured numbers of one call ``fn(*args, **kwargs)`` on the card:
    the arguments' and outputs' bytes, and ``temp_size_in_bytes``, the
    peak the call's allocations reached above what was allocated before
    it (``torch.cuda.max_memory_allocated`` after
    ``reset_peak_memory_stats``, which this resets). Raises
    :class:`DeviceUnavailableError` without a card: the CPU has no
    allocator statistics to read."""
    from ..core.enforce import DeviceUnavailableError

    if not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "memory_usage measures one call on the card (its allocator's "
            "peak); no CUDA device is available")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    res = {"argument_size_in_bytes": bytes_of_tree((args, kwargs)),
           "output_size_in_bytes": bytes_of_tree(out),
           "temp_size_in_bytes": max(0, peak - before)}
    res["total_bytes"] = sum(res.values())
    return res
