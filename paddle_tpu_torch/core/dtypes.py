"""Dtype names and the mixed-precision policy (counterpart of
paddle_tpu/core/dtypes.py). Float32 is the default parameter and
KV-cache type; bfloat16 is the half type a server on the card runs.

A :class:`Policy` says where each dtype applies: ``param_dtype`` (the
master parameters), ``compute_dtype`` (what a Linear casts its input,
weight and bias to) and ``output_dtype`` (what it casts its result to).
The current policy is module-global, as in the JAX package: the layers
read it while they run, and :func:`policy_scope` sets it for a block of
code. It is not ``torch.autocast``, which would also cast the matmuls
the JAX package leaves in float32 (the fused loss head, attention)."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Union

import torch

from ..clip import tree_map
from .enforce import enforce

_DTYPES = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}

DTypeLike = Union[str, torch.dtype]


def to_dtype(d: DTypeLike) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    enforce(d in _DTYPES, "unknown dtype name %s", d)
    return _DTYPES[d]


def is_floating(d: DTypeLike) -> bool:
    return to_dtype(d).is_floating_point


def is_integer(d: DTypeLike) -> bool:
    d = to_dtype(d)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


@dataclasses.dataclass(frozen=True)
class Policy:
    """Mixed-precision policy: where each dtype applies."""

    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    output_dtype: str = "float32"

    def cast_to_compute(self, x):
        return _cast_floating(x, to_dtype(self.compute_dtype))

    def cast_to_output(self, x):
        return _cast_floating(x, to_dtype(self.output_dtype))


# float32 master parameters with bfloat16 (or float16) products and
# float32 outputs in the mixed policies; "bfloat16" leaves the Linears'
# outputs in bfloat16 too
POLICIES = {
    "float32": Policy(),
    "bfloat16": Policy("bfloat16", "bfloat16", "bfloat16"),
    "mixed_bf16": Policy("float32", "bfloat16", "float32"),
    "mixed_fp16": Policy("float32", "float16", "float32"),
}

_current_policy = POLICIES["float32"]


def get_policy() -> Policy:
    return _current_policy


def set_policy(p: Union[str, Policy]) -> Policy:
    """Make ``p`` (a name of :data:`POLICIES` or a :class:`Policy`) the
    current policy; an unknown name raises :class:`EnforceError`."""
    global _current_policy
    if isinstance(p, str):
        enforce(p in POLICIES, "unknown policy %s", p)
        p = POLICIES[p]
    _current_policy = p
    return p


@contextlib.contextmanager
def policy_scope(p: Union[str, Policy]):
    """The policy ``p`` for the block; the previous one comes back on
    exit, an exception's too."""
    prev = get_policy()
    set_policy(p)
    try:
        yield get_policy()
    finally:
        set_policy(prev)


def _cast_floating(x, dtype: torch.dtype):
    """Cast the floating tensors of the tree ``x`` to ``dtype``; other
    leaves come back as they are. The cast is an autograd op, so a
    float32 leaf gets a float32 gradient."""
    def cast_leaf(leaf):
        if torch.is_tensor(leaf) and leaf.is_floating_point():
            return leaf.to(dtype)
        return leaf

    return tree_map(cast_leaf, x)


def default_dtype() -> torch.dtype:
    """The default parameter / cache dtype: float32."""
    return torch.float32
