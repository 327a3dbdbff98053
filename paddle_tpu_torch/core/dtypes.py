"""Dtype names (counterpart of paddle_tpu/core/dtypes.py). Float32 is the
default parameter and KV-cache type, as under the JAX package's default
``Policy``; bfloat16 is the half type a server on the card runs."""

from __future__ import annotations

from typing import Union

import torch

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


def default_dtype() -> torch.dtype:
    """The default parameter / cache dtype: float32."""
    return torch.float32
