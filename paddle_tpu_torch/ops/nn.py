"""Neural-network ops of the serving slice (counterpart of the matching
functions in paddle_tpu/ops/nn.py)."""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x, scale=None, *, epsilon: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) [* scale], over the last axis."""
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + epsilon)
    if scale is not None:
        y = y * scale
    return y


def embedding(ids, table, padding_idx: Optional[int] = None):
    """Row lookup ``table[ids]``; rows of ``padding_idx`` read as zeros."""
    out = table[ids]
    if padding_idx is not None:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return out
