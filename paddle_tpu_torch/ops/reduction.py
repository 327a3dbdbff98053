"""Reduction ops (counterpart of paddle_tpu/ops/reduction.py; reference:
paddle/fluid/operators/reduce_ops/): sum, mean, max, min, prod, all and
any over ``dim`` (every dim when None), plus ``mean`` of everything and
``sum`` of a list. A mean of integers is a float32 mean, as
``jnp.mean``'s."""

from __future__ import annotations

import builtins
from typing import Optional, Sequence, Union

import torch

Axes = Optional[Union[int, Sequence[int]]]


def _norm_axes(x, axes: Axes):
    if axes is None:
        return tuple(range(x.ndim))
    if isinstance(axes, int):
        return (axes,)
    return tuple(axes)


def _floating(x):
    return x if x.is_floating_point() else x.to(torch.float32)


def reduce_sum(x, dim: Axes = None, keep_dim: bool = False):
    return torch.sum(x, dim=_norm_axes(x, dim), keepdim=keep_dim)


def reduce_mean(x, dim: Axes = None, keep_dim: bool = False):
    return torch.mean(_floating(x), dim=_norm_axes(x, dim),
                      keepdim=keep_dim)


def reduce_max(x, dim: Axes = None, keep_dim: bool = False):
    return torch.amax(x, dim=_norm_axes(x, dim), keepdim=keep_dim)


def reduce_min(x, dim: Axes = None, keep_dim: bool = False):
    return torch.amin(x, dim=_norm_axes(x, dim), keepdim=keep_dim)


def reduce_prod(x, dim: Axes = None, keep_dim: bool = False):
    """One ``torch.prod`` per axis (it takes one dim), the highest first
    so the lower axes keep their numbers."""
    for a in sorted((a % x.ndim for a in _norm_axes(x, dim)),
                    reverse=True):
        x = torch.prod(x, dim=a, keepdim=keep_dim)
    return x


def reduce_all(x, dim: Axes = None, keep_dim: bool = False):
    return torch.all(x, dim=_norm_axes(x, dim), keepdim=keep_dim)


def reduce_any(x, dim: Axes = None, keep_dim: bool = False):
    return torch.any(x, dim=_norm_axes(x, dim), keepdim=keep_dim)


def mean(x):
    """reference: operators/mean_op.cc — the scalar mean of everything."""
    return torch.mean(_floating(x))


def sum(xs):  # noqa: A001 - the reference's name
    """reference: operators/sum_op.cc — the sum of a list of same-shape
    tensors (of everything, for one tensor)."""
    if not isinstance(xs, (list, tuple)):
        return torch.sum(xs)
    return builtins.sum(xs[1:], xs[0])
