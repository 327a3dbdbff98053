"""Gradient clipping (counterpart of paddle_tpu/clip.py):
GradientClipByValue, GradientClipByNorm, GradientClipByGlobalNorm,
ErrorClipByValue and ``global_norm``.

Each clip is a callable ``grads -> grads`` over a tree of tensors (a
tensor, or a dict, list or tuple of trees), pluggable into
``Optimizer(grad_clip=...)``. It returns new tensors and reads nothing
back to the host."""

from __future__ import annotations

import torch


def tree_map(f, *trees):
    """Apply ``f`` leaf-wise over matching dicts, lists and tuples."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(f, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(f, *leaves) for leaves in zip(*trees))
    return f(*trees)


def tree_leaves(tree):
    """The leaves of ``tree`` in the JAX package's order: a dict's in
    sorted-key order (``jax.tree_util`` flattens dicts so), a list's or
    tuple's in order. Optimizer state is indexed by this order, so its
    i-th entry belongs to the i-th parameter by sorted name in both
    packages."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


class GradientClipByValue:
    def __init__(self, max: float, min: float = None):  # noqa: A002
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, grads):
        return tree_map(lambda g: torch.clamp(g, self.min, self.max), grads)


def sq_sum(x, sharding=None) -> torch.Tensor:
    """The sum of squares of ``x``, in its dtype; summed over the ranks
    that hold the other shards where ``x`` is a placed shard (its
    ``_pt_sharding``, or ``sharding``: parallel/sharding.py), so every
    rank gets the whole tensor's."""
    out = torch.sum(torch.square(x))
    sh = sharding if sharding is not None else getattr(
        x, "_pt_sharding", None)
    if sh is not None and sh.axes():
        from .parallel.collective import allreduce

        out = allreduce(out, sh.axes(), mesh=sh.mesh)
    return out


class GradientClipByNorm:
    """Per-tensor L2 clip (reference: clip.py GradientClipByNorm)."""

    def __init__(self, clip_norm: float):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        def clip_one(g):
            norm = torch.sqrt(sq_sum(g))
            return torch.where(norm > self.clip_norm,
                               g * (self.clip_norm / norm), g)

        return tree_map(clip_one, grads)


def global_norm(grads) -> torch.Tensor:
    """L2 norm of every leaf together, in float32 (a placed shard's part
    summed over its ranks: :func:`sq_sum`)."""
    return torch.sqrt(sum(sq_sum(g.float(), getattr(g, "_pt_sharding", None))
                          for g in tree_leaves(grads)))


class GradientClipByGlobalNorm:
    """Global-norm clip (reference: clip.py GradientClipByGlobalNorm)."""

    def __init__(self, clip_norm: float):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        factor = torch.clamp(
            self.clip_norm / torch.clamp(global_norm(grads), min=1e-12),
            max=1.0)
        return tree_map(lambda g: g * factor.to(g.dtype), grads)


class ErrorClipByValue:
    """reference: clip.py ErrorClipByValue — clip a single tensor."""

    def __init__(self, max: float, min: float = None):  # noqa: A002
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, x):
        return torch.clamp(x, self.min, self.max)
