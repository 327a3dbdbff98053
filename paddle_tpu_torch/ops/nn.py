"""Neural-network ops (counterpart of the matching functions in
paddle_tpu/ops/nn.py): normalisations, the embedding lookup and
dropout."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.enforce import enforce


def layer_norm(x, scale=None, bias=None, *, begin_norm_axis: int = 1,
               epsilon: float = 1e-5):
    """Normalize over dims [begin_norm_axis, ndim): (x - mean) *
    rsqrt(var + eps), var the population variance taken as the JAX
    package takes it (mean of the squared deviations), then [* scale]
    [+ bias]."""
    axes = tuple(range(begin_norm_axis, x.ndim))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axes, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + epsilon)
    norm_shape = x.shape[begin_norm_axis:]
    if scale is not None:
        y = y * scale.reshape(norm_shape)
    if bias is not None:
        y = y + bias.reshape(norm_shape)
    return y


def rms_norm(x, scale=None, *, epsilon: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) [* scale], over the last axis."""
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + epsilon)
    if scale is not None:
        y = y * scale
    return y


def dropout(x, p: float, generator: Optional[torch.Generator] = None, *,
            training: bool = True, mode: str = "upscale_in_train"):
    """Dropout (the reference's dropout_op and its
    dropout_implementation). In eval mode or at p == 0 the identity,
    except that ``downgrade_in_infer`` scales by 1 - p in eval mode. In
    training an entry is kept where a uniform draw from ``generator``
    (the JAX package's PRNG key) is below 1 - p: ``upscale_in_train``
    scales the kept entries by 1 / (1 - p), ``downgrade_in_infer`` keeps
    them as they are."""
    if not training or p == 0.0:
        if mode == "downgrade_in_infer" and not training:
            return x * (1.0 - p)
        return x
    enforce(generator is not None,
            "dropout in training mode requires a torch.Generator (open "
            "core.rng_scope, as Trainer.train_step does)")
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator,
                      device=generator.device) < keep
    mask = mask.to(x.device)
    if mode == "upscale_in_train":
        return torch.where(mask, x / keep, 0.0).to(x.dtype)
    return torch.where(mask, x, 0.0).to(x.dtype)


def embedding(ids, table, padding_idx: Optional[int] = None):
    """Row lookup ``table[ids]``; rows of ``padding_idx`` read as zeros."""
    out = table[ids]
    if padding_idx is not None:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return out
