"""The weight bridge from the JAX package (counterpart of
``Layer.set_parameters``, paddle_tpu/nn/layer.py): parameters cross by
their dotted names, as numpy arrays. Names and layouts are the same in
both packages (Linear weights (in, out), the tied head read as
``embed.weight.T``), so nothing is transposed."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.enforce import InvalidArgumentError


def load_numpy_state(model: torch.nn.Module,
                     flat: Dict[str, np.ndarray]) -> None:
    """Copy ``flat`` — e.g. ``{k: np.asarray(v) for k, v in
    jax_model.named_parameters().items()}`` — into ``model``'s
    parameters, in place, on their device and in their dtype. The key
    sets and every shape must match exactly."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise InvalidArgumentError(
            f"parameter names differ: missing {missing}, unexpected {extra}")
    for name, p in params.items():
        value = np.asarray(flat[name])
        if tuple(value.shape) != tuple(p.shape):
            raise InvalidArgumentError(
                f"parameter {name}: shape {tuple(value.shape)} != "
                f"{tuple(p.shape)}")
    with torch.no_grad():
        for name, p in params.items():
            # np.array copies: the source may be a read-only view
            p.copy_(torch.from_numpy(np.array(flat[name], np.float32)))
