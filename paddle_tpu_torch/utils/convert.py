"""The weight bridge from the JAX package (counterpart of
``Layer.set_parameters``, paddle_tpu/nn/layer.py): parameters and
buffers cross by their dotted names, as numpy arrays. Names and layouts
are the same in both packages (Linear weights (in, out), the tied head
read as ``embed.weight.T``), so nothing is transposed."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.enforce import InvalidArgumentError


def load_numpy_state(model: torch.nn.Module,
                     flat: Dict[str, np.ndarray]) -> None:
    """Copy ``flat`` — e.g. ``{k: np.asarray(v) for k, v in
    jax_model.named_parameters().items()}``, plus any of its
    ``named_buffers()`` — into ``model``'s parameters and buffers, in
    place, on their device. Every parameter must be present; a buffer
    is loaded when its name is. Parameters are cast to their float
    dtype; a buffer keeps its dtype, which the value must have (an int8
    weight of a quantized layer stays int8 bit for bit). Every shape
    must match exactly."""
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params) - set(buffers))
    if missing or extra:
        raise InvalidArgumentError(
            f"parameter names differ: missing {missing}, unexpected {extra}")
    # np.array copies: the source may be a read-only view
    values = {name: np.array(value) for name, value in flat.items()}
    for name, value in values.items():
        target = params.get(name, buffers.get(name))
        if tuple(value.shape) != tuple(target.shape):
            raise InvalidArgumentError(
                f"{name}: shape {tuple(value.shape)} != "
                f"{tuple(target.shape)}")
        if name in buffers and (torch.from_numpy(value).dtype
                                != target.dtype):
            raise InvalidArgumentError(
                f"buffer {name}: dtype {value.dtype} != {target.dtype}")
    with torch.no_grad():
        for name, value in values.items():
            if name in params:
                value = value.astype(np.float32)
            params.get(name, buffers.get(name)).copy_(
                torch.from_numpy(value))
