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
    must match exactly: a sharding plan's placed shard
    (parallel/sharding.py) takes its whole shape, and this rank's shard
    of the value is cut from the whole state, so a JAX state trains
    under a plan."""
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
        whole = getattr(target, "_pt_global_shape", tuple(target.shape))
        if tuple(value.shape) != tuple(whole):
            raise InvalidArgumentError(
                f"{name}: shape {tuple(value.shape)} != {tuple(whole)}")
        sharding = getattr(target, "_pt_sharding", None)
        if sharding is not None:
            values[name] = value = np.array(sharding.local(value))
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


def hybrid_params(arrays, like, *, ring=None):
    """This rank's params of a hybrid builder (parallel/hybrid.py) from a
    JAX hybrid builder's, as numpy: ``arrays`` is ``{"layers": {name:
    (L, ...)}, "rest": {name: array}}`` (or the transformer builder's
    flat ``{name: array}``), ``like`` the port builder's params of the
    same structure, whose leaves carry the layout. Each array is cut to
    this rank's shard under its leaf's sharding and returned as a new
    trainable leaf on the leaf's device, marked as it is. The stack
    crosses in the order it is given: the JAX builders store it in ring
    order under the interleaved schedule, as the port's do. ``ring=(n,
    v)`` takes a LOGICAL-order stack into the ring order of n pp ranks
    and v virtual stages first."""
    from ..parallel import sharding as S
    from ..parallel.pipeline import ring_order_layers

    def leaf(a, t, stacked):
        a = np.asarray(a)
        if stacked and ring is not None:
            a = ring_order_layers(torch.from_numpy(np.array(a)),
                                  *ring).numpy()
        whole = tuple(getattr(t, "_pt_global_shape", t.shape))
        if a.shape != whole:
            raise InvalidArgumentError(
                f"hybrid_params: an array of shape {a.shape} for a leaf of "
                f"whole shape {whole}")
        value = torch.from_numpy(np.array(a)).to(t.dtype)
        sh = S.sharding_of(t)
        if sh is not None:
            value = sh.local(value)
        out = torch.nn.Parameter(value.to(t.device).contiguous())
        if sh is not None:
            S.mark(out, sh, whole)
        return out

    if "layers" in like and isinstance(like["layers"], dict):
        return {g: {k: leaf(arrays[g][k], t, g == "layers")
                    for k, t in like[g].items()} for g in like}
    return {k: leaf(arrays[k], t, False) for k, t in like.items()}
