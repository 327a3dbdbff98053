"""Layer: the module system (counterpart of paddle_tpu/nn/layer.py).

The JAX package's Layer is a mutable container whose compiled entry
points are functional. Here it is a ``torch.nn.Module``: PyTorch runs
eagerly, so nothing has to be injected. What carries over is the naming
— parameters are registered under the same dotted paths
(``blocks.0.self_attn.q_proj.weight``) and layouts, so a state moves
between the packages by name (utils/convert.py).

Every layer takes an explicit ``device=`` (the CUDA card when None; see
core/places.py) and ``generator=`` (a ``torch.Generator`` on that device,
for its initial draws)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..core.dtypes import default_dtype, to_dtype
from ..core.places import DeviceLike, resolve_device


class Layer(nn.Module):
    """Base class for all network modules of the port. ``name_scope`` is
    accepted for the JAX package's signature, which stores nothing of it
    either."""

    def __init__(self, name_scope: Optional[str] = None):
        super().__init__()

    def create_parameter(self, name: str, shape, dtype=None,
                         initializer: Optional[Callable] = None,
                         is_bias: bool = False, *,
                         device: DeviceLike = None,
                         generator: Optional[torch.Generator] = None):
        """Create, initialise and register parameter ``name``
        (LayerHelper.create_parameter analog)."""
        from ..initializer import Constant, XavierUniform

        dtype = to_dtype(dtype) if dtype is not None else default_dtype()
        if initializer is None:
            initializer = Constant(0.0) if is_bias else XavierUniform()
        value = initializer(tuple(shape), dtype, resolve_device(device),
                            generator)
        param = nn.Parameter(value)
        self.register_parameter(name, param)
        return param


class LayerList(nn.ModuleList):
    """reference: dygraph LayerList — children named "0", "1", ..."""

    def __init__(self, layers=()):
        super().__init__(layers)


class Sequential(nn.Sequential):
    """reference: dygraph Sequential — children named "0", "1", ..., so
    parameter names match the JAX package's."""
