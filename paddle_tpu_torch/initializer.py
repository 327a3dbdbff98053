"""Parameter initializers (counterpart of paddle_tpu/initializer.py).

An initializer is ``(shape, dtype, device, generator) -> tensor``. The
distributions match the JAX package's; the draws do not (a different
generator). Weights that must agree across the two packages cross with
:func:`paddle_tpu_torch.utils.convert.load_numpy_state`."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def _fans(shape: Sequence[int]):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    rf = math.prod(shape[2:])
    return shape[1] * rf, shape[0] * rf


class Initializer:
    def __call__(self, shape, dtype: torch.dtype, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype, device, generator=None):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=device)


class XavierUniform(Initializer):
    """U(-limit, limit), limit = gain * sqrt(6 / (fan_in + fan_out))."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, shape, dtype, device, generator=None):
        fan_in, fan_out = _fans(shape)
        limit = self.gain * math.sqrt(6.0 / (fan_in + fan_out))
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        return out.uniform_(-limit, limit, generator=generator)


class XavierNormal(Initializer):
    """N(0, std), std = gain * sqrt(2 / (fan_in + fan_out))."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, shape, dtype, device, generator=None):
        fan_in, fan_out = _fans(shape)
        std = self.gain * math.sqrt(2.0 / (fan_in + fan_out))
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        return out.normal_(0.0, std, generator=generator)
