"""Parameter initializers (counterpart of paddle_tpu/initializer.py).

An initializer is ``(shape, dtype, device, generator) -> tensor``. The
distributions match the JAX package's; the draws do not (a different
generator). Weights that must agree across the two packages cross with
:func:`paddle_tpu_torch.utils.convert.load_numpy_state`."""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import numpy as np
import torch

from .core.enforce import enforce


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


class Uniform(Initializer):
    """U(low, high)."""

    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, device, generator=None):
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        return out.uniform_(self.low, self.high, generator=generator)


class Normal(Initializer):
    """N(loc, scale)."""

    def __init__(self, loc: float = 0.0, scale: float = 1.0):
        self.loc, self.scale = loc, scale

    def __call__(self, shape, dtype, device, generator=None):
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        return out.normal_(self.loc, self.scale, generator=generator)


class TruncatedNormal(Initializer):
    """A standard normal truncated to [-2, 2], times ``scale``, plus
    ``loc`` (``jax.random.truncated_normal``'s bounds)."""

    def __init__(self, loc: float = 0.0, scale: float = 1.0):
        self.loc, self.scale = loc, scale

    def __call__(self, shape, dtype, device, generator=None):
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return out.mul_(self.scale).add_(self.loc)


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


class MSRA(Initializer):
    """Kaiming/He initialisation from the fan in (``fan_in`` overrides
    the shape's): U(-sqrt(6 / fan_in), sqrt(6 / fan_in)) when
    ``uniform``, else N(0, sqrt(2 / fan_in))."""

    def __init__(self, uniform: bool = True, fan_in=None):
        self.uniform = uniform
        self.fan_in = fan_in

    def __call__(self, shape, dtype, device, generator=None):
        fan_in = self.fan_in or _fans(shape)[0]
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        if self.uniform:
            limit = math.sqrt(6.0 / fan_in)
            return out.uniform_(-limit, limit, generator=generator)
        return out.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)


class Bilinear(Initializer):
    """The bilinear upsampling kernel for a transposed convolution,
    weight (C_in, C_out, kh, kw): channel i's filter in output channel
    min(i, C_out - 1), zeros elsewhere. Deterministic: the JAX
    package's values exactly."""

    def __call__(self, shape, dtype, device, generator=None):
        kh, kw = shape[-2], shape[-1]
        f_h, f_w = (kh + 1) // 2, (kw + 1) // 2
        og = np.ogrid[:kh, :kw]
        filt = ((1 - np.abs(og[0] - (kh - 1) / 2.0) / f_h)
                * (1 - np.abs(og[1] - (kw - 1) / 2.0) / f_w))
        weight = np.zeros(tuple(shape), np.float32)
        for i in range(shape[0]):
            weight[i, min(i, shape[1] - 1)] = filt
        return torch.as_tensor(weight, dtype=dtype, device=device)


class NumpyArray(Initializer):
    """Fixed values; the shape asked for must be the array's."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, shape, dtype, device, generator=None):
        enforce(tuple(self.value.shape) == tuple(shape),
                "NumpyArray initializer shape %s != %s", self.value.shape,
                tuple(shape))
        return torch.as_tensor(self.value, dtype=dtype, device=device)


# Paddle-style aliases
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
XavierInitializer = XavierUniform
MSRAInitializer = MSRA
BilinearInitializer = Bilinear
NumpyArrayInitializer = NumpyArray


def force_init_on_cpu() -> bool:
    """reference: initializer.py force_init_on_cpu — parameters are made
    on the device their layer is given; reported False always."""
    return False


@contextlib.contextmanager
def init_on_cpu():
    """reference: initializer.py init_on_cpu — a no-op scope: a layer's
    ``device=`` decides where its parameters are made (``device="cpu"``
    for the CPU)."""
    yield
