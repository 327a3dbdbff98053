"""Activations (counterpart of the activation half of
paddle_tpu/ops/math.py, and of the ``jax.nn`` activations that the JAX
package's ``act=`` falls back to).

``activation(name)`` resolves a layer's ``act=`` name as the JAX
package's ``_apply_act`` does: the one-argument activations of its
``ops.math`` first, then ``jax.nn``'s. Each function keeps the JAX
package's defaults, which differ from torch's: ``leaky_relu``'s slope is
0.02, ``gelu`` is exact (erf, not tanh), ``softmax`` and
``log_softmax`` normalize the last axis, ``hard_sigmoid`` is
``clip(0.2 x + 0.5, 0, 1)``. A name outside :data:`ACTIVATIONS` raises
:class:`InvalidArgumentError`; torch-only names such as ``hardswish``
are refused, since the JAX package refuses them."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.enforce import InvalidArgumentError

# ----- ops.math's activations (the reference's functor table) ------------


def sigmoid(x):
    return torch.sigmoid(x)


def logsigmoid(x):
    return F.logsigmoid(x)


def exp(x):
    return torch.exp(x)


def gelu(x, approximate: bool = False):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)


def atan(x):
    return torch.atan(x)


def softshrink(x, lambda_: float = 0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > lambda_, x - lambda_,
                       torch.where(x < -lambda_, x + lambda_, zero))


def sqrt(x):
    return torch.sqrt(x)


def rsqrt(x):
    return torch.rsqrt(x)


def abs(x):  # noqa: A001 - the reference op's name
    return torch.abs(x)


def ceil(x):
    return torch.ceil(x)


def floor(x):
    return torch.floor(x)


def cos(x):
    return torch.cos(x)


def acos(x):
    return torch.acos(x)


def sin(x):
    return torch.sin(x)


def asin(x):
    return torch.asin(x)


def round(x):  # noqa: A001 - half to even, as jnp.round
    return torch.round(x)


def reciprocal(x):
    return 1.0 / x


def log(x):
    return torch.log(x)


def square(x):
    return torch.square(x)


def brelu(x, t_min: float = 0.0, t_max: float = 24.0):
    return torch.clamp(x, t_min, t_max)


def soft_relu(x, threshold: float = 40.0):
    return torch.log1p(torch.exp(torch.clamp(x, -threshold, threshold)))


def pow(x, factor: float = 1.0):  # noqa: A001
    return torch.pow(x, factor)


def stanh(x, scale_a: float = 0.67, scale_b: float = 1.7159):
    return scale_b * torch.tanh(scale_a * x)


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def softsign(x):
    return x / (torch.abs(x) + 1.0)


def relu6(x, threshold: float = 6.0):
    return torch.clamp(x, 0.0, threshold)


def leaky_relu(x, alpha: float = 0.02):
    return torch.where(x >= 0, x, alpha * x)


def tanh_shrink(x):
    return x - torch.tanh(x)


def elu(x, alpha: float = 1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(
        torch.where(x > 0, torch.zeros_like(x), x)))


def hard_shrink(x, threshold: float = 0.5):
    return torch.where((x > threshold) | (x < -threshold), x,
                       torch.zeros_like(x))


def hard_sigmoid(x, slope: float = 0.2, offset: float = 0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def swish(x, beta: float = 1.0):
    return x * torch.sigmoid(beta * x)


def thresholded_relu(x, threshold: float = 1.0):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def selu(x, scale: float = 1.0507009873554805,
         alpha: float = 1.6732632423543772):
    return scale * torch.where(x >= 0, x, alpha * (torch.exp(x) - 1.0))


def prelu(x, alpha, mode: str = "all"):
    """``x`` where x >= 0, else ``alpha * x``; ``mode="channel"``: alpha
    (C,) over axis 1 of (N, C, ...); ``"all"`` and ``"element"``: alpha
    broadcasts as it is. Not an ``act=`` name: it takes a parameter."""
    if mode == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    return torch.where(x >= 0, x, alpha * x)


# ----- jax.nn's activations that ops.math does not shadow -----------------


def celu(x, alpha: float = 1.0):
    return torch.clamp(x, min=0.0) + alpha * torch.expm1(
        torch.clamp(x, max=0.0) / alpha)


def glu(x, axis: int = -1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def hard_silu(x):
    """x * relu6(x + 3) / 6 (``jax.nn.hard_swish``; not ops.math's
    hard_sigmoid, whose slope and offset differ)."""
    return x * (torch.clamp(x + 3.0, 0.0, 6.0) / 6.0)


def hard_tanh(x):
    return torch.clamp(x, -1.0, 1.0)


def identity(x):
    return x


def log1mexp(x):
    return torch.where(x < math.log(2.0), torch.log(-torch.expm1(-x)),
                       torch.log1p(-torch.exp(-x)))


def log_sigmoid(x):
    return -softplus(-x)


def log_softmax(x, axis: int = -1):
    return F.log_softmax(x, dim=axis)


def mish(x):
    return x * torch.tanh(softplus(x))


def silu(x):
    return x * torch.sigmoid(x)


def softmax(x, axis: int = -1):
    return F.softmax(x, dim=axis)


def sparse_plus(x):
    return torch.where(x <= -1.0, torch.zeros_like(x),
                       torch.where(x >= 1.0, x, (x + 1.0) ** 2 / 4))


def sparse_sigmoid(x):
    return 0.5 * torch.clamp(x + 1.0, 0.0, 2.0)


def squareplus(x, b: float = 4.0):
    return (x + torch.sqrt(torch.square(x) + b)) / 2


def standardize(x, axis: int = -1, epsilon: float = 1e-5):
    mean = torch.mean(x, dim=axis, keepdim=True)
    var = torch.mean(torch.square(x), dim=axis, keepdim=True) - \
        torch.square(mean)
    return (x - mean) * torch.rsqrt(var + epsilon)


# name -> function, in the JAX package's resolution order: ops.math's
# one-argument activations, then jax.nn's under the names it exports
ACTIVATIONS = {fn.__name__: fn for fn in (
    sigmoid, logsigmoid, exp, gelu, relu, tanh, atan, softshrink, sqrt,
    rsqrt, abs, ceil, floor, cos, acos, sin, asin, round, reciprocal, log,
    square, brelu, soft_relu, pow, stanh, softplus, softsign, relu6,
    leaky_relu, tanh_shrink, elu, hard_shrink, hard_sigmoid, swish,
    thresholded_relu, selu,
    celu, glu, hard_silu, hard_tanh, identity, log1mexp, log_sigmoid,
    log_softmax, mish, silu, softmax, sparse_plus, sparse_sigmoid,
    squareplus, standardize)}
ACTIVATIONS.update(hard_swish=hard_silu, soft_sign=softsign)


def activation(name: str):
    """The activation function named ``name`` (an ``act=`` value)."""
    fn = ACTIVATIONS.get(name)
    if fn is None:
        raise InvalidArgumentError(
            f"unknown activation {name!r}: act= takes the JAX package's "
            f"names ({', '.join(sorted(ACTIVATIONS))})")
    return fn
