"""Math ops (counterpart of paddle_tpu/ops/math.py, and of the
``jax.nn`` activations that the JAX package's ``act=`` falls back to):
the activations, then the elementwise binary ops with Paddle's ``axis``
broadcast, the matrix products (``torch.matmul``: the JAX package
computes them with ``jnp.matmul``, outside any Pallas kernel) and the
scalar and reduction utilities.

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
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.enforce import InvalidArgumentError, enforce

# ----- jnp.maximum / minimum / clip ---------------------------------------
# torch.clamp gives the whole gradient to a value at its bound; these
# split a tie 0.5 / 0.5 as JAX's do (jnp.clip is maximum, then minimum)


def _maximum(x, v):
    return torch.maximum(x, v if torch.is_tensor(v) else x.new_full((), v))


def _minimum(x, v):
    return torch.minimum(x, v if torch.is_tensor(v) else x.new_full((), v))


def _clip(x, lo, hi):
    return _minimum(_maximum(x, lo), hi)


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
    # derivative +1 at +-0, as jnp.abs's (torch.abs's is 0 there); the
    # + 0.0 turns the -0.0 that the first branch keeps into +0.0
    return torch.where(x >= 0, x, -x) + 0.0


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
    return _clip(x, t_min, t_max)


def soft_relu(x, threshold: float = 40.0):
    return torch.log1p(torch.exp(_clip(x, -threshold, threshold)))


def pow(x, factor: float = 1.0):  # noqa: A001
    return torch.pow(x, factor)


def stanh(x, scale_a: float = 0.67, scale_b: float = 1.7159):
    return scale_b * torch.tanh(scale_a * x)


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def softsign(x):
    return x / (abs(x) + 1.0)


def relu6(x, threshold: float = 6.0):
    return _clip(x, 0.0, threshold)


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
    return _clip(slope * x + offset, 0.0, 1.0)


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
    return _maximum(x, 0.0) + alpha * torch.expm1(
        _minimum(x, 0.0) / alpha)


def glu(x, axis: int = -1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def hard_silu(x):
    """x * relu6(x + 3) / 6 (``jax.nn.hard_swish``; not ops.math's
    hard_sigmoid, whose slope and offset differ)."""
    # jax.nn.relu6's derivative is 0 at both bounds (its custom jvp),
    # which the branches give
    y = x + 3.0
    r6 = torch.where(y <= 0.0, torch.zeros_like(y),
                     torch.where(y >= 6.0, torch.full_like(y, 6.0), y))
    return x * (r6 / 6.0)


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
    return 0.5 * _clip(x + 1.0, 0.0, 2.0)


def squareplus(x, b: float = 4.0):
    return (x + torch.sqrt(torch.square(x) + b)) / 2


def standardize(x, axis: int = -1, epsilon: float = 1e-5):
    mean = torch.mean(x, dim=axis, keepdim=True)
    var = torch.mean(torch.square(x), dim=axis, keepdim=True) - \
        torch.square(mean)
    return (x - mean) * torch.rsqrt(var + epsilon)


# ----- the rest of ops.math: not act= names --------------------------------


def maxout(x, groups: int, axis: int = 1):
    """Max over ``groups`` consecutive channels of ``axis``
    (reference: operators/maxout_op.cc)."""
    shape = list(x.shape)
    c = shape[axis]
    enforce(c % groups == 0, "channels %s not divisible by groups %s", c,
            groups)
    new_shape = shape[:axis] + [c // groups, groups] + shape[axis + 1:]
    return torch.amax(x.reshape(new_shape), dim=axis + 1)


def _broadcast_y(x, y, axis: int):
    """``y`` reshaped so its dims line up with x's dims [axis, axis +
    y.ndim) (reference: operators/elementwise/elementwise_op.h); the
    trailing 1s broadcast. ``axis == -1`` or equal shapes: y as it is."""
    y = torch.as_tensor(y, device=x.device if torch.is_tensor(x) else None)
    if tuple(x.shape) == tuple(y.shape) or axis == -1:
        return y
    enforce(0 <= axis and axis + y.ndim <= x.ndim,
            "bad elementwise axis %s for shapes %s, %s", axis,
            tuple(x.shape), tuple(y.shape))
    return y.reshape((1,) * axis + tuple(y.shape)
                     + (1,) * (x.ndim - axis - y.ndim))


def elementwise_add(x, y, axis: int = -1):
    return x + _broadcast_y(x, y, axis)


def elementwise_sub(x, y, axis: int = -1):
    return x - _broadcast_y(x, y, axis)


def elementwise_mul(x, y, axis: int = -1):
    return x * _broadcast_y(x, y, axis)


def elementwise_div(x, y, axis: int = -1):
    return x / _broadcast_y(x, y, axis)


def elementwise_min(x, y, axis: int = -1):
    return torch.minimum(x, _broadcast_y(x, y, axis))


def elementwise_max(x, y, axis: int = -1):
    return torch.maximum(x, _broadcast_y(x, y, axis))


def elementwise_pow(x, y, axis: int = -1):
    return torch.pow(x, _broadcast_y(x, y, axis))


def elementwise_mod(x, y, axis: int = -1):
    """``jnp.mod``: the result takes the divisor's sign (Python's rule,
    ``torch.remainder``; C's ``fmod`` takes the dividend's)."""
    return torch.remainder(x, _broadcast_y(x, y, axis))


def elementwise_floordiv(x, y, axis: int = -1):
    """``jnp.floor_divide``: rounds toward minus infinity, not zero."""
    return torch.div(x, _broadcast_y(x, y, axis), rounding_mode="floor")


def matmul(x, y, transpose_x: bool = False, transpose_y: bool = False,
           alpha: float = 1.0, precision=None):
    """Batched product with optional transposes of the last two dims
    (reference: operators/matmul_op.cc). ``precision`` is the JAX
    package's ``jnp.matmul`` argument; float32 here computes in float32
    unless the caller allows TF32 (``torch.backends``), so it is
    accepted and has no further effect."""
    if transpose_x and x.ndim >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim >= 2:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    if alpha != 1.0:
        out = out * alpha
    return out


def mul(x, y, x_num_col_dims: int = 1, y_num_col_dims: int = 1):
    """The flatten-to-2-D product (reference: operators/mul_op.cc): an
    operand of more than 2 dims is flattened to (prod(shape[:n]), rest)
    at its ``*_num_col_dims``."""
    if x.ndim > 2:
        x = x.reshape(math.prod(x.shape[:x_num_col_dims]), -1)
    if y.ndim > 2:
        y = y.reshape(math.prod(y.shape[:y_num_col_dims]), -1)
    return torch.matmul(x, y)


def bilinear_tensor_product(x, y, weight, bias=None):
    """out[b, k] = x[b] @ weight[k] @ y[b] (+ bias)
    (reference: operators/bilinear_tensor_product_op.cc)."""
    out = torch.einsum("bi,kij,bj->bk", x, weight, y)
    if bias is not None:
        out = out + bias
    return out


def scale(x, scale: float = 1.0, bias: float = 0.0,
          bias_after_scale: bool = True):
    """reference: operators/scale_op.cc."""
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def clip(x, min: float, max: float):  # noqa: A002 - the reference's names
    return _clip(x, min, max)


def clip_by_norm(x, max_norm: float):
    """``x * max_norm / ||x||`` where the L2 norm of the whole tensor
    exceeds ``max_norm``, else ``x`` (reference:
    operators/clip_by_norm_op.cc)."""
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return torch.where(norm > max_norm, x * (max_norm / norm), x)


def sign(x):
    return torch.sign(x)


def cumsum(x, axis: Optional[int] = None, exclusive: bool = False,
           reverse: bool = False):
    """reference: operators/cumsum_op.cc; ``axis=None`` flattens first.
    ``exclusive`` subtracts the element from its inclusive sum, as the
    JAX package does."""
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    if reverse:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis)
    if exclusive:
        out = out - x
    if reverse:
        out = torch.flip(out, (axis,))
    return out


def increment(x, value: float = 1.0):
    return x + value


def l1_norm(x):
    return torch.sum(abs(x))


def squared_l2_norm(x):
    return torch.sum(torch.square(x))


def squared_l2_distance(x, y):
    """(per-row sum of (x - y)^2 over every dim but the first, x - y)."""
    d = x - y
    return torch.sum(torch.square(d), dim=tuple(range(1, d.ndim))), d


def cos_sim(x, y, eps: float = 1e-12):
    """Row-wise cosine similarity over the last axis, keeping it as a
    singleton: ``<x, y> / max(|x| |y|, eps)`` (reference:
    operators/cos_sim_op.cc)."""
    xn = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    num = torch.sum(x * y, dim=-1, keepdim=True)
    return num / _maximum(xn * yn, eps)


def logsumexp(x, axis=None, keepdims: bool = False):
    """``jax.scipy.special.logsumexp``: over every axis when ``axis`` is
    None; a slice of only -inf gives -inf."""
    if axis is None:
        axis = tuple(range(x.ndim))
    return torch.logsumexp(x, dim=axis, keepdim=keepdims)


def isfinite(x):
    """A scalar bool: every entry finite (reference:
    operators/isfinite_op.cc)."""
    return torch.all(torch.isfinite(x))


def has_inf(x):
    return torch.any(torch.isinf(x))


def has_nan(x):
    return torch.any(torch.isnan(x))


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
