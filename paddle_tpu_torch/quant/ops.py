"""Fake-quantization ops and the shared abs-max int-k encode/decode
(counterpart of paddle_tpu/quant/ops.py).

Fake quantization simulates int-k in float (quantize, round, dequantize)
with the straight-through gradient: identity inside the clip range, zero
outside. The scale trackers are functional, as in the JAX package: the
moving average takes a :class:`MovingAverageState` and the sliding
window (``fake_quantize_range_abs_max``) a :class:`RangeState`, and each
returns a new one.

Rounding is ``torch.round`` (half to even, as ``jnp.round``) and every
division is the JAX package's, in the same order, so encoded values equal
the JAX ones exactly for equal float inputs. Two formulas coexist, as
there: :func:`absmax_encode` divides by ``max(absmax / qmax, 1e-10)``;
:func:`quantize_to_int` (the freeze export) multiplies the clipped value
by ``qmax / max(scale, 1e-8)``."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.math import _clip


def _qmax(bit_length: int) -> float:
    return float((1 << (bit_length - 1)) - 1)  # 127 for int8


def _int_dtype(bit_length: int) -> torch.dtype:
    return torch.int8 if bit_length <= 8 else torch.int16


def _qmax_over(scale: torch.Tensor, bit_length: int) -> torch.Tensor:
    """``qmax / scale`` as a true division: torch computes a Python
    number over a tensor as the tensor's reciprocal times the number,
    which can land an ulp off the JAX package's quotient."""
    return _as_f(_qmax(bit_length), scale) / scale


def _as_f(value, like: torch.Tensor) -> torch.Tensor:
    """``jnp.asarray(value, like.dtype)`` on ``like``'s device."""
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


class _STERound(torch.autograd.Function):
    """round() forward, identity backward."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def quantize_dequantize(x, scale, bit_length: int = 8):
    """Simulated quantization: clip to [-scale, scale], round onto the
    int-k grid, return float. Straight-through gradient inside the clip
    range."""
    scale = torch.clamp_min(_as_f(scale, x), 1e-8)
    inv = _qmax_over(scale, bit_length)
    clipped = _clip(x, -scale, scale)
    return _STERound.apply(clipped * inv) / inv


def abs_max_scale(x, axis: Optional[int] = None):
    """Current abs-max of a tensor (per channel when ``axis`` is given)."""
    if axis is None:
        return torch.amax(torch.abs(x))
    axis = axis % x.ndim
    reduce_axes = tuple(i for i in range(x.ndim) if i != axis)
    return torch.amax(torch.abs(x), dim=reduce_axes)


def fake_quantize_abs_max(x, bit_length: int = 8):
    """Scale = abs-max of this tensor. Returns (quantized x, scale)."""
    scale = abs_max_scale(x)
    return quantize_dequantize(x, scale, bit_length), scale


def fake_channel_wise_quantize_abs_max(x, bit_length: int = 8,
                                       channel_axis: int = 0):
    """One scale per channel along ``channel_axis`` (weights)."""
    scale = abs_max_scale(x, axis=channel_axis)
    shape = [1] * x.ndim
    shape[channel_axis] = x.shape[channel_axis]
    return quantize_dequantize(x, scale.reshape(shape), bit_length), scale


class MovingAverageState(NamedTuple):
    scale: torch.Tensor  # scalar running scale
    accum: torch.Tensor
    state: torch.Tensor


def moving_average_state_init(dtype=torch.float32) -> MovingAverageState:
    z = torch.zeros((), dtype=dtype)
    return MovingAverageState(z, z.clone(), z.clone())


def moving_average_abs_max_scale(x, st: MovingAverageState,
                                 moving_rate: float = 0.9
                                 ) -> Tuple[torch.Tensor,
                                            MovingAverageState]:
    """EMA of the abs-max with bias-corrected accumulators."""
    cur = abs_max_scale(x).to(st.scale.dtype)
    accum = st.accum * moving_rate + cur
    state = st.state * moving_rate + 1.0
    scale = accum / state
    return scale, MovingAverageState(scale, accum, state)


def fake_quantize_moving_average_abs_max(x, st: MovingAverageState,
                                         bit_length: int = 8,
                                         moving_rate: float = 0.9,
                                         is_test: bool = False):
    """Fake quantization at the moving-average abs-max scale. Returns
    (quantized, new_state); ``is_test`` keeps the state's scale."""
    if is_test:
        return quantize_dequantize(x, st.scale, bit_length), st
    scale, new_st = moving_average_abs_max_scale(x, st, moving_rate)
    return quantize_dequantize(x, scale, bit_length), new_st


class RangeState(NamedTuple):
    scale: torch.Tensor          # current scale
    scales_window: torch.Tensor  # (window,) ring buffer of recent abs-maxes
    step: torch.Tensor           # int32 counter


def range_state_init(window_size: int = 10000,
                     dtype=torch.float32) -> RangeState:
    """A zero scale, a window of ``window_size`` zeros and step 0, on the
    CPU; the first call moves the state to its input's device."""
    return RangeState(torch.zeros((), dtype=dtype),
                      torch.zeros((window_size,), dtype=dtype),
                      torch.zeros((), dtype=torch.int32))


def fake_quantize_range_abs_max(x, st: RangeState, bit_length: int = 8,
                                is_test: bool = False):
    """Fake quantization at the max of a sliding window of recent
    abs-maxes. This call's abs-max goes into slot ``step % window`` of
    the ring buffer, and the scale is the max over the WHOLE window, the
    zeros of slots not yet written included. Returns (quantized,
    new_state) with the new state on ``x``'s device; ``is_test``
    quantizes at ``st.scale`` and returns ``st`` unchanged. As in the
    JAX package the new state is a function of ``x``: a caller that keeps
    it across steps keeps it detached."""
    if is_test:
        return quantize_dequantize(x, st.scale, bit_length), st
    window = st.scales_window.to(x.device)
    step = st.step.to(x.device)
    cur = abs_max_scale(x).to(window.dtype)
    # index_put with a tensor index: no read of the step back to the host
    idx = torch.remainder(step, window.shape[0]).long().reshape(1)
    window = window.index_put((idx,), cur.reshape(1))
    scale = torch.amax(window)
    return (quantize_dequantize(x, scale, bit_length),
            RangeState(scale, window, step + 1))


# ----- the shared abs-max int-k encode/decode -------------------------------
# One rounding convention for every real-int8 quantizer: int8 activations,
# the quantized paged-KV pool, and (with the distributed slice) the
# compressed collectives.


def absmax_encode(x, axis: Optional[int] = None, *, absmax=None,
                  bit_length: int = 8, eps: float = 1e-10, key=None):
    """Quantize ``x`` onto the symmetric int-k grid at an abs-max scale:
    ``scale = max(absmax / qmax, eps)``, ``q = clip(round(x / scale),
    -qmax, qmax)`` as int8 (int16 above 8 bits); dequant is ``q * scale``
    (:func:`absmax_decode`).

    ``axis``: the axis the abs-max is taken over (None = whole tensor);
    the returned scale keeps it with size 1. ``absmax``: a recorded
    abs-max (calibrated activation scales), which skips the reduction.
    ``key`` (JAX key data, uint32[2]): stochastic rounding, ``floor(y +
    u)`` with ``u ~ U[0, 1)`` drawn from a ``torch.Generator`` on ``x``'s
    device that the key seeds (``core.random.seed_generator``), the
    gradient-compression option where rounding bias would accumulate
    across steps. It is unbiased, ``E[q] = y``, and within one step of
    ``y``, as the JAX package's; the draws match the JAX ones in
    distribution only. Returns ``(q, scale)`` with ``scale`` float32."""
    if absmax is None:
        absmax = (torch.amax(torch.abs(x)) if axis is None
                  else torch.amax(torch.abs(x), dim=axis, keepdim=True))
    scale = _absmax_scale(absmax, x.device, bit_length, eps)
    if key is None:
        return _encode_at(x, scale, bit_length), scale
    return _encode_stochastic(x, scale, key, bit_length), scale


def _encode_stochastic(x, scale, key, bit_length: int = 8):
    """:func:`absmax_encode`'s stochastic rounding at a scale taken
    beforehand: ``clip(floor(x / scale + u), -qmax, qmax)``, ``u ~ U[0,
    1)`` from a generator on ``x``'s device that ``key`` seeds."""
    from ..core.random import seed_generator

    gen = seed_generator(torch.Generator(device=x.device), key)
    y = x.float() / scale
    y = torch.floor(y + torch.rand(y.shape, generator=gen,
                                   device=x.device))
    qmax = _qmax(bit_length)
    return torch.clamp(y, -qmax, qmax).to(_int_dtype(bit_length))


def _absmax_scale(absmax, device, bit_length: int = 8, eps: float = 1e-10):
    """:func:`absmax_encode`'s scale: ``max(absmax / qmax, eps)`` in
    float32 on ``device``."""
    absmax = torch.as_tensor(absmax, dtype=torch.float32, device=device)
    return torch.clamp_min(absmax / _qmax(bit_length), eps)


def _encode_at(x, scale, bit_length: int = 8):
    """:func:`absmax_encode`'s rounding at a scale taken beforehand:
    ``clip(round(x / scale), -qmax, qmax)`` as int8 (int16 above 8
    bits)."""
    qmax = _qmax(bit_length)
    y = torch.round(x.float() / scale)
    return torch.clamp(y, -qmax, qmax).to(_int_dtype(bit_length))


def absmax_decode(q, scale):
    """``q * scale`` in float32 (the scale broadcasts: the reduced axis
    was kept)."""
    return q.float() * scale


def dequantize(q, scale, bit_length: int = 8,
               quant_axis: Optional[int] = None):
    """Map an int-k grid tensor back to float: ``q * scale / qmax``
    (per channel along ``quant_axis`` for a 1-D scale)."""
    qmax = _qmax(bit_length)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    if quant_axis is not None and scale.ndim == 1:
        shape = [1] * q.ndim
        shape[quant_axis] = q.shape[quant_axis]
        scale = scale.reshape(shape)
    return q.float() * scale / qmax


def quantize_to_int(x, scale, bit_length: int = 8):
    """Real int quantization for export: ``round(clip(x, -s, s) *
    (qmax / s))`` with ``s = max(scale, 1e-8)``, as int8 (int16 above 8
    bits)."""
    scale = torch.clamp_min(_as_f(scale, x), 1e-8)
    q = torch.round(_clip(x, -scale, scale) * _qmax_over(scale, bit_length))
    return q.to(_int_dtype(bit_length))
