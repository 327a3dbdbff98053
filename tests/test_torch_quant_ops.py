"""The port's quantization ops (paddle_tpu_torch/quant/ops.py) against the
JAX package's paddle_tpu/quant/ops.py on the same numpy-seeded inputs.

Tolerances and why:
- ``absmax_encode`` (per vector, per tensor, with a recorded ``absmax=``),
  ``quantize_to_int`` and ``quantize_tensor``: exact. Both packages
  divide (or multiply) once in float32 and round half to even, so equal
  inputs give equal codes and equal scales.
- the fake-quant ops and the moving-average tracker: atol 1e-6 (the same
  float32 operations in the same order; agreement is in fact exact, and
  1e-6 leaves room for a compiler's reassociation).
- the straight-through gradient of ``quantize_dequantize``, with the
  scale taken from the tensor itself (so the abs-max element sits on the
  clip boundary, where both split the gradient evenly): atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.quant_matmul import quantize_tensor as jax_qt
from paddle_tpu.quant import ops as JQ
from paddle_tpu_torch.ops.kernels import quant_matmul as TQM
from paddle_tpu_torch.quant import ops as TQ

ATOL = 1e-6


def _x(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("axis", [None, -1, 0])
def test_absmax_encode_exact(axis):
    x = _x((6, 5, 64), seed=1, scale=3.0)
    x[0, 0] = 0.0                      # an all-zero vector: scale = eps
    jq, js = JQ.absmax_encode(jnp.asarray(x), axis=axis)
    tq, ts = TQ.absmax_encode(torch.from_numpy(x), axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _eq(tq, jq)
    _eq(ts, js)
    _eq(TQ.absmax_decode(tq, ts), JQ.absmax_decode(jq, js))


@pytest.mark.parametrize("absmax", [2.5, 0.0])
def test_absmax_encode_recorded_absmax_and_16_bit(absmax):
    x = _x((8, 32), seed=2, scale=2.0)
    for bits in (8, 12):
        jq, js = JQ.absmax_encode(jnp.asarray(x), absmax=absmax,
                                  bit_length=bits)
        tq, ts = TQ.absmax_encode(torch.from_numpy(x),
                                  absmax=torch.tensor(absmax),
                                  bit_length=bits)
        assert tq.dtype == (torch.int8 if bits == 8 else torch.int16)
        _eq(tq, jq)
        _eq(ts, js)


def test_absmax_encode_stochastic_key_raises():
    """``key=`` (stochastic rounding) no longer raises: the codes are
    within one step of ``x / scale`` and unbiased in the mean, as the JAX
    package's on the same input (the draws differ: distribution only),
    the scale is the nearest-rounding one exactly, and one key gives the
    same codes twice."""
    x = _x((256, 256), seed=9, scale=1.0)
    jq, js = JQ.absmax_encode(jnp.asarray(x), axis=1,
                              key=jax.random.key(0))
    tq, ts = TQ.absmax_encode(torch.from_numpy(x), axis=1,
                              key=np.array([0, 7], np.uint32))
    _eq(ts, js)
    for q in (np.asarray(jq), tq.numpy()):
        err = q.astype(np.float32) * np.asarray(js) - x
        assert (np.abs(err) <= np.asarray(js) * (1 + 1e-5)).all()
        assert abs(err.mean()) < float(np.asarray(js).mean()) * 0.02
    again, _ = TQ.absmax_encode(torch.from_numpy(x), axis=1,
                                key=np.array([0, 7], np.uint32))
    assert torch.equal(again, tq) and tq.dtype == torch.int8


@pytest.mark.parametrize("scale", [0.7, 5.0])
def test_quantize_to_int_and_dequantize_exact(scale):
    x = _x((16, 24), seed=3, scale=1.5)
    for bits in (8, 16):
        _eq(TQ.quantize_to_int(torch.from_numpy(x), scale, bits),
            JQ.quantize_to_int(jnp.asarray(x), scale, bits))
    q = np.random.default_rng(4).integers(-127, 128, (16, 24)).astype(
        np.int8)
    s = np.abs(_x((24,), seed=5)) + 0.1
    _eq(TQ.dequantize(torch.from_numpy(q), torch.from_numpy(s),
                      quant_axis=1),
        JQ.dequantize(jnp.asarray(q), jnp.asarray(s), quant_axis=1))


def test_fake_quant_ops():
    x = _x((12, 20), seed=6, scale=2.0)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    for t, j in ((TQ.fake_quantize_abs_max(tx),
                  JQ.fake_quantize_abs_max(jx)),
                 (TQ.fake_channel_wise_quantize_abs_max(tx, 8, 1),
                  JQ.fake_channel_wise_quantize_abs_max(jx, 8, 1)),
                 (TQ.fake_channel_wise_quantize_abs_max(tx, 4, 0),
                  JQ.fake_channel_wise_quantize_abs_max(jx, 4, 0))):
        _close(t[0], j[0])
        _close(t[1], j[1])
    _close(TQ.quantize_dequantize(tx, 0.5),
           JQ.quantize_dequantize(jx, 0.5))
    _close(TQ.abs_max_scale(tx, axis=0), JQ.abs_max_scale(jx, axis=0))


def test_moving_average_tracker():
    """Three training steps then one test step of the moving-average fake
    quantizer, state threaded through both packages."""
    jst = JQ.moving_average_state_init()
    tst = TQ.moving_average_state_init()
    for i in range(4):
        x = _x((8, 16), seed=10 + i, scale=1.0 + i)
        is_test = i == 3
        jy, jst = JQ.fake_quantize_moving_average_abs_max(
            jnp.asarray(x), jst, 8, 0.9, is_test=is_test)
        ty, tst = TQ.fake_quantize_moving_average_abs_max(
            torch.from_numpy(x), tst, 8, 0.9, is_test=is_test)
        _close(ty, jy)
        for a, b in zip(tst, jst):
            _close(a, b)


@pytest.mark.parametrize("fixed_scale", [True, False])
def test_quantize_dequantize_ste_gradient(fixed_scale):
    """The gradient of sum(w * qdq(x, s)) against jax.grad: identity
    inside the clip range, zero outside, and (scale from x) the tie at
    the abs-max element split as JAX splits it."""
    x = _x((10, 7), seed=20, scale=2.0)
    w = _x((10, 7), seed=21)

    def jloss(x):
        s = 1.5 if fixed_scale else jnp.max(jnp.abs(x))
        return jnp.sum(jnp.asarray(w) * JQ.quantize_dequantize(x, s))

    tx = torch.from_numpy(x).requires_grad_()
    s = 1.5 if fixed_scale else torch.amax(torch.abs(tx))
    (torch.from_numpy(w) * TQ.quantize_dequantize(tx, s)).sum().backward()
    _close(tx.grad, jax.grad(jloss)(jnp.asarray(x)))


@pytest.mark.parametrize("axis", [None, 1, 0])
def test_quantize_tensor_exact(axis):
    x = _x((9, 13), seed=30, scale=0.3)
    jq, js = jax_qt(jnp.asarray(x), per_channel_axis=axis)
    tq, ts = TQM.quantize_tensor(torch.from_numpy(x), per_channel_axis=axis)
    _eq(tq, jq)
    _eq(ts, js)
