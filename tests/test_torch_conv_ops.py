"""The port's convolutional ops (``ops/nn.py``, ``ops/math.py`` prelu,
``ops/tensor.py`` flatten) against the JAX package's on the same numpy
inputs, float32 on the CPU: forward and, for the float ops, the
gradient of ``sum(out * cotangent)`` for every float input.

Tolerances: outputs at 1e-5 (float32 sums of at most a few hundred
products in two libraries' orders); gradients within 1e-5 of each
input's largest reference-gradient entry. NaN and -inf where the JAX
package gives them (a pooling window wholly in the padding) must be
NaN and -inf here.

The traps where torch's functional op means something else than the
JAX package's are named in their own tests: BatchNorm's running
statistics, ceil-mode pooling, ``lrn``'s alpha, ``one_hot`` of an id out
of range, fully padded max windows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu.ops import math as JMATH
from paddle_tpu.ops import nn as J
from paddle_tpu.ops import tensor as JT
from paddle_tpu_torch.ops import math as TMATH
from paddle_tpu_torch.ops import nn as T
from paddle_tpu_torch.ops import tensor as TT

ATOL = 1e-5


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _check(jfn, tfn, inputs, grad=True, seed=0, atol=ATOL):
    """jfn(*jax arrays) against tfn(*torch tensors), forward and grads."""
    want = np.asarray(jax.jit(jfn)(*[jnp.asarray(a) for a in inputs]))
    tin = [torch.tensor(a, requires_grad=grad and a.dtype.kind == "f")
           for a in inputs]
    got = tfn(*tin)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol,
                               rtol=0, equal_nan=True)
    if not grad:
        return
    cot = np.random.default_rng(seed + 100).normal(
        size=want.shape).astype(np.float32)
    cot[~np.isfinite(want)] = 0.0
    argnums = tuple(i for i, a in enumerate(inputs) if a.dtype.kind == "f")
    def jloss(*a):
        y = jfn(*a)
        return jnp.sum(jnp.where(jnp.isfinite(y), y, 0.0) * cot)

    jg = jax.jit(jax.grad(jloss, argnums))(*[jnp.asarray(a)
                                             for a in inputs])
    out = torch.where(torch.isfinite(got), got, 0.0)
    (out * torch.from_numpy(cot)).sum().backward()
    for i, g in zip(argnums, jg):
        g = np.asarray(g)
        np.testing.assert_allclose(
            tin[i].grad.numpy(), g, rtol=0,
            atol=atol * max(1.0, float(np.abs(g).max())))


# ----- convolutions ----------------------------------------------------------

CONV2D = {
    "plain": ((2, 4, 9, 10), (6, 4, 3, 3), dict(padding=1)),
    "stride2": ((2, 4, 9, 10), (6, 4, 3, 3), dict(stride=2, padding=1)),
    "dilation2": ((2, 4, 9, 10), (6, 4, 3, 3), dict(padding=2,
                                                     dilation=2)),
    "groups2": ((2, 4, 9, 10), (6, 2, 3, 3), dict(padding=1, groups=2)),
    "depthwise": ((2, 4, 9, 10), (8, 1, 3, 3), dict(padding=1, groups=4)),
    "rect": ((2, 3, 9, 10), (5, 3, 3, 2), dict(stride=(2, 1),
                                               padding=(1, 0))),
    "nhwc_stride2": ((2, 9, 10, 4), (6, 4, 3, 3),
                     dict(stride=2, padding=1, data_format="NHWC")),
    "nhwc_groups2": ((2, 9, 10, 4), (6, 2, 3, 3),
                     dict(padding=1, groups=2, data_format="NHWC")),
    "stem7x7": ((1, 3, 16, 16), (8, 3, 7, 7), dict(stride=2, padding=3)),
}


@pytest.mark.parametrize("case", list(CONV2D))
def test_conv2d(case):
    xs, ws, kw = CONV2D[case]
    rng = np.random.default_rng(1)
    _check(lambda x, w: J.conv2d(x, w, **kw),
           lambda x, w: T.conv2d(x, w, **kw), [_rand(rng, *xs),
                                                _rand(rng, *ws)])


def test_nhwc_conv_runs_channels_last_and_returns_nhwc():
    x = torch.randn(2, 9, 10, 4)
    y = T.conv2d(x, torch.randn(6, 4, 3, 3), padding=1, data_format="NHWC")
    assert y.shape == (2, 9, 10, 6) and y.is_contiguous()


def test_depthwise_conv2d():
    rng = np.random.default_rng(2)
    _check(lambda x, w: J.depthwise_conv2d(x, w, 2, 1),
           lambda x, w: T.depthwise_conv2d(x, w, 2, 1),
           [_rand(rng, 2, 4, 9, 10), _rand(rng, 4, 1, 3, 3)])


TRANSPOSE = {
    "stride2": ((2, 4, 5, 6), (4, 3, 3, 3), dict(stride=2, padding=1)),
    "groups2": ((2, 4, 5, 6), (4, 3, 3, 3), dict(stride=2, padding=1,
                                                 groups=2)),
    "dilation2": ((2, 4, 5, 6), (4, 2, 3, 3), dict(padding=3, dilation=2)),
    "rect": ((1, 2, 5, 6), (2, 3, 4, 3), dict(stride=(2, 1),
                                              padding=(1, 1))),
}


@pytest.mark.parametrize("case", list(TRANSPOSE))
def test_conv2d_transpose(case):
    xs, ws, kw = TRANSPOSE[case]
    rng = np.random.default_rng(3)
    _check(lambda x, w: J.conv2d_transpose(x, w, **kw),
           lambda x, w: T.conv2d_transpose(x, w, **kw),
           [_rand(rng, *xs), _rand(rng, *ws)])


@pytest.mark.parametrize("groups", [1, 2])
def test_conv3d(groups):
    rng = np.random.default_rng(4)
    _check(lambda x, w: J.conv3d(x, w, (1, 2, 1), 1, groups=groups),
           lambda x, w: T.conv3d(x, w, (1, 2, 1), 1, groups=groups),
           [_rand(rng, 1, 4, 5, 6, 7), _rand(rng, 3 * groups, 4 // groups,
                                             2, 3, 3)])


# ----- pooling ---------------------------------------------------------------

POOL = {
    "max3s2p1": dict(kernel_size=3, pool_type="max", stride=2, padding=1),
    "avg3s2p1": dict(kernel_size=3, pool_type="avg", stride=2, padding=1),
    "avg_inclusive": dict(kernel_size=3, pool_type="avg", stride=2,
                          padding=1, exclusive=False),
    "max_ceil": dict(kernel_size=2, pool_type="max", stride=2, padding=1,
                     ceil_mode=True),
    "avg_ceil_inclusive": dict(kernel_size=2, pool_type="avg", stride=2,
                               padding=1, ceil_mode=True, exclusive=False),
    "avg_ceil_rect": dict(kernel_size=(3, 2), pool_type="avg",
                          stride=(2, 1), padding=(1, 0), ceil_mode=True),
    "max_default_stride": dict(kernel_size=2, pool_type="max"),
    "global_avg": dict(kernel_size=1, pool_type="avg",
                       global_pooling=True),
    "global_max": dict(kernel_size=1, pool_type="max",
                       global_pooling=True),
}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", list(POOL))
def test_pool2d(case, layout):
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, 3, 5, 7)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    kw = dict(POOL[case], data_format=layout)
    _check(lambda a: J.pool2d(a, **kw), lambda a: T.pool2d(a, **kw), [x])


def test_ceil_mode_keeps_the_window_torch_drops():
    """At H=5, k=2, s=2, p=1 the JAX package's ceil mode gives 4 outputs
    (its last window starts in the right padding's extension), torch's
    ``ceil_mode`` 3; the port gives 4, equal to the JAX values."""
    x = np.random.default_rng(6).normal(size=(1, 1, 5, 5)).astype(np.float32)
    kw = dict(kernel_size=2, pool_type="max", stride=2, padding=1,
              ceil_mode=True)
    want = np.asarray(J.pool2d(jnp.asarray(x), **kw))
    assert want.shape[-2:] == (4, 4)
    assert F.max_pool2d(torch.from_numpy(x), 2, 2, 1,
                        ceil_mode=True).shape[-2:] == (3, 3)
    np.testing.assert_array_equal(T.pool2d(torch.from_numpy(x), **kw)
                                  .numpy(), want)


def test_exclusive_ceil_average_matches_including_empty_windows():
    """Exclusive average in ceil mode divides by the live count; a window
    with none gives NaN (0 / 0) in both packages. Non-exclusive divides
    by kh * kw always."""
    x = np.random.default_rng(7).normal(size=(1, 2, 5, 5)).astype(
        np.float32)
    for exclusive in (True, False):
        kw = dict(kernel_size=2, pool_type="avg", stride=2, padding=1,
                  ceil_mode=True, exclusive=exclusive)
        want = np.asarray(J.pool2d(jnp.asarray(x), **kw))
        got = T.pool2d(torch.from_numpy(x), **kw).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   equal_nan=True)
    # the last window lies wholly in the ceil extension of the padding
    ex, inc = (T.pool2d(torch.from_numpy(x), 2, "avg", 2, 1, True, e)
               for e in (True, False))
    assert torch.isnan(ex[0, 0, -1, -1]) and inc[0, 0, -1, -1] == 0


def test_fully_padded_max_window_is_minus_inf():
    x = np.ones((1, 1, 2, 2), np.float32)
    want = np.asarray(J.pool2d(jnp.asarray(x), 2, "max", stride=2,
                               padding=2))
    got = T.pool2d(torch.from_numpy(x), 2, "max", stride=2,
                   padding=2).numpy()
    assert np.isneginf(want).sum() == 8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pool_type,size", [("avg", 3), ("max", (3, 1)),
                                            ("avg", (1, 1))])
def test_adaptive_pool2d(pool_type, size):
    x = _rand(np.random.default_rng(8), 2, 3, 9, 6)
    _check(lambda a: J.adaptive_pool2d(a, size, pool_type),
           lambda a: T.adaptive_pool2d(a, size, pool_type), [x])


# ----- normalisations ----------------------------------------------------------


def _bn_inputs(seed, c=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=c).astype(np.float32),
            rng.normal(size=c).astype(np.float32),
            rng.normal(size=c).astype(np.float32),
            (rng.random(c) + 0.5).astype(np.float32))


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batch_norm(training, layout):
    rng = np.random.default_rng(9)
    x = _rand(rng, 3, 4, 5, 6) * 2 + 1
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    sc, bi, mu, va = _bn_inputs(10)
    kw = dict(training=training, momentum=0.8, epsilon=1e-3,
              data_layout=layout)
    for i in range(3):                  # y, new_mean, new_var
        _check(lambda a, s, b: J.batch_norm(a, s, b, jnp.asarray(mu),
                                            jnp.asarray(va), **kw)[i],
               lambda a, s, b: T.batch_norm(a, s, b, torch.from_numpy(mu),
                                            torch.from_numpy(va), **kw)[i],
               [x, sc, bi], grad=i == 0)


def test_batch_norm_running_statistics_are_the_reference_update():
    """The running statistics after two training calls and an eval call:
    ``momentum * old + (1 - momentum) * batch`` with the biased variance,
    as the JAX package updates them; ``F.batch_norm``'s own update
    (batch weighted by momentum, unbiased variance) gives another
    result."""
    rng = np.random.default_rng(11)
    xs = [_rand(rng, 4, 3, 2, 2) * 3 + 1 for _ in range(3)]
    sc, bi, _, _ = _bn_inputs(12, 3)
    jm, jv = jnp.zeros(3), jnp.ones(3)
    tm, tv = torch.zeros(3), torch.ones(3)
    torch_m, torch_v = torch.zeros(3), torch.ones(3)
    for x, training in zip(xs, (True, True, False)):
        jy, jm, jv = J.batch_norm(jnp.asarray(x), sc, bi, jm, jv,
                                  training=training)
        ty, tm, tv = T.batch_norm(torch.from_numpy(x), torch.from_numpy(sc),
                                  torch.from_numpy(bi), tm, tv,
                                  training=training)
        F.batch_norm(torch.from_numpy(x), torch_m, torch_v,
                     torch.from_numpy(sc), torch.from_numpy(bi), training,
                     0.9)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                                   rtol=0)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    assert np.abs(torch_m.numpy() - np.asarray(jm)).max() > 1e-2
    assert np.abs(torch_v.numpy() - np.asarray(jv)).max() > 1e-2


def test_batch_norm_one_value_per_channel():
    """Batch 1 at 1x1: the JAX package normalises to the bias, where
    ``F.batch_norm`` refuses the input. The batch variance is 0, so
    rsqrt(var + eps) is 1 / sqrt(1e-5) = 316: torch's kernel, which folds
    the normalisation into x * (scale * invstd) + (bias - mean * scale *
    invstd), rounds about 316 times float32's step of |x * scale| away
    from the bias; the tolerance is ATOL times that factor."""
    x = np.random.default_rng(13).normal(size=(1, 4, 1, 1)).astype(
        np.float32)
    sc, bi, mu, va = _bn_inputs(14)
    _check(lambda a: J.batch_norm(a, sc, bi, mu, va, training=True)[0],
           lambda a: T.batch_norm(a, *map(torch.from_numpy,
                                          (sc, bi, mu, va)),
                                  training=True)[0], [x],
           atol=ATOL / np.sqrt(1e-5))


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_group_norm(groups):
    rng = np.random.default_rng(15)
    _check(lambda x, s, b: J.group_norm(x, s, b, groups=groups),
           lambda x, s, b: T.group_norm(x, s, b, groups=groups),
           [_rand(rng, 2, 4, 3, 5), _rand(rng, 4), _rand(rng, 4)])


def test_group_norm_without_affine():
    x = _rand(np.random.default_rng(16), 2, 6, 3, 3)
    _check(lambda a: J.group_norm(a, groups=3),
           lambda a: T.group_norm(a, groups=3), [x])


@pytest.mark.parametrize("axis", [-1, 1])
def test_l2_normalize(axis):
    x = _rand(np.random.default_rng(17), 2, 4, 3)
    x[0, :, 0] = 0.0                    # a zero vector: the epsilon floor
    _check(lambda a: J.l2_normalize(a, axis), lambda a: T.l2_normalize(
        a, axis), [x])


def test_lrn_does_not_divide_alpha_by_n():
    x = _rand(np.random.default_rng(18), 2, 6, 3, 3)
    _check(lambda a: J.lrn(a, 5, 2.0, 0.1, 0.75),
           lambda a: T.lrn(a, 5, 2.0, 0.1, 0.75), [x])
    torch_lrn = F.local_response_norm(torch.from_numpy(x), 5, 0.1, 0.75,
                                      2.0).numpy()
    assert np.abs(torch_lrn - np.asarray(J.lrn(jnp.asarray(x), 5, 2.0, 0.1,
                                               0.75))).max() > 1e-3


@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax_and_log_softmax(axis):
    x = _rand(np.random.default_rng(19), 2, 5, 3)
    _check(lambda a: J.softmax(a, axis), lambda a: T.softmax(a, axis), [x])
    _check(lambda a: J.log_softmax(a, axis),
           lambda a: T.log_softmax(a, axis), [x])


def test_one_hot_zero_rows_out_of_range():
    ids = np.array([[-1, 0, 3], [4, 7, 2]], np.int32)
    want = np.asarray(J.one_hot(jnp.asarray(ids), 4))
    got = T.one_hot(torch.from_numpy(ids), 4)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0].sum() == 0 and want[1, 1].sum() == 0
    with pytest.raises(RuntimeError):
        F.one_hot(torch.from_numpy(ids).long(), 4)
    assert T.one_hot(torch.from_numpy(ids), 4, "int32").dtype == torch.int32


@pytest.mark.parametrize("mode,alpha_shape", [("all", (1,)),
                                              ("channel", (4,)),
                                              ("element", (4, 3, 2))])
def test_prelu(mode, alpha_shape):
    rng = np.random.default_rng(20)
    _check(lambda x, a: JMATH.prelu(x, a, mode),
           lambda x, a: TMATH.prelu(x, a, mode),
           [_rand(rng, 2, 4, 3, 2), _rand(rng, *alpha_shape)])


@pytest.mark.parametrize("axis", [1, 2, 3])
def test_flatten(axis):
    x = _rand(np.random.default_rng(21), 2, 3, 4, 5)
    _check(lambda a: JT.flatten(a, axis), lambda a: TT.flatten(a, axis), [x])
