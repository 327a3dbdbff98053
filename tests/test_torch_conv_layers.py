"""The port's convolutional layers (``nn/layers.py``) against the JAX
package's on the same weights (crossed with ``load_numpy_state``,
buffers included) and inputs, on the CPU, under the ``float32`` and
``mixed_bf16`` policies: the output and its dtype, every parameter's
gradient of ``sum(out * cotangent)``, and BatchNorm's buffers after a
training forward. Then the initializers this slice adds, by their
moments and bounds on a seeded generator (Bilinear and NumpyArray
exactly).

Tolerances: float32 1e-5 for outputs, gradients within 1e-5 of each
parameter's largest JAX-gradient entry; ``mixed_bf16`` 2e-2 of the
largest entry for both (bfloat16 keeps 8 bits: each product rounds by
up to 2^-8 of its magnitude, in another place in each framework)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import initializer as JI
from paddle_tpu import nn as jnn
from paddle_tpu.core import dtypes as JD
from paddle_tpu_torch import initializer as I
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import dtypes as TD
from paddle_tpu_torch.utils.convert import load_numpy_state

TOL = {"float32": 1e-5, "mixed_bf16": 2e-2}

# name -> (constructor args, kwargs, input shape)
LAYERS = {
    "Conv2D": ((4, 6, 3), dict(padding=1, act="relu"), (2, 4, 7, 8)),
    "Conv2D_nhwc_stride2": ((4, 6, 3), dict(stride=2, padding=1,
                                            data_format="NHWC"),
                            (2, 7, 8, 4)),
    "Conv2D_groups_dilation": ((4, 6, (3, 2)), dict(padding=(2, 1),
                                                     dilation=2, groups=2,
                                                     bias_attr=False),
                               (2, 4, 7, 8)),
    "Conv2D_depthwise": ((4, 4, 3), dict(padding=1, groups=4),
                         (2, 4, 7, 8)),
    "Conv2DTranspose": ((4, 6, 3), dict(stride=2, padding=1, groups=2,
                                        act="tanh"), (2, 4, 5, 6)),
    "Pool2D_max": ((3, "max"), dict(stride=2, padding=1), (2, 3, 7, 8)),
    "Pool2D_avg_ceil": ((2, "avg"), dict(stride=2, padding=1,
                                         ceil_mode=True), (2, 3, 6, 6)),
    "Pool2D_nhwc": ((3, "max"), dict(stride=2, padding=1,
                                     data_format="NHWC"), (2, 7, 8, 3)),
    "BatchNorm": ((4,), dict(momentum=0.8, act="relu"), (3, 4, 5, 5)),
    "BatchNorm_nhwc": ((4,), dict(data_layout="NHWC"), (3, 5, 5, 4)),
    "GroupNorm": ((2, 4), {}, (2, 4, 3, 5)),
    "PRelu_all": ((), dict(init=0.3), (2, 4, 3, 3)),
    "PRelu_channel": (("channel", 4), {}, (2, 4, 3, 3)),
    "Flatten": ((), {}, (2, 3, 4, 5)),
    "Flatten_axis2": ((2,), {}, (2, 3, 4, 5)),
    "ReLU": ((), {}, (2, 5)),
    "GELU": ((), {}, (2, 5)),
    "GELU_tanh": ((True,), {}, (2, 5)),
    "Sigmoid": ((), {}, (2, 5)),
    "Tanh": ((), {}, (2, 5)),
    "Softmax": ((1,), {}, (2, 5, 3)),
}


def _cls(name):
    return name.split("_")[0]


def _pair(name):
    args, kw, _ = LAYERS[name]
    pt.seed(3)
    jl = getattr(jnn, _cls(name))(*args, **kw)
    tkw = dict(kw)
    if jl.named_parameters() or jl.named_buffers():
        tkw["device"] = "cpu"
    tl = getattr(tnn, _cls(name))(*args, **tkw)
    # start BatchNorm away from its zeros/ones buffers
    rng = np.random.default_rng(4)
    state = {k: np.asarray(v) for k, v in jl.named_parameters().items()}
    for k, v in jl.named_buffers().items():
        v = np.asarray(v)
        state[k] = (v + rng.random(v.shape).astype(v.dtype) * 0.5)
    jl.set_buffers({k: jnp.asarray(state[k]) for k in jl.named_buffers()})
    load_numpy_state(tl, state)
    return jl, tl


@pytest.fixture(autouse=True)
def float32_policy():
    yield
    TD.set_policy("float32")
    JD.set_policy("float32")


# BatchNorm in training and eval mode; the other layers have one mode
CASES = [(name, training) for name in LAYERS
         for training in ((True, False) if name.startswith("BatchNorm")
                          else (True,))]


@pytest.mark.parametrize("policy", list(TOL))
@pytest.mark.parametrize("name,training", CASES)
def test_layer_matches_jax(name, training, policy):
    jl, tl = _pair(name)
    rng = np.random.default_rng(5)
    x = rng.normal(size=LAYERS[name][2]).astype(np.float32)
    tol = TOL[policy]
    params = jl.named_parameters()
    with JD.policy_scope(policy):
        jout, jbuf = jl.functional_call(params, jnp.asarray(x),
                                        training=training)
        cot = rng.normal(size=jout.shape).astype(np.float32)

        def loss(p):
            out, _ = jl.functional_call(p, jnp.asarray(x),
                                        training=training)
            return jnp.sum(out.astype(jnp.float32) * cot)

        jgrad = jax.grad(loss)(params) if params else {}
    tl.train(training)
    with TD.policy_scope(policy):
        tout = tl(torch.from_numpy(x))
    assert str(tout.dtype).split(".")[-1] == str(jout.dtype)
    want = np.asarray(jout, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(tout.detach().float().numpy(), want,
                               atol=tol * scale, rtol=0)
    if params:
        (tout.float() * torch.from_numpy(cot)).sum().backward()
        got = dict(tl.named_parameters())
        for k, g in jgrad.items():
            g = np.asarray(g)
            np.testing.assert_allclose(
                got[k].grad.numpy(), g, rtol=0,
                atol=tol * max(1.0, float(np.abs(g).max())), err_msg=k)
    for k, b in tl.named_buffers():
        np.testing.assert_allclose(b.numpy(), np.asarray(jbuf[k]),
                                   atol=TOL["float32"], rtol=0, err_msg=k)


def test_batchnorm_buffers_carry_by_name():
    tl = tnn.BatchNorm(5, device="cpu")
    assert sorted(dict(tl.named_buffers())) == ["mean", "variance"]
    assert sorted(tl.state_dict()) == ["bias", "mean", "variance", "weight"]
    jl = jnn.BatchNorm(5)
    assert sorted(jl.named_buffers()) == ["mean", "variance"]


def test_conv2d_bias_and_parameter_layouts():
    tl = tnn.Conv2D(4, 6, (3, 2), groups=2, device="cpu")
    assert tl.weight.shape == (6, 2, 3, 2) and tl.bias.shape == (6,)
    tt = tnn.Conv2DTranspose(4, 6, 3, groups=2, device="cpu")
    assert tt.weight.shape == (4, 3, 3, 3)       # IOHW, as torch's
    assert not tnn.Conv2D(4, 6, 3, bias_attr=False,
                          device="cpu").has_bias


# ----- initializers ----------------------------------------------------------

N = 200_000


def _draw(init, shape=(N,)):
    gen = torch.Generator().manual_seed(0)
    return init(shape, torch.float32, torch.device("cpu"), gen).double()


def test_uniform_and_normal_moments():
    u = _draw(I.Uniform(-2.0, 3.0))
    assert u.min() >= -2.0 and u.max() <= 3.0
    assert abs(float(u.mean()) - 0.5) < 0.02
    assert abs(float(u.std()) - 5 / np.sqrt(12)) < 0.02
    n = _draw(I.Normal(1.0, 2.0))
    assert abs(float(n.mean()) - 1.0) < 0.02
    assert abs(float(n.std()) - 2.0) < 0.02


def test_truncated_normal_bounds_and_moments():
    t = _draw(I.TruncatedNormal(1.0, 2.0))
    assert t.min() >= 1.0 - 4.0 and t.max() <= 1.0 + 4.0
    assert abs(float(t.mean()) - 1.0) < 0.02
    # std of a standard normal truncated to [-2, 2]: 0.8796
    assert abs(float(t.std()) - 2.0 * 0.8796) < 0.02


@pytest.mark.parametrize("uniform", [True, False])
def test_msra_from_fan_in(uniform):
    shape = (64, 32, 3, 3)                      # OIHW: fan_in 32 * 9
    fan_in = 32 * 9
    w = _draw(I.MSRA(uniform=uniform), shape)
    if uniform:
        limit = np.sqrt(6.0 / fan_in)
        assert w.abs().max() <= limit
        assert abs(float(w.std()) - limit / np.sqrt(3)) < 0.01 * limit
    else:
        assert abs(float(w.std()) - np.sqrt(2.0 / fan_in)) < 0.01 * np.sqrt(
            2.0 / fan_in)
    # five standard errors of the mean
    assert abs(float(w.mean())) < 5 * float(w.std()) / np.sqrt(w.numel())
    wide = _draw(I.MSRA(uniform=False, fan_in=8), (N,))
    assert abs(float(wide.std()) - 0.5) < 0.01


@pytest.mark.parametrize("shape", [(3, 3, 4, 4), (2, 1, 3, 5), (1, 4, 4, 4)])
def test_bilinear_exactly(shape):
    want = np.asarray(JI.Bilinear()(jax.random.key(0), shape))
    got = I.Bilinear()(shape, torch.float32, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_numpy_array_exactly_and_shape_checked():
    value = np.random.default_rng(6).normal(size=(3, 4)).astype(np.float32)
    got = I.NumpyArray(value)((3, 4), torch.float32, torch.device("cpu"))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JI.NumpyArray(value)(jax.random.key(0),
                                                     (3, 4))))
    with pytest.raises(Exception, match="shape"):
        I.NumpyArray(value)((4, 3), torch.float32, torch.device("cpu"))


def test_initializer_draws_follow_the_generator():
    a = _draw(I.Normal(), (16,))
    b = _draw(I.Normal(), (16,))
    assert torch.equal(a, b)
    layer = tnn.Conv2D(8, 16, 3, device="cpu",
                       generator=torch.Generator().manual_seed(1),
                       weight_init=I.TruncatedNormal(0.0, 0.1))
    assert layer.weight.abs().max() <= 0.2
