"""``act=`` names in the port (paddle_tpu_torch/ops/math.py
``activation``) against the JAX package's ``_apply_act``, which resolves
a name in its ``ops.math`` and then in ``jax.nn``.

- The port's table holds exactly the names the JAX package resolves to
  a one-argument activation: the functions of ``paddle_tpu/ops/math.py``'s
  activation section (the reference's functor table, up to its
  elementwise-binary section) that take one array, then ``jax.nn``'s
  activations under the names it exports. ``NOT_ACTIVATIONS`` lists, with
  a reason, the other names either resolves.
- ``Linear(act=name)`` in both packages, on the same seeded weights and
  a 3-D input (2, 3, 8) -> (2, 3, 6): atol 1e-6 plus rtol 1e-6 (the same
  formula in float32 in both; a transcendental may round one ulp apart,
  which is 1e-6 relative, e.g. exp of an output near 3).
- A torch-only name raises the typed ``InvalidArgumentError``, which the
  JAX package refuses too.
- ``Int8Linear`` with a non-relu activation, on the same frozen entry."""

import inspect

import jax.nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import EnforceError as JaxEnforceError
from paddle_tpu.ops import math as OM
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import quant
from paddle_tpu_torch.core import InvalidArgumentError
from paddle_tpu_torch.ops.math import ACTIVATIONS, activation
from paddle_tpu_torch.utils.convert import load_numpy_state

# names the JAX package resolves that are not one-argument activations:
# ops.math's elementwise-binary, matmul, reduction and utility ops, and
# the activations that need a second array; jax.nn's non-activations
NOT_ACTIVATIONS = {
    "maxout": "needs groups: the JAX package's act= call fails on it",
    "prelu": "needs alpha: the JAX package's act= call fails on it",
    "logsumexp": "a reduction to one value, not an activation",
    "logmeanexp": "a reduction to one value, not an activation",
    "one_hot": "needs num_classes; integer input",
    "dot_product_attention": "needs k and v",
    "scaled_dot_general": "a product, needs two operands",
    "scaled_matmul": "a product, needs four operands",
    "get_scaled_dot_general_config": "a config factory, not an array op",
}


def _one_array_arg(fn):
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return False
    required = [p for p in params if p.default is p.empty and p.kind in (
        p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(required) == 1


def reference_activation_names():
    """The names the JAX package's ``_apply_act`` resolves to a
    one-argument activation."""
    end = inspect.getsourcelines(OM._broadcast_y)[1]
    names = {n for n, f in vars(OM).items()
             if inspect.isfunction(f) and not n.startswith("_")
             and f.__module__ == OM.__name__
             and inspect.getsourcelines(f)[1] < end}
    names |= {n for n in dir(jax.nn) if not n.startswith("_")
              and callable(getattr(jax.nn, n))}
    return {n for n in names - set(NOT_ACTIVATIONS)
            if _one_array_arg(getattr(OM, n, None) or getattr(jax.nn, n))}


def test_table_holds_exactly_the_reference_names():
    ref = reference_activation_names()
    assert set(ACTIVATIONS) == ref, (sorted(set(ACTIVATIONS) - ref),
                                     sorted(ref - set(ACTIVATIONS)))
    for n in NOT_ACTIVATIONS:       # each is a name the reference resolves
        assert getattr(OM, n, None) or getattr(jax.nn, n)


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_linear_act_matches_jax(name):
    pt.seed(3)
    jl = pt.nn.Linear(8, 6, act=name)
    tl = tnn.Linear(8, 6, act=name, device="cpu")
    rng = np.random.default_rng(4)
    jl.set_parameters({"bias": rng.normal(size=(6,)).astype(np.float32)})
    load_numpy_state(tl, {k: np.asarray(v) for k, v in
                          jl.named_parameters().items()})
    x = rng.normal(size=(2, 3, 8)).astype(np.float32)
    want = np.asarray(jl(jnp.asarray(x)))
    got = tl(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_defaults_that_differ_from_torch():
    x = torch.tensor([[-2.0, 0.5, 3.0]])
    assert torch.allclose(activation("leaky_relu")(x),
                          torch.tensor([[-0.04, 0.5, 3.0]]))
    x3 = torch.arange(8.0).reshape(2, 2, 2)
    assert torch.allclose(activation("softmax")(x3).sum(-1),
                          torch.ones(2, 2))
    assert torch.allclose(activation("hard_sigmoid")(torch.tensor([1.0])),
                          torch.tensor([0.7]))


@pytest.mark.parametrize("name", ["hardswish", "gelu_tanh", "Relu"])
def test_names_outside_the_table_raise(name):
    with pytest.raises(InvalidArgumentError, match=name):
        tnn.Linear(4, 4, act=name, device="cpu")(torch.zeros(1, 4))
    with pytest.raises(JaxEnforceError):         # refused there too
        pt.nn.Linear(4, 4, act=name)(jnp.zeros((1, 4)))


@pytest.mark.parametrize("act", ["leaky_relu", "softmax", "gelu"])
def test_int8_linear_act_matches_jax(act):
    from paddle_tpu import quant as JQ

    rng = np.random.default_rng(5)
    entry = {"weight_int8": rng.integers(-127, 128, (16, 8)).astype(np.int8),
             "weight_scale": rng.uniform(0.5, 1.5, (8,)).astype(np.float32),
             "act_scale": np.float32(3.0)}
    bias = rng.normal(size=(8,)).astype(np.float32)
    x = rng.normal(size=(5, 16)).astype(np.float32)
    want = np.asarray(JQ.Int8Linear(
        {k: jnp.asarray(v) for k, v in entry.items()},
        bias=jnp.asarray(bias), act=act)(jnp.asarray(x)))
    layer = quant.Int8Linear({k: torch.from_numpy(np.array(v))
                              for k, v in entry.items()},
                             bias=torch.from_numpy(bias), act=act)
    got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
