"""``ops/math.py`` (the functions that are not activations) and
``ops/reduction.py`` of the port against the JAX package's, on the CPU:
one case per function, the same numpy-seeded inputs through both (the
JAX side jitted), outputs within atol 1e-6 + rtol 1e-6 in float32
(integer and bool outputs equal), and where the op is differentiable the
gradients of a fixed random projection of the outputs within 1e-5 (a
reduction over a few dozen products rounds differently in XLA and
torch). The cases include Paddle's ``axis`` broadcast, ``mul``'s
``*_num_col_dims`` flattening, and ``elementwise_mod`` and
``elementwise_floordiv`` on negative operands (``jnp``'s sign rules:
the result takes the divisor's sign, the quotient rounds down), and
the gradients at every kink of ``clip``, ``l1_norm`` and the clipped
activations (JAX splits a tie at a bound 0.5 / 0.5 and gives ``abs``
the derivative +1 at 0; ``torch.clamp`` and ``torch.abs`` do not)."""

import functools

import numpy as np
import pytest

from paddle_tpu.ops import math as JM
from paddle_tpu.ops import reduction as JR
from paddle_tpu_torch.ops import math as TM
from paddle_tpu_torch.ops import reduction as TR
from torch_parity import check_pair

RNG = np.random.default_rng(0)


def f32(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def pos32(*shape):
    return RNG.uniform(0.5, 2.0, size=shape).astype(np.float32)


def ints(lo, hi, *shape):
    return RNG.integers(lo, hi, size=shape).astype(np.int32)


NONZERO = ints(1, 5, 3, 4) * np.where(RNG.random((3, 4)) < 0.5, -1, 1)

# name -> (args, static kwargs, grad positions)
CASES = {
    "maxout": ([f32(2, 6, 3, 3)], dict(groups=3), (0,)),
    "maxout_axis3": ([f32(2, 3, 3, 4)], dict(groups=2, axis=3), (0,)),
    "elementwise_add": ([f32(2, 3, 4, 5), f32(3, 4)], dict(axis=1), (0, 1)),
    "elementwise_add_tail": ([f32(2, 3, 4), f32(4)], {}, (0, 1)),
    "elementwise_sub": ([f32(2, 3, 4), f32(2, 3)], dict(axis=0), (0, 1)),
    "elementwise_mul": ([f32(2, 3, 4), f32(3)], dict(axis=1), (0, 1)),
    "elementwise_div": ([f32(2, 3, 4), pos32(3, 4)], dict(axis=1), (0, 1)),
    "elementwise_min": ([f32(3, 4), f32(3, 4)], {}, (0, 1)),
    "elementwise_max": ([f32(2, 3, 4), f32(3)], dict(axis=1), (0, 1)),
    "elementwise_pow": ([pos32(3, 4), f32(3, 4)], {}, (0, 1)),
    "elementwise_mod": ([f32(3, 4) * 5, NONZERO.astype(np.float32)], {},
                        (0,)),
    "elementwise_mod_int": ([ints(-20, 20, 3, 4), NONZERO], {}, ()),
    "elementwise_floordiv": ([ints(-20, 20, 3, 4), NONZERO], {}, ()),
    "elementwise_floordiv_float": ([f32(3, 4) * 5,
                                    NONZERO.astype(np.float32)], {}, ()),
    "matmul": ([f32(2, 3, 4), f32(2, 4, 5)], {}, (0, 1)),
    "matmul_transposed": ([f32(2, 4, 3), f32(5, 4)],
                          dict(transpose_x=True, transpose_y=True,
                               alpha=0.5), (0, 1)),
    "matmul_vector": ([f32(4), f32(4, 3)], {}, (0, 1)),
    "mul": ([f32(2, 3, 4), f32(12, 5)], dict(x_num_col_dims=1), (0, 1)),
    "mul_col_dims": ([f32(2, 3, 4), f32(4, 2, 3)],
                     dict(x_num_col_dims=2, y_num_col_dims=1), (0, 1)),
    "bilinear_tensor_product": ([f32(4, 3), f32(4, 5), f32(6, 3, 5),
                                 f32(6)], {}, (0, 1, 2, 3)),
    "scale": ([f32(3, 4)], dict(scale=2.5, bias=0.5), (0,)),
    "scale_bias_first": ([f32(3, 4)], dict(scale=2.5, bias=0.5,
                                           bias_after_scale=False), (0,)),
    "clip": ([f32(3, 4)], dict(min=-0.5, max=0.7), (0,)),
    "clip_by_norm": ([f32(3, 4)], dict(max_norm=1.0), (0,)),
    "clip_by_norm_inside": ([f32(3, 4) * 0.01], dict(max_norm=1.0), (0,)),
    "sign": ([np.array([-2.0, 0.0, 3.0, -0.0], np.float32)], {}, ()),
    "cumsum": ([f32(3, 4)], dict(axis=1), (0,)),
    "cumsum_flat": ([f32(3, 4)], {}, (0,)),
    "cumsum_exclusive_reverse": ([f32(3, 4)], dict(axis=0, exclusive=True,
                                                   reverse=True), (0,)),
    "increment": ([f32(3)], dict(value=2.0), (0,)),
    "l1_norm": ([f32(3, 4)], {}, (0,)),
    "squared_l2_norm": ([f32(3, 4)], {}, (0,)),
    "squared_l2_distance": ([f32(3, 4, 2), f32(3, 4, 2)], {}, (0, 1)),
    "cos_sim": ([f32(5, 8), f32(5, 8)], {}, (0, 1)),
    "cos_sim_zero_row": ([np.concatenate([np.zeros((1, 4), np.float32),
                                          f32(2, 4)]), f32(3, 4)], {}, ()),
    "logsumexp": ([f32(3, 4)], dict(axis=1), (0,)),
    "logsumexp_all_keep": ([f32(3, 4)], dict(keepdims=True), (0,)),
    "logsumexp_neg_inf_row": ([np.array([[-np.inf, -np.inf], [0.0, 1.0]],
                                        np.float32)], dict(axis=1), ()),
    "isfinite": ([np.array([1.0, np.inf], np.float32)], {}, ()),
    "isfinite_true": ([f32(3)], {}, ()),
    "has_inf": ([np.array([1.0, -np.inf], np.float32)], {}, ()),
    "has_nan": ([np.array([1.0, np.nan], np.float32)], {}, ()),
    # kinks: clip splits a tie at each bound, abs has derivative +1 at 0
    "clip_at_bounds": ([np.array([-0.5, 0.7, 0.0, 2.0], np.float32)],
                       dict(min=-0.5, max=0.7), (0,)),
    "l1_norm_at_zero": ([np.array([0.0, -0.0, 1.5, -2.0], np.float32)], {},
                        (0,)),
}

RED_CASES = {
    "reduce_sum": ([f32(2, 3, 4)], dict(dim=[0, 2]), (0,)),
    "reduce_sum_all": ([f32(2, 3, 4)], {}, (0,)),
    "reduce_mean": ([f32(2, 3, 4)], dict(dim=1, keep_dim=True), (0,)),
    "reduce_mean_int": ([ints(0, 9, 3, 4)], dict(dim=0), ()),
    "reduce_max": ([f32(2, 3, 4)], dict(dim=-1), (0,)),
    "reduce_min": ([f32(2, 3, 4)], dict(dim=(0, 1)), (0,)),
    "reduce_prod": ([pos32(2, 3, 4)], dict(dim=[0, 2], keep_dim=True),
                    (0,)),
    "reduce_prod_all": ([pos32(2, 3)], {}, (0,)),
    "reduce_all": ([RNG.random((3, 4)) < 0.8], dict(dim=1), ()),
    "reduce_any": ([RNG.random((3, 4)) < 0.2], {}, ()),
    "mean": ([f32(3, 4)], {}, (0,)),
    "sum": ([f32(3, 4)], {}, (0,)),
}


def _fn(module, name):
    base = name
    while not hasattr(module, base):
        base = base.rsplit("_", 1)[0]
    return getattr(module, base)


@pytest.mark.parametrize("name", sorted(CASES))
def test_math_op_matches_jax(name):
    args, kw, grad = CASES[name]
    check_pair(functools.partial(_fn(JM, name), **kw),
               functools.partial(_fn(TM, name), **kw), args, grad=grad,
               gatol=1e-5)


@pytest.mark.parametrize("name", sorted(RED_CASES))
def test_reduction_matches_jax(name):
    args, kw, grad = RED_CASES[name]
    check_pair(functools.partial(_fn(JR, name), **kw),
               functools.partial(_fn(TR, name), **kw), args, grad=grad,
               gatol=1e-5)


# activations at their kinks: exactly 0 and each clip bound, where JAX
# splits a tie (jnp.clip / maximum / minimum), jnp.abs has derivative +1
# and jax.nn.relu6 (inside hard_silu) has derivative 0 at its bounds
KINKS = {
    "abs": [0.0, -0.0, 1.5, -2.0],
    "brelu": [0.0, 24.0, -1.0, 3.0, 30.0],
    "relu6": [0.0, -0.0, 6.0, 3.0, 7.0],
    # slope 0.25 puts both bounds on exact products (0.2 x + 0.5 at
    # x = -2.5 is not 0 once XLA fuses it into one fma)
    "hard_sigmoid": ([-2.0, 2.0, 0.0, 3.0], dict(slope=0.25)),
    "soft_relu": [40.0, -40.0, 0.0, 50.0],
    "celu": [0.0, -0.0, 1.0, -1.0],
    "hard_silu": [-3.0, 3.0, 0.0, -4.0, 4.0],
    "hard_swish": [-3.0, 3.0, 0.0, -4.0, 4.0],
    "sparse_sigmoid": [-1.0, 1.0, 0.0, 2.0],
    "softsign": [0.0, -0.0, 1.0],
}


@pytest.mark.parametrize("name", sorted(KINKS))
def test_activation_gradient_at_its_kinks_matches_jax(name):
    import jax

    from paddle_tpu_torch.ops.math import ACTIVATIONS

    pts, kw = KINKS[name] if isinstance(KINKS[name], tuple) else (
        KINKS[name], {})
    jfn = getattr(JM, name, None) or getattr(jax.nn, name)
    check_pair(functools.partial(jfn, **kw),
               functools.partial(ACTIVATIONS[name], **kw),
               [np.array(pts, np.float32)], grad=(0,), gatol=1e-6)


def test_sum_of_a_list_matches_jax():
    xs = [f32(2, 3) for _ in range(3)]
    check_pair(lambda a, b, c: JR.sum([a, b, c]),
               lambda a, b, c: TR.sum([a, b, c]), xs, grad=(0, 1, 2))


def test_every_public_name_has_a_case():
    """Each public function of the two JAX modules that the port lacked
    before this slice has a case above (the activations have theirs in
    tests/test_torch_activations.py)."""
    import inspect

    from paddle_tpu_torch.ops.math import ACTIVATIONS

    covered = {_fn(JM, n).__name__ for n in CASES} | {"prelu"}
    for name, f in vars(JM).items():
        if (inspect.isfunction(f) and not name.startswith("_")
                and f.__module__ == JM.__name__ and name not in ACTIVATIONS):
            assert name in covered, name
    covered = {_fn(JR, n).__name__ for n in RED_CASES}
    for name, f in vars(JR).items():
        if (inspect.isfunction(f) and not name.startswith("_")
                and f.__module__ == JR.__name__):
            assert name in covered, name


def test_bilinear_tensor_product_layer_matches_jax():
    """nn.BilinearTensorProduct over the op, on the JAX layer's weights:
    output within 1e-6, grads within 1e-5."""
    import jax
    import jax.numpy as jnp
    import torch

    import paddle_tpu as pt
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.utils.convert import load_numpy_state

    pt.seed(1)
    jl = jnn.BilinearTensorProduct(3, 4, 5)
    tl = tnn.BilinearTensorProduct(3, 4, 5, device="cpu")
    params = jl.named_parameters()
    params["bias"] = f32(5)
    jl.set_parameters(params)
    load_numpy_state(tl, {k: np.asarray(v) for k, v in params.items()})
    x, y = f32(6, 3), f32(6, 4)

    def jloss(p):
        out, _ = jl.functional_call(p, jnp.asarray(x), jnp.asarray(y))
        return jnp.sum(out ** 2), out

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    got = tl(torch.from_numpy(x), torch.from_numpy(y))
    (got ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-6)
    for k, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    assert not tnn.BilinearTensorProduct(3, 4, 5, bias_attr=False,
                                         device="cpu").has_bias
