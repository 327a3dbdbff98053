"""``ops/tensor.py`` of the port against the JAX package's, on the CPU:
one case per function, the same numpy-seeded inputs through both (the
JAX side jitted, except ``where_index`` and ``unique_with_counts``,
whose output shapes depend on the data), float outputs within atol 1e-6
+ rtol 1e-6 and integer and bool outputs equal, gradients where the op
is differentiable within 1e-6.

The cases hold the semantics a plain torch port gets wrong:
- indices out of range: ``gather`` fills (``jnp.take``: NaN for floats,
  the type's minimum for int32), ``gather_nd`` and ``multiplex`` clamp
  (``x[...]``), ``scatter`` (set and add) and ``scatter_nd_add`` drop
  the row; negative indices in range wrap;
- float-to-int ``cast`` saturates at the target's range and sends NaN
  to 0, as XLA's convert does (int8, uint8, int32 with NaN and +-inf);
- ties: ``top_k`` puts the lower index first, ``argsort(descending=
  True)`` the higher one;
- the random ops match in distribution only (the same key gives the
  same port draw, a distribution as the JAX draw's): 200000 draws each,
  the mean and standard deviation within 0.01 of the JAX draw's (about
  four standard errors), the truncated normal inside [-2, 2]."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import tensor as J
from paddle_tpu_torch.ops import tensor as T
from torch_parity import check_pair, compare

RNG = np.random.default_rng(1)
P = functools.partial
CPU = dict(device="cpu")


def f32(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def i32(*a):
    return np.array(a, np.int32)


X53 = f32(5, 3)
SATURATING = np.array([-1.5, 300.7, -300.2, 3e9, np.nan, np.inf, -np.inf,
                       -3e9, 126.9, 2147483520.0], np.float32)
TIES = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 1.0], [0.0, 0.0, 5.0, 5.0, 0.0,
                                                   -1.0]], np.float32)

# name -> (JAX fn, port fn, args, grad positions)
CASES = {
    "fill_constant": (P(J.fill_constant, (2, 3), 1.5),
                      P(T.fill_constant, (2, 3), 1.5, **CPU), [], ()),
    "fill_constant_batch_size_like": (
        P(J.fill_constant_batch_size_like, shape=(1, 4), value=2.0,
          input_dim_idx=1, output_dim_idx=0),
        P(T.fill_constant_batch_size_like, shape=(1, 4), value=2.0,
          input_dim_idx=1, output_dim_idx=0), [f32(2, 3)], ()),
    "fill_zeros_like": (J.fill_zeros_like, T.fill_zeros_like, [f32(2, 3)],
                        ()),
    "ones": (P(J.ones, (2, 3)), P(T.ones, (2, 3), **CPU), [], ()),
    "zeros": (P(J.zeros, (4,)), P(T.zeros, (4,), **CPU), [], ()),
    "eye": (P(J.eye, 3, 4), P(T.eye, 3, 4, **CPU), [], ()),
    "diag": (J.diag, T.diag, [f32(4)], (0,)),
    "diag_of_matrix": (J.diag, T.diag, [f32(3, 3)], (0,)),
    "linspace": (P(J.linspace, -1.0, 2.0, 7),
                 P(T.linspace, -1.0, 2.0, 7, **CPU), [], ()),
    "arange": (P(J.arange, 2, 11, 3), P(T.arange, 2, 11, 3, **CPU), [], ()),
    "arange_float": (P(J.arange, 0.5, 2.0, 0.25),
                     P(T.arange, 0.5, 2.0, 0.25, **CPU), [], ()),
    "assign": (J.assign, T.assign, [f32(2, 2)], (0,)),
    "reshape": (P(J.reshape, shape=[0, -1, 2]), P(T.reshape, shape=[0, -1, 2]),
                [f32(3, 4, 2)], (0,)),
    "transpose": (P(J.transpose, perm=(2, 0, 1)),
                  P(T.transpose, perm=(2, 0, 1)), [f32(2, 3, 4)], (0,)),
    "flatten": (P(J.flatten, axis=2), P(T.flatten, axis=2), [f32(2, 3, 4)],
                (0,)),
    "squeeze": (P(J.squeeze, axes=[1]), P(T.squeeze, axes=[1]),
                [f32(2, 1, 3, 1)], (0,)),
    "squeeze_all": (J.squeeze, T.squeeze, [f32(2, 1, 3, 1)], (0,)),
    "unsqueeze": (P(J.unsqueeze, axes=[0, 3]), P(T.unsqueeze, axes=[0, 3]),
                  [f32(2, 3)], (0,)),
    "expand": (P(J.expand, expand_times=(2, 1, 3)),
               P(T.expand, expand_times=(2, 1, 3)), [f32(2, 3, 1)], (0,)),
    "expand_as": (J.expand_as, T.expand_as, [f32(1, 3), f32(4, 3)], (0,)),
    "stack": (lambda a, b: J.stack([a, b], 1), lambda a, b: T.stack([a, b], 1),
              [f32(2, 3), f32(2, 3)], (0, 1)),
    "unstack": (P(J.unstack, axis=1), P(T.unstack, axis=1), [f32(2, 3, 4)],
                (0,)),
    "concat": (lambda a, b: J.concat([a, b], -1),
               lambda a, b: T.concat([a, b], -1), [f32(2, 3), f32(2, 2)],
               (0, 1)),
    "split": (P(J.split, num_or_sections=2, axis=1),
              P(T.split, num_or_sections=2, axis=1), [f32(2, 4)], (0,)),
    "split_sections": (P(J.split, num_or_sections=[1, -1, 2], axis=1),
                       P(T.split, num_or_sections=[1, -1, 2], axis=1),
                       [f32(2, 6)], (0,)),
    "slice": (P(J.slice, axes=[0, 2], starts=[1, -3], ends=[3, 10]),
              P(T.slice, axes=[0, 2], starts=[1, -3], ends=[3, 10]),
              [f32(4, 3, 5)], (0,)),
    "strided_slice": (P(J.strided_slice, axes=[0, 1], starts=[0, 4],
                        ends=[4, 0], strides=[2, -2]),
                      P(T.strided_slice, axes=[0, 1], starts=[0, 4],
                        ends=[4, 0], strides=[2, -2]), [f32(4, 6)], (0,)),
    "crop": (P(J.crop, shape=(2, 2), offsets=(1, 2)),
             P(T.crop, shape=(2, 2), offsets=(1, 2)), [f32(4, 5)], (0,)),
    "reverse": (P(J.reverse, axis=[0, 2]), P(T.reverse, axis=[0, 2]),
                [f32(2, 3, 4)], (0,)),
    "pad": (P(J.pad, paddings=[1, 0, 2, 3], pad_value=-1.0),
            P(T.pad, paddings=[1, 0, 2, 3], pad_value=-1.0), [f32(2, 3)],
            (0,)),
    "pad_constant_like": (P(J.pad_constant_like, pad_value=0.5),
                          P(T.pad_constant_like, pad_value=0.5),
                          [f32(4, 5), f32(2, 3)], (1,)),
    "shape": (J.shape, T.shape, [f32(2, 3, 4)], ()),
    "cast": (P(J.cast, dtype="int32"), P(T.cast, dtype="int32"),
             [f32(3, 4) * 3], ()),
    # float to int saturates at the range and sends NaN to 0 (XLA's
    # convert; a bare .to wraps)
    "cast_saturating_int8": (P(J.cast, dtype="int8"), P(T.cast, dtype="int8"),
                             [SATURATING], ()),
    "cast_saturating_uint8": (P(J.cast, dtype="uint8"),
                              P(T.cast, dtype="uint8"), [SATURATING], ()),
    "cast_saturating_int32": (P(J.cast, dtype="int32"),
                              P(T.cast, dtype="int32"), [SATURATING], ()),
    "gather": (P(J.gather, axis=0), P(T.gather, axis=0),
               [X53, i32(0, 4, 2, -1)], (0,)),
    "gather_out_of_range": (P(J.gather, axis=0), P(T.gather, axis=0),
                            [X53, i32(0, 5, -1, -5, -6, 9)], ()),
    "gather_axis1_int": (P(J.gather, axis=1), P(T.gather, axis=1),
                         [RNG.integers(-9, 9, (2, 4)).astype(np.int32),
                          i32(3, 4, -1, -7)], ()),
    "gather_nd": (J.gather_nd, T.gather_nd,
                  [f32(3, 4, 2), i32(0, 1, 2, 3, 1, 0).reshape(3, 2)], (0,)),
    "gather_nd_out_of_range": (
        J.gather_nd, T.gather_nd,
        [f32(3, 4, 2), i32(3, 1, -1, 4, 7, -9, 0, -4).reshape(4, 2)], (0,)),
    "scatter": (J.scatter, T.scatter, [X53, i32(1, 3, 0), f32(3, 3)],
                (0, 2)),
    "scatter_out_of_range": (J.scatter, T.scatter,
                             [X53, i32(1, 7, -1, -9), f32(4, 3)], ()),
    "scatter_add": (P(J.scatter, overwrite=False),
                    P(T.scatter, overwrite=False),
                    [X53, i32(1, 1, -1, 9, 4), f32(5, 3)], (0, 2)),
    "scatter_nd_add": (J.scatter_nd_add, T.scatter_nd_add,
                       [f32(4, 5), i32(0, 1, 3, 4, 0, 1, -1, 2, 4, 0, 2, 7)
                        .reshape(6, 2), f32(6)], (0, 2)),
    "scatter_nd_add_rows": (J.scatter_nd_add, T.scatter_nd_add,
                            [f32(4, 3), i32(2, 2, 5, -1).reshape(4, 1),
                             f32(4, 3)], (0, 2)),
    "top_k": (P(J.top_k, k=3), P(T.top_k, k=3), [f32(3, 7)], (0,)),
    "top_k_ties": (P(J.top_k, k=4), P(T.top_k, k=4), [TIES], ()),
    "argsort": (J.argsort, T.argsort, [f32(3, 5)], (0,)),
    "argsort_ties": (J.argsort, T.argsort, [TIES], ()),
    "argsort_descending_ties": (P(J.argsort, descending=True),
                                P(T.argsort, descending=True), [TIES], ()),
    "argsort_axis0": (P(J.argsort, axis=0, descending=True),
                      P(T.argsort, axis=0, descending=True), [TIES], ()),
    "arg_max": (J.arg_max, T.arg_max, [TIES], ()),
    "arg_min": (P(J.arg_min, axis=0), P(T.arg_min, axis=0), [TIES], ()),
    "where": (J.where, T.where, [RNG.random((3, 4)) < 0.5, f32(3, 4),
                                 f32(3, 4)], (1, 2)),
    "multiplex": (lambda i, a, b, c: J.multiplex(i, [a, b, c]),
                  lambda i, a, b, c: T.multiplex(i, [a, b, c]),
                  [i32(0, 2, 1, 1).reshape(4, 1), f32(4, 2), f32(4, 2),
                   f32(4, 2)], (1, 2, 3)),
    "multiplex_out_of_range": (
        lambda i, a, b, c: J.multiplex(i, [a, b, c]),
        lambda i, a, b, c: T.multiplex(i, [a, b, c]),
        [i32(5, -1, -4, 3).reshape(4, 1), f32(4, 2), f32(4, 2),
         f32(4, 2)], (1, 2, 3)),
    "is_empty": (J.is_empty, T.is_empty, [np.zeros((2, 0), np.float32)], ()),
    "roll": (P(J.roll, shifts=2, axis=1), P(T.roll, shifts=2, axis=1),
             [f32(2, 5)], (0,)),
    "roll_flat": (P(J.roll, shifts=-3), P(T.roll, shifts=-3), [f32(2, 5)],
                  (0,)),
    "tril": (P(J.tril, k=-1), P(T.tril, k=-1), [f32(4, 4)], (0,)),
    "triu": (P(J.triu, k=1), P(T.triu, k=1), [f32(3, 4)], (0,)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_op_matches_jax(name):
    jfn, tfn, args, grad = CASES[name]
    check_pair(jfn, tfn, args, grad=grad)


def test_out_of_range_results_are_the_jax_fill_clamp_and_drop():
    """What the out-of-range cases above compare, spelled out."""
    x = torch.from_numpy(X53)
    g = T.gather(x, torch.tensor([5, -1, -6]))
    assert torch.isnan(g[0]).all() and torch.equal(g[1], x[4])
    assert torch.isnan(g[2]).all()
    gi = T.gather(torch.arange(4, dtype=torch.int32), torch.tensor([4]))
    assert int(gi[0]) == torch.iinfo(torch.int32).min
    s = T.scatter(x, torch.tensor([7]), torch.ones(1, 3))
    assert torch.equal(s, x)
    nd = T.gather_nd(x, torch.tensor([[9, -9]]))
    assert float(nd[0]) == float(x[4, 0])


def test_saturating_cast_values_and_the_int64_choice():
    """The saturating cases above, spelled out (ROADMAP's table). The JAX
    package runs without 64-bit mode, so its "int64" is int32 and
    saturates there; the port keeps int64 and saturates at int64's
    range."""
    x = torch.from_numpy(SATURATING[:6])
    assert T.cast(x, "int8").tolist() == [-1, 127, -128, 127, 0, 127]
    assert T.cast(x, "uint8").tolist() == [0, 255, 0, 255, 0, 255]
    assert T.cast(x, "int32").tolist() == [-1, 300, -300, 2 ** 31 - 1, 0,
                                           2 ** 31 - 1]
    want = np.asarray(J.cast(jnp.asarray(SATURATING[:6]), "int64"))
    assert want.dtype == np.int32 and want[3] == 2 ** 31 - 1
    got = T.cast(x, "int64")
    assert got.dtype == torch.int64
    assert got.tolist() == [-1, 300, -300, 3000000000, 0, 2 ** 63 - 1]


def test_dynamic_shape_ops_match_jax_eagerly():
    cond = RNG.random((3, 4)) < 0.4
    compare(T.where_index(torch.from_numpy(cond)), J.where_index(
        jnp.asarray(cond)), 0, 0)
    v = RNG.integers(0, 5, (12,)).astype(np.int32)
    compare(T.unique_with_counts(torch.from_numpy(v)),
            J.unique_with_counts(jnp.asarray(v)), 0, 0)


N_DRAWS = 200_000


def _key(i):
    return np.asarray(jax.random.key_data(jax.random.key(i)))


@pytest.mark.parametrize("name,kw,lo,hi", [
    ("uniform_random", dict(min=-2.0, max=3.0), -2.0, 3.0),
    ("gaussian_random", dict(mean=1.0, std=2.0), -np.inf, np.inf),
    ("truncated_gaussian_random", dict(mean=0.5, std=1.5), -2.5, 3.5)])
def test_random_ops_match_jax_in_distribution(name, kw, lo, hi):
    key = _key(3)
    got = getattr(T, name)((N_DRAWS,), key, **kw, device="cpu")
    again = getattr(T, name)((N_DRAWS,), key, **kw, device="cpu")
    other = getattr(T, name)((N_DRAWS,), _key(4), **kw, device="cpu")
    want = np.asarray(getattr(J, name)((N_DRAWS,), jax.random.key(3), **kw))
    assert torch.equal(got, again) and not torch.equal(got, other)
    g = got.numpy().astype(np.float64)
    assert g.min() >= lo and g.max() <= hi
    assert abs(g.mean() - want.mean()) < 0.01 * max(1.0, want.std())
    assert abs(g.std() - want.std()) < 0.01 * max(1.0, want.std())


def test_random_crop_is_a_window_drawn_from_the_key():
    x = torch.arange(2 * 6 * 7, dtype=torch.float32).reshape(2, 6, 7)
    seen = set()
    for i in range(40):
        out = T.random_crop(x, (3, 4), _key(i))
        assert out.shape == (2, 3, 4)
        o1, o2 = int(out[0, 0, 0]) // 7, int(out[0, 0, 0]) % 7
        assert torch.equal(out, x[:, o1:o1 + 3, o2:o2 + 4])
        assert torch.equal(out, T.random_crop(x, (3, 4), _key(i)))
        seen.add((o1, o2))
    want = J.random_crop(jnp.asarray(x.numpy()), (3, 4), jax.random.key(0))
    assert want.shape == (2, 3, 4)
    # 4 x 4 offsets; 40 draws from the key see most of them
    assert len(seen) >= 10 and all(0 <= a <= 3 and 0 <= b <= 3
                                   for a, b in seen)


def test_every_public_name_has_a_case():
    import inspect

    names = {n for n, f in vars(J).items() if inspect.isfunction(f)
             and not n.startswith("_") and f.__module__ == J.__name__}
    covered = {n for n in names if any(c == n or c.startswith(n + "_")
                                       for c in CASES)}
    covered |= {"where_index", "unique_with_counts", "uniform_random",
                "gaussian_random", "truncated_gaussian_random",
                "random_crop"}
    assert names <= covered, sorted(names - covered)
    assert all(hasattr(T, n) for n in names)
