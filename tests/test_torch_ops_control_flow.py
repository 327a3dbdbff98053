"""``ops/control_flow.py`` of the port against the JAX package's, on the
CPU: the compare and logical ops (exact, on ties and on mixed
int/float operands), then the structured control flow with the same
step functions written once for each package: ``while_loop``, ``cond``,
``case``, ``switch_case`` (an index out of range is clamped, as
``lax.switch`` clamps it), ``scan`` (pytree carries and outputs,
``reverse=``, ``length=`` with no xs), ``static_rnn`` (batch- and
time-major), ``fori_loop`` and ``TensorArray`` (a write leaves the
array it came from as it was; a negative index counts from the end,
one still out of range is clamped). Float
results within 1e-6, gradients through ``scan`` and ``static_rnn``
within 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import control_flow as J
from paddle_tpu_torch.ops import control_flow as T
from torch_parity import check_pair, compare

RNG = np.random.default_rng(5)


def f32(*shape):
    return RNG.normal(size=shape).astype(np.float32)


A = np.array([1.0, 2.0, 3.0, -1.0], np.float32)
BV = np.array([1.0, 3.0, 2.0, -1.0], np.float32)
BOOLS = (np.array([True, False, True, False]),
         np.array([True, True, False, False]))

BINARY = ["less_than", "less_equal", "greater_than", "greater_equal",
          "equal", "not_equal"]
LOGICAL = ["logical_and", "logical_or", "logical_xor"]


@pytest.mark.parametrize("name", BINARY)
def test_compare_ops_match_jax(name):
    check_pair(getattr(J, name), getattr(T, name), [A, BV])
    check_pair(getattr(J, name), getattr(T, name),
               [np.array([1, 2, 3], np.int32), np.array([2.0, 2.0, 2.5],
                                                         np.float32)])


@pytest.mark.parametrize("name", LOGICAL)
def test_logical_ops_match_jax(name):
    check_pair(getattr(J, name), getattr(T, name), list(BOOLS))


def test_logical_not_matches_jax():
    check_pair(J.logical_not, T.logical_not, [BOOLS[0]])
    check_pair(J.logical_not, T.logical_not, [np.array([0.0, 2.0, -1.0],
                                                       np.float32)])


def test_while_loop_matches_jax():
    def body_j(v):
        i, x = v
        return i + 1, x * 1.5 + jnp.sin(x)

    def body_t(v):
        i, x = v
        return i + 1, x * 1.5 + torch.sin(x)

    x = f32(3)
    want = J.while_loop(lambda v: v[0] < 5, body_j, (jnp.int32(0),
                                                     jnp.asarray(x)))
    got = T.while_loop(lambda v: v[0] < 5, body_t,
                       (torch.tensor(0), torch.from_numpy(x)))
    compare(got, want, 1e-6, 1e-6)
    assert int(got[0]) == 5


@pytest.mark.parametrize("pred", [True, False])
def test_cond_matches_jax(pred):
    x = f32(2, 2)
    want = J.cond(jnp.asarray(pred), lambda a, b: a @ b, lambda a, b: a - b,
                  jnp.asarray(x), jnp.asarray(x.T))
    got = T.cond(torch.tensor(pred), lambda a, b: a @ b, lambda a, b: a - b,
                 torch.from_numpy(x), torch.from_numpy(x.T.copy()))
    compare(got, want, 1e-6, 1e-6)


@pytest.mark.parametrize("preds", [(False, True, True), (False, False,
                                                        False)])
def test_case_matches_jax(preds):
    def run(M, conv):
        pairs = [(conv(p), (lambda k=k: conv(float(k)) * 2))
                 for k, p in enumerate(preds)]
        return M.case(pairs, default=lambda: conv(-1.0))

    compare(run(T, torch.tensor), run(J, jnp.asarray), 0, 0)
    with pytest.raises(ValueError):
        T.case([(torch.tensor(False), lambda: torch.tensor(1.0))])


@pytest.mark.parametrize("index", [0, 2, 5, -3])
def test_switch_case_clamps_as_jax(index):
    fns_j = [lambda x: x + 1, lambda x: x * 2, lambda x: -x]
    fns_t = [lambda x: x + 1, lambda x: x * 2, lambda x: -x]
    x = f32(3)
    compare(T.switch_case(torch.tensor(index), fns_t, torch.from_numpy(x)),
            J.switch_case(jnp.asarray(index), fns_j, jnp.asarray(x)), 0, 0)


def _scan_step(M):
    tanh = jnp.tanh if M is J else torch.tanh

    def step(carry, x):
        h, n = carry
        h = tanh(h * 0.5 + x["a"] * x["b"])
        return (h, n + 1), {"h": h, "sum": h.sum()}
    return step


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_matches_jax(reverse):
    xs = {"a": f32(5, 3), "b": f32(5, 3)}
    h0 = f32(3)

    def jf(h, a, b):
        return J.scan(_scan_step(J), (h, jnp.int32(0)), {"a": a, "b": b},
                      reverse=reverse)

    def tf(h, a, b):
        return T.scan(_scan_step(T), (h, torch.tensor(0)), {"a": a, "b": b},
                      reverse=reverse)

    check_pair(jf, tf, [h0, xs["a"], xs["b"]], grad=(0, 1, 2), gatol=1e-5)


def test_scan_with_length_and_no_xs_matches_jax():
    want = J.scan(lambda c, _: (c * 2, c), jnp.float32(1.5), None, length=4)
    got = T.scan(lambda c, _: (c * 2, c), torch.tensor(1.5), None, length=4)
    compare(got, want, 0, 0)


@pytest.mark.parametrize("time_major", [False, True])
def test_static_rnn_matches_jax(time_major):
    w = f32(3, 3)

    def step(M):
        tanh = jnp.tanh if M is J else torch.tanh

        def f(x_t, states):
            h = tanh(x_t["x"] @ states["w"] + states["h"])
            return (h, h * 2), {"h": h, "w": states["w"]}
        return f

    def jf(x, h, w):
        return J.static_rnn(step(J), {"x": x}, {"h": h, "w": w}, time_major)

    def tf(x, h, w):
        return T.static_rnn(step(T), {"x": x}, {"h": h, "w": w}, time_major)

    check_pair(jf, tf, [f32(2, 4, 3), f32(2, 3) if not time_major
                        else f32(4, 3), w], grad=(0, 1, 2), gatol=1e-5)


def test_fori_loop_matches_jax():
    x = f32(4)
    want = J.fori_loop(0, 5, lambda i, v: v * 0.9 + i, jnp.asarray(x))
    got = T.fori_loop(0, 5, lambda i, v: v * 0.9 + i, torch.from_numpy(x))
    compare(got, want, 1e-6, 1e-6)


def test_tensor_array_matches_jax():
    v1, v2, v3 = f32(2), f32(2), f32(2)
    ja = J.TensorArray(4, (2,))
    ta = T.TensorArray(4, (2,), device="cpu")
    ja2 = ja.write(1, jnp.asarray(v1)).write(jnp.int32(9), jnp.asarray(v2))
    ta2 = ta.write(1, torch.from_numpy(v1)).write(torch.tensor(9),
                                                  torch.from_numpy(v2))
    ja3 = ja2.write(-2, jnp.asarray(v3))
    ta3 = ta2.write(-2, torch.from_numpy(v3))
    compare(ta3.stack(), ja3.stack(), 0, 0)
    compare(ta2.stack(), ja2.stack(), 0, 0)
    assert float(ta.stack().abs().sum()) == 0.0
    for i in (0, 1, 3, torch.tensor(7), torch.tensor(-1)):
        ji = i if isinstance(i, int) else jnp.int32(int(i))
        compare(ta3.read(i), ja3.read(ji), 0, 0)


def test_every_public_name_has_a_test():
    import inspect

    names = {n for n, f in vars(J).items() if (inspect.isfunction(f)
             or inspect.isclass(f)) and not n.startswith("_")
             and f.__module__ == J.__name__}
    here = {n.split("test_", 1)[1] for n in globals() if n.startswith(
        "test_")}
    covered = set(BINARY) | set(LOGICAL) | {"TensorArray"}
    covered |= {n for n in names if any(h.startswith(n) for h in here)}
    assert names <= covered, sorted(names - covered)
