"""``ops/sampling.py``'s sampled losses and samplers, and the ``NCE`` and
``HSigmoid`` layers (``nn/sampling_layers.py``), of the port against the
JAX package's, on the CPU.

- ``nce_loss`` with ``custom_neg`` (the negatives given, so exact), both
  samplers, with and without bias: cost within 1e-6 and the grads of
  x, weight and bias within 1e-5;
- ``hsigmoid_loss`` over the default complete tree and over a custom
  tree (-1 padded paths): exact tree codes, cost within 1e-6, grads
  within 1e-5;
- the keyed draws (``sample_classes``, ``sample_logits``,
  ``sampling_id``) match in distribution only: 200000 ids each, the
  empirical class frequencies within 0.01 in total variation of the
  JAX draw's (the two samples' own spread is ~0.004 at the ~20 classes
  used); the same key gives the same port draw; the log-uniform sampler
  truncates toward zero, then clips; ``nce_loss`` without
  ``custom_neg``: each row's cost in both packages within 5 standard
  deviations of its exact expectation;
- the layers on the same weights (``load_numpy_state``), ``NCE`` with
  ``custom_neg`` and through ``functional_call(rng=)`` without it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import nn as jnn
from paddle_tpu.ops import sampling as J
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.ops import sampling as T
from paddle_tpu_torch.utils.convert import load_numpy_state
from torch_parity import check_pair

RNG = np.random.default_rng(3)
C, D, B = 20, 8, 6


def f32(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def _key(i):
    return np.asarray(jax.random.key_data(jax.random.key(i)))


LABEL = RNG.integers(0, C, (B,)).astype(np.int32)
NEG = RNG.integers(0, C, (B, 5)).astype(np.int32)


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform"])
@pytest.mark.parametrize("bias", [True, False])
def test_nce_loss_with_custom_negatives_matches_jax(sampler, bias):
    args = [f32(B, D), LABEL, f32(C, D), f32(C), NEG]
    if bias:
        def jf(x, l, w, b, n):
            return J.nce_loss(x, l, w, b, sampler=sampler, custom_neg=n)

        def tf(x, l, w, b, n):
            return T.nce_loss(x, l, w, b, sampler=sampler, custom_neg=n)
        grad = (0, 2, 3)
    else:
        def jf(x, l, w, b, n):
            return J.nce_loss(x, l, w, None, sampler=sampler, custom_neg=n)

        def tf(x, l, w, b, n):
            return T.nce_loss(x, l, w, None, sampler=sampler, custom_neg=n)
        grad = (0, 2)
    check_pair(jf, tf, args, grad=grad, gatol=1e-5)


@pytest.mark.parametrize("num_classes", [2, 7, 16, 20])
def test_default_tree_codes_match_jax(num_classes):
    jt, jc = J._default_tree_codes(num_classes)
    tt, tc = T._default_tree_codes(num_classes)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_hsigmoid_loss_default_tree_matches_jax():
    check_pair(lambda x, l, w, b: J.hsigmoid_loss(x, l, w, b,
                                                  num_classes=C),
               lambda x, l, w, b: T.hsigmoid_loss(x, l, w, b,
                                                  num_classes=C),
               [f32(B, D), LABEL, f32(C, D), f32(C)], grad=(0, 2, 3),
               gatol=1e-5)


CUSTOM_TABLE = np.array([[0, 1, -1], [0, 2, 3], [0, 2, -1], [4, -1, -1]],
                        np.int32)
CUSTOM_CODE = np.array([[1, 0, -1], [0, 1, 1], [0, 0, -1], [1, -1, -1]],
                       np.int32)


def test_hsigmoid_loss_custom_tree_matches_jax():
    label = np.array([0, 3, 1, 2, 3, 0], np.int32)
    check_pair(lambda x, l, w, b, pt_, pc: J.hsigmoid_loss(
                   x, l, w, b, path_table=pt_, path_code=pc),
               lambda x, l, w, b, pt_, pc: T.hsigmoid_loss(
                   x, l, w, b, path_table=pt_, path_code=pc),
               [f32(B, D), label, f32(5, D), f32(5), CUSTOM_TABLE,
                CUSTOM_CODE], grad=(0, 2, 3), gatol=1e-5)


N = 200_000


def _tv(a, b, n):
    fa = np.bincount(np.asarray(a).reshape(-1), minlength=n) / np.size(a)
    fb = np.bincount(np.asarray(b).reshape(-1), minlength=n) / np.size(b)
    return 0.5 * np.abs(fa - fb).sum()


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform"])
def test_sample_classes_match_jax_in_distribution(sampler):
    ids, p = T.sample_classes(_key(1), (N,), C, sampler, device="cpu")
    again, _ = T.sample_classes(_key(1), (N,), C, sampler, device="cpu")
    jids, jp = J.sample_classes(jax.random.key(1), (N,), C, sampler)
    assert torch.equal(ids, again) and ids.dtype == torch.int32
    assert int(ids.min()) >= 0 and int(ids.max()) < C
    assert _tv(ids.numpy(), jids, C) < 0.01
    # the proposal probability of each drawn id is the JAX formula's
    np.testing.assert_allclose(
        p.numpy(), np.asarray(J._prob_fn(sampler)(jnp.asarray(ids.numpy()),
                                                  C)), rtol=1e-6)


def test_log_uniform_truncates_toward_zero_then_clips():
    gen = torch.Generator()
    ids = T._log_uniform_sample(gen.manual_seed(0), (1000,), 3)
    assert int(ids.min()) >= 0 and int(ids.max()) <= 2
    # u -> exp(u log 4) - 1 in [0, 3): the int cast floors these
    # non-negative values, and every id of [0, 3) occurs
    assert set(ids.tolist()) == {0, 1, 2}


def test_nce_loss_keyed_draws_match_jax_in_distribution():
    """With S keyed negatives a row's cost is softplus(-pos) plus a sum of
    S draws: both packages' costs lie within 5 standard deviations of
    its exact expectation and spread, computed from the sampler's
    probabilities."""
    s = 2000
    x, w, b = f32(64, D), f32(C, D), f32(C)
    label = RNG.integers(0, C, (64,)).astype(np.int32)
    got = T.nce_loss(torch.from_numpy(x), torch.from_numpy(label),
                     torch.from_numpy(w), torch.from_numpy(b),
                     num_neg_samples=s, sampler="log_uniform",
                     key=_key(2)).numpy().astype(np.float64)
    want = np.asarray(J.nce_loss(x, label, w, b, num_neg_samples=s,
                                 sampler="log_uniform",
                                 key=jax.random.key(2)), np.float64)
    ids = np.arange(C)
    p = np.log((ids + 2.0) / (ids + 1.0)) / np.log(C + 1.0)
    logit = x.astype(np.float64) @ w.T.astype(np.float64) + b
    sp = np.logaddexp(0.0, logit - np.log(s * p))          # (64, C)
    pos = np.logaddexp(0.0, -np.take_along_axis(
        logit - np.log(s * p), label[:, None].astype(np.int64), 1)[:, 0])
    mean = pos + s * (sp * p).sum(1)
    std = np.sqrt(s * ((sp ** 2 * p).sum(1) - (sp * p).sum(1) ** 2))
    assert np.all(np.abs(got - mean) < 5 * std + 1e-4)
    assert np.all(np.abs(want - mean) < 5 * std + 1e-4)


def test_sample_logits_matches_jax_in_distribution():
    v, s = C, 4
    logits = f32(N // s, v)
    label = RNG.integers(0, v, (N // s,)).astype(np.int32)
    tl = torch.from_numpy(logits)
    picked, slabel, ids = T.sample_logits(tl, torch.from_numpy(label), s,
                                          _key(6))
    jpicked, jslabel, jids = J.sample_logits(logits, label, s,
                                             jax.random.key(6))
    assert picked.shape == jpicked.shape and torch.all(slabel == 0)
    assert torch.equal(ids[:, 0], torch.from_numpy(label))
    assert _tv(ids[:, 1:].numpy(), np.asarray(jids)[:, 1:], v) < 0.01
    # the port's values are the JAX formula on the port's own ids
    q = np.asarray(J._prob_fn("log_uniform")(jnp.asarray(ids.numpy()), v))
    want = np.take_along_axis(logits, ids.numpy(), 1) - np.log(q)
    hit = ids.numpy() == label[:, None]
    hit[:, 0] = False
    want = np.where(hit, np.float32(-1e20), want)
    np.testing.assert_allclose(picked.numpy(), want, rtol=1e-6, atol=1e-5)
    assert hit.any()


def test_sampling_id_matches_jax_in_distribution():
    p = np.array([0.1, 0.0, 0.5, 0.15, 0.25], np.float32) * 2.0  # unnormed
    probs = np.broadcast_to(p, (N, 5)).copy()
    got = T.sampling_id(torch.from_numpy(probs), _key(7))
    want = J.sampling_id(probs, jax.random.key(7))
    assert torch.equal(got, T.sampling_id(torch.from_numpy(probs), _key(7)))
    assert int((got == 1).sum()) == 0
    assert _tv(got.numpy(), want, 5) < 0.01


@pytest.fixture
def seeded():
    pt.seed(0)
    ptt.seed(0)
    yield
    pt.seed(0)
    ptt.seed(0)


def _state(jm):
    return {k: np.asarray(v) for k, v in jm.named_parameters().items()}


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform"])
def test_nce_layer_matches_jax(seeded, sampler):
    jm = jnn.NCE(D, C, num_neg_samples=5, sampler=sampler)
    tm = tnn.NCE(D, C, num_neg_samples=5, sampler=sampler, device="cpu")
    load_numpy_state(tm, _state(jm))
    x = f32(B, D)
    want = jm(jnp.asarray(x), jnp.asarray(LABEL), custom_neg=NEG)
    got = tm(torch.from_numpy(x), torch.from_numpy(LABEL),
             custom_neg=torch.from_numpy(NEG))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    # without custom_neg the layer draws from its rng("nce") key: the
    # same call key gives the same cost
    a, _ = tm.functional_call(dict(tm.named_parameters()),
                              torch.from_numpy(x), torch.from_numpy(LABEL),
                              rng=_key(9))
    b, _ = tm.functional_call(dict(tm.named_parameters()),
                              torch.from_numpy(x), torch.from_numpy(LABEL),
                              rng=_key(9))
    assert torch.equal(a, b) and torch.isfinite(a).all()


@pytest.mark.parametrize("custom", [False, True])
def test_hsigmoid_layer_matches_jax(seeded, custom):
    kw = (dict(path_table=CUSTOM_TABLE, path_code=CUSTOM_CODE) if custom
          else {})
    n = 4 if custom else C
    jm = jnn.HSigmoid(D, n, **kw)
    tm = tnn.HSigmoid(D, n, **kw, device="cpu")
    load_numpy_state(tm, _state(jm))
    x = f32(B, D)
    label = RNG.integers(0, n, (B,)).astype(np.int32)

    def jloss(p):
        out, _ = jm.functional_call(p, jnp.asarray(x), jnp.asarray(label))
        return jnp.sum(out), out

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(
        jm.named_parameters())
    got = tm(torch.from_numpy(x), torch.from_numpy(label))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[k]),
                                   atol=1e-5, err_msg=k)
