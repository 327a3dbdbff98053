"""The recommender book model (``models/recommender.py``) of the port
against the JAX package's, on the CPU, the JAX weights carried across by
name (``load_numpy_state``):

- at small widths (50 users, 40 movies, embed 8, fc 16) on a synthetic
  MovieLens-shaped batch from numpy (ratings uniform in [1, 5], 3
  category ids a row, 0 the pad, summed as a real category): the
  predictions within 1e-6, the loss within 1e-5 and every gradient
  within 1e-5 of its parameter's largest JAX-gradient entry;
- three Adam(5e-3) steps through each package's Trainer: the start
  keys equal, the losses and the parameters within 1e-5;
- at the default MovieLens-1M widths the parameter names and shapes are
  the JAX model's, and a forward on the CPU gives |pred| <= 5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JP
from paddle_tpu.models import recommender as JR
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.models import recommender as TR
from paddle_tpu_torch.parallel import Trainer
from paddle_tpu_torch.utils.convert import load_numpy_state

SMALL = dict(num_users=50, num_items=40, embed_dim=8, fc_dim=16)
B = 16


@pytest.fixture(autouse=True)
def fresh_streams():
    pt.seed(0)
    ptt.seed(0)
    yield
    pt.seed(0)
    ptt.seed(0)


def _pair(**kw):
    jm = JR.RecommenderNet(**kw)
    tm = TR.RecommenderNet(**kw, device="cpu")
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    return jm, tm


def batch(b=B, seed=0, users=50, items=40):
    rng = np.random.default_rng(seed)
    feats = (rng.integers(0, users, b), rng.integers(0, 2, b),
             rng.integers(0, 7, b), rng.integers(0, 21, b),
             rng.integers(0, items, b), rng.integers(0, 19, (b, 3)))
    feats = [f.astype(np.int32) for f in feats]
    feats[5][0, 1:] = 0                         # a padded category list
    rating = rng.uniform(1.0, 5.0, b).astype(np.float32)
    return feats, rating


def test_forward_loss_and_grads_match_jax():
    jm, tm = _pair(**SMALL)
    feats, rating = batch()

    def jloss(p):
        pred, _ = jm.functional_call(p, *map(jnp.asarray, feats))
        return JR.loss_fn(pred, jnp.asarray(rating)), pred

    (jl, jpred), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jm.named_parameters())
    tpred = tm(*map(torch.from_numpy, feats))
    tl = TR.loss_fn(tpred, torch.from_numpy(rating))
    tl.backward()
    np.testing.assert_allclose(tpred.detach().numpy(), np.asarray(jpred),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-5)
    for k, p in tm.named_parameters():
        want = np.asarray(jg[k])
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-5 * scale,
                                   rtol=0, err_msg=k)


def test_three_adam_steps_match_the_jax_trainer():
    jm, tm = _pair(**SMALL)
    feats, rating = batch(seed=1)

    def jbuild(params, buffers, rng, bt):
        pred, nb = jm.functional_call(params, *bt[0], buffers=buffers,
                                      rng=rng)
        return JR.loss_fn(pred, bt[1]), ({}, nb)

    def tbuild(model, bt, gen):
        return TR.loss_fn(model(*bt[0]), bt[1]), {}

    jt = JP.Trainer(jm, JO.Adam(5e-3), jbuild)
    tt = Trainer(tm, TO.Adam(5e-3), tbuild)
    np.testing.assert_array_equal(tt._key,
                                  np.asarray(jax.random.key_data(jt._rng)))
    jb = ([jnp.asarray(f) for f in feats], jnp.asarray(rating))
    tb = ([torch.from_numpy(f) for f in feats], torch.from_numpy(rating))
    losses = []
    for _ in range(3):
        jl, _ = jt.train_step(jb)
        tl, _ = tt.train_step(tb)
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-5)
        losses.append(float(tl))
    assert losses[-1] < losses[0]
    for k, p in tt.params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jt.params[k]), atol=1e-5,
                                   err_msg=k)


def test_default_widths_are_movielens_1m(monkeypatch):
    from paddle_tpu import initializer as JI

    def zeros(self, key, shape, dtype=jnp.float32):
        return jnp.zeros(shape, dtype)

    for cls in (JI.Constant, JI.XavierUniform, JI.XavierNormal):
        monkeypatch.setattr(cls, "__call__", zeros)
    jm = JR.RecommenderNet()
    tm = TR.RecommenderNet(device="cpu")
    assert {k: tuple(v.shape) for k, v in tm.named_parameters()} == {
        k: tuple(v.shape) for k, v in jm.named_parameters().items()}
    assert tm.user_emb.weight.shape == (6041, 32)
    assert tm.item_emb.weight.shape == (3953, 32)
    assert tm.user_fc.weight.shape == (80, 200)
    feats, _ = batch(64, seed=2, users=6041, items=3953)
    pred = tm(*map(torch.from_numpy, feats))
    assert pred.shape == (64, 1) and float(pred.abs().max()) <= 5.0
