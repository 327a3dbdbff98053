"""DeepFM, BASELINE config 5 (``models/deepfm.py``), and the CTR metric
(``metrics.py`` ``auc_terms``, ``Auc``) of the port against the JAX
package's, on the CPU, at ``DeepFMConfig.tiny()`` with
``embedding_axis=None``, the JAX weights carried across by name:

- logits and loss within 1e-5, every gradient within 1e-5 of its
  parameter's largest JAX-gradient entry;
- three dense Adam(1e-3) steps through each package's Trainer, and
  three sparse ones through ``sparse_minimize_fn`` (JAX jitted), the
  losses within 1e-5 and the parameters within 1e-5 (the sparse run's
  Adam moments too), on the bench's batch (ids uniform over the vocab,
  dense normal, labels ``ids[:, 0] % 2``);
- the same dense steps under ``mixed_bf16`` within 2e-2;
- ``auc_terms`` exactly and ``Auc.eval`` within 1e-12;
- ``embedding_axis="ep"`` raises naming queue 1 item 11.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import metrics as JMT
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JP
from paddle_tpu.core import dtypes as JDT
from paddle_tpu.models import deepfm as JD
from paddle_tpu.optimizer.sparse import sparse_minimize_fn as j_sparse
from paddle_tpu_torch import metrics as TMT
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.core import UnimplementedError
from paddle_tpu_torch.core import dtypes as TDT
from paddle_tpu_torch.models import deepfm as TD
from paddle_tpu_torch.optimizer.sparse import sparse_minimize_fn as t_sparse
from paddle_tpu_torch.parallel import Trainer
from paddle_tpu_torch.utils.convert import load_numpy_state

B = 64
TOL = {"float32": 1e-5, "mixed_bf16": 2e-2}


@pytest.fixture(autouse=True)
def fresh_state():
    pt.seed(0)
    ptt.seed(0)
    TDT.set_policy("float32")
    JDT.set_policy("float32")
    yield
    TDT.set_policy("float32")
    JDT.set_policy("float32")


def _cfg(M, sparse=False):
    cfg = M.DeepFMConfig.tiny()
    cfg.embedding_axis = None
    cfg.sparse_grads = sparse
    return cfg


def _pair(sparse=False):
    jm = JD.DeepFM(_cfg(JD, sparse))
    tm = TD.DeepFM(_cfg(TD, sparse), device="cpu")
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    return jm, tm


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.total_vocab, (B, cfg.num_fields))
    dense = rng.normal(size=(B, cfg.dense_dim)).astype(np.float32)
    return ids, dense


def _labels_j(ids):
    return (ids[:, 0] % 2).astype(jnp.float32)


def _labels_t(ids):
    return (ids[:, 0] % 2).to(torch.float32)


def test_forward_loss_and_grads_match_jax():
    jm, tm = _pair()
    ids, dense = _batch(jm.cfg)

    def jloss(p):
        logits, _ = jm.functional_call(p, jnp.asarray(ids),
                                       jnp.asarray(dense))
        return JD.loss_fn(logits, _labels_j(jnp.asarray(ids))), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jm.named_parameters())
    tids = torch.from_numpy(ids)
    tlogits = tm(tids, torch.from_numpy(dense))
    tl = TD.loss_fn(tlogits, _labels_t(tids))
    tl.backward()
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-5)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-5)
    for k, p in tm.named_parameters():
        want = np.asarray(jg[k])
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-5 * scale,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("policy", ["float32", "mixed_bf16"])
def test_three_dense_adam_steps_match_the_jax_trainer(policy):
    jm, tm = _pair()
    ids, dense = _batch(jm.cfg, seed=1)

    def jbuild(params, buffers, rng, batch):
        logits, nb = jm.functional_call(params, *batch, buffers=buffers,
                                        rng=rng)
        return JD.loss_fn(logits, _labels_j(batch[0])), ({}, nb)

    def tbuild(model, batch, gen):
        return TD.loss_fn(model(*batch), _labels_t(batch[0])), {}

    jt = JP.Trainer(jm, JO.Adam(1e-3), jbuild, amp=policy)
    tt = Trainer(tm, TO.Adam(1e-3), tbuild, amp=policy)
    np.testing.assert_array_equal(tt._key,
                                  np.asarray(jax.random.key_data(jt._rng)))
    jb = (jnp.asarray(ids), jnp.asarray(dense))
    tb = (torch.from_numpy(ids), torch.from_numpy(dense))
    tol = TOL[policy]
    losses = []
    for _ in range(3):
        jl, _ = jt.train_step(jb)
        tl, _ = tt.train_step(tb)
        np.testing.assert_allclose(float(tl), float(jl), atol=tol)
        losses.append(float(tl))
    assert losses[-1] < losses[0]
    for k, p in tt.params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jt.params[k]), atol=tol,
                                   err_msg=k)


def test_three_sparse_adam_steps_match_jax():
    jm, tm = _pair(sparse=True)
    ids, dense = _batch(jm.cfg, seed=2)

    def jfl(p, i, d):
        logits, _ = jm.functional_call(p, i, d)
        return JD.loss_fn(logits, _labels_j(i))

    def tfl(p, i, d):
        logits, _ = tm.functional_call(p, i, d)
        return TD.loss_fn(logits, _labels_t(i))

    jinit, jstep = j_sparse(jm, jfl, JO.Adam(1e-3))
    jstep = jax.jit(jstep)
    tinit, tstep = t_sparse(tm, tfl, TO.Adam(1e-3))
    jp = jm.named_parameters()
    jst = jinit(jp)
    tp = {k: v.detach().clone() for k, v in tm.named_parameters()}
    tst = tinit(tp)
    assert sorted(tst["sparse"]) == ["embedding.weight",
                                     "linear_embed.weight"]
    jb = (jnp.asarray(ids), jnp.asarray(dense))
    tb = (torch.from_numpy(ids), torch.from_numpy(dense))
    for _ in range(3):
        jl, jp, jst = jstep(jp, jst, *jb)
        tl, tp, tst = tstep(tp, tst, *tb)
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-5)
    for k, v in tp.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jp[k]), atol=1e-5,
                                   err_msg=k)
    for name, leaves in tst["sparse"].items():
        for k, v in leaves.items():
            np.testing.assert_allclose(
                v.numpy(), np.asarray(jst["sparse"][name][k]), atol=1e-5,
                err_msg=f"{name} {k}")


@pytest.mark.parametrize("two_col", [False, True])
def test_auc_terms_and_auc_match_jax(two_col):
    rng = np.random.default_rng(3)
    p = rng.uniform(size=(257,)).astype(np.float32)
    p[:4] = [0.0, 1.0, 0.999, 0.5]                    # bucket edges
    label = (rng.uniform(size=(257,)) < p).astype(np.int64)
    probs = np.stack([1 - p, p], 1) if two_col else p
    for nt in (200, 7):
        jt, jf = JMT.auc_terms(jnp.asarray(probs), jnp.asarray(label), nt)
        tt, tf = TMT.auc_terms(torch.from_numpy(probs),
                               torch.from_numpy(label), nt)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    ja, ta = JMT.Auc(), TMT.Auc()
    for half in (slice(0, 128), slice(128, None)):
        ja.update(probs[half], label[half])
        ta.update(torch.from_numpy(probs[half]), torch.from_numpy(label[half]))
    assert 0.5 < ta.eval() < 1.0
    np.testing.assert_allclose(ta.eval(), ja.eval(), atol=1e-12)
    ta.reset()
    assert ta.eval() == 0.0
    ta.update(torch.full((4,), 0.99), torch.tensor([1, 0, 1, 0]))
    ja = JMT.Auc()
    ja.update(np.full((4,), 0.99, np.float32), np.asarray([1, 0, 1, 0]))
    assert ta.eval() == ja.eval() == 0.5          # the (0, 0) anchor
    with pytest.raises(NotImplementedError):
        TMT.MetricBase().eval()


def test_sharded_tables_raise_naming_their_item():
    with pytest.raises(UnimplementedError, match="queue 1 item 11"):
        TD.DeepFM(TD.DeepFMConfig.tiny(), device="cpu")
    assert TD.DeepFMConfig.criteo().total_vocab == 1_000_000
    assert TD.DeepFMConfig().embedding_axis == "ep"
