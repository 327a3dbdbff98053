"""The loss of the global batch under a mesh: data-parallel ranks that
count different numbers of valid tokens, against the JAX package, which
takes the loss of the global batch (GSPMD) and its gradient, float32.

The port runs in a world of 4 gloo ranks (tests/torch_world.py), each on
its rows of the seeded global batch (the batch split over dp, as the
JAX Trainer's ``data_sharding`` gives it); the JAX side runs the global
batch on the same mesh over 4 of the 8 CPU devices. Every case puts a
different number of ignored labels on each dp rank, so a mean of the
ranks' own means would differ from the global mean.

- ``Trainer.supervised`` (dp=4) on BERT tiny with ``bert.pretrain_loss``
  and a different count of masked tokens on each rank: two SGD steps
  against the JAX Trainer, the losses and every parameter after each
  step at 1e-5, as tests/test_torch_train.py holds the single-device
  SGD trajectory (GPT's ``DataParallel`` with ragged ignored labels is
  tests/test_torch_seq_parallel.py's).
- BERT tiny's ``forward_fused_loss`` and ``forward_packed_loss`` on dp=2
  x sp=2, whole on each rank and under ``seq_parallel`` ring and
  Ulysses: the loss at 1e-5 and the gradients' mean over the mesh (as
  ``Trainer(mesh=)`` takes it) within 1e-5 of each parameter's largest
  JAX entry (at least 0.1).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import torch_world as W
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JP
from paddle_tpu.core.mesh import mesh_scope
from paddle_tpu.models import bert as JB

BERT_CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                intermediate_size=128, max_position=128, dropout=0.0)
B, T = 4, 64
CHUNK = 96


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


@functools.lru_cache(maxsize=None)
def _jmesh(dp, sp):
    return pt.build_mesh(dp=dp, sp=sp, devices=jax.devices()[:dp * sp])


def _state(layer):
    return {k: np.asarray(v) for k, v in layer.named_parameters().items()}


def _mlm_labels(rng, ids, counts):
    """-100 but at ``counts[i]`` random positions of row i."""
    labels = np.full(ids.shape, -100, np.int32)
    for row, n in enumerate(counts):
        at = rng.choice(T, n, replace=False)
        labels[row, at] = ids[row, at]
    return labels


def _check_steps(res, want):
    for step, (j_loss, j_params) in enumerate(want):
        for rank in range(4):
            np.testing.assert_allclose(res[rank][step][0], j_loss,
                                       atol=1e-5, rtol=0)
        for name, p in j_params.items():
            np.testing.assert_allclose(res[0][step][1][name], p, atol=1e-5,
                                       rtol=0, err_msg=name)


def _jax_steps(jt, batch, steps=2):
    out = []
    for _ in range(steps):
        loss, _ = jt.train_step(batch)
        out.append((float(loss), {k: np.asarray(v)
                                  for k, v in jt.params.items()}))
    return out


def test_supervised_bert_pretrain_loss_matches_jax(world):
    pt.seed(13)
    jm = JB.BertForPretraining(JB.BertConfig(**BERT_CFG))
    state = _state(jm)
    rng = np.random.default_rng(14)
    ids = rng.integers(1, 512, (B, T)).astype(np.int32)
    label = {"mlm_labels": _mlm_labels(rng, ids, (2, 7, 13, 29)),
             "nsp_label": rng.integers(0, 2, (B,)).astype(np.int32)}
    with mesh_scope(_jmesh(4, 1)):
        jt = JP.Trainer.supervised(jm, JO.SGD(0.5), JB.pretrain_loss,
                                   mesh=_jmesh(4, 1))
        want = _jax_steps(jt, {"x": jnp.asarray(ids),
                               "label": {k: jnp.asarray(v)
                                         for k, v in label.items()}})
    res = world.run(W.job_supervised_bert, dict(dp=4, sp=1), BERT_CFG,
                    state, ids, label, 2, 0.5)
    _check_steps(res, want)


def _fused_args(rng, ids):
    mask = np.ones((B, T), bool)
    mask[1, 40:] = False
    mask[3, 50:] = False
    return (ids, _mlm_labels(rng, ids, (3, 5, 11, 24)),
            rng.integers(0, 2, (B,)).astype(np.int32),
            rng.integers(0, 2, (B, T)).astype(np.int32), mask)


def _packed_args(rng, ids):
    segs = np.zeros((B, T), np.int32)
    positions = np.zeros((B, T), np.int32)
    for row, edges in enumerate(((0, 20, 64), (0, 40, 56), (0, 30, 60),
                                 (0, 10, 33))):
        for s, (lo, hi) in enumerate(zip(edges, edges[1:])):
            segs[row, lo:hi] = s + 1
            positions[row, lo:hi] = np.arange(hi - lo)
    return ids, positions, segs, _mlm_labels(rng, ids, (4, 9, 2, 17))


@pytest.mark.parametrize("method,impl", [
    ("forward_fused_loss", None),
    ("forward_fused_loss", "ring"),
    ("forward_packed_loss", "ulysses"),
], ids=["fused-whole", "fused-ring", "packed-ulysses"])
def test_bert_mlm_loss_under_mesh_matches_jax(world, method, impl):
    pt.seed(15)
    jm = JB.BertForPretraining(JB.BertConfig(**BERT_CFG, seq_parallel=impl))
    rng = np.random.default_rng(16)
    ids = rng.integers(1, 512, (B, T)).astype(np.int32)
    args = (_fused_args if method == "forward_fused_loss"
            else _packed_args)(rng, ids)

    def jloss(p):
        out, _ = jm.functional_call(p, *(jnp.asarray(a) for a in args),
                                    vocab_chunk=CHUNK, training=True,
                                    method=method)
        return out

    with mesh_scope(_jmesh(2, 2)):
        j_loss, j_grads = jax.jit(jax.value_and_grad(jloss))(
            jm.named_parameters())
    res = world.run(W.job_bert_loss, method, impl, dict(dp=2, sp=2),
                    BERT_CFG, _state(jm), args, CHUNK)
    for loss, _ in res:
        np.testing.assert_allclose(loss, float(j_loss), atol=1e-5, rtol=0)
    for name, w in j_grads.items():
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 0.1)
        np.testing.assert_allclose(res[0][1][name] / scale, w / scale,
                                   atol=1e-5, rtol=0, err_msg=name)
