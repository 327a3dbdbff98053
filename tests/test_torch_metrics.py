"""``metrics.py`` of the port (all but the detection metrics) against the
JAX package's, on the CPU: the metric ops on the same numpy-seeded
inputs (float results within 1e-6, counts equal; the JAX side jitted),
and the host accumulators fed the same batches (results equal to 1e-12).
``mean_iou`` and ``precision_recall`` include a class that never occurs
and a label out of range (a zero one-hot row in both);
``positive_negative_pair`` has tied scores and several queries;
``chunk_eval`` takes whole rows by default; ``EditDistance`` takes
tensors and lists."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import metrics as J
from paddle_tpu_torch import metrics as T
from torch_parity import check_pair

RNG = np.random.default_rng(6)
P = functools.partial

OPS = {
    "mean_iou": (P(J.mean_iou, num_classes=5), P(T.mean_iou, num_classes=5),
                 [RNG.integers(0, 4, (3, 7)).astype(np.int32),
                  np.where(RNG.random((3, 7)) < 0.1, 6,
                           RNG.integers(0, 4, (3, 7))).astype(np.int32)]),
    "precision_recall": (P(J.precision_recall, num_classes=5),
                         P(T.precision_recall, num_classes=5),
                         [RNG.random((20, 5)).astype(np.float32),
                          np.where(RNG.random(20) < 0.1, 7,
                                   RNG.integers(0, 4, 20)).astype(np.int32)]),
    "positive_negative_pair": (
        J.positive_negative_pair, T.positive_negative_pair,
        [np.round(RNG.random(16), 1).astype(np.float32),
         RNG.integers(0, 3, 16).astype(np.int32),
         RNG.integers(0, 3, 16).astype(np.int32)]),
    "chunk_eval": (P(J.chunk_eval, chunk_scheme="IOBES", num_chunk_types=2),
                   P(T.chunk_eval, chunk_scheme="IOBES", num_chunk_types=2),
                   [RNG.integers(0, 9, (3, 8)).astype(np.int32),
                    RNG.integers(0, 9, (3, 8)).astype(np.int32)]),
    "chunk_eval_lengths": (
        P(J.chunk_eval, num_chunk_types=2, excluded_chunk_types=[1],
          seq_lens=jnp.asarray([8, 3, 0])),
        P(T.chunk_eval, num_chunk_types=2, excluded_chunk_types=[1],
          seq_lens=torch.tensor([8, 3, 0])),
        [RNG.integers(0, 5, (3, 8)).astype(np.int32),
         RNG.integers(0, 5, (3, 8)).astype(np.int32)]),
    "accuracy": (J.accuracy, T.accuracy,
                 [RNG.random((10, 4)).astype(np.float32),
                  RNG.integers(0, 4, (10, 1)).astype(np.int32)]),
    "accuracy_top2": (P(J.accuracy, k=2), P(T.accuracy, k=2),
                      [RNG.random((10, 4)).astype(np.float32),
                       RNG.integers(0, 4, (10,)).astype(np.int32)]),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_metric_op_matches_jax(name):
    jfn, tfn, args = OPS[name]
    check_pair(jfn, tfn, args)


def _batches(n=3):
    return [(RNG.random(12).astype(np.float32),
             RNG.integers(0, 2, 12).astype(np.int64)) for _ in range(n)]


@pytest.mark.parametrize("name", ["Precision", "Recall"])
def test_binary_accumulators_match_jax(name):
    j, t = getattr(J, name)(), getattr(T, name)()
    for preds, labels in _batches():
        j.update(preds, labels)
        t.update(torch.from_numpy(preds), torch.from_numpy(labels))
    assert t.eval() == pytest.approx(j.eval(), abs=1e-12)
    t.reset()
    assert t.eval() == 0.0


def test_accuracy_accumulator_matches_jax():
    j, t = J.Accuracy("acc"), T.Accuracy("acc")
    assert t.eval() == 0.0
    for v, w in ((0.5, 10), (0.75, 30), (torch.tensor(1.0), 2)):
        j.update(float(v), w)
        t.update(v, w)
    assert t.eval() == pytest.approx(j.eval(), abs=1e-12)


@pytest.mark.parametrize("normalized", [True, False])
def test_edit_distance_matches_jax(normalized):
    hyps = [[1, 2, 3], [4, 5], [], [7, 7, 7, 8]]
    refs = [[1, 3], [4, 5], [1], [7, 8]]
    j, t = J.EditDistance(normalized), T.EditDistance(normalized)
    j.update(hyps, refs)
    t.update([torch.tensor(h, dtype=torch.long) for h in hyps], refs)
    assert t.eval() == pytest.approx(j.eval(), abs=1e-12)
    for a, b in zip(hyps, refs):
        assert (T.EditDistance._levenshtein(a, b)
                == J.EditDistance._levenshtein(a, b))


def test_composite_metric_matches_jax():
    j = J.CompositeMetric(J.Precision())
    j.add_metric(J.Recall())
    t = T.CompositeMetric(T.Precision())
    t.add_metric(T.Recall())
    for preds, labels in _batches():
        j.update(preds, labels)
        t.update(preds, labels)
    assert t.eval() == pytest.approx(j.eval(), abs=1e-12)


def test_chunk_evaluator_matches_jax():
    j, t = J.ChunkEvaluator(), T.ChunkEvaluator()
    for _ in range(3):
        infer = RNG.integers(0, 5, (2, 6)).astype(np.int32)
        label = RNG.integers(0, 5, (2, 6)).astype(np.int32)
        counts = J.chunk_eval(infer, label, num_chunk_types=2)[3:]
        j.update(*counts)
        t.update(*T.chunk_eval(torch.from_numpy(infer),
                               torch.from_numpy(label),
                               num_chunk_types=2)[3:])
    assert t.eval() == pytest.approx(j.eval(), abs=1e-12)
    assert t.num_infer_chunks == j.num_infer_chunks
