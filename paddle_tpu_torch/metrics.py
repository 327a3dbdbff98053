"""Metrics (counterpart of paddle_tpu/metrics.py): the in-graph top-k
accuracy and the CTR metric, ``auc_terms`` with its host-side
accumulator ``Auc`` on ``MetricBase``. The other host-side accumulators
(Accuracy, Precision, ...) come with the compat surfaces, ROADMAP queue
1 item 12."""

from __future__ import annotations

import numpy as np
import torch


def accuracy(pred_logits, label, k: int = 1):
    """Top-k accuracy of ``pred_logits`` (N, C) against ``label`` (N,) or
    (N, 1), as a float32 scalar; ties resolve as in the JAX package (the
    first maximum for k == 1, a stable sort for k > 1)."""
    label = label.reshape(-1)
    if k == 1:
        correct = torch.argmax(pred_logits, dim=-1) == label
    else:
        topk = torch.argsort(pred_logits, dim=-1, stable=True)[..., -k:]
        correct = torch.any(topk == label[:, None], dim=-1)
    return torch.mean(correct.to(torch.float32))


def auc_terms(probs, label, num_thresholds: int = 200):
    """Histogram terms for streaming AUC (reference: operators/metrics/
    auc_op.cc): the (tp, fp) counts of the positive-class probabilities
    in ``num_thresholds + 1`` buckets, float32, on the input's device, to
    be accumulated on the host."""
    pos_prob = probs[:, 1] if probs.ndim == 2 else probs
    label = label.reshape(-1).to(torch.float32)
    idx = torch.clamp((pos_prob * num_thresholds).to(torch.int32), 0,
                      num_thresholds).long()
    zeros = torch.zeros(num_thresholds + 1, dtype=torch.float32,
                        device=pos_prob.device)
    tp = zeros.clone().index_add_(0, idx, label)
    fp = zeros.index_add_(0, idx, 1.0 - label)
    return tp, fp


# --- host-side accumulators ------------------------------------------------

class MetricBase:
    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Auc(MetricBase):
    """reference: metrics.py Auc — trapezoidal over the threshold
    histogram, with the (0, 0) ROC anchor."""

    def __init__(self, num_thresholds: int = 200):
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self.tp = np.zeros(self.num_thresholds + 1)
        self.fp = np.zeros(self.num_thresholds + 1)

    def update(self, probs, label):
        tp, fp = auc_terms(torch.as_tensor(probs), torch.as_tensor(label),
                           self.num_thresholds)
        self.tp += tp.cpu().numpy()
        self.fp += fp.cpu().numpy()

    def eval(self):
        # cumulative from the top threshold down → ROC points
        tp_cum = np.cumsum(self.tp[::-1])
        fp_cum = np.cumsum(self.fp[::-1])
        total_pos = tp_cum[-1]
        total_neg = fp_cum[-1]
        if total_pos == 0 or total_neg == 0:
            return 0.0
        # prepend the (0,0) ROC anchor so mass in the top bucket still
        # integrates over the full curve (degenerate case → 0.5, not 0)
        tpr = np.concatenate([[0.0], tp_cum / total_pos])
        fpr = np.concatenate([[0.0], fp_cum / total_neg])
        # the trapezoid rule as numpy's trapezoid computes it
        return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())
