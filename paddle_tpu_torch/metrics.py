"""Metrics (counterpart of paddle_tpu/metrics.py; reference:
python/paddle/fluid/metrics.py and operators/metrics/): the metric ops
on tensors (``accuracy``, ``auc_terms``, ``chunk_eval``, ``mean_iou``,
``precision_recall``, ``positive_negative_pair``), which run on their
inputs' device and read nothing back, and the host-side accumulators on
``MetricBase`` (Accuracy, Auc, Precision, Recall, EditDistance,
CompositeMetric, ChunkEvaluator, DetectionMAP), which take host values
and tensors alike. ``detection_map`` (11-point interpolated mAP) is
host-side, as in the JAX package: an eval-time metric over ragged
detections, its IoUs from ops/detection.py :func:`iou_similarity` on the
CPU."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops.nn import one_hot


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


def _host(x) -> np.ndarray:
    """A host copy of a tensor (or anything numpy takes)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Accuracy(MetricBase):
    """reference: metrics.py Accuracy — a weighted running average."""

    def __init__(self, name: Optional[str] = None):
        self.name = name
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1.0):
        self.value += float(value) * float(weight)
        self.weight += float(weight)

    def eval(self):
        if self.weight == 0:
            return 0.0
        return self.value / self.weight


class Precision(MetricBase):
    """reference: metrics.py Precision (binary; predictions rounded)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(_host(preds)).astype(np.int64).reshape(-1)
        labels = _host(labels).astype(np.int64).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def eval(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(MetricBase):
    """reference: metrics.py Recall (binary; predictions rounded)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(_host(preds)).astype(np.int64).reshape(-1)
        labels = _host(labels).astype(np.int64).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def eval(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class EditDistance(MetricBase):
    """reference: metrics.py EditDistance — the mean Levenshtein distance
    of hypotheses to references (divided by the reference's length when
    ``normalized``) and the share of sequences not exactly right."""

    def __init__(self, normalized: bool = True):
        self.normalized = normalized
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0
        self.seq_right = 0

    @staticmethod
    def _levenshtein(a, b) -> int:
        m, n = len(a), len(b)
        dp = list(range(n + 1))
        for i in range(1, m + 1):
            prev = dp[0]
            dp[0] = i
            for j in range(1, n + 1):
                cur = dp[j]
                dp[j] = min(dp[j] + 1, dp[j - 1] + 1,
                            prev + (a[i - 1] != b[j - 1]))
                prev = cur
        return dp[n]

    def update(self, hyps, refs):
        for h, r in zip(hyps, refs):
            h = _host(h).tolist() if torch.is_tensor(h) else list(h)
            r = _host(r).tolist() if torch.is_tensor(r) else list(r)
            d = self._levenshtein(h, r)
            if self.normalized:
                d = d / max(len(r), 1)
            self.total += d
            self.count += 1
            if d == 0:
                self.seq_right += 1

    def eval(self):
        avg = self.total / self.count if self.count else 0.0
        instance_err = 1.0 - (self.seq_right / self.count
                              if self.count else 0.0)
        return avg, instance_err


class CompositeMetric(MetricBase):
    """reference: metrics.py CompositeMetric — updates every metric with
    the same arguments; eval() is the list of their evals."""

    def __init__(self, *metrics: MetricBase):
        self.metrics = list(metrics)

    def add_metric(self, m: MetricBase):
        self.metrics.append(m)

    def reset(self):
        for m in self.metrics:
            m.reset()

    def update(self, *args, **kwargs):
        for m in self.metrics:
            m.update(*args, **kwargs)

    def eval(self):
        return [m.eval() for m in self.metrics]


def chunk_eval(input, label, chunk_scheme: str = "IOB",  # noqa: A002
               num_chunk_types: int = 1, excluded_chunk_types=None,
               seq_lens=None):
    """Chunking precision, recall and F1 with the fluid argument order
    (reference: layers/nn.py chunk_eval) over
    :func:`paddle_tpu_torch.ops.sequence.chunk_eval`; ``seq_lens``
    defaults to whole rows."""
    from .ops.sequence import chunk_eval as _ce

    input = torch.as_tensor(input)  # noqa: A001
    if seq_lens is None:
        t = input.shape[-1] if input.ndim > 1 else input.shape[0]
        b = input.shape[0] if input.ndim > 1 else 1
        seq_lens = torch.full((b,), t, dtype=torch.int32,
                              device=input.device)
    return _ce(input, label, seq_lens, num_chunk_types, chunk_scheme,
               tuple(excluded_chunk_types or ()))


class ChunkEvaluator(MetricBase):
    """reference: metrics.py:361 ChunkEvaluator — chunk_eval's counts
    summed over mini-batches; eval() is (precision, recall, f1)."""

    def __init__(self, name=None):
        self.name = name
        self.reset()

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self.num_infer_chunks += int(num_infer_chunks)
        self.num_label_chunks += int(num_label_chunks)
        self.num_correct_chunks += int(num_correct_chunks)

    def eval(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


def mean_iou(pred, label, num_classes: int):
    """reference: operators/mean_iou_op.cc — (the mean IoU over the
    classes present in pred or label, per-class intersection, per-class
    union)."""
    p = one_hot(pred.reshape(-1), num_classes)
    l = one_hot(label.reshape(-1), num_classes)
    inter = torch.sum(p * l, dim=0)
    union = torch.sum(p, dim=0) + torch.sum(l, dim=0) - inter
    present = union > 0
    iou = torch.where(present, inter / torch.clamp_min(union, 1.0),
                      torch.zeros_like(inter))
    miou = torch.sum(iou) / torch.clamp_min(torch.sum(present), 1)
    return miou, inter, union


def precision_recall(pred_probs, label, num_classes: int):
    """reference: operators/metrics/precision_recall_op.cc — per-class
    and macro/micro precision, recall and F1 of the argmax predictions:
    a dict of 0-dim tensors, plus the per-class tp, fp and fn."""
    p = one_hot(torch.argmax(pred_probs, dim=-1), num_classes)
    l = one_hot(label.reshape(-1), num_classes)
    tp = torch.sum(p * l, dim=0)
    fp = torch.sum(p * (1 - l), dim=0)
    fn = torch.sum((1 - p) * l, dim=0)
    prec = tp / torch.clamp_min(tp + fp, 1.0)
    rec = tp / torch.clamp_min(tp + fn, 1.0)
    f1 = 2 * prec * rec / torch.clamp_min(prec + rec, 1e-9)
    micro_p = torch.sum(tp) / torch.clamp_min(torch.sum(tp + fp), 1.0)
    micro_r = torch.sum(tp) / torch.clamp_min(torch.sum(tp + fn), 1.0)
    return {
        "macro_precision": torch.mean(prec), "macro_recall": torch.mean(rec),
        "macro_f1": torch.mean(f1), "micro_precision": micro_p,
        "micro_recall": micro_r,
        "micro_f1": 2 * micro_p * micro_r / torch.clamp_min(
            micro_p + micro_r, 1e-9),
        "tp": tp, "fp": fp, "fn": fn,
    }


def positive_negative_pair(score, label, query_id):
    """reference: operators/metrics/positive_negative_pair_op.cc — over
    the pairs of one query with different labels: (pairs ordered as
    their labels, pairs ordered against them, pairs with equal
    scores)."""
    s = score.reshape(-1)
    l = label.reshape(-1).to(torch.float32)
    q = query_id.reshape(-1)
    n = s.numel()
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=s.device), diagonal=1)
    valid = (q[:, None] == q[None, :]) & upper & (l[:, None] != l[None, :])
    sdiff = s[:, None] - s[None, :]
    prod = sdiff * (l[:, None] - l[None, :])
    return (torch.sum(valid & (prod > 0)), torch.sum(valid & (prod < 0)),
            torch.sum(valid & (sdiff == 0)))


def detection_map(det_boxes, det_scores, det_labels, gt_boxes, gt_labels,
                  *, num_classes: int, overlap_threshold: float = 0.5):
    """reference: operators/detection_map_op.cc: the mean over classes
    of the 11-point interpolated average precision, one batch of
    detections (D, 4) + (D,) + (D,) against ground truth (G, 4) + (G,);
    padded entries have label < 0. Detections of a class in descending
    score order (a stable sort), each matching its highest-IoU gt of
    that class once. Tensors or arrays; the result a float."""
    from .ops.detection import iou_similarity

    det_boxes = _host(det_boxes)
    det_scores = _host(det_scores)
    det_labels = _host(det_labels)
    gt_boxes = _host(gt_boxes)
    gt_labels = _host(gt_labels)
    aps = []
    for c in range(num_classes):
        d_idx = np.where(det_labels == c)[0]
        g_idx = np.where(gt_labels == c)[0]
        if len(g_idx) == 0:
            continue
        order = d_idx[np.argsort(-det_scores[d_idx], kind="stable")]
        gts = torch.from_numpy(np.ascontiguousarray(gt_boxes[g_idx]))
        matched = set()
        tp = np.zeros(len(order))
        fp = np.zeros(len(order))
        for i, di in enumerate(order):
            ious = iou_similarity(torch.from_numpy(np.ascontiguousarray(
                det_boxes[di:di + 1])).to(gts.dtype), gts).numpy()[0]
            j = int(np.argmax(ious))
            if ious[j] >= overlap_threshold and j not in matched:
                tp[i] = 1
                matched.add(j)
            else:
                fp[i] = 1
        ctp = np.cumsum(tp)
        cfp = np.cumsum(fp)
        rec = ctp / len(g_idx)
        prec = ctp / np.maximum(ctp + cfp, 1e-9)
        ap = 0.0
        for t in np.linspace(0, 1, 11):
            p = prec[rec >= t].max() if np.any(rec >= t) else 0.0
            ap += p / 11
        aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0


class DetectionMAP(MetricBase):
    """reference: python/paddle/fluid/metrics.py DetectionMAP: the mean
    of :func:`detection_map` over the batches given to ``update``."""

    def __init__(self, num_classes: int, overlap_threshold: float = 0.5,
                 name=None):
        self.name = name
        self.num_classes = num_classes
        self.overlap_threshold = overlap_threshold
        self.reset()

    def reset(self):
        self._maps = []

    def update(self, det_boxes, det_scores, det_labels, gt_boxes, gt_labels):
        self._maps.append(detection_map(
            det_boxes, det_scores, det_labels, gt_boxes, gt_labels,
            num_classes=self.num_classes,
            overlap_threshold=self.overlap_threshold))

    def eval(self):
        return float(np.mean(self._maps)) if self._maps else 0.0
