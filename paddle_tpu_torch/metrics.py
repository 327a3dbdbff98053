"""Metrics (counterpart of paddle_tpu/metrics.py): the in-graph top-k
accuracy. The host-side accumulators (Accuracy, Auc, ...) come with the
compat surfaces, ROADMAP queue 1 item 12."""

from __future__ import annotations

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
