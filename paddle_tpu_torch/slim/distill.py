"""Distillation losses and their composition (counterpart of
paddle_tpu/slim/distill.py; reference:
python/paddle/fluid/contrib/slim/distillation/ — soft-label loss, fsp
loss, l2 feature loss between teacher and student var pairs). The
teacher is a second params dict and an apply function."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.loss import softmax_with_cross_entropy
from ..ops.nn_extra import fsp_matrix


def soft_label_loss(student_logits, teacher_logits,
                    temperature: float = 1.0):
    """KL-style soft-label distillation loss (reference:
    distillation_strategy soft_label_loss): the mean over every position
    of CE(student/T, softmax(teacher/T)), scaled by T^2 so gradients keep
    their magnitude. No position is ignored."""
    t = temperature
    teacher_probs = torch.softmax(teacher_logits / t, dim=-1)
    ce = softmax_with_cross_entropy(student_logits / t, teacher_probs,
                                    soft_label=True)
    return torch.mean(ce) * (t * t)


def fsp_loss(student_pair: Tuple, teacher_pair: Tuple):
    """FSP distillation loss (reference: fsp_op.cc + distillation usage):
    L2 between the student's and teacher's flow matrices."""
    s = fsp_matrix(*student_pair)
    te = fsp_matrix(*teacher_pair)
    return torch.mean((s - te) ** 2)


def l2_feature_loss(student_feat, teacher_feat):
    """reference: distillation l2-loss between matched feature maps."""
    return torch.mean((student_feat - teacher_feat) ** 2)


class Distiller:
    """Compose distillation terms with the task loss (the
    DistillationStrategy role, config-driven weighting). The hard term
    is the mean of the label CE over EVERY position: a label at the
    ignore index counts as a zero in that mean."""

    def __init__(self, temperature: float = 4.0, soft_weight: float = 0.7,
                 hard_weight: float = 0.3, feature_weight: float = 0.0):
        self.temperature = temperature
        self.soft_weight = soft_weight
        self.hard_weight = hard_weight
        self.feature_weight = feature_weight

    def loss(self, student_logits, teacher_logits, label=None,
             feature_pairs: Sequence[Tuple] = ()):
        total = self.soft_weight * soft_label_loss(
            student_logits, teacher_logits, self.temperature)
        if label is not None and self.hard_weight:
            total = total + self.hard_weight * torch.mean(
                softmax_with_cross_entropy(student_logits, label))
        for s, t in feature_pairs:
            total = total + self.feature_weight * l2_feature_loss(s, t)
        return total
