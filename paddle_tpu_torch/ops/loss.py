"""Loss ops (counterpart of paddle_tpu/ops/loss.py; reference:
paddle/fluid/operators/*loss*_op.cc, cross_entropy_op.cc,
softmax_with_cross_entropy_op.cc, ...). The fused linear-CE head is
ops/fused_loss.py. Hard labels may come with a singleton class dim
(Paddle's (N, 1)) or without. ``sampled_softmax_with_cross_entropy``
draws its negatives from the JAX package's threefry key through a
seeded ``torch.Generator``: distributed as the JAX draws, not equal."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.enforce import enforce
from ..core.random import seed_generator
from .math import _clip, _maximum
from .math import abs as _abs
from .tensor import _in_range, _take_along, _wrap_clamp


def _index_label(label, logits_ndim: int, axis: int):
    """A hard-label tensor with a singleton class dim at ``axis``."""
    axis = axis % logits_ndim
    label = torch.as_tensor(label)
    if label.ndim == logits_ndim:
        # came in with a singleton class dim already (paddle's (N, 1) style)
        return label.long()
    return label.long().unsqueeze(axis)


def cross_entropy(probs, label, soft_label: bool = False, axis: int = -1,
                  eps: float = 1e-8):
    """-log(max(probs, eps)) at the label along ``axis`` (a singleton
    class dim kept), or the cross entropy against a soft ``label``.
    Takes probabilities, as the reference's cross_entropy_op takes a
    softmax output."""
    logp = torch.log(_maximum(probs, eps))
    if soft_label:
        return -torch.sum(label * logp, dim=axis, keepdim=True)
    lbl = _index_label(label, logp.ndim, axis).to(logp.device)
    # jnp.take_along_axis: a label in [-C, 0) wraps, one outside [-C, C)
    # gives NaN
    return -_take_along(logp, lbl, axis % logp.ndim)


def softmax_with_cross_entropy(logits, label, soft_label: bool = False,
                               axis: int = -1, ignore_index: int = -100,
                               return_softmax: bool = False):
    """-log_softmax(logits)[label] along ``axis``, keeping a singleton
    class dim; entries whose label is ``ignore_index`` give 0.
    ``soft_label``: ``label`` is a distribution, the loss its cross
    entropy. ``return_softmax`` also returns the softmax."""
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        lbl = _index_label(label, logp.ndim, axis).to(logp.device)
        valid = lbl != ignore_index
        # clamp before gathering so ignored (possibly negative) labels
        # cannot index out of bounds; their loss is masked to 0 below
        safe = lbl.clamp(0, logits.shape[axis] - 1)
        loss = -torch.gather(logp, axis % logp.ndim, safe)
        loss = loss * valid.to(loss.dtype)
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index: int = -100,
                                      normalize: bool = False):
    """Elementwise ``max(x, 0) - x * label + log1p(exp(-|x|))``; entries
    whose label is ``ignore_index`` give 0, and ``normalize`` divides by
    the count of the others (at least 1)
    (reference: operators/sigmoid_cross_entropy_with_logits_op.cc)."""
    # maximum, not clamp, and abs with derivative +1 at 0: the gradient
    # at x == 0 is -label, as JAX's is
    loss = _maximum(x, 0.0) - x * label + torch.log1p(torch.exp(-_abs(x)))
    mask = (label != ignore_index).to(loss.dtype)
    loss = loss * mask
    if normalize:
        loss = loss / torch.clamp_min(torch.sum(mask), 1.0)
    return loss


def label_smooth(label, epsilon: float = 0.1, prior_dist=None):
    """``(1 - epsilon) * label + epsilon * prior``: the uniform prior
    ``1 / k`` over the last axis's k classes unless ``prior_dist`` is
    given (reference: operators/label_smooth_op.cc)."""
    k = label.shape[-1]
    if prior_dist is not None:
        return (1.0 - epsilon) * label + epsilon * prior_dist
    return (1.0 - epsilon) * label + epsilon / k


def square_error_cost(input, label):  # noqa: A002 - the reference's name
    return torch.square(input - label)


def smooth_l1_loss(x, y, sigma: float = 1.0, inside_weight=None,
                   outside_weight=None):
    """reference: operators/smooth_l1_loss_op.cc — the loss summed over
    every dim but the first, as (N, 1)."""
    sigma2 = sigma * sigma
    d = x - y
    if inside_weight is not None:
        d = d * inside_weight
    ad = torch.abs(d)
    loss = torch.where(ad < 1.0 / sigma2, 0.5 * sigma2 * d * d,
                       ad - 0.5 / sigma2)
    if outside_weight is not None:
        loss = loss * outside_weight
    return torch.sum(loss, dim=tuple(range(1, loss.ndim)))[..., None]


def huber_loss(x, y, delta: float = 1.0):
    """reference: operators/huber_loss_op.cc."""
    d = y - x
    ad = torch.abs(d)
    return torch.where(ad <= delta, 0.5 * d * d, delta * (ad - 0.5 * delta))


def modified_huber_loss(x, y):
    """reference: operators/modified_huber_loss_op.cc — y in {0, 1}."""
    z = x * (2.0 * y - 1.0)
    return torch.where(z < -1.0, -4.0 * z,
                       torch.where(z < 1.0, torch.square(1.0 - z),
                                   torch.zeros_like(z)))


def hinge_loss(logits, label):
    """reference: operators/hinge_loss_op.cc — label in {0, 1}."""
    return _maximum(1.0 - logits * (2.0 * label - 1.0), 0.0)


def log_loss(predicted, label, epsilon: float = 1e-4):
    """reference: operators/log_loss_op.cc."""
    return (-label * torch.log(predicted + epsilon)
            - (1.0 - label) * torch.log(1.0 - predicted + epsilon))


def bpr_loss(logits, label):
    """reference: operators/bpr_loss_op.cc — Bayesian personalised
    ranking: the mean over the other d - 1 classes of log(1 +
    exp(-(pos - logit))), the label's own column masked out. A label in
    [-d, 0) wraps; one outside [-d, d) gives NaN (``jnp.take_along_axis``)
    and masks no column (``.at[]`` drops it)."""
    n, d = logits.shape
    lbl = label.reshape(n, 1).long()
    pos = _take_along(logits, lbl, 1)
    lse = torch.log1p(torch.exp(-(pos - logits)))
    mask = torch.ones((n, d), dtype=logits.dtype, device=logits.device)
    mask = mask.scatter(1, _wrap_clamp(lbl, d),
                        (~_in_range(lbl, d)).to(logits.dtype))
    return torch.sum(lse * mask, dim=1, keepdim=True) / (d - 1)


def kldiv_loss(x, target, reduction: str = "mean"):
    """reference: operators/kldiv_loss_op.cc — ``x`` is a log-probability;
    entries with target <= 0 give 0."""
    loss = target * (torch.log(_maximum(target, 1e-12)) - x)
    loss = torch.where(target > 0, loss, torch.zeros_like(loss))
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    if reduction == "batchmean":
        return torch.sum(loss) / x.shape[0]
    return loss


def margin_rank_loss(label, left, right, margin: float = 0.0):
    """reference: operators/margin_rank_loss_op.cc."""
    return _maximum(-label * (left - right) + margin, 0.0)


def rank_loss(label, left, right):
    """reference: operators/rank_loss_op.cc — RankNet's pairwise loss."""
    d = left - right
    return torch.log1p(torch.exp(d)) - label * d


def teacher_student_sigmoid_loss(x, label, soft_max_up_bound: float = 15.0,
                                 soft_max_lower_bound: float = -15.0):
    """reference: operators/teacher_student_sigmoid_loss_op.cc — x
    clipped to the bounds; a label < -1 is the teacher's soft label
    label + 2, otherwise the label as it is."""
    xc = _clip(x, soft_max_lower_bound, soft_max_up_bound)
    target = torch.where(label < -1.0, label + 2.0, label)
    return (_maximum(xc, 0.0) - xc * target
            + torch.log1p(torch.exp(-_abs(xc))))


def npair_loss(anchor, positive, labels, l2_reg: float = 0.002):
    """reference: layers/nn.py npair_loss — the softmax cross entropy of
    anchor @ positive.T against the same-label rows, normalised, plus
    0.25 * l2_reg times the squared norms over the batch size."""
    batch = anchor.shape[0]
    sim = anchor @ positive.T
    lbl = labels.reshape(-1)
    target = (lbl[:, None] == lbl[None, :]).to(sim.dtype)
    target = target / torch.sum(target, dim=1, keepdim=True)
    ce = -torch.sum(target * torch.log_softmax(sim, dim=1), dim=1).mean()
    reg = 0.25 * l2_reg * (torch.sum(torch.square(anchor))
                           + torch.sum(torch.square(positive))) / batch
    return ce + reg


def mse_loss(input, label):  # noqa: A002 - the reference's name
    return torch.mean(torch.square(input - label))


def sampled_softmax_with_cross_entropy(logits, label, num_samples: int,
                                       key: Optional[object] = None):
    """The softmax cross entropy of the true class (column 0) against
    ``num_samples`` classes drawn uniformly from ``key`` per row
    (reference: operators/sample_logits_op.cc with a softmax)."""
    enforce(key is not None, "sampled softmax requires a PRNG key")
    n, v = logits.shape
    gen = seed_generator(torch.Generator(device=logits.device), key)
    sampled = torch.randint(0, v, (n, num_samples), generator=gen,
                            device=logits.device)
    idx = torch.cat([label.reshape(n, 1).long(), sampled], dim=1)
    picked = torch.gather(logits, 1, idx)
    return softmax_with_cross_entropy(
        picked, torch.zeros((n,), dtype=torch.long, device=logits.device))


def dice_loss(input, label, epsilon: float = 1e-5):  # noqa: A002
    """The Dice coefficient loss (reference: layers/nn.py dice_loss):
    ``input`` (..., D) class probabilities, ``label`` (..., 1) or (...)
    class ids (one out of range is a row of zeros, as
    ``jax.nn.one_hot``'s)."""
    from .nn import one_hot as _one_hot

    if label.ndim == input.ndim:
        label = label[..., 0]
    one_hot = _one_hot(label, input.shape[-1], input.dtype)
    dims = tuple(range(1, input.ndim))
    inter = torch.sum(input * one_hot, dim=dims)
    union = torch.sum(input, dim=dims) + torch.sum(one_hot, dim=dims)
    return torch.mean(1.0 - (2.0 * inter + epsilon) / (union + epsilon))


def smooth_l1(x, y, inside_weight=None, outside_weight=None,
              sigma: float = 1.0):
    """The fluid name (layers/nn.py smooth_l1): :func:`smooth_l1_loss`
    summed to (N, 1)."""
    l = smooth_l1_loss(x, y, sigma=sigma, inside_weight=inside_weight,
                       outside_weight=outside_weight)
    return torch.sum(l.reshape(l.shape[0], -1), dim=1, keepdim=True)
