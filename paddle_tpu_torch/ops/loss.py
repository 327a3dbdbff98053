"""Loss ops (counterpart of paddle_tpu/ops/loss.py): the fused softmax
cross-entropy BERT's NSP head takes, the sigmoid cross-entropy of the
CTR models and the NMT model's label smoothing. The fused linear-CE head
is ops/fused_loss.py."""

from __future__ import annotations

import torch


def _index_label(label, logits_ndim: int, axis: int):
    """A hard-label tensor with a singleton class dim at ``axis``."""
    axis = axis % logits_ndim
    label = torch.as_tensor(label)
    if label.ndim == logits_ndim:
        # came in with a singleton class dim already (paddle's (N, 1) style)
        return label.long()
    return label.long().unsqueeze(axis)


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
    # maximum, not clamp: its gradient at x == 0 is split, as jnp's is
    loss = torch.maximum(x, x.new_zeros(())) - x * label + torch.log1p(
        torch.exp(-torch.abs(x)))
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
