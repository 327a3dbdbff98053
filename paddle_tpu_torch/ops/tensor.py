"""Tensor ops (counterpart of paddle_tpu/ops/tensor.py): ``flatten``,
which the convolutional models need. The rest of the module is ROADMAP
queue 1 entry 4."""

from __future__ import annotations


def flatten(x, axis: int = 1):
    """Collapse to 2-D at ``axis``: (prod(shape[:axis]), rest) (the
    reference's flatten2)."""
    lead = 1
    for s in x.shape[:axis]:
        lead *= s
    return x.reshape(lead, -1)
