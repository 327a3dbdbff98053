"""Sequence ops (counterpart of paddle_tpu/ops/sequence.py): the padded
(B, T) + lengths layout that replaces the reference's LoD. Ported so far:
``sequence_mask``; the rest of the file is ROADMAP queue 1 item 4."""

from __future__ import annotations

import torch

from ..core.dtypes import to_dtype


def sequence_mask(lengths, maxlen: int, dtype=torch.float32):
    """(B, maxlen) mask, 1 where position < the row's length
    (reference: operators/sequence_mask_op.cc)."""
    lengths = torch.as_tensor(lengths)
    pos = torch.arange(maxlen, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(to_dtype(dtype))
