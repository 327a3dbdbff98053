"""Decoding filters and draws (counterpart of the LM-decoding half of
paddle_tpu/ops/sampling.py).

The filters (temperature, top-k, top-p) are exact ports. The draw takes
an explicit ``torch.Generator`` where the JAX package takes a PRNG key:
the two give different numbers, so only the filtered support and the
distribution carry over (ROADMAP queue 3)."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.enforce import enforce


def top_k_logits(logits, k: int):
    """Keep the k largest entries per row; push the rest to -inf.
    ``k <= 0`` is a no-op. Ties at the k-th value all survive (the filter
    is by value threshold, not by rank)."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, float("-inf"), logits)


def top_p_logits(logits, p: float):
    """Nucleus filter: keep the smallest set of entries whose probability
    mass reaches ``p`` (the top entry always survives); push the rest to
    -inf. ``p >= 1`` is a no-op."""
    if p >= 1.0:
        return logits
    enforce(p > 0.0, "top_p must be in (0, 1], got %s (p <= 0 would "
            "filter every token)", p)
    srt = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(srt.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # an entry is kept while the mass BEFORE it is still < p
    keep = (cum - probs) < p
    thresh = torch.where(keep, srt, float("inf")).amin(
        dim=-1, keepdim=True).to(logits.dtype)
    return torch.where(logits < thresh, float("-inf"), logits)


def filter_logits(logits, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0):
    """Temperature scaling, then top-k, then top-p, in float32. softmax
    of the result is the exact distribution :func:`sample_from_logits`
    draws from. ``temperature`` must be > 0."""
    enforce(temperature > 0.0, "temperature must be > 0, got %s",
            temperature)
    scaled = logits.float() / float(temperature)
    scaled = top_k_logits(scaled, top_k)
    return top_p_logits(scaled, top_p)


def sample_from_logits(logits, generator: Optional[torch.Generator],
                       temperature: float = 1.0, top_k: int = 0,
                       top_p: float = 1.0):
    """One token id per row of (B, V) ``logits``: filter, then a
    categorical draw from ``generator``. ``temperature == 0`` is exact
    argmax (no draw)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]
