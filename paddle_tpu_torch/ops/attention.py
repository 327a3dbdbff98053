"""Attention ops (counterpart of paddle_tpu/ops/attention.py).

Layout convention: (batch, seq, heads, head_dim) — "BTHD".

``xla_attention`` keeps the JAX package's name for the plain masked
path: the JAX package leaves it to XLA, and here it is plain PyTorch
math (einsum plus a masked softmax). Prefill attends with a per-query
mask and always takes it, as in the JAX package. On a CUDA tensor whose
shape the flash gate accepts, with no mask or a key-padding mask,
:func:`scaled_dot_product_attention` runs :func:`flash_attention`: the
forward and recompute-backward CUDA kernels of
``ops/kernels/flash_attention.py``."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.enforce import UnimplementedError, enforce

# head dims the training kernels' dispatch gate admits
# (ops/attention.py:152 in the JAX package)
_FLASH_HEAD_DIMS = (64, 128, 256)


def scaled_dot_product_attention(q, k, v, mask=None, causal: bool = False,
                                 dropout_p: float = 0.0, dropout_key=None,
                                 scale: Optional[float] = None,
                                 use_flash: bool = True,
                                 segment_ids=None,
                                 window: Optional[int] = None):
    """q: (B, Tq, H, D), k/v: (B, Tk, Hkv, D) -> (B, Tq, H, D).

    mask: broadcastable to (B, H, Tq, Tk); True = keep. window: sliding
    window (lookback-only when causal, a symmetric band otherwise).
    Attention dropout (``dropout_p``, ``dropout_key``) and packed-batch
    ``segment_ids`` are not ported and raise."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    enforce(window is None or window >= 1,
            "window must be >= 1, got %s", window)
    _check_unported(segment_ids, dropout_p, dropout_key)
    if use_flash:
        kv_mask = _as_kv_mask(mask, q.shape[0], k.shape[1])
        if (mask is None or kv_mask is not None) and _flash_ok(q, k):
            return flash_attention(q, k, v, causal=causal, scale=scale,
                                   kv_mask=kv_mask, window=window)
    return xla_attention(q, k, v, mask=mask, causal=causal, scale=scale,
                         window=window)


def _check_unported(segment_ids, dropout_p, dropout_key=None):
    if segment_ids is not None:
        raise UnimplementedError(
            "packed-batch segment_ids are not ported yet: ROADMAP queue 2 "
            "item 1 (flash-attention options)")
    if dropout_p != 0.0 or dropout_key is not None:
        raise UnimplementedError(
            "attention dropout is not ported yet: ROADMAP queue 1 item 3 "
            "(training-mode dropout) and queue 2 item 1 (the in-kernel "
            "dropout hash)")


class _FlashAttention(torch.autograd.Function):
    """Forward kernel; backward = delta = rowsum(do * o) in float32, then
    the dq kernel and the dk/dv kernel (the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale, window):
        from .kernels.flash_attention import flash_attention_fwd

        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                     window=window, kv_mask=kv_mask)
        ctx.save_for_backward(q, k, v, o, lse, kv_mask)
        ctx.opts = dict(causal=causal, scale=scale, window=window)
        return o

    @staticmethod
    def backward(ctx, do):
        from .kernels.flash_attention import (flash_attention_dkv,
                                              flash_attention_dq)

        q, k, v, o, lse, kv_mask = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        dq = flash_attention_dq(q, k, v, do, lse, delta, kv_mask=kv_mask,
                                **ctx.opts)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, delta,
                                     kv_mask=kv_mask, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, kv_mask=None,
                    window: Optional[int] = None, segment_ids=None,
                    dropout_p: float = 0.0):
    """Blockwise attention over q (B, Tq, H, D) and k/v (B, Tk, Hkv, D),
    differentiable by the recompute backward (counterpart of
    paddle_tpu/ops/pallas/flash_attention.py ``flash_attention``).
    ``kv_mask``: (B, Tk) keep-mask; a row with no live key outputs zeros.
    On CUDA tensors the three kernels run; on CPU tensors their plain
    versions."""
    _check_unported(segment_ids, dropout_p)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, kv_mask, bool(causal),
                                 float(scale),
                                 None if window is None else int(window))


def _as_kv_mask(mask, b: int, tk: int):
    """The (B, Tk) key-padding form of a keep-mask, or None when it
    constrains per head or per query. Only the explicit (B, 1, 1, Tk)
    broadcast form qualifies."""
    if mask is None:
        return None
    if (mask.ndim == 4 and mask.shape[0] in (1, b) and mask.shape[1] == 1
            and mask.shape[2] == 1 and mask.shape[3] == tk):
        return mask[:, 0, 0, :].expand(b, tk)
    return None


def xla_attention(q, k, v, mask=None, causal: bool = False,
                  dropout_p: float = 0.0, dropout_key=None,
                  scale: Optional[float] = None, segment_ids=None,
                  window: Optional[int] = None):
    """The plain path — materializes (B, H, Tq, Tk) scores. Masked
    logits take ``finfo.min``; rows with no valid key output zeros (the
    flash-kernel convention), not a uniform average of V. Dropout and
    ``segment_ids`` are not ported and raise."""
    _check_unported(segment_ids, dropout_p, dropout_key)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if k.shape[2] != q.shape[2]:
        # GQA/MQA: kv-major — head h reads kv head h // group
        group = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    dev = q.device
    if window is not None:
        enforce(window >= 1, "window must be >= 1, got %s", window)
        tq, tk = q.shape[1], k.shape[1]
        rows = torch.arange(tq, device=dev)[:, None] + (tk - tq)
        cols = torch.arange(tk, device=dev)[None, :]
        band = rows - cols < window
        if not causal:
            band = band & (cols - rows < window)
        mask = band if mask is None else (mask.bool() & band)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    neg = torch.finfo(logits.dtype).min
    keep = None
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones((tq, tk), dtype=torch.bool,
                          device=dev).tril(tk - tq)
        logits = logits.masked_fill(~keep, neg)
    if mask is not None:
        mask = mask.bool()
        keep = mask if keep is None else (keep & mask)
        logits = torch.where(mask, logits, neg)
    probs = torch.softmax(logits, dim=-1)
    if keep is not None:
        any_valid = keep.expand(logits.shape).any(-1, keepdim=True)
        probs = torch.where(any_valid, probs, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def rotary_embedding(x, positions, theta: float = 10000.0):
    """Rotary position embedding over (B, T, H, D) with even D.

    ``positions``: (T,) or (B, T) integer absolute positions. Rotate-half
    convention: pairs are (x[..., i], x[..., i + D/2]). Frequencies are
    ``theta ** (-arange(half) / half)`` in float32, from float32
    positions — the JAX package's exact order of operations."""
    d = x.shape[-1]
    enforce(d % 2 == 0, "rotary needs an even head_dim, got %s", d)
    half = d // 2
    dev = x.device
    expo = -torch.arange(0, half, dtype=torch.float32, device=dev) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=dev),
                      expo)
    ang = positions.to(device=dev, dtype=torch.float32)[..., None] * freqs
    # (T, half) broadcasts over batch and heads, (B, T, half) over heads
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cache_keep_mask(positions, n_keys: int, window: Optional[int] = None):
    """Keep-mask of queries at absolute cache ``positions`` over cache
    positions [0, n_keys): a query keeps the keys at or before its own
    position (and inside ``window``). ``positions`` (S,) -> (1, 1, S,
    n_keys); (B, 1) -> (B, 1, 1, n_keys); both broadcast to (B, H, Tq,
    Tk)."""
    cols = torch.arange(n_keys, device=positions.device)
    pos = positions[..., None]
    keep = cols <= pos
    if window is not None:
        keep &= cols > pos - window
    return keep[None, None] if positions.ndim == 1 else keep[:, None]


def _flash_ok(q, k) -> bool:
    """The flash-kernel gate for (B, T, H, D) operands on the card."""
    return q.is_cuda and flash_shape_ok(q.shape[1], k.shape[1],
                                        q.shape[-1])


def flash_shape_ok(tq: int, tk: int, d: int, causal: bool = False,
                   window=None) -> bool:
    """The flash kernels' shape rule: 64-divisible sequence lengths and
    a supported head dim; every shape it admits runs on the kernels.
    ``causal`` and ``window`` only pick the JAX package's tuned verdict
    for a shape; the port has no tuned table (ROADMAP queue 1 item 4), so
    its answer is the JAX package's where no verdict is recorded."""
    return tq % 64 == 0 and tk % 64 == 0 and d in _FLASH_HEAD_DIMS
