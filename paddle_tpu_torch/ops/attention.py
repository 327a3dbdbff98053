"""Attention ops (counterpart of paddle_tpu/ops/attention.py).

Layout convention: (batch, seq, heads, head_dim) — "BTHD".

``xla_attention`` keeps the JAX package's name for the plain masked
path: the JAX package leaves it to XLA, and here it is plain PyTorch
math (einsum plus a masked softmax). Prefill attends with a per-query
mask and always takes it, as in the JAX package. On a CUDA tensor whose
shape the flash gate accepts, with no mask or a key-padding mask,
:func:`scaled_dot_product_attention` runs :func:`flash_attention`: the
forward and recompute-backward CUDA kernels of
``ops/kernels/flash_attention.py``, packed-row segment ids and attention
dropout included."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.enforce import enforce

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
    segment_ids: (B, T) ids of packed rows (self-attention only);
    positions attend within their own segment. dropout_p / dropout_key:
    attention-probability dropout, its masks drawn from the
    ``torch.Generator`` ``dropout_key`` (see :func:`flash_attention`).
    Both ride the flash kernels on the card."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    enforce(segment_ids is None or q.shape[1] == k.shape[1],
            "segment_ids requires self-attention shapes (tq=%s != tk=%s)",
            q.shape[1], k.shape[1])
    enforce(window is None or window >= 1,
            "window must be >= 1, got %s", window)
    if use_flash and (dropout_p == 0.0 or dropout_key is not None):
        kv_mask = _as_kv_mask(mask, q.shape[0], k.shape[1])
        if (mask is None or kv_mask is not None) and _flash_ok(q, k):
            return flash_attention(q, k, v, causal=causal, scale=scale,
                                   kv_mask=kv_mask, segment_ids=segment_ids,
                                   window=window, dropout_p=dropout_p,
                                   dropout_key=dropout_key)
    return xla_attention(q, k, v, mask=mask, causal=causal,
                         dropout_p=dropout_p, dropout_key=dropout_key,
                         scale=scale, segment_ids=segment_ids,
                         window=window)


def _dropout_seeds(generator: torch.Generator, b: int, h: int, device):
    """One int32 dropout seed per (batch, head), drawn from ``generator``
    over the JAX package's range (its ``flash_attention``:
    ``jax.random.randint(key, (b, h), -2**31, 2**31 - 1)``), on
    ``device``. The kernels and the plain path hash these seeds with the
    global (row, column) of each score."""
    enforce(isinstance(generator, torch.Generator),
            "dropout_key must be a torch.Generator, got %s",
            type(generator).__name__)
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (b, h),
                          generator=generator, device=generator.device,
                          dtype=torch.int32)
    return seeds.to(device)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel; backward = delta = rowsum(do * o) in float32, then
    the dq kernel and the dk/dv kernel (the JAX package's custom VJP).
    The mask, segment ids and seeds carry no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, segment_ids, seeds, causal, scale,
                window, dropout_p):
        from .kernels.flash_attention import flash_attention_fwd

        opts = dict(causal=causal, scale=scale, window=window,
                    dropout_p=dropout_p)
        o, lse = flash_attention_fwd(q, k, v, kv_mask=kv_mask,
                                     segment_ids=segment_ids, seeds=seeds,
                                     **opts)
        ctx.save_for_backward(q, k, v, o, lse, kv_mask, segment_ids, seeds)
        ctx.opts = opts
        return o

    @staticmethod
    def backward(ctx, do):
        from .kernels.flash_attention import (flash_attention_dkv,
                                              flash_attention_dq)

        q, k, v, o, lse, kv_mask, segment_ids, seeds = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        kw = dict(kv_mask=kv_mask, segment_ids=segment_ids, seeds=seeds,
                  **ctx.opts)
        dq = flash_attention_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, kv_mask=None,
                    segment_ids=None, window: Optional[int] = None,
                    dropout_p: float = 0.0, dropout_key=None):
    """Blockwise attention over q (B, Tq, H, D) and k/v (B, Tk, Hkv, D),
    differentiable by the recompute backward (counterpart of
    paddle_tpu/ops/pallas/flash_attention.py ``flash_attention``).
    ``kv_mask``: (B, Tk) keep-mask; a row with no live key outputs zeros.
    ``segment_ids``: (B, T) ids of packed rows (Tq == Tk); a position
    attends within its own segment. ``dropout_p`` > 0 drops attention
    probabilities inside the kernels; ``dropout_key``, a
    ``torch.Generator`` in place of the JAX PRNG key, gives one int32
    seed per (batch, head) for each call, and the backward rebuilds the
    forward's mask from them. On CUDA tensors the three kernels run; on
    CPU tensors their plain versions."""
    b, tq, h, _ = q.shape
    enforce(0.0 <= dropout_p < 1.0, "dropout_p must be in [0, 1), got %s",
            dropout_p)
    seeds = None
    if dropout_p > 0.0:
        enforce(dropout_key is not None, "dropout_p > 0 requires "
                "dropout_key, a torch.Generator (core.rng_scope makes one "
                "current for the layers, as Trainer.train_step does)")
        seeds = _dropout_seeds(dropout_key, b, h, q.device)
    if segment_ids is not None:
        enforce(tq == k.shape[1], "segment_ids requires self-attention "
                "shapes (tq=%s != tk=%s)", tq, k.shape[1])
        enforce(tuple(segment_ids.shape) == (b, tq),
                "segment_ids must be (batch, t) = (%s, %s), got %s", b, tq,
                tuple(segment_ids.shape))
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, kv_mask, segment_ids, seeds,
                                 bool(causal), float(scale),
                                 None if window is None else int(window),
                                 float(dropout_p))


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
    flash-kernel convention), not a uniform average of V.
    ``segment_ids`` (B, T): the segment-equality mask of packed rows.
    Dropout draws the same (B, H) seeds from ``dropout_key`` as
    :func:`flash_attention` and keeps an entry where the flash kernels'
    counter-based hash does (``ops.kernels.flash_attention.hash_keep``),
    not with a Bernoulli draw as the JAX package's XLA path: that draw
    could match the kernels only in distribution, while the hash makes
    this path and the kernels compute one function, so a check can hold
    one against the other with dropout on."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    if k.shape[2] != q.shape[2]:
        # GQA/MQA: kv-major — head h reads kv head h // group
        group = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    dev = q.device
    if window is not None:
        enforce(window >= 1, "window must be >= 1, got %s", window)
        rows = torch.arange(tq, device=dev)[:, None] + (tk - tq)
        cols = torch.arange(tk, device=dev)[None, :]
        band = rows - cols < window
        if not causal:
            band = band & (cols - rows < window)
        mask = band if mask is None else (mask.bool() & band)
    if segment_ids is not None:
        enforce(tq == tk, "segment_ids requires self-attention shapes "
                "(tq=%s != tk=%s)", tq, tk)
        ids = segment_ids.to(dev)
        seg = ids[:, None, :, None] == ids[:, None, None, :]
        mask = seg if mask is None else (mask.bool() & seg)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    neg = torch.finfo(logits.dtype).min
    keep = None
    if causal:
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
    if dropout_p > 0.0:
        from .kernels.flash_attention import hash_keep, keep_scale

        enforce(dropout_key is not None, "attention dropout requires "
                "dropout_key, a torch.Generator (core.rng_scope makes one "
                "current for the layers, as Trainer.train_step does)")
        seeds = _dropout_seeds(dropout_key, b, h, dev)
        rows = torch.arange(tq, device=dev)[:, None] + (tk - tq)
        cols = torch.arange(tk, device=dev)[None, :]
        drop_keep = hash_keep(seeds[:, :, None, None], rows, cols,
                              dropout_p)
        probs = torch.where(drop_keep, probs * keep_scale(dropout_p),
                            0.0).to(probs.dtype)
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
    # a Python-scalar base: a tensor made on the card from theta would be
    # a host-to-device copy, which waits for the card (a host sync in
    # every decode step); the float32 pow is the same
    freqs = torch.pow(float(theta), expo)
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
