"""Fused linear + softmax cross-entropy over a chunked vocabulary
(counterpart of paddle_tpu/ops/fused_loss.py).

``loss = CE(h @ W + b, labels)`` without the (N, V) logits: the forward
scans vocabulary chunks with an online logsumexp, and the backward
recomputes each chunk's (N, C) logits and keeps nothing (N, V)-sized.
The JAX package leaves these products to XLA; here they are
``torch.matmul`` on float32 operands, the counterpart of its
``preferred_element_type=float32`` (bfloat16 inputs are exact in
float32, so the products and their float32 sums are the same)."""

from __future__ import annotations

import torch

from ..core.enforce import enforce


def _chunk_logits(hidden, weight, bias, c0, c1):
    """(N, c1-c0) float32 logits of vocabulary columns [c0, c1)."""
    logits = torch.matmul(hidden.float(), weight[:, c0:c1].float())
    if bias is not None:
        logits = logits + bias[c0:c1].float()
    return logits


class _LinearCrossEntropy(torch.autograd.Function):
    """The JAX package's custom VJP (``_lce_fwd_impl`` / ``_lce_bwd``)."""

    @staticmethod
    def forward(ctx, hidden, weight, bias, labels, chunk, ignore_index):
        n, d = hidden.shape
        enforce(d == weight.shape[0], "hidden dim %s != weight dim %s", d,
                weight.shape[0])
        v = weight.shape[1]
        m = torch.full((n,), float("-inf"), device=hidden.device)
        s = torch.zeros((n,), device=hidden.device)
        for c0 in range(0, v, chunk):
            logits = _chunk_logits(hidden, weight, bias, c0,
                                   min(c0 + chunk, v))
            m_new = torch.maximum(m, logits.amax(dim=1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=1)
            m = m_new
        lse = m + torch.log(s)
        safe = labels.clamp(0, v - 1).long()
        # float32 products and a float32 sum, as the chunk matmuls take
        # them: a rounded product here would put lse below the target
        # logit (a negative loss) on confident rows
        t_logit = (hidden.float() * weight[:, safe].T.float()).sum(dim=1)
        if bias is not None:
            t_logit = t_logit + bias[safe].float()
        valid = labels != ignore_index
        loss = torch.where(valid, lse - t_logit, 0.0)
        ctx.save_for_backward(hidden, weight, bias, labels, lse)
        ctx.chunk, ctx.ignore_index = chunk, ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, weight, bias, labels, lse = ctx.saved_tensors
        v = weight.shape[1]
        gv = torch.where(labels != ctx.ignore_index, g, 0.0)
        safe = labels.clamp(0, v - 1).long()
        dh = torch.zeros(hidden.shape, dtype=torch.float32,
                         device=hidden.device)
        dw, db = [], []
        for c0 in range(0, v, ctx.chunk):
            c1 = min(c0 + ctx.chunk, v)
            p = torch.exp(_chunk_logits(hidden, weight, bias, c0, c1)
                          - lse[:, None])
            cols = torch.arange(c0, c1, device=hidden.device)
            onehot = (cols[None, :] == safe[:, None]).to(p.dtype)
            dl = (gv[:, None] * (p - onehot)).to(hidden.dtype)
            dh += torch.matmul(dl, weight[:, c0:c1].T).float()
            dw.append(torch.matmul(hidden.T, dl))
            db.append(dl.float().sum(dim=0))
        dbias = (torch.cat(db).to(bias.dtype) if bias is not None
                 else None)
        return (dh.to(hidden.dtype), torch.cat(dw, dim=1).to(weight.dtype),
                dbias, None, None, None)


def linear_cross_entropy(hidden, weight, bias, labels, chunk: int = 4096,
                         ignore_index: int = -100):
    """Per-row CE of ``hidden @ weight + bias`` against ``labels`` without
    the full logits. hidden (N, D); weight (D, V); bias (V,) or None;
    labels (N,) int. Rows with ``labels == ignore_index`` contribute 0;
    V need not divide ``chunk``. Returns (N,) float32 losses."""
    enforce(chunk >= 1, "chunk must be >= 1, got %s", chunk)
    return _LinearCrossEntropy.apply(hidden, weight, bias, labels,
                                     int(chunk), int(ignore_index))


def mean_linear_cross_entropy(hidden, weight, bias, labels,
                              chunk: int = 4096, ignore_index: int = -100):
    """Mean over non-ignored rows (the training-loss form)."""
    losses = linear_cross_entropy(hidden, weight, bias, labels, chunk,
                                  ignore_index)
    count = torch.clamp((labels != ignore_index).sum().to(losses.dtype),
                        min=1.0)
    return losses.sum() / count
