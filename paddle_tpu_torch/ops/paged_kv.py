"""Paged-KV cache ops (counterpart of paddle_tpu/ops/paged_kv.py): K/V
live in a shared (pages, page_size, kv_heads, head_dim) pool; a
request's logical cache is its page-id sequence. The host-side allocator
is serving.PagedKVPool.

Pools come in two storage forms, as in the JAX package: a float tensor,
or a :class:`QuantizedPool` (int8 values plus one float32 abs-max scale
per (page, position, kv head) vector, the ``quant.ops.absmax_encode``
format). Writes quantize on append; attention hands the int8 decode
kernel the raw planes, and the gather path (prefill, and the wrapper's
plain version on the CPU) dequantizes only the gathered rows. This
module is the one place that branches on the storage form.

Writes are IN PLACE (the JAX functions return new pools). JAX scatters
with ``mode="drop"``, so a cursor past a row's table capacity writes
nothing. Torch has no drop mode, and boolean indexing would copy a
count to the host on every write, so a dropped row is sent to a place
another row writes with that row's value (see ``_drop_index``) — a
clamped write of its own value would corrupt another request's page.
An int8 pool writes its value and scale planes with the same indices.

``write_chunk_rows`` writes S positions per row at per-row cursors (the
speculative verify chunk); ``export_pages``/``import_pages`` copy whole
pages out of and into a pool in its storage form (the KV handoff)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class QuantizedPool(NamedTuple):
    """int8 paged K or V pool: ``q`` (pages, page_size, kv_heads,
    head_dim) int8 values, ``scale`` (pages, page_size, kv_heads)
    float32 per-vector abs-max scales (dequant = ``q * scale``).
    ``shape``/``dtype`` mirror the value plane, so shape-driven callers
    (``kpool.shape[1]`` is the page size) never branch."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def nbytes(self) -> int:
        """Device bytes of the pool, values and scales."""
        return quantized_pool_nbytes(self.q.shape)


def quantized_pool_nbytes(shape) -> int:
    """Device bytes a :class:`QuantizedPool` with value layout ``shape``
    = (pages, page_size, kv_heads, head_dim) costs: int8 values plus one
    float32 scale per vector. The one byte formula of the storage form
    (``QuantizedPool.nbytes`` and ``PagedKVPool.pool_nbytes`` read it)."""
    pages, page_size, kv_heads, head_dim = shape
    vecs = pages * page_size * kv_heads
    return vecs * head_dim + vecs * 4


def _encode_vectors(x):
    """(..., head_dim) float -> (int8 values, scales (...,)): per-vector
    abs-max int8, the shared quant.ops convention."""
    from ..quant.ops import absmax_encode

    q, scale = absmax_encode(x, axis=-1)
    return q, scale[..., 0]


def _drop_index(page, off, valid, pages: int):
    """Scatter indices that drop the rows where ``valid`` fails (or the
    page id lies outside the pool) without a host sync. A dropped row
    takes the place of ``j``, the first valid row, and will write row
    j's value there, so the repeated index stores one value whatever the
    order; with no valid row, j = 0 and every row rewrites the value
    already at row 0's (clamped) place. Returns ((page, off), valid, j)."""
    valid = valid & (page >= 0) & (page < pages)
    page = page.clamp(0, pages - 1)
    # j as a (1,) tensor: indexing with a 0-dim one would read it on the
    # host
    j = torch.argmax(valid.to(torch.int32)).reshape(1)
    return ((torch.where(valid, page, page[j]),
             torch.where(valid, off, off[j])), valid, j)


def _plane_write(plane, idx, valid, j, x):
    """plane[idx] = x (in place) for the valid rows; dropped rows store
    what row j stores (its x, or the old value when no row is valid)."""
    tail = (1,) * (x.ndim - 1)
    dropped = torch.where(valid[j].view(1, *tail), x[j],
                          plane[idx[0][j], idx[1][j]])
    plane[idx] = torch.where(valid.view(-1, *tail), x, dropped)


def _pool_write(pool, idx, valid, j, x):
    """Write the vectors ``x`` (rows, kv, hd) at ``idx``, dropping the
    invalid rows: quantize on append into both planes of a
    :class:`QuantizedPool`, a dtype-cast store into a float pool."""
    if isinstance(pool, QuantizedPool):
        q, s = _encode_vectors(x)
        _plane_write(pool.q, idx, valid, j, q)
        _plane_write(pool.scale, idx, valid, j, s)
    else:
        _plane_write(pool, idx, valid, j, x.to(pool.dtype))


def write_rows(kpool, vpool, table, t_rows, k_t, v_t, page_size: int):
    """One position per row at logical cursors ``t_rows`` (B,): write
    k_t/v_t (B, 1, kv, hd) into each row's page. Cursors outside the
    row's table capacity drop."""
    n_log = table.shape[1]
    t = t_rows.long()
    rows = torch.arange(table.shape[0], device=t.device)
    col = (t // page_size).clamp(0, n_log - 1)
    idx, valid, j = _drop_index(table[rows, col].long(), t % page_size,
                                (t >= 0) & (t < n_log * page_size),
                                kpool.shape[0])
    _pool_write(kpool, idx, valid, j, k_t[:, 0])
    _pool_write(vpool, idx, valid, j, v_t[:, 0])
    return kpool, vpool


def write_chunk(kpool, vpool, table_row, t0: int, k_c, v_c,
                page_size: int):
    """S consecutive positions for one row from logical ``t0``: k_c/v_c
    (1, S, kv, hd). Positions past the table capacity drop."""
    s = k_c.shape[1]
    n_log = table_row.shape[0]
    pos = t0 + torch.arange(s, device=k_c.device)
    col = (pos // page_size).clamp(0, n_log - 1)
    idx, valid, j = _drop_index(table_row[col].long(), pos % page_size,
                                (pos >= 0) & (pos < n_log * page_size),
                                kpool.shape[0])
    _pool_write(kpool, idx, valid, j, k_c[0])
    _pool_write(vpool, idx, valid, j, v_c[0])
    return kpool, vpool


def gather_rows(pool, table, upto: Optional[int] = None,
                full: bool = False):
    """Each row's logical cache: (B, n_cols * page_size, kv, hd). ``upto``
    bounds the live positions (prefill): only the first
    ceil(upto / page_size) table columns are gathered; ``full=True``
    gathers the whole view all the same. Page ids clamp into the pool,
    as JAX's gather clamps. A :class:`QuantizedPool` dequantizes here,
    only the gathered rows, to float32."""
    from .kernels.decode_attention import dequantize_pages, gather_pages

    if upto is not None and not full:
        n_cols = max(1, -(-int(upto) // pool.shape[1]))
        table = table[:, :min(table.shape[1], n_cols)]
    if isinstance(pool, QuantizedPool):
        return dequantize_pages(pool.q, pool.scale, table)
    return gather_pages(pool, table)


def attend(q, kpool, vpool, table, t_rows, window: Optional[int] = None):
    """Decode attention over the paged cache, whatever its shape: the
    paged decode wrapper (an int8 pool hands the int8 one its raw value
    and scale planes). On the card that launches the kernel or raises a
    typed error for a shape the kernel cannot run; on the CPU the wrapper
    gathers (and dequantizes) the pages and attends on its plain
    version. ``t_rows``: scalar or (B,) logical cursors."""
    from .kernels.decode_attention import (decode_attention_paged,
                                           decode_attention_paged_quant)

    if isinstance(kpool, QuantizedPool):
        return decode_attention_paged_quant(
            q, kpool.q, kpool.scale, vpool.q, vpool.scale, table, t_rows,
            window=window)
    return decode_attention_paged(q, kpool, vpool, table, t_rows,
                                  window=window)


def write_chunk_rows(kpool, vpool, table, t0_rows, k_c, v_c,
                     page_size: int):
    """S consecutive positions per row from per-row logical cursors
    ``t0_rows`` (B,): k_c/v_c (B, S, kv, hd), the speculative verify
    chunk's write (every row lands its candidates at its own offset).
    Positions past the table capacity drop."""
    b, s = k_c.shape[:2]
    n_log = table.shape[1]
    pos = (t0_rows.long()[:, None]
           + torch.arange(s, device=k_c.device)[None, :]).reshape(-1)
    rows = torch.arange(b, device=k_c.device).repeat_interleave(s)
    col = (pos // page_size).clamp(0, n_log - 1)
    idx, valid, j = _drop_index(table[rows, col].long(), pos % page_size,
                                (pos >= 0) & (pos < n_log * page_size),
                                kpool.shape[0])
    _pool_write(kpool, idx, valid, j, k_c.reshape(b * s, *k_c.shape[2:]))
    _pool_write(vpool, idx, valid, j, v_c.reshape(b * s, *v_c.shape[2:]))
    return kpool, vpool


def export_pages(pool, ids):
    """The contents of pages ``ids`` (n,), the KV handoff's payload:
    (n, page_size, kv_heads, head_dim) values for a float pool, a
    ``(q, scale)`` pair for a :class:`QuantizedPool` (the int8 values and
    their scales travel together, never dequantized). A gather on the
    pool's device; the caller copies it to the host."""
    ids = torch.as_tensor(ids, device=pool.q.device if isinstance(
        pool, QuantizedPool) else pool.device).long()
    if isinstance(pool, QuantizedPool):
        return pool.q[ids], pool.scale[ids]
    return pool[ids]


def _on(x, device, dtype):
    """A payload array (numpy, possibly read-only, or a tensor) as a
    ``dtype`` tensor on ``device``."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype)


def import_pages(pool, ids, payload):
    """Write an :func:`export_pages` payload into pages ``ids`` of
    ``pool``, in place (the decode side of the KV handoff). The storage
    forms must match: a quantized payload lands only in a quantized pool
    and a float payload only in a float pool, since converting either way
    would change the cached values; a mismatch is a typed error."""
    from ..core.enforce import enforce

    if isinstance(pool, QuantizedPool):
        enforce(isinstance(payload, tuple) and len(payload) == 2,
                "quantized pool needs a (q, scale) payload, got %s",
                type(payload).__name__)
        dev = pool.q.device
        ids = torch.as_tensor(ids, device=dev).long()
        q, scale = payload
        pool.q[ids] = _on(q, dev, torch.int8)
        pool.scale[ids] = _on(scale, dev, torch.float32)
        return pool
    enforce(not isinstance(payload, tuple),
            "float pool cannot import a quantized (q, scale) payload "
            "— kv_dtype must match across the handoff")
    ids = torch.as_tensor(ids, device=pool.device).long()
    pool[ids] = _on(payload, pool.device, pool.dtype)
    return pool
