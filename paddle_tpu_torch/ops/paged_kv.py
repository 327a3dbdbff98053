"""Paged-KV cache ops over a float page pool (counterpart of the float
half of paddle_tpu/ops/paged_kv.py): K/V live in a shared (pages,
page_size, kv_heads, head_dim) pool; a request's logical cache is its
page-id sequence. The host-side allocator is serving.PagedKVPool.

Writes are IN PLACE (the JAX functions return new pools). JAX scatters
with ``mode="drop"``, so a cursor past a row's table capacity writes
nothing. Torch has no drop mode, and boolean indexing would copy a
count to the host on every write, so a dropped row is sent to a place
another row writes with that row's value (see ``_drop_index``) — a
clamped write of its own value would corrupt another request's page.
The int8 pool form (``QuantizedPool``) comes with the
``kv_dtype="int8"`` slice (ROADMAP queue 1 item 7)."""

from __future__ import annotations

from typing import Optional

import torch


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


def _pool_write(pool, idx, valid, j, x):
    """pool[idx] = x (in place) for the valid rows; dropped rows store
    what row j stores (its x, or the old value when no row is valid)."""
    x = x.to(pool.dtype)
    dropped = torch.where(valid[j].view(1, 1, 1), x[j],
                          pool[idx[0][j], idx[1][j]])
    pool[idx] = torch.where(valid.view(-1, 1, 1), x, dropped)


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


def gather_rows(pool, table, upto: Optional[int] = None):
    """Each row's logical cache: (B, n_cols * page_size, kv, hd). ``upto``
    bounds the live positions (prefill): only the first
    ceil(upto / page_size) table columns are gathered. Page ids clamp
    into the pool, as JAX's gather clamps."""
    from .kernels.decode_attention import gather_pages

    if upto is not None:
        n_cols = max(1, -(-int(upto) // pool.shape[1]))
        table = table[:, :min(table.shape[1], n_cols)]
    return gather_pages(pool, table)


def attend(q, kpool, vpool, table, t_rows, window: Optional[int] = None):
    """Decode attention over the paged cache: the paged decode kernel
    when the gate admits the shape, else gather the pages and attend on
    the plain masked path. ``t_rows``: scalar or (B,) logical cursors."""
    from . import attention as A
    from .kernels.decode_attention import _cursors, decode_attention_paged

    d = q.shape[-1]
    page_size, n_log = kpool.shape[1], table.shape[1]
    t_rows = _cursors(t_rows, q.shape[0], q.device)
    if A.decode_flash_ok(page_size * n_log, d):
        return decode_attention_paged(q, kpool, vpool, table, t_rows,
                                      window=window)
    keep = A.cache_keep_mask(t_rows[:, None], n_log * page_size, window)
    return A.scaled_dot_product_attention(
        q, gather_rows(kpool, table), gather_rows(vpool, table), mask=keep,
        use_flash=False)
