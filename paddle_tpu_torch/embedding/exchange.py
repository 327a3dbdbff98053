"""Sparse gradient exchange for ep-sharded tables: (unique ids, rows) on
the wire, never the dense (V, D) gradient (counterpart of
paddle_tpu/embedding/exchange.py).

The reference's trainers push SelectedRows, (row ids, row values) pairs,
to the parameter servers instead of dense table gradients (reference:
framework/selected_rows.h:32, MergeAdd in
operators/math/selected_rows_functor.cc). Per step, on every rank of a
``Plan(ep=N)`` mesh:

1. **local MergeAdd**: the rank merges its ids and sums duplicate rows
   (``optimizer.sparse.merge_rows``; fill slots carry id V) before
   anything goes on the wire;
2. **the wire**: the merged ids (int32) and rows are all-gathered over
   the batch axes: the rows as int8 with one float32 scale per row
   (``quant.ops.absmax_encode(axis=1)``) where
   :func:`should_compress` says so, float32 otherwise;
3. **NaN poisoning**: a non-finite row gradient on any rank poisons
   every exchanged row with NaN (a ``min``-reduced finite flag), so the
   train loop's nan-guard keeps firing;
4. **local scatter**: each rank keeps the rows in its table's row window
   (global id minus its shard's offset) and applies them through
   ``optimizer.sparse.apply_rows``, out-of-window rows dropped. The cost
   stays O(touched rows), flat in the vocab.

Multi-controller (core/mesh.py): the table is the rank's rows when a
plan placed it over the table axis, and every rank then updates its
window; a whole table (every rank holding it) takes every gathered row.
``ids`` and row gradients are the rank's.

The loss convention. JAX's :func:`sparse_ep_minimize_fn` differentiates
the global batch's loss, so each rank's row gradients carry the global
normalisation before the exchange sums them. The port keeps the
convention its Trainer set for an opaque loss under a plan: each rank
runs ``forward_loss`` on its rows (inside ``core.mesh.local_batch``), the
ranks' losses and dense gradients are averaged over the batch axes, and
the row gradients are divided by the batch axes' size before the
exchange, which sums them. For a mean loss over equal shards this is
the JAX step exactly.

Byte accounting: :func:`exchange_payload_bytes` is what one rank sends;
the port's updates run eagerly, so :func:`sparse_ep_update` itself
advances ``pt_collective_bytes_total{compressed=}`` by it
(:func:`record_exchange_bytes`) when telemetry is on, where the JAX
package's traced step leaves that to its caller."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core.enforce import enforce
from ..core.mesh import get_mesh, local_batch, mesh_scope
from ..core.random import fold_in
from ..optimizer.sparse import apply_rows, find_sparse_embeddings, merge_rows
from ..quant.collectives import MIN_COMPRESS_SIZE, record_payload_bytes
from ..quant.ops import absmax_decode, absmax_encode


# ---------------------------------------------------------------------------
# payload-byte accounting
# ---------------------------------------------------------------------------


def exchange_payload_bytes(num_ids: int, dim: int, batch_axis_size: int,
                           *, compressed: bool) -> int:
    """Bytes ONE rank moves all-gathering its (ids, rows) payload over a
    ``batch_axis_size`` ring: (n-1) forwarding hops of its own chunk,
    int32 ids + int8 rows + one float32 scale per row when compressed,
    float32 rows otherwise. 0 on a degenerate axis (nothing crosses the
    wire)."""
    n = int(batch_axis_size)
    if n <= 1:
        return 0
    ids_bytes = int(num_ids) * 4
    if compressed:
        row_bytes = int(num_ids) * (int(dim) + 4)  # int8 rows + f32 scale
    else:
        row_bytes = int(num_ids) * int(dim) * 4
    return (n - 1) * (ids_bytes + row_bytes)


def dense_grad_bytes(vocab: int, dim: int, axis_size: int) -> int:
    """The counterfactual this module avoids: ring-allreducing the dense
    (V, D) float32 table gradient over ``axis_size`` ranks,
    2*(n-1)*ceil(V*D/n)*4 bytes a rank a step."""
    n = int(axis_size)
    if n <= 1:
        return 0
    size = int(vocab) * int(dim)
    return 2 * (n - 1) * (-(-size // n)) * 4


def record_exchange_bytes(num_ids: int, dim: int, batch_axis_size: int,
                          *, compressed: bool) -> int:
    """Advance ``pt_collective_bytes_total`` by one step's payload
    (nothing when telemetry is off). Returns the bytes."""
    b = exchange_payload_bytes(num_ids, dim, batch_axis_size,
                               compressed=compressed)
    if compressed:
        record_payload_bytes(b, 0)
    else:
        record_payload_bytes(0, b)
    return b


def should_compress(ids_size: int, batch_axis_size: int, dim: int,
                    *, min_size: int = MIN_COMPRESS_SIZE) -> bool:
    """The tiny-payload float32 fallback gate: int8 where a rank's row
    payload (``ids_size`` global ids over ``batch_axis_size`` ranks,
    ``dim`` wide) has at least ``min_size`` elements."""
    per_shard = -(-int(ids_size) // max(1, int(batch_axis_size)))
    return per_shard * int(dim) >= min_size


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------


def exchange_rows(uids, rows, axis_name, *, compress: bool = True,
                  key=None, mesh=None):
    """All-gather this rank's merged (ids, rows) over ``axis_name`` (a
    name, a tuple of names, or None), the SelectedRows wire.

    ``uids``: (K,) int ids (out-of-vocab fill slots welcome: the scatter
    drops them); ``rows``: (K, D). Returns ``(all_ids (n*K,), all_rows
    (n*K, D) float32)``, the same on every rank of the axis, in axis
    order. ``axis_name=None`` skips the wire but keeps the poison and
    compression numerics, so results do not depend on the mesh shape.
    ``key`` (JAX key data) rounds the int8 payload stochastically (fold
    a per-rank key in the caller). ``mesh``: the current mesh when
    None."""
    from ..parallel.collective import allgather, allreduce

    rows = rows.float()
    ok = torch.isfinite(rows).all().to(torch.int32).reshape(1)
    if axis_name is not None:
        ok = allreduce(ok, axis_name, "min", mesh=mesh)
    if compress:
        q, sc = absmax_encode(rows, axis=1, key=key)
        if axis_name is not None:
            q = allgather(q, axis_name, mesh=mesh)
            sc = allgather(sc, axis_name, mesh=mesh)
        all_rows = absmax_decode(q, sc)
    else:
        all_rows = (allgather(rows, axis_name, mesh=mesh)
                    if axis_name is not None else rows)
    wire = uids.to(torch.int32)
    all_ids = (allgather(wire, axis_name, mesh=mesh)
               if axis_name is not None else wire).long()
    # non-finite anywhere: poison every exchanged row
    all_rows = torch.where(ok > 0, all_rows,
                           all_rows.new_full((), float("nan")))
    return all_ids, all_rows


def _batch_axes(mesh, batch_axis) -> Optional[Tuple[str, ...]]:
    """The axes of ``batch_axis`` (a name or names) that the mesh has
    with more than one rank; None when there are none."""
    if batch_axis is None:
        return None
    names = (batch_axis,) if isinstance(batch_axis, str) else batch_axis
    axes = tuple(a for a in names if int(mesh.shape.get(a, 1)) > 1)
    return axes or None


def sparse_ep_update(optimizer, table, ids, row_grads, leaf_state,
                     lr, step, *, mesh=None, table_axis: str = "ep",
                     batch_axis: Optional[str] = "dp",
                     compress: Optional[bool] = None, key=None
                     ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One row-sparse update of an ep-sharded ``table``, in place: local
    MergeAdd, the (ids, rows) exchange over ``batch_axis`` (a name or
    names; None for ids every rank holds alike), the rank's window
    applied through the optimizer's ``update_leaf`` rule.

    - ``table``: the rank's rows (placed ``P(table_axis, None)``), or a
      whole table;
    - ``ids``: the rank's ids (any int shape); ``row_grads``:
      ``ids.shape + (D,)``;
    - ``leaf_state``: the table's optimizer state (``init_leaf``);
      leaves with the table's leading dim are per-row and lie like it;
    - ``compress=None`` applies :func:`should_compress`.

    Returns ``(table, leaf_state)``, the same objects. The dense (V, D)
    gradient exists on no rank and on no wire. Raises where ``mesh``
    (default: the placed table's, else the current one) has no
    ``table_axis`` or its size does not divide the vocab."""
    from ..parallel.sharded_embedding import row_layout

    layout, vocab, rows, offset, mesh = row_layout(table, table_axis, mesh)
    enforce(layout is table, "sparse_ep_update updates a table placed "
            "by rows over %r, or a whole one; this one is placed under %s",
            table_axis, getattr(table, "_pt_sharding", None))
    dim = table.shape[1]
    axes = _batch_axes(mesh, batch_axis)
    n_b = mesh.axis_size(axes) if axes else 1
    if compress is None:
        compress = should_compress(ids.numel() * n_b, n_b, dim)
    # 1. local MergeAdd before the wire (fill slots carry id == vocab:
    #    outside every window, dropped by the scatter)
    uids, merged = merge_rows(ids, row_grads, vocab)
    k = None
    if key is not None:
        k = fold_in(key, mesh.axis_index(table_axis))
        for a in axes or ():
            k = fold_in(k, mesh.axis_index(a))
    # 2./3. the exchange and the poison
    all_ids, all_rows = exchange_rows(uids, merged, axes, compress=compress,
                                      key=k, mesh=mesh)
    record_exchange_bytes(ids.numel(), dim, n_b, compressed=compress)
    # 4. localize to this rank's window and scatter-update
    loc = all_ids - offset
    loc = torch.where((loc >= 0) & (loc < rows), loc,
                      torch.full_like(loc, rows))
    lr = torch.as_tensor(lr, dtype=torch.float32)
    return apply_rows(optimizer, table, loc, all_rows, leaf_state, lr,
                      int(step))


# ---------------------------------------------------------------------------
# the train-step builder (the ep counterpart of
# optimizer.sparse.sparse_minimize_fn)
# ---------------------------------------------------------------------------


def _leaf(v):
    """A detached alias of ``v`` that requires grad and keeps a placed
    leaf's sharding (so a layer still gathers it at use)."""
    out = v.detach().requires_grad_()
    sh = getattr(v, "_pt_sharding", None)
    if sh is not None:
        out._pt_sharding = sh
        out._pt_global_shape = v._pt_global_shape
    return out


def _mean_over(grads, params, axes, mesh):
    """Each gradient's mean over the batch ``axes``: summed over those its
    parameter's spec does not split (a gathered leaf's backward summed it
    over those it does), then divided by their size."""
    from ..parallel.collective import sum_over

    names = list(grads)
    split = [set(params[k]._pt_sharding.axes())
             if getattr(params[k], "_pt_sharding", None) is not None
             else set() for k in names]
    summed = sum_over([grads[k] for k in names],
                      lambda i: tuple(a for a in axes if a not in split[i]),
                      mesh)
    n = mesh.axis_size(axes)
    return {k: g / n for k, g in zip(names, summed)}


def sparse_ep_minimize_fn(model, forward_loss: Callable, optimizer, *,
                          plan=None, mesh=None, table_axis: str = "ep",
                          batch_axis: Optional[str] = "dp",
                          emb_optimizer=None,
                          compress: Optional[bool] = None, key=None):
    """Build ``(init_fn, step_fn)`` where every ``is_sparse`` embedding
    table updates through :func:`sparse_ep_update` (the sparse exchange
    over the plan's mesh) and the dense remainder through
    ``optimizer.apply``. The contract of
    ``optimizer.sparse.sparse_minimize_fn``::

        state = init_fn(params)
        loss, params, state = step_fn(params, state, *batch)

    ``params``: the model's parameters by name, placed by ``plan``
    (``plan.place``: registered tables the rank's rows); ``*batch``:
    the rank's rows (``plan.batch_sharding().local``).
    ``forward_loss(params, *batch)`` runs the model through
    ``functional_call`` on them; the step follows the module docstring's
    loss convention (the ranks' mean) and updates ``params`` and
    ``state`` in place. ``batch_axis=None`` treats the batch as one
    every rank holds alike (no exchange, no average). ``mesh``: the
    mesh without a plan (default the current one)."""
    from ..nn.sparse import Capture

    embs = find_sparse_embeddings(model)
    enforce(embs, "sparse_ep_minimize_fn: model has no is_sparse "
            "embeddings — use optimizer.minimize_fn / "
            "sparse_minimize_fn instead")
    emb_names = set(embs)
    eopt = emb_optimizer or optimizer
    layer_ids = {id(l) for l in embs.values()}
    by_layer = {id(l): n for n, l in embs.items()}

    def the_mesh():
        return plan.mesh if plan is not None else (mesh or get_mesh())

    def init_fn(params: Dict[str, Any]) -> Dict[str, Any]:
        dense = {k: v for k, v in params.items() if k not in emb_names}
        sparse = {}
        for n in emb_names:
            st = eopt.init_leaf(params[n])
            sh = getattr(params[n], "_pt_sharding", None)
            if sh is not None:
                from ..parallel.sharding import mark

                for t in st.values():
                    if torch.is_tensor(t) and t.shape == params[n].shape:
                        mark(t, sh, params[n]._pt_global_shape)
            sparse[n] = st
        return {"dense": optimizer.init(dense), "sparse": sparse}

    def step_fn(params, state, *args, **kwargs):
        from ..parallel.collective import allreduce

        m = the_mesh()
        axes = (None if batch_axis is None else
                tuple(a for a in m.batch_axes if int(m.shape[a]) > 1))
        n_b = m.axis_size(axes) if axes else 1
        dense = {k: v for k, v in params.items() if k not in emb_names}
        leaves = {k: _leaf(v) for k, v in dense.items()}
        cap = Capture(layer_ids)
        with mesh_scope(m), local_batch(), cap:
            loss = forward_loss({**params, **leaves}, *args, **kwargs)
        slots = list(cap.owner)
        grads = torch.autograd.grad(
            loss, list(leaves.values()) + [cap.rows[s] for s in slots],
            allow_unused=True)
        g_dense = {k: (g if g is not None else torch.zeros_like(v))
                   for (k, v), g in zip(dense.items(), grads)}
        g_rows = dict(zip(slots, grads[len(leaves):]))
        loss = loss.detach()
        if axes:
            g_dense = _mean_over(g_dense, dense, axes, m)
            loss = allreduce(loss, axes, "mean", mesh=m)

        step = state["dense"]["step"]
        optimizer.apply(dense, g_dense, state["dense"])
        lr = eopt.schedule(step)
        for slot in slots:
            name = by_layer[cap.owner[slot]]
            g = g_rows[slot]
            if g is None:
                g = torch.zeros_like(cap.rows[slot])
            sparse_ep_update(eopt, params[name], cap.ids[slot], g / n_b,
                             state["sparse"][name], lr, step, mesh=m,
                             table_axis=table_axis, batch_axis=axes,
                             compress=compress, key=key)
        return loss, params, state

    return init_fn, step_fn
