"""Row-sparse optimizer updates — the SelectedRows update path
(counterpart of paddle_tpu/optimizer/sparse.py).

Capability lineage: the reference's sparse gradients are SelectedRows
(reference: framework/selected_rows.h:32) emitted by
lookup_table_op.cc (is_sparse=True); duplicate rows are merged by
operators/math/selected_rows_functor.cc (MergeAdd) and the optimizer ops
carry dedicated sparse branches that update only the touched rows
(reference: operators/optimizers/adam_op.h SelectedRows branch with
lazy_mode).

The ids are merged into a fixed number of slots (the id count n) with a
sort, so nothing is read back to the host: the distinct ids in sorted
order, then the fill value V (the JAX package's ``jnp.unique(size=n,
fill_value=V)``), and duplicate gradients summed with ``index_add_``
(``segment_sum``). The rows of the table and of each per-row state leaf
are gathered into fresh tensors, the optimizer's ordinary
``update_leaf`` rule runs on them, and they are written back; slots
whose id lies outside the table (the fill slots, ids >= V) are dropped,
as the JAX scatter's ``mode="drop"`` drops them, and a negative id
wraps to id + V, as JAX's indexing wraps it. A step is O(batch x fields
x D), flat in the vocab. Untouched rows keep their parameters and
their accumulators: the reference's lazy_mode.

On the card ``index_add_`` sums a row's duplicates with atomics in no
fixed order, so the merged gradient of a repeated id can differ in its
last bits between two runs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..core.enforce import enforce


def merge_rows(ids, row_grads, vocab_size: int):
    """MergeAdd (reference: selected_rows_functor.cc): flatten and merge
    duplicate ids. Returns (uids (N,), merged (N, D)) where slots past
    the number of distinct ids hold ``vocab_size`` (out of bounds — the
    write-back drops them) and zero gradients."""
    ids = ids.reshape(-1).long()
    n = ids.shape[0]
    row_grads = row_grads.reshape(n, -1)
    sorted_ids, order = torch.sort(ids)
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(first, 0) - 1              # each sorted id's slot
    uids = torch.full_like(sorted_ids, vocab_size)
    uids.scatter_(0, seg, sorted_ids)             # duplicates write alike
    merged = torch.zeros_like(row_grads).index_add_(
        0, seg, row_grads.index_select(0, order))
    return uids, merged


def _rowwise(leaf, vocab: int) -> bool:
    return (torch.is_tensor(leaf) and leaf.ndim >= 1
            and leaf.shape[0] == vocab)


@torch.no_grad()
def apply_rows(optimizer, table, ids, row_grads,
               leaf_state: Dict[str, Any], lr, step
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One row-sparse update of ``table`` with ``optimizer``'s ordinary
    update_leaf rule applied to the touched rows only, in place; returns
    ``(table, leaf_state)``, the same objects.

    ``ids``: an int tensor (any shape); ``row_grads``: ids.shape + (D,).
    State leaves whose leading dim equals the vocab are per-row
    accumulators (Adam moments, Adagrad accumulator, momentum
    velocity); anything else passes to the rule as it is."""
    vocab = table.shape[0]
    uids, merged = merge_rows(ids, row_grads, vocab)
    merged = merged.to(table.dtype)
    idx = torch.where(uids < 0, uids + vocab, uids)
    keep = (idx >= 0) & (idx < vocab)
    safe = idx.clamp(0, vocab - 1)
    # a dropped slot writes the first kept slot's row back to that row,
    # the same value as the kept slot's own write, so the copy is exact
    # in any order and needs no count of the kept slots on the host (with
    # no kept slot at all it writes the first slot's row unchanged)
    lead = torch.argmax(keep.to(torch.int8)).reshape(1)
    target = torch.where(keep, safe, safe.index_select(0, lead))

    def gather(leaf):
        raw = leaf.index_select(0, safe)
        rows = torch.where(keep.reshape((-1,) + (1,) * (raw.ndim - 1)),
                           raw, raw.new_zeros(()))
        return raw, rows

    def put(leaf, raw, new):
        shape = (-1,) + (1,) * (new.ndim - 1)
        anchor = torch.where(keep.index_select(0, lead).reshape(shape),
                             new.index_select(0, lead),
                             raw.index_select(0, lead))
        leaf.index_copy_(0, target,
                         torch.where(keep.reshape(shape), new, anchor))

    raw_p, p_rows = gather(table)
    raws, s_rows = {}, {}
    for k, v in leaf_state.items():
        if _rowwise(v, vocab):
            raws[k], s_rows[k] = gather(v)
        else:
            s_rows[k] = v
    optimizer.update_leaf(p_rows, merged, s_rows, lr, step)
    put(table, raw_p, p_rows)
    for k, raw in raws.items():
        put(leaf_state[k], raw, s_rows[k])
    for k, v in s_rows.items():
        if k not in raws:
            leaf_state[k] = v
    return table, leaf_state


def find_sparse_embeddings(model) -> Dict[str, Any]:
    """{param name -> layer} for every is_sparse embedding in ``model``."""
    out = {}
    for name, sub in model.named_modules():
        if getattr(sub, "is_sparse", False) and hasattr(sub, "weight"):
            out[f"{name}.weight" if name else "weight"] = sub
    return out


def sparse_minimize_fn(model, forward_loss: Callable, optimizer,
                       emb_optimizer=None):
    """Build ``(init_fn, step_fn)`` where embedding tables flagged
    ``is_sparse`` get row-sparse updates and everything else follows the
    ordinary dense ``optimizer.apply``.

    - ``forward_loss(params, *args, **kwargs) -> scalar loss`` must run
      the model through ``model.functional_call`` with ``params``, so
      the sparse layers see the step's capture context and the dense
      parameters' gradients reach the step.
    - ``emb_optimizer`` optionally uses a different rule for the tables
      (reference: PS deployments pair sparse Adagrad tables with dense
      Adam); defaults to ``optimizer``.

    Returned contract::

        state = init_fn(params)
        loss, params, state = step_fn(params, state, *args)

    ``step_fn`` updates the tensors of ``params`` and ``state`` in place
    (as ``Optimizer.apply`` does) and returns the same dicts, with the
    loss detached. As in the JAX package, the tables' rule reads the
    step count before the dense update advances it, and each call slot
    of a table is applied in turn."""
    from ..nn.sparse import Capture

    embs = find_sparse_embeddings(model)
    enforce(embs, "sparse_minimize_fn: model has no is_sparse embeddings "
            "— use optimizer.minimize_fn instead")
    emb_names = set(embs)
    eopt = emb_optimizer or optimizer
    layer_ids = {id(l) for l in embs.values()}
    by_layer = {id(l): n for n, l in embs.items()}

    def init_fn(params: Dict[str, Any]) -> Dict[str, Any]:
        dense = {k: v for k, v in params.items() if k not in emb_names}
        return {
            "dense": optimizer.init(dense),
            "sparse": {n: eopt.init_leaf(params[n]) for n in emb_names},
        }

    def step_fn(params, state, *args, **kwargs):
        dense = {k: v for k, v in params.items() if k not in emb_names}
        # leaves that alias the dense tensors, for the gradient
        leaves = {k: v.detach().requires_grad_() for k, v in dense.items()}
        cap = Capture(layer_ids)
        with cap:
            loss = forward_loss({**params, **leaves}, *args, **kwargs)
        slots = list(cap.owner)
        grads = torch.autograd.grad(
            loss, list(leaves.values()) + [cap.rows[s] for s in slots],
            allow_unused=True)
        g_dense = {k: (g if g is not None else torch.zeros_like(v))
                   for (k, v), g in zip(dense.items(), grads)}
        g_rows = dict(zip(slots, grads[len(leaves):]))

        step = state["dense"]["step"]
        optimizer.apply(dense, g_dense, state["dense"])
        lr = eopt.schedule(step)
        for slot in slots:
            name = by_layer[cap.owner[slot]]
            g = g_rows[slot]
            if g is None:
                g = torch.zeros_like(cap.rows[slot])
            apply_rows(eopt, params[name], cap.ids[slot], g,
                       state["sparse"][name], lr, step)
        return loss.detach(), params, state

    return init_fn, step_fn
