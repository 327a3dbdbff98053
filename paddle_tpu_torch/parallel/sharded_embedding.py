"""Sharded embedding tables (counterpart of
paddle_tpu/parallel/sharded_embedding.py).

Capability lineage: the reference shards giant embedding tables across
parameter servers and prefetches rows over RPC (reference:
operators/distributed/parameter_prefetch.cc,
transpiler/distribute_lookup_table.py). Here a table is row-sharded over
a mesh axis ('ep'): each rank holds V/ep rows, gathers the ids that fall
in its rows (the others read as exact zeros) and one sum over the axis
gives every rank the looked-up rows.

Multi-controller (core/mesh.py): a table that a sharding plan placed
over the axis (``P(axis, None)``, parallel/sharding.py ``place``) is the
rank's rows and the lookup computes on them; it is never gathered. A
whole table, which every rank holds, is gathered locally. ``ids`` are
the rank's ids (its rows of the batch, the same on the ``ep`` ranks of
one batch shard); the output is the rank's rows of the lookup.

Gradient scale. The JAX lookup is a ``shard_map`` with
``check_vma=False`` whose output is unmapped over ``ep``; JAX's
transpose divides that output's cotangent by the ``ep`` size before
``psum``'s own psum transpose, so each table shard gets its rows'
gradient once. The port's ``allreduce`` keeps the psum-to-psum backward
(parallel/collective.py), which would give every shard ``ep`` times its
gradient, since the loss sees the same output on every ``ep`` rank. The
lookup therefore sums over the axis with ``reduce_from_tp`` (the sum
forward, the identity backward): each shard's gradient is the plain
scatter-add of its rows.

Out-of-vocab ids. JAX checks only concrete ids (eager calls). The port's
calls are all eager, so it always checks: one min/max read of the ids
per lookup, which on the card is one host sync."""

from __future__ import annotations

import re
from typing import Optional

import torch

from .. import initializer as I
from ..core.enforce import InvalidArgumentError, enforce
from ..core.mesh import get_mesh
from ..core.sharding_types import NamedSharding, PartitionSpec as P
from ..nn.layer import Layer, use


def _check_ids_in_vocab(ids, vocab: int,
                        padding_idx: Optional[int] = None) -> None:
    """Raise :class:`InvalidArgumentError` when an id lies outside [0,
    ``vocab``): it would otherwise sum to a silent all-zeros row.
    ``padding_idx`` ids are exempt (an out-of-range pad like -1 is a
    convention). One fused min/max read of the ids."""
    if ids.numel() == 0:
        return
    check = ids if padding_idx is None else torch.where(
        ids == padding_idx, torch.zeros_like(ids), ids)
    lo, hi = torch.stack(torch.aminmax(check.reshape(-1))).tolist()
    if lo < 0 or hi >= vocab:
        raise InvalidArgumentError(
            f"embedding ids span [{lo}, {hi}] but the table has "
            f"{vocab} rows — out-of-vocab ids are an error, not a "
            f"clip (hash or bucket ids upstream, or grow the table)")


def row_layout(table, axis: str, mesh=None):
    """How ``table`` lies over ``axis``: ``(table, vocab, rows, offset,
    mesh)``. A table placed with its rows over ``axis`` alone is the
    rank's ``rows`` of the ``vocab``, starting at global row ``offset``;
    any other table is taken whole (a table placed under another spec is
    gathered at use), ``rows == vocab`` and ``offset == 0``. ``mesh``:
    the placed table's own mesh when None, else the current mesh. Raises
    where the mesh has no ``axis`` or its size does not divide the
    vocab."""
    sh = getattr(table, "_pt_sharding", None)
    mesh = mesh or (sh.mesh if sh is not None else get_mesh())
    enforce(axis in mesh.shape, "mesh has no %r axis (axes: %s)", axis,
            tuple(mesh.shape))
    n = int(mesh.shape[axis])
    if sh is not None and (tuple(sh.spec)[:1] != (axis,)
                           or any(p is not None for p in sh.spec[1:])):
        table, sh = use(table), None
    vocab = (table._pt_global_shape[0] if sh is not None
             else table.shape[0])
    enforce(vocab % n == 0,
            "vocab %s must divide %s axis size %s (pad the table)", vocab,
            axis, n)
    if sh is None or n == 1:
        return table, vocab, table.shape[0], 0, mesh
    rows = vocab // n
    return table, vocab, rows, mesh.axis_index(axis) * rows, mesh


def gather_rows(ids, table, *, axis: str, mesh=None):
    """The rows of ``table`` at the global ``ids``: a row shard (see
    :func:`row_layout`) gathers its in-shard ids (the others exact zeros)
    and sums over ``axis`` (identity backward, the module docstring); a
    whole table is gathered locally (an id outside it reads zeros, as
    it sums to zeros in the JAX package). No id check."""
    return _gather(ids, row_layout(table, axis, mesh), axis)


def _gather(ids, layout, axis):
    """The rows in the rank's window (ids outside it, an out-of-range pad
    included, read as exact zeros), summed over ``axis`` for a shard."""
    table, vocab, rows, offset, mesh = layout
    local = ids.long() - offset
    valid = (local >= 0) & (local < rows)
    got = torch.nn.functional.embedding(local.clamp(0, rows - 1), table)
    got = torch.where(valid[..., None], got, got.new_zeros(()))
    if rows == vocab:
        return got
    from .collective import reduce_from_tp

    return reduce_from_tp(got, axis, mesh=mesh)


def sharded_embedding_lookup(ids, table, *, axis: str = "ep",
                             batch_axis: Optional[str] = "dp", mesh=None,
                             padding_idx: Optional[int] = None):
    """Rows of a globally (V, D) table row-sharded over ``axis``, at the
    rank's ``ids`` (any int shape): ids.shape + (D,).

    ``table``: the rank's rows when placed over ``axis`` (the module
    docstring), else the whole table. ``batch_axis`` names the axis the
    ids split over, as in the JAX package; the rank's ids are taken as
    given. ``padding_idx`` rows come back as exact zeros; ids outside
    [0, V) raise :class:`InvalidArgumentError`, ``padding_idx`` ids
    exempt. Raises where ``mesh`` (default: the placed table's, else the
    current one) has no ``axis`` or its size does not divide V."""
    layout = row_layout(table, axis, mesh)
    _check_ids_in_vocab(ids, layout[1], padding_idx)
    out = _gather(ids, layout, axis)
    if padding_idx is not None:
        out = torch.where((ids == padding_idx)[..., None], out.new_zeros(()),
                          out)
    return out


class ShardedEmbedding(Layer):
    """Embedding whose table is row-sharded over a mesh axis ('ep'): the
    PSLib/Downpour giant-table capability (reference:
    distributed/downpour.py:24) without a parameter server.

    The weight is created whole (``weight_init``, default XavierNormal,
    drawn as the JAX package draws it); a sharding plan that registers
    it as a table (``Plan(ep=, tables=)``) or the rules of
    :func:`embedding_ep_rules` place the rank's rows, and the forward
    computes on them (:func:`sharded_embedding_lookup`), never gathering
    the table. ``is_sparse`` marks it for row-sparse updates
    (optimizer/sparse.py, embedding/exchange.py): under
    ``nn.sparse.Capture`` the rows are gathered off the graph by the
    sharded lookup and recorded as a leaf, under ``Inject`` given rows
    replace the lookup (padding rows zeroed)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 axis: str = "ep", padding_idx: Optional[int] = None,
                 weight_init=None, dtype=None, mesh=None,
                 batch_axis: Optional[str] = "dp",
                 is_sparse: bool = False, *, device=None, generator=None):
        super().__init__()
        self.axis = axis
        self.batch_axis = batch_axis
        self.padding_idx = padding_idx
        self._mesh = mesh
        self.is_sparse = is_sparse
        self.create_parameter("weight", (num_embeddings, embedding_dim),
                              dtype, weight_init or I.XavierNormal(),
                              device=device, generator=generator)

    def weight_sharding(self, mesh=None) -> NamedSharding:
        """The row-sharded placement (``P(axis, None)``): place the
        weight with it, or use it as the parameter's spec."""
        return NamedSharding(self._mesh or mesh or get_mesh(),
                             P(self.axis, None))

    def _lookup(self, ids):
        return sharded_embedding_lookup(
            ids, self.weight, axis=self.axis, mesh=self._mesh,
            batch_axis=self.batch_axis, padding_idx=self.padding_idx)

    def forward(self, ids):
        from ..nn.sparse import Capture, active

        ctx = active()
        if ctx is not None and ctx.handles(self):
            if isinstance(ctx, Capture):
                with torch.no_grad():
                    rows = self._lookup(ids)
                ctx.record(self, ids, rows.requires_grad_())
            else:
                rows = ctx.pop(self)
            if self.padding_idx is not None:
                rows = torch.where((ids == self.padding_idx)[..., None],
                                   rows.new_zeros(()), rows)
            return rows
        return self._lookup(ids)


def embedding_ep_rules(model: Layer, axis: str = "ep"):
    """Sharding rules placing every :class:`ShardedEmbedding` table of
    ``model`` on ``axis`` (``P(axis, None)``; compose with the plan's
    other rules)."""
    rules = []
    for name, sub in model.named_sublayers():
        if isinstance(sub, ShardedEmbedding):
            rules.append((re.escape(f"{name}.weight") + "$", P(axis, None)))
    return rules
