"""Sparse-gradient contexts for embedding layers (counterpart of
paddle_tpu/nn/sparse.py).

The SelectedRows capability (reference: framework/selected_rows.h:32,
lookup_table_op.cc is_sparse=True emits SelectedRows grads): a dense
gather's gradient is a (V, D) tensor, an O(V) materialization and an
O(V) optimizer update per step. A sparse train step
(optimizer/sparse.py) instead differentiates with respect to the rows
each sparse embedding gathers, O(batch x fields, D).

The JAX package runs the forward twice: a CAPTURE pass records the ids
(XLA removes the rest of it as dead code), the rows are gathered outside
the differentiated function, and an INJECT pass replays the forward
with them. PyTorch runs eagerly, where a second forward would cost as
much as the first, so here one CAPTURE pass does both: each sparse
embedding gathers its rows from the table without a graph, makes them a
leaf that requires grad, records ``(ids, rows)`` under its call slot and
returns them; one backward then gives the row gradients. ``Inject``
keeps the JAX package's replay of given rows, in the same call order.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

_STACK: List["_Ctx"] = []


def active() -> Optional["_Ctx"]:
    return _STACK[-1] if _STACK else None


class _Ctx:
    def __init__(self, layer_ids):
        self.layer_ids = set(layer_ids)
        self._order: Dict[int, int] = {}  # id(layer) -> call count

    def handles(self, layer) -> bool:
        return id(layer) in self.layer_ids

    def _slot(self, layer) -> str:
        k = id(layer)
        n = self._order.get(k, 0)
        self._order[k] = n + 1
        return f"{k}:{n}"

    def __enter__(self):
        _STACK.append(self)
        return self

    def __exit__(self, *exc):
        _STACK.pop()
        return False


class Capture(_Ctx):
    """Records (slot -> ids), (slot -> owner layer id) and, from the
    one-pass gather, (slot -> rows) for every sparse-embedding call."""

    def __init__(self, layer_ids):
        super().__init__(layer_ids)
        self.ids: Dict[str, Any] = {}
        self.owner: Dict[str, int] = {}  # slot -> id(layer)
        self.rows: Dict[str, Any] = {}

    def record(self, layer, ids, rows=None):
        slot = self._slot(layer)
        self.ids[slot] = ids
        self.owner[slot] = id(layer)
        if rows is not None:
            self.rows[slot] = rows
        return slot


class Inject(_Ctx):
    """Replays pre-gathered rows in the same call order."""

    def __init__(self, layer_ids, rows: Dict[str, Any]):
        super().__init__(layer_ids)
        self.rows = rows

    def pop(self, layer):
        return self.rows[self._slot(layer)]
