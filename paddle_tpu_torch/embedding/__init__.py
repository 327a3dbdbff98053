"""The sharded embedding plane (counterpart of paddle_tpu/embedding):
giant tables on the port's plans, three planes over one table.

- **on the card, sharded**: ``Plan(ep=N, tables=[...])`` row-shards the
  registered tables over the ``ep`` mesh axis; the forward is
  ``parallel.sharded_embedding_lookup`` (the rank's rows, one sum over
  the axis) and the sparse step is :func:`exchange.sparse_ep_update`:
  (unique ids, int8 rows) on the wire, never the dense (V, D) gradient.
- **host-backed**: :class:`host_table.HostBackedTable` keeps the
  authoritative rows in host memory, with a working set of hot rows on
  the card chosen by :class:`cache.RowCache` (clock / second-chance
  LRU) and prefetched by the data plane
  (``DevicePrefetcher(prefetch_rows=...)``).
- **durable**: a host-backed table saves and loads its rows through
  ``paddle_tpu_torch.checkpoint``; an ep-placed table is saved per host
  and restores across ``ep`` shapes (``restore_state(mesh=)``).
"""

from .cache import RowCache
from .host_table import HostBackedTable
from .exchange import (dense_grad_bytes, exchange_payload_bytes,
                       exchange_rows, record_exchange_bytes,
                       should_compress, sparse_ep_minimize_fn,
                       sparse_ep_update)
from ..parallel.sharded_embedding import (ShardedEmbedding,
                                          embedding_ep_rules,
                                          sharded_embedding_lookup)

__all__ = [
    "RowCache",
    "HostBackedTable",
    "ShardedEmbedding",
    "dense_grad_bytes",
    "embedding_ep_rules",
    "exchange_payload_bytes",
    "exchange_rows",
    "record_exchange_bytes",
    "sharded_embedding_lookup",
    "should_compress",
    "sparse_ep_minimize_fn",
    "sparse_ep_update",
]
