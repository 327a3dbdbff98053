"""Host-backed giant embedding tables: authoritative rows in host memory,
hot rows on the card (counterpart of paddle_tpu/embedding/host_table.py).

The reference serves 10^8-row tables from a parameter-server fleet and
pulls the batch's rows into trainer memory per step (reference:
framework/fleet/fleet_wrapper.h:55 PullSparseVarsSync,
operators/distributed/parameter_prefetch.cc). Host memory is the
parameter server here: a :class:`HostBackedTable` keeps the whole (V, D)
table as a numpy array and a ``(capacity, D)`` working set on its device,
whose rows :class:`.cache.RowCache` chooses (clock / second-chance LRU).

Data plane per step (host-driven, the feeding layer):

1. :meth:`prefetch` dedups the NEXT batch's ids, admits them into the
   cache and copies only the missing rows into their slots.
   ``data.DevicePrefetcher`` calls it from its staging thread
   (``prefetch_rows=``), so the row copies overlap the current step.
2. :meth:`lookup` maps ids to slots and gathers from the working set.
3. :meth:`update` writes through: the host array (authoritative) and any
   resident slot, so eviction never loses a write.

On the card the missing rows go from pinned host memory in one
non-blocking copy. The two threads' calls are ordered on the host by one
lock (slot assignment and the fill must be atomic together); on the card
every working-set operation first makes its stream wait on an event that
the previous one recorded, so a lookup on the training thread's stream
never reads a slot before the prefetch thread's copy into it has landed,
and a fill never overwrites a slot a queued lookup still reads.

Counters (``pt_embedding_cache_{hits,misses,evictions}_total``,
``pt_embedding_prefetched_rows_total``) advance per call when telemetry
is on; :meth:`statusz` is a ready-made debug-server section.
:meth:`save`/:meth:`load` write and read the host rows through
``checkpoint.save_state``/``restore_state`` (:meth:`load` also takes a
table a plan saved per host, its ``ep`` regions assembled; an ep-placed
table restores onto another ``ep`` shape, or a dense one onto an ep
plan, through ``restore_state(mesh=)`` or ``shardings=``), and
:meth:`from_array` ingests a table trained on the card, a plan's placed
shard included (gathered over its axis first)."""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import telemetry
from ..core.dtypes import to_dtype
from ..core.enforce import enforce
from ..core.places import resolve_device
from .cache import RowCache


@telemetry.cached_instruments
def _emb_metrics(reg):
    """The embedding plane's counters (reached only when telemetry is
    on)."""
    return {
        "hits": reg.counter(
            "pt_embedding_cache_hits_total",
            "host-backed table lookups served from the on-chip "
            "working set"),
        "misses": reg.counter(
            "pt_embedding_cache_misses_total",
            "host-backed table lookups that fetched rows host->chip"),
        "evictions": reg.counter(
            "pt_embedding_cache_evictions_total",
            "working-set rows evicted by the clock sweep"),
        "prefetched_rows": reg.counter(
            "pt_embedding_prefetched_rows_total",
            "rows staged host->chip by prefetch (the overlap path)"),
    }


class HostBackedTable:
    """(V, D) embedding table whose authoritative rows live in host
    memory, with a working set of ``capacity`` hot rows on ``device``
    (the card when None; ``"cpu"`` for a host working set).

    ``rows`` may be passed (any array-like, copied to a host numpy
    array) or drawn N(0, 1/sqrt(D)) from numpy's ``seed``, as the JAX
    package draws them. ``capacity`` bounds the device bytes at
    ``capacity * D * itemsize`` whatever ``V``."""

    def __init__(self, num_rows: int, dim: int, *, capacity: int,
                 dtype=torch.float32, rows: Optional[Any] = None,
                 seed: int = 0, name: str = "table", device=None):
        enforce(num_rows >= 1 and dim >= 1,
                "HostBackedTable needs num_rows/dim >= 1, got (%s, %s)",
                num_rows, dim)
        enforce(capacity >= 1, "capacity must be >= 1, got %s", capacity)
        self.num_rows, self.dim = int(num_rows), int(dim)
        self.name = name
        self._dtype = to_dtype(dtype)
        # the host mirror: float32 for a dtype numpy lacks (bfloat16)
        self._np_dtype = (np.dtype(np.float32)
                          if self._dtype == torch.bfloat16
                          else torch.empty((), dtype=self._dtype)
                          .numpy().dtype)
        if rows is not None:
            rows = np.asarray(rows, self._np_dtype)
            enforce(rows.shape == (self.num_rows, self.dim),
                    "rows shape %s != (%s, %s)", rows.shape,
                    self.num_rows, self.dim)
            self.rows = np.array(rows, copy=True)
        else:
            rng = np.random.default_rng(seed)
            self.rows = (rng.standard_normal((self.num_rows, self.dim))
                         / np.sqrt(self.dim)).astype(self._np_dtype)
        self.cache = RowCache(capacity)
        self.device = resolve_device(device)
        self._ws = torch.zeros((int(capacity), self.dim), dtype=self._dtype,
                               device=self.device)
        # the last working-set operation's event on the card (the module
        # docstring)
        self._done = None
        # one lock orders prefetch (the staging thread) against lookup
        # and update (the training thread): slot assignment and the fill
        # must be atomic together
        self._lock = threading.RLock()

    # -- the card's ordering -------------------------------------------------

    def _after_last(self):
        """Make the current stream wait for the previous working-set
        operation (caller holds the lock)."""
        if self._done is not None:
            torch.cuda.current_stream(self.device).wait_event(self._done)

    def _mark_done(self):
        if self.device.type == "cuda":
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(self.device))

    def _to_device(self, array: np.ndarray, dtype=None):
        """A host array on the working set's device: through pinned
        memory in a non-blocking copy on the card."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if dtype is not None:
            t = t.to(dtype)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- data plane ----------------------------------------------------------

    def _admit_and_fill(self, uids: np.ndarray) -> int:
        """Admit unique ids; copy the missing rows into their slots.
        Returns the number of misses. Caller holds the lock."""
        if uids.size == 0:
            return 0
        slots, was_miss, evicted = self.cache.admit(uids)
        n_miss = int(was_miss.sum())
        if n_miss:
            payload = self._to_device(self.rows[uids[was_miss]],
                                      self._dtype)
            where = self._to_device(slots[was_miss])
            self._after_last()
            self._ws.index_copy_(0, where, payload)
            self._mark_done()
        if telemetry.enabled():
            m = _emb_metrics()
            m["hits"].inc(int((~was_miss).sum()))
            m["misses"].inc(n_miss)
            if evicted:
                m["evictions"].inc(len(evicted))
        return n_miss

    def _check_ids(self, ids: np.ndarray) -> None:
        enforce(ids.size == 0 or (int(ids.min()) >= 0
                                  and int(ids.max()) < self.num_rows),
                "id out of range [0, %s) for table %r", self.num_rows,
                self.name)

    def prefetch(self, ids) -> int:
        """Stage the rows for ``ids`` (host ids: a numpy array, a list or
        a CPU tensor) onto the device ahead of use (the DevicePrefetcher
        hook). Returns the rows actually moved."""
        uids = np.unique(_host_ids(ids))
        self._check_ids(uids)
        with self._lock:
            n = self._admit_and_fill(uids)
        if n and telemetry.enabled():
            _emb_metrics()["prefetched_rows"].inc(n)
        return n

    def lookup(self, ids):
        """Rows for ``ids`` (any int shape, host ids) as a tensor
        ``ids.shape + (D,)`` on the device, gathered from the working set
        (missing rows are fetched first: a prefetched batch gathers
        without a host copy)."""
        arr = _host_ids(ids)
        flat = arr.reshape(-1)
        self._check_ids(flat)
        with self._lock:
            self._admit_and_fill(np.unique(flat))
            slots = self._to_device(self.cache.slots_of(flat))
            self._after_last()
            out = self._ws.index_select(0, slots)
            self._mark_done()
        return out.reshape(arr.shape + (self.dim,))

    def update(self, ids, new_rows) -> None:
        """Write-through row update: the host array is authoritative,
        resident working-set slots are patched in place, so eviction
        never loses data."""
        flat = _host_ids(ids).reshape(-1)
        self._check_ids(flat)
        if torch.is_tensor(new_rows):
            new_rows = new_rows.detach().float().cpu().numpy()
        vals = np.asarray(new_rows, self._np_dtype).reshape(
            flat.size, self.dim)
        with self._lock:
            self.rows[flat] = vals
            slots = self.cache.slots_of(flat)
            resident = slots >= 0
            if resident.any():
                payload = self._to_device(vals[resident], self._dtype)
                where = self._to_device(slots[resident])
                self._after_last()
                self._ws.index_copy_(0, where, payload)
                self._mark_done()

    # -- reporting -----------------------------------------------------------

    @property
    def host_bytes(self) -> int:
        return int(self.rows.nbytes)

    @property
    def device_bytes(self) -> int:
        return self._ws.numel() * self._ws.element_size()

    @property
    def hit_rate(self) -> float:
        return float(self.cache.stats()["hit_rate"])

    def statusz(self) -> Dict[str, Any]:
        """The ``/statusz`` embedding section: host-side fields only,
        safe to render on every scrape."""
        s = self.cache.stats()
        s.update({
            "name": self.name,
            "rows": self.num_rows,
            "dim": self.dim,
            "host_bytes": self.host_bytes,
            "device_bytes": self.device_bytes,
        })
        return s

    # -- checkpoint ----------------------------------------------------------

    def save(self, directory: str) -> None:
        """Write the authoritative host rows through the checkpoint plane
        (manifest, checksums, atomic commit)."""
        from .. import checkpoint

        checkpoint.save_state(directory, {"rows": self.rows})

    @classmethod
    def load(cls, directory: str, *, capacity: int, dtype=torch.float32,
             name: str = "table", device=None) -> "HostBackedTable":
        from .. import checkpoint

        rows = checkpoint.restore_state(directory)["rows"]
        rows = rows.numpy() if torch.is_tensor(rows) else np.asarray(rows)
        return cls(rows.shape[0], rows.shape[1], capacity=capacity,
                   dtype=dtype, rows=rows, name=name, device=device)

    @classmethod
    def from_array(cls, rows, *, capacity: int, dtype=torch.float32,
                   name: str = "table", device=None) -> "HostBackedTable":
        """Ingest an existing table (a tensor on any device or an array):
        e.g. to serve a table trained under ``Plan(ep=N)``. A plan's
        placed shard is gathered over its axes first (every rank of
        them takes part), as the JAX package's ``np.asarray`` of a
        sharded array is the whole table."""
        if torch.is_tensor(rows):
            from ..nn.layer import use

            with torch.no_grad():
                rows = use(rows).detach().float().cpu().numpy()
        host = np.asarray(rows)
        return cls(host.shape[0], host.shape[1], capacity=capacity,
                   dtype=dtype, rows=host, name=name, device=device)

    def __repr__(self):
        return (f"HostBackedTable({self.name!r}, rows={self.num_rows}, "
                f"dim={self.dim}, capacity={self.cache.capacity}, "
                f"resident={len(self.cache)})")


def _host_ids(ids) -> np.ndarray:
    """``ids`` as a host int64 array (a card tensor is read back)."""
    if torch.is_tensor(ids):
        ids = ids.detach().cpu().numpy()
    return np.asarray(ids, np.int64)
