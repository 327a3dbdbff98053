"""Hot-row working-set cache, the eviction substrate of the sharded
embedding plane (counterpart of paddle_tpu/embedding/cache.py; plain
numpy, a copy of the JAX package's own so the port imports none of it).

The reference's parameter-server tables keep the authoritative rows on
the PS fleet and prefetch the batch's rows into trainer memory
(reference: operators/distributed/parameter_prefetch.cc); here the
split is host memory (authoritative) against the card (working set),
and this cache decides WHICH rows stay on the card.

:class:`RowCache` maps integer row ids to fixed slots of a working-set
array with the clock (second-chance) approximation of LRU: every
admitted id sets its slot's reference bit; the clock hand clears bits
as it sweeps and evicts the first unreferenced slot. O(1) amortized per
id, and the eviction order is deterministic (the JAX package's, slot
for slot). Thread-safe: one lock around the id->slot map and the clock
state (the prefetch thread and the training thread both admit).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.enforce import enforce


class RowCache:
    """Clock (second-chance LRU) cache of integer row ids over
    ``capacity`` fixed slots.

    - :meth:`admit` is the one mutating entry: every requested id ends
      up resident and gets a slot; misses claim free slots first, then
      evict via the clock sweep. Ids admitted in the same call are
      protected from each other's evictions.
    - :meth:`slots_of` is the read-only mapping (``-1`` for absent).
    - ``hits`` / ``misses`` / ``evictions`` count cumulatively; the
      telemetry counters of :class:`..host_table.HostBackedTable` are
      advanced from these.
    """

    def __init__(self, capacity: int):
        enforce(capacity >= 1, "RowCache capacity must be >= 1, got %s",
                capacity)
        self.capacity = int(capacity)
        self._slot_of: Dict[int, int] = {}
        self._ids = np.full(self.capacity, -1, np.int64)  # slot -> id
        self._ref = np.zeros(self.capacity, bool)  # second-chance bits
        self._hand = 0
        self._free = list(range(self.capacity - 1, -1, -1))
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._slot_of)

    def __contains__(self, row_id: int) -> bool:
        with self._lock:
            return int(row_id) in self._slot_of

    def slots_of(self, ids) -> np.ndarray:
        """Slot of each id (-1 when not resident). Read-only: counters
        and reference bits stay untouched."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        with self._lock:
            return np.asarray([self._slot_of.get(int(i), -1)
                               for i in ids], np.int64)

    def _evict_one(self, protected) -> Tuple[int, int]:
        """Clock sweep: clear reference bits until an unreferenced,
        unprotected slot comes up; evict it. Returns (slot, victim id).
        """
        for _ in range(4 * self.capacity):
            s = self._hand
            self._hand = (self._hand + 1) % self.capacity
            if s in protected:
                continue
            if self._ref[s]:
                self._ref[s] = False
                continue
            victim = int(self._ids[s])
            del self._slot_of[victim]
            self._ids[s] = -1
            self.evictions += 1
            return s, victim
        raise AssertionError("RowCache clock made 4 full sweeps without "
                             "finding a victim (capacity exhausted by "
                             "one batch?)")

    def admit(self, ids) -> Tuple[np.ndarray, np.ndarray, List[int]]:
        """Make every id resident. Returns ``(slots, was_miss,
        evicted_ids)`` — ``slots[i]`` is where ``ids[i]`` now lives,
        ``was_miss[i]`` marks ids the caller must fill (fetch the row
        into the working set at that slot), ``evicted_ids`` lists rows
        that lost their slot this call (write-through callers need no
        write-back; a dirty-row caller would flush these).

        ``ids`` should be deduplicated; a batch of distinct ids larger
        than ``capacity`` is refused (it cannot be co-resident).
        """
        ids = np.asarray(ids, np.int64).reshape(-1)
        enforce(ids.size <= self.capacity,
                "batch of %s distinct ids exceeds cache capacity %s",
                ids.size, self.capacity)
        slots = np.empty(ids.size, np.int64)
        was_miss = np.zeros(ids.size, bool)
        evicted: List[int] = []
        with self._lock:
            protected = set()
            for i, rid in enumerate(int(r) for r in ids):
                enforce(rid >= 0, "row id must be >= 0, got %s", rid)
                s = self._slot_of.get(rid)
                if s is None:
                    self.misses += 1
                    was_miss[i] = True
                    if self._free:
                        s = self._free.pop()
                    else:
                        s, victim = self._evict_one(protected)
                        evicted.append(victim)
                    self._slot_of[rid] = s
                    self._ids[s] = rid
                else:
                    self.hits += 1
                self._ref[s] = True
                protected.add(s)
                slots[i] = s
        return slots, was_miss, evicted

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "capacity": self.capacity,
                "resident": len(self._slot_of),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": (self.hits / total) if total else 0.0,
            }
