"""Sequence packing and bucket boundaries (counterpart of
paddle_tpu/data/bucketing.py ``pack_sequences`` and ``round_to_bucket``):
numpy only, copied here so that the port never imports the JAX package.
The rest of that module (length bucketing) comes with the data layer,
ROADMAP queue 1 item 12."""

from __future__ import annotations

from typing import Callable, Iterator, List

import numpy as np

from ..core.enforce import enforce


def round_to_bucket(n: int, buckets) -> int:
    """Round a length up to its bucket boundary: "pow2" -> the next
    power of two; an ascending list -> the first boundary >= n; beyond
    the last boundary, n unchanged."""
    if buckets is None:
        return n
    if buckets == "pow2":
        b = 1
        while b < n:
            b *= 2
        return b
    for bound in buckets:
        if n <= bound:
            return int(bound)
    return n


def pack_sequences(reader: Callable[[], Iterator], capacity: int,
                   batch_size: int, pad_value=0,
                   min_fill: float = 0.0) -> Callable[[], Iterator]:
    """Greedy sequence PACKING — the padding-free dual of bucketing.

    Multiple variable-length sequences share one fixed-length row of
    ``capacity`` tokens; attention stays correct via the emitted
    per-token segment ids (ops.attention segment_ids → the flash
    kernels' packed-batch path). Bucketing bounds recompilation by
    padding each sample up; packing removes the padding waste entirely —
    the layout pretraining pipelines use. Capability lineage: the
    reference's LoD layout also stored sequences back-to-back without
    padding (framework/lod_tensor.h:229); this is that idea made
    static-shape.

    ``reader`` yields 1-D int/float sequences (len <= capacity; longer
    ones raise). Yields dicts with fixed shapes (batch_size, capacity):
      tokens       the packed rows (padded tail with ``pad_value``)
      segment_ids  1-based segment id per token, 0 = padding tail
      positions    position WITHIN each segment (for position embeddings)
    A row closes when the next sequence does not fit; a batch closes when
    ``batch_size`` rows are full. ``min_fill`` (0..1) applies to the
    FINAL flushed batch only: it is dropped when its used-token fraction
    falls below the floor (0 keeps everything). Mid-stream batches are
    always kept — their density is governed by packing, not stream end.
    """
    enforce(capacity >= 1 and batch_size >= 1,
            "capacity and batch_size must be >= 1")
    enforce(0.0 <= min_fill <= 1.0,
            "min_fill must be in [0, 1], got %s", min_fill)

    def gen():
        rows: List[List[np.ndarray]] = []
        cur: List[np.ndarray] = []
        used = 0

        def close_row():
            nonlocal cur, used
            if cur:
                rows.append(cur)
                cur, used = [], 0

        def emit(batch_rows, final=False):
            # buffer dtype follows the data (float sequences stay float),
            # widened as needed to also hold pad_value exactly
            dt = np.result_type(np.min_scalar_type(pad_value),
                                *(s.dtype for seqs in batch_rows
                                  for s in seqs))
            tokens = np.full((batch_size, capacity), pad_value, dtype=dt)
            segs = np.zeros((batch_size, capacity), np.int32)
            poss = np.zeros((batch_size, capacity), np.int32)
            n_used = 0
            for r, seqs in enumerate(batch_rows):
                off = 0
                for si, s in enumerate(seqs):
                    L = len(s)
                    tokens[r, off:off + L] = s
                    segs[r, off:off + L] = si + 1  # 0 marks padding
                    poss[r, off:off + L] = np.arange(L)
                    off += L
                n_used += off
            if final and n_used < min_fill * batch_size * capacity:
                return None  # final partial batch below the fill floor
            return {"tokens": tokens, "segment_ids": segs,
                    "positions": poss}

        for seq in reader():
            s = np.asarray(seq)
            enforce(s.ndim == 1, "pack_sequences packs 1-D sequences, "
                    "got shape %s", s.shape)
            enforce(len(s) <= capacity,
                    "sequence length %s exceeds capacity %s (truncate or "
                    "raise capacity)", len(s), capacity)
            if used + len(s) > capacity:
                close_row()
            cur.append(s)
            used += len(s)
            if len(rows) == batch_size:
                # mid-stream batches always yield (emit only returns
                # None on the min_fill-checked final flush)
                yield emit(rows)
                rows.clear()
        close_row()
        if rows:
            out = emit(rows, final=True)
            if out is not None:
                yield out

    return gen
