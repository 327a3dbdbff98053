"""Length bucketing, sequence packing and bucket boundaries (counterpart
of paddle_tpu/data/bucketing.py): host-side numpy, copied here so that
the port never imports the JAX package.

Variable-length samples are grouped into a fixed set of length buckets;
each bucket pads to its boundary, so a run sees at most
``len(boundaries)`` step shapes whatever the data's lengths (the JAX
package bounds its recompiles this way; here it bounds the shapes the
kernels and the allocator see). Packing is the padding-free dual."""

from __future__ import annotations

from typing import (Callable, Iterable, Iterator, List, Optional,
                    Sequence)

import numpy as np

from ..core.enforce import enforce


def quantile_boundaries(lengths: Sequence[int], num_buckets: int,
                        round_to: int = 8) -> List[int]:
    """Pick bucket boundaries at length quantiles (rounded up to a
    multiple of ``round_to``) — balances samples per bucket."""
    enforce(num_buckets >= 1, "num_buckets must be >= 1")
    ls = np.asarray(sorted(lengths))
    qs = [ls[min(int(len(ls) * (i + 1) / num_buckets), len(ls) - 1)]
          for i in range(num_buckets)]
    out: List[int] = []
    for q in qs:
        b = int(-(-int(q) // round_to) * round_to)
        if not out or b > out[-1]:
            out.append(b)
    return out


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


def pad_to(sample: np.ndarray, length: int, pad_value=0) -> np.ndarray:
    """Pad axis 0 of one sample to ``length``."""
    sample = np.asarray(sample)
    enforce(sample.shape[0] <= length,
            "sample length %s exceeds bucket %s", sample.shape[0], length)
    pad = [(0, length - sample.shape[0])] + [(0, 0)] * (sample.ndim - 1)
    return np.pad(sample, pad, constant_values=pad_value)


def bucket_by_length(reader: Callable[[], Iterator],
                     boundaries: Sequence[int],
                     batch_size: int,
                     length_of: Optional[Callable] = None,
                     pad_value=0,
                     drop_long: bool = False) -> Callable[[], Iterator]:
    """Reader decorator: group samples by length bucket and yield dict
    batches
    ``{"data": (B, bucket_len, ...), "lengths": (B,)}`` — one static shape
    per bucket.

    ``length_of(sample)`` defaults to ``len(sample)`` (or of its first
    field when the sample is a tuple — remaining fields are carried
    per-sample in "extras"). Samples longer than the last boundary raise
    (or are dropped with ``drop_long``).
    """
    bounds = list(boundaries)
    enforce(bounds == sorted(bounds) and len(set(bounds)) == len(bounds),
            "boundaries must be strictly increasing, got %s", bounds)

    def get_len(sample):
        if length_of is not None:
            return length_of(sample)
        if isinstance(sample, tuple):
            return len(sample[0])
        return len(sample)

    def bucket_of(n: int) -> int:
        for i, b in enumerate(bounds):
            if n <= b:
                return i
        return -1

    def gen():
        pending: List[List] = [[] for _ in bounds]
        for sample in reader():
            n = get_len(sample)
            i = bucket_of(n)
            if i < 0:
                if drop_long:
                    continue
                enforce(False, "sample length %s exceeds largest bucket %s "
                        "(use drop_long=True to skip)", n, bounds[-1])
            pending[i].append(sample)
            if len(pending[i]) == batch_size:
                yield _emit(pending[i], bounds[i])
                pending[i] = []
        for i, bucket in enumerate(pending):  # flush remainders
            if bucket:
                yield _emit(bucket, bounds[i])

    def _emit(samples: List, bound: int):
        first_tuple = isinstance(samples[0], tuple)
        seqs = [s[0] if first_tuple else s for s in samples]
        lengths = np.asarray([len(s) for s in seqs], np.int32)
        data = np.stack([pad_to(np.asarray(s), bound, pad_value)
                         for s in seqs])
        out = {"data": data, "lengths": lengths}
        if first_tuple and len(samples[0]) > 1:
            out["extras"] = [s[1:] for s in samples]
        return out

    return gen


def compile_shape_count(batches: Iterable[dict]) -> int:
    """Distinct (B, T) shapes a stream produces (the JAX package's count
    of the recompiles a jitted step would pay). A diagnostic."""
    return len({b["data"].shape for b in batches})


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
