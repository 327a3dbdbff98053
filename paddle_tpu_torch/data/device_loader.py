"""Overlapped device input (counterpart of
paddle_tpu/data/device_loader.py): prefetch to the card, and shape
bucketing.

- :class:`DevicePrefetcher` stages batches on the card ahead of the
  consumer. A background thread runs the host half (transform,
  bucket padding) and copies each array leaf from pinned host memory
  with ``non_blocking`` copies on its own CUDA stream, then records an
  event; the consumer makes its current stream wait on that event
  before it reads the batch, and marks each staged tensor with
  ``record_stream``, so the caching allocator never hands its memory to
  another tensor while the step still reads it. ``size=0`` stages in the
  consumer's thread (bucketing without prefetch).
- :class:`BucketPadder` pads the batch axis of a batch's per-example
  leaves up to a fixed set of sizes (``"pow2"`` or an ascending list),
  as the JAX package does to keep one compiled step per bucket; the
  port has no compiled step, but a ragged last batch gets the same
  rows, so the two packages train on the same padded data.

Donation safety: a leaf already on the card is cloned (``donate_safe``),
so a consumer that updates its batch in place never changes the
source's tensor. The JAX package's input metrics are telemetry (ROADMAP
queue 1 item 8); ``host_wait_s`` and ``batches_staged`` count here.
Staging onto a mesh (``mesh=``, ``sharding=``, ``stage_per_shard=``)
raises, naming item 11."""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from ..clip import tree_leaves, tree_map
from ..core.enforce import UnimplementedError, enforce
from ..core.places import resolve_device
from .bucketing import round_to_bucket

_ITEM11 = "is not ported yet: ROADMAP queue 1 item 11 (distributed)"


def _dominant_rows(leaves, axis: int) -> Optional[int]:
    """The batch-axis size shared by the most array leaves; ties go to
    the size with more elements, then the smaller size. A fixed-size
    aux leaf cannot outvote the per-example ones."""
    counts: dict = {}
    elems: dict = {}
    for leaf in leaves:
        shape = getattr(leaf, "shape", None)
        if shape is None or len(shape) <= axis:
            continue
        n = int(shape[axis])
        counts[n] = counts.get(n, 0) + 1
        elems[n] = elems.get(n, 0) + int(np.prod(shape))
    if not counts:
        return None
    return max(counts, key=lambda n: (counts[n], elems[n], -n))


class BucketPadder:
    """Pad the batch axis of a batch's array leaves (numpy arrays or
    tensors) to a fixed bucket set. Only leaves whose ``axis`` size is
    the batch's dominant size are padded; an empty batch rides through.
    ``mode``: ``"zeros"`` fills with ``pad_value``, ``"edge"`` repeats
    the last real row."""

    def __init__(self, buckets: Union[str, Iterable[int]] = "pow2",
                 axis: int = 0, pad_value=0, mode: str = "zeros"):
        if buckets is not None and buckets != "pow2":
            buckets = sorted(int(b) for b in buckets)
            enforce(bool(buckets), "buckets must be non-empty")
            enforce(all(b >= 1 for b in buckets),
                    "bucket boundaries must be >= 1, got %s", buckets)
        enforce(mode in ("zeros", "edge"), "mode must be zeros|edge, got %s",
                mode)
        enforce(axis >= 0, "axis must be >= 0, got %s", axis)
        self.buckets = buckets
        self.axis = axis
        self.pad_value = pad_value
        self.mode = mode

    def bucket_size(self, n: int) -> int:
        return int(round_to_bucket(int(n), self.buckets))

    def pad(self, batch):
        """``(padded, rows_added)``."""
        padded, rows_added, _ = self._pad_impl(batch)
        return padded, rows_added

    def _pad_leaf(self, leaf, n: int, b: int):
        if torch.is_tensor(leaf):
            if self.mode == "edge":
                fill = leaf.narrow(self.axis, n - 1, 1)
                fill = fill.expand(*[b - n if d == self.axis else s
                                     for d, s in enumerate(leaf.shape)])
            else:
                shape = list(leaf.shape)
                shape[self.axis] = b - n
                fill = torch.full(shape, self.pad_value, dtype=leaf.dtype,
                                  device=leaf.device)
            return torch.cat([leaf, fill], dim=self.axis)
        arr = np.asarray(leaf)
        widths = [(0, 0)] * arr.ndim
        widths[self.axis] = (0, b - n)
        if self.mode == "edge":
            return np.pad(arr, widths, mode="edge")
        return np.pad(arr, widths, constant_values=self.pad_value)

    def _pad_impl(self, batch):
        """``(padded, rows_added, pre_pad_rows)``."""
        n = _dominant_rows(tree_leaves(batch), self.axis)
        if not n:
            return batch, 0, n
        b = self.bucket_size(n)
        if b == n:
            return batch, 0, n
        added = [0]

        def pad(leaf):
            shape = getattr(leaf, "shape", None)
            if (shape is None or len(shape) <= self.axis
                    or int(shape[self.axis]) != n):
                return leaf
            added[0] += b - n
            return self._pad_leaf(leaf, n, b)

        return tree_map(pad, batch), added[0], n

    def __call__(self, batch):
        return self.pad(batch)[0]


def _put_cancellable(q: "queue.Queue", item, stop: "threading.Event") -> bool:
    """q.put that gives up once ``stop`` is set (False then)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


_PRODUCER_LOST = object()


def _get_bounded(q: "queue.Queue", thread, poll_s: float = 0.5):
    """q.get bounded by the producer's liveness: a producer that died
    without its end sentinel gives :data:`_PRODUCER_LOST`, not a hang."""
    while True:
        try:
            return q.get(timeout=poll_s)
        except queue.Empty:
            if not thread.is_alive():
                try:
                    return q.get_nowait()
                except queue.Empty:
                    return _PRODUCER_LOST


class DevicePrefetcher:
    """Prefetch-to-device iterator over ``batches`` (a reader creator,
    re-iterable per epoch, or a plain iterable). Per batch, in the
    worker: ``transform``, ``prefetch_rows``, :class:`BucketPadder` (with
    ``bucket_by``), then each array leaf to ``device`` (the card by
    default). ``size`` >= 1 slots of run-ahead (2 = double buffering);
    ``size=0`` stages in the consumer's thread; ``size="auto"`` starts at
    2 and grows by one (up to ``auto_cap``) whenever the median of the
    last ``AUTO_WINDOW`` host waits exceeds ``auto_threshold_s``.
    Abandoning the iterator releases the worker; a worker exception
    re-raises in the consumer. ``last_real_rows`` is the pre-pad row
    count of the batch last yielded; ``host_wait_s`` the seconds the
    consumer spent blocked on the queue, summed; ``last_wait_s`` the
    last such wait."""

    _END = object()

    AUTO_INITIAL = 2
    AUTO_CAP = 8
    AUTO_WINDOW = 8
    AUTO_THRESHOLD_S = 1e-3

    def __init__(self, batches: Union[Callable[[], Iterator[Any]],
                                      Iterable[Any]],
                 *, size: Union[int, str] = 2, mesh=None, sharding=None,
                 transform: Optional[Callable] = None, bucket_by=None,
                 pad_value=0, axis: int = 0, donate_safe: bool = True,
                 auto_cap: Optional[int] = None,
                 auto_threshold_s: Optional[float] = None,
                 stage_per_shard: Optional[bool] = None,
                 prefetch_rows: Optional[Callable[[Any], Any]] = None,
                 device=None):
        for name, value in (("mesh", mesh), ("sharding", sharding),
                            ("stage_per_shard", stage_per_shard or None)):
            if value is not None:
                raise UnimplementedError(
                    f"DevicePrefetcher {name}= {_ITEM11}")
        self.auto = size == "auto"
        if self.auto:
            self.auto_cap = int(auto_cap if auto_cap is not None
                                else self.AUTO_CAP)
            enforce(self.auto_cap >= 1, "auto_cap must be >= 1, got %s",
                    self.auto_cap)
            size = min(self.AUTO_INITIAL, self.auto_cap)
        else:
            enforce(auto_cap is None and auto_threshold_s is None,
                    "auto_cap/auto_threshold_s only apply to size='auto'")
            enforce(not isinstance(size, str),
                    "prefetch size must be an int or 'auto', got %r", size)
            size = int(size)
            enforce(size >= 0, "prefetch size must be >= 0, got %s", size)
            self.auto_cap = size
        self.auto_threshold_s = float(
            auto_threshold_s if auto_threshold_s is not None
            else self.AUTO_THRESHOLD_S)
        self.batches = batches
        self.size = size
        self._depth = size
        self.device = resolve_device(device)
        self.transform = transform
        if isinstance(bucket_by, BucketPadder) or bucket_by is None:
            self.padder = bucket_by
        else:
            self.padder = BucketPadder(bucket_by, axis=axis,
                                       pad_value=pad_value)
        if self.padder is not None:
            self.axis = self.padder.axis
        else:
            enforce(axis >= 0, "axis must be >= 0, got %s", axis)
            self.axis = int(axis)
        self.donate_safe = donate_safe
        self.prefetch_rows = prefetch_rows
        self.last_real_rows: Optional[int] = None
        self.last_wait_s: Optional[float] = None
        self.host_wait_s = 0.0
        self.batches_staged = 0
        self._stream = None

    # -- staging (worker side) ----------------------------------------------

    def _source(self) -> Iterator[Any]:
        src = self.batches
        return src() if callable(src) else iter(src)

    def _put(self, leaf):
        if getattr(leaf, "shape", None) is None:
            return leaf                 # a Python scalar rides along
        dev = self.device
        if torch.is_tensor(leaf) and leaf.device == dev:
            return leaf.clone() if self.donate_safe else leaf
        t = leaf if torch.is_tensor(leaf) else torch.from_numpy(
            np.ascontiguousarray(leaf))
        if dev.type == "cpu":
            return t.clone()
        if t.device.type == "cpu" and not t.is_pinned():
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    def _stage(self, item):
        if self.transform is not None:
            item = self.transform(item)
        if self.prefetch_rows is not None:
            self.prefetch_rows(item)
        if self.padder is not None:
            item, _, real_rows = self.padder._pad_impl(item)
        else:
            real_rows = _dominant_rows(tree_leaves(item), self.axis)
        event = None
        if self.device.type == "cuda":
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            if any(torch.is_tensor(x) and x.device == self.device
                   for x in tree_leaves(item)):
                # a clone reads what the producer's stream wrote
                self._stream.wait_stream(
                    torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream):
                staged = tree_map(self._put, item)
            event = torch.cuda.Event()
            event.record(self._stream)
        else:
            staged = tree_map(self._put, item)
        self.batches_staged += 1
        return staged, real_rows, event

    def _hand_over(self, staged, event):
        """Order the consumer's stream after the staging copies."""
        if event is None:
            return staged
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(event)
        for x in tree_leaves(staged):
            if torch.is_tensor(x) and x.device == self.device:
                x.record_stream(cur)
        return staged

    # -- iteration (consumer side) ------------------------------------------

    @property
    def current_depth(self) -> int:
        return self._depth

    def _maybe_grow(self, q: "queue.Queue", waits: list) -> None:
        if len(waits) < self.AUTO_WINDOW or self._depth >= self.auto_cap:
            return
        p50 = sorted(waits)[len(waits) // 2]
        waits.clear()
        if p50 <= self.auto_threshold_s:
            return
        self._depth += 1
        with q.mutex:
            q.maxsize = self._depth
            q.not_full.notify()

    def __iter__(self):
        if self.size == 0:
            for item in self._source():
                staged, rows, event = self._stage(item)
                self.last_real_rows = rows
                yield self._hand_over(staged, event)
            return

        q: queue.Queue = queue.Queue(maxsize=self._depth)
        waits: list = []
        err = []
        stop = threading.Event()

        def worker():
            try:
                for item in self._source():
                    if not _put_cancellable(q, self._stage(item), stop):
                        return
            except BaseException as e:  # re-raised in the consumer
                err.append(e)
            finally:
                _put_cancellable(q, self._END, stop)

        wt = threading.Thread(target=worker, daemon=True,
                              name="pt-device-prefetch")
        wt.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = _get_bounded(q, wt)
                if item is _PRODUCER_LOST:
                    enforce(err, "prefetch worker died without "
                            "delivering its end sentinel")
                    break
                if item is self._END:
                    break
                wait = time.perf_counter() - t0
                self.last_wait_s = wait
                self.host_wait_s += wait
                if self.auto and self._depth < self.auto_cap:
                    waits.append(wait)
                    self._maybe_grow(q, waits)
                staged, rows, event = item
                self.last_real_rows = rows
                yield self._hand_over(staged, event)
        finally:
            stop.set()
        if err:
            raise err[0]


def prefetch_to_device(batches, **kwargs) -> DevicePrefetcher:
    """Convenience front for :class:`DevicePrefetcher` (same kwargs)."""
    return DevicePrefetcher(batches, **kwargs)
