"""Continuous-batching LM serving loop (counterpart of
paddle_tpu/serving.py): a fixed arena of ``slots`` KV caches decodes in
lockstep — every tick advances all active slots, each at its own
cursor. Requests queue host-side; when a slot finishes (eos or its
budget) the next prompt is prefilled into it between ticks.

Two cache forms, as in the JAX package: contiguous per-block
(slots, capacity, Hkv, D) arenas (the decode tick runs the contiguous
decode kernel), or paged (``pages=N``): per-block shared page pools plus
one page table (the decode tick runs the paged decode kernel). Paged
pools may be int8 (``kv_dtype="int8"``: values plus per-vector float32
scales, quantized on append; the tick runs the int8 paged decode
kernel, and prefill attends over the dequantized gathered rows). Prefill
runs the bucketed prompt cache-only on the plain masked path, then
re-steps the last prompt token for the next-token logits.

Options, as in the JAX package:

- ``decode_steps=k``: a tick runs k single-token steps with the picks
  kept on the device and reads the (slots, k) token block to the host
  once; budget and eos apply per token on the host.
- ``prefix_cache=True`` (paged): completed requests register their
  page-aligned prompt prefix (refcounted pages); a later prompt with
  that prefix shares the pages and prefills only its suffix.
- ``prefill_chunk=C``: admission only allocates; the prompt prefills C
  tokens per loop iteration, so active slots keep decoding.
- ``draft=model, gamma=g``: speculative rounds — g draft steps per row,
  one per-row verify chunk of the target, and the modified rejection
  test; the draft keeps a contiguous arena of its own.
- :meth:`BatchedDecoder.prefill_export` / :meth:`inject_prefilled`
  move a prefilled prompt's pages between decoders as a
  :class:`KVHandoff` (the JAX package's npz wire format).
- ``submit(stream=TokenStream())``: tokens leave the arena the tick
  they are picked.

Sampled draws are keyed, as the JAX arena folds its key by (admission
counter, position): each pick hashes (the decoder's seed, the slot's
admission counter, the position, a salt) on the device
(``ops.sampling.keyed_sample``), so ``decode_steps=k`` draws what k=1
draws and a sampled speculative run repeats itself.

PyTorch idiom: the arena runs under ``torch.inference_mode()`` and its
caches and pools are written IN PLACE; a slot's prefill works on a
batch-1 view of its arena row, so nothing is written back. A tick
uploads its host state (tokens, cursors, admission counters, page
table) in one copy and reads its tokens back in one.

Telemetry (``paddle_tpu_torch.telemetry``, off by default), as in the
JAX package: TTFT and per-token decode-latency histograms, token, tick
and request counters, queue-depth and page-occupancy gauges, admission
rejections by cause (:func:`reject_cause`), signature tracking of the
tick and the prefill buckets, each program's cost in the ledger (its
first real call counted), the goodput ledger and the ITL sentinel, and
request tracing (each request adopts the caller's bound trace context).
With telemetry off a tick runs none of it. ``run(debug_port=,
flight_recorder=, preemption=)`` serve the debug endpoints, record each
tick, and drain on a grace signal. End-to-end deadlines
(``resilience.reliability``): a request submitted under a bound
:class:`Deadline` is dropped with ``deadline_exceeded`` once it expires,
queued or resident, and never computed after; a :class:`KVHandoff`
carries its trace context and deadline on the wire (the npz ``trace``
and ``deadline`` keys)."""

from __future__ import annotations

import contextlib
import io
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import telemetry
from .core.dtypes import default_dtype, to_dtype
from .core.enforce import enforce
from .core.places import resolve_device
from .ops import paged_kv
from .ops.sampling import (filter_logits, generator_seed,
                           keyed_categorical, keyed_sample, keyed_uniform)
from .resilience import reliability as _reliability
from .telemetry import costs as _costs
from .telemetry import profiling as _profiling
from .telemetry import recompile as _recompile
from .telemetry import server as _dbg_server
from .telemetry import tracing as _tracing

__all__ = ["BatchedDecoder", "PagedKVPool", "Request", "KVHandoff",
           "TokenStream", "reject_cause"]

# reusable inert context manager: span call sites gate on
# telemetry.enabled() (a disabled run executes no tracing code) and fall
# back to this
_NULL_CM = contextlib.nullcontext()


@telemetry.cached_instruments
def _serving_metrics(reg):
    """Serving instrument set, memoized against the registry generation
    (run() touches it every tick). Only reached while telemetry is
    enabled."""
    return {
        "requests": reg.counter(
            "pt_serving_requests_total", "requests submitted"),
        "completed": reg.counter(
            "pt_serving_completed_total", "requests completed"),
        "tokens": reg.counter(
            "pt_serving_tokens_total", "tokens emitted"),
        "ttft": reg.histogram(
            "pt_serving_ttft_seconds",
            "submit-to-first-token latency (includes queue wait)",
            unit="s"),
        "decode_latency": reg.histogram(
            "pt_serving_decode_latency_seconds",
            "per-token decode latency (dispatch wall time / tokens "
            "emitted that dispatch)", unit="s"),
        "queue_depth": reg.gauge(
            "pt_serving_queue_depth", "requests waiting for a slot"),
        "rejections": reg.counter(
            "pt_serving_admission_rejections_total",
            "admissions rejected or deferred (all causes; see the "
            "cause-labeled series for the split)"),
        # the cause-labeled split of the same total: pool_exhausted =
        # paged admission deferred on page exhaustion, capacity = hard
        # queue-depth cap, shed = SLO load-shed (router policy),
        # deadline = the end-to-end deadline expired before or while
        # serving (a typed drop, never computed)
        "rejections_by_cause": {
            cause: reg.counter(
                "pt_serving_admission_rejections_total",
                "admissions rejected or deferred, by cause",
                labels={"cause": cause})
            for cause in ("pool_exhausted", "capacity", "shed",
                          "deadline")},
        "page_occupancy": reg.gauge(
            "pt_serving_page_occupancy_ratio",
            "allocated fraction of the KV page pool"),
        "kv_pool_bytes": reg.gauge(
            "pt_serving_kv_pool_bytes",
            "device bytes held by the paged KV pools (all blocks, "
            "K+V, scales included for kv_dtype=int8) — the "
            "concurrent-session HBM denominator"),
        "kv_pool_live_bytes": reg.gauge(
            "pt_serving_kv_pool_live_bytes",
            "KV pool bytes backing ALLOCATED pages (occupancy x pool "
            "bytes)"),
        "spec_rounds": reg.counter(
            "pt_serving_spec_row_rounds_total",
            "speculative verify rounds (per active row)"),
        "spec_accepted": reg.counter(
            "pt_serving_spec_accepted_total",
            "draft tokens accepted by target verify"),
        "spec_accept_rate": reg.gauge(
            "pt_serving_spec_accept_rate",
            "mean accepted draft tokens per verify round (0..gamma)"),
        "streams": reg.counter(
            "pt_serving_streams_total",
            "requests served with a per-token stream attached"),
        "stream_stalled": reg.counter(
            "pt_stream_stalled_seconds",
            "cumulative seconds streams spent stalled on a full "
            "client buffer (the backpressure that pauses a stream, "
            "never the arena tick)", unit="s"),
    }


def reject_cause(cause: str) -> None:
    """Bump the admission-rejection counters (the unlabeled total and
    the cause-labeled series): the one place the split is recorded.
    No-op while telemetry is disabled."""
    if not telemetry.enabled():
        return
    m = _serving_metrics()
    m["rejections"].inc()
    by = m["rejections_by_cause"].get(cause)
    if by is not None:
        by.inc()


class PagedKVPool:
    """Shared page pool for paged-KV attention: K and V live in
    (pages, page_size, kv_heads, head_dim) pools shared by all requests;
    each request owns a row of the page table. Host-side alloc/free
    here; ``arrays=True`` also mints one K and one V pool (``kpool``,
    ``vpool``), while the decoder passes ``arrays=False`` and keeps its
    own per-block pools, minted with :meth:`empty_pool`.
    ``kv_dtype="int8"`` mints ``ops.paged_kv.QuantizedPool`` pools:
    (1 + 4 / head_dim) bytes per cached element instead of the float
    itemsize, which is what sets the sessions a fixed pool budget
    holds. Pages are reference-counted (prefix caching: a page shared by
    N live requests and the registry has count N + 1 and returns to the
    free list at 0)."""

    def __init__(self, pages: int, page_size: int, kv_heads: int,
                 head_dim: int, dtype=None, arrays: bool = True,
                 kv_dtype=None, *, device=None):
        enforce(page_size in (64, 128, 256),
                "page_size must be one of (64, 128, 256), got %s",
                page_size)
        enforce(pages >= 1, "pages must be >= 1, got %s", pages)
        enforce(kv_dtype in (None, "int8"),
                'kv_dtype must be None or "int8", got %r', kv_dtype)
        self.kv_dtype = kv_dtype
        self.dtype = to_dtype(dtype) if dtype is not None else \
            default_dtype()
        self.device = resolve_device(device)
        self.shape = (pages, page_size, kv_heads, head_dim)
        self.page_size = page_size
        self.pages = pages
        self._free = list(range(pages - 1, -1, -1))
        self._free_set = set(self._free)
        self._ref = np.zeros(pages, np.int64)
        self.kpool = self.empty_pool() if arrays else None
        self.vpool = self.empty_pool() if arrays else None

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def empty_pool(self):
        """One zeroed pool (K or V side) on the pool's device: a float
        tensor, or a QuantizedPool when ``kv_dtype="int8"``."""
        if self.kv_dtype == "int8":
            return paged_kv.QuantizedPool(
                torch.zeros(self.shape, dtype=torch.int8,
                            device=self.device),
                torch.zeros(self.shape[:3], dtype=torch.float32,
                            device=self.device))
        return torch.zeros(self.shape, dtype=self.dtype, device=self.device)

    @property
    def pool_nbytes(self) -> int:
        """Device bytes one pool (K or V side) costs."""
        if self.kv_dtype == "int8":
            return paged_kv.quantized_pool_nbytes(self.shape)
        return int(np.prod(self.shape)) * torch.empty(
            (), dtype=self.dtype).element_size()

    def alloc(self, n: int) -> np.ndarray:
        """Claim n pages (typed error when exhausted)."""
        enforce(n <= len(self._free),
                "page pool exhausted: want %s, free %s", n, len(self._free))
        got = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(got)
        self._ref[got] = 1
        return np.asarray(got, np.int32)

    def share(self, ids) -> None:
        """Take an extra reference on live pages (prefix caching)."""
        for i in np.asarray(ids).reshape(-1):
            i = int(i)
            enforce(0 <= i < self.pages,
                    "page id %s outside pool (%s pages)", i, self.pages)
            enforce(self._ref[i] > 0, "share of unallocated page %s", i)
            self._ref[i] += 1

    def free(self, ids) -> None:
        """Drop one reference per page; a page returns to the free list at
        count 0. Over-freeing would hand one page to two requests, so it
        is a typed error."""
        for i in np.asarray(ids).reshape(-1):
            i = int(i)
            enforce(0 <= i < self.pages,
                    "page id %s outside pool (%s pages)", i, self.pages)
            enforce(i not in self._free_set and self._ref[i] > 0,
                    "double free of page %s", i)
            self._ref[i] -= 1
            if self._ref[i] == 0:
                self._free.append(i)
                self._free_set.add(i)


def _row_apply(caches, s: int, fn):
    """Run ``fn(row)`` on slot ``s`` of each layer's (slots, ...) K/V
    cache pair, taken as a batch-1 VIEW. The port's cache writes are in
    place, so they land in the arena with no write-back (the JAX
    package slices the row out and writes it back)."""
    row = [(ck[s:s + 1], cv[s:s + 1]) for ck, cv in caches]
    out, _ = fn(row)
    return out


class TokenStream:
    """Bounded per-client token buffer, the per-token streaming sink.

    Tokens leave the arena the tick they are picked: the arena calls
    :meth:`offer` with the request's emitted-token list each tick, and
    records are appended from the stream's own high-water index while
    the buffer has room. ``offer`` never blocks: a stalled client (a
    full buffer) pauses its own stream (``stalled_s`` accumulates) and
    the stream catches up from the same list on a later tick; no
    consumer ever slows the arena.

    A pump feeding a client-side instance uses :meth:`put`, which may
    wait (bounded) for room. Records are dicts: tokens ``{"i": index,
    "tok": id, "t": perf_counter-or-None}``; control records
    (``{"event": "resume", ...}``, ``{"event": "end", "n": total}``,
    ``{"event": "error", "error": repr}``) ride the same queue and
    bypass the cap. Consume with :meth:`get` (None = timeout, the stream
    still live) or iteration, which ends at end or error."""

    def __init__(self, maxlen: int = 256):
        enforce(maxlen >= 1, "stream maxlen must be >= 1, got %s", maxlen)
        self.maxlen = int(maxlen)
        self._buf: List[Dict[str, Any]] = []
        self._cond = threading.Condition()
        self._src = 0                 # next emitted index to buffer
        self._final = None            # the completion's token array
        self._end_sent = False
        self.closed = False
        self.error: Optional[BaseException] = None
        self.stalled_s = 0.0
        self._stall_t0: Optional[float] = None

    # -- producer side ------------------------------------------------------

    def _note_stall_end(self, now: float) -> None:
        if self._stall_t0 is not None:
            d = max(0.0, now - self._stall_t0)
            self.stalled_s += d
            self._stall_t0 = None
            if d and telemetry.enabled():
                _serving_metrics()["stream_stalled"].inc(d)

    def offer(self, toks, now: Optional[float] = None) -> None:
        """Arena side: buffer token records for ``toks[src:]`` while the
        client buffer has room. Never blocks."""
        if now is None:
            now = time.perf_counter()
        with self._cond:
            if self.closed:
                return
            progressed = False
            while self._src < len(toks) and len(self._buf) < self.maxlen:
                self._buf.append({"i": self._src,
                                  "tok": int(toks[self._src]), "t": now})
                self._src += 1
                progressed = True
            if self._src < len(toks):
                if self._stall_t0 is None:
                    self._stall_t0 = now   # the stall starts
            else:
                self._note_stall_end(now)
            if progressed:
                self._cond.notify_all()

    def put(self, rec: Dict[str, Any],
            timeout: Optional[float] = None) -> bool:
        """Pump side: append one record, waiting (bounded) for room.
        False when the stream closed or the wait expired."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while len(self._buf) >= self.maxlen and not self.closed:
                w = 0.05
                if deadline is not None:
                    w = min(w, deadline - time.monotonic())
                    if w <= 0:
                        return False
                t0 = time.monotonic()
                self._cond.wait(w)
                d = time.monotonic() - t0
                self.stalled_s += d
                if d and telemetry.enabled():
                    _serving_metrics()["stream_stalled"].inc(d)
            if self.closed:
                return False
            if "i" in rec and int(rec["i"]) < self._src:
                # already delivered (a completion-driven tail outran this
                # record): dropped as delivered, never served twice
                return True
            self._buf.append(dict(rec))
            if "i" in rec:
                self._src = max(self._src, int(rec["i"]) + 1)
            self._cond.notify_all()
            return True

    def control(self, event: str, **kv: Any) -> None:
        """Append a control record; it bypasses the cap."""
        with self._cond:
            if self.closed:
                return
            self._buf.append({"event": event, **kv})
            self._cond.notify_all()

    def finish(self, result, now: Optional[float] = None) -> None:
        """The request completed with ``result`` tokens. Tokens a
        stalled client has not buffered yet are served from this record
        as the consumer asks for them, then the end record."""
        if now is None:
            now = time.perf_counter()
        with self._cond:
            self._note_stall_end(now)
            self._final = np.asarray(result, np.int32)
            self._cond.notify_all()

    def fail(self, err: BaseException) -> None:
        """Terminal failure: the typed error record, then closed."""
        with self._cond:
            self._note_stall_end(time.perf_counter())
            self.error = err
            self._buf.append({"event": "error", "error": repr(err)})
            self.closed = True
            self._cond.notify_all()

    # -- consumer side ------------------------------------------------------

    @property
    def done(self) -> bool:
        with self._cond:
            return (not self._buf
                    and (self.closed
                         or (self._final is not None and self._end_sent
                             and self._src >= len(self._final))))

    def get(self, timeout: Optional[float] = None):
        """Next record, or None on timeout (the stream still live) or
        once the stream is drained after end or error."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._buf:
                    rec = self._buf.pop(0)
                    self._cond.notify_all()   # room freed: wake put()
                    return rec
                if self._final is not None:
                    if self._src < len(self._final):
                        i = self._src
                        self._src += 1
                        return {"i": i, "tok": int(self._final[i]),
                                "t": None}
                    if not self._end_sent:
                        self._end_sent = True
                        self.closed = True
                        return {"event": "end", "n": int(len(self._final))}
                if self.closed:
                    return None
                w = 0.1
                if deadline is not None:
                    w = min(w, deadline - time.monotonic())
                    if w <= 0:
                        return None
                self._cond.wait(w)

    def __iter__(self):
        """Yield records up to and including the end or error record."""
        while True:
            rec = self.get(timeout=1.0)
            if rec is None:
                if self.done:
                    return
                continue
            yield rec
            if rec.get("event") in ("end", "error"):
                return


class KVHandoff:
    """Prefilled KV pages plus next-token logits for one prompt, the
    prefill-to-decode wire unit: :meth:`BatchedDecoder.prefill_export`
    produces it, :meth:`BatchedDecoder.inject_prefilled` consumes it.

    ``blocks`` holds one ``(k_payload, v_payload)`` per transformer
    block: (m, page_size, kv_heads, head_dim) float arrays, or
    ``(q, scale)`` pairs for int8 pools (the storage form crosses
    intact). :meth:`to_bytes` / :meth:`from_bytes` are the JAX package's
    npz wire format, so either package reads the other's bytes.
    ``trace`` (a :class:`telemetry.tracing.TraceContext`) and
    ``deadline`` (a :class:`resilience.reliability.Deadline`) ride the
    wire in their header forms (the ``trace`` and ``deadline`` keys): the
    decode side adopts the request's trace and its remaining budget, not
    a fresh one."""

    def __init__(self, prompt, plen: int, logits, blocks,
                 page_size: int, kv_dtype=None, trace=None,
                 deadline=None):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.plen = int(plen)
        self.logits = np.asarray(logits, np.float32)
        self.blocks = blocks
        self.page_size = int(page_size)
        self.kv_dtype = kv_dtype
        self.trace = trace
        self.deadline = deadline

    @property
    def pages(self) -> int:
        """Pages per block the payload covers."""
        first = self.blocks[0][0]
        return (first[0] if isinstance(first, tuple) else first).shape[0]

    @property
    def nbytes(self) -> int:
        n = 0
        for kp, vp in self.blocks:
            for p in (kp, vp):
                arrs = p if isinstance(p, tuple) else (p,)
                n += sum(int(a.nbytes) for a in arrs)
        return n

    def to_bytes(self) -> bytes:
        quant = self.kv_dtype is not None

        def stack(side):
            if quant:
                return (np.stack([np.asarray(b[side][0])
                                  for b in self.blocks]),
                        np.stack([np.asarray(b[side][1])
                                  for b in self.blocks]))
            return (np.stack([np.asarray(b[side]) for b in self.blocks]),)

        arrays = {"prompt": self.prompt, "logits": self.logits,
                  "meta": np.asarray([self.plen, self.page_size,
                                      int(quant)], np.int64)}
        if self.trace is not None:
            arrays["trace"] = np.asarray(self.trace.to_header())
        if self.deadline is not None:
            # an absolute wall-clock epoch: meaningful across processes
            arrays["deadline"] = np.asarray(self.deadline.to_header())
        for side, name in ((0, "k"), (1, "v")):
            payload = stack(side)
            if quant:
                arrays[name + "q"], arrays[name + "s"] = payload
            else:
                arrays[name] = payload[0]
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return buf.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> "KVHandoff":
        z = np.load(io.BytesIO(data))
        plen, page_size, quant = (int(x) for x in z["meta"])
        if quant:
            blocks = [((z["kq"][i], z["ks"][i]), (z["vq"][i], z["vs"][i]))
                      for i in range(z["kq"].shape[0])]
        else:
            blocks = [(z["k"][i], z["v"][i])
                      for i in range(z["k"].shape[0])]
        trace = (_tracing.from_header(str(z["trace"]))
                 if "trace" in z.files else None)
        deadline = (_reliability.Deadline.from_header(str(z["deadline"]))
                    if "deadline" in z.files else None)
        return KVHandoff(z["prompt"], plen, z["logits"], blocks, page_size,
                         "int8" if quant else None, trace=trace,
                         deadline=deadline)


class Request:
    """One generation request; ``result`` is filled on completion."""

    def __init__(self, rid: int, prompt_ids, max_new: int):
        self.rid = rid
        self.prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        self.max_new = int(max_new)
        self.result: Optional[np.ndarray] = None
        self.t_submit = 0.0
        self.t_first = 0.0
        self.t_done = 0.0
        self.t_tokens: List[float] = []   # per-token emission stamps
        self.handoff: Optional[KVHandoff] = None   # pre-filled KV pages
        self.stream: Optional[TokenStream] = None  # per-token sink
        self.trace = None        # TraceContext (telemetry on, traced hop)
        self.deadline = None     # reliability.Deadline (bound at submit)
        self.deadline_exceeded = False  # dropped typed, never computed


class BatchedDecoder:
    """Slot-based continuous batching over a GPT-family causal LM.

    ``submit()`` enqueues; ``run()`` drives to completion and returns
    {request_id: np.ndarray of generated ids (prompt excluded)}. Sampling
    parameters apply to every request (temperature=0 = greedy; sampled
    modes key their draws from a seed drawn once from ``generator``, a
    ``torch.Generator``); ``eos_id`` ends a request early.
    ``kv_dtype="int8"`` (paged mode only) keeps the page pools in int8.
    ``device``: the CUDA card when None (raises when there is none); it
    must be the model's (and the draft's) device. The other options are
    described in the module docstring."""

    def __init__(self, model, slots: int, capacity: int, *,
                 eos_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, prompt_bucket: int = 16,
                 pages: Optional[int] = None, page_size: int = 128,
                 prefix_cache: bool = False, kv_dtype=None,
                 prefill_chunk: Optional[int] = None, draft=None,
                 gamma: int = 4, decode_steps: int = 1, device=None):
        self.device = resolve_device(device)
        enforce(model.device == self.device,
                "the model lives on %s but the decoder on %s", model.device,
                self.device)
        enforce(slots >= 1, "slots must be >= 1, got %s", slots)
        enforce(capacity >= prompt_bucket,
                "capacity %s < prompt bucket %s", capacity, prompt_bucket)
        self.model = model
        self.prefill_chunk = prefill_chunk
        if prefill_chunk is not None:
            enforce(prefill_chunk >= 1, "prefill_chunk must be >= 1")
            enforce(prefill_chunk <= capacity,
                    "prefill_chunk %s > capacity %s", prefill_chunk,
                    capacity)
            if pages is not None:
                # with C | page_size the padded chunk frontier (the
                # smallest multiple of C >= plen) never passes the page
                # demand, so no chunk writes into an unallocated entry
                enforce(page_size % prefill_chunk == 0,
                        "prefill_chunk %s must divide page_size %s",
                        prefill_chunk, page_size)
        self.decode_steps = int(decode_steps)
        enforce(self.decode_steps >= 1,
                "decode_steps must be >= 1, got %s", decode_steps)
        self.draft = draft
        self.gamma = int(gamma)
        if draft is not None:
            enforce(gamma >= 1, "gamma must be >= 1, got %s", gamma)
            enforce(model.cfg.vocab_size == draft.cfg.vocab_size,
                    "vocab mismatch: target %s vs draft %s",
                    model.cfg.vocab_size, draft.cfg.vocab_size)
            enforce(self.decode_steps == 1,
                    "decode_steps composes with the plain arena only; "
                    "speculative rounds already emit multiple tokens per "
                    "dispatch")
            enforce(draft.device == self.device,
                    "the draft lives on %s but the decoder on %s",
                    draft.device, self.device)
        # overrun margin budgeted at admission: a verify chunk writes up
        # to cursor+gamma, and a decode_steps window up to k-1 positions
        # past a mid-window finish; unbudgeted, those writes would land
        # in an unallocated table entry (paged) or clamp onto the live
        # tail of a contiguous row
        self._extra = (self.gamma if draft is not None
                       else self.decode_steps - 1)
        self.slots, self.capacity = slots, capacity
        self.eos_id = eos_id
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self.sampled = float(temperature) != 0.0
        enforce(not self.sampled or generator is not None,
                "temperature > 0 samples and needs a torch.Generator")
        self.seed = generator_seed(generator) if self.sampled else 0
        self.bucket = prompt_bucket
        self.paged = pages is not None
        self.prefix_cache = prefix_cache
        self._prefix_registry: Dict[bytes, np.ndarray] = {}
        self.prefix_hits = 0
        self.prefix_lookups = 0   # admissions that consulted the registry
        if self.paged:
            enforce(capacity % page_size == 0,
                    "capacity %s not divisible by page_size %s", capacity,
                    page_size)
            enforce(page_size % prompt_bucket == 0,
                    "page_size %s must be a multiple of prompt_bucket %s "
                    "(bucket round-up must never overrun the allocated "
                    "pages into another request's page 0)", page_size,
                    prompt_bucket)
            attn0 = model.blocks[0].self_attn
            self._allocator = PagedKVPool(
                pages, page_size, attn0.num_kv_heads, attn0.head_dim,
                dtype=attn0.cache_home()[0], arrays=False,
                kv_dtype=kv_dtype, device=self.device)
            self.page_size = page_size
            self.n_log = capacity // page_size
            al = self._allocator
            self.pools = [(al.empty_pool(), al.empty_pool())
                          for _ in model.blocks]
            self.table = np.zeros((slots, self.n_log), np.int32)
            self._slot_pages: List[Optional[np.ndarray]] = [None] * slots
        else:
            enforce(not prefix_cache,
                    "prefix_cache requires paged mode (pages=N)")
            enforce(kv_dtype is None,
                    "kv_dtype requires paged mode (pages=N) — the "
                    "contiguous arena has no quantized form")
            self.caches = [blk.self_attn.init_cache(slots, capacity)
                           for blk in model.blocks]
        if draft is not None:
            self.caches_d = [blk.self_attn.init_cache(slots, capacity)
                             for blk in draft.blocks]
        self.tok = np.zeros((slots,), np.int32)       # last token per slot
        # cursors: paged mode parks every idle slot past capacity — an
        # idle slot's table row is zeros, and a cursor of 0 would write
        # its junk K/V into physical page 0 (write_rows drops
        # out-of-range cursors). Contiguous slots own private rows.
        self.t = np.full((slots,), capacity if self.paged else 0, np.int32)
        self.active = np.zeros((slots,), bool)
        self.budget = np.zeros((slots,), np.int64)    # tokens left
        self.owner: List[Optional[Request]] = [None] * slots
        self.emitted: List[List[int]] = [[] for _ in range(slots)]
        self.gen_count = 0                            # admission counter
        self._slot_gen = np.zeros((slots,), np.int64)
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        self._next_rid = 0
        # chunked prefill: slot -> {padded, plen, off, r}; _pf_order is
        # admission FIFO, so ticks are fair
        self._pf: List[Optional[dict]] = [None] * slots
        self._pf_order: List[int] = []
        # SLO degrade lever: forces decode_steps=1 and bypasses
        # speculative rounds until cleared (set_degraded)
        self.degraded = False
        self._warmed = False
        # tick accounting: ticks run, host seconds spent in them, tokens
        # emitted and the token capacity (slots x k per tick); a
        # speculative round counts as a tick of gamma+1 positions
        self.tick_count = 0
        self.tick_seconds = 0.0
        self.tick_tokens = 0
        self.tick_capacity = 0
        # speculative stats: mean accepted per verify per row =
        # spec_accepted / spec_row_rounds; tokens per target call = 1 +
        # that
        self.spec_rounds = 0
        self.spec_row_rounds = 0
        self.spec_accepted = 0
        # the tick's host-to-device staging (pinned, on the card)
        self._stage = None
        self._dstage = None
        # per-slot trace context of the active request (None unless
        # telemetry was on at submit and the request is traced): the
        # decode tick's span and exemplar source
        self._slot_trace: List[Optional[Any]] = [None] * slots
        self._weights_fp = None   # stamped per run() while telemetry is on
        self.debug_server = None  # the last run(debug_port=)'s server
        self.preempted = False    # the last run() exited on a grace signal
        # slot-resident requests carrying a deadline: the per-tick expiry
        # sweep is gated on this count, so an undeadlined run executes no
        # deadline code per tick
        self._dl_active = 0
        self._backend_name: Optional[str] = None

    # ----- host API --------------------------------------------------------

    def _check_budget(self, plen: int, max_new: int) -> None:
        enforce(max_new >= 1, "max_new must be >= 1, got %s", max_new)
        enforce(plen + max_new + self._extra <= self.capacity,
                "prompt %s + max_new %s (+%s speculative/window margin) "
                "exceeds slot capacity %s", plen, max_new, self._extra,
                self.capacity)
        if self.paged:
            # a demand beyond the whole pool could never be admitted
            need = -(-(plen + max_new + self._extra) // self.page_size)
            enforce(need <= self._allocator.pages,
                    "request needs %s pages but the pool only has %s",
                    need, self._allocator.pages)

    def submit(self, prompt_ids, max_new: int,
               stream: Optional[TokenStream] = None) -> int:
        """Enqueue one request; returns its id. ``stream=`` attaches a
        :class:`TokenStream` the arena offers tokens to each tick."""
        enforce(len(np.asarray(prompt_ids).reshape(-1)) >= 1,
                "empty prompt")
        enforce(stream is None or isinstance(stream, TokenStream),
                "stream= takes a serving.TokenStream, got %s",
                type(stream).__name__)
        r = Request(self._next_rid, prompt_ids, max_new)
        self._check_budget(len(r.prompt), max_new)
        r.stream = stream
        self._next_rid += 1
        r.t_submit = time.perf_counter()
        # the ambient end-to-end deadline (a router's dispatch or the
        # debug server's POST edge binds it): one contextvar read
        r.deadline = _reliability.current()
        if telemetry.enabled():
            self._note_request(r, _tracing.current())
        self.queue.append(r)
        return r.rid

    def _note_request(self, r: Request, trace) -> None:
        """A submitted request's telemetry: the request counters, its
        trace context, the /healthz last-request clock (owner-scoped
        while run() has our server up, else broadcast)."""
        m = _serving_metrics()
        m["requests"].inc()
        if r.stream is not None:
            m["streams"].inc()
        r.trace = trace
        srv = self.debug_server
        if srv is not None and srv.running:
            srv.note("request")
        else:
            _dbg_server.note("request")

    @torch.inference_mode()
    def run(self, debug_port: Optional[int] = None, flight_recorder=None,
            preemption=None) -> Dict[int, np.ndarray]:
        """Drive until every submitted request completes.

        Live diagnostics (opt-in): ``debug_port=P`` serves the debug
        endpoints (/metrics /healthz /readyz /statusz /tracez /memz,
        POST /profilez) on 127.0.0.1:P for the drive (0 = ephemeral;
        ``self.debug_server`` holds the server; starting it enables
        telemetry; its thread is joined before run() returns).
        ``flight_recorder=`` records one entry per tick (tick wall time,
        queue depth, active slots) into a
        :class:`telemetry.diag.FlightRecorder`: its ``step_stall`` watch
        catches a wedged arena; policy ``halt`` raises
        :class:`telemetry.diag.AnomalyHalt`, ``skip_step`` acts as
        ``record`` (a tick is no optimizer update; nothing rolls back).
        Consulted only while telemetry is enabled; it reads no device
        value.

        Preemption grace (opt-in): ``preemption=True`` installs a
        SIGTERM/SIGINT handler for the drive (or pass a
        :class:`resilience.PreemptionHandler`). On a signal the arena
        stops admitting but ticks until every in-flight request (active
        or mid-prefill) completes: the drained results are returned,
        ``self.preempted`` is True, and unserved requests stay in
        ``self.queue``. With None no handler exists and a tick runs no
        resilience code."""
        if telemetry.enabled():
            # the weights' fingerprint, once per run (they change only
            # between runs): per-tick records pass its hash as an Opaque
            # token, so a quant/LoRA swap between runs registers as a new
            # signature without re-walking every leaf per tick
            models = [self.model] + ([self.draft] if self.draft else [])
            self._weights_fp = _recompile.Opaque(hash(telemetry.fingerprint(
                [(dict(m.named_parameters()), dict(m.named_buffers()))
                 for m in models])))
        self.debug_server = None
        if debug_port is not None:
            self.debug_server = _dbg_server.DebugServer(
                port=debug_port, owned=True,
                run_config={"role": "serving", "slots": self.slots,
                            "capacity": self.capacity,
                            "paged": self.paged,
                            "kv_dtype": (self._allocator.kv_dtype
                                         if self.paged else None),
                            "spec": self.draft is not None,
                            "decode_steps": self.decode_steps}).start()
            self.debug_server.add_status("serving", self._statusz)
            # on-demand bounded device capture (404 -> 409 -> 200; one
            # capture at a time, a hard duration cap)
            self.debug_server.add_post(
                "/profilez", _profiling.make_profilez())
            # readiness is not liveness: a draining or not-yet-warmed
            # arena answers ready=false without reading as dead
            self.debug_server.set_ready(lambda: self.ready)
            if self.queue or self._pf_order or self.active.any():
                # requests submitted before the server came up
                self.debug_server.note("request")
        pre = None
        own_pre = False
        self.preempted = False
        if preemption is not None and preemption is not False:
            from .resilience.preemption import PreemptionHandler

            pre = (PreemptionHandler() if preemption is True
                   else preemption)
            if not pre.installed:
                pre.install()
                own_pre = True
        tick = 0
        try:
            while self.queue or self._pf_order or self.active.any():
                if pre is not None and not self.preempted \
                        and pre.requested():
                    self.preempted = True
                if self.preempted and not (self._pf_order
                                           or self.active.any()):
                    # in-flight work drained; queued requests stay in
                    # self.queue for a successor process
                    break
                telem = telemetry.enabled()
                if telem:
                    self._note_gauges()
                    t_tick = time.perf_counter()
                if not self.preempted:
                    self._admit()
                self._prefill_tick()
                self._step()
                if telem:
                    tick += 1
                    # stamp our server when we own one (owner-scoped
                    # heartbeat, see telemetry.server.note)
                    if self.debug_server is not None:
                        self.debug_server.note("step")
                    else:
                        _dbg_server.note("step")
                    if flight_recorder is not None:
                        action = flight_recorder.record_step(
                            tick, step_time=time.perf_counter() - t_tick,
                            queue_depth=len(self.queue),
                            active_slots=int(self.active.sum()))
                        if action == "halt":
                            raise flight_recorder.halt_error(
                                f"serving tick {tick}")
        finally:
            if own_pre:
                pre.uninstall()
            if self.debug_server is not None:
                self.debug_server.stop()
        if self.preempted and telemetry.enabled():
            from .resilience.preemption import _preempt_metrics

            _preempt_metrics()["clean_exits"].inc()
        out = {rid: r.result for rid, r in self.done.items()}
        self.done = {}
        return out

    def _note_gauges(self) -> None:
        """The queue and page-pool gauges, once per loop iteration."""
        m = _serving_metrics()
        m["queue_depth"].set(len(self.queue))
        if self.paged:
            al = self._allocator
            occ = (al.pages - al.free_pages) / al.pages
            m["page_occupancy"].set(occ)
            pool_b = 2 * len(self.pools) * al.pool_nbytes
            m["kv_pool_bytes"].set(pool_b)
            m["kv_pool_live_bytes"].set(occ * pool_b)

    def _statusz(self) -> Dict[str, Any]:
        """Arena view for /statusz (host fields only; a read mid-tick may
        tear across fields, fine for monitoring)."""
        st = {"slots": self.slots, "capacity": self.capacity,
              "active_slots": int(self.active.sum()),
              "queue_depth": len(self.queue),
              "completed": len(self.done),
              "prefilling": len(self._pf_order),
              "preempted": self.preempted}
        if self.paged:
            al = self._allocator
            st["pages"] = al.pages
            st["free_pages"] = al.free_pages
            st["kv_dtype"] = al.kv_dtype or str(al.dtype).replace("torch.",
                                                                  "")
            st["kv_pool_bytes"] = 2 * len(self.pools) * al.pool_nbytes
            if self.prefix_cache:
                st["prefix_hits"] = self.prefix_hits
        if self.draft is not None:
            st["spec_rounds"] = self.spec_rounds
            st["spec_accepted"] = self.spec_accepted
        st["ready"] = self.ready
        st["degraded"] = self.degraded
        return st

    # ----- readiness, degrade, KV handoff ----------------------------------

    @property
    def ready(self) -> bool:
        """Readiness (the placement signal): True once the arena has run
        a decode tick (or :meth:`warm_step`) and is not draining on a
        preemption."""
        return self._warmed and not self.preempted

    @torch.inference_mode()
    def warm_step(self) -> None:
        """Run the decode tick once over the arena as it stands and mark
        the decoder warm, with no request. Safe on an idle arena: paged
        cursors are parked past capacity, so their writes drop;
        contiguous junk lands at positions a later prefill overwrites and
        no attention reads. A speculative arena runs its round too."""
        kd = 1 if self.degraded else self.decode_steps
        tok, t, gens, table = self._tick_inputs()
        self._decode_window(kd, tok, t, gens, table).cpu()
        if self.draft is not None and not self.degraded:
            self._spec_round(tok, t, gens, table)[0].cpu()
        self._warmed = True

    def set_degraded(self, on: bool) -> None:
        """While on, every tick emits one token per slot (decode_steps
        forced to 1) and speculative rounds are bypassed. Outputs stay
        the target's: the plain step picks the target's own tokens."""
        self.degraded = bool(on)

    @torch.inference_mode()
    def prefill_export(self, prompt_ids) -> KVHandoff:
        """Prefill ``prompt_ids`` and export its KV pages and next-token
        logits as a :class:`KVHandoff` instead of activating a slot: the
        prefill side of prefill/decode disaggregation. The pages are
        allocated, written, copied to the host and freed. Paged mode
        only (the payload is pages)."""
        enforce(self.paged, "prefill_export requires paged mode "
                "(pages=N) — the handoff payload is KV pages")
        # the deadline check comes BEFORE the prefill: an expired request
        # never costs device work (the typed drop)
        dl = _reliability.current()
        if dl is not None and dl.expired():
            reject_cause("deadline")
            dl.check("prefill export")   # raises DeadlineExceededError
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        plen = len(prompt)
        enforce(plen >= 1, "empty prompt")
        enforce(plen <= self.capacity,
                "prompt %s exceeds prefill capacity %s", plen,
                self.capacity)
        ps = self.page_size
        m = -(-plen // ps)
        ids = self._allocator.alloc(m)       # typed error when exhausted
        telem = telemetry.enabled()
        ctx = _tracing.current() if telem else None
        cm = (_tracing.span("serve.prefill.export", ctx=ctx, plen=plen,
                            pages=int(m)) if telem else _NULL_CM)
        try:
            with cm:
                row = np.zeros((self.n_log,), np.int32)
                row[:m] = ids
                lb = self._bucket_len(plen)
                padded = np.zeros((lb,), np.int64)
                padded[:plen] = prompt
                if telem:
                    _recompile.record("serving.prefill", padded)
                logits = self._prefill_paged(
                    torch.as_tensor(row, device=self.device),
                    torch.as_tensor(padded, device=self.device), plen)
                quant = self._allocator.kv_dtype is not None
                blocks = []
                for kp, vp in self.pools:
                    payload = []
                    for pool in (kp, vp):
                        got = paged_kv.export_pages(pool, ids)
                        payload.append(tuple(a.cpu().numpy() for a in got)
                                       if quant else got.cpu().numpy())
                    blocks.append(tuple(payload))
                return KVHandoff(prompt, plen,
                                 logits.float().cpu().numpy(), blocks, ps,
                                 self._allocator.kv_dtype, trace=ctx,
                                 deadline=dl)
        finally:
            self._allocator.free(ids)

    def inject_prefilled(self, handoff: KVHandoff, max_new: int,
                         stream: Optional[TokenStream] = None) -> int:
        """Admit a request whose prompt KV arrives prefilled (a
        :class:`KVHandoff`): at admission the decoder allocates pages,
        imports the payload and activates the slot from the handoff's
        logits; no prompt token runs through this decoder's prefill.
        Queues like :meth:`submit`; returns the request id."""
        enforce(self.paged, "inject_prefilled requires paged mode "
                "(pages=N) on the decode replica")
        enforce(isinstance(handoff, KVHandoff),
                "inject_prefilled takes a KVHandoff, got %s",
                type(handoff).__name__)
        enforce(handoff.page_size == self.page_size,
                "handoff page_size %s != replica page_size %s",
                handoff.page_size, self.page_size)
        al = self._allocator
        enforce(handoff.kv_dtype == al.kv_dtype,
                "handoff kv_dtype %r != replica kv_dtype %r — the storage "
                "form crosses the wire intact", handoff.kv_dtype,
                al.kv_dtype)
        enforce(len(handoff.blocks) == len(self.pools),
                "handoff has %s blocks, replica model has %s",
                len(handoff.blocks), len(self.pools))
        enforce(stream is None or isinstance(stream, TokenStream),
                "stream= takes a serving.TokenStream, got %s",
                type(stream).__name__)
        r = Request(self._next_rid, handoff.prompt, max_new)
        self._check_budget(len(r.prompt), max_new)
        r.handoff = handoff
        r.stream = stream
        self._next_rid += 1
        r.t_submit = time.perf_counter()
        # the handoff carries the REQUEST's deadline (an absolute epoch:
        # the remaining budget, not a per-hop reset); a bound ambient
        # deadline wins, as a bound trace context does below
        r.deadline = _reliability.current() or handoff.deadline
        if telemetry.enabled():
            self._note_request(r, _tracing.current() or handoff.trace)
        self.queue.append(r)
        return r.rid

    def _import_handoff(self, s: int, r: Request) -> None:
        """Write the handoff payload into the slot's freshly allocated
        pages and activate from the handoff's logits."""
        h = r.handoff
        cm = (_tracing.span("serve.handoff.import", ctx=r.trace,
                            plen=h.plen, slot=s)
              if telemetry.enabled() else _NULL_CM)
        with cm:
            m = -(-h.plen // self.page_size)
            ids = self._slot_pages[s][:m]
            for (kp, vp), (pk, pv) in zip(self.pools, h.blocks):
                paged_kv.import_pages(kp, ids, pk)
                paged_kv.import_pages(vp, ids, pv)
            self._activate(s, r, torch.as_tensor(h.logits,
                                                 device=self.device), h.plen)

    # ----- prefill ---------------------------------------------------------

    def _bucket_len(self, n: int) -> int:
        b = self.bucket
        # clamp to capacity: a bucket past the arena would clamp the
        # cache write window (submit guarantees plen + max_new fits)
        return min(max(b, ((n + b - 1) // b) * b), self.capacity)

    def _prefill(self, s: int, padded: torch.Tensor, plen: int):
        """Contiguous prefill of slot ``s``: the padded prompt runs
        cache-only at positions [0, lb) (positions >= plen write junk
        above the cursor, masked and later overwritten); the next-token
        logits come from a one-position re-step of the last prompt token
        (an idempotent K/V rewrite at plen-1 with a single-row head)."""
        model = self.model

        def body(row):
            _, row = model._chunk_logits(padded[None], row, 0, head=False)
            return model._step_logits(padded[plen - 1:plen], row, plen - 1)

        return _row_apply(self.caches, s, body)[0]

    def _restep_paged(self, row: torch.Tensor, tok, pos: int):
        """Next-token logits of ``tok`` (an int, or a (1,) tensor on the
        device) at ``pos`` on a paged row: one position through the paged
        decode kernel at B=1 (an idempotent K/V rewrite)."""
        if not torch.is_tensor(tok):
            tok = torch.full((1,), tok, dtype=torch.int64,
                             device=self.device)
        logits, self.pools = self.model._step_logits_paged(
            tok, self.pools, row[None],
            torch.full((1,), pos, dtype=torch.int32, device=self.device))
        return logits[0]

    def _prefill_paged(self, row: torch.Tensor, padded: torch.Tensor,
                       plen: int, t0: int = 0):
        """Paged prefill of ``padded`` from position ``t0`` (a
        page-aligned prefix hit's frontier, else 0): chunk-write it into
        the row's pages cache-only, then re-step the last prompt token
        (the paged decode kernel at B=1) for the next-token logits."""
        _, self.pools = self.model._chunk_logits_paged(
            padded[None], self.pools, row, t0, head=False)
        return self._restep_paged(row, padded[plen - 1 - t0:plen - t0],
                                  plen - 1)

    def _prefill_tick(self):
        """Advance chunked prefill by one chunk (FIFO across admitting
        slots), which bounds the prefill work of a loop iteration so
        active slots keep their decode cadence. After the final chunk
        the slot activates through the last-token re-step."""
        if not self._pf_order:
            return
        s = self._pf_order[0]
        st = self._pf[s]
        padded, plen, off, r = st["padded"], st["plen"], st["off"], st["r"]
        c = self.prefill_chunk
        model = self.model
        if off < plen:
            t0 = off
            if t0 + c > self.capacity:
                # slide the final chunk back so its write cannot clamp
                # below the frontier (the overlap rewrites the same real
                # tokens); paged mode never takes this (page demand >=
                # the chunk frontier)
                t0 = self.capacity - c
            toks = torch.as_tensor(padded[t0:t0 + c], device=self.device)
            if self.paged:
                _, self.pools = model._chunk_logits_paged(
                    toks[None], self.pools,
                    torch.as_tensor(self.table[s], device=self.device), t0,
                    head=False)
            else:
                _row_apply(self.caches, s, lambda row: model._chunk_logits(
                    toks[None], row, t0, head=False))
            st["off"] = t0 + c
            if st["off"] < plen:
                return
        last = int(padded[plen - 1])
        if self.paged:
            logits = self._restep_paged(
                torch.as_tensor(self.table[s], device=self.device), last,
                plen - 1)
        else:
            tok = torch.full((1,), last, dtype=torch.int64,
                             device=self.device)
            logits = _row_apply(self.caches, s, lambda row: model._step_logits(
                tok, row, plen - 1))[0]
        self._pf[s] = None
        self._pf_order.pop(0)
        self._activate(s, r, logits, plen)

    # ----- prefix cache ----------------------------------------------------

    def _prefix_key(self, prompt: np.ndarray, n: int) -> bytes:
        return np.ascontiguousarray(prompt[:n], np.int32).tobytes()

    def _lookup_prefix(self, prompt: np.ndarray):
        """Longest registered page-aligned prefix of ``prompt`` ->
        (pages, cached_len); the hit moves to the registry's young end
        (the registry is an insertion-ordered LRU)."""
        if not self._prefix_registry:
            return None, 0
        ps = self.page_size
        for k in range(min(len(prompt) // ps, self.n_log), 0, -1):
            key_t = self._prefix_key(prompt, k * ps)
            e = self._prefix_registry.pop(key_t, None)
            if e is not None:
                self._prefix_registry[key_t] = e       # LRU re-insert
                return e, k * ps
        return None, 0

    def _evict_prefixes(self, want: int):
        """Drop the oldest registry entries until ``want`` pages are free
        (pages still held by live requests stay allocated)."""
        while self._prefix_registry and self._allocator.free_pages < want:
            key_t = next(iter(self._prefix_registry))
            self._allocator.free(self._prefix_registry.pop(key_t))

    def _try_alloc_paged(self, s: int, r: Request):
        """Paged admission: prefix lookup, pin, evict, alloc; installs
        the slot's table row. Returns the cached prefix length, or None
        when the pool cannot hold the request yet (the caller requeues)."""
        plen = len(r.prompt)
        # a handoff never takes a hit: its payload is imported over the
        # allocated pages, and importing onto shared pages would change
        # every other holder's KV
        if self.prefix_cache and r.handoff is None:
            self.prefix_lookups += 1
            hit, cached = self._lookup_prefix(r.prompt)
        else:
            hit, cached = None, 0
        if hit is not None:
            # pin before any eviction: evicting the hit's own entry would
            # otherwise free its pages and alloc() would hand them back as
            # new ones (one physical page twice in one table)
            self._allocator.share(hit)
        need = -(-(plen + r.max_new + self._extra) // self.page_size)
        need_new = need - cached // self.page_size
        if need_new > self._allocator.free_pages:
            self._evict_prefixes(need_new)
        if need_new > self._allocator.free_pages:
            if hit is not None:
                self._allocator.free(hit)      # unpin
            return None                        # wait for completions
        new_ids = self._allocator.alloc(need_new)
        if hit is not None:
            self.prefix_hits += 1
            ids = np.concatenate([hit, new_ids])
        else:
            ids = new_ids
        row = np.zeros((self.n_log,), np.int32)
        row[:need] = ids
        self.table[s] = row
        self._slot_pages[s] = ids
        return cached

    # ----- admission -------------------------------------------------------

    def _admit(self):
        """Fill every free slot from the queue. Monolithic mode runs the
        whole prefill (and first token) here; chunked mode only
        allocates and queues the slot for :meth:`_prefill_tick`. Paged
        mode backpressures: a request whose page demand exceeds the free
        pool stays queued until completions free pages."""
        for s in range(self.slots):
            if self.active[s] or self._pf[s] is not None or not self.queue:
                continue
            r = self.queue.pop(0)
            # a request that expired while queued is dropped typed before
            # any prefill work, never silently computed
            while r.deadline is not None and r.deadline.expired():
                self._expire_request(r, where="queue")
                if not self.queue:
                    r = None
                    break
                r = self.queue.pop(0)
            if r is None:
                break
            plen = len(r.prompt)
            lb = self._bucket_len(plen)
            padded = np.zeros((lb,), np.int64)
            padded[:plen] = r.prompt
            cached = 0
            if self.paged:
                cached = self._try_alloc_paged(s, r)
                if cached is None:
                    reject_cause("pool_exhausted")
                    self.queue.insert(0, r)
                    break
            if r.deadline is not None:
                # slot-resident from here on: the per-tick expiry sweep
                # (gated on this count) owns the deadline now
                self._dl_active += 1
            self.owner[s] = r
            self._slot_gen[s] = self.gen_count
            self.gen_count += 1
            dev_padded = torch.as_tensor(padded, device=self.device)
            if self.draft is not None:
                # the draft arena needs the whole prompt whatever the
                # target's prefix hit (prefix pages hold the target's K/V)
                draft = self.draft
                _row_apply(self.caches_d, s, lambda row: draft._chunk_logits(
                    dev_padded[None], row, 0, head=False))
            if r.handoff is not None:
                # prefilled KV arrived with the request: import and go
                # live, with no local prefill (chunked deferral included)
                self._import_handoff(s, r)
                continue
            if self.prefill_chunk is not None:
                # defer: the chunk grid starts at the cached frontier
                # (page-aligned, hence chunk-aligned); park the cursor so
                # ticks cannot land junk below the frontier; the tick
                # reads fixed-size chunks, so pad to the chunk grid
                c = self.prefill_chunk
                grid = np.zeros((max(1, -(-plen // c)) * c,), np.int64)
                grid[:plen] = r.prompt
                self._pf[s] = {"padded": grid, "plen": plen, "off": cached,
                               "r": r}
                self._pf_order.append(s)
                self.t[s] = self.capacity
                continue
            telem = telemetry.enabled()
            if telem:
                # a new padded shape here is a new prefill bucket (the
                # JAX package compiles one program per bucket); chunked
                # mode left above, it goes by chunk size
                _recompile.record("serving.prefill", padded)
            pf_cm = (_tracing.span("serve.prefill", ctx=r.trace, plen=plen,
                                   slot=s, cached=cached)
                     if telem else _NULL_CM)
            with pf_cm:
                if self.paged:
                    row = torch.as_tensor(self.table[s], device=self.device)
                    if cached == 0:
                        cost = (_costs.counting(
                            f"serving.prefill[paged,{lb}]",
                            origin="serving", device=self.device)
                            if telem else _NULL_CM)
                        with cost:
                            logits = self._prefill_paged(row, dev_padded,
                                                         plen)
                    elif cached < plen:
                        # only the uncached suffix, from the page-aligned
                        # frontier, then the last-token re-step
                        suf = r.prompt[cached:]
                        spad = np.zeros((self._bucket_len(len(suf)),),
                                        np.int64)
                        spad[:len(suf)] = suf
                        logits = self._prefill_paged(
                            row, torch.as_tensor(spad, device=self.device),
                            plen, t0=cached)
                    else:
                        # the whole prompt is cached: the re-step alone
                        logits = self._restep_paged(row, int(r.prompt[-1]),
                                                    plen - 1)
                else:
                    cost = (_costs.counting(
                        f"serving.prefill[{lb}]", origin="serving",
                        device=self.device) if telem else _NULL_CM)
                    with cost:
                        logits = self._prefill(s, dev_padded, plen)
                self._activate(s, r, logits, plen)

    def _pick(self, logits, gens, poss, salt: int = 0):
        """Next tokens (B,) int32 on the device for (B, V) ``logits``:
        argmax, or a keyed draw at each row's (admission counter,
        position)."""
        return keyed_sample(logits, self.seed, gens, poss, salt,
                            self.temperature, self.top_k,
                            self.top_p).to(torch.int32)

    def _activate(self, s: int, r: Request, logits, plen: int):
        """Admission epilogue: first-token pick and the slot goes live."""
        self.active[s] = True
        self._slot_trace[s] = r.trace
        gen = torch.full((1,), int(self._slot_gen[s]), dtype=torch.int64,
                         device=self.device)
        pos = torch.full((1,), plen, dtype=torch.int64, device=self.device)
        tok = int(self._pick(logits[None], gen, pos)[0])
        self.emitted[s] = [tok]
        r.t_first = time.perf_counter()
        r.t_tokens.append(r.t_first)
        if telemetry.enabled():
            m = _serving_metrics()
            traced = r.trace is not None and r.trace.sampled
            if r.t_submit:
                # a traced sample stamps its trace id onto the bucket it
                # lands in: the p99 row's link to its timeline
                m["ttft"].observe(
                    r.t_first - r.t_submit,
                    exemplar=r.trace.trace_id if traced else None)
            if traced:
                _tracing.event("serve.first_token", ctx=r.trace, rid=r.rid,
                               slot=s)
            m["tokens"].inc()
        self.budget[s] = r.max_new - 1
        self.tok[s] = tok
        self.t[s] = plen
        if r.stream is not None:
            # the first token leaves the arena at activation
            r.stream.offer(self.emitted[s], r.t_first)
        self._maybe_finish(s)

    # ----- decode ticks ----------------------------------------------------

    def _tick_inputs(self):
        """The tick's host state on the device, in one copy: tokens,
        cursors, admission counters (and the page table) as views of one
        int32 buffer. On the card it goes through a pinned staging
        buffer with a copy that does not wait for the card; reusing the
        buffer is safe, since every tick ends in a read that waits for
        the copies before it."""
        parts = [self.tok, self.t, self._slot_gen.astype(np.int32)]
        if self.paged:
            parts.append(self.table.reshape(-1))
        flat = np.concatenate(parts).astype(np.int32)
        if self.device.type == "cpu":
            buf = torch.from_numpy(flat)
        else:
            if self._stage is None:
                self._stage = torch.empty(flat.size, dtype=torch.int32,
                                          pin_memory=True)
                self._dstage = torch.empty(flat.size, dtype=torch.int32,
                                           device=self.device)
            self._stage.numpy()[:] = flat
            self._dstage.copy_(self._stage, non_blocking=True)
            buf = self._dstage
        b = self.slots
        table = (buf[3 * b:].view(b, self.n_log) if self.paged else None)
        return buf[:b], buf[b:2 * b], buf[2 * b:3 * b], table

    def _decode_window(self, kd: int, tok, t, gens, table):
        """``kd`` single-token steps over the whole arena with the picks
        on the device: (slots, kd) int32 tokens, still on the device.
        Idle and retired rows compute junk the host discards (their
        paged writes drop)."""
        model = self.model
        out = []
        for _ in range(kd):
            if self.paged:
                logits, self.pools = model._step_logits_paged(
                    tok, self.pools, table, t)
            else:
                logits, self.caches = model._step_logits_rows(
                    tok, self.caches, t, decode_kernel=True)
            t = t + 1
            tok = self._pick(logits, gens, t)
            out.append(tok)
        return torch.stack(out, dim=1)

    def _emit(self, was_active, toks, counts, now: float) -> int:
        """Append each active row's new tokens in order, finishing per
        token (nothing is emitted past eos or the budget; a mid-window
        finish discards the rest); offer them to streams. Returns the
        tokens emitted."""
        n_emitted = 0
        for s in range(self.slots):
            if not was_active[s]:
                continue
            r = self.owner[s]
            for j in range(int(counts[s])):
                self.emitted[s].append(int(toks[s, j]))
                r.t_tokens.append(now)
                n_emitted += 1
                self.budget[s] -= 1
                self._maybe_finish(s)
                if not self.active[s]:
                    break
            if r.stream is not None and r.result is None:
                # this tick's tokens leave now (a completion streamed
                # through finish above)
                r.stream.offer(self.emitted[s], now)
        return n_emitted

    def _step_multi(self):
        """One plain tick: ``decode_steps`` tokens per slot (1 while
        degraded) and one host read of the (slots, k) token block."""
        if not self.active.any():
            return
        kd = 1 if self.degraded else self.decode_steps
        t0 = time.perf_counter()
        was_active = self.active.copy()
        telem = telemetry.enabled()
        tick_ctx = None
        tick_cm = cost_cm = _NULL_CM
        counted = False
        if telem:
            # the weight token participates: a quant/LoRA swap between
            # runs is a new signature, which (tok, t) alone never shows
            _recompile.record("serving.step", self.tok, self.t,
                              weights=self._weights_fp)
            # one tick advances every active slot, so it rides the first
            # SAMPLED slot's context (an unsampled one must not shadow a
            # sampled neighbour)
            tick_ctx = next((c for c in self._slot_trace
                             if c is not None and c.sampled), None)
            if tick_ctx is not None:
                tick_cm = _tracing.span("serve.decode.tick", ctx=tick_ctx,
                                        k=kd,
                                        n_active=int(was_active.sum()))
            # the step program's cost, counted over its first real call
            counted = not _costs.known(f"serving.step[k={kd}]")
            cost_cm = _costs.counting(f"serving.step[k={kd}]",
                                      origin="serving", device=self.device)
        with tick_cm:
            tok, t, gens, table = self._tick_inputs()
            with cost_cm:
                window = self._decode_window(kd, tok, t, gens, table)
            toks = window.cpu().numpy()
        self._warmed = True
        now = time.perf_counter()
        n_emitted = self._emit(was_active, toks,
                               np.full((self.slots,), kd), now)
        self.tick_count += 1
        self.tick_tokens += n_emitted
        self.tick_capacity += self.slots * kd
        if telem and n_emitted:
            self._note_tick(f"serving.step[k={kd}]", n_emitted, kd,
                            self.slots * kd, t0, tick_ctx, counted)
        # retired rows keep what _maybe_finish left (paged parking)
        keep = was_active & self.active
        self.tok = np.where(keep, toks[:, -1], self.tok).astype(np.int32)
        self.t = np.where(keep, self.t + kd, self.t).astype(np.int32)
        self.tick_seconds += time.perf_counter() - t0

    def _spec_round(self, tok, t, gens, table):
        """One speculative round over the whole arena: gamma draft steps
        per row, one per-row target verify chunk, and the
        Leviathan/Chen modified rejection test, all at per-row cursors.
        Greedy: the accepted drafts are where the two argmaxes agree.
        Sampled: tokens are distributed as the target's own filtered
        chain. Returns (emitted (B, gamma+1), accepted n (B,), the last
        token (B,), the new cursors (B,)) on the device."""
        model, draft, gamma = self.model, self.draft, self.gamma
        sampled = self.sampled
        temp, top_k, top_p, seed = (self.temperature, self.top_k,
                                    self.top_p, self.seed)

        def flp(logits):
            return torch.log_softmax(filter_logits(logits, temp, top_k,
                                                   top_p), dim=-1)

        drafts, qs = [], []
        tokc = tok
        for i in range(gamma):
            logits, self.caches_d = draft._step_logits_rows(
                tokc, self.caches_d, t + i, decode_kernel=True)
            if sampled:
                lq = flp(logits)
                d = keyed_categorical(lq, seed, gens, t, 1 + i)
                qs.append(torch.exp(lq))
            else:
                d = torch.argmax(logits, dim=-1)
            tokc = d.to(torch.int32)
            drafts.append(tokc)
        # cache d_{gamma-1}'s K/V at t+gamma (logits unused): on a fully
        # accepted round no later write covers that position before the
        # draft's queries attend it
        _, self.caches_d = draft._step_logits_rows(
            drafts[-1], self.caches_d, t + gamma, decode_kernel=True)
        drafts_b = torch.stack(drafts, dim=1)                 # (B, gamma)
        chunk = torch.cat([tok[:, None], drafts_b], dim=1)
        if self.paged:
            logits_t, self.pools = model._chunk_logits_paged_rows(
                chunk, self.pools, table, t)
        else:
            logits_t, self.caches = model._chunk_logits_rows(
                chunk, self.caches, t)
        idx = drafts_b.long()[..., None]
        if sampled:
            p_all = torch.exp(flp(logits_t))              # (B, gamma+1, V)
            q_b = torch.stack(qs, dim=1)                  # (B, gamma, V)
            pi = torch.gather(p_all[:, :gamma], 2, idx)[..., 0]
            qi = torch.gather(q_b, 2, idx)[..., 0]
            u = keyed_uniform(seed, gens, t, 1 + gamma, gamma)
            accept = u * qi < pi               # u < p/q without the /0
            n = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
            # the residual max(p_n - q_n, 0), normalised; at n == gamma q
            # is all zero, so this is the bonus draw from p_gamma
            v = p_all.shape[-1]
            p_n = torch.gather(p_all, 1, n.long()[:, None, None].expand(
                -1, 1, v))[:, 0]
            q_n = torch.gather(q_b, 1, n.clamp(max=gamma - 1).long()[
                :, None, None].expand(-1, 1, v))[:, 0]
            q_n = torch.where((n < gamma)[:, None], q_n, 0.0)
            res = torch.clamp(p_n - q_n, min=0.0)
            norm = res.sum(dim=1, keepdim=True)
            res = torch.where(norm > 0, res / norm, p_n)
            corr = keyed_categorical(
                torch.where(res > 0, torch.log(res), float("-inf")), seed,
                gens, t, 2 + gamma)
        else:
            tgt = torch.argmax(logits_t, dim=-1)           # (B, gamma+1)
            accept = drafts_b == tgt[:, :gamma]
            n = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
            corr = torch.gather(tgt, 1, n.long()[:, None])[:, 0]
        corr = corr.to(torch.int32)
        slot = torch.arange(gamma + 1, device=tok.device)[None, :]
        ext = torch.cat([drafts_b, drafts_b[:, -1:]], dim=1)
        emitted = torch.where(slot < n[:, None], ext,
                              torch.where(slot == n[:, None],
                                          corr[:, None], 0))
        return emitted.to(torch.int32), n.to(torch.int32), corr, \
            (t + n + 1).to(torch.int32)

    def _step_spec(self):
        """One speculative tick: the round on the device, one host read
        of (emitted, n, last token, cursors), then each row's accepted
        prefix and correction appended with per-token finishing."""
        if not self.active.any():
            return
        t0 = time.perf_counter()
        was_active = self.active.copy()
        tok, t, gens, table = self._tick_inputs()
        emitted, n, new_tok, new_t = self._spec_round(tok, t, gens, table)
        g1 = self.gamma + 1
        packed = torch.cat([emitted, n[:, None], new_tok[:, None],
                            new_t[:, None]], dim=1).cpu().numpy()
        emitted, n_np = packed[:, :g1], packed[:, g1]
        new_tok, new_t = packed[:, g1 + 1], packed[:, g1 + 2]
        self._warmed = True
        now = time.perf_counter()
        self.spec_rounds += 1
        self.spec_row_rounds += int(was_active.sum())
        self.spec_accepted += int(n_np[was_active].sum())
        n_emitted = self._emit(was_active, emitted, n_np + 1, now)
        self.tick_count += 1
        self.tick_tokens += n_emitted
        self.tick_capacity += self.slots * g1
        if telemetry.enabled():
            m = _serving_metrics()
            m["spec_rounds"].inc(int(was_active.sum()))
            m["spec_accepted"].inc(int(n_np[was_active].sum()))
            if self.spec_row_rounds:
                m["spec_accept_rate"].set(
                    self.spec_accepted / self.spec_row_rounds)
            if n_emitted:
                spec_ctx = next((c for c in self._slot_trace
                                 if c is not None and c.sampled), None)
                m["tokens"].inc(n_emitted)
                m["decode_latency"].observe(
                    (time.perf_counter() - t0) / n_emitted,
                    exemplar=(spec_ctx.trace_id
                              if spec_ctx is not None else None))
        # live rows advance by their accepted count + 1
        keep = was_active & self.active
        self.tok = np.where(keep, new_tok, self.tok).astype(np.int32)
        self.t = np.where(keep, new_t, self.t).astype(np.int32)
        self.tick_seconds += time.perf_counter() - t0

    def _note_tick(self, prog: str, n_emitted: int, kd: int,
                   capacity: int, t0: float, ctx,
                   counted: bool = False) -> None:
        """A plain tick's telemetry: tokens, the per-token decode latency
        (the tick's host wall over its tokens), the serving goodput and
        the ITL sentinel. The sentinel reads a slot's inter-token latency,
        the tick's wall over the ``kd`` tokens each slot gets, so an
        arena draining to one slot does not read as a regression. A
        degraded arena, or a tick the cost ledger ``counted`` (slowed by
        the count itself), never feeds a baseline."""
        m = _serving_metrics()
        m["tokens"].inc(n_emitted)
        wall = time.perf_counter() - t0
        m["decode_latency"].observe(
            wall / n_emitted,
            exemplar=ctx.trace_id if ctx is not None else None)
        _profiling.goodput().note_tick(n_emitted, capacity)
        if not counted:
            _profiling.sentinel().observe(prog, self._backend(), wall / kd,
                                          kind="itl", degraded=self.degraded)

    def _step(self):
        if self._dl_active:
            # the per-tick deadline sweep: an expired slot is torn down
            # BEFORE the next tick, so no device work is spent on a
            # request nobody waits for (zero cost while no resident
            # request carries a deadline)
            self._expire_slots()
        if self.draft is not None and not self.degraded:
            return self._step_spec()
        return self._step_multi()

    def _backend(self) -> str:
        """The sentinel's backend key (the card's kind, or ``cpu``),
        resolved once."""
        if self._backend_name is None:
            self._backend_name = _costs.backend_key(self.device)
        return self._backend_name

    def _expire_request(self, r: Request, where: str = "queue") -> None:
        """Drop an expired request typed: a done record with
        ``deadline_exceeded`` set and no tokens (``run()`` returns None
        for it), counted under ``cause="deadline"``; its stream fails
        with :class:`DeadlineExceededError`."""
        reject_cause("deadline")
        r.result = None
        r.deadline_exceeded = True
        r.t_done = time.perf_counter()
        self.done[r.rid] = r
        if r.stream is not None:
            r.stream.fail(_reliability.DeadlineExceededError(
                f"request {r.rid} deadline expired in {where}"))
        if (telemetry.enabled() and r.trace is not None
                and r.trace.sampled):
            _tracing.event("serve.deadline_exceeded", ctx=r.trace,
                           rid=r.rid, where=where)

    def _expire_slots(self) -> None:
        """Tear down every slot-resident request whose deadline passed
        (active slots and parked chunked-prefill slots)."""
        now = time.time()
        for s in range(self.slots):
            st = self._pf[s]
            r = st["r"] if st is not None else self.owner[s]
            if r is None or r.deadline is None:
                continue
            if now < r.deadline.t_end:
                continue
            self._expire_request(
                r, where="prefill" if st is not None else "decode")
            self._dl_active -= 1
            if st is not None:
                self._pf[s] = None
                self._pf_order.remove(s)
            self.owner[s] = None
            self._slot_trace[s] = None
            self.active[s] = False
            self.emitted[s] = []
            if self.paged and self._slot_pages[s] is not None:
                # freed pages may be reallocated: park the cursor past
                # capacity so the retired slot's writes drop
                self._allocator.free(self._slot_pages[s])
                self._slot_pages[s] = None
                self.t[s] = self.capacity

    def _maybe_finish(self, s: int):
        r = self.owner[s]
        hit_eos = (self.eos_id is not None
                   and self.emitted[s][-1] == self.eos_id)
        if not (hit_eos or self.budget[s] <= 0):
            return
        r.result = np.asarray(self.emitted[s], np.int32)
        r.t_done = time.perf_counter()
        self.done[r.rid] = r
        if r.stream is not None:
            # tokens not yet buffered are served from the completion
            # record, then the end record
            r.stream.finish(r.result, r.t_done)
        if telemetry.enabled():
            _serving_metrics()["completed"].inc()
            if r.trace is not None and r.trace.sampled:
                _tracing.event("serve.done", ctx=r.trace, rid=r.rid,
                               n_tokens=len(r.result), eos=bool(hit_eos))
        if r.deadline is not None:
            self._dl_active -= 1
        self.owner[s] = None
        self._slot_trace[s] = None
        self.active[s] = False
        self.emitted[s] = []
        if self.paged and self._slot_pages[s] is not None:
            if self.prefix_cache:
                # register the prompt's page-aligned prefix for reuse
                # (one registry reference; a present key stays as it is)
                ps = self.page_size
                m = len(r.prompt) // ps
                if m >= 1:
                    key_t = self._prefix_key(r.prompt, m * ps)
                    if key_t not in self._prefix_registry:
                        pref = self._slot_pages[s][:m]
                        self._allocator.share(pref)
                        self._prefix_registry[key_t] = np.asarray(pref)
            # freed pages may be handed to another request, so the
            # retired slot's later tick writes must drop: park its cursor
            # past capacity
            self._allocator.free(self._slot_pages[s])
            self._slot_pages[s] = None
            self.t[s] = self.capacity
