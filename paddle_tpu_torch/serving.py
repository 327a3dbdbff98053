"""Continuous-batching LM serving loop (counterpart of
paddle_tpu/serving.py): a fixed arena of ``slots`` KV caches decodes in
lockstep — every tick advances all active slots one token, each at its
own cursor. Requests queue host-side; when a slot finishes (eos or its
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

PyTorch idiom: the arena runs under ``torch.inference_mode()`` and its
caches and pools are written IN PLACE; a slot's prefill works on a
batch-1 view of its arena row, so nothing is written back.

Left for later slices (each raises a typed error naming its ROADMAP.md
item): prefix caching, chunked prefill, speculative decoding,
``decode_steps > 1``, KV handoff, per-token streams, and the debug
server / flight recorder / preemption hooks of ``run``."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .core.dtypes import default_dtype, to_dtype
from .core.enforce import UnimplementedError, enforce
from .core.places import resolve_device
from .ops import paged_kv
from .ops.sampling import sample_from_logits

__all__ = ["BatchedDecoder", "PagedKVPool", "Request"]


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
    holds."""

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
        return np.asarray(got, np.int32)

    def free(self, ids) -> None:
        """Return pages to the free list. Freeing a page twice would hand
        it to two requests, so it is a typed error."""
        for i in np.asarray(ids).reshape(-1):
            i = int(i)
            enforce(0 <= i < self.pages,
                    "page id %s outside pool (%s pages)", i, self.pages)
            enforce(i not in self._free_set, "double free of page %s", i)
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


def _reject_later_slices(prefix_cache, prefill_chunk, draft, gamma,
                         decode_steps):
    """BatchedDecoder options of later slices raise; none is accepted and
    then ignored."""
    if prefix_cache:
        raise UnimplementedError(
            "prefix_cache is not ported yet: ROADMAP queue 1 item 7")
    if prefill_chunk is not None:
        raise UnimplementedError(
            "prefill_chunk (chunked prefill) is not ported yet: ROADMAP "
            "queue 1 item 7")
    if draft is not None or gamma != 4:
        raise UnimplementedError(
            "draft=/gamma= (speculative decoding) is not ported yet: "
            "ROADMAP queue 1 item 7")
    if decode_steps != 1:
        raise UnimplementedError(
            f"decode_steps={decode_steps} (multi-token ticks) is not "
            "ported yet: ROADMAP queue 1 item 6")


class BatchedDecoder:
    """Slot-based continuous batching over a GPT-family causal LM.

    ``submit()`` enqueues; ``run()`` drives to completion and returns
    {request_id: np.ndarray of generated ids (prompt excluded)}. Sampling
    parameters apply to every request (temperature=0 = greedy; sampled
    modes draw from ``generator``, a ``torch.Generator`` on the device);
    ``eos_id`` ends a request early. ``kv_dtype="int8"`` (paged mode
    only) keeps the page pools in int8. ``device``: the CUDA card when
    None (raises when there is none); it must be the model's device."""

    def __init__(self, model, slots: int, capacity: int, *,
                 eos_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, prompt_bucket: int = 16,
                 pages: Optional[int] = None, page_size: int = 128,
                 prefix_cache: bool = False, kv_dtype=None,
                 prefill_chunk: Optional[int] = None, draft=None,
                 gamma: int = 4, decode_steps: int = 1, device=None):
        _reject_later_slices(prefix_cache, prefill_chunk, draft, gamma,
                             decode_steps)
        self.device = resolve_device(device)
        enforce(model.device == self.device,
                "the model lives on %s but the decoder on %s", model.device,
                self.device)
        enforce(slots >= 1, "slots must be >= 1, got %s", slots)
        enforce(capacity >= prompt_bucket,
                "capacity %s < prompt bucket %s", capacity, prompt_bucket)
        self.model = model
        self.slots, self.capacity = slots, capacity
        self.eos_id = eos_id
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self.sampled = float(temperature) != 0.0
        enforce(not self.sampled or generator is not None,
                "temperature > 0 samples and needs a torch.Generator")
        self.generator = generator
        self.bucket = prompt_bucket
        self.paged = pages is not None
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
                dtype=attn0.k_proj.weight.dtype, arrays=False,
                kv_dtype=kv_dtype, device=self.device)
            self.page_size = page_size
            self.n_log = capacity // page_size
            al = self._allocator
            self.pools = [(al.empty_pool(), al.empty_pool())
                          for _ in model.blocks]
            self.table = np.zeros((slots, self.n_log), np.int32)
            self._slot_pages: List[Optional[np.ndarray]] = [None] * slots
        else:
            enforce(kv_dtype is None,
                    "kv_dtype requires paged mode (pages=N) — the "
                    "contiguous arena has no quantized form")
            self.caches = [blk.self_attn.init_cache(slots, capacity)
                           for blk in model.blocks]
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
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        self._next_rid = 0
        # tick accounting: ticks run and host seconds spent in them
        self.tick_count = 0
        self.tick_seconds = 0.0

    # ----- host API --------------------------------------------------------

    def submit(self, prompt_ids, max_new: int, stream=None) -> int:
        """Enqueue one request; returns its id."""
        if stream is not None:
            raise UnimplementedError(
                "per-token streams (TokenStream) are not ported yet: "
                "ROADMAP queue 1 item 6")
        enforce(len(np.asarray(prompt_ids).reshape(-1)) >= 1,
                "empty prompt")
        enforce(max_new >= 1, "max_new must be >= 1, got %s", max_new)
        r = Request(self._next_rid, prompt_ids, max_new)
        enforce(len(r.prompt) + max_new <= self.capacity,
                "prompt %s + max_new %s exceeds slot capacity %s",
                len(r.prompt), max_new, self.capacity)
        if self.paged:
            # a demand beyond the whole pool could never be admitted
            need = -(-(len(r.prompt) + max_new) // self.page_size)
            enforce(need <= self._allocator.pages,
                    "request needs %s pages but the pool only has %s",
                    need, self._allocator.pages)
        self._next_rid += 1
        r.t_submit = time.perf_counter()
        self.queue.append(r)
        return r.rid

    @torch.inference_mode()
    def run(self, debug_port: Optional[int] = None, flight_recorder=None,
            preemption=None) -> Dict[int, np.ndarray]:
        """Drive until every submitted request completes."""
        if debug_port is not None or flight_recorder is not None:
            raise UnimplementedError(
                "debug_port= / flight_recorder= (telemetry) are not ported "
                "yet: ROADMAP queue 1 item 8")
        if preemption is not None:
            raise UnimplementedError(
                "preemption= (resilience) is not ported yet: ROADMAP queue "
                "1 item 8")
        while self.queue or self.active.any():
            self._admit()
            self._step()
        out = {rid: r.result for rid, r in self.done.items()}
        self.done = {}
        return out

    # ----- internals -------------------------------------------------------

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

    def _prefill_paged(self, s: int, padded: torch.Tensor, plen: int):
        """Paged prefill: chunk-write the prompt into the slot's pages
        cache-only, then re-step the last token (the paged decode kernel
        at B=1) for the next-token logits."""
        model = self.model
        row = torch.as_tensor(self.table[s], device=self.device)
        _, self.pools = model._chunk_logits_paged(padded[None], self.pools,
                                                  row, 0, head=False)
        logits, self.pools = model._step_logits_paged(
            padded[plen - 1:plen], self.pools, row[None],
            torch.full((1,), plen - 1, dtype=torch.int32,
                       device=self.device))
        return logits[0]

    def _try_alloc_paged(self, s: int, r: Request) -> bool:
        """Allocate the request's pages and install the slot's table row;
        False when the pool cannot hold it yet (the caller requeues)."""
        need = -(-(len(r.prompt) + r.max_new) // self.page_size)
        if need > self._allocator.free_pages:
            return False
        ids = self._allocator.alloc(need)
        row = np.zeros((self.n_log,), np.int32)
        row[:need] = ids
        self.table[s] = row
        self._slot_pages[s] = ids
        return True

    def _admit(self):
        """Fill every free slot from the queue: prefill plus first token.
        Paged mode backpressures — a request whose page demand exceeds
        the free pool stays queued until completions free pages."""
        for s in range(self.slots):
            if self.active[s] or not self.queue:
                continue
            r = self.queue.pop(0)
            if self.paged and not self._try_alloc_paged(s, r):
                self.queue.insert(0, r)
                break
            plen = len(r.prompt)
            padded = np.zeros((self._bucket_len(plen),), np.int64)
            padded[:plen] = r.prompt
            padded = torch.as_tensor(padded, device=self.device)
            self.owner[s] = r
            if self.paged:
                logits = self._prefill_paged(s, padded, plen)
            else:
                logits = self._prefill(s, padded, plen)
            self._activate(s, r, logits, plen)

    def _pick(self, logits) -> np.ndarray:
        """Next tokens for (B, V) logits, on the host."""
        nxt = sample_from_logits(logits, self.generator, self.temperature,
                                 self.top_k, self.top_p)
        return nxt.to(torch.int32).cpu().numpy()

    def _activate(self, s: int, r: Request, logits, plen: int):
        """Admission epilogue: first-token pick and the slot goes live."""
        self.active[s] = True
        tok = int(self._pick(logits[None])[0])
        self.emitted[s] = [tok]
        r.t_first = time.perf_counter()
        self.budget[s] = r.max_new - 1
        self.tok[s] = tok
        self.t[s] = plen
        self._maybe_finish(s)

    def _step(self):
        """One decode tick over the whole arena: every slot advances one
        position at its own cursor; idle and retired rows compute junk
        the host discards (their paged writes drop)."""
        if not self.active.any():
            return
        t0 = time.perf_counter()
        was_active = self.active.copy()
        tok = torch.as_tensor(self.tok, device=self.device)
        t = torch.as_tensor(self.t, device=self.device)
        if self.paged:
            logits, self.pools = self.model._step_logits_paged(
                tok, self.pools, torch.as_tensor(self.table,
                                                 device=self.device), t)
        else:
            logits, self.caches = self.model._step_logits_rows(
                tok, self.caches, t, decode_kernel=True)
        toks = self._pick(logits)
        self.tick_count += 1
        self.tick_seconds += time.perf_counter() - t0
        for s in range(self.slots):
            if not was_active[s]:
                continue
            self.emitted[s].append(int(toks[s]))
            self.budget[s] -= 1
            self._maybe_finish(s)
        # retired rows keep what _maybe_finish left (paged parking)
        keep = was_active & self.active
        self.tok = np.where(keep, toks, self.tok).astype(np.int32)
        self.t = np.where(keep, self.t + 1, self.t).astype(np.int32)

    def _maybe_finish(self, s: int):
        r = self.owner[s]
        hit_eos = (self.eos_id is not None
                   and self.emitted[s][-1] == self.eos_id)
        if not (hit_eos or self.budget[s] <= 0):
            return
        r.result = np.asarray(self.emitted[s], np.int32)
        r.t_done = time.perf_counter()
        self.done[r.rid] = r
        self.owner[s] = None
        self.active[s] = False
        self.emitted[s] = []
        if self.paged and self._slot_pages[s] is not None:
            # freed pages may be handed to another request, so the
            # retired slot's later tick writes must drop: park its
            # cursor past capacity
            self._allocator.free(self._slot_pages[s])
            self._slot_pages[s] = None
            self.t[s] = self.capacity
