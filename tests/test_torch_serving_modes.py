"""The serving arena's options in the port (paddle_tpu_torch/serving.py)
against the JAX package and against the port's own plain arena:
``decode_steps``, the prefix cache, chunked prefill, ``warm_step`` /
``ready`` / ``set_degraded``, :class:`TokenStream`, the KV handoff
across the packages, and W8A16 (``quant/weight_only.py``).

Model: GPTConfig.tiny() from the JAX package (seed 60), its weights
moved into the port by name; the JAX side runs once per module (module
fixtures). Gates and why:
- ``decode_steps=3`` equals k=1 token for token, greedy and sampled, in
  both cache forms: the same kernels' plain versions at the same batch,
  and keyed draws at the same (admission counter, position);
- options that change the prefill's arithmetic (a prefix hit's suffix
  prefill, spec) agree with a cold run on >= 0.9 of the tokens (the JAX
  tests' bound: untrained near ties) and every float token sits within
  1e-4 of the max of JAX's teacher-forced logits at its position;
- chunked prefill equals monolithic prefill exactly (the JAX tests' own
  gate: chunk boundaries do not change the attention);
- a KVHandoff's bytes cross between the packages both ways: the injected
  pages and logits are the exporter's bits, so the tokens equal those of
  the exporting package's own decode of the same pages, and agree with
  the other package's up to a near tie (top-2 gap < 1e-4);
- W8A16: the buffers equal JAX's (int8 codes exactly, scales 1e-7) and
  the logits agree at 1e-5; against float32, the JAX package's bound
  (relative norm < 0.03, argmax agreement > 0.9)."""

import io
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import quant as JQ
from paddle_tpu.models import gpt as JG
from paddle_tpu.serving import BatchedDecoder as JaxDecoder
from paddle_tpu.serving import KVHandoff as JaxHandoff
from paddle_tpu_torch import quant as TQ
from paddle_tpu_torch.core import EnforceError, UnimplementedError
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.serving import BatchedDecoder, KVHandoff, TokenStream
from paddle_tpu_torch.utils.convert import load_numpy_state

PAGED = dict(pages=8, page_size=64)
MODES = {"contiguous": {}, "paged": PAGED}


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 512, n).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    """(jax model, port model), GPTConfig.tiny(), the same weights."""
    pt.seed(60)
    jm = JG.GPTForCausalLM(JG.GPTConfig.tiny()).eval()
    tm = TG.GPTForCausalLM(TG.GPTConfig.tiny(), device="cpu").eval()
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    return jm, tm


def _serve(model, prompts, max_new=12, slots=2, capacity=64, **kw):
    dec = BatchedDecoder(model, slots=slots, capacity=capacity,
                         device="cpu", **kw)
    budgets = max_new if isinstance(max_new, (list, tuple)) else \
        [max_new] * len(prompts)
    rids = [dec.submit(p, n) for p, n in zip(prompts, budgets)]
    outs = dec.run()
    return dec, [outs[r] for r in rids]


def _jax_gap(jm, prompts, outs):
    """Worst (max logit - emitted token's logit) of JAX's teacher-forced
    logits over every emitted token."""
    seqs = [np.concatenate([p, o]) for p, o in zip(prompts, outs)]
    width = max(len(s) for s in seqs)
    batch = np.zeros((len(seqs), width), np.int32)
    for i, s in enumerate(seqs):
        batch[i, :len(s)] = s
    ref = np.asarray(jm(jnp.asarray(batch)))
    worst = 0.0
    for i, (p, o) in enumerate(zip(prompts, outs)):
        rows = ref[i, len(p) - 1:len(p) - 1 + len(o)]
        worst = max(worst, float((rows.max(-1)
                                  - rows[np.arange(len(o)), o]).max()))
    return worst


def _agree(got, want, thresh=0.9):
    n = min(len(got), len(want))
    agree = (got[:n] == want[:n]).mean()
    assert agree >= thresh, (agree, got, want)


# ----- decode_steps ---------------------------------------------------------

MS_PROMPTS = [(5, 200), (9, 201), (4, 202)]


@pytest.mark.parametrize("draw", ["greedy", "sampled"])
@pytest.mark.parametrize("mode", list(MODES))
def test_decode_steps_match_k1(models, mode, draw):
    jm, tm = models
    prompts = [_prompt(n, s) for n, s in MS_PROMPTS]
    kw = dict(MODES[mode])
    if draw == "sampled":
        kw.update(temperature=0.8, top_k=40)

    def run(k):
        gen = torch.Generator().manual_seed(7)
        return _serve(tm, prompts, decode_steps=k,
                      generator=gen if draw == "sampled" else None, **kw)

    _, want = run(1)
    dec, got = run(3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the first token of each request is emitted at admission
    assert dec.tick_tokens == sum(len(o) for o in got) - len(got)
    assert dec.tick_capacity == dec.tick_count * dec.slots * 3
    if draw == "greedy":
        assert _jax_gap(jm, prompts, got) <= 1e-4


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_steps_eos_and_budget_mid_window(models, mode):
    """Budgets not divisible by k and an eos landing mid-window: nothing
    is emitted past either; k=4 equals k=1."""
    _, tm = models
    prompt = _prompt(5, 220)
    _, (free,) = _serve(tm, [prompt], 20, slots=1, **MODES[mode])
    eos = int(free[6])

    def run(k):
        return _serve(tm, [prompt, _prompt(4, 221)], [21, 3], slots=1,
                      eos_id=eos, decode_steps=k, **MODES[mode])[1]

    want, got = run(1), run(4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    hits = np.flatnonzero(got[0] == eos)
    assert len(hits) and hits[0] == len(got[0]) - 1
    assert len(got[1]) <= 3


def test_decode_steps_typed_errors(models):
    _, tm = models
    with pytest.raises(EnforceError, match="decode_steps"):
        BatchedDecoder(tm, slots=1, capacity=64, device="cpu",
                       decode_steps=0)
    dec = BatchedDecoder(tm, slots=1, capacity=32, device="cpu",
                         decode_steps=8)
    with pytest.raises(EnforceError, match="margin"):
        dec.submit(_prompt(8, 240), 18)          # 8 + 18 + 7 > 32


# ----- prefix cache ---------------------------------------------------------

@pytest.mark.parametrize("kv", ["float", "int8"])
def test_prefix_cache_matches_cold(models, kv):
    jm, tm = models
    sys_prompt = _prompt(64, 90)                  # exactly one page
    prompts = [np.concatenate([sys_prompt, _prompt(4 + i, 91 + i)])
               for i in range(3)]
    kw = dict(pages=6, page_size=64, slots=1, capacity=128, max_new=8,
              kv_dtype="int8" if kv == "int8" else None)
    _, cold = _serve(tm, prompts, **kw)
    dec, hot = _serve(tm, prompts, prefix_cache=True, **kw)
    assert dec.prefix_hits == 2 and dec.prefix_lookups == 3
    for h, c in zip(hot, cold):
        _agree(h, c)
    if kv == "float":
        assert _jax_gap(jm, prompts, hot) <= 1e-4
    # the registry keeps the prefix page; the requests released theirs
    assert dec._allocator.free_pages == 6 - 1
    assert len(dec._prefix_registry) == 1


def test_prefix_cache_fully_cached_prompt_and_eviction(models):
    _, tm = models
    p64 = _prompt(64, 95)
    dec = BatchedDecoder(tm, slots=1, capacity=128, pages=3, page_size=64,
                         prefix_cache=True, device="cpu")
    a = dec.submit(p64, 8)
    first = dec.run()[a]
    b = dec.submit(p64, 8)                      # whole prompt cached
    again = dec.run()[b]
    assert dec.prefix_hits == 1
    _agree(again, first)
    # fresh prompts fill the pool: the entry is evicted, no deadlock
    c = dec.submit(_prompt(80, 96), 40)
    d = dec.submit(_prompt(80, 97), 40)
    outs = dec.run()
    assert outs[c].shape == (40,) and outs[d].shape == (40,)


def test_prefix_cache_evicting_the_hit_does_not_corrupt(models):
    """The hit's registry entry is evicted to satisfy the same admission:
    the pinned pages are not handed back as new ones; the request waits,
    and its output agrees with a cold run; no page leaks."""
    _, tm = models
    p = _prompt(64, 98)
    full = np.concatenate([p, _prompt(4, 99)])
    _, (cold,) = _serve(tm, [full], 8, capacity=128, pages=3, page_size=64)
    dec = BatchedDecoder(tm, slots=2, capacity=128, pages=3, page_size=64,
                         prefix_cache=True, device="cpu")
    dec.submit(p, 8)
    dec.run()                                    # registers p's page
    a = dec.submit(_prompt(70, 100), 40)         # needs 2 pages
    b = dec.submit(full, 8)                      # hits p while dry
    outs = dec.run()
    assert dec.prefix_hits <= 1
    assert outs[a].shape == (40,)
    _agree(outs[b], cold)
    held = sum(len(v) for v in dec._prefix_registry.values())
    assert dec._allocator.free_pages + held == 3


def test_prefix_cache_requires_paged_mode(models):
    _, tm = models
    with pytest.raises(EnforceError, match="paged"):
        BatchedDecoder(tm, slots=1, capacity=64, device="cpu",
                       prefix_cache=True)


# ----- chunked prefill ------------------------------------------------------

@pytest.mark.parametrize("mode,chunk", [("contiguous", 16), ("paged", 32)])
def test_chunked_matches_monolithic(models, mode, chunk):
    _, tm = models
    prompts = [_prompt(n, 110 + i) for i, n in enumerate((40, 5, 21, 9))]
    kw = dict(MODES[mode], capacity=128)
    _, want = _serve(tm, prompts, 10, **kw)
    _, got = _serve(tm, prompts, 10, prefill_chunk=chunk, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_chunked_decode_keeps_moving_while_long_prompt_prefills(models):
    _, tm = models
    short, long_p = _prompt(4, 130), _prompt(48, 131)
    dec = BatchedDecoder(tm, slots=2, capacity=64, prefill_chunk=16,
                         device="cpu")
    r_short = dec.submit(short, 12)
    with torch.inference_mode():
        dec._admit()
        while dec._pf_order:
            dec._prefill_tick()
        r_long = dec.submit(long_p, 6)
        dec._admit()                      # the long slot only allocates
        assert dec._pf_order
        s_short = next(s for s in range(2) if dec.active[s])
        before = len(dec.emitted[s_short])
        dec._prefill_tick()               # one chunk of the long prompt
        dec._step()                       # the short slot decodes
        assert dec._pf_order
        assert len(dec.emitted[s_short]) == before + 1
    outs = dec.run()
    for rid, p, n in ((r_short, short, 12), (r_long, long_p, 6)):
        _, (solo,) = _serve(tm, [p], n, slots=1)
        np.testing.assert_array_equal(solo, outs[rid])


def test_chunked_final_chunk_slide_at_capacity(models):
    """capacity 56 is not a multiple of the chunk: the final chunk slides
    back to capacity - C and rewrites real tokens; the result equals
    monolithic prefill."""
    _, tm = models
    prompt = _prompt(50, 145)          # the chunk grid pads to 64 > 56
    _, (want,) = _serve(tm, [prompt], 4, slots=1, capacity=56)
    _, (got,) = _serve(tm, [prompt], 4, slots=1, capacity=56,
                       prefill_chunk=16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("combo", ["prefix_cache", "spec", "decode_steps"])
def test_chunked_composes(models, combo):
    _, tm = models
    if combo == "prefix_cache":
        sys_p = _prompt(64, 140)
        full = np.concatenate([sys_p, _prompt(9, 141)])
        _, (cold,) = _serve(tm, [full], 8, slots=1, capacity=128, pages=6,
                            page_size=64)
        dec = BatchedDecoder(tm, slots=1, capacity=128, pages=6,
                             page_size=64, prefix_cache=True,
                             prefill_chunk=32, device="cpu")
        dec.submit(sys_p, 4)
        dec.run()
        rid = dec.submit(full, 8)
        out = dec.run()[rid]
        assert dec.prefix_hits == 1
        _agree(out, cold)
        return
    prompts = [_prompt(34, 195), _prompt(6, 196)]
    _, want = _serve(tm, prompts, 9, capacity=128, **PAGED)
    if combo == "spec":
        dec, got = _serve(tm, prompts, 9, capacity=128, draft=tm, gamma=3,
                          prefill_chunk=16)
        assert dec.spec_rounds > 0
        for g, w in zip(got, want):
            assert g.shape == w.shape
            _agree(g, w)
    else:
        _, got = _serve(tm, prompts, 9, capacity=128, decode_steps=3,
                        prefill_chunk=32, **PAGED)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_chunked_typed_errors(models):
    _, tm = models
    with pytest.raises(EnforceError, match="divide page_size"):
        BatchedDecoder(tm, slots=1, capacity=128, pages=4, page_size=64,
                       prefill_chunk=48, device="cpu")
    with pytest.raises(EnforceError, match="capacity"):
        BatchedDecoder(tm, slots=1, capacity=32, prefill_chunk=64,
                       device="cpu")


# ----- warm_step, ready, degraded ------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_warm_step_marks_ready_and_serves_identically(models, mode):
    _, tm = models
    prompts = [_prompt(8, 4), _prompt(13, 5)]
    dec = BatchedDecoder(tm, slots=2, capacity=64, decode_steps=2,
                         device="cpu", **MODES[mode])
    assert not dec.ready
    dec.warm_step()
    assert dec.ready and dec.tick_count == 0
    rids = [dec.submit(p, 8) for p in prompts]
    outs = dec.run()
    _, fresh = _serve(tm, prompts, 8, decode_steps=2, **MODES[mode])
    for r, f in zip(rids, fresh):
        np.testing.assert_array_equal(outs[r], f)


@pytest.mark.parametrize("kind", ["decode_steps", "spec"])
def test_degraded_mode_serves_like_the_plain_arena(models, kind):
    """Degraded: one token per tick, speculative rounds bypassed; the
    tokens are the plain k=1 arena's. Switching it off mid-run keeps
    the outputs (multi-step: equal; spec: >= 0.9)."""
    _, tm = models
    prompts = [_prompt(n, s) for n, s in MS_PROMPTS]
    kw = (dict(decode_steps=3) if kind == "decode_steps"
          else dict(draft=tm, gamma=3))
    _, plain = _serve(tm, prompts)
    dec = BatchedDecoder(tm, slots=2, capacity=64, device="cpu", **kw)
    dec.set_degraded(True)
    dec.warm_step()
    rids = [dec.submit(p, 12) for p in prompts]
    outs = dec.run()
    assert dec.spec_rounds == 0
    assert dec.tick_capacity == dec.tick_count * dec.slots
    for r, w in zip(rids, plain):
        np.testing.assert_array_equal(outs[r], w)
    # on, then off after a few ticks
    dec = BatchedDecoder(tm, slots=2, capacity=64, device="cpu", **kw)
    dec.set_degraded(True)
    rids = [dec.submit(p, 12) for p in prompts]
    with torch.inference_mode():
        for _ in range(3):
            dec._admit()
            dec._step()
    dec.set_degraded(False)
    outs = dec.run()
    for r, w in zip(rids, plain):
        if kind == "decode_steps":
            np.testing.assert_array_equal(outs[r], w)
        else:
            _agree(outs[r], w)


# ----- TokenStream ----------------------------------------------------------

def test_stream_offer_then_iterate_ordered():
    ts = TokenStream()
    ts.offer([5, 6], now=1.0)
    ts.offer([5, 6, 7], now=2.0)            # only the new token buffers
    ts.finish([5, 6, 7], now=3.0)
    recs = list(ts)
    assert [r["tok"] for r in recs if "i" in r] == [5, 6, 7]
    assert [r["i"] for r in recs if "i" in r] == [0, 1, 2]
    assert recs[-1] == {"event": "end", "n": 3}


def test_stream_offer_never_blocks_and_catches_up():
    ts = TokenStream(maxlen=2)
    toks = [10, 11, 12]
    t0 = time.perf_counter()
    ts.offer(toks, now=t0)                  # buffers 2, stalls, returns
    assert time.perf_counter() - t0 < 0.05
    assert ts.get(0.01)["tok"] == 10
    assert ts.get(0.01)["tok"] == 11
    ts.offer(toks, now=t0 + 1.0)            # the stall window closes
    assert ts.get(0.01)["tok"] == 12
    assert ts.stalled_s >= 1.0


def test_stream_put_bounded_wait_and_timeout():
    ts = TokenStream(maxlen=1)
    assert ts.put({"i": 0, "tok": 1, "t": None}) is True
    t0 = time.monotonic()
    assert ts.put({"i": 1, "tok": 2, "t": None}, timeout=0.05) is False
    assert 0.04 <= time.monotonic() - t0 < 1.0


def test_stream_fail_delivers_typed_error():
    ts = TokenStream()
    ts.offer([3], now=0.0)
    ts.fail(EnforceError("all replicas down"))
    recs = list(ts)
    assert recs[0]["tok"] == 3
    assert recs[-1]["event"] == "error"
    assert "EnforceError" in recs[-1]["error"]
    assert ts.done and isinstance(ts.error, EnforceError)


def test_stream_finish_serves_tail_consumer_driven():
    ts = TokenStream(maxlen=1)
    ts.offer([1, 2, 3, 4], now=0.0)         # buffers only token 0
    ts.finish([1, 2, 3, 4])
    recs = list(ts)
    assert [r["tok"] for r in recs if "i" in r] == [1, 2, 3, 4]
    assert recs[-1]["event"] == "end"


def test_stream_put_highwater_dedupes_finish_tail():
    ts = TokenStream()
    ts.put({"i": 0, "tok": 7, "t": 1.0})
    ts.put({"i": 1, "tok": 8, "t": 2.0})
    ts.finish([7, 8, 9])
    assert [r["tok"] for r in ts if "i" in r] == [7, 8, 9]


def test_stream_lagging_put_after_finish_never_duplicates():
    ts = TokenStream()
    ts.put({"i": 0, "tok": 7, "t": 1.0})
    ts.finish([7, 8, 9])
    assert ts.get(0.01)["tok"] == 7
    assert ts.get(0.01)["tok"] == 8
    assert ts.put({"i": 1, "tok": 8, "t": 2.0}) is True
    assert ts.get(0.01)["tok"] == 9
    assert ts.get(0.01) == {"event": "end", "n": 3}


def test_stream_control_records_bypass_cap():
    ts = TokenStream(maxlen=1)
    ts.put({"i": 0, "tok": 1, "t": None})
    ts.control("resume", retries=1)
    assert ts.get(0.01)["i"] == 0
    assert ts.get(0.01)["event"] == "resume"


@pytest.mark.parametrize("k", [1, 3])
def test_stream_matches_result_with_per_token_stamps(models, k):
    _, tm = models
    ts = TokenStream()
    dec = BatchedDecoder(tm, slots=2, capacity=128, decode_steps=k,
                         device="cpu", **PAGED)
    rid = dec.submit(_prompt(8, 1), 10, stream=ts)
    other = dec.submit(_prompt(5, 2), 7)
    outs = dec.run()
    recs = list(ts)
    assert [r["tok"] for r in recs if "i" in r] == outs[rid].tolist()
    assert recs[-1] == {"event": "end", "n": 10}
    assert len(outs[other]) == 7
    with pytest.raises(EnforceError, match="TokenStream"):
        dec.submit(_prompt(5, 2), 2, stream=object())


def test_stalled_client_never_blocks_the_arena(models):
    _, tm = models
    dec = BatchedDecoder(tm, slots=2, capacity=64, device="cpu")
    ts = TokenStream(maxlen=1)
    rid = dec.submit(_prompt(8, 2), 12, stream=ts)
    r = dec.queue[0]
    t0 = time.perf_counter()
    out = dec.run()[rid]
    assert time.perf_counter() - t0 < 60
    assert len(r.t_tokens) == 12 and r.t_tokens == sorted(r.t_tokens)
    t1 = time.perf_counter()
    ts.offer(np.arange(100), now=t1)        # the full buffer: returns
    assert time.perf_counter() - t1 < 0.05
    assert ts.stalled_s > 0
    assert [x["tok"] for x in ts if "i" in x] == out.tolist()


# ----- KV handoff -----------------------------------------------------------

HANDOFF_PROMPT = (70, 3)                     # 2 pages
HANDOFF_MAX_NEW = 10


@pytest.fixture(scope="module")
def jax_handoffs(models):
    """Per kv form: the JAX worker's handoff bytes, and the JAX decode
    replica's tokens from that handoff."""
    jm, _ = models
    prompt = _prompt(*HANDOFF_PROMPT)
    out = {}
    for kv in (None, "int8"):
        kw = dict(slots=2, capacity=128, pages=8, page_size=64,
                  kv_dtype=kv)
        h = JaxDecoder(jm, **kw).prefill_export(prompt)
        rep = JaxDecoder(jm, **kw)
        rid = rep.inject_prefilled(h, HANDOFF_MAX_NEW)
        out[kv] = (h.to_bytes(), np.asarray(rep.run()[rid]), rep)
    return prompt, out


def _port_handoff_decoder(tm, kv):
    return BatchedDecoder(tm, slots=2, capacity=128, pages=8, page_size=64,
                          kv_dtype=kv, device="cpu")


def _near_tie_equal(jm, prompt, got, want):
    diff = np.nonzero(got != want)[0]
    if len(diff):
        seq = np.concatenate([prompt, want])[None]
        ref = np.asarray(jm(jnp.asarray(seq)))[0, len(prompt) - 1:]
        top2 = np.sort(ref[diff[0]])[-2:]
        assert top2[1] - top2[0] < 1e-4, (diff[0], top2)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["float", "int8"])
def test_jax_handoff_bytes_inject_into_the_port(models, jax_handoffs, kv):
    jm, tm = models
    prompt, out = jax_handoffs
    data, jax_tokens, _ = out[kv]
    h = KVHandoff.from_bytes(data)
    assert h.plen == 70 and h.pages == 2 and h.kv_dtype == kv
    dec = _port_handoff_decoder(tm, kv)
    rid = dec.inject_prefilled(h, HANDOFF_MAX_NEW)
    got = dec.run()[rid]
    _near_tie_equal(jm, prompt, got, jax_tokens)
    # the pages are the JAX prefill's bits: a port decoder handed the
    # same pages twice answers the same
    dec2 = _port_handoff_decoder(tm, kv)
    rid2 = dec2.inject_prefilled(KVHandoff.from_bytes(data),
                                 HANDOFF_MAX_NEW)
    np.testing.assert_array_equal(dec2.run()[rid2], got)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["float", "int8"])
def test_port_handoff_bytes_inject_into_jax(models, jax_handoffs, kv):
    jm, tm = models
    prompt, out = jax_handoffs
    _, jax_tokens, rep = out[kv]
    worker = _port_handoff_decoder(tm, kv)
    free0 = worker._allocator.free_pages
    h = worker.prefill_export(prompt)
    assert worker._allocator.free_pages == free0   # export frees its pages
    data = h.to_bytes()
    jh = JaxHandoff.from_bytes(data)
    assert jh.plen == 70 and jh.kv_dtype == kv
    rid = rep.inject_prefilled(jh, HANDOFF_MAX_NEW)
    got = np.asarray(rep.run()[rid])
    _near_tie_equal(jm, prompt, got, jax_tokens)
    # the port's own decode of its own bytes equals the request served
    # directly by the same options
    dec = _port_handoff_decoder(tm, kv)
    rid = dec.inject_prefilled(KVHandoff.from_bytes(data), HANDOFF_MAX_NEW)
    direct = _port_handoff_decoder(tm, kv)
    drid = direct.submit(prompt, HANDOFF_MAX_NEW)
    np.testing.assert_array_equal(dec.run()[rid], direct.run()[drid])


def test_handoff_wire_form_and_headers(models):
    _, tm = models
    h = _port_handoff_decoder(tm, "int8").prefill_export(_prompt(30, 3))
    assert h.blocks[0][0][0].dtype == np.int8 and h.pages == 1
    assert h.nbytes == sum(a.nbytes for kp, vp in h.blocks
                           for p in (kp, vp) for a in p)
    h2 = KVHandoff.from_bytes(h.to_bytes())
    for (k1, v1), (k2, v2) in zip(h.blocks, h2.blocks):
        for a, b in zip(k1 + v1, k2 + v2):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(h2.logits, h.logits)
    # a trace / deadline entry rides the bytes as its header string
    z = dict(np.load(io.BytesIO(h.to_bytes())))
    z["trace"] = np.asarray("00-abc-def-01")
    z["deadline"] = np.asarray("1700000000.5")
    buf = io.BytesIO()
    np.savez(buf, **z)
    h3 = KVHandoff.from_bytes(buf.getvalue())
    assert h3.trace_header == "00-abc-def-01"
    h4 = KVHandoff.from_bytes(h3.to_bytes())
    assert h4.deadline_header == "1700000000.5"
    assert h4.trace_header == "00-abc-def-01"
    with pytest.raises(UnimplementedError, match="item 8"):
        KVHandoff(h.prompt, h.plen, h.logits, h.blocks, 64, "int8",
                  trace=object())


def test_handoff_typed_errors(models):
    _, tm = models
    h = _port_handoff_decoder(tm, None).prefill_export(_prompt(8, 4))
    contiguous = BatchedDecoder(tm, slots=1, capacity=64, device="cpu")
    with pytest.raises(EnforceError, match="paged"):
        contiguous.inject_prefilled(h, 4)
    with pytest.raises(EnforceError, match="paged"):
        contiguous.prefill_export(_prompt(8, 4))
    with pytest.raises(EnforceError, match="kv_dtype"):
        _port_handoff_decoder(tm, "int8").inject_prefilled(h, 4)
    with pytest.raises(EnforceError, match="page_size"):
        BatchedDecoder(tm, slots=1, capacity=256, pages=4, page_size=128,
                       device="cpu").inject_prefilled(h, 4)
    with pytest.raises(EnforceError, match="capacity"):
        _port_handoff_decoder(tm, None).inject_prefilled(h, 1000)


# ----- W8A16 ----------------------------------------------------------------

@pytest.fixture(scope="module")
def w8a16(models):
    """(float logits, JAX W8A16 logits, the JAX wrapped paths, the JAX
    W8A16 model's buffers) on one seeded (2, 32) batch."""
    pt.seed(60)
    jm = JG.GPTForCausalLM(JG.GPTConfig.tiny()).eval()
    seq = np.random.default_rng(1).integers(0, 512, (2, 32))
    want = np.asarray(jm(jnp.asarray(seq)))
    paths = JQ.apply_weight_only_int8(jm)
    got = np.asarray(jm(jnp.asarray(seq)))
    bufs = {k: np.asarray(v) for k, v in jm.named_buffers().items()}
    return seq, want, got, paths, bufs


def test_w8a16_matches_jax(models, w8a16):
    _, tm0 = models
    seq, float_logits, jax_logits, jpaths, jbufs = w8a16
    tm = TG.GPTForCausalLM(TG.GPTConfig.tiny(), device="cpu").eval()
    tm.load_state_dict(tm0.state_dict())
    paths = TQ.apply_weight_only_int8(tm)
    assert paths == jpaths and len(paths) >= 2 * 7
    tbufs = dict(tm.named_buffers())
    for name, want in jbufs.items():
        got = tbufs[name].numpy()
        if name.endswith("qweight"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    assert not any(n.endswith("q_proj.weight")
                   for n, _ in tm.named_parameters())
    with torch.inference_mode():
        got = tm(torch.from_numpy(seq)).numpy()
    np.testing.assert_allclose(got, jax_logits, atol=1e-5, rtol=0)
    rel = np.linalg.norm(got - float_logits) / np.linalg.norm(float_logits)
    assert rel < 0.03, rel
    assert (got.argmax(-1) == float_logits.argmax(-1)).mean() > 0.9


def test_w8a16_layer_and_filters(models):
    _, tm0 = models
    lin = tm0.blocks[0].ffn.up
    q = TQ.WeightOnlyLinear(lin)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 128)).astype(np.float32))
    with torch.inference_mode():
        rel = float((q(x) - lin(x)).norm() / lin(x).norm())
    assert rel < 5e-3, rel
    assert q.qweight.dtype == torch.int8 and q.scale.shape == (256,)
    assert not list(q.parameters())
    torch.testing.assert_close(q.dequantized_weight(), lin.weight,
                               atol=float(q.scale.max()) / 127, rtol=0)
    tm = TG.GPTForCausalLM(TG.GPTConfig.tiny(), device="cpu").eval()
    wrapped = TQ.apply_weight_only_int8(tm, targets=("q_proj", "k_proj"))
    assert wrapped and all(p.endswith(("q_proj", "k_proj"))
                           for p in wrapped)
    with pytest.raises(EnforceError, match="matched no"):
        TQ.apply_weight_only_int8(
            TG.GPTForCausalLM(TG.GPTConfig.tiny(), device="cpu"),
            min_features=100000)
    with pytest.raises(EnforceError, match="wraps nn.Linear"):
        TQ.WeightOnlyLinear(tm.norm_f)


def test_w8a16_model_serves(models):
    """The arena serves the W8A16 model: every token within 1e-4 of the
    max of that model's own teacher-forced logits."""
    _, tm0 = models
    tm = TG.GPTForCausalLM(TG.GPTConfig.tiny(), device="cpu").eval()
    tm.load_state_dict(tm0.state_dict())
    TQ.apply_weight_only_int8(tm)
    prompts = [_prompt(n, s) for n, s in MS_PROMPTS]
    _, outs = _serve(tm, prompts, 10, decode_steps=2)
    with torch.inference_mode():
        for p, o in zip(prompts, outs):
            seq = torch.from_numpy(np.concatenate([p, o]))[None].long()
            rows = tm(seq)[0, len(p) - 1:len(p) - 1 + len(o)].numpy()
            assert (rows.max(-1) - rows[np.arange(len(o)), o]).max() <= 1e-4
