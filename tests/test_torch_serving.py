"""The port's BatchedDecoder (paddle_tpu_torch/serving.py) against the JAX
one on the same weights, in contiguous mode (capacity 128) and paged
mode (pages=12, page_size=64): slots=2, five requests of mixed lengths
(one longer than a page, one finishing on eos_id, more requests than
slots so slots are reused). The JAX arena runs under force_flash, so its
decode ticks reach the Pallas decode kernels in interpret mode.

Gate: teacher-forced per-step logits at atol 1e-4 (the port's arena is
forced along the JAX tokens); free-running tokens equal up to the first
position where JAX's own top-2 logit gap is below 1e-4.

int8 KV (``kv_dtype="int8"``, paged): the JAX package's logit-parity
contract (tests/test_serving.py) — a 37-token prefill and 6
teacher-forced steps, int8 pools within 0.05 x the float logits' spread
of float pools. Against the JAX int8 pools the gate is 0.01 x spread,
not 1e-4: the two frameworks' K/V differ by ~1e-6, so a vector's int8
code can flip by one step (absmax/127) where the division lands on a
rounding tie (observed: see the test's docstring)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt as JG
from paddle_tpu.ops import attention as JA
from paddle_tpu.ops import paged_kv as JP
from paddle_tpu.ops import sampling as JS
from paddle_tpu.serving import BatchedDecoder as JaxDecoder
from paddle_tpu.serving import PagedKVPool as JaxPool
from paddle_tpu_torch.core import EnforceError
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.ops import paged_kv as TP
from paddle_tpu_torch.serving import BatchedDecoder, PagedKVPool
from paddle_tpu_torch.utils.convert import load_numpy_state

ATOL = 1e-4
CFG = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_size=512, max_position=128)
LENS = (5, 70, 3, 20, 9)            # 70 > one 64-token page
MAX_NEW = (8, 10, 4, 12, 6)
EOS_REQ = 3                         # this request finishes on eos_id
MODES = {"contiguous": {}, "paged": dict(pages=12, page_size=64)}


@pytest.fixture(scope="module")
def setup():
    pt.seed(0)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**CFG)).eval()
    tm = TG.GPTForCausalLM(TG.GPTConfig(**CFG), device="cpu").eval()
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in LENS]
    # eos = the third greedy token of request EOS_REQ, so that request
    # ends on eos after 3 tokens
    cont = tm.greedy_decode(torch.from_numpy(prompts[EOS_REQ])[None],
                            LENS[EOS_REQ] + 3)
    eos = int(cont[0, -1])
    return jm, tm, prompts, eos


def _serve(dec, prompts):
    rids = [dec.submit(p, n) for p, n in zip(prompts, MAX_NEW)]
    outs = dec.run()
    return [outs[r] for r in rids]


class _Forced(BatchedDecoder):
    """The port's arena, teacher-forced along given token sequences: every
    pick returns the reference token and records the row's logits. A
    pick's position says which token of its request it is (position
    plen + i is the i-th generated token)."""

    def __init__(self, *args, forced, **kw):
        super().__init__(*args, **kw)
        self.forced = forced            # rid -> reference tokens
        self.logits = {rid: [] for rid in forced}
        self._admitting = None

    def _activate(self, s, r, logits, plen):
        self._admitting = s
        super()._activate(s, r, logits, plen)

    def _pick(self, logits, gens, poss, salt=0):
        out = super()._pick(logits, gens, poss, salt)
        if self._admitting is not None:        # one row: the new slot
            pairs, self._admitting = [(0, self._admitting)], None
        else:                                  # a tick: row = slot
            pairs = [(s, s) for s in range(self.slots) if self.active[s]]
        for row, s in pairs:
            r = self.owner[s]
            i = int(poss[row]) - len(r.prompt)
            self.logits[r.rid].append(logits[row].numpy())
            out[row] = self.forced[r.rid][i]
        return out


def _jax_logits(jm, prompts, outs):
    """Teacher-forced JAX logits of every request along its tokens: one
    right-padded causal forward over prompt + output."""
    seqs = [np.concatenate([p, o]) for p, o in zip(prompts, outs)]
    width = max(len(s) for s in seqs)
    batch = np.zeros((len(seqs), width), np.int32)
    for i, s in enumerate(seqs):
        batch[i, :len(s)] = s
    return np.asarray(jm(jnp.asarray(batch)))


@pytest.mark.parametrize("mode", list(MODES))
def test_arena_matches_jax(setup, mode):
    jm, tm, prompts, eos = setup
    kw = MODES[mode]
    with JA.force_flash():
        want = _serve(JaxDecoder(jm, slots=2, capacity=128, eos_id=eos,
                                 **kw), prompts)
    assert len(want[EOS_REQ]) == 3 and want[EOS_REQ][-1] == eos
    ref = _jax_logits(jm, prompts, want)
    # teacher-forced: the port's per-step logits along the JAX tokens
    forced = _Forced(tm, slots=2, capacity=128, eos_id=eos, device="cpu",
                     forced=dict(enumerate(want)), **kw)
    got_forced = _serve(forced, prompts)
    for rid, (p, w) in enumerate(zip(prompts, want)):
        np.testing.assert_array_equal(got_forced[rid], w)
        steps = np.stack(forced.logits[rid])
        assert steps.shape == (len(w), CFG["vocab_size"])
        np.testing.assert_allclose(
            steps, ref[rid, len(p) - 1:len(p) - 1 + len(w)], atol=ATOL,
            rtol=0)
    # free-running: tokens agree up to a JAX near tie
    got = _serve(BatchedDecoder(tm, slots=2, capacity=128, eos_id=eos,
                                device="cpu", **kw), prompts)
    for rid, (p, g, w) in enumerate(zip(prompts, got, want)):
        diff = np.nonzero(g[:len(w)] != w[:len(g)])[0]
        if len(diff) == 0:
            assert len(g) == len(w), rid
            continue
        i = diff[0]
        top2 = np.sort(ref[rid, len(p) - 1 + i])[-2:]
        assert top2[1] - top2[0] < 1e-4, (rid, i, top2)


@pytest.mark.parametrize("mode", list(MODES))
def test_sampled_tokens_stay_in_filtered_support(setup, mode):
    """Sampled serving draws from a torch.Generator (not JAX's key
    chain), so draws are not compared; every drawn token must lie in
    the support of the JAX filter on the JAX logits at its position."""
    jm, tm, prompts, _ = setup
    gen = torch.Generator().manual_seed(7)
    dec = BatchedDecoder(tm, slots=2, capacity=128, device="cpu",
                         generator=gen, temperature=0.8, top_k=5,
                         top_p=0.9, **MODES[mode])
    outs = _serve(dec, prompts)
    ref = _jax_logits(jm, prompts, outs)
    for rid, (p, o) in enumerate(zip(prompts, outs)):
        assert len(o) == MAX_NEW[rid]
        rows = ref[rid, len(p) - 1:len(p) - 1 + len(o)]
        filt = np.asarray(JS.filter_logits(jnp.asarray(rows), 0.8, 5, 0.9))
        assert np.all(np.isfinite(filt[np.arange(len(o)), o])), rid


def test_paged_and_contiguous_arenas_agree(setup):
    _, tm, prompts, eos = setup
    a = _serve(BatchedDecoder(tm, slots=2, capacity=128, eos_id=eos,
                              device="cpu"), prompts)
    b = _serve(BatchedDecoder(tm, slots=2, capacity=128, eos_id=eos,
                              device="cpu", pages=12, page_size=64),
               prompts)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_write_rows_drops_out_of_range_cursors():
    """A parked cursor (t = capacity) writes nothing, as JAX's
    mode="drop" scatter; in-range rows land at their page/offset."""
    rng = np.random.default_rng(1)
    pool = rng.normal(size=(6, 64, 2, 8)).astype(np.float32)
    table = np.array([[4, 1], [0, 5], [2, 3]], np.int32)
    t = np.array([70, 128, 0], np.int32)
    k = rng.normal(size=(3, 1, 2, 8)).astype(np.float32)
    jk, _ = JP.write_rows(jnp.asarray(pool), jnp.asarray(pool),
                          jnp.asarray(table), jnp.asarray(t),
                          jnp.asarray(k), jnp.asarray(k), 64)
    tk = torch.from_numpy(pool.copy())
    TP.write_rows(tk, tk.clone(), torch.from_numpy(table),
                  torch.from_numpy(t), torch.from_numpy(k),
                  torch.from_numpy(k), 64)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tk.numpy()[0], pool[0])   # row 1 parked


@pytest.mark.parametrize("t", [
    [0, 128, 128],        # parked rows' clamped spot is row 0's write
    [128, 128, 200],      # every row dropped
    [63, 64, 127],        # page edges, none dropped
], ids=["collides", "all_dropped", "page_edges"])
def test_write_rows_drop_matches_jax(t):
    """Dropped rows leave the pool as JAX's mode="drop" scatter leaves
    it, also where a dropped row's clamped place is a live row's."""
    rng = np.random.default_rng(2)
    pool = rng.normal(size=(4, 64, 2, 8)).astype(np.float32)
    table = np.array([[0, 1], [2, 0], [3, 0]], np.int32)
    t = np.array(t, np.int32)
    k = rng.normal(size=(3, 1, 2, 8)).astype(np.float32)
    v = rng.normal(size=(3, 1, 2, 8)).astype(np.float32)
    jk, jv = JP.write_rows(jnp.asarray(pool), jnp.asarray(pool),
                           jnp.asarray(table), jnp.asarray(t),
                           jnp.asarray(k), jnp.asarray(v), 64)
    tk, tv = torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy())
    TP.write_rows(tk, tv, torch.from_numpy(table), torch.from_numpy(t),
                  torch.from_numpy(k), torch.from_numpy(v), 64)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("t0", [0, 100, 120, 130])
def test_write_chunk_drop_matches_jax(t0):
    """A chunk running past the table's capacity writes its in-range
    positions and drops the rest, as JAX's write_chunk."""
    rng = np.random.default_rng(3)
    pool = rng.normal(size=(4, 64, 2, 8)).astype(np.float32)
    table_row = np.array([3, 1], np.int32)
    k = rng.normal(size=(1, 16, 2, 8)).astype(np.float32)
    jk, _ = JP.write_chunk(jnp.asarray(pool), jnp.asarray(pool),
                           jnp.asarray(table_row), t0, jnp.asarray(k),
                           jnp.asarray(k), 64)
    tk = torch.from_numpy(pool.copy())
    TP.write_chunk(tk, tk.clone(), torch.from_numpy(table_row), t0,
                   torch.from_numpy(k), torch.from_numpy(k), 64)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_page_pool_alloc_free():
    al = PagedKVPool(4, 64, 2, 8, device="cpu")
    ids = al.alloc(3)
    assert al.free_pages == 1 and len(set(ids.tolist())) == 3
    with pytest.raises(EnforceError, match="exhausted"):
        al.alloc(2)
    al.free(ids[:1])
    with pytest.raises(EnforceError, match="double free"):
        al.free(ids[:1])
    with pytest.raises(EnforceError, match="outside pool"):
        al.free([9])


def test_int8_kv_requires_paged_mode(setup):
    _, tm, _, _ = setup
    with pytest.raises(EnforceError, match="paged mode"):
        BatchedDecoder(tm, slots=2, capacity=128, device="cpu",
                       kv_dtype="int8")
    with pytest.raises(EnforceError, match="kv_dtype"):
        PagedKVPool(4, 64, 2, 64, kv_dtype="int4", device="cpu")


def test_int8_arena_completes_requests(setup):
    """The int8 paged arena serves the five requests (slot reuse, eos)
    with well-formed outputs, its pools QuantizedPools."""
    _, tm, prompts, eos = setup
    dec = BatchedDecoder(tm, slots=2, capacity=128, eos_id=eos,
                         device="cpu", pages=12, page_size=64,
                         kv_dtype="int8")
    outs = _serve(dec, prompts)
    assert isinstance(dec.pools[0][0], TP.QuantizedPool)
    assert dec.pools[0][0].q.dtype == torch.int8
    for o, n in zip(outs, MAX_NEW):
        assert 1 <= len(o) <= n and o.min() >= 0 and o.max() < 512


def _mint(model, kv_dtype, jax_side):
    """Per-block (K, V) pools of 2 pages and the (1, 2) table, from the
    JAX or the port's PagedKVPool."""
    attn0 = model.blocks[0].self_attn
    if jax_side:
        al = JaxPool(2, 64, attn0.num_kv_heads, attn0.head_dim,
                     arrays=False, kv_dtype=kv_dtype)
        table = jnp.asarray(al.alloc(2))[None]
    else:
        al = PagedKVPool(2, 64, attn0.num_kv_heads, attn0.head_dim,
                         arrays=False, kv_dtype=kv_dtype, device="cpu")
        table = torch.from_numpy(al.alloc(2))[None]
    return [(al.empty_pool(), al.empty_pool()) for _ in model.blocks], table


def test_int8_kv_teacher_forced_logit_parity(setup):
    """Prefill 37 tokens, then 6 teacher-forced steps (along the port's
    float argmax): the port's int8 pools stay within 0.05 x the float
    logits' spread of its float pools (observed 7.4e-3 x spread), and
    within 1e-3 x spread of the JAX int8 pools. That limit lies between
    its two readings: 7.2e-7 x spread observed (no code flipped on this
    input; a one-step code flip at a rounding tie stays far below 1e-3),
    and 7.4e-3 x spread, the int8-vs-float reading, which a port whose
    int8 pools skipped quantization would show."""
    jm, tm, _, _ = setup
    prompt = np.random.default_rng(83).integers(1, 512, 37).astype(
        np.int32)
    pf, tf = _mint(tm, None, False)
    pq, tq = _mint(tm, "int8", False)
    jq, jt = _mint(jm, "int8", True)
    with torch.inference_mode():
        lf, pf = tm._chunk_logits_paged(torch.from_numpy(prompt)[None], pf,
                                        tf[0], 0)
        lq, pq = tm._chunk_logits_paged(torch.from_numpy(prompt)[None], pq,
                                        tq[0], 0)
    lj, jq = jm._chunk_logits_paged(jnp.asarray(prompt)[None], jq, jt[0], 0)
    spread = float(lf.max() - lf.min())
    worst_f = (lq - lf).abs().max().item() / spread
    worst_j = np.abs(lq.numpy() - np.asarray(lj)).max() / spread
    tok = lf[:, -1].argmax(-1)
    for i in range(6):
        t = torch.tensor([37 + i], dtype=torch.int32)
        with torch.inference_mode():
            lf, pf = tm._step_logits_paged(tok, pf, tf, t)
            lq, pq = tm._step_logits_paged(tok, pq, tq, t)
        lj, jq = jm._step_logits_paged(jnp.asarray(tok.numpy()), jq, jt,
                                       jnp.asarray(t.numpy()))
        worst_f = max(worst_f, (lq - lf).abs().max().item() / spread)
        worst_j = max(worst_j,
                      np.abs(lq.numpy() - np.asarray(lj)).max() / spread)
        tok = lf.argmax(-1)                              # teacher-forced
    assert worst_f < 0.05, worst_f
    assert worst_j < 1e-3, worst_j


def test_int8_pool_density(setup):
    """The int8 pool costs >= 3.5x fewer bytes than the float32 pool at
    the same page count, by the JAX package's byte formula."""
    _, tm, _, _ = setup
    fp = BatchedDecoder(tm, slots=2, capacity=128, pages=8, page_size=64,
                        device="cpu")
    q8 = BatchedDecoder(tm, slots=2, capacity=128, pages=8, page_size=64,
                        device="cpu", kv_dtype="int8")
    ratio = fp._allocator.pool_nbytes / q8._allocator.pool_nbytes
    assert ratio >= 3.5, ratio
    assert q8._allocator.pool_nbytes == q8.pools[0][0].nbytes == (
        JP.quantized_pool_nbytes(q8._allocator.shape))
    assert fp._allocator.pool_nbytes == fp.pools[0][0].numel() * 4


@pytest.mark.parametrize("kw", [dict(debug_port=0),
                                dict(flight_recorder=object()),
                                dict(preemption=True)])
def test_later_slice_run_hooks_raise(setup, kw):
    """The run hooks of the telemetry slice (they raised before it) serve
    the same tokens as a plain run: the debug server starts and is joined,
    an unconsulted recorder (telemetry off) and a grace handler change
    nothing."""
    from paddle_tpu_torch import telemetry

    _, tm, prompts, _ = setup
    want = BatchedDecoder(tm, slots=2, capacity=128, device="cpu")
    rid = want.submit(prompts[0], 2)
    want = want.run()[rid]
    dec = BatchedDecoder(tm, slots=2, capacity=128, device="cpu")
    rid = dec.submit(prompts[0], 2)
    try:
        got = dec.run(**kw)[rid]
    finally:
        telemetry.disable()          # a debug server turns it on
    np.testing.assert_array_equal(got, want)
    assert not dec.preempted
    if "debug_port" in kw:
        assert dec.debug_server.port > 0 and not dec.debug_server.running


def test_submit_checks(setup):
    _, tm, prompts, _ = setup
    dec = BatchedDecoder(tm, slots=1, capacity=64, device="cpu")
    with pytest.raises(EnforceError, match="max_new"):
        dec.submit(prompts[0], 0)
    with pytest.raises(EnforceError, match="capacity"):
        dec.submit(prompts[1], 10)
    with pytest.raises(EnforceError, match="TokenStream"):
        dec.submit(prompts[0], 2, stream=object())
    with pytest.raises(EnforceError, match="torch.Generator"):
        BatchedDecoder(tm, slots=1, capacity=64, device="cpu",
                       temperature=1.0)
