"""Speculative decoding in the port against the JAX package: the per-row
chunk entries (``nn/layers.py`` ``forward_chunk_rows`` and
``forward_chunk_paged_rows``, ``models/gpt.py`` ``_chunk_logits_rows``
and ``_chunk_logits_paged_rows``), ``models/speculative.py``
``speculative_generate``, and the arena's speculative rounds
(``BatchedDecoder(draft=, gamma=)``).

Models: the JAX tests' pair (``tests/test_serving.py`` TestSpeculativeArena
``_pair``): GPTConfig.tiny() as the target and a 1-layer hidden-64
draft, the weights moved into the port by name.

Tolerances and why:
- the chunk entries: logits 1e-4, attention outputs and caches 1e-5
  (the same float32 products in another framework, ~1e-6);
- greedy tokens: equal, except after a position where JAX's own top-2
  logit gap is below 1e-4 (an untrained model's near tie can flip on a
  1e-6 difference; ROADMAP "Token-match gates");
- the arena's greedy spec output: >= 0.9 agreement with the plain arena
  (the JAX tests' ``_agree``: the verify chunk and the step loop reduce
  in different orders), and every emitted token within 1e-4 of the max
  of JAX's teacher-forced logits at its position;
- self-draft acceptance > 0.7 per drafted token (the JAX package's
  bound);
- sampled draws are keyed from a torch.Generator, not JAX's key chain:
  two runs with one seed are equal, and every token lies in the support
  of the JAX filter on the JAX logits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt as JG
from paddle_tpu.models.speculative import \
    speculative_generate as jax_speculative
from paddle_tpu.ops import sampling as JS
from paddle_tpu_torch.core import EnforceError
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.speculative import speculative_generate
from paddle_tpu_torch.serving import BatchedDecoder
from paddle_tpu_torch.utils.convert import load_numpy_state

DRAFT = dict(vocab_size=512, hidden_size=64, num_layers=1, num_heads=2,
             num_kv_heads=2, intermediate_size=128, max_position=128)
MODES = {"contiguous": {}, "paged": dict(pages=8, page_size=64)}
LENS = (6, 11, 4)


def _port(jm, cfg):
    tm = TG.GPTForCausalLM(cfg, device="cpu").eval()
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    return tm


@pytest.fixture(scope="module")
def pair():
    """(jax target, jax draft, port target, port draft, prompts)."""
    pt.seed(50)
    jm = JG.GPTForCausalLM(JG.GPTConfig.tiny()).eval()
    pt.seed(51)
    jd = JG.GPTForCausalLM(JG.GPTConfig(**DRAFT)).eval()
    tm = _port(jm, TG.GPTConfig.tiny())
    td = _port(jd, TG.GPTConfig(**DRAFT))
    rng = np.random.default_rng(150)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in LENS]
    return jm, jd, tm, td, prompts


def _jax_rows(jm, prompts, outs):
    """JAX's teacher-forced logits at each emitted position: (rows of
    (len(out), V))."""
    seqs = [np.concatenate([p, o]) for p, o in zip(prompts, outs)]
    width = max(len(s) for s in seqs)
    batch = np.zeros((len(seqs), width), np.int32)
    for i, s in enumerate(seqs):
        batch[i, :len(s)] = s
    ref = np.asarray(jm(jnp.asarray(batch)))
    return [ref[i, len(p) - 1:len(p) - 1 + len(o)]
            for i, (p, o) in enumerate(zip(prompts, outs))]


def _agree(got, want, thresh=0.9):
    n = min(len(got), len(want))
    agree = (got[:n] == want[:n]).mean()
    assert agree >= thresh, (agree, got, want)


def _random_caches(model, b, cap, seed):
    rng = np.random.default_rng(seed)
    attn = model.blocks[0].self_attn
    shape = (b, cap, attn.num_kv_heads, attn.head_dim)
    return [(rng.normal(size=shape).astype(np.float32),
             rng.normal(size=shape).astype(np.float32))
            for _ in model.blocks]


def _random_pools(model, pages, seed):
    rng = np.random.default_rng(seed)
    attn = model.blocks[0].self_attn
    shape = (pages, 64, attn.num_kv_heads, attn.head_dim)
    return [(rng.normal(size=shape).astype(np.float32),
             rng.normal(size=shape).astype(np.float32))
            for _ in model.blocks]


# cursors of the verify chunk: contiguous rows (one at the capacity's
# edge, where the write start clamps to cap - S); paged rows, one parked
# past capacity (its writes drop)
T0 = {"contiguous": [3, 40, 126], "paged": [3, 60, 128]}
CAP, S = 128, 4


@pytest.mark.parametrize("mode", list(MODES))
def test_chunk_logits_rows_match_jax(pair, mode):
    jm, _, tm, _, _ = pair
    rng = np.random.default_rng(7)
    toks = rng.integers(1, 512, (3, S)).astype(np.int32)
    t0 = np.array(T0[mode], np.int32)
    if mode == "contiguous":
        caches = _random_caches(tm, 3, CAP, 8)
        jl, jc = jm._chunk_logits_rows(
            jnp.asarray(toks), [tuple(map(jnp.asarray, c)) for c in caches],
            jnp.asarray(t0))
        with torch.inference_mode():
            tl, tc = tm._chunk_logits_rows(
                torch.from_numpy(toks),
                [tuple(torch.from_numpy(x.copy()) for x in c)
                 for c in caches], torch.from_numpy(t0))
    else:
        pools = _random_pools(tm, 8, 9)
        table = np.array([[5, 1], [0, 7], [2, 3]], np.int32)
        jl, jc = jm._chunk_logits_paged_rows(
            jnp.asarray(toks), [tuple(map(jnp.asarray, c)) for c in pools],
            jnp.asarray(table), jnp.asarray(t0))
        with torch.inference_mode():
            tl, tc = tm._chunk_logits_paged_rows(
                torch.from_numpy(toks),
                [tuple(torch.from_numpy(x.copy()) for x in c)
                 for c in pools], torch.from_numpy(table),
                torch.from_numpy(t0))
    got = tl.numpy()
    want = np.asarray(jl)
    if mode == "paged":                # the parked row's logits are junk
        got, want = got[:2], want[:2]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for (tk, tv), (jk, jv) in zip(tc, jc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("mode", list(MODES))
def test_attention_chunk_rows_match_jax(pair, mode):
    """The layer entries alone, on one block's attention, window 5."""
    jm, _, tm, _, _ = pair
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, S, 128)).astype(np.float32)
    t0 = np.array(T0[mode], np.int32)
    ja, ta = jm.blocks[0].self_attn, tm.blocks[0].self_attn
    if mode == "contiguous":
        (ck, cv), = _random_caches(tm, 3, CAP, 12)[:1]
        jo, jk, jv = ja.forward_chunk_rows(
            jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
            jnp.asarray(t0), window=5)
        with torch.inference_mode():
            to, tk, tv = ta.forward_chunk_rows(
                torch.from_numpy(x), torch.from_numpy(ck.copy()),
                torch.from_numpy(cv.copy()), torch.from_numpy(t0), window=5)
    else:
        (kp, vp), = _random_pools(tm, 8, 13)[:1]
        table = np.array([[5, 1], [0, 7], [2, 3]], np.int32)
        jo, jk, jv = ja.forward_chunk_paged_rows(
            jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(t0), window=5)
        with torch.inference_mode():
            to, tk, tv = ta.forward_chunk_paged_rows(
                torch.from_numpy(x), torch.from_numpy(kp.copy()),
                torch.from_numpy(vp.copy()), torch.from_numpy(table),
                torch.from_numpy(t0), window=5)
    rows = slice(None) if mode == "contiguous" else slice(0, 2)
    np.testing.assert_allclose(to.numpy()[rows], np.asarray(jo)[rows],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                               rtol=0)


SPEC_PROMPT_ROWS = 2


@pytest.fixture(scope="module")
def jax_spec(pair):
    """JAX's greedy speculative_generate at gamma=3, once: (prompt
    (2, 6), tokens (2, 22), stats, JAX's teacher-forced rows)."""
    jm, jd, _, _, prompts = pair
    prompt = np.stack([prompts[0], prompts[0][::-1]])
    want, stats = jax_speculative(jm, jd, jnp.asarray(prompt), 22, gamma=3,
                                  temperature=0.0, return_stats=True)
    want = np.asarray(want)
    return prompt, want, stats, _jax_rows(jm, list(prompt),
                                          [w[6:] for w in want])


@pytest.mark.parametrize("gamma", [1, 3])
def test_speculative_generate_greedy_matches_jax(pair, jax_spec, gamma):
    """Greedy tokens equal JAX's (greedy output does not depend on
    gamma), up to a JAX near tie, and the target's own greedy decode;
    at JAX's gamma the round statistics are equal too."""
    _, _, tm, td, _ = pair
    prompt, want, jstats, ref = jax_spec
    got, stats = speculative_generate(tm, td, torch.from_numpy(prompt), 22,
                                      gamma=gamma, temperature=0.0,
                                      return_stats=True)
    got = got.numpy()
    for i in range(SPEC_PROMPT_ROWS):
        diff = np.nonzero(got[i] != want[i])[0]
        if len(diff):
            top2 = np.sort(ref[i][diff[0] - 6])[-2:]
            assert top2[1] - top2[0] < 1e-4, (i, diff[0], top2)
        elif gamma == 3:
            assert stats["rounds"][i] == int(jstats["rounds"][i])
            assert stats["accepted_drafts"][i] == int(
                jstats["accepted_drafts"][i])
    greedy = tm.greedy_decode(torch.from_numpy(prompt), 22).numpy()
    for g, w in zip(got, greedy):
        _agree(g, w)


def test_speculative_generate_eos_and_checks(pair):
    """An eos stops the row and fills the rest with eos; the tokens
    before it are the free run's."""
    _, _, tm, td, prompts = pair
    prompt = torch.from_numpy(prompts[1][None])
    free = speculative_generate(tm, td, prompt, 24, gamma=3,
                                temperature=0.0).numpy()[0]
    eos = int(free[14])
    out = speculative_generate(tm, td, prompt, 24, gamma=3,
                               temperature=0.0, eos_id=eos).numpy()[0]
    first = 11 + np.flatnonzero(out[11:] == eos)[0]
    assert (out[first:] == eos).all()
    np.testing.assert_array_equal(out[:first + 1], free[:first + 1])
    with pytest.raises(EnforceError, match="torch.Generator"):
        speculative_generate(tm, td, prompt, 24, temperature=0.7)
    with pytest.raises(EnforceError, match="capacity"):
        speculative_generate(tm, td, prompt, 24, gamma=4, capacity=25)


def test_speculative_generate_sampled_deterministic(pair):
    _, _, tm, td, prompts = pair
    prompt = torch.from_numpy(np.stack([prompts[0], prompts[0][::-1]]))
    a, b = (speculative_generate(
        tm, td, prompt, 16, gamma=2, temperature=0.9, top_k=20,
        generator=torch.Generator().manual_seed(4)).numpy()
        for _ in range(2))
    np.testing.assert_array_equal(a, b)
    assert ((0 <= a) & (a < 512)).all()


def _serve(model, prompts, max_new=12, **kw):
    dec = BatchedDecoder(model, slots=2, capacity=128, device="cpu", **kw)
    rids = [dec.submit(p, max_new) for p in prompts]
    outs = dec.run()
    return dec, [outs[r] for r in rids]


@pytest.mark.parametrize("mode", list(MODES))
def test_arena_greedy_spec_matches_plain_and_jax(pair, mode):
    jm, _, tm, td, prompts = pair
    _, plain = _serve(tm, prompts, **MODES[mode])
    dec, got = _serve(tm, prompts, draft=td, gamma=3, **MODES[mode])
    assert dec.spec_rounds > 0 and dec.spec_row_rounds >= dec.spec_rounds
    for g, w in zip(got, plain):
        assert g.shape == w.shape
        _agree(g, w)
    # teacher-forced against JAX: each emitted token is JAX's argmax at
    # its position, up to 1e-4; the port's own logits within 1e-4
    rows = _jax_rows(jm, prompts, got)
    with torch.inference_mode():
        for p, o, ref in zip(prompts, got, rows):
            gap = ref.max(-1) - ref[np.arange(len(o)), o]
            assert gap.max() <= 1e-4, gap
            seq = torch.from_numpy(np.concatenate([p, o]))[None].long()
            mine = tm(seq)[0, len(p) - 1:len(p) - 1 + len(o)].numpy()
            np.testing.assert_allclose(mine, ref, atol=1e-4, rtol=0)


def test_self_draft_accepts_nearly_everything(pair):
    _, _, tm, _, prompts = pair
    dec, _ = _serve(tm, prompts, max_new=15, draft=tm, gamma=3)
    rate = dec.spec_accepted / max(1, dec.spec_row_rounds * 3)
    assert rate > 0.7, (dec.spec_accepted, dec.spec_row_rounds)


def test_spec_eos_and_budget_respected(pair):
    _, _, tm, td, prompts = pair
    _, (free,) = _serve(tm, prompts[:1], max_new=24)
    eos = int(free[9])
    _, (out,) = _serve(tm, prompts[:1], max_new=24, draft=td, gamma=4,
                       eos_id=eos)
    assert len(out) <= 24
    hits = np.flatnonzero(out == eos)
    assert len(hits) and hits[0] == len(out) - 1   # nothing past eos


@pytest.mark.parametrize("mode", list(MODES))
def test_arena_sampled_spec_deterministic_and_in_support(pair, mode):
    jm, _, tm, td, prompts = pair

    def run():
        return _serve(tm, prompts, max_new=10, draft=td, gamma=3,
                      temperature=0.8, top_k=40,
                      generator=torch.Generator().manual_seed(9),
                      **MODES[mode])[1]

    a, b = run(), run()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    rows = _jax_rows(jm, prompts, a)
    for o, ref in zip(a, rows):
        filt = np.asarray(JS.filter_logits(jnp.asarray(ref), 0.8, 40, 1.0))
        assert np.all(np.isfinite(filt[np.arange(len(o)), o]))


def test_spec_typed_errors(pair):
    _, _, tm, td, _ = pair
    bad = TG.GPTForCausalLM(TG.GPTConfig(
        vocab_size=256, hidden_size=64, num_layers=1, num_heads=2,
        intermediate_size=128), device="cpu").eval()
    with pytest.raises(EnforceError, match="vocab"):
        BatchedDecoder(tm, slots=1, capacity=64, device="cpu", draft=bad)
    with pytest.raises(EnforceError, match="decode_steps"):
        BatchedDecoder(tm, slots=1, capacity=64, device="cpu", draft=td,
                       decode_steps=4)
    with pytest.raises(EnforceError, match="gamma"):
        BatchedDecoder(tm, slots=1, capacity=64, device="cpu", draft=td,
                       gamma=0)
    dec = BatchedDecoder(tm, slots=1, capacity=32, device="cpu", draft=td,
                         gamma=4)
    with pytest.raises(EnforceError, match="margin"):
        dec.submit(np.arange(1, 9), 21)          # 8 + 21 + 4 > 32
