"""The port's ops/decode.py against the JAX package's on the CPU, on the
cases of tests/test_ops_decode.py (brute-force references where those
use them), inputs from numpy seeds:

- ``ctc_loss`` against the brute-force sum over alignments (1e-4
  relative) and against JAX, batched with lengths, with its gradient
  (1e-5); ``ctc_align`` and ``ctc_greedy_decode`` exactly;
- ``beam_search``: the argmax sequence of a state-free table, stopping
  at ``end_id`` with the score frozen, state reordered by parents, an
  empty state, each against JAX (sequences exactly, scores 1e-5);
- ``beam_search_step`` with the length penalty observable in a step,
  ``beam_search_batch_step``, ``beam_search_decode``, ``gather_beams``
  and ``beam_search_decode_lod`` (reordering under the penalty) against
  JAX, exactly or at 1e-6, ties at ``_NEG`` included;
- ``linear_chain_crf`` and ``crf_decoding`` against the brute force and
  JAX, lengths respected, the CRF's gradients (1e-5);
- ``edit_distance``, plain and normalized, against a numpy DP and JAX."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import decode as JD
from paddle_tpu_torch.ops import decode as TD


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close(got, want, atol):
    if torch.is_tensor(got):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0)


# ----- CTC -----------------------------------------------------------------

def _brute_ctc_nll(log_probs, labels, blank=0):
    t_len, v = log_probs.shape
    total = -np.inf
    for path in itertools.product(range(v), repeat=t_len):
        out, prev = [], -1
        for s in path:
            if s != prev and s != blank:
                out.append(s)
            prev = s
        if out == list(labels):
            total = np.logaddexp(total, sum(log_probs[t, s]
                                            for t, s in enumerate(path)))
    return -total


@pytest.mark.parametrize("labels", [[1], [1, 2], [2, 2], [1, 2, 1]])
def test_ctc_loss_matches_brute_force(labels):
    rng = np.random.default_rng(0)
    lp = torch.log_softmax(_t(rng.normal(size=(5, 3)).astype(np.float32)),
                           -1)
    n = len(labels)
    got = TD.ctc_loss(lp[None], _t([labels + [0] * (4 - n)]), _t([5]),
                      _t([n]))
    want = _brute_ctc_nll(lp.numpy(), labels)
    np.testing.assert_allclose(float(got[0]), want, rtol=1e-4)


def test_ctc_loss_batched_and_its_gradient_match_jax():
    rng = np.random.default_rng(1)
    b, t_len, v, n = 3, 8, 5, 3
    x = rng.normal(size=(b, t_len, v)).astype(np.float32)
    labels = rng.integers(1, v, size=(b, n))
    il, ll = np.array([8, 6, 5]), np.array([3, 2, 1])

    def jloss(x):
        return JD.ctc_loss(jax.nn.log_softmax(x, -1), jnp.asarray(labels),
                           jnp.asarray(il), jnp.asarray(ll))

    want = jloss(jnp.asarray(x))
    want_g = jax.grad(lambda x: jloss(x).sum())(jnp.asarray(x))
    tx = _t(x).requires_grad_()
    got = TD.ctc_loss(torch.log_softmax(tx, -1), _t(labels), _t(il),
                      _t(ll))
    got.sum().backward()
    assert got.shape == (b,)
    _close(got, want, 1e-5)
    _close(tx.grad, want_g, 1e-5)
    assert np.isfinite(tx.grad.numpy()).all()


def test_ctc_align_and_greedy_decode_match_jax():
    ids = np.array([[0, 1, 1, 0, 2, 2, 0, 3], [3, 3, 0, 3, 1, 0, 0, 2]])
    for lengths in ([8, 8], [5, 3]):
        got = TD.ctc_align(_t(ids), _t(lengths))
        want = JD.ctc_align(jnp.asarray(ids), jnp.asarray(lengths))
        for g, w in zip(got, want):
            _eq(g, w)
    out, n = TD.ctc_align(_t(ids[:1]), _t([8]))
    assert int(n[0]) == 3
    _eq(out[0, :3], [1, 2, 3])
    lp = np.log(np.array([[[0.1, 0.8, 0.1], [0.1, 0.8, 0.1],
                           [0.8, 0.1, 0.1], [0.1, 0.1, 0.8]]], np.float32))
    got = TD.ctc_greedy_decode(_t(lp), _t([4]))
    want = JD.ctc_greedy_decode(jnp.asarray(lp), jnp.asarray([4]))
    for g, w in zip(got, want):
        _eq(g, w)
    assert int(got[1][0]) == 2


# ----- beam search -----------------------------------------------------------

def _run_beam(step_j, step_t, init, **kw):
    want = JD.beam_search({k: jnp.asarray(v) for k, v in init.items()},
                          step_j, **kw)
    got = TD.beam_search({k: _t(v) for k, v in init.items()}, step_t, **kw)
    _eq(got[0], want[0])
    _close(got[1], want[1], 1e-5)
    return got


def test_beam_search_finds_the_argmax_sequence():
    v, k, t_len = 6, 3, 4
    rng = np.random.default_rng(2)
    tables = np.array(jax.nn.log_softmax(
        jnp.asarray(rng.normal(size=(t_len, v)).astype(np.float32)), -1))
    tables[:, 5] -= 100.0              # end_id unlikely: full length

    def step_j(state, tok):
        return jnp.asarray(tables)[state["t"]], {"t": state["t"] + 1}

    def step_t(state, tok):
        return _t(tables)[state["t"].long()], {"t": state["t"] + 1}

    seqs, scores = _run_beam(step_j, step_t,
                             {"t": np.zeros((k,), np.int32)}, beam_size=k,
                             max_len=t_len, bos_id=0, end_id=5)
    _eq(seqs[0], tables.argmax(1))
    assert float(scores[0]) == pytest.approx(float(tables.max(1).sum()),
                                             rel=1e-5)
    assert len({tuple(s.tolist()) for s in seqs}) == k
    assert (np.diff(scores.numpy()) <= 1e-6).all()


def test_beam_search_stops_at_end_id():
    k = 2
    late = np.log(np.array([0.01, 0.01, 0.01, 0.97], np.float32))
    early = np.log(np.array([0.05, 0.9, 0.03, 0.02], np.float32))

    def step_j(state, tok):
        t = state["t"]
        return (jnp.where(t[:, None] >= 1, late[None], early[None]),
                {"t": t + 1})

    def step_t(state, tok):
        t = state["t"]
        return (torch.where(t[:, None] >= 1, _t(late)[None],
                            _t(early)[None]), {"t": t + 1})

    seqs, scores = _run_beam(step_j, step_t,
                             {"t": np.zeros((k,), np.int32)}, beam_size=k,
                             max_len=5, bos_id=0, end_id=3)
    top = seqs[0].numpy()
    assert top[0] == 1 and (top[1:] == 3).all()
    assert float(scores[0]) == pytest.approx(np.log(0.9) + np.log(0.97),
                                             rel=1e-4)


def _stateless_beam(tables, **kw):
    """The port's beam search over per-step log-prob tables (on their
    device) with an empty state, the step counted on the host; returns (sequences, scores, the devices the tokens came on)."""
    seen = []

    def step(state, tok):
        seen.append(tok.device.type)
        return tables[len(seen) - 1].expand(tok.shape[0], -1), state

    return (*TD.beam_search({}, step, **kw), seen)


def _jax_table_beam(tables, **kw):
    """The JAX beam search over the same tables, its step read from a
    per-beam counter in the state."""
    def step(state, tok):
        return jnp.asarray(tables)[state["t"]], {"t": state["t"] + 1}

    k = kw["beam_size"]
    return JD.beam_search({"t": jnp.zeros((k,), jnp.int32)}, step, **kw)


def test_beam_search_with_an_empty_state_matches_jax():
    v, t_len = 7, 5
    rng = np.random.default_rng(5)
    tables = np.log(rng.dirichlet(np.ones(v), size=t_len)).astype(np.float32)
    kw = dict(beam_size=3, max_len=t_len, bos_id=0, end_id=6,
              length_penalty=0.6)
    seqs, scores, seen = _stateless_beam(_t(tables), **kw)
    want = _jax_table_beam(tables, **kw)
    _eq(seqs, want[0])
    _close(scores, want[1], 1e-5)
    assert seen == ["cpu"] * t_len


@pytest.mark.parametrize("penalty", [0.0, 0.6])
def test_beam_search_state_follows_its_parents(penalty):
    v, k = 5, 3
    base = np.log(np.array([0.04, 0.11, 0.2, 0.3, 0.35], np.float32))

    def step_j(state, tok):
        pen = (jax.nn.one_hot(tok, v) + jax.nn.one_hot(state["prev"], v))
        return jnp.broadcast_to(base, (k, v)) - 30.0 * pen, {"prev": tok}

    def step_t(state, tok):
        eye = torch.eye(v)
        pen = eye[tok.long()] + eye[state["prev"].long()]
        return _t(base).expand(k, v) - 30.0 * pen, {"prev": tok}

    seqs, _ = _run_beam(step_j, step_t, {"prev": np.zeros((k,), np.int32)},
                        beam_size=k, max_len=6, bos_id=0, end_id=0,
                        length_penalty=penalty)
    for s in seqs.numpy():
        assert all(s[i] != s[i + 1] for i in range(5)), s
        assert all(s[i] != s[i + 2] for i in range(4)), s


def test_length_penalty_is_observable_in_a_step():
    acc, fin = np.array([-1.0, -1.05], np.float32), np.array([True, False])
    lens = np.array([2, 5], np.int32)
    scores = np.array([[0.0, 0.0, 0.0], [-20.0, -20.0, -1e-4]], np.float32)
    for alpha in (0.0, 5.0):
        kw = dict(beam_size=2, end_id=1, length_penalty=alpha, step=6)
        got = TD.beam_search_step(_t(scores), _t(acc), _t(fin),
                                  lengths=_t(lens), **kw)
        want = JD.beam_search_step(jnp.asarray(scores), jnp.asarray(acc),
                                   jnp.asarray(fin),
                                   lengths=jnp.asarray(lens), **kw)
        for g, w in zip(got, want):
            _close(g, w, 0)
        assert int(got[1][0]) == (0 if alpha == 0.0 else 1)
    # lengths=None starts every beam at ``step``
    got = TD.beam_search_step(_t(scores), _t(acc), _t(fin), beam_size=2,
                              end_id=1, step=3)
    want = JD.beam_search_step(jnp.asarray(scores), jnp.asarray(acc),
                               jnp.asarray(fin), beam_size=2, end_id=1,
                               step=3)
    for g, w in zip(got, want):
        _close(g, w, 0)


def test_beam_search_batch_step_matches_jax_with_ties():
    rng = np.random.default_rng(7)
    b, k, v = 3, 4, 6
    logp = np.array(jax.nn.log_softmax(jnp.asarray(
        rng.normal(size=(b, k, v)).astype(np.float32)), -1))
    logp[1, 2] = logp[1, 1]            # two beams with equal candidates
    acc = np.full((b, k), TD._NEG, np.float32)
    acc[:, 0] = 0.0                     # dead beams: ties at exactly _NEG
    acc[2] = [-1.0, -1.5, -2.0, -1.5]
    fin = np.zeros((b, k), bool)
    fin[2, 1] = True
    lens = np.full((b, k), 3, np.int32)
    for lengths in (None, lens):
        kw = dict(beam_size=k, end_id=1, length_penalty=0.6)
        got = TD.beam_search_batch_step(
            _t(logp), _t(acc), _t(fin), 4,
            None if lengths is None else _t(lengths), **kw)
        want = JD.beam_search_batch_step(
            jnp.asarray(logp), jnp.asarray(acc), jnp.asarray(fin), 4,
            None if lengths is None else jnp.asarray(lengths), **kw)
        for g, w in zip(got, want):
            _close(g, w, 0)
        assert got[1].dtype == torch.int32 and got[2].dtype == torch.int32


def test_beam_search_decode_and_gather_beams_match_jax():
    rng = np.random.default_rng(8)
    t_len, b, k = 5, 2, 3
    ids = rng.integers(0, 9, (t_len, b, k))
    parents = rng.integers(0, k, (t_len, b, k))
    scores = rng.normal(size=(t_len, b, k)).astype(np.float32)
    for s in (None, scores):
        got = TD.beam_search_decode(_t(ids), _t(parents),
                                    None if s is None else _t(s), end_id=1)
        want = JD.beam_search_decode(jnp.asarray(ids), jnp.asarray(parents),
                                     None if s is None else jnp.asarray(s),
                                     end_id=1)
        _eq(got[0], want[0])
        _close(got[1], want[1], 0)
    x = rng.normal(size=(b, k, 2, 3)).astype(np.float32)
    par = rng.integers(0, k, (b, k))
    _eq(TD.gather_beams(_t(x), _t(par)),
        JD.gather_beams(jnp.asarray(x), jnp.asarray(par)))


def test_decode_lod_length_penalty_reorders():
    t_len, b, k, end = 4, 1, 2, 1
    ids = np.array([[[5, 6]], [[end, 7]], [[0, 8]], [[0, 9]]])
    parents = np.zeros((t_len, b, k), np.int32)
    parents[:, 0, 1] = 1
    final = np.array([[-1.0, -1.2]], np.float32)
    for alpha, best, length in ((0.0, -1.0, 2), (5.0, -1.2, 4)):
        got = TD.beam_search_decode_lod(_t(ids), _t(parents), _t(final),
                                        end_id=end, length_penalty=alpha)
        want = JD.beam_search_decode_lod(
            jnp.asarray(ids), jnp.asarray(parents), jnp.asarray(final),
            end_id=end, length_penalty=alpha)
        for g, w in zip(got, want):
            _close(g, w, 0)
        assert float(got[2][0, 0]) == pytest.approx(best, rel=1e-6)
        assert int(got[1][0, 0]) == length


# ----- CRF -----------------------------------------------------------------

def _brute_crf(em, tr, start, stop, labels):
    t_len, n = em.shape

    def score(path):
        s = start[path[0]] + em[0, path[0]]
        for t in range(1, t_len):
            s += tr[path[t - 1], path[t]] + em[t, path[t]]
        return s + stop[path[-1]]

    paths = list(itertools.product(range(n), repeat=t_len))
    logz = np.logaddexp.reduce([score(p) for p in paths])
    best = max(paths, key=score)
    return logz - score(labels), best, score(best)


def test_linear_chain_crf_and_viterbi_match_brute_force_and_jax():
    rng = np.random.default_rng(3)
    t_len, n = 4, 3
    em = rng.normal(size=(t_len, n)).astype(np.float32)
    tr = rng.normal(size=(n, n)).astype(np.float32)
    start = rng.normal(size=n).astype(np.float32)
    stop = rng.normal(size=n).astype(np.float32)
    labels = [1, 0, 2, 1]
    want_nll, want_path, want_best = _brute_crf(em, tr, start, stop, labels)
    kw_t = dict(start_transitions=_t(start), stop_transitions=_t(stop))
    kw_j = dict(start_transitions=jnp.asarray(start),
                stop_transitions=jnp.asarray(stop))
    got = TD.linear_chain_crf(_t(em)[None], _t(tr), _t([labels]),
                              _t([t_len]), **kw_t)
    np.testing.assert_allclose(float(got[0]), want_nll, rtol=1e-4)
    _close(got, JD.linear_chain_crf(jnp.asarray(em)[None], jnp.asarray(tr),
                                    jnp.asarray([labels]),
                                    jnp.asarray([t_len]), **kw_j), 1e-5)
    paths, scores = TD.crf_decoding(_t(em)[None], _t(tr), _t([t_len]),
                                    **kw_t)
    _eq(paths[0], want_path)
    np.testing.assert_allclose(float(scores[0]), want_best, rtol=1e-4)


def test_crf_respects_lengths_and_matches_jax():
    rng = np.random.default_rng(4)
    b, t_len, n = 3, 6, 4
    em = rng.normal(size=(b, t_len, n)).astype(np.float32)
    tr = rng.normal(size=(n, n)).astype(np.float32)
    labels = rng.integers(0, n, size=(b, t_len))
    lengths = np.array([4, 6, 1])
    nll = TD.linear_chain_crf(_t(em), _t(tr), _t(labels), _t(lengths))
    nll4 = TD.linear_chain_crf(_t(em[:1, :4]), _t(tr), _t(labels[:1, :4]),
                               _t([4]))
    np.testing.assert_allclose(float(nll[0]), float(nll4[0]), rtol=1e-4)
    _close(nll, JD.linear_chain_crf(jnp.asarray(em), jnp.asarray(tr),
                                    jnp.asarray(labels),
                                    jnp.asarray(lengths)), 1e-5)
    paths, best = TD.crf_decoding(_t(em), _t(tr), _t(lengths))
    want_p, want_b = JD.crf_decoding(jnp.asarray(em), jnp.asarray(tr),
                                     jnp.asarray(lengths))
    _eq(paths, want_p)
    _close(best, want_b, 1e-5)
    assert (paths[0, 4:] == 0).all() and (paths[2, 1:] == 0).all()


def test_crf_gradients_match_jax():
    rng = np.random.default_rng(5)
    t_len, n = 5, 3
    em = rng.normal(size=(2, t_len, n)).astype(np.float32)
    labels = rng.integers(0, n, size=(2, t_len))
    lengths = np.array([5, 3])
    tr0 = rng.normal(size=(n, n)).astype(np.float32)

    def jf(em, tr):
        return JD.linear_chain_crf(em, tr, jnp.asarray(labels),
                                   jnp.asarray(lengths)).sum()

    want_em, want_tr = jax.grad(jf, argnums=(0, 1))(jnp.asarray(em),
                                                    jnp.asarray(tr0))
    tem, ttr = _t(em).requires_grad_(), _t(tr0).requires_grad_()
    TD.linear_chain_crf(tem, ttr, _t(labels), _t(lengths)).sum().backward()
    _close(tem.grad, want_em, 1e-5)
    _close(ttr.grad, want_tr, 1e-5)
    assert np.abs(ttr.grad.numpy()).sum() > 0


# ----- edit distance ---------------------------------------------------------

def _np_edit(a, b):
    dp = np.zeros((len(a) + 1, len(b) + 1))
    dp[:, 0] = np.arange(len(a) + 1)
    dp[0, :] = np.arange(len(b) + 1)
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            dp[i, j] = min(dp[i - 1, j] + 1, dp[i, j - 1] + 1,
                           dp[i - 1, j - 1] + (a[i - 1] != b[j - 1]))
    return dp[len(a), len(b)]


@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance_matches_naive_and_jax(normalized):
    rng = np.random.default_rng(6)
    b, lh, lr = 4, 6, 5
    hyp = rng.integers(0, 5, size=(b, lh))
    ref = rng.integers(0, 5, size=(b, lr))
    hl = rng.integers(1, lh + 1, size=b)
    rl = rng.integers(1, lr + 1, size=b)
    got = TD.edit_distance(_t(hyp), _t(hl), _t(ref), _t(rl),
                           normalized=normalized)
    want = [_np_edit(hyp[i, :hl[i]].tolist(), ref[i, :rl[i]].tolist())
            / (rl[i] if normalized else 1) for i in range(b)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    _close(got, JD.edit_distance(jnp.asarray(hyp), jnp.asarray(hl),
                                 jnp.asarray(ref), jnp.asarray(rl),
                                 normalized=normalized), 1e-6)
    one = TD.edit_distance(_t([[1, 2, 3]]), _t([3]), _t([[1, 2, 4]]),
                           _t([3]), normalized=True)
    assert float(one[0]) == pytest.approx(1 / 3)
