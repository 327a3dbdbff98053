"""Sequence decoding and structured-prediction ops (counterpart of
paddle_tpu/ops/decode.py): CTC loss, alignment and greedy decoding, beam
search with GNMT length normalisation and parent backtracking, the
linear-chain CRF and its Viterbi decoding, and edit distance.

The JAX package writes each dynamic program as a ``lax.scan`` over time;
here each is a loop over time of tensor operations on the caller's
device, with the same static shapes and length masks, so the tensors
never leave the device and nothing is read back to the host inside a
loop. The CTC and CRF losses are differentiable by autograd.

Orders follow the JAX package where it fixes them: the beam step's top-k
puts the lower flat index first among equal candidates (``lax.top_k``),
and the final rankings are stable sorts (``jnp.argsort``). Ties are
common there: a dead or finished beam's candidates sit at exactly
``_NEG`` in float32.

An id or length out of range reads what the JAX package reads, with no
host read and no device assert: ``take_along_axis`` gives NaN and plain
indexing clamps, its gradient dropped (ops/tensor.py)."""

from __future__ import annotations

from typing import Callable

import torch

from ..clip import tree_leaves, tree_map
from ..core.enforce import enforce
from .tensor import _drop_grad, _in_range, _take_along, _wrap_clamp

__all__ = ["ctc_loss", "ctc_align", "ctc_greedy_decode", "beam_search_step",
           "beam_search", "beam_search_decode", "beam_search_batch_step",
           "beam_search_decode_lod", "gather_beams", "linear_chain_crf",
           "crf_decoding", "edit_distance"]

_NEG = -1e30


def _logsumexp2(a, b):
    m = torch.maximum(a, b)
    dead = m <= _NEG
    m_safe = torch.where(dead, 0.0, m)
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe)
    # the dead branch stays NaN-free under grad: log(0) -> log(1)
    out = m_safe + torch.log(torch.where(dead, 1.0, s))
    return torch.where(dead, _NEG, out)


def _shift_right(x, n: int):
    """``x`` (B, S) shifted n places right along S, the front filled with
    ``_NEG``."""
    return torch.cat([x.new_full((x.shape[0], n), _NEG), x[:, :-n]], dim=1)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, *,
             blank: int = 0):
    """CTC negative log-likelihood: the alpha recursion in log space, one
    step per frame. log_probs (B, T, V) log-softmax outputs; labels (B, L)
    padded; input_lengths and label_lengths (B,). Returns (B,) losses."""
    b, t_len, _ = log_probs.shape
    dev = log_probs.device
    labels = labels.long().to(dev)
    input_lengths = input_lengths.to(dev)
    label_lengths = label_lengths.to(dev)
    s_len = 2 * labels.shape[1] + 1
    # extended labels: blank l1 blank l2 ... blank
    ext = torch.full((b, s_len), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    # alpha[s] also takes alpha[s-2] where the symbol is not blank and
    # differs from the one two back
    prev2_ok = torch.zeros((b, s_len), dtype=torch.bool, device=dev)
    prev2_ok[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    lp0 = log_probs[:, 0]
    alpha = torch.full((b, s_len), _NEG, dtype=log_probs.dtype, device=dev)
    alpha = torch.cat([
        _take_along(lp0, ext[:, :1], 1),
        torch.where(label_lengths[:, None] > 0,
                    _take_along(lp0, ext[:, 1:2], 1), _NEG),
        alpha[:, 2:]], dim=1)
    for t in range(1, t_len):
        emit = _take_along(log_probs[:, t], ext, 1)
        a2 = torch.where(prev2_ok, _shift_right(alpha, 2), _NEG)
        new = _logsumexp2(_logsumexp2(alpha, _shift_right(alpha, 1)),
                          a2) + emit
        # frozen past input_length: the final read takes that alpha
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
    send = 2 * label_lengths.long()         # the final blank's index
    a_end = _take_along(alpha, send[:, None], 1)[:, 0]
    a_lab = _take_along(alpha, (send - 1).clamp_min(0)[:, None], 1)[:, 0]
    a_lab = torch.where(label_lengths > 0, a_lab, _NEG)
    return -_logsumexp2(a_end, a_lab)


def ctc_align(ids, lengths, *, blank: int = 0):
    """Collapse repeats, then drop blanks (reference:
    operators/ctc_align_op.cc). ids (B, T) -> (out (B, T), out_lengths
    (B,)), ``out`` padded with ``blank``: fixed capacity instead of LoD
    shrinkage."""
    b, t_len = ids.shape
    dev = ids.device
    prev = torch.cat([ids.new_full((b, 1), -1), ids[:, :-1]], dim=1)
    t_idx = torch.arange(t_len, device=dev)[None, :]
    keep = ((ids != blank) & (ids != prev)
            & (t_idx < lengths.to(dev)[:, None]))
    # stable compaction: a kept id lands at the count of kept ids before it
    pos = torch.cumsum(keep.long(), dim=1) - 1
    out_len = torch.where(keep, pos + 1, 0).amax(dim=1)
    # dropped ids write to a spare column T, cut off after
    out = ids.new_full((b, t_len + 1), blank)
    out.scatter_(1, torch.where(keep, pos, t_len), ids)
    return out[:, :t_len], out_len


def ctc_greedy_decode(log_probs, lengths, *, blank: int = 0):
    """The argmax per frame through :func:`ctc_align` (the reference's
    greedy CTC decoder)."""
    return ctc_align(torch.argmax(log_probs, dim=-1), lengths, blank=blank)


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

def _penalty(lengths, dtype, length_penalty: float):
    """GNMT's ``((5 + len) / 6) ** alpha``, in ``dtype``."""
    return ((5.0 + lengths.to(dtype)) / 6.0) ** length_penalty


def _batch_step(scores, acc, finished, step, lengths, *, end_id: int,
                length_penalty: float):
    """One expansion step for B sources at once: scores (B, K, V), acc
    (B, K), finished (B, K) bool, lengths (B, K) int; ``step`` an int or
    0-dim tensor. Each source's K best of its K*V candidates, ranked by
    the length-normalised score, the lower flat index first among equal
    ones (``lax.top_k``'s order). Returns (acc, parent, token, finished,
    lengths), each (B, K), parent and token int64."""
    b, k, v = scores.shape
    dev = scores.device
    frozen = torch.full((v,), _NEG, dtype=scores.dtype, device=dev)
    frozen[end_id] = 0.0
    fin = finished[..., None]
    # finished beams: the score freezes and only end_id continues
    total = torch.where(fin, acc[..., None] + frozen, acc[..., None] + scores)
    # a fill, not a copy of host data (which would wait for the card)
    step_t = (step.to(device=dev, dtype=torch.int32) if torch.is_tensor(step)
              else torch.full((), int(step), dtype=torch.int32, device=dev))
    cand_len = torch.where(fin, lengths.to(torch.int32)[..., None], step_t)
    ranked = (total / _penalty(cand_len, total.dtype, length_penalty))
    order = torch.sort(ranked.reshape(b, k * v), dim=1, descending=True,
                       stable=True).indices[:, :k]
    parent = torch.div(order, v, rounding_mode="floor")
    token = order % v
    next_acc = torch.gather(total.reshape(b, k * v), 1, order)
    fin_parent = torch.gather(finished, 1, parent)
    next_fin = fin_parent | (token == end_id)
    # finished keep their frozen length; newly finished and live
    # candidates are ``step`` tokens long
    next_len = torch.where(fin_parent,
                           torch.gather(lengths.to(torch.int32), 1, parent),
                           step_t)
    return next_acc, parent, token, next_fin, next_len


def beam_search_step(scores, beam_log_probs, finished, *, beam_size: int,
                     end_id: int, length_penalty: float = 0.0, step=1,
                     lengths=None):
    """One expansion step (the reference's beam_search op, minus LoD
    bookkeeping): scores (K, V) log-probs of each beam's continuations,
    beam_log_probs (K,) accumulated. Candidates are ranked by
    ``total / ((5 + len) / 6) ** length_penalty`` with ``len`` each
    hypothesis's own length: ``step`` for live candidates, the frozen
    ``lengths`` (K,) for finished beams (None starts every beam at
    ``step``); accumulated scores stay un-penalized. Returns (next_acc
    (K,), parent (K,), token (K,), next_finished (K,), next_lengths
    (K,)); finished beams continue only with end_id."""
    k = scores.shape[0]
    dev = scores.device
    if lengths is None:
        lengths = torch.full((k,), int(step), dtype=torch.int32, device=dev)
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
    out = _batch_step(scores[None], torch.as_tensor(beam_log_probs)[None],
                      torch.as_tensor(finished, device=dev).bool()[None],
                      step, lengths[None], end_id=end_id,
                      length_penalty=length_penalty)
    return tuple(x[0] for x in out)


def _beam_search_rows(init_state, step_fn: Callable, *, batch: int,
                      beam_size: int, max_len: int, bos_id: int,
                      end_id: int, length_penalty: float = 0.0,
                      device=None):
    """Beam search over ``batch`` sources at once, each its own K beams:
    state leaves carry a leading (batch * K) axis, source-major, and
    ``step_fn(state, token (batch*K,), t)`` (``t`` the step, a Python
    int) returns (log_probs (batch*K, V), new_state). After every step
    the whole state follows its beams' parents (caches too). Each
    source's result equals :func:`beam_search` on it alone. The first
    tokens go to ``device``; the beams then live where the log-probs do,
    and each state leaf is gathered on its own device. Returns
    (sequences (batch, K, max_len) best-first, scores (batch, K), raw)."""
    k = beam_size
    tok = torch.full((batch * k,), bos_id, dtype=torch.long, device=device)
    acc = torch.full((batch, k), _NEG, dtype=torch.float32, device=device)
    acc[:, 0] = 0.0                     # only beam 0 is live at the start
    fin = torch.zeros((batch, k), dtype=torch.bool, device=device)
    lens = torch.zeros((batch, k), dtype=torch.int32, device=device)
    rows = (torch.arange(batch, device=device) * k)[:, None]
    state = init_state
    parents, tokens = [], []
    for t in range(max_len):
        logp, state = step_fn(state, tok, t)
        logp = logp.reshape(batch, k, -1)
        if t == 0:
            acc, fin, lens, rows = (x.to(logp.device)
                                    for x in (acc, fin, lens, rows))
        acc, parent, token, fin, lens = _batch_step(
            logp, acc.to(logp.dtype), fin, t + 1, lens, end_id=end_id,
            length_penalty=length_penalty)
        flat = (rows + parent).reshape(-1)
        state = tree_map(lambda s: s[flat.to(s.device)], state)
        tok = token.reshape(-1)
        parents.append(parent)
        tokens.append(token)
    # backtrack: walk the parent pointers from the end
    seqs = _backtrack(torch.stack(tokens), torch.stack(parents))
    # the final ranking is length-normalized (GNMT); scores stay raw
    order = torch.sort(-(acc / _penalty(lens.clamp_min(1), acc.dtype,
                                        length_penalty)),
                       dim=1, stable=True).indices
    return gather_beams(seqs, order), torch.gather(acc, 1, order)


def _backtrack(step_ids, step_parents):
    """step_ids and step_parents (T, B, K) -> (B, K, T): beam k's tokens,
    found by following the parent pointers back from step T-1."""
    t_len, b, k = step_ids.shape
    beam = torch.arange(k, device=step_ids.device).expand(b, k)
    out = []
    for t in range(t_len - 1, -1, -1):
        out.append(torch.gather(step_ids[t], 1, beam))
        beam = torch.gather(step_parents[t].long(), 1, beam)
    return torch.stack(out[::-1], dim=-1)


def beam_search(init_state, step_fn: Callable, *, beam_size: int,
                max_len: int, bos_id: int, end_id: int,
                length_penalty: float = 0.0):
    """The decode loop of one source (the reference's beam_search +
    beam_search_decode ops inside a While block): ``step_fn(state, token
    (K,)) -> (log_probs (K, V), new_state)``, state leaves with a leading
    beam axis (K, ...), gathered by parent after each step. Returns
    (sequences (K, max_len), scores (K,)) best-first, scores raw."""
    leaves = tree_leaves(init_state)
    seqs, scores = _beam_search_rows(
        init_state, lambda state, tok, t: step_fn(state, tok), batch=1,
        beam_size=beam_size, max_len=max_len, bos_id=bos_id, end_id=end_id,
        length_penalty=length_penalty,
        device=leaves[0].device if leaves else None)
    return seqs[0], scores[0]


# ---------------------------------------------------------------------------
# Linear-chain CRF
# ---------------------------------------------------------------------------

def _boundaries(emissions, start_transitions, stop_transitions):
    n = emissions.shape[-1]
    zeros = emissions.new_zeros((n,))
    return (zeros if start_transitions is None else start_transitions,
            zeros if stop_transitions is None else stop_transitions)


def linear_chain_crf(emissions, transitions, labels, lengths, *,
                     start_transitions=None, stop_transitions=None):
    """Negative log-likelihood of a linear-chain CRF (reference:
    operators/linear_chain_crf_op.cc; its start/stop weights are explicit
    optional arguments here). emissions (B, T, N), labels (B, T), lengths
    (B,) -> (B,) nll."""
    b, t_len, _ = emissions.shape
    dev = emissions.device
    start, stop = _boundaries(emissions, start_transitions,
                              stop_transitions)
    labels = labels.long().to(dev)
    lengths = lengths.to(dev)
    # the partition function by the forward algorithm
    alpha = start[None] + emissions[:, 0]
    for t in range(1, t_len):
        new = torch.logsumexp(alpha[:, :, None] + transitions[None], dim=1)
        new = new + emissions[:, t]
        alpha = torch.where((t < lengths)[:, None], new, alpha)
    log_z = torch.logsumexp(alpha + stop[None], dim=1)
    # the gold path's score
    t_idx = torch.arange(t_len, device=dev)[None, :]
    live = t_idx < lengths[:, None]
    n = emissions.shape[-1]
    emit = _take_along(emissions, labels[..., None], 2)[..., 0]
    emit = torch.where(live, emit, 0.0).sum(dim=1)
    # x[idx] reads: clamped, the gradient of a clamped read dropped
    trans = _drop_grad(
        transitions[_wrap_clamp(labels[:, :-1], n),
                    _wrap_clamp(labels[:, 1:], n)],
        _in_range(labels[:, :-1], n) & _in_range(labels[:, 1:], n))
    trans = torch.where(live[:, 1:], trans, 0.0).sum(dim=1)
    last = _take_along(labels, (lengths.long() - 1).clamp_min(0)[:, None],
                       1)[:, 0]
    first = _drop_grad(start[_wrap_clamp(labels[:, 0], n)],
                       _in_range(labels[:, 0], n))
    gold = emit + trans + first + _drop_grad(stop[_wrap_clamp(last, n)],
                                             _in_range(last, n))
    return log_z - gold


def crf_decoding(emissions, transitions, lengths, *,
                 start_transitions=None, stop_transitions=None):
    """Viterbi decoding (reference: operators/crf_decoding_op.cc) ->
    (paths (B, T), scores (B,)); positions past ``lengths`` hold 0. The
    first best label wins a tie, as ``jnp.argmax``."""
    b, t_len, n = emissions.shape
    dev = emissions.device
    start, stop = _boundaries(emissions, start_transitions,
                              stop_transitions)
    lengths = lengths.to(dev)
    ident = torch.arange(n, device=dev).expand(b, n)
    score = start[None] + emissions[:, 0]
    ptrs = []
    for t in range(1, t_len):
        cand = score[:, :, None] + transitions[None]       # (B, N, N)
        live = (t < lengths)[:, None]
        ptrs.append(torch.where(live, torch.argmax(cand, dim=1), ident))
        score = torch.where(live, cand.amax(dim=1) + emissions[:, t], score)
    final = score + stop[None]
    cur = torch.argmax(final, dim=1)
    best = final.amax(dim=1)
    path = [cur]
    for ptr in reversed(ptrs):
        cur = torch.gather(ptr, 1, cur[:, None])[:, 0]
        path.append(cur)
    paths = torch.stack(path[::-1], dim=1)
    paths = torch.where(torch.arange(t_len, device=dev)[None]
                        < lengths[:, None], paths, 0)
    return paths, best


def edit_distance(hyp, hyp_lengths, ref, ref_lengths, *,
                  normalized: bool = False):
    """Levenshtein distance between padded id rows (reference:
    operators/edit_distance_op.cc): the dynamic program over hypothesis
    positions, a (B, Lr + 1) row of distances at a time. Returns (B,)
    float32 distances, divided by the reference length (at least 1) when
    ``normalized``."""
    b, lh = hyp.shape
    lr = ref.shape[1]
    dev = hyp.device
    hyp_lengths = hyp_lengths.to(dev)
    ref = ref.to(dev)
    row = torch.arange(lr + 1, dtype=torch.float32,
                       device=dev).expand(b, lr + 1)
    for i in range(lh):
        cost = (hyp[:, i:i + 1] != ref).to(torch.float32)      # (B, Lr)
        cols = [row[:, 0] + 1]
        for j in range(lr):
            cols.append(torch.minimum(torch.minimum(cols[-1] + 1,
                                                    row[:, j + 1] + 1),
                                      row[:, j] + cost[:, j]))
        new = torch.stack(cols, dim=1)
        row = torch.where((i < hyp_lengths)[:, None], new, row)
    rl = ref_lengths.to(dev).long()
    # row[rl] in JAX: a length past Lr reads the last column
    d = torch.gather(row, 1, _wrap_clamp(rl, lr + 1)[:, None])[:, 0]
    return d / rl.clamp_min(1) if normalized else d


# ---------------------------------------------------------------------------
# Batched beam bookkeeping (the ops the reference runs inside its decode
# While block)
# ---------------------------------------------------------------------------

def beam_search_decode(step_ids, step_parents, step_scores=None, *,
                       end_id: int = 1):
    """Backtrack per-step beam candidates into whole sequences
    (reference: operators/beam_search_decode_op.cc walks the LoD parent
    links; here parents are an explicit array). step_ids and
    step_parents (T, B, K); step_scores (T, B, K) optional cumulative
    scores. Returns (sequences (B, K, T), scores (B, K): each beam's last
    cumulative score, zeros if none given)."""
    t_len, b, k = step_ids.shape
    seqs = _backtrack(step_ids, step_parents)
    scores = (step_scores[-1] if step_scores is not None
              else torch.zeros((b, k), dtype=torch.float32,
                               device=step_ids.device))
    return seqs, scores


def beam_search_batch_step(log_probs, pre_scores, finished, step,
                           lengths=None, *, beam_size: int, end_id: int,
                           length_penalty: float = 0.0):
    """The batched :func:`beam_search_step`: each of B sources keeps
    exactly K live beams. log_probs (B, K, V), pre_scores (B, K),
    finished (B, K) bool-ish, ``step`` the loop counter (drives the
    length penalty), lengths (B, K) frozen hypothesis lengths (None
    starts at ``step``). Returns (acc (B, K), parent (B, K) int32, token
    (B, K) int32, finished (B, K) bool, lengths (B, K) int32)."""
    enforce(log_probs.shape[1] == beam_size,
            "log_probs has %s beams, beam_size is %s", log_probs.shape[1],
            beam_size)
    t = int(step) if not torch.is_tensor(step) else step.reshape(())
    if lengths is None:
        lengths = torch.as_tensor(t, dtype=torch.int32,
                                  device=log_probs.device).expand(
                                      pre_scores.shape)
    acc, parent, token, fin, lens = _batch_step(
        log_probs, pre_scores, torch.as_tensor(finished).bool(), t,
        lengths, end_id=end_id, length_penalty=length_penalty)
    return (acc, parent.to(torch.int32), token.to(torch.int32), fin, lens)


def gather_beams(x, parent):
    """Per-beam state reordered by parent: x (B, K, ...), parent (B, K)
    -> x[b, parent[b, k]]."""
    idx = parent.long().reshape(parent.shape + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, idx.expand(parent.shape + x.shape[2:]))


def beam_search_decode_lod(step_ids, step_parents, final_scores, *,
                           end_id: int = 1,
                           length_penalty: float = 0.0):
    """Backtrack, rank and measure: the padded-dense form of the
    reference's level-2 LoD result (operators/beam_search_decode_op.cc).
    Returns sequences (B, K, T) best-first (by the length-normalized final
    score), lengths (B, K) (up to and including the first ``end_id``; T
    when the beam never finished) and scores (B, K), raw, in that
    order."""
    seqs, _ = beam_search_decode(step_ids, step_parents, end_id=end_id)
    t_len = step_ids.shape[0]
    is_end = seqs == end_id
    first = torch.argmax(is_end.to(torch.int32), dim=-1)
    lengths = torch.where(is_end.any(dim=-1), first + 1,
                          t_len).to(torch.int32)
    order = torch.sort(-(final_scores / _penalty(
        lengths.clamp_min(1), final_scores.dtype, length_penalty)),
        dim=1, stable=True).indices
    return (gather_beams(seqs, order), torch.gather(lengths, 1, order),
            torch.gather(final_scores, 1, order))
