"""Sequence ops (counterpart of paddle_tpu/ops/sequence.py) over the
padded layout that replaces the reference's LoD: a batch of sequences is
a dense (B, T_max, ...) tensor plus an integer ``lengths`` (B,) vector,
and each op is a masked dense op (reference:
paddle/fluid/operators/sequence_ops/).

Three ops take a size from the data, and on the card read it back to
the host, one synchronisation a call: ``sequence_unpad`` (its output's
length), and ``sequence_expand``/``sequence_expand_as`` when no ``rmax``
is given (the largest ref length). Everything else reads nothing back.
``chunk_eval`` walks the time axis in a Python loop of T + 1 steps of
device ops, where the JAX package scans."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.dtypes import to_dtype
from ..core.enforce import enforce
from .tensor import _drop_grad, _in_range, _take_along, _wrap_clamp


def sequence_mask(lengths, maxlen: int, dtype=torch.float32):
    """(B, maxlen) mask, 1 where position < the row's length
    (reference: operators/sequence_mask_op.cc)."""
    lengths = torch.as_tensor(lengths)
    pos = torch.arange(maxlen, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(to_dtype(dtype))


def _lowest(dtype):
    """The most negative value of a float or integer dtype."""
    if dtype.is_floating_point:
        return torch.finfo(dtype).min
    return torch.iinfo(dtype).min


def _bcast(v, ndim: int):
    """(B, T) -> (B, T, 1, ...) against a tensor of ``ndim`` dims."""
    return v.reshape(tuple(v.shape) + (1,) * (ndim - v.ndim))


def sequence_pad(flat, lengths, maxlen: int, pad_value: float = 0.0):
    """reference: sequence_pad_op.cc — packed (sum(L), ...) rows plus
    lengths -> (B, maxlen, ...), ``pad_value`` past each length."""
    lengths = torch.as_tensor(lengths, device=flat.device)
    offsets = torch.cumsum(lengths.long(), 0) - lengths.long()
    idx = offsets[:, None] + torch.arange(maxlen, device=flat.device)
    out = flat[torch.clamp_max(idx, flat.shape[0] - 1)]
    mask = _bcast(sequence_mask(lengths, maxlen, torch.bool), out.ndim)
    return torch.where(mask, out, torch.full((), pad_value, dtype=out.dtype,
                                             device=out.device))


def sequence_unpad(x, lengths):
    """reference: sequence_unpad_op.cc — the valid prefixes of the rows of
    x, concatenated. Its length depends on the data: on the card this
    reads it back, one host synchronisation."""
    lengths = torch.as_tensor(lengths, device=x.device)
    return x[sequence_mask(lengths, x.shape[1], torch.bool)]


def sequence_pool(x, lengths, pool_type: str = "sum"):
    """reference: sequence_pool_op.cc — pool (B, T, ...) over the valid
    time steps: sum, average, sqrt, max (0 for an empty row), last or
    first."""
    mask = _bcast(sequence_mask(lengths, x.shape[1], x.dtype), x.ndim)

    def row(v):
        return v.reshape((-1,) + (1,) * (x.ndim - 2))

    if pool_type == "sum":
        return torch.sum(x * mask, dim=1)
    if pool_type == "average":
        denom = row(torch.clamp_min(lengths.to(x.dtype), 1.0))
        return torch.sum(x * mask, dim=1) / denom
    if pool_type == "sqrt":
        denom = row(torch.sqrt(torch.clamp_min(lengths.to(x.dtype), 1.0)))
        return torch.sum(x * mask, dim=1) / denom
    if pool_type == "max":
        masked = torch.where(mask > 0, x, torch.full(
            (), _lowest(x.dtype), dtype=x.dtype, device=x.device))
        out = torch.amax(masked, dim=1)
        return torch.where(row(lengths) > 0, out, torch.zeros_like(out))
    if pool_type == "last":
        # x[..., idx] in JAX reads row T - 1 for a length past T, and its
        # gradient drops that read
        last = torch.clamp_min(lengths - 1, 0)
        out = x[torch.arange(x.shape[0], device=x.device),
                _wrap_clamp(last, x.shape[1])]
        return _drop_grad(out, _in_range(last, x.shape[1]))
    if pool_type == "first":
        return x[:, 0]
    enforce(False, "unknown pool_type %s", pool_type)


def sequence_softmax(x, lengths):
    """reference: sequence_softmax_op.cc — softmax over each row's valid
    steps of (B, T), 0 past its length."""
    mask = sequence_mask(lengths, x.shape[1], torch.bool)
    masked = torch.where(mask, x, torch.full((), _lowest(x.dtype),
                                             dtype=x.dtype, device=x.device))
    return torch.softmax(masked, dim=1) * mask.to(x.dtype)


def sequence_reverse(x, lengths):
    """reference: sequence_reverse_op.cc — each row's valid prefix
    reversed; the padding stays where it is. A length past T reads
    source steps past the end, which give NaN (``jnp.take_along_axis``)."""
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    ln = lengths[:, None]
    src = torch.where(pos < ln, ln - 1 - pos, pos).long()
    return _take_along(x, _bcast(src, x.ndim), 1)


def sequence_expand(x, ref_lengths, rmax: Optional[int] = None):
    """reference: sequence_expand_op.cc — row i of (B, ...) repeated
    ``ref_lengths[i]`` times along a new axis: (B, rmax, ...), zero past
    each length. Without ``rmax`` the bound is the largest ref length,
    read from the data (on the card, one host synchronisation)."""
    if rmax is None:
        rmax = (max(ref_lengths) if isinstance(ref_lengths, (list, tuple))
                else int(torch.max(torch.as_tensor(ref_lengths))))
    out = x[:, None].repeat_interleave(rmax, dim=1)
    mask = sequence_mask(torch.as_tensor(ref_lengths, device=x.device),
                         rmax, out.dtype)
    return out * _bcast(mask, out.ndim)


def sequence_concat(xs, lengths_list):
    """reference: sequence_concat_op.cc — per row, the valid prefixes of
    each input one after another: ((B, sum T_i, ...), summed lengths).
    The source of each output step is computed from the lengths on the
    device, no host read."""
    b = xs[0].shape[0]
    total = sum(x.shape[1] for x in xs)
    dev = xs[0].device
    lens = [torch.as_tensor(l, device=dev).long() for l in lengths_list]
    result = torch.zeros((b, total) + tuple(xs[0].shape[2:]),
                         dtype=xs[0].dtype, device=dev)
    t_out = torch.arange(total, device=dev)[None, :]
    start = torch.zeros(b, dtype=torch.long, device=dev)
    for x, ln in zip(xs, lens):
        src = t_out - start[:, None]
        valid = (src >= 0) & (src < ln[:, None])
        src = torch.clamp(src, 0, x.shape[1] - 1)
        gathered = torch.take_along_dim(x, _bcast(src, x.ndim), dim=1)
        result = torch.where(_bcast(valid, x.ndim), gathered, result)
        start = start + ln
    return result, sum(lens)


def sequence_slice(x, lengths, offset, length):
    """reference: sequence_slice_op.cc — row i's window [offset[i],
    offset[i] + length[i]), left-aligned, zero past it; (window,
    length)."""
    b, t = x.shape[:2]
    pos = torch.arange(t, device=x.device)[None, :]
    src = torch.clamp(pos + offset[:, None], 0, t - 1).long()
    out = torch.take_along_dim(x, _bcast(src, x.ndim), dim=1)
    mask = _bcast(pos < length[:, None], x.ndim)
    return out * mask.to(x.dtype), length


def sequence_enumerate(x, lengths, win_size: int, pad_value: int = 0):
    """reference: sequence_enumerate_op.cc — the ``win_size`` windows of
    ids (B, T) starting at each step: (B, T, win_size), ``pad_value``
    past each length."""
    t = x.shape[1]
    idx = (torch.arange(t, device=x.device)[:, None]
           + torch.arange(win_size, device=x.device)[None, :])
    valid = idx < lengths[:, None, None]
    out = x[:, torch.clamp_max(idx, t - 1)]
    return torch.where(valid, out, torch.full((), pad_value, dtype=x.dtype,
                                              device=x.device))


def sequence_erase(x, lengths, tokens):
    """reference: sequence_erase_op.cc — the listed ``tokens`` removed
    from each row's valid prefix, the rest moved left in order, zeros
    after: (ids, new lengths int32). A stable sort of the kept flags,
    no host read."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    drop = torch.isin(x, torch.as_tensor(list(tokens), dtype=x.dtype,
                                         device=x.device))
    keep = (pos < lengths[:, None]) & ~drop
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    out = torch.take_along_dim(x, order, dim=1)
    kept = torch.take_along_dim(keep, order, dim=1)
    return (torch.where(kept, out, torch.zeros_like(out)),
            keep.sum(dim=1).to(torch.int32))


def sequence_expand_as(x, ref_lengths, rmax: Optional[int] = None):
    """reference: sequence_expand_as_op.cc (:func:`sequence_expand`)."""
    return sequence_expand(x, ref_lengths, rmax=rmax)


def im2sequence(x, kernel, stride, padding=(0, 0)):
    """reference: operators/im2sequence_op.cc — the NCHW image's patches
    as a sequence: (N, oh * ow, C * kh * kw), channel-major patches."""
    patches = F.unfold(x, tuple(kernel), stride=tuple(stride),
                       padding=tuple(padding))
    return patches.transpose(1, 2)


def position_encoding(x, alpha: float = 1.0, beta: float = 1.0):
    """reference: operators/add_position_encoding_op.cc — alpha x + beta
    times sin over ceil(D/2) columns, then cos over floor(D/2)."""
    b, t, d = x.shape
    sin_d, cos_d = (d + 1) // 2, d // 2
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
    half = max(sin_d, 1)

    def div(n):
        return torch.pow(10000.0, torch.arange(
            n, dtype=torch.float32, device=x.device) / half)

    pe = torch.cat([torch.sin(pos / div(sin_d)), torch.cos(pos / div(cos_d))],
                   dim=1)
    return alpha * x + beta * pe[None]


def hash_embedding_ids(ids, num_buckets: int, num_hash: int = 1):
    """reference: operators/hash_op.cc — ``num_hash`` hashes of each id
    into ``num_buckets``: (ids, num_hash) int32. The JAX package's uint32
    arithmetic with wraparound, bit for bit, in int64 masked to 32
    bits. Hash i adds the seed i * 0x9E3779B9 mod 2**32; from i = 2 on
    that seed leaves uint32, where the JAX package raises OverflowError
    (num_hash > 2)."""
    from .sampling import _M32, _mul32

    x = ids.long() & _M32
    outs = []
    for i in range(num_hash):
        h = (_mul32(x, 2654435761) + ((i * 0x9E3779B9) & _M32)) & _M32
        outs.append((h % num_buckets).to(torch.int32))
    return torch.stack(outs, dim=-1)


def sequence_reshape(x, lengths, new_dim: int):
    """reference: sequence_reshape_op.cc — each row's payload re-chunked
    into rows of ``new_dim`` (T * D must divide by it); lengths scale by
    D / new_dim."""
    b, t, d = x.shape
    enforce((t * d) % new_dim == 0,
            "sequence_reshape: T*D=%s not divisible by new_dim=%s", t * d,
            new_dim)
    return (x.reshape(b, t * d // new_dim, new_dim),
            torch.div(lengths * d, new_dim, rounding_mode="floor"))


def sequence_scatter(x, index, updates, lengths=None):
    """reference: sequence_scatter_op.cc — ``updates`` (B, T) added into
    x (B, D) at positions ``index`` (B, T) of each row; duplicates add
    up, steps past ``lengths`` add nothing, a position out of range is
    dropped (a negative one wraps), as ``row.at[idx].add`` does."""
    from .tensor import _scatter_rows

    b, t = index.shape
    if lengths is not None:
        mask = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
        updates = updates * mask.to(updates.dtype)
    rows = torch.arange(b, device=x.device)[:, None].expand(b, t)
    return _scatter_rows(x, (rows, index), updates, add=True)


def add_position_encoding(x, alpha: float = 1.0, beta: float = 1.0):
    """reference: operators/add_position_encoding_op.cc — alpha x + beta
    times the transformer's sin half then cos half (a zero column for an
    odd D)."""
    b, t, d = x.shape
    pos = torch.arange(t, dtype=x.dtype, device=x.device)[:, None]
    half = d // 2
    div = torch.exp(torch.arange(half, dtype=x.dtype, device=x.device)
                    * -(math.log(10000.0) / max(half - 1, 1)))
    ang = pos * div[None, :]
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if enc.shape[-1] < d:
        enc = F.pad(enc, (0, d - enc.shape[-1]))
    return alpha * x + beta * enc[None]


# ---------------------------------------------------------------------------
# chunk evaluation (sequence tagging F1)
# ---------------------------------------------------------------------------

_CHUNK_SCHEMES = {
    # (num_tag_types, tag_begin, tag_inside, tag_end, tag_single)
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _select(conds, choices, default):
    """``jnp.select``: the choice of the first true condition."""
    out = default
    for c, v in reversed(list(zip(conds, choices))):
        out = torch.where(c, v, out)
    return out


def _chunk_flags(prev_tag, prev_type, tag, typ, other, scheme):
    """ChunkBegin / ChunkEnd (reference: operators/chunk_eval_op.h:83,
    :95), their early-return chains as priority selects."""
    _, t_begin, t_inside, t_end, t_single = scheme
    f = torch.zeros_like(tag, dtype=torch.bool)
    t = torch.ones_like(tag, dtype=torch.bool)
    end = _select(
        [prev_type == other, typ == other, typ != prev_type,
         prev_tag == t_begin, prev_tag == t_inside, prev_tag == t_end,
         prev_tag == t_single],
        [f, t, t, (tag == t_begin) | (tag == t_single),
         (tag == t_begin) | (tag == t_single), t, t], f)
    begin = _select(
        [prev_type == other, typ == other, typ != prev_type,
         tag == t_begin, tag == t_inside, tag == t_end, tag == t_single],
        [typ != other, f, t, t,
         (prev_tag == t_end) | (prev_tag == t_single),
         (prev_tag == t_end) | (prev_tag == t_single), t], f)
    return begin, end


def _chunk_segments(labels, lengths, num_chunk_types, scheme):
    """GetSegments (reference: chunk_eval_op.h:41) encoded per position:
    (close (B, T+1), start (B, T+1), type (B, T+1)), close[b, i] marking
    a segment [start[b, i], i - 1] of that type. Padding and one extra
    step are the 'other' type, which closes any open chunk."""
    num_tag = scheme[0]
    other = num_chunk_types
    b, t = labels.shape
    dev = labels.device
    valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    lab = torch.where(valid, labels.long(), other * num_tag)
    lab = torch.cat([lab, torch.full((b, 1), other * num_tag,
                                     dtype=lab.dtype, device=dev)], dim=1)
    tag = lab % num_tag
    typ = torch.div(lab, num_tag, rounding_mode="floor")
    prev_tag = torch.cat([torch.full((b, 1), -1, dtype=tag.dtype,
                                     device=dev), tag[:, :-1]], dim=1)
    prev_typ = torch.cat([torch.full((b, 1), other, dtype=typ.dtype,
                                     device=dev), typ[:, :-1]], dim=1)
    begin, end = _chunk_flags(prev_tag, prev_typ, tag, typ, other, scheme)
    in_chunk = torch.zeros(b, dtype=torch.bool, device=dev)
    start = torch.zeros(b, dtype=torch.int32, device=dev)
    closes, starts = [], []
    for i in range(t + 1):
        b_i, e_i = begin[:, i], end[:, i]
        closes.append(in_chunk & e_i)
        starts.append(start)
        in_chunk = b_i | (in_chunk & ~e_i)
        start = torch.where(b_i, i, start).to(torch.int32)
    return torch.stack(closes, 1), torch.stack(starts, 1), prev_typ


def chunk_eval(inference, label, lengths, num_chunk_types: int,
               chunk_scheme: str = "IOB", excluded_chunk_types=()):
    """Chunking precision, recall and F1 (reference: operators/
    chunk_eval_op.h ChunkEvalKernel::Compute:110; IOB, IOE, IOBES and
    plain over label = type * num_tag_types + tag): (precision, recall,
    f1 float32, num_infer_chunks, num_label_chunks, num_correct_chunks
    int32), each a 0-dim tensor on the inputs' device. A chunk is matched
    by its close position, start and type."""
    enforce(chunk_scheme in _CHUNK_SCHEMES,
            "unknown chunk scheme %r (IOB/IOE/IOBES/plain)", chunk_scheme)
    scheme = _CHUNK_SCHEMES[chunk_scheme]
    inference = torch.as_tensor(inference)
    label = torch.as_tensor(label, device=inference.device)
    if inference.ndim == 1:
        inference, label = inference[None], label[None]
    lengths = torch.as_tensor(lengths, device=inference.device).reshape(
        -1).to(torch.int32)
    i_close, i_start, i_typ = _chunk_segments(inference, lengths,
                                              num_chunk_types, scheme)
    l_close, l_start, l_typ = _chunk_segments(label, lengths,
                                              num_chunk_types, scheme)

    def kept(typ):
        keep = torch.ones_like(typ, dtype=torch.bool)
        for e in excluded_chunk_types:
            keep &= typ != e
        return keep

    num_infer = torch.sum(i_close & kept(i_typ)).to(torch.int32)
    num_label = torch.sum(l_close & kept(l_typ)).to(torch.int32)
    correct = torch.sum(i_close & l_close & (i_start == l_start)
                        & (i_typ == l_typ) & kept(i_typ)).to(torch.int32)
    zero = torch.zeros((), dtype=torch.float32, device=inference.device)
    precision = torch.where(num_infer > 0, correct / torch.clamp_min(
        num_infer, 1), zero).to(torch.float32)
    recall = torch.where(num_label > 0, correct / torch.clamp_min(
        num_label, 1), zero).to(torch.float32)
    f1 = torch.where(correct > 0, 2 * precision * recall / torch.clamp_min(
        precision + recall, 1e-38), zero).to(torch.float32)
    return precision, recall, f1, num_infer, num_label, correct
