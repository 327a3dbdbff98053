"""Sampling ops (counterpart of paddle_tpu/ops/sampling.py): the
large-vocabulary training losses (NCE, hierarchical sigmoid), their
class samplers, ``sample_logits`` and ``sampling_id``, then the
decoding filters and draws.

A sampler takes the JAX package's threefry key (key data, ``uint32[2]``)
and draws from a ``torch.Generator`` seeded from it
(``core.random.seed_generator``): the same key gives the same draw in
the port, and a draw distributed as the JAX package's, not its numbers.
``nce_loss(custom_neg=)`` takes the negatives from the caller, which
makes it exact.

The filters (temperature, top-k, top-p) are exact ports. The draw takes
an explicit ``torch.Generator`` where the JAX package takes a PRNG key:
the two give different numbers, so only the filtered support and the
distribution carry over (ROADMAP queue 3).

The serving arena keys each draw instead, as the JAX arena folds its key
by (admission counter, position): :func:`keyed_bits` is a counter-based
hash of (seed, generation, position, salt, column), computed on the
device in int64 with every product taken mod 2**32, so a draw depends on
where it is made and not on the order of the calls. :func:`keyed_sample`
is a Gumbel-max categorical draw over those bits, :func:`keyed_uniform`
their uniforms in (0, 1)."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.enforce import enforce
from ..core.places import resolve_device
from ..core.random import seed_generator

# ----- samplers and the sampled losses -------------------------------------


def _log_uniform_sample(gen, shape, range_max: int):
    """Zipfian ids, P(k) proportional to log((k+2)/(k+1)) over [0,
    range_max): the inverse CDF exp(u log(range_max + 1)) - 1, truncated
    toward zero, then clipped."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    k = torch.exp(u * math.log(float(range_max + 1))) - 1.0
    return torch.clamp(k.to(torch.int32), 0, range_max - 1)


def _log_uniform_prob(ids, range_max: int):
    idsf = ids.to(torch.float32)
    return (torch.log((idsf + 2.0) / (idsf + 1.0))
            / math.log(float(range_max + 1)))


def _uniform_prob(ids, range_max: int):
    return torch.full(ids.shape, 1.0 / range_max, dtype=torch.float32,
                      device=ids.device)


def _uniform_sample(gen, shape, range_max: int):
    return torch.randint(0, range_max, shape, generator=gen,
                         device=gen.device, dtype=torch.int32)


_SAMPLERS = {
    "uniform": (_uniform_sample, _uniform_prob),
    "log_uniform": (_log_uniform_sample, _log_uniform_prob),
}


def _prob_fn(sampler: str):
    enforce(sampler in _SAMPLERS, "unknown sampler %s", sampler)
    return _SAMPLERS[sampler][1]


def sample_classes(key, shape, num_classes: int, sampler: str = "uniform",
                   *, device=None):
    """(ids int32, their proposal probabilities float32) of ``shape``,
    drawn from ``key`` on ``device`` (the CUDA card when None)."""
    enforce(sampler in _SAMPLERS, "unknown sampler %s", sampler)
    draw, prob = _SAMPLERS[sampler]
    gen = seed_generator(torch.Generator(device=resolve_device(device)),
                         key)
    ids = draw(gen, tuple(shape), num_classes)
    return ids, prob(ids, num_classes)


def nce_loss(x, label, weight, bias=None, num_neg_samples: int = 10,
             sampler: str = "uniform", key=None, custom_neg=None):
    """Noise-contrastive estimation (reference: operators/nce_op.cc):
    x (B, D), label (B,), weight (num_classes, D), bias (num_classes,);
    the cost (B,). A class's logit is ``x . w_c + b_c - log(S P(c))``,
    the true class scored against S negatives as binary classification.
    The negatives are ``custom_neg`` (B, S) when given, else S =
    ``num_neg_samples`` draws from ``key``."""
    num_classes = weight.shape[0]
    b = x.shape[0]
    label = label.reshape(b).long()
    if custom_neg is not None:
        neg = torch.as_tensor(custom_neg, device=x.device)
        enforce(neg.ndim == 2 and neg.shape[0] == b,
                "custom_neg must be (B, S), got %s", tuple(neg.shape))
        neg_p = _prob_fn(sampler)(neg, num_classes)
    else:
        enforce(key is not None, "nce_loss requires a PRNG key")
        neg, neg_p = sample_classes(key, (b, num_neg_samples), num_classes,
                                    sampler, device=x.device)
    neg = neg.long()
    s = neg.shape[1]

    def logit(ids):  # (B, K) -> (B, K)
        out = torch.einsum("bd,bkd->bk", x, weight[ids])
        if bias is not None:
            out = out + bias[ids]
        return out

    pos_prob = _prob_fn(sampler)(label, num_classes)
    pos_logit = logit(label[:, None])[:, 0] - torch.log(s * pos_prob)
    neg_logit = logit(neg) - torch.log(s * neg_p)
    # -log sigmoid(pos) - sum log(1 - sigmoid(neg)), numerically stable
    return (F.softplus(-pos_logit)
            + torch.sum(F.softplus(neg_logit), dim=1))


def _default_tree_codes(num_classes: int, device=None):
    """The complete binary tree of hsigmoid's default mode (reference:
    operators/math/matrix_bit_code.h SimpleCode: a leaf's node is label +
    num_classes, walked to the root; the bit is node & 1): (path_table,
    path_code), each (C, L) int32 padded with -1, L =
    ceil(log2(num_classes))."""
    depth = max(int(np.ceil(np.log2(max(num_classes, 2)))), 1)
    table = -np.ones((num_classes, depth), np.int32)
    code = -np.ones((num_classes, depth), np.int32)
    for c in range(num_classes):
        node = c + num_classes
        i = 0
        while node > 1:
            # inner nodes are 1..num_classes-1; their row is node/2 - 1
            table[c, i] = node // 2 - 1
            code[c, i] = node & 1
            node //= 2
            i += 1
    return (torch.as_tensor(table, device=device),
            torch.as_tensor(code, device=device))


def hsigmoid_loss(x, label, weight, bias=None, num_classes: int = None,
                  path_table=None, path_code=None):
    """Hierarchical sigmoid (reference:
    operators/hierarchical_sigmoid_op.cc): x (B, D), label (B,), weight
    (num_nodes, D), one row per inner node, bias (num_nodes,); the cost
    (B,). The default tree is the complete binary tree over
    ``num_classes``; a custom one is ``path_table``/``path_code`` (C, L),
    padded with -1."""
    b = x.shape[0]
    label = label.reshape(b).long()
    if path_table is None:
        enforce(num_classes is not None,
                "hsigmoid needs num_classes or explicit paths")
        path_table, path_code = _default_tree_codes(num_classes, x.device)
    else:
        enforce(path_code is not None,
                "hsigmoid: path_code is required alongside path_table")
    path_table = torch.as_tensor(path_table, device=x.device)
    path_code = torch.as_tensor(path_code, device=x.device)
    rows = path_table[label].long()            # (B, L) node ids, -1 pads
    codes = path_code[label]
    valid = rows >= 0
    safe = torch.clamp_min(rows, 0)
    logits = torch.einsum("bd,bld->bl", x, weight[safe])
    if bias is not None:
        logits = logits + bias[safe]
    # bit 1 -> sigmoid(logit), bit 0 -> 1 - sigmoid(logit)
    cost = F.softplus(logits) - codes.to(logits.dtype) * logits
    return torch.sum(torch.where(valid, cost, torch.zeros_like(cost)), dim=1)


def sampling_id(probs, key, min: float = 0.0,  # noqa: A002
                max: float = 1.0):  # noqa: A002 - the reference's names
    """One class id per row of ``probs`` (B, C), rows not necessarily
    normalised (reference: operators/sampling_id_op.cc): u ~ U(min, max)
    times the row's total, walked along the CDF; drawn from ``key`` on
    the probabilities' device."""
    cdf = torch.cumsum(probs, dim=-1)
    total = cdf[:, -1:]
    gen = seed_generator(torch.Generator(device=probs.device), key)
    u = torch.rand((probs.shape[0], 1), generator=gen, device=probs.device,
                   dtype=probs.dtype) * (max - min) + min
    ids = torch.sum((cdf < u * total).to(torch.int32), dim=-1)
    return torch.clamp_max(ids, probs.shape[-1] - 1)


def sample_logits(logits, label, num_samples: int, key,
                  sampler: str = "log_uniform",
                  remove_accidental_hits: bool = True):
    """Negatives drawn from ``key`` and their logits corrected by -log Q
    (reference: operators/sample_logits_op.cc): (sampled logits (B,
    1+S), sampled labels (B,) all 0 — the true class is column 0 — and
    the ids (B, 1+S)). ``remove_accidental_hits`` pushes a negative equal
    to the true class to -1e20."""
    b, v = logits.shape
    label = label.reshape(b).to(torch.int32)
    neg, neg_p = sample_classes(key, (b, num_samples), v, sampler,
                                device=logits.device)
    ids = torch.cat([label[:, None], neg], dim=1)
    q = torch.cat([_prob_fn(sampler)(label, v)[:, None], neg_p], dim=1)
    picked = torch.gather(logits, 1, ids.long()) - torch.log(q)
    if remove_accidental_hits:
        hit = ids == label[:, None]
        hit[:, 0] = False
        picked = torch.where(hit, torch.full((), -1e20, dtype=picked.dtype,
                                             device=picked.device), picked)
    return picked, torch.zeros((b,), dtype=torch.int32,
                               device=logits.device), ids


# ----- decoding filters ----------------------------------------------------


def top_k_logits(logits, k: int):
    """Keep the k largest entries per row; push the rest to -inf.
    ``k <= 0`` is a no-op. Ties at the k-th value all survive (the filter
    is by value threshold, not by rank)."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, float("-inf"), logits)


def top_p_logits(logits, p: float):
    """Nucleus filter: keep the smallest set of entries whose probability
    mass reaches ``p`` (the top entry always survives); push the rest to
    -inf. ``p >= 1`` is a no-op."""
    if p >= 1.0:
        return logits
    enforce(p > 0.0, "top_p must be in (0, 1], got %s (p <= 0 would "
            "filter every token)", p)
    srt = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(srt.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # an entry is kept while the mass BEFORE it is still < p
    keep = (cum - probs) < p
    thresh = torch.where(keep, srt, float("inf")).amin(
        dim=-1, keepdim=True).to(logits.dtype)
    return torch.where(logits < thresh, float("-inf"), logits)


def filter_logits(logits, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0):
    """Temperature scaling, then top-k, then top-p, in float32. softmax
    of the result is the exact distribution :func:`sample_from_logits`
    draws from. ``temperature`` must be > 0."""
    enforce(temperature > 0.0, "temperature must be > 0, got %s",
            temperature)
    scaled = logits.float() / float(temperature)
    scaled = top_k_logits(scaled, top_k)
    return top_p_logits(scaled, top_p)


def sample_from_logits(logits, generator: Optional[torch.Generator],
                       temperature: float = 1.0, top_k: int = 0,
                       top_p: float = 1.0):
    """One token id per row of (B, V) ``logits``: filter, then a
    categorical draw from ``generator``. ``temperature == 0`` is exact
    argmax (no draw)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


# ----- keyed draws ---------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """x * c mod 2**32 for int64 ``x`` in [0, 2**32): two 16-bit halves of
    the constant, so no int64 product overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix(x):
    """MurmurHash3's 32-bit finalizer on int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keyed_bits(seed: int, gens, poss, salt: int, n: int):
    """(B, n) int64 hash values in [0, 2**32) of (``seed``, ``gens[b]``,
    ``poss[b]``, ``salt``, column j): ``gens``/``poss`` are (B,) integer
    tensors on the device the bits are made on."""
    x = _fmix((gens.long() & _M32) ^ (seed & _M32))
    x = _fmix(((x + _mul32(poss.long() & _M32, 0x9E3779B9)) & _M32)
              ^ ((seed >> 32) & _M32))
    x = _fmix((x + ((salt * 0x632BE5AB) & _M32)) & _M32)
    cols = torch.arange(n, dtype=torch.int64, device=x.device)
    return _fmix((x[:, None] + _mul32(cols, 0x27D4EB2F)[None, :]) & _M32)


def keyed_uniform(seed: int, gens, poss, salt: int, n: int):
    """(B, n) float32 uniforms in (0, 1) from :func:`keyed_bits`: the top
    24 bits, centred in their interval, so neither 0 nor 1 occurs."""
    bits = keyed_bits(seed, gens, poss, salt, n) >> 8
    return (bits.to(torch.float32) + 0.5) * (1.0 / 16777216.0)


def keyed_categorical(logits, seed: int, gens, poss, salt: int):
    """One draw per row of (B, V) unnormalised log-probabilities
    (``-inf`` = excluded): the Gumbel-max construction over keyed
    uniforms, the construction ``jax.random.categorical`` uses."""
    u = keyed_uniform(seed, gens, poss, salt, logits.shape[-1])
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)


def keyed_sample(logits, seed: int, gens, poss, salt: int = 0,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0):
    """:func:`sample_from_logits` with a keyed draw: filter, then one
    :func:`keyed_categorical` draw per row. ``temperature == 0`` is exact
    argmax (no draw)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    return keyed_categorical(filter_logits(logits, temperature, top_k,
                                           top_p), seed, gens, poss, salt)


def generator_seed(generator: torch.Generator) -> int:
    """A 62-bit seed for the keyed draws, drawn once from ``generator``
    (on its own device; one host read)."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())
