"""Decoding filters and draws (counterpart of the LM-decoding half of
paddle_tpu/ops/sampling.py).

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

from typing import Optional

import torch

from ..core.enforce import enforce


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
