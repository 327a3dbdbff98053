"""Explicit random streams (counterpart of paddle_tpu/core/random.py).

The JAX package splits keys off a global seed; the port hands an
explicit ``torch.Generator`` to every initialiser and sampler instead,
and a scope (:func:`rng_scope`) makes one current for the layers that
draw during a forward (dropout). The two frameworks draw different
numbers from the same seed: only distributions match.

Keys are the JAX package's: threefry key data (uint32[2]).
:func:`split_key` is ``jax.random.split`` and :func:`fold_in`
``jax.random.fold_in``, bit for bit. The global stream (:func:`seed`,
:func:`next_key`, :func:`key_for`) is the JAX package's too: after
``seed(s)`` the port draws the keys the JAX package draws, in the same
order, so a model built the same way in both leaves the stream at the
same key, and a fresh Trainer takes the JAX Trainer's start key. The
trainer splits its key once a step as the JAX Trainer does, so the key
moves between the packages in a checkpoint; :func:`seed_generator`
makes a step's generator from it."""

from __future__ import annotations

import contextlib
import threading
import zlib
from typing import List, Optional

import numpy as np
import torch

from .places import DeviceLike, resolve_device


def make_generator(seed: int = 0,
                   device: DeviceLike = None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (the card by default) seeded
    with ``seed``."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen


# the generators opened by rng_scope, innermost last (the counterpart of
# the JAX package's functional-call key stack, nn/layer.py _RNG_STACK)
_SCOPES: List[Optional[torch.Generator]] = []


@contextlib.contextmanager
def rng_scope(generator: Optional[torch.Generator]):
    """Make ``generator`` the current random stream inside the block:
    training-mode ``Dropout`` and attention dropout draw their masks from
    it (the counterpart of ``Layer.rng``, which folds keys off the
    functional call's key). ``Trainer.train_step`` opens it around the
    loss builder with the trainer's generator. ``None`` opens a scope
    with no stream (as ``eval_step`` runs)."""
    _SCOPES.append(generator)
    try:
        yield generator
    finally:
        _SCOPES.pop()


def current_generator() -> Optional[torch.Generator]:
    """The generator of the innermost :func:`rng_scope`, or None."""
    return _SCOPES[-1] if _SCOPES else None


# --- the trainer's key (the JAX package's threefry key data) ---------------

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def make_key(seed: int = 0) -> np.ndarray:
    """The key data of ``jax.random.key(seed)`` for the default threefry
    key as the JAX package makes it (64-bit mode off): uint32[2], a zero
    high word and the seed's low 32 bits."""
    return np.array([0, int(seed) & _MASK], np.uint32)


def _threefry2x32(k1: int, k2: int, x0: int, x1: int):
    """Threefry-2x32 (20 rounds) of the counter pair (x0, x1) under the
    key (k1, k2), in Python ints mod 2^32: the block function of the JAX
    package's default key."""
    def rotl(v, r):
        return ((v << r) | (v >> (32 - r))) & _MASK

    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x0 + ks[0]) & _MASK, (x1 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def split_key(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` on key data (uint32[2] ->
    uint32[num, 2]), bit for bit, with the partitionable threefry the
    JAX package runs: key i is the block function of the counter i."""
    k1, k2 = (int(v) for v in np.asarray(key, np.uint32).reshape(2))
    return np.array([_threefry2x32(k1, k2, i >> 32, i & _MASK)
                     for i in range(num)], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` on key data, bit for bit: the
    block function of the counter pair (0, data) under the key."""
    k1, k2 = (int(v) for v in np.asarray(key, np.uint32).reshape(2))
    return np.array(_threefry2x32(k1, k2, 0, int(data) & _MASK), np.uint32)


# --- the global stream (the JAX package's core/random.py) -----------------

_lock = threading.Lock()
_seed: int = 0
_key: Optional[np.ndarray] = None


def seed(s: int) -> None:
    """Set the global seed and restart the stream from ``make_key(s)``
    (fluid's Program.random_seed analog)."""
    global _seed, _key
    with _lock:
        _seed = int(s)
        _key = make_key(_seed)


def get_seed() -> int:
    return _seed


def next_key(n: int = 1):
    """Split fresh key(s) off the global stream, as the JAX package's
    ``next_key`` does: one key for ``n == 1``, else a list of ``n``."""
    global _key
    with _lock:
        if _key is None:
            _key = make_key(_seed)
        keys = split_key(_key, n + 1)
        _key, subs = keys[0], list(keys[1:])
    return subs[0] if n == 1 else subs


def key_for(name: str, base_key=None) -> np.ndarray:
    """A key derived from ``name`` (its crc32, so every process derives
    the same one) folded into ``base_key`` (the seed's key when None)."""
    k = base_key if base_key is not None else make_key(_seed)
    return fold_in(k, zlib.crc32(name.encode()) & 0x7FFFFFFF)


def seed_generator(generator: torch.Generator, key) -> torch.Generator:
    """Seed ``generator`` from key data, deterministically: its 64-bit
    seed is the key's two words. ``Trainer.train_step`` seeds its step's
    generator so from a key it splits once a step, as the JAX Trainer
    splits its key; a run resumed with the key in its checkpoint draws
    the same dropout masks (layer and in-kernel attention dropout) as an
    uninterrupted one. The two frameworks draw different numbers from
    the same key."""
    k = np.asarray(key, np.uint32).reshape(2)
    generator.manual_seed((int(k[0]) << 32) | int(k[1]))
    return generator
