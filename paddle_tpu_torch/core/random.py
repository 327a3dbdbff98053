"""Explicit random streams (counterpart of paddle_tpu/core/random.py).

The JAX package splits keys off a global seed; the port hands an
explicit ``torch.Generator`` to every initialiser and sampler instead,
and a scope (:func:`rng_scope`) makes one current for the layers that
draw during a forward (dropout). The two frameworks draw different
numbers from the same seed: only distributions match."""

from __future__ import annotations

import contextlib
from typing import List, Optional

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
