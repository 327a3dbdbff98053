"""Explicit random streams (counterpart of paddle_tpu/core/random.py).

The JAX package splits keys off a global seed; the port hands an
explicit ``torch.Generator`` to every initialiser and sampler instead,
so no module-level random state exists. The two frameworks draw
different numbers from the same seed: only distributions match."""

from __future__ import annotations

import torch

from .places import DeviceLike, resolve_device


def make_generator(seed: int = 0,
                   device: DeviceLike = None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (the card by default) seeded
    with ``seed``."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen
