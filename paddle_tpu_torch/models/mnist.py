"""MNIST models (counterpart of paddle_tpu/models/mnist.py): the MLP,
which carries the int8 inference path (``quant`` PTQ, then
``int8_swap``). ``MnistCNN``, ``loss_fn`` and ``eval_metrics`` come with
the model-zoo slice (ROADMAP queue 1 item 9)."""

from __future__ import annotations

from typing import Optional

import torch

from .. import nn
from ..core.places import resolve_device
from ..core.random import make_generator


class MnistMLP(nn.Layer):
    """784-hidden1-hidden2-10 with ReLUs; parameters ``fc1``, ``fc2``,
    ``fc3``, named and laid out as in the JAX package. ``device``: the
    CUDA card when None (raises when there is none); ``generator``: the
    initial weights' stream (seed 0 on ``device`` when None)."""

    def __init__(self, hidden1: int = 128, hidden2: int = 64, *,
                 device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = make_generator(0, device)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.fc1 = nn.Linear(784, hidden1, act="relu", **kw)
        self.fc2 = nn.Linear(hidden1, hidden2, act="relu", **kw)
        self.fc3 = nn.Linear(hidden2, 10, **kw)

    def forward(self, x):
        return self.fc3(self.fc2(self.fc1(x)))
