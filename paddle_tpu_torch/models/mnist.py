"""MNIST models, BASELINE config 1 (counterpart of
paddle_tpu/models/mnist.py): the MLP, which also carries the int8
inference path (``quant`` PTQ, then ``int8_swap``), the CNN (conv-pool
twice, then a Linear), ``loss_fn`` and ``eval_metrics``."""

from __future__ import annotations

from typing import Optional

import torch

from .. import nn
from ..core.places import resolve_device
from ..core.random import make_generator
from ..metrics import accuracy
from ..ops import loss as L


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


class MnistCNN(nn.Layer):
    """conv(1->20, 5) ReLU, 2x2 max pool, conv(20->50, 5) ReLU, 2x2 max
    pool, Linear(800, 10); parameters named as in the JAX package. Takes
    (N, 1, 28, 28) or flat (N, 784) images. ``device`` and ``generator``
    as for :class:`MnistMLP`."""

    def __init__(self, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = make_generator(0, device)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.conv1 = nn.Conv2D(1, 20, 5, act="relu", **kw)
        self.pool1 = nn.Pool2D(2, "max", stride=2)
        self.conv2 = nn.Conv2D(20, 50, 5, act="relu", **kw)
        self.pool2 = nn.Pool2D(2, "max", stride=2)
        self.fc = nn.Linear(50 * 4 * 4, 10, **kw)

    def forward(self, x):
        if x.ndim == 2:
            x = x.reshape(-1, 1, 28, 28)
        h = self.pool1(self.conv1(x))
        h = self.pool2(self.conv2(h))
        return self.fc(h.reshape(h.shape[0], -1))


def loss_fn(logits, label):
    """Mean softmax cross-entropy."""
    return torch.mean(L.softmax_with_cross_entropy(logits, label))


def eval_metrics(logits, label):
    return {"acc": accuracy(logits, label)}
