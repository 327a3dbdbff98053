"""AlexNet (counterpart of paddle_tpu/models/alexnet.py), NCHW, from the
port's Conv2D, Pool2D, Linear and Dropout with the JAX package's
parameter names."""

from __future__ import annotations

import torch

from .. import nn
from ..core.places import resolve_device
from ..core.random import make_generator
from ..ops import loss as L


class AlexNet(nn.Layer):
    """Five convs (11x11/4, 5x5, three 3x3) with three 3x3/2 max pools,
    then dropout and three Linears. ``device``: the CUDA card when None
    (raises when there is none); ``generator``: the initial weights'
    stream (seed 0 on ``device`` when None)."""

    def __init__(self, num_classes: int = 1000, in_ch: int = 3,
                 dropout: float = 0.5, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = make_generator(0, device)
        kw = dict(device=device, generator=generator)
        self.features = nn.Sequential(
            nn.Conv2D(in_ch, 64, 11, stride=4, padding=2, act="relu", **kw),
            nn.Pool2D(3, "max", stride=2),
            nn.Conv2D(64, 192, 5, padding=2, act="relu", **kw),
            nn.Pool2D(3, "max", stride=2),
            nn.Conv2D(192, 384, 3, padding=1, act="relu", **kw),
            nn.Conv2D(384, 256, 3, padding=1, act="relu", **kw),
            nn.Conv2D(256, 256, 3, padding=1, act="relu", **kw),
            nn.Pool2D(3, "max", stride=2),
        )
        self.classifier = nn.Sequential(
            nn.Flatten(),
            nn.Dropout(dropout),
            nn.Linear(256 * 6 * 6, 4096, act="relu", **kw),
            nn.Dropout(dropout),
            nn.Linear(4096, 4096, act="relu", **kw),
            nn.Linear(4096, num_classes, **kw),
        )

    def forward(self, x):
        return self.classifier(self.features(x))


def alexnet(num_classes: int = 1000, **kw) -> AlexNet:
    return AlexNet(num_classes, **kw)


def loss_fn(logits, labels):
    """Mean softmax cross-entropy."""
    return torch.mean(L.softmax_with_cross_entropy(logits, labels))
