"""VGG (counterpart of paddle_tpu/models/vgg.py): the batch-norm variant
of the reference's zoo entry, NCHW, built from the port's Conv2D,
BatchNorm, Pool2D, Linear and Dropout with the JAX package's parameter
and buffer names."""

from __future__ import annotations

import torch

from .. import nn
from ..core.places import resolve_device
from ..core.random import make_generator
from ..ops import loss as L

_CFGS = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}
_WIDTHS = (64, 128, 256, 512, 512)


class VGG(nn.Layer):
    """Five stages of 3x3 conv-BN-ReLU and a 2x2 max pool, then three
    Linears (4096, 4096, classes) with dropout between. ``image_size``
    fixes the classifier's input (image_size // 32 squared per channel).
    ``device``: the CUDA card when None (raises when there is none);
    ``generator``: the initial weights' stream (seed 0 on ``device``
    when None)."""

    def __init__(self, depth: int = 16, num_classes: int = 1000,
                 in_ch: int = 3, image_size: int = 224,
                 dropout: float = 0.5, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = make_generator(0, device)
        kw = dict(device=device, generator=generator)
        feats = []
        cur = in_ch
        for width, n in zip(_WIDTHS, _CFGS[depth]):
            for _ in range(n):
                feats.append(nn.Conv2D(cur, width, 3, padding=1,
                                       bias_attr=False, **kw))
                feats.append(nn.BatchNorm(width, act="relu", **kw))
                cur = width
            feats.append(nn.Pool2D(2, "max", stride=2))
        self.features = nn.Sequential(*feats)
        spatial = image_size // 32
        self.classifier = nn.Sequential(
            nn.Flatten(),
            nn.Linear(cur * spatial * spatial, 4096, act="relu", **kw),
            nn.Dropout(dropout),
            nn.Linear(4096, 4096, act="relu", **kw),
            nn.Dropout(dropout),
            nn.Linear(4096, num_classes, **kw),
        )

    def forward(self, x):
        return self.classifier(self.features(x))


def vgg16(num_classes: int = 1000, **kw) -> VGG:
    return VGG(16, num_classes, **kw)


def loss_fn(logits, labels):
    """Mean softmax cross-entropy."""
    return torch.mean(L.softmax_with_cross_entropy(logits, labels))
