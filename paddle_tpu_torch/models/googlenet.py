"""GoogLeNet, Inception v1 (counterpart of paddle_tpu/models/googlenet.py):
NCHW, plain conv + ReLU (no LRN, as in the JAX package), the two
auxiliary heads in training mode, from the port's layers with the JAX
package's parameter names."""

from __future__ import annotations

import torch

from .. import nn
from ..core.places import resolve_device
from ..core.random import make_generator
from ..ops import loss as L
from ..ops.nn import adaptive_pool2d


class Inception(nn.Layer):
    """One inception block: 1x1 | 1x1 -> 3x3 | 1x1 -> 5x5 | pool -> 1x1,
    concatenated on the channels."""

    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, pp, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(act="relu", device=device, generator=generator)
        self.b1 = nn.Conv2D(in_ch, c1, 1, **kw)
        self.b2 = nn.Sequential(nn.Conv2D(in_ch, c3r, 1, **kw),
                                nn.Conv2D(c3r, c3, 3, padding=1, **kw))
        self.b3 = nn.Sequential(nn.Conv2D(in_ch, c5r, 1, **kw),
                                nn.Conv2D(c5r, c5, 5, padding=2, **kw))
        self.b4_pool = nn.Pool2D(3, "max", stride=1, padding=1)
        self.b4 = nn.Conv2D(in_ch, pp, 1, **kw)

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x),
                          self.b4(self.b4_pool(x))], dim=1)


class AuxHead(nn.Layer):
    """The v1 recipe: 5x5/3 average pool (14x14 -> 4x4), 1x1 conv, two
    Linears with dropout 0.7 between."""

    def __init__(self, in_ch, num_classes, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.pool = nn.Pool2D(5, "avg", stride=3)
        self.conv = nn.Conv2D(in_ch, 128, 1, act="relu", **kw)
        self.fc1 = nn.Linear(128 * 4 * 4, 1024, act="relu", **kw)
        self.drop = nn.Dropout(0.7)
        self.fc2 = nn.Linear(1024, num_classes, **kw)

    def forward(self, x):
        x = self.conv(self.pool(x))
        x = x.reshape(x.shape[0], -1)
        return self.fc2(self.drop(self.fc1(x)))


class GoogLeNet(nn.Layer):
    """Stem, nine inception blocks, global average pool, dropout 0.4 and
    the head. In training mode with ``aux_heads`` the forward returns
    (logits, aux1, aux2), else the logits. ``device``: the CUDA card when
    None (raises when there is none); ``generator``: the initial
    weights' stream (seed 0 on ``device`` when None)."""

    def __init__(self, num_classes: int = 1000, in_ch: int = 3,
                 aux_heads: bool = True, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = make_generator(0, device)
        kw = dict(device=device, generator=generator)
        relu = dict(act="relu", **kw)
        self.stem = nn.Sequential(
            nn.Conv2D(in_ch, 64, 7, stride=2, padding=3, **relu),
            nn.Pool2D(3, "max", stride=2, padding=1),
            nn.Conv2D(64, 64, 1, **relu),
            nn.Conv2D(64, 192, 3, padding=1, **relu),
            nn.Pool2D(3, "max", stride=2, padding=1),
        )
        self.i3a = Inception(192, 64, 96, 128, 16, 32, 32, **kw)     # 256
        self.i3b = Inception(256, 128, 128, 192, 32, 96, 64, **kw)   # 480
        self.pool3 = nn.Pool2D(3, "max", stride=2, padding=1)
        self.i4a = Inception(480, 192, 96, 208, 16, 48, 64, **kw)    # 512
        self.i4b = Inception(512, 160, 112, 224, 24, 64, 64, **kw)   # 512
        self.i4c = Inception(512, 128, 128, 256, 24, 64, 64, **kw)   # 512
        self.i4d = Inception(512, 112, 144, 288, 32, 64, 64, **kw)   # 528
        self.i4e = Inception(528, 256, 160, 320, 32, 128, 128, **kw)  # 832
        self.pool4 = nn.Pool2D(3, "max", stride=2, padding=1)
        self.i5a = Inception(832, 256, 160, 320, 32, 128, 128, **kw)  # 832
        self.i5b = Inception(832, 384, 192, 384, 48, 128, 128, **kw)  # 1024
        self.drop = nn.Dropout(0.4)
        self.head = nn.Linear(1024, num_classes, **kw)
        self.aux_heads = aux_heads
        if aux_heads:
            self.aux1 = AuxHead(512, num_classes, **kw)
            self.aux2 = AuxHead(528, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4a(x)
        aux = self.aux_heads and self.training
        a1 = self.aux1(x) if aux else None
        x = self.i4d(self.i4c(self.i4b(x)))
        a2 = self.aux2(x) if aux else None
        x = self.pool4(self.i4e(x))
        x = self.i5b(self.i5a(x))
        x = adaptive_pool2d(x, 1, "avg").reshape(x.shape[0], -1)
        logits = self.head(self.drop(x))
        if a1 is not None:
            return logits, a1, a2
        return logits


def googlenet(num_classes: int = 1000, **kw) -> GoogLeNet:
    return GoogLeNet(num_classes, **kw)


def loss_fn(outputs, labels, aux_weight: float = 0.3):
    """Main CE plus ``aux_weight`` x each aux head's CE (the v1 training
    recipe) for a training forward's tuple; the main CE otherwise."""
    if isinstance(outputs, tuple):
        main, a1, a2 = outputs
        loss = torch.mean(L.softmax_with_cross_entropy(main, labels))
        for aux in (a1, a2):
            loss = loss + aux_weight * torch.mean(
                L.softmax_with_cross_entropy(aux, labels))
        return loss
    return torch.mean(L.softmax_with_cross_entropy(outputs, labels))
