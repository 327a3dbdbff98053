"""SE-ResNeXt (counterpart of paddle_tpu/models/se_resnext.py): the
grouped-conv bottleneck (cardinality 32) with squeeze-and-excitation
gating, on models/resnet.py's conv-BN unit, with the JAX package's
parameter and buffer names.

Inputs are NCHW at the API in both layouts; ``data_format="NHWC"`` (the
bench's default) transposes once at the stem into contiguous NHWC
memory, as models/resnet.py does."""

from __future__ import annotations

import torch

from .. import nn
from ..core.places import resolve_device
from ..core.random import make_generator
from ..ops import loss as L
from .resnet import _conv_bn


class SEBlock(nn.Layer):
    """Squeeze-excitation: global average pool, a bottleneck MLP (ReLU,
    then sigmoid), and the channels scaled by its output."""

    def __init__(self, ch: int, reduction: int = 16,
                 data_format: str = "NCHW", *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        hidden = max(ch // reduction, 4)
        self.fc1 = nn.Linear(ch, hidden, act="relu", **kw)
        self.fc2 = nn.Linear(hidden, ch, act="sigmoid", **kw)
        self.data_format = data_format

    def forward(self, x):
        nchw = self.data_format == "NCHW"
        s = self.fc2(self.fc1(torch.mean(x, dim=(2, 3) if nchw
                                         else (1, 2))))
        return x * (s[:, :, None, None] if nchw else s[:, None, None, :])


class SEBottleneck(nn.Layer):
    """1x1 conv-BN to 2 x ``ch``, a grouped 3x3 (the stride), 1x1 to 4 x
    ``ch`` without ReLU, SE gating, plus the shortcut, then ReLU."""

    expansion = 2

    def __init__(self, in_ch: int, ch: int, stride: int = 1,
                 cardinality: int = 32, reduction: int = 16,
                 data_format: str = "NCHW", *, device=None, generator=None,
                 **_):
        super().__init__()
        width = ch * 2
        out_ch = ch * self.expansion * 2
        kw = dict(data_format=data_format, device=device,
                  generator=generator)
        self.conv1 = _conv_bn(in_ch, width, 1, **kw)
        self.conv2 = _conv_bn(width, width, 3, stride=stride,
                              groups=cardinality, **kw)
        self.conv3 = _conv_bn(width, out_ch, 1, act=None, **kw)
        self.se = SEBlock(out_ch, reduction, **kw)
        self.short = (None if in_ch == out_ch and stride == 1
                      else _conv_bn(in_ch, out_ch, 1, stride=stride,
                                    act=None, **kw))

    def forward(self, x):
        y = self.se(self.conv3(self.conv2(self.conv1(x))))
        s = x if self.short is None else self.short(x)
        return torch.relu(y + s)


class SEResNeXt(nn.Layer):
    """Stem (7x7/2 conv-BN, 3x3/2 max pool), four stages of
    SEBottleneck, a global average pool and a Linear head. ``device``:
    the CUDA card when None (raises when there is none); ``generator``:
    the initial weights' stream (seed 0 on ``device`` when None)."""

    def __init__(self, depths=(3, 4, 6, 3), num_classes: int = 1000,
                 in_ch: int = 3, cardinality: int = 32,
                 data_format: str = "NCHW", *, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = make_generator(0, device)
        kw = dict(data_format=data_format, device=device,
                  generator=generator)
        self.data_format = data_format
        self.stem = _conv_bn(in_ch, 64, 7, stride=2, **kw)
        self.maxpool = nn.Pool2D(3, "max", stride=2, padding=1,
                                 data_format=data_format)
        blocks = []
        cur = 64
        for stage, (w, n) in enumerate(zip([64, 128, 256, 512], depths)):
            for i in range(n):
                stride = 2 if (i == 0 and stage > 0) else 1
                blocks.append(SEBottleneck(cur, w, stride=stride,
                                           cardinality=cardinality, **kw))
                cur = w * SEBottleneck.expansion * 2
        self.blocks = nn.LayerList(blocks)
        self.head = nn.Linear(cur, num_classes, device=device,
                              generator=generator)

    def forward(self, x):
        if self.data_format == "NHWC":
            # NCHW inputs, NHWC memory from here on
            x = x.permute(0, 2, 3, 1).contiguous()
        x = self.maxpool(self.stem(x))
        for blk in self.blocks:
            x = blk(x)
        spatial = (2, 3) if self.data_format == "NCHW" else (1, 2)
        return self.head(torch.mean(x, dim=spatial))


def se_resnext50(num_classes: int = 1000, **kw) -> SEResNeXt:
    return SEResNeXt((3, 4, 6, 3), num_classes, **kw)


def loss_fn(logits, labels):
    """Mean softmax cross-entropy."""
    return torch.mean(L.softmax_with_cross_entropy(logits, labels))
