"""ResNet family, BASELINE config 2 (counterpart of
paddle_tpu/models/resnet.py): resnet50/101/152 (ImageNet, bottleneck
blocks) and resnet20/32 (CIFAR, basic blocks), built from the port's
Conv2D and BatchNorm with the JAX package's parameter and buffer names.

Inputs are NCHW at the API in both layouts. ``data_format="NHWC"``
transposes the input once at the stem, into contiguous NHWC memory, and
every conv, BatchNorm and pool after it runs channels-last (cuDNN's NHWC
kernels, the layout the JAX bench trains in)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import nn
from ..core.places import resolve_device
from ..core.random import make_generator
from ..ops import loss as L


def _conv_bn(in_ch: int, out_ch: int, k: int, stride: int = 1,
             groups: int = 1, act: Optional[str] = "relu",
             data_format: str = "NCHW", *, device=None,
             generator=None) -> nn.Layer:
    """Conv2D (no bias, padding (k - 1) // 2) then BatchNorm(act)."""
    return nn.Sequential(
        nn.Conv2D(in_ch, out_ch, k, stride=stride, padding=(k - 1) // 2,
                  groups=groups, bias_attr=False, data_format=data_format,
                  device=device, generator=generator),
        nn.BatchNorm(out_ch, act=act, data_layout=data_format,
                     device=device, generator=generator),
    )


class BottleneckBlock(nn.Layer):
    """1x1, 3x3 (the stride), 1x1 to 4 x ``ch``, plus the shortcut."""

    expansion = 4

    def __init__(self, in_ch: int, ch: int, stride: int = 1,
                 groups: int = 1, base_width: int = 64,
                 data_format: str = "NCHW", *, device=None,
                 generator=None):
        super().__init__()
        width = int(ch * (base_width / 64.0)) * groups
        out_ch = ch * self.expansion
        kw = dict(data_format=data_format, device=device,
                  generator=generator)
        self.conv1 = _conv_bn(in_ch, width, 1, **kw)
        self.conv2 = _conv_bn(width, width, 3, stride=stride, groups=groups,
                              **kw)
        self.conv3 = _conv_bn(width, out_ch, 1, act=None, **kw)
        self.short = (None if in_ch == out_ch and stride == 1
                      else _conv_bn(in_ch, out_ch, 1, stride=stride,
                                    act=None, **kw))

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        s = x if self.short is None else self.short(x)
        return torch.relu(y + s)


class BasicBlock(nn.Layer):
    """Two 3x3 convs (the first takes the stride), plus the shortcut."""

    expansion = 1

    def __init__(self, in_ch: int, ch: int, stride: int = 1,
                 data_format: str = "NCHW", *, device=None, generator=None,
                 **_):
        super().__init__()
        kw = dict(data_format=data_format, device=device,
                  generator=generator)
        self.conv1 = _conv_bn(in_ch, ch, 3, stride=stride, **kw)
        self.conv2 = _conv_bn(ch, ch, 3, act=None, **kw)
        self.short = (None if in_ch == ch and stride == 1
                      else _conv_bn(in_ch, ch, 1, stride=stride, act=None,
                                    **kw))

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        s = x if self.short is None else self.short(x)
        return torch.relu(y + s)


class ResNet(nn.Layer):
    """Stem (7x7/2 conv-BN and a 3x3/2 max pool; CIFAR: one 3x3 conv-BN),
    the stages of ``block``, a global average pool and a Linear head.
    ``device``: the CUDA card when None (raises when there is none);
    ``generator``: the initial weights' stream (seed 0 on ``device`` when
    None)."""

    def __init__(self, block, depths: Sequence[int], num_classes: int = 1000,
                 in_ch: int = 3, cifar: bool = False, groups: int = 1,
                 base_width: int = 64, data_format: str = "NCHW", *,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = make_generator(0, device)
        self.cifar = cifar
        self.data_format = data_format
        kw = dict(data_format=data_format, device=device,
                  generator=generator)
        ch = 16 if cifar else 64
        if cifar:
            self.stem = _conv_bn(in_ch, ch, 3, **kw)
            widths = [16, 32, 64]
        else:
            self.stem = _conv_bn(in_ch, ch, 7, stride=2, **kw)
            self.maxpool = nn.Pool2D(3, "max", stride=2, padding=1,
                                     data_format=data_format)
            widths = [64, 128, 256, 512]
        blocks = []
        cur = ch
        for stage, (w, n) in enumerate(zip(widths, depths)):
            for i in range(n):
                stride = 2 if (i == 0 and stage > 0) else 1
                blocks.append(block(cur, w, stride=stride, groups=groups,
                                    base_width=base_width, **kw))
                cur = w * block.expansion
        self.blocks = nn.LayerList(blocks)
        self.head = nn.Linear(cur, num_classes, device=device,
                              generator=generator)

    def forward(self, x):
        if self.data_format == "NHWC":
            # NCHW inputs, NHWC memory from here on
            x = x.permute(0, 2, 3, 1).contiguous()
        x = self.stem(x)
        if not self.cifar:
            x = self.maxpool(x)
        for blk in self.blocks:
            x = blk(x)
        pool_axes = (2, 3) if self.data_format == "NCHW" else (1, 2)
        x = torch.mean(x, dim=pool_axes)       # global average pool
        return self.head(x)


def resnet50(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet(BottleneckBlock, [3, 4, 6, 3], num_classes, **kw)


def resnet101(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet(BottleneckBlock, [3, 4, 23, 3], num_classes, **kw)


def resnet152(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet(BottleneckBlock, [3, 8, 36, 3], num_classes, **kw)


def resnet20_cifar(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(BasicBlock, [3, 3, 3], num_classes, cifar=True, **kw)


def resnet32_cifar(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(BasicBlock, [5, 5, 5], num_classes, cifar=True, **kw)


def loss_fn(logits, labels):
    """Mean softmax cross-entropy."""
    return torch.mean(L.softmax_with_cross_entropy(logits, labels))
