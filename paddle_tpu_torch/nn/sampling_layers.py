"""NCE and hierarchical-sigmoid layers (counterpart of
paddle_tpu/nn/sampling_layers.py; reference: dygraph/nn.py NCE and
HSigmoid) over ops/sampling.py."""

from __future__ import annotations

import torch

from .. import initializer as I
from ..core.places import resolve_device
from ..ops import sampling as SP
from .layer import Layer


class NCE(Layer):
    """Noise-contrastive estimation head: weight (num_total_classes,
    dim) from XavierUniform, bias zeros. ``forward(x, label,
    custom_neg=None)`` -> the cost (B,); without ``custom_neg`` the
    negatives are drawn from ``self.rng("nce")``, as in the JAX
    package."""

    def __init__(self, dim: int, num_total_classes: int,
                 num_neg_samples: int = 10, sampler: str = "uniform",
                 bias_attr: bool = True, dtype=None, *, device=None,
                 generator=None):
        super().__init__()
        self.num_neg_samples = num_neg_samples
        self.sampler = sampler
        kw = dict(device=device, generator=generator)
        self.create_parameter("weight", (num_total_classes, dim), dtype,
                              I.XavierUniform(), **kw)
        self.has_bias = bias_attr
        if bias_attr:
            self.create_parameter("bias", (num_total_classes,), dtype,
                                  I.Constant(0.0), is_bias=True, **kw)

    def forward(self, x, label, custom_neg=None):
        return SP.nce_loss(
            x, label, self.weight,
            bias=self.bias if self.has_bias else None,
            num_neg_samples=self.num_neg_samples, sampler=self.sampler,
            key=None if custom_neg is not None else self.rng("nce"),
            custom_neg=custom_neg)


class HSigmoid(Layer):
    """Hierarchical sigmoid head over the complete binary tree of
    ``num_classes`` (its paths computed once here), or over a custom
    tree ``path_table``/``path_code`` (C, L), padded with -1. The paths
    are plain tensors on the layer's device, not buffers, as in the JAX
    package, where they are not part of the state either."""

    def __init__(self, dim: int, num_classes: int, path_table=None,
                 path_code=None, bias_attr: bool = True, dtype=None, *,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.num_classes = num_classes
        if path_table is not None:
            self.path_table = torch.as_tensor(path_table, device=device)
            self.path_code = torch.as_tensor(path_code, device=device)
            num_nodes = int(self.path_table.max()) + 1
        else:
            self.path_table, self.path_code = SP._default_tree_codes(
                num_classes, device)
            num_nodes = num_classes  # inner nodes of a complete tree < C
        kw = dict(device=device, generator=generator)
        self.create_parameter("weight", (num_nodes, dim), dtype,
                              I.XavierUniform(), **kw)
        self.has_bias = bias_attr
        if bias_attr:
            self.create_parameter("bias", (num_nodes,), dtype,
                                  I.Constant(0.0), is_bias=True, **kw)

    def forward(self, x, label):
        return SP.hsigmoid_loss(
            x, label, self.weight,
            bias=self.bias if self.has_bias else None,
            num_classes=self.num_classes, path_table=self.path_table,
            path_code=self.path_code)
