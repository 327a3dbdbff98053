"""Weight-only int8 quantization, W8A16 (counterpart of
paddle_tpu/quant/weight_only.py): a Linear's weight is stored as
per-output-channel symmetric int8 with one float32 scale per channel,
and dequantized in the compute dtype at every forward, then multiplied
(``torch.matmul``; the JAX package does the same with ``jnp.matmul``,
outside any Pallas kernel). Activations and accumulation keep their
precision; the stored weight bytes are a quarter of float32's. A pure
post-training transform: no data, no retraining."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch import nn as tnn

from ..core.dtypes import get_policy
from ..core.enforce import enforce
from ..nn.layer import Layer, use
from ..nn.layers import Linear, _apply_act


class WeightOnlyLinear(Layer):
    """A Linear whose weight lives as int8 plus per-output-channel
    float32 scales, both buffers (a serving transform: nothing trains).
    The forward contract (bias, ``act``, the mixed-precision policy) is
    that of the Linear it replaces."""

    def __init__(self, inner: Linear):
        super().__init__()
        enforce(isinstance(inner, Linear),
                "WeightOnlyLinear wraps nn.Linear, got %s",
                type(inner).__name__)
        from .ops import abs_max_scale, quantize_to_int

        self.in_features = inner.in_features
        self.out_features = inner.out_features
        self.act = inner.act
        self.has_bias = inner.has_bias
        # the package-wide convention (quant/ops.py): scale = per-channel
        # abs-max, q = round(w * 127 / scale), dequant = q * scale / 127,
        # so the buffers read back through quant.dequantize(quant_axis=1)
        with torch.no_grad():
            w = inner.weight.detach().float()              # (in, out)
            scale = torch.clamp_min(abs_max_scale(w, axis=1), 1e-8)
            self.register_buffer("qweight", quantize_to_int(w, scale[None]))
            self.register_buffer("scale", scale)
            if inner.has_bias:
                self.register_buffer("bias", inner.bias.detach().clone())

    def forward(self, x):
        pol = get_policy()
        xc = pol.cast_to_compute(x)
        w = use(self.qweight).to(xc.dtype) * (
            use(self.scale) / 127.0).to(xc.dtype)
        out = torch.matmul(xc, w)
        if self.has_bias:
            out = out + pol.cast_to_compute(use(self.bias))
        return _apply_act(pol.cast_to_output(out), self.act)

    def dequantized_weight(self):
        from .ops import dequantize

        return dequantize(self.qweight, self.scale, quant_axis=1)


def apply_weight_only_int8(model: tnn.Module,
                           targets: Optional[Sequence[str]] = None,
                           predicate: Optional[
                               Callable[[str, tnn.Module], bool]] = None,
                           min_features: int = 0) -> List[str]:
    """Replace matching Linear sublayers with :class:`WeightOnlyLinear`
    in place; returns the wrapped paths. ``targets``: attribute-name
    suffixes (None = every Linear); ``min_features``: skip layers
    smaller than this on both dims (small heads gain nothing and lose
    the most precision)."""
    from ..nn.rewrite import rewrite_linears

    def big_enough(path, sub):
        return (max(sub.in_features, sub.out_features) >= min_features
                and (predicate is None or predicate(path, sub)))

    return rewrite_linears(
        model, WeightOnlyLinear, targets=targets, predicate=big_enough,
        skip=lambda sub: isinstance(sub, WeightOnlyLinear),
        what="apply_weight_only_int8")
