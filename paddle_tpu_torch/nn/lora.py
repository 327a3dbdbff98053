"""LoRA, low-rank adaptation for parameter-efficient fine-tuning
(counterpart of paddle_tpu/nn/lora.py).

out = x @ W_frozen + (alpha/r) * dropout(x) @ A @ B, with A (in, r)
drawn from N(0, 0.02) and B (r, out) zero, so an adapted model is
exactly the base model at step 0 and only (in+out)*r values train per
wrapped projection.

``apply_lora`` rewrites Linear sublayers in place (nn/rewrite.py). The
frozen base weight and bias move from parameters to buffers, which do
not require grad: ``named_parameters()`` is then the adapters plus every
layer that was never wrapped, and a checkpoint (``state_dict``) still
carries the frozen weights. ``merge_lora`` folds A @ B back into plain
Linears for serving. Each adapter draws its key off the global stream
as the JAX package's does: ``lora_a`` then ``lora_b``, in
``rewrite_linears``' walk order."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch import nn as tnn

from .. import initializer as I
from ..core.dtypes import get_policy
from ..core.enforce import enforce
from .layer import Layer
from .layers import Dropout, Linear, _apply_act


class LoRALinear(Layer):
    """A Linear whose weight (and bias) are frozen buffers, plus a
    trainable low-rank delta. Its forward contract (bias, ``act``, the
    mixed-precision policy) is that of the Linear it wraps; the adapters
    are created on that Linear's device."""

    def __init__(self, inner: Linear, r: int,
                 alpha: Optional[float] = None, dropout: float = 0.0):
        super().__init__()
        enforce(isinstance(inner, Linear),
                "LoRALinear wraps nn.Linear, got %s", type(inner).__name__)
        enforce(r >= 1, "rank must be >= 1, got %s", r)
        self.in_features = inner.in_features
        self.out_features = inner.out_features
        self.act = inner.act
        self.has_bias = inner.has_bias
        self.r = r
        self.scale = float(alpha if alpha is not None else r) / r
        # the frozen base: buffers, not parameters (no grad, no optimizer
        # state, still in the state dict)
        self.register_buffer("weight", inner.weight.detach())
        if inner.has_bias:
            self.register_buffer("bias", inner.bias.detach())
        self.drop = Dropout(dropout)
        device = inner.weight.device
        self.create_parameter("lora_a", (self.in_features, r), None,
                              I.Normal(scale=0.02), device=device)
        self.create_parameter("lora_b", (r, self.out_features), None,
                              I.Constant(0.0), device=device)

    def forward(self, x):
        # under the policy: x, W, dropout(x), A and B cast to the compute
        # dtype, the low-rank delta added before the bias, the sum cast to
        # the output dtype before ``act`` (the JAX package's order)
        pol = get_policy()
        out = torch.matmul(pol.cast_to_compute(x),
                           pol.cast_to_compute(self.weight))
        delta = torch.matmul(
            torch.matmul(pol.cast_to_compute(self.drop(x)),
                         pol.cast_to_compute(self.lora_a)),
            pol.cast_to_compute(self.lora_b))
        out = out + self.scale * delta
        if self.has_bias:
            out = out + pol.cast_to_compute(self.bias)
        return _apply_act(pol.cast_to_output(out), self.act)

    def merged_weight(self):
        """W + (alpha/r) A @ B, computed in float32 and cast to the base
        weight's dtype."""
        delta = self.lora_a.float() @ self.lora_b.float()
        return (self.weight.float() + self.scale * delta).to(
            self.weight.dtype)

    def to_linear(self) -> Linear:
        """A plain Linear with the adapter folded in (serving, export).
        Its parameters are created with constant initializers, as in the
        JAX package (one key off the stream each, and no random draw),
        then replaced by the merged weight and the frozen bias."""
        dev = self.weight.device
        lin = Linear(self.in_features, self.out_features,
                     bias_attr=self.has_bias, act=self.act,
                     weight_init=I.Constant(0.0), bias_init=I.Constant(0.0),
                     dtype=self.weight.dtype, device=dev)
        with torch.no_grad():
            lin.weight = tnn.Parameter(self.merged_weight())
            if self.has_bias:
                lin.bias = tnn.Parameter(self.bias.clone())
        return lin


def apply_lora(model: tnn.Module, r: int, alpha: Optional[float] = None,
               dropout: float = 0.0,
               targets: Optional[Sequence[str]] = None,
               predicate: Optional[Callable[[str, tnn.Module], bool]] = None,
               ) -> List[str]:
    """Wrap matching Linear sublayers of ``model`` in place; returns the
    wrapped paths. ``targets``: attribute-name suffixes to adapt (e.g.
    ("q_proj", "v_proj")); None adapts every Linear. ``predicate(path,
    layer)`` filters further. Build an optimizer or Trainer after this:
    the trainable parameters shrink to the adapters plus the layers that
    were never wrapped."""
    from .rewrite import rewrite_linears

    return rewrite_linears(
        model, lambda lin: LoRALinear(lin, r, alpha, dropout),
        targets=targets, predicate=predicate,
        skip=lambda sub: isinstance(sub, LoRALinear), what="apply_lora")


def lora_parameters(model: tnn.Module) -> dict:
    """The adapter subset of ``model.named_parameters()``, by name: what
    the fine-tuning optimizer should see."""
    return {k: v for k, v in model.named_parameters()
            if k.endswith("lora_a") or k.endswith("lora_b")}


def merge_lora(model: tnn.Module) -> List[str]:
    """Fold every LoRALinear back into a plain Linear in place (the
    adapter disappears into the weight). Returns the merged paths."""
    merged: List[str] = []

    def rewrite(layer: tnn.Module, prefix: str):
        for name, sub in list(layer._modules.items()):
            if sub is None:
                continue
            path = f"{prefix}{name}"
            if isinstance(sub, LoRALinear):
                setattr(layer, name, sub.to_linear())
                merged.append(path)
            else:
                rewrite(sub, f"{path}.")

    rewrite(model, "")
    return merged
