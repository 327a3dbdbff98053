"""Quantization-aware training and post-training quantization
(counterpart of paddle_tpu/quant/qat.py).

Quantization is a layer rewrite: :func:`quantize_model` wraps each
quantizable sublayer (Linear) in a :class:`QuantedLayer` that
fake-quantizes its input activation at a moving-average abs-max scale
(kept in buffers, updated in training mode only) and its weight per
channel. The same wrapper serves QAT (train with straight-through
gradients) and PTQ (:func:`calibrate` on representative batches, then
:func:`freeze`, which exports int8 weights and scales).

Parameter paths gain ``.inner`` under each wrapped layer
(``fc1.inner.weight``) and the wrapper's buffers are ``act_scale``,
``act_accum`` and ``act_state``, as in the JAX package, so states move
between the packages by name."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn as tnn
from torch.func import functional_call

from ..core.enforce import enforce
from ..nn.layer import Layer
from . import ops as Q


@dataclass
class QuantConfig:
    weight_bits: int = 8
    activation_bits: int = 8
    moving_rate: float = 0.9
    # which layer classes get wrapped, by type name
    quantizable: Tuple[str, ...] = ("Linear", "Conv2D")
    # per-channel weight axis by layer type (Linear weight (in, out) ->
    # axis 1; Conv2D weight (cout, cin, kh, kw) -> axis 0)
    channel_axis: Dict[str, int] = field(
        default_factory=lambda: {"Linear": 1, "Conv2D": 0})


class QuantedLayer(Layer):
    """One quantizable layer with activation and weight fake
    quantization. The inner layer runs with the fake-quantized weight
    through ``torch.func.functional_call``; its parameter is never
    mutated."""

    def __init__(self, inner: tnn.Module, config: QuantConfig):
        super().__init__()
        tname = type(inner).__name__
        enforce(isinstance(getattr(inner, "weight", None), tnn.Parameter),
                "QuantedLayer needs an inner layer with a 'weight' param, "
                "got %s", tname)
        self.inner = inner
        self.config = config
        self.channel_axis = config.channel_axis.get(tname, 0)
        w = inner.weight
        for name in ("act_scale", "act_accum", "act_state"):
            self.register_buffer(name, torch.zeros((), dtype=torch.float32,
                                                   device=w.device))

    def forward(self, x, *args, **kwargs):
        cfg = self.config
        st = Q.MovingAverageState(self.act_scale, self.act_accum,
                                  self.act_state)
        xq, new_st = Q.fake_quantize_moving_average_abs_max(
            x, st, cfg.activation_bits, cfg.moving_rate,
            is_test=not self.training)
        if self.training:
            with torch.no_grad():
                self.act_scale.copy_(new_st.scale)
                self.act_accum.copy_(new_st.accum)
                self.act_state.copy_(new_st.state)
        wq, _ = Q.fake_channel_wise_quantize_abs_max(
            self.inner.weight, cfg.weight_bits, self.channel_axis)
        return functional_call(self.inner, {"weight": wq}, (xq,) + args,
                               kwargs)

    def weight_scales(self):
        return Q.abs_max_scale(self.inner.weight, axis=self.channel_axis)


def quantize_model(model: tnn.Module,
                   config: Optional[QuantConfig] = None) -> tnn.Module:
    """Rewrite ``model`` in place, wrapping every quantizable sublayer.
    Returns the model (parameter paths gain an ``.inner`` segment under
    each wrapped layer)."""
    config = config or QuantConfig()

    def rewrite(layer: tnn.Module):
        for name, sub in list(layer.named_children()):
            if type(sub).__name__ in config.quantizable:
                setattr(layer, name, QuantedLayer(sub, config))
            else:
                rewrite(sub)

    enforce(type(model).__name__ not in config.quantizable,
            "quantize_model wraps sublayers; wrap the root %s yourself with "
            "QuantedLayer", type(model).__name__)
    rewrite(model)
    return model


def calibrate(model: tnn.Module, batches: Iterable,
              forward=None) -> tnn.Module:
    """Post-training calibration: run representative batches in training
    mode so the moving-average activation scales settle, then switch to
    eval (frozen scales)."""
    model.train()
    with torch.no_grad():
        for batch in batches:
            if forward is not None:
                forward(model, batch)
            elif isinstance(batch, tuple):
                model(*batch)
            else:
                model(batch)
    model.eval()
    return model


def freeze(model: tnn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """Export int8 weights and scales for every quantized layer:
    ``{layer_path: {"weight_int8", "weight_scale", "act_scale",
    "bits"}}`` (``weight_scale`` is the per-channel abs-max,
    ``weight_int8 = round(clip(w) * qmax / weight_scale)``)."""
    out = {}
    with torch.no_grad():
        for path, sub in model.named_modules():
            if not isinstance(sub, QuantedLayer):
                continue
            w = sub.inner.weight
            wscale = sub.weight_scales()
            shape = [1] * w.ndim
            shape[sub.channel_axis] = w.shape[sub.channel_axis]
            out[path] = {
                "weight_int8": Q.quantize_to_int(
                    w, wscale.reshape(shape), sub.config.weight_bits),
                "weight_scale": wscale,
                "act_scale": sub.act_scale.clone(),
                "bits": sub.config.weight_bits,
            }
    return out
