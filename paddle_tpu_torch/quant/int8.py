"""int8 execution of frozen quantized Linear layers (counterpart of the
Linear half of paddle_tpu/quant/int8.py) over the fused int8 kernel
(``ops/kernels/quant_matmul.py`` ``quant_linear``): weights live as int8
buffers (from ``quant.freeze``); one launch encodes the activations per
tensor at the recorded activation scale, accumulates the product in
int32, dequantizes, adds the bias and, for a ``"relu"`` layer, applies
ReLU.

As in the JAX package, ``int8_linear`` takes 2-D activations (N, D)
only. ``Int8Conv2D``/``int8_conv2d`` come with the convolution slice
(ROADMAP queue 1 item 10); ``int8_swap`` leaves other layer types on the
fake-quant float path and says so on stderr."""

from __future__ import annotations

import sys

import torch

from ..core.enforce import (InvalidArgumentError, UnimplementedError,
                            enforce)
from ..nn.layer import Layer
from ..ops.kernels.quant_matmul import pack_weight, quant_linear
from .ops import _absmax_scale


def _as_int8_weight(w):
    # a wider integer could hold values that wrap mod 256
    enforce(w.dtype == torch.int8,
            "int8 execution needs int8 frozen weights, got %s "
            "(weight_bits != 8?)", w.dtype)
    return w


def _linear_scales(act_scale, weight_scale, n: int, device):
    """The scales the kernel takes for a frozen Linear: the activations'
    encode scale at the recorded abs-max (``absmax_encode``'s) and the
    weight's per-channel ``weight_scale / 127`` as a contiguous (n,)
    tensor, both float32 on ``device``."""
    w_scale = torch.as_tensor(weight_scale, dtype=torch.float32,
                              device=device) / 127.0
    return (_absmax_scale(act_scale, device),
            w_scale.expand(n).contiguous())


def _check_2d(x):
    if x.ndim != 2:
        raise InvalidArgumentError(
            f"int8_linear takes 2-D activations (N, D), got rank {x.ndim} "
            f"(shape {tuple(x.shape)})")


def _int8_linear(x, w_packed, a_scale, w_scale, bias, out_dtype,
                 relu=False):
    """``quant_linear`` with the JAX package's result type: a float32
    bias is added in the kernel; any other case adds it after the
    product, as ``out + bias`` promotes there."""
    _check_2d(x)
    if bias is None or (out_dtype == torch.float32
                        and bias.dtype == torch.float32):
        return quant_linear(x, w_packed, a_scale, w_scale, bias, relu,
                            out_dtype=out_dtype)
    out = quant_linear(x, w_packed, a_scale, w_scale,
                       out_dtype=out_dtype) + bias
    return torch.relu(out) if relu else out


def int8_linear(x, frozen_entry, bias=None, *, out_dtype=torch.float32,
                use_pallas=None, interpret: bool = False):
    """Run a frozen Linear layer in int8: ``x`` (N, D) float;
    ``frozen_entry`` is one value of ``quant.freeze()``'s dict
    (``weight_int8`` (D, O), ``weight_scale`` (O,), ``act_scale``
    scalar). The weight is packed for the kernel on every call; an
    :class:`Int8Linear` packs it once. The JAX package's kernel choices
    (``use_pallas``, ``interpret``) are not ported and raise unless left
    at their defaults."""
    if use_pallas is not None or interpret:
        raise UnimplementedError(
            "int8_linear use_pallas=/interpret= (the kernel's tile and "
            "dispatch arguments) are not ported yet: ROADMAP queue 2 item 3")
    w_i8 = _as_int8_weight(frozen_entry["weight_int8"])
    a_scale, w_scale = _linear_scales(frozen_entry["act_scale"],
                                      frozen_entry["weight_scale"],
                                      w_i8.shape[1], x.device)
    return _int8_linear(x, pack_weight(w_i8.to(x.device)), a_scale,
                        w_scale, bias, out_dtype)


class Int8Linear(Layer):
    """Frozen int8 Linear executor: the int8 weight, its scales and the
    bias are buffers, never parameters. What the kernel takes — the
    scales and the weight packed (N, K16) — is derived from the buffers
    once, and again only after a buffer changes (a load writes them in
    place) or moves, not on every forward; the packed weight is a cache,
    not state (``state_dict`` holds only the buffers). A ``"relu"``
    layer runs its activation in the kernel's epilogue; any other
    ``act`` runs after it."""

    def __init__(self, frozen_entry, bias=None, act=None):
        super().__init__()

        def buf(x, dtype=None):
            return torch.as_tensor(x, dtype=dtype).detach().clone()

        self.register_buffer("weight_int8",
                             _as_int8_weight(buf(frozen_entry["weight_int8"])))
        self.register_buffer("weight_scale",
                             buf(frozen_entry["weight_scale"],
                                 torch.float32))
        self.register_buffer("act_scale",
                             buf(frozen_entry["act_scale"], torch.float32))
        if bias is not None:
            self.register_buffer("linear_bias", buf(bias))
        self.has_bias = bias is not None
        self.act = act
        self._operand_key = None
        self._operands = None

    def _kernel_operands(self):
        """(a_scale, w_scale, w_packed), derived again only when a buffer
        was written or moved."""
        bufs = (self.weight_int8, self.weight_scale, self.act_scale)
        # an inference tensor keeps no version counter: derive every time
        key = (None if any(b.is_inference() for b in bufs) else
               tuple((b.device, b.data_ptr(), b._version) for b in bufs))
        if key is None or key != self._operand_key:
            w_i8 = _as_int8_weight(self.weight_int8)
            self._operands = (*_linear_scales(
                self.act_scale, self.weight_scale, w_i8.shape[1],
                w_i8.device), pack_weight(w_i8))
            self._operand_key = key
        return self._operands

    def forward(self, x):
        from ..nn.layers import _apply_act  # the resolver nn.Linear uses

        a_scale, w_scale, w_packed = self._kernel_operands()
        relu = self.act == "relu"
        out = _int8_linear(x, w_packed, a_scale, w_scale,
                           self.linear_bias if self.has_bias else None,
                           torch.float32, relu=relu)
        return out if relu else _apply_act(out, self.act)


def int8_swap(model, frozen) -> int:
    """Swap every frozen QuantedLayer-wrapped Linear for an
    :class:`Int8Linear`, so ``model(x)`` runs the int8 kernel path.
    Non-8-bit freezes and layer types with no int8 executor stay on the
    fake-quant float path, reported on stderr. Returns the number of
    layers swapped."""
    from .qat import QuantedLayer

    swapped = 0
    for path, sub in list(model.named_modules()):
        if not isinstance(sub, QuantedLayer) or path not in frozen:
            continue
        if frozen[path].get("bits", 8) != 8:
            print(f"int8_swap: {path} skipped "
                  f"({frozen[path].get('bits')}-bit freeze stays on "
                  "the fake-quant float path)", file=sys.stderr)
            continue
        inner = sub.inner
        tname = type(inner).__name__
        if tname != "Linear":
            print(f"int8_swap: {path} ({tname}) has no int8 executor — "
                  "stays on the fake-quant float path", file=sys.stderr)
            continue
        repl = Int8Linear(frozen[path],
                          bias=inner.bias if inner.has_bias else None,
                          act=getattr(inner, "act", None))
        parent = model
        parts = path.split(".")
        for p in parts[:-1]:
            parent = getattr(parent, p)
        setattr(parent, parts[-1], repl)
        swapped += 1
    return swapped
