"""int8 execution of frozen quantized Linear and Conv2D layers
(counterpart of paddle_tpu/quant/int8.py) over the int8 matrix-product
kernel (``ops/kernels/quant_matmul.py``): weights live as int8 buffers
(from ``quant.freeze``), activations are encoded per tensor at the
recorded activation scale, products accumulate in int32 and dequantize
in the kernel's epilogue.

- Linear: one launch of the fused ``quant_linear`` encodes, multiplies,
  dequantizes, adds the bias and, for a ``"relu"`` layer, applies ReLU.
  As in the JAX package, ``int8_linear`` takes 2-D activations (N, D)
  only.
- Conv2D, ``groups == 1``: the activations encoded to int8, im2col in
  int8 (the JAX package's (i, j, c) column order, written into K16
  columns, the last ones zero), then ONE ``quant_matmul`` launch against
  the weight laid out (kh*kw*C, O) and packed once.
- Conv2D, ``groups > 1`` (grouped, depthwise): no Pallas kernel in the
  JAX package either (an integer ``lax.conv`` with int32 accumulation);
  here the same im2col per group and an exact batched product in
  float64, scaled as the JAX package scales it,
  ``(acc * a_scale) * w_scale``.

``int8_swap`` leaves other layer types on the fake-quant float path and
says so on stderr."""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from ..core.enforce import (InvalidArgumentError, UnimplementedError,
                            enforce)
from ..nn.layer import Layer
from ..ops.kernels.quant_matmul import (pack_weight, quant_linear,
                                        quant_matmul_packed)
from ..ops.nn import _pair
from .ops import _absmax_scale, _encode_at


def _as_int8_weight(w):
    # a wider integer could hold values that wrap mod 256
    enforce(w.dtype == torch.int8,
            "int8 execution needs int8 frozen weights, got %s "
            "(weight_bits != 8?)", w.dtype)
    return w


def _linear_scales(act_scale, weight_scale, n: int, device):
    """The scales the kernel takes for a frozen Linear or Conv2D: the
    activations' encode scale at the recorded abs-max
    (``absmax_encode``'s) and the weight's per-channel ``weight_scale /
    127`` as a contiguous (n,) tensor, both float32 on ``device``."""
    w_scale = torch.as_tensor(weight_scale, dtype=torch.float32,
                              device=device) / 127.0
    return (_absmax_scale(act_scale, device),
            w_scale.expand(n).contiguous())


def _buffer_key(bufs):
    """What operands derived from ``bufs`` depend on: each buffer's
    device, storage and version; None for an inference tensor, which
    keeps no version counter (derive every time)."""
    if any(b.is_inference() for b in bufs):
        return None
    return tuple((b.device, b.data_ptr(), b._version) for b in bufs)


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
        key = _buffer_key((self.weight_int8, self.weight_scale,
                           self.act_scale))
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
    """Swap every frozen QuantedLayer-wrapped Linear and Conv2D (grouped,
    depthwise, dilated and NHWC convs too) for an :class:`Int8Linear` or
    :class:`Int8Conv2D`, so ``model(x)`` runs the int8 kernel path.
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
        bias = inner.bias if getattr(inner, "has_bias", False) else None
        if tname == "Linear":
            repl = Int8Linear(frozen[path], bias=bias,
                              act=getattr(inner, "act", None))
        elif tname == "Conv2D":
            repl = Int8Conv2D(
                frozen[path], bias=bias, act=getattr(inner, "act", None),
                stride=inner.stride, padding=inner.padding,
                dilation=inner.dilation, groups=inner.groups,
                data_format=inner.data_format)
        else:
            print(f"int8_swap: {path} ({tname}) has no int8 executor — "
                  "stays on the fake-quant float path", file=sys.stderr)
            continue
        parent = model
        parts = path.split(".")
        for p in parts[:-1]:
            parent = getattr(parent, p)
        setattr(parent, parts[-1], repl)
        swapped += 1
    return swapped


# ----- int8 convolution ------------------------------------------------------

# float64 sums of int8 products are exact below 2^53
_EXACT_F64 = 2 ** 53


def _im2col_nhwc(x, kh: int, kw: int, stride, padding, dilation=1,
                 cols=None):
    """(B, H, W, C) -> (B*OH*OW, ``cols``) patches, column (i*kw + j)*C +
    c holding tap (i, j) of channel c (the JAX package's (i, j, c)
    order); columns past kh*kw*C are zeros (``cols`` defaults to
    kh*kw*C). Slicing only, so int8 stays int8. Returns (patches, (B,
    OH, OW))."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    b, h, w, c = x.shape
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    k = kh * kw * c
    cols = k if cols is None else cols
    out = (x.new_empty if cols == k else x.new_zeros)((b, oh, ow, cols))
    for i in range(kh):
        for j in range(kw):
            t = (i * kw + j) * c
            out[..., t:t + c] = x[:, i * dh:i * dh + (oh - 1) * sh + 1:sh,
                                  j * dw:j * dw + (ow - 1) * sw + 1:sw]
    return out.reshape(b * oh * ow, cols), (b, oh, ow)


def _im2col_nchw(x, kh: int, kw: int, stride, padding, dilation=1):
    """(B, C, H, W) -> (B*OH*OW, kh*kw*C) patches in the (i, j, c) order,
    as the JAX package's ``_im2col_nchw``; returns (patches, (B, OH,
    OW))."""
    return _im2col_nhwc(x.permute(0, 2, 3, 1), kh, kw, stride, padding,
                        dilation)


def _conv_weight_packed(w_i8):
    """The OIHW int8 weight as the kernel takes it: laid out (kh*kw*C,
    O) in the im2col's (i, j, c) order, then packed (O, K16)."""
    o, cpg, kh, kw = w_i8.shape
    return pack_weight(w_i8.permute(2, 3, 1, 0).reshape(kh * kw * cpg, o))


def _grouped_acc(x_i8, w_i8, groups: int, stride, padding, dilation):
    """The exact integer sums of a grouped int8 convolution, NHWC in,
    (B*OH*OW, O) out as float64: im2col, then one batched product over
    the groups in float64 (exact below 2^53, checked)."""
    o, cpg, kh, kw = w_i8.shape
    enforce(x_i8.shape[-1] == cpg * groups and o % groups == 0,
            "int8_conv2d: x has %s channels, the weight %s in %s groups of "
            "%s", x_i8.shape[-1], o, groups, cpg)
    if kh * kw * cpg * 127 * 127 >= _EXACT_F64:
        raise InvalidArgumentError(
            f"int8_conv2d: a grouped conv of {kh}x{kw} taps over {cpg} "
            f"channels a group sums past 2^53 and would not be exact")
    patches, (b, oh, ow) = _im2col_nhwc(x_i8, kh, kw, stride, padding,
                                        dilation)
    m, opg = patches.shape[0], o // groups
    a = (patches.reshape(m, kh * kw, groups, cpg).permute(2, 0, 1, 3)
         .reshape(groups, m, kh * kw * cpg).double())
    w = (w_i8.reshape(groups, opg, cpg, kh, kw).permute(0, 3, 4, 2, 1)
         .reshape(groups, kh * kw * cpg, opg).double())
    acc = torch.bmm(a, w).permute(1, 0, 2).reshape(m, o)
    return acc, (b, oh, ow)


def _int8_conv(x, w_i8, w_packed, a_scale, w_scale, bias, stride, padding,
               dilation, groups, data_format, out_dtype):
    """The frozen conv on encoded activations; ``w_packed`` (groups == 1)
    is the packed weight."""
    enforce(data_format in ("NCHW", "NHWC"),
            "int8_conv2d data_format must be NCHW|NHWC, got %s", data_format)
    if x.ndim != 4:
        raise InvalidArgumentError(
            f"int8_conv2d takes 4-D activations, got shape {tuple(x.shape)}")
    o, cpg, kh, kw = w_i8.shape
    x_nhwc = x.permute(0, 2, 3, 1) if data_format == "NCHW" else x
    x_i8 = _encode_at(x_nhwc, a_scale)
    if groups == 1:
        enforce(x_i8.shape[-1] == cpg,
                "int8_conv2d: x has %s channels, the weight %s",
                x_i8.shape[-1], cpg)
        patches, (b, oh, ow) = _im2col_nhwc(
            x_i8, kh, kw, stride, padding, dilation,
            cols=w_packed.shape[1])
        out = quant_matmul_packed(patches, w_packed, a_scale, w_scale,
                                  out_dtype=out_dtype)
    else:
        acc, (b, oh, ow) = _grouped_acc(x_i8, w_i8, groups, stride,
                                        padding, dilation)
        out = ((acc.float() * a_scale) * w_scale[None, :]).to(out_dtype)
    out = out.reshape(b, oh, ow, o)
    if bias is not None:
        out = out + bias
    return out.permute(0, 3, 1, 2) if data_format == "NCHW" else out


def int8_conv2d(x, frozen_entry, bias=None, *, stride=1, padding=0,
                dilation=1, groups: int = 1, data_format: str = "NCHW",
                out_dtype=torch.float32, use_pallas=None,
                interpret: bool = False):
    """A frozen Conv2D in int8: ``x`` float NCHW (or NHWC), the same
    layout out; ``frozen_entry`` one value of ``quant.freeze()``'s dict
    (``weight_int8`` OIHW, ``weight_scale`` (O,), ``act_scale``). groups
    == 1 runs one ``quant_matmul`` launch on the card (the weight packed
    on every call; an :class:`Int8Conv2D` packs it once), groups > 1 the
    exact grouped product. Equal to the JAX package's ``int8_conv2d``.
    ``use_pallas``/``interpret`` are not ported and raise unless left at
    their defaults."""
    if use_pallas is not None or interpret:
        raise UnimplementedError(
            "int8_conv2d use_pallas=/interpret= (the kernel's tile and "
            "dispatch arguments) are not ported yet: ROADMAP queue 2 item 3")
    w_i8 = _as_int8_weight(frozen_entry["weight_int8"]).to(x.device)
    a_scale, w_scale = _linear_scales(frozen_entry["act_scale"],
                                      frozen_entry["weight_scale"],
                                      w_i8.shape[0], x.device)
    w_packed = _conv_weight_packed(w_i8) if groups == 1 else None
    return _int8_conv(x, w_i8, w_packed, a_scale, w_scale, bias, stride,
                      padding, dilation, groups, data_format, out_dtype)


class Int8Conv2D(Layer):
    """Frozen int8 Conv2D executor: the int8 weight (OIHW), its scales
    and the bias are buffers; the scales and (groups == 1) the packed
    weight are derived from them once, and again only after a buffer
    changes or moves, as :class:`Int8Linear` does. ``act`` runs after the
    convolution."""

    def __init__(self, frozen_entry, bias=None, act=None, stride=1,
                 padding=0, dilation=1, groups: int = 1,
                 data_format: str = "NCHW"):
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
            self.register_buffer("conv_bias", buf(bias))
        self.has_bias = bias is not None
        self.act = act
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.data_format = data_format
        self._operand_key = None
        self._operands = None

    def _kernel_operands(self):
        """(a_scale, w_scale, w_packed or None), derived again only when a
        buffer was written or moved."""
        key = _buffer_key((self.weight_int8, self.weight_scale,
                           self.act_scale))
        if key is None or key != self._operand_key:
            w_i8 = _as_int8_weight(self.weight_int8)
            self._operands = (*_linear_scales(
                self.act_scale, self.weight_scale, w_i8.shape[0],
                w_i8.device), _conv_weight_packed(w_i8)
                if self.groups == 1 else None)
            self._operand_key = key
        return self._operands

    def forward(self, x):
        from ..nn.layers import _apply_act

        a_scale, w_scale, w_packed = self._kernel_operands()
        out = _int8_conv(x, self.weight_int8, w_packed, a_scale, w_scale,
                         self.conv_bias if self.has_bias else None,
                         self.stride, self.padding, self.dilation,
                         self.groups, self.data_format, torch.float32)
        return _apply_act(out, self.act)
