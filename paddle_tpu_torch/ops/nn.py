"""Neural-network ops (counterpart of the matching functions in
paddle_tpu/ops/nn.py): convolutions, pooling, normalisations, softmax,
the embedding lookup, one-hot and dropout.

None of these has a Pallas kernel in the JAX package (XLA runs its
``lax.conv_general_dilated`` and ``lax.reduce_window``), so cuDNN, through
``torch.nn.functional``, carries them here. Layouts are the JAX
package's: NCHW activations with OIHW weights by default (IOHW for the
transposed convolution); ``data_format="NHWC"`` takes and returns
logically NHWC tensors, which are permuted to an NCHW view with
``channels_last`` memory — no copy — so cuDNN runs its NHWC kernels.
Where torch's functional op means something else than the JAX
package's, the JAX meaning is kept and said where: pooling's ceil mode,
the BatchNorm running statistics, ``lrn``'s alpha, ``one_hot`` of an
id out of range."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..core.enforce import enforce

IntOrPair = Union[int, Sequence[int]]


def _pair(v: IntOrPair, n: int = 2) -> Tuple[int, ...]:
    if isinstance(v, int):
        return (v,) * n
    t = tuple(v)
    enforce(len(t) == n, "expected %s values, got %s", n, t)
    return t


def _check_format(data_format: str, what: str):
    enforce(data_format in ("NCHW", "NHWC"),
            "%s data_format must be NCHW|NHWC, got %s", what, data_format)


def _to_nchw(x, data_format: str):
    """A logically NHWC tensor as an NCHW view (channels_last memory when
    ``x`` is contiguous); NCHW as it is."""
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _from_nchw(y, data_format: str):
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


# ----- convolutions ----------------------------------------------------------


def conv2d(x, weight, stride: IntOrPair = 1, padding: IntOrPair = 0,
           dilation: IntOrPair = 1, groups: int = 1,
           data_format: str = "NCHW"):
    """2-D convolution, weight OIHW (O, C / groups, kh, kw) in both
    layouts; symmetric ``padding``."""
    _check_format(data_format, "conv2d")
    y = F.conv2d(_to_nchw(x, data_format), weight, None, _pair(stride),
                 _pair(padding), _pair(dilation), groups)
    return _from_nchw(y, data_format)


def depthwise_conv2d(x, weight, stride: IntOrPair = 1,
                     padding: IntOrPair = 0, dilation: IntOrPair = 1):
    """NCHW convolution with groups == C_in."""
    return conv2d(x, weight, stride, padding, dilation, groups=x.shape[1])


def conv2d_transpose(x, weight, stride: IntOrPair = 1,
                     padding: IntOrPair = 0, dilation: IntOrPair = 1,
                     groups: int = 1):
    """NCHW transposed convolution, weight IOHW (C_in, O / groups, kh,
    kw); output size (in - 1) * stride - 2 * pad + dilation * (k - 1) + 1,
    the JAX package's (no output padding)."""
    enforce(x.shape[1] % groups == 0,
            "in channels %s not divisible by groups %s", x.shape[1], groups)
    return F.conv_transpose2d(x, weight, None, _pair(stride), _pair(padding),
                              0, groups, _pair(dilation))


def conv3d(x, weight, stride: IntOrPair = 1, padding: IntOrPair = 0,
           dilation: IntOrPair = 1, groups: int = 1):
    """NCDHW convolution, weight OIDHW."""
    return F.conv3d(x, weight, None, _pair(stride, 3), _pair(padding, 3),
                    _pair(dilation, 3), groups)


# ----- pooling ---------------------------------------------------------------


def _ceil_pads(hw, k, s, p):
    """(top, bottom, left, right): the JAX package's ceil-mode padding,
    ``p`` on the left and on the right as much more as the last partial
    window needs. Torch's ``ceil_mode`` drops a last window that starts
    in the right padding (H=5, k=2, s=2, p=1: torch 3 outputs, the JAX
    package 4), so the padding is applied here instead."""
    pads = []
    for dim, kk, ss, pp in zip(hw, k, s, p):
        out = -(-(dim + 2 * pp - kk) // ss) + 1
        need = (out - 1) * ss + kk - dim - 2 * pp
        pads.append((pp, pp + max(0, need)))
    return pads[0] + pads[1]


def pool2d(x, kernel_size: IntOrPair, pool_type: str = "max",
           stride: Optional[IntOrPair] = None, padding: IntOrPair = 0,
           ceil_mode: bool = False, exclusive: bool = True,
           global_pooling: bool = False, data_format: str = "NCHW"):
    """Max or average pooling over H and W. Padding reads as -inf (max)
    or is left out of the count (``exclusive`` average); a window wholly
    in the padding gives -inf (max). A non-``exclusive`` average divides
    by kh * kw always."""
    _check_format(data_format, "pool2d")
    enforce(pool_type in ("max", "avg"), "pool_type must be max|avg, got %s",
            pool_type)
    xc = _to_nchw(x, data_format)
    hw = tuple(xc.shape[2:])
    if global_pooling:
        kernel_size, padding, stride = hw, 0, hw
    k = _pair(kernel_size)
    s = _pair(stride) if stride is not None else k
    p = _pair(padding)
    pads = (_ceil_pads(hw, k, s, p) if ceil_mode
            else (p[0], p[0], p[1], p[1]))
    fits = (pads == (p[0], p[0], p[1], p[1])
            and all(2 * pp <= kk for pp, kk in zip(p, k)))
    if fits:
        # torch pads implicitly (-inf for max, left out of an exclusive
        # count) exactly as the JAX package does
        if pool_type == "max":
            y = F.max_pool2d(xc, k, s, p)
        else:
            y = F.avg_pool2d(xc, k, s, p, count_include_pad=not exclusive)
        return _from_nchw(y, data_format)
    t, b, left, right = pads
    if pool_type == "max":
        xp = F.pad(xc, (left, right, t, b), value=float("-inf"))
        return _from_nchw(F.max_pool2d(xp, k, s), data_format)
    summed = F.avg_pool2d(F.pad(xc, (left, right, t, b)), k, s,
                          divisor_override=1)
    if exclusive:
        ones = torch.ones((1, 1) + hw, dtype=xc.dtype, device=xc.device)
        counts = F.avg_pool2d(F.pad(ones, (left, right, t, b)), k, s,
                              divisor_override=1)
        y = summed / counts
    else:
        y = summed / (k[0] * k[1])
    return _from_nchw(y, data_format)


def adaptive_pool2d(x, output_size: IntOrPair, pool_type: str = "avg"):
    """NCHW pooling onto ``output_size``; H and W must divide by it."""
    oh, ow = _pair(output_size)
    n, c, h, w = x.shape
    enforce(h % oh == 0 and w % ow == 0,
            "adaptive pool needs divisible sizes (%s,%s)->(%s,%s)", h, w,
            oh, ow)
    x = x.reshape(n, c, oh, h // oh, ow, w // ow)
    if pool_type == "avg":
        return x.mean(dim=(3, 5))
    return x.amax(dim=(3, 5))


# ----- normalisations ----------------------------------------------------------


def batch_norm(x, scale, bias, mean, variance, *, training: bool = False,
               momentum: float = 0.9, epsilon: float = 1e-5,
               data_layout: str = "NCHW"):
    """Returns ``(y, new_mean, new_var)``, as the JAX package does; the
    caller keeps the running statistics. In training, y normalises by
    the batch's mean and biased variance, and the running statistics
    move as ``momentum * old + (1 - momentum) * batch`` with the biased
    variance — not ``F.batch_norm``'s update, which weights the batch by
    ``momentum`` and takes the unbiased variance. So torch normalises
    (cuDNN) and the statistics are taken apart, without gradient. In
    eval mode the running statistics normalise and come back as they
    are. Channels on axis 1 (NCHW) or last (NHWC)."""
    xc = x.movedim(-1, 1) if data_layout == "NHWC" else x
    if training:
        # the aten op: F.batch_norm refuses one value per channel, which
        # the JAX package normalises (to the bias)
        y = torch.batch_norm(xc, scale, bias, None, None, True, 0.0,
                             epsilon, torch.backends.cudnn.enabled)
        with torch.no_grad():
            axes = (0,) + tuple(range(2, xc.ndim))
            batch_var, batch_mean = torch.var_mean(xc, dim=axes,
                                                   correction=0)
            new_mean = momentum * mean + (1 - momentum) * batch_mean
            new_var = momentum * variance + (1 - momentum) * batch_var
    else:
        y = torch.batch_norm(xc, scale, bias, mean, variance, False, 0.0,
                             epsilon, torch.backends.cudnn.enabled)
        new_mean, new_var = mean, variance
    if data_layout == "NHWC":
        y = y.movedim(1, -1)
    return y, new_mean, new_var


def group_norm(x, scale=None, bias=None, *, groups: int = 32,
               epsilon: float = 1e-5):
    """Group normalisation over channels (axis 1) in ``groups`` groups,
    biased variance."""
    c = x.shape[1]
    enforce(c % groups == 0, "channels %s not divisible by groups %s", c,
            groups)
    return F.group_norm(x, groups, scale, bias, epsilon)


def l2_normalize(x, axis: int = -1, epsilon: float = 1e-12):
    """``x / max(||x||_2, epsilon)`` along ``axis``."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    return x / torch.clamp_min(norm, epsilon)


def lrn(x, n: int = 5, k: float = 1.0, alpha: float = 1e-4,
        beta: float = 0.75):
    """Local response normalisation across channels (NCHW): ``x / (k +
    alpha * sum of x^2 over n channels) ** beta``. Alpha is not divided
    by n, as ``F.local_response_norm`` divides it."""
    sq = torch.square(x)
    half = n // 2
    pad = F.pad(sq, (0, 0, 0, 0, half, half))
    c = x.shape[1]
    den = k + alpha * sum(pad[:, i:i + c] for i in range(n))
    return x / torch.pow(den, beta)


def softmax(x, axis: int = -1):
    return F.softmax(x, dim=axis)


def log_softmax(x, axis: int = -1):
    return F.log_softmax(x, dim=axis)


def layer_norm(x, scale=None, bias=None, *, begin_norm_axis: int = 1,
               epsilon: float = 1e-5):
    """Normalize over dims [begin_norm_axis, ndim): (x - mean) *
    rsqrt(var + eps), var the population variance taken as the JAX
    package takes it (mean of the squared deviations), then [* scale]
    [+ bias]."""
    axes = tuple(range(begin_norm_axis, x.ndim))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axes, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + epsilon)
    norm_shape = x.shape[begin_norm_axis:]
    if scale is not None:
        y = y * scale.reshape(norm_shape)
    if bias is not None:
        y = y + bias.reshape(norm_shape)
    return y


def rms_norm(x, scale=None, *, epsilon: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) [* scale], over the last axis."""
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + epsilon)
    if scale is not None:
        y = y * scale
    return y


def dropout(x, p: float, generator: Optional[torch.Generator] = None, *,
            training: bool = True, mode: str = "upscale_in_train"):
    """Dropout (the reference's dropout_op and its
    dropout_implementation). In eval mode or at p == 0 the identity,
    except that ``downgrade_in_infer`` scales by 1 - p in eval mode. In
    training an entry is kept where a uniform draw from ``generator``
    (the JAX package's PRNG key) is below 1 - p: ``upscale_in_train``
    scales the kept entries by 1 / (1 - p), ``downgrade_in_infer`` keeps
    them as they are."""
    if not training or p == 0.0:
        if mode == "downgrade_in_infer" and not training:
            return x * (1.0 - p)
        return x
    enforce(generator is not None,
            "dropout in training mode requires a torch.Generator (open "
            "core.rng_scope, as Trainer.train_step does)")
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator,
                      device=generator.device) < keep
    mask = mask.to(x.device)
    if mode == "upscale_in_train":
        return torch.where(mask, x / keep, 0.0).to(x.dtype)
    return torch.where(mask, x, 0.0).to(x.dtype)


def embedding(ids, table, padding_idx: Optional[int] = None):
    """Row lookup with ``jnp.take``'s fill semantics: an id in [-V, 0)
    reads row id + V, an id outside [-V, V) reads a row of NaN (a bad
    token poisons its own row, and no other, instead of raising on the
    CPU or asserting on the card); rows of ``padding_idx`` read as
    zeros. The ids are clamped before the gather and the bad rows
    masked after it, so the lookup reads nothing back to the host."""
    v = table.shape[0]
    ids_l = ids.long()
    inside = (ids_l >= -v) & (ids_l < v)
    rows = torch.where(ids_l < 0, ids_l + v, ids_l).clamp(0, v - 1)
    out = torch.where(inside[..., None], table[rows],
                      torch.full((), float("nan"), dtype=table.dtype,
                                 device=table.device))
    if padding_idx is not None:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return out


def one_hot(ids, depth: int, dtype=torch.float32):
    """(..., depth) one-hot rows; an id outside [0, depth) gives a row of
    zeros, as ``jax.nn.one_hot`` does (``F.one_hot`` raises)."""
    from ..core.dtypes import to_dtype

    classes = torch.arange(depth, device=ids.device)
    return (ids[..., None] == classes).to(to_dtype(dtype))
