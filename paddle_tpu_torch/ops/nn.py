"""Neural-network ops (counterpart of paddle_tpu/ops/nn.py):
convolutions, pooling, normalisations, softmax, the embedding lookup,
one-hot and dropout, and the resize, rearrangement and sampling ops
(``interpolate``, ``pixel_shuffle``, ``pad2d``, ``space_to_depth``,
``shuffle_channel``, ``grid_sampler``, ``temporal_shift``).

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
id out of range, ``interpolate``'s half-pixel nearest rows and
antialiased linear weights (``jax.image.resize``'s)."""

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


# ----- resize, rearrangement, sampling ---------------------------------------


def _resize_weights(n_in: int, n_out: int, dtype, device):
    """(n_in, n_out) weights of ``jax.image.resize``'s linear method
    along one axis (its ``compute_weight_mat`` with the triangle kernel
    and antialiasing): half-pixel sample positions, the kernel widened
    by 1 / scale when downsampling, each column normalised over the taps
    inside the input, zero where the sample falls outside it."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=dtype, device=device) + 0.5)
              * inv_scale - 0.5)
    src = torch.arange(n_in, dtype=dtype, device=device)
    x = torch.abs(sample[None, :] - src[:, None]) / kernel_scale
    weights = torch.clamp_min(1.0 - torch.abs(x), 0.0)
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * 1.1920928955078125e-07,
                          weights / torch.where(total != 0, total,
                                                torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _nearest_index(n_in: int, n_out: int, device):
    """``jax.image.resize``'s nearest source rows: floor((i + 0.5) *
    n_in / n_out) in float32 (half-pixel centres: torch's
    ``"nearest-exact"``, not ``"nearest"``)."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * n_in / n_out
    return torch.floor(pos).long()


def interpolate(x, size: Sequence[int], method: str = "nearest"):
    """NCHW resize to ``size`` (H, W), as ``jax.image.resize`` computes
    it: ``"nearest"`` picks half-pixel-centred source rows;
    ``"bilinear"`` contracts with per-axis triangle-kernel weights that
    antialias when downsampling (``F.interpolate`` does neither). The
    weights are float32, float64 for a float64 input (the JAX package
    runs without 64-bit mode)."""
    methods = ("nearest", "bilinear")
    enforce(method in methods, "interpolate method must be one of %s, got %s",
            sorted(methods), method)
    h, w = x.shape[2], x.shape[3]
    oh, ow = (int(s) for s in size)
    if method == "nearest":
        if oh != h:
            x = torch.index_select(x, 2, _nearest_index(h, oh, x.device))
        if ow != w:
            x = torch.index_select(x, 3, _nearest_index(w, ow, x.device))
        return x
    if not x.dtype.is_floating_point:
        x = x.to(torch.float32)
    wdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    if oh != h:
        wy = _resize_weights(h, oh, wdt, x.device).to(x.dtype)
        x = torch.einsum("nchw,hH->ncHw", x, wy)
    if ow != w:
        wx = _resize_weights(w, ow, wdt, x.device).to(x.dtype)
        x = torch.einsum("nchw,wW->nchW", x, wx)
    return x


def pixel_shuffle(x, upscale_factor: int):
    """reference: operators/pixel_shuffle_op.cc (NCHW)."""
    n, c, h, w = x.shape
    r = upscale_factor
    x = x.reshape(n, c // (r * r), r, r, h, w)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


def pad2d(x, paddings: Sequence[int], mode: str = "constant",
          value: float = 0.0):
    """reference: operators/pad2d_op.cc, NCHW, paddings [top, bottom,
    left, right]; ``mode`` constant, reflect or edge."""
    t, b, left, right = paddings
    cfg = (left, right, t, b)
    if mode == "constant":
        return F.pad(x, cfg, value=value)
    enforce(mode in ("reflect", "edge"),
            "pad2d mode must be constant|reflect|edge, got %s", mode)
    return F.pad(x, cfg, mode="reflect" if mode == "reflect" else "replicate")


def space_to_depth(x, blocksize: int):
    """reference: operators/space_to_depth_op.cc (NCHW)."""
    n, c, h, w = x.shape
    bs = blocksize
    x = x.reshape(n, c, h // bs, bs, w // bs, bs)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * bs * bs, h // bs, w // bs)


def shuffle_channel(x, group: int):
    """reference: operators/shuffle_channel_op.cc."""
    n, c, h, w = x.shape
    x = x.reshape(n, group, c // group, h, w)
    return x.transpose(1, 2).reshape(n, c, h, w)


def grid_sampler(x, grid):
    """reference: operators/grid_sampler_op.cc: bilinear samples of x
    (N, C, H, W) at grid (N, H', W', 2) in [-1, 1] (align-corners
    coordinates); corners outside the map count 0. Each corner's index
    is clipped into range before its gather, as in the JAX package."""
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    x1, y1 = x0 + 1, y0 + 1
    wx1, wy1 = gx - x0, gy - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = x.reshape(n, c, h * w)

    def gather(yy, xx):
        yy = torch.clamp(yy, 0, h - 1).long()
        xx = torch.clamp(xx, 0, w - 1).long()
        idx = (yy * w + xx).reshape(n, 1, -1).expand(n, c, -1)
        return torch.gather(flat, 2, idx).reshape(n, c, *gx.shape[1:])

    def inb(yy, xx):
        ok = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        return ok.to(x.dtype)[:, None]

    return (gather(y0, x0) * (wy0 * wx0)[:, None] * inb(y0, x0)
            + gather(y0, x1) * (wy0 * wx1)[:, None] * inb(y0, x1)
            + gather(y1, x0) * (wy1 * wx0)[:, None] * inb(y1, x0)
            + gather(y1, x1) * (wy1 * wx1)[:, None] * inb(y1, x1))


def temporal_shift(x, seg_num: int, shift_ratio: float = 0.25):
    """reference: operators/temporal_shift_op.cc: channels below c1 read
    step t - 1, channels c1..c2 step t + 1 (zero past either end)."""
    nt, c, h, w = x.shape
    n = nt // seg_num
    x = x.reshape(n, seg_num, c, h, w)
    c1 = int(c * shift_ratio)
    c2 = int(c * 2 * shift_ratio)
    prev = torch.cat([torch.zeros_like(x[:, :1, :c1]), x[:, :-1, :c1]], dim=1)
    nxt = torch.cat([x[:, 1:, c1:c2], torch.zeros_like(x[:, :1, c1:c2])],
                    dim=1)
    return torch.cat([prev, nxt, x[:, :, c2:]], dim=2).reshape(nt, c, h, w)
