"""Additional NN ops (counterpart of paddle_tpu/ops/nn_extra.py;
reference: paddle/fluid/operators/{pool_op.cc pool3d,
pool_with_index_op.cc, unpool_op.cc, spp_op.cc, affine_channel_op.cc,
affine_grid_op.cc, conv_transpose_op.cc conv3d/depthwise variants,
data_norm_op.cc, interpolate_op.cc bilinear/nearest, fsp_op.cc,
similarity_focus_op.cc, tree_conv_op.cc, cvm_op.cc, spectral_norm_op.cc}).

The pools with index keep the JAX package's reduction: a window's first
maximum in row-major order wins (strictly greater replaces), and a
window with no value above ``-inf`` gives index -1; their gradient is
the JAX package's custom one, the output cotangent scattered back to
the argmax positions (``unpool``, ``.at[].add``: an index -1 wraps to
the last position). The transposed convolutions are XLA's
``conv_transpose`` with an unflipped kernel, which is torch's with the
kernel flipped."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core.enforce import enforce
from .nn import _pair, interpolate, pool2d


def _triple(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


def _pads(p):
    """F.pad's order (last dim first) for symmetric per-dim pads ``p``."""
    out = []
    for pp in reversed(p):
        out += [pp, pp]
    return out


def pool3d(x, kernel_size, pool_type: str = "max", stride=None, padding=0,
           global_pooling: bool = False):
    """reference: operators/pool_op.cc (3D path). x: (N, C, D, H, W);
    max pads with -inf, average divides by the count of real entries."""
    if global_pooling:
        kernel_size = tuple(x.shape[2:5])
        padding = 0
        stride = kernel_size
    k = _triple(kernel_size)
    s = _triple(stride) if stride is not None else k
    p = _triple(padding)
    if pool_type == "max":
        fill = (float("-inf") if x.dtype.is_floating_point
                else torch.iinfo(x.dtype).min)
        return F.max_pool3d(F.pad(x, _pads(p), value=fill), k, s)
    enforce(pool_type == "avg", "pool_type must be max|avg, got %s",
            pool_type)
    summed = F.avg_pool3d(F.pad(x, _pads(p)), k, s, divisor_override=1)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    counts = F.avg_pool3d(F.pad(ones, _pads(p)), k, s, divisor_override=1)
    return summed / counts


def _windows(x, k, s, p):
    """(values, flat input indices) of every pooling window, each
    (N, C, *out, prod(k)): x padded with -inf, the index grid with -1."""
    nd = len(k)
    spatial = x.shape[2:]
    n_in = 1
    for d in spatial:
        n_in *= d
    idx = torch.arange(n_in, device=x.device).reshape((1, 1) + spatial)
    idx = idx.expand(x.shape)
    v = F.pad(x, _pads(p), value=float("-inf"))
    i = F.pad(idx, _pads(p), value=-1)
    for d in range(nd):
        v = v.unfold(2 + d, k[d], s[d])
        i = i.unfold(2 + d, k[d], s[d])
    lead = v.shape[:2 + nd]
    return v.reshape(lead + (-1,)), i.reshape(lead + (-1,))


def _pool_with_index(x, k, s, p):
    """(max, index) of every window: the first maximum, -1 for a window
    whose values are all -inf (the JAX package's strictly-greater
    reduction from (-inf, -1))."""
    vals, idx = _windows(x, k, s, p)
    best = vals.amax(dim=-1)
    first = torch.argmax((vals == best[..., None]).to(torch.uint8), dim=-1)
    arg = torch.gather(idx, -1, first[..., None])[..., 0]
    arg = torch.where(best > float("-inf"), arg, torch.full_like(arg, -1))
    return best, arg.to(torch.int32)


class _MaxPoolWithIndex(torch.autograd.Function):
    """The pools with index: forward as :func:`_pool_with_index`, backward
    the output cotangent scattered to the argmax positions
    (MaxPoolWithIndexGrad, the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, x, k, s, p):
        with torch.no_grad():
            out, idx = _pool_with_index(x, k, s, p)
        ctx.save_for_backward(idx)
        ctx.spatial = tuple(x.shape[2:])
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, g, _):
        idx, = ctx.saved_tensors
        return _scatter_add_flat(g, idx, ctx.spatial), None, None, None


def max_pool2d_with_index(x, kernel_size, stride=None, padding=0):
    """reference: operators/pool_with_index_op.cc: max pooling that also
    returns each window's flat (h * w) argmax, for unpool. x: (N, C, H,
    W) -> (out, indices int32)."""
    k = _pair(kernel_size)
    s = _pair(stride) if stride is not None else k
    return _MaxPoolWithIndex.apply(x, k, s, _pair(padding))


def max_pool3d_with_index(x, kernel_size, stride=None, padding=0):
    """reference: pool_with_index_op.cc 3D variant. x: (N, C, D, H, W)
    -> (out, flat d * h * w indices int32)."""
    k = _triple(kernel_size)
    s = _triple(stride) if stride is not None else k
    return _MaxPoolWithIndex.apply(x, k, s, _triple(padding))


def _scatter_add_flat(v, indices, spatial):
    """(N, C, *spatial) zeros with ``v`` added at the flat positions
    ``indices`` (both (N, C, ...)): ``.at[i].add`` per (n, c) plane, a
    negative index wrapping, one out of range dropped (sent to a spare
    slot past the end)."""
    n, c = v.shape[:2]
    size = 1
    for d in spatial:
        size *= d
    i = indices.reshape(n, c, -1).long()
    i = torch.where(i < 0, i + size, i)
    i = torch.where((i >= 0) & (i < size), i, torch.full_like(i, size))
    out = v.new_zeros((n, c, size + 1))
    out.scatter_add_(2, i, v.reshape(n, c, -1))
    return out[:, :, :size].reshape((n, c) + tuple(spatial))


def unpool(x, indices, output_size: Tuple[int, int]):
    """reference: operators/unpool_op.cc: pooled values scattered (added)
    back to their argmax positions. x, indices: (N, C, ph, pw); indices
    flat over the output's h * w."""
    return _scatter_add_flat(x, indices, tuple(output_size))


def spp(x, pyramid_height: int = 3, pool_type: str = "max"):
    """Spatial pyramid pooling (reference: operators/spp_op.cc): pooled
    to 1x1, 2x2, ..., flattened bins concatenated -> (N, C * sum(4^l))."""
    n, c, h, w = x.shape
    outs = []
    for level in range(pyramid_height):
        bins = 2 ** level
        kh, kw = -(-h // bins), -(-w // bins)
        sh, sw = h // bins, w // bins
        enforce(sh > 0 and sw > 0, "spp level %s too deep for input %sx%s",
                level, h, w)
        pooled = pool2d(x, (kh, kw), pool_type, stride=(sh, sw), padding=0,
                        ceil_mode=True)
        outs.append(pooled[:, :, :bins, :bins].reshape(n, -1))
    return torch.cat(outs, dim=1)


def affine_channel(x, scale, bias, data_layout: str = "NCHW"):
    """reference: operators/affine_channel_op.cc: per-channel
    ``x * scale + bias`` (the BatchNorm-folded inference form)."""
    axis = 1 if data_layout == "NCHW" else x.ndim - 1
    shape = tuple(x.shape[axis] if i == axis else 1 for i in range(x.ndim))
    return x * scale.reshape(shape) + bias.reshape(shape)


def affine_grid(theta, out_shape: Sequence[int]):
    """reference: operators/affine_grid_op.cc: the sampling grid of 2x3
    affine matrices theta (N, 2, 3) over out_shape (N, C, H, W) -> (N, H,
    W, 2) in [-1, 1] coordinates (pairs with grid_sampler)."""
    n, _, h, w = out_shape
    ys = torch.linspace(-1.0, 1.0, h, dtype=theta.dtype, device=theta.device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=theta.dtype, device=theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(
        1, h * w, 3).expand(n, h * w, 3)
    return torch.einsum("nhk,nck->nhc", base, theta).reshape(n, h, w, 2)


def conv3d_transpose(x, weight, stride=1, padding=0, bias=None):
    """reference: operators/conv_transpose_op.cc 3D. x: (N, Cin, D, H, W);
    weight: (Cin, Cout, kd, kh, kw); out = (in - 1) * s + k - 2p."""
    out = F.conv_transpose3d(x, torch.flip(weight, (2, 3, 4)),
                             stride=_triple(stride), padding=_triple(padding))
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1, 1)
    return out


def depthwise_conv2d_transpose(x, weight, stride=1, padding=0, bias=None):
    """reference: conv_transpose_op.cc depthwise variant. weight:
    (C, 1, kh, kw), one transposed convolution per channel."""
    out = F.conv_transpose2d(x, torch.flip(weight, (2, 3)),
                             stride=_pair(stride), padding=_pair(padding),
                             groups=x.shape[1])
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def data_norm(x, batch_size, batch_sum, batch_square_sum,
              epsilon: float = 1e-4):
    """reference: operators/data_norm_op.cc: CTR feature normalisation
    from accumulated (count, sum, sum of squares) statistics."""
    mean = batch_sum / batch_size
    var = batch_square_sum / batch_size - mean * mean
    return (x - mean) / torch.sqrt(var + epsilon)


def bilinear_interp(x, out_size: Sequence[int]):
    """reference: operators/interpolate_op.cc bilinear_interp."""
    return interpolate(x, tuple(out_size), method="bilinear")


def nearest_interp(x, out_size: Sequence[int]):
    """reference: operators/interpolate_op.cc nearest_interp."""
    return interpolate(x, tuple(out_size), method="nearest")


def fsp_matrix(x, y):
    """reference: operators/fsp_op.cc: the flow-of-solution-procedure
    matrix x (N, C1, H, W), y (N, C2, H, W) -> (N, C1, C2) = x.y^T / HW."""
    n, c1, h, w = x.shape
    return torch.einsum("nch,ndh->ncd", x.reshape(n, c1, h * w),
                        y.reshape(n, y.shape[1], h * w)) / (h * w)


def similarity_focus(x, axis: int, indexes: Sequence[int]):
    """reference: operators/similarity_focus_op.cc: for each selected
    slice along ``axis``, the (h, w) positions that are a maximum along
    either remaining dim, unioned over ``indexes``, as a 0/1 mask of x's
    shape. An index out of range reads a NaN slice (``jnp.take``), which
    marks nothing."""
    from .tensor import gather

    enforce(axis in (1, 2, 3), "axis must be 1|2|3, got %s", axis)
    mask = torch.zeros_like(x, dtype=torch.bool)
    for index in indexes:
        at = torch.full((1,), index, dtype=torch.long, device=x.device)
        sl = gather(x, at, axis=axis).squeeze(axis)
        m1 = sl == sl.amax(dim=1, keepdim=True)
        m2 = sl == sl.amax(dim=2, keepdim=True)
        mask = mask | (m1 | m2).unsqueeze(axis).expand(mask.shape)
    return mask.to(x.dtype)


def cvm(x, use_cvm: bool = True):
    """reference: operators/cvm_op.cc: the CTR show/click columns (the
    first two) become (log(show + 1), log(click + 1) - log(show + 1)),
    or are dropped without ``use_cvm``."""
    show = torch.log(x[:, 0:1] + 1.0)
    click = torch.log(x[:, 1:2] + 1.0) - show
    if use_cvm:
        return torch.cat([show, click, x[:, 2:]], dim=1)
    return x[:, 2:]


def tree_conv(nodes, edges, weight, max_depth: int = 2):
    """reference: operators/tree_conv_op.cc: nodes (N, F), edges (N, N)
    row-normalised adjacency, weight (max_depth + 1, F, Fout):
    out = sum_d (A^d nodes) W_d."""
    out = nodes @ weight[0]
    prop = nodes
    for d in range(1, max_depth + 1):
        prop = edges @ prop
        out = out + prop @ weight[d]
    return out


def adaptive_pool3d(x, output_size, pool_type: str = "avg"):
    """reference: operators/pool_op.cc adaptive path, 3D. x (N, C, D, H,
    W) -> (N, C, od, oh, ow); the sizes must divide."""
    od, oh, ow = ((output_size,) * 3 if isinstance(output_size, int)
                  else tuple(output_size))
    n, c, d, h, w = x.shape
    enforce(d % od == 0 and h % oh == 0 and w % ow == 0,
            "adaptive pool needs divisible sizes (%s,%s,%s)->(%s,%s,%s)",
            d, h, w, od, oh, ow)
    x = x.reshape(n, c, od, d // od, oh, h // oh, ow, w // ow)
    return x.mean(dim=(3, 5, 7)) if pool_type == "avg" \
        else x.amax(dim=(3, 5, 7))


def spectral_norm(weight, u, v, *, dim: int = 0, power_iters: int = 1,
                  eps: float = 1e-12):
    """Functional spectral normalisation (reference:
    operators/spectral_norm_op.cc): ``power_iters`` power iterations from
    (u, v), then (weight / sigma, new u, new v); the nn.SpectralNorm
    layer owns the u/v buffers."""
    h = weight.shape[dim]
    wmat = torch.movedim(weight, dim, 0).reshape(h, -1)
    u, v = u.to(wmat.dtype), v.to(wmat.dtype)
    for _ in range(power_iters):
        v = wmat.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wmat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ wmat @ v
    return weight / sigma, u, v


def image_resize_short(x, out_short_len: int, method: str = "bilinear"):
    """Resize so the short edge is ``out_short_len``, keeping the aspect
    ratio (reference: layers/nn.py image_resize_short)."""
    h, w = x.shape[-2], x.shape[-1]
    short = h if h < w else w
    scale = out_short_len / float(short)
    return interpolate(x, (int(round(h * scale)), int(round(w * scale))),
                       method=method)
