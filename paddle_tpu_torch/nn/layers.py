"""Layers of the port (counterpart of paddle_tpu/nn/layers.py):
Linear (with its ``act=``), Embedding, RMSNorm, LayerNorm, Dropout and
MultiHeadAttention (attention dropout and packed-row segment ids) with
its KV-cache decode mixin; the convolutional layers Conv2D,
Conv2DTranspose, Pool2D, BatchNorm, GroupNorm, PRelu and Flatten, the
activation layers ReLU, GELU, Sigmoid, Tanh and Softmax, the
recurrent GRUCell, LSTMCell and RNN (a cell over time),
BilinearTensorProduct, SpectralNorm and the SSD head MultiBoxHead
(``LayerList`` is re-exported, as the JAX module does).

Linear weights are (in, out), as in the JAX package, so parameters move
across by name without transposes. The JAX package returns new cache
arrays from every decode step; here caches and page pools are updated
IN PLACE (slice assignment / ``index_put_``) and the same tensors are
returned, so the call shapes stay those of the JAX methods."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .. import initializer as I
from ..core.dtypes import default_dtype, get_policy, to_dtype
from ..core.enforce import UnimplementedError, enforce
from ..core.places import resolve_device
from ..core.random import current_generator
from ..ops import math as OM
from ..ops import nn as ON
from ..ops.math import activation
from .layer import Layer, LayerList  # noqa: F401 - LayerList re-exported


def _apply_act(x, act: Optional[str]):
    """The activation named ``act`` (None = identity), resolved as the
    JAX package resolves it (``ops/math.py`` :func:`activation`); an
    unknown name raises :class:`InvalidArgumentError`."""
    if act is None:
        return x
    return activation(act)(x)


class Linear(Layer):
    """FC layer: ``act(x @ weight (+ bias))``, weight (in, out), under
    the current mixed-precision policy.
    ``weight_init``/``bias_init``: initializers of the port's
    ``initializer`` module (default XavierUniform and Constant(0))."""

    def __init__(self, in_features: int, out_features: int,
                 bias_attr: bool = True, act: Optional[str] = None,
                 weight_init=None, bias_init=None, dtype=None, *,
                 device=None, generator=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.act = act
        self.create_parameter("weight", (in_features, out_features), dtype,
                              weight_init or I.XavierUniform(),
                              device=device, generator=generator)
        self.has_bias = bias_attr
        if bias_attr:
            self.create_parameter("bias", (out_features,), dtype,
                                  bias_init or I.Constant(0.0),
                                  is_bias=True, device=device,
                                  generator=generator)

    def forward(self, x):
        # the policy's casts (core/dtypes.py): x, weight and bias to the
        # compute dtype, the product and bias add there, the result to
        # the output dtype before ``act``; the parameters stay masters
        pol = get_policy()
        out = torch.matmul(pol.cast_to_compute(x),
                           pol.cast_to_compute(self.weight))
        if self.has_bias:
            out = out + pol.cast_to_compute(self.bias)
        return _apply_act(pol.cast_to_output(out), self.act)


def _kernel(kernel_size):
    return ((kernel_size,) * 2 if isinstance(kernel_size, int)
            else tuple(kernel_size))


class Conv2D(Layer):
    """2-D convolution, weight OIHW (out, in / groups, kh, kw), default
    initializer MSRA(uniform=False), bias zeros, under the current
    mixed-precision policy as Linear is (x, weight and bias cast to the
    compute dtype, the result to the output dtype, then ``act``).
    ``data_format="NHWC"`` takes and returns NHWC activations (the weight
    stays OIHW); cuDNN then runs its channels-last kernels."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Sequence[int]], stride=1,
                 padding=0, dilation=1, groups: int = 1,
                 bias_attr: bool = True, act: Optional[str] = None,
                 weight_init=None, dtype=None, data_format: str = "NCHW", *,
                 device=None, generator=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.act = act
        self.data_format = data_format
        self.create_parameter(
            "weight", (out_channels, in_channels // groups)
            + _kernel(kernel_size), dtype,
            weight_init or I.MSRA(uniform=False), device=device,
            generator=generator)
        self.has_bias = bias_attr
        if bias_attr:
            self.create_parameter("bias", (out_channels,), dtype,
                                  I.Constant(0.0), is_bias=True,
                                  device=device, generator=generator)

    def forward(self, x):
        pol = get_policy()
        out = ON.conv2d(pol.cast_to_compute(x),
                        pol.cast_to_compute(self.weight), self.stride,
                        self.padding, self.dilation, self.groups,
                        data_format=self.data_format)
        if self.has_bias:
            bshape = ((1, -1, 1, 1) if self.data_format == "NCHW"
                      else (1, 1, 1, -1))
            out = out + pol.cast_to_compute(self.bias).reshape(bshape)
        return _apply_act(pol.cast_to_output(out), self.act)


class Conv2DTranspose(Layer):
    """NCHW transposed convolution, weight IOHW (in, out / groups, kh,
    kw), default initializer XavierUniform, under the mixed-precision
    policy as Conv2D."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 bias_attr: bool = True, act: Optional[str] = None,
                 dtype=None, *, device=None, generator=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.act = act
        self.create_parameter(
            "weight", (in_channels, out_channels // groups)
            + _kernel(kernel_size), dtype, I.XavierUniform(), device=device,
            generator=generator)
        self.has_bias = bias_attr
        if bias_attr:
            self.create_parameter("bias", (out_channels,), dtype,
                                  I.Constant(0.0), is_bias=True,
                                  device=device, generator=generator)

    def forward(self, x):
        pol = get_policy()
        out = ON.conv2d_transpose(pol.cast_to_compute(x),
                                  pol.cast_to_compute(self.weight),
                                  self.stride, self.padding,
                                  self.dilation, self.groups)
        if self.has_bias:
            out = out + pol.cast_to_compute(self.bias).reshape(1, -1, 1, 1)
        return _apply_act(pol.cast_to_output(out), self.act)


class Pool2D(Layer):
    """Max or average pooling (ops/nn.py :func:`pool2d`, the JAX
    package's ceil mode and padding)."""

    def __init__(self, kernel_size, pool_type: str = "max", stride=None,
                 padding=0, global_pooling: bool = False,
                 ceil_mode: bool = False, data_format: str = "NCHW"):
        super().__init__()
        self.kernel_size, self.pool_type = kernel_size, pool_type
        self.stride, self.padding = stride, padding
        self.global_pooling, self.ceil_mode = global_pooling, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return ON.pool2d(x, self.kernel_size, self.pool_type, self.stride,
                         self.padding, ceil_mode=self.ceil_mode,
                         global_pooling=self.global_pooling,
                         data_format=self.data_format)


class BatchNorm(Layer):
    """Batch normalisation with parameters ``weight`` (ones) and ``bias``
    (zeros) and the running statistics as float32 buffers ``mean``
    (zeros) and ``variance`` (ones), the JAX package's names, so the
    Trainer's state and checkpoints carry them by name. In training the
    batch's statistics normalise and the buffers move as
    ``momentum * old + (1 - momentum) * batch`` (biased variance), in
    place; in eval mode the buffers normalise. No policy cast, as in the
    JAX package."""

    def __init__(self, num_channels: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, act: Optional[str] = None,
                 data_layout: str = "NCHW", dtype=None, *, device=None,
                 generator=None):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.act, self.data_layout = act, data_layout
        self.create_parameter("weight", (num_channels,), dtype,
                              I.Constant(1.0), device=device,
                              generator=generator)
        self.create_parameter("bias", (num_channels,), dtype,
                              I.Constant(0.0), is_bias=True, device=device,
                              generator=generator)
        device = resolve_device(device)
        self.register_buffer("mean", torch.zeros(
            (num_channels,), dtype=torch.float32, device=device))
        self.register_buffer("variance", torch.ones(
            (num_channels,), dtype=torch.float32, device=device))

    def forward(self, x):
        y, new_mean, new_var = ON.batch_norm(
            x, self.weight, self.bias, self.mean, self.variance,
            training=self.training, momentum=self.momentum,
            epsilon=self.epsilon, data_layout=self.data_layout)
        if self.training:
            with torch.no_grad():
                self.mean.copy_(new_mean)
                self.variance.copy_(new_var)
        return _apply_act(y, self.act)


class GroupNorm(Layer):
    """Group normalisation over axis 1, parameters ``weight`` (ones) and
    ``bias`` (zeros)."""

    def __init__(self, num_groups: int, num_channels: int,
                 epsilon: float = 1e-5, dtype=None, *, device=None,
                 generator=None):
        super().__init__()
        self.num_groups, self.epsilon = num_groups, epsilon
        self.create_parameter("weight", (num_channels,), dtype,
                              I.Constant(1.0), device=device,
                              generator=generator)
        self.create_parameter("bias", (num_channels,), dtype,
                              I.Constant(0.0), is_bias=True, device=device,
                              generator=generator)

    def forward(self, x):
        return ON.group_norm(x, self.weight, self.bias,
                             groups=self.num_groups, epsilon=self.epsilon)


class PRelu(Layer):
    """Parametric ReLU, ``alpha`` (1,) for ``mode="all"``, (channel,)
    otherwise, initialised to ``init``."""

    def __init__(self, mode: str = "all", channel: Optional[int] = None,
                 init: float = 0.25, dtype=None, *, device=None,
                 generator=None):
        super().__init__()
        self.mode = mode
        shape = (1,) if mode == "all" else (channel,)
        self.create_parameter("alpha", shape, dtype, I.Constant(init),
                              device=device, generator=generator)

    def forward(self, x):
        return OM.prelu(x, self.alpha, self.mode)


class BilinearTensorProduct(Layer):
    """``out[b, k] = x[b] @ weight[k] @ y[b] (+ bias[k])``, weight
    (out, in1, in2) from XavierUniform, bias zeros (ops/math.py
    :func:`bilinear_tensor_product`; reference: dygraph/nn.py
    BilinearTensorProduct)."""

    def __init__(self, in1_features: int, in2_features: int,
                 out_features: int, bias_attr: bool = True, dtype=None, *,
                 device=None, generator=None):
        super().__init__()
        self.create_parameter("weight",
                              (out_features, in1_features, in2_features),
                              dtype, I.XavierUniform(), device=device,
                              generator=generator)
        self.has_bias = bias_attr
        if bias_attr:
            self.create_parameter("bias", (out_features,), dtype,
                                  I.Constant(0.0), is_bias=True,
                                  device=device, generator=generator)

    def forward(self, x, y):
        return OM.bilinear_tensor_product(
            x, y, self.weight, self.bias if self.has_bias else None)


class SpectralNorm(Layer):
    """Power-iteration weight normalisation (reference: dygraph/nn.py
    SpectralNorm; ops/nn_extra.py :func:`spectral_norm`): ``forward(
    weight)`` is weight / sigma. The u (h,) and v (w,) vectors are
    float32 buffers, the JAX package's names, drawn from a standard
    normal keyed by ``make_key(0)`` and ``make_key(1)`` (the JAX
    package's keys; the draws match in distribution); a training forward
    moves them to the iteration's result."""

    def __init__(self, weight_shape, dim: int = 0, power_iters: int = 1,
                 eps: float = 1e-12, dtype=None, *, device=None):
        from ..core.random import make_key, seed_generator

        super().__init__()
        self.dim, self.power_iters, self.eps = dim, power_iters, eps
        device = resolve_device(device)
        h = weight_shape[dim]
        w = 1
        for d in weight_shape:
            w *= d
        w //= h
        for name, size, seed in (("u", h, 0), ("v", w, 1)):
            gen = seed_generator(torch.Generator(device=device),
                                 make_key(seed))
            self.register_buffer(name, torch.randn(
                (size,), generator=gen, dtype=torch.float32, device=device))

    def forward(self, weight):
        from ..ops.nn_extra import spectral_norm

        out, u, v = spectral_norm(weight, self.u, self.v, dim=self.dim,
                                  power_iters=self.power_iters,
                                  eps=self.eps)
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
                self.v.copy_(v)
        return out


class RMSNorm(Layer):
    def __init__(self, dim: int, epsilon: float = 1e-6, dtype=None, *,
                 device=None, generator=None):
        super().__init__()
        self.epsilon = epsilon
        self.create_parameter("weight", (dim,), dtype, I.Constant(1.0),
                              device=device, generator=generator)

    def forward(self, x):
        return ON.rms_norm(x, self.weight, epsilon=self.epsilon)


class Embedding(Layer):
    """Lookup table (num_embeddings, embedding_dim); ``weight_init``
    defaults to XavierNormal.

    ``is_sparse=True`` marks the table for row-sparse updates: inside a
    step of :func:`paddle_tpu_torch.optimizer.sparse.sparse_minimize_fn`
    the layer gathers its rows off the graph (``jnp.take``'s semantics,
    ops/nn.py :func:`embedding`), records them as a leaf that requires
    grad, and returns them (``padding_idx`` rows as zeros), so the step
    differentiates with respect to the rows, not the table (see
    nn/sparse.py). Outside such a step the flag is inert."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, weight_init=None,
                 dtype=None, is_sparse: bool = False, *, device=None,
                 generator=None):
        super().__init__()
        self.padding_idx = padding_idx
        self.is_sparse = is_sparse
        self.create_parameter("weight", (num_embeddings, embedding_dim),
                              dtype, weight_init or I.XavierNormal(),
                              device=device, generator=generator)

    def forward(self, ids):
        from .sparse import Capture, active

        ctx = active()
        if ctx is not None and ctx.handles(self):
            if isinstance(ctx, Capture):
                with torch.no_grad():
                    rows = ON.embedding(ids, self.weight)
                ctx.record(self, ids, rows.requires_grad_())
            else:
                rows = ctx.pop(self)
            if self.padding_idx is not None:
                rows = torch.where((ids == self.padding_idx)[..., None],
                                   0.0, rows)
            return rows
        return ON.embedding(ids, self.weight, self.padding_idx)


class LayerNorm(Layer):
    """Layer normalisation over the trailing ``normalized_shape`` dims,
    with the JAX package's parameters ``weight`` (ones) and ``bias``
    (zeros); ``scale``/``shift`` False leave either out."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 scale: bool = True, shift: bool = True, dtype=None, *,
                 device=None, generator=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.has_scale, self.has_shift = scale, shift
        if scale:
            self.create_parameter("weight", self.normalized_shape, dtype,
                                  I.Constant(1.0), device=device,
                                  generator=generator)
        if shift:
            self.create_parameter("bias", self.normalized_shape, dtype,
                                  I.Constant(0.0), is_bias=True,
                                  device=device, generator=generator)

    def forward(self, x):
        begin = x.ndim - len(self.normalized_shape)
        return ON.layer_norm(
            x, self.weight if self.has_scale else None,
            self.bias if self.has_shift else None,
            begin_norm_axis=begin, epsilon=self.epsilon)


class Dropout(Layer):
    """Dropout (ops/nn.py :func:`dropout`): the identity in eval mode or
    at p == 0, except that ``mode="downgrade_in_infer"`` scales by 1 - p
    in eval mode. In training its mask is drawn from the current
    generator (core/random.py :func:`rng_scope`, which
    ``Trainer.train_step`` opens); with none, a training forward raises
    :class:`EnforceError`."""

    def __init__(self, p: float = 0.5, mode: str = "upscale_in_train"):
        super().__init__()
        enforce(mode in ("upscale_in_train", "downgrade_in_infer"),
                "Dropout mode must be upscale_in_train or "
                "downgrade_in_infer, got %s", mode)
        self.p, self.mode = p, mode

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return ON.dropout(x, self.p, training=False, mode=self.mode)
        return ON.dropout(x, self.p, current_generator(), training=True,
                          mode=self.mode)


class _MHADecodeMixin:
    """Incremental-decode pieces for MultiHeadAttention (KV cache)."""

    def cache_home(self):
        """(dtype, device) of the K/V the layer caches: the K
        projection's floating-point weight's, or the default dtype on its
        device when the weight is stored otherwise (W8A16's int8)."""
        w = next(iter(self.k_proj.state_dict(keep_vars=True).values()))
        return (w.dtype if w.is_floating_point() else default_dtype(),
                w.device)

    def init_cache(self, batch: int, capacity: int, dtype=None):
        """Zeroed (B, capacity, h_kv, hd) K and V caches on the layer's
        device, in the projection dtype unless ``dtype`` is given."""
        dt, dev = self.cache_home()
        dt = to_dtype(dtype) if dtype is not None else dt
        shape = (batch, capacity, self.num_kv_heads, self.head_dim)
        return (torch.zeros(shape, dtype=dt, device=dev),
                torch.zeros(shape, dtype=dt, device=dev))

    def project_kv(self, key, value=None):
        value = key if value is None else value
        b, tk, _ = key.shape
        k = self.k_proj(key).reshape(b, tk, self.num_kv_heads, self.head_dim)
        v = self.v_proj(value).reshape(b, tk, self.num_kv_heads,
                                       self.head_dim)
        return k, v

    def attend_kv(self, query, k, v, attn_mask=None, q_positions=None,
                  decode_t=None, window=None):
        """Attention of ``query`` (B, Tq, D) against pre-projected k/v.
        ``q_positions``: the absolute positions rotary queries rotate by
        (the cached K was rotated when it was written). ``decode_t``
        (with one query per row): the cache cursors, a scalar or (B,);
        then the decode wrapper runs, whatever the shape, and applies the
        ``pos <= decode_t`` (and ``window``) mask itself (on the card it
        launches the kernel or raises). Otherwise attention runs under
        ``attn_mask`` (callers pass both, as in the JAX package)."""
        from ..ops.attention import (rotary_embedding,
                                     scaled_dot_product_attention)
        from ..ops.kernels.decode_attention import decode_attention

        b, tq, d = query.shape
        q = self.q_proj(query).reshape(b, tq, self.num_heads, self.head_dim)
        if q_positions is not None:
            q = rotary_embedding(q, q_positions, theta=self.rotary_theta)
        if decode_t is not None and tq == 1 and self.use_flash:
            out = decode_attention(q, k, v, decode_t, window=window)
        else:
            out = scaled_dot_product_attention(q, k, v, mask=attn_mask,
                                               use_flash=self.use_flash)
        return self.out_proj(out.reshape(b, tq, d))

    def forward_chunk(self, x_chunk, cache_k, cache_v, t0, window=None,
                      decode_kernel: bool = False):
        """S positions in one call: write the chunk's K/V into the caches
        at [t0, t0+S) (in place) and attend position i over cache
        positions <= t0+i. The write start clamps to cap-S, as JAX's
        dynamic_update_slice does. Returns (out, cache_k, cache_v)."""
        from ..ops.attention import cache_keep_mask

        b, s, _ = x_chunk.shape
        cap = cache_k.shape[1]
        t0 = int(t0)
        # one positions array for the k rotation here, and the q rotation
        # and the mask in attend_kv — they must never desynchronize
        pos_chunk = t0 + torch.arange(s, dtype=torch.int32,
                                      device=x_chunk.device)
        k_c, v_c = self._project_kv_t(x_chunk, pos_chunk)
        start = min(max(t0, 0), cap - s)
        cache_k[:, start:start + s] = k_c.to(cache_k.dtype)
        cache_v[:, start:start + s] = v_c.to(cache_v.dtype)
        # the decode wrapper masks by its cursor: it needs no keep-mask
        decode = decode_kernel and s == 1 and self.use_flash
        out = self.attend_kv(
            x_chunk, cache_k, cache_v,
            attn_mask=None if decode else cache_keep_mask(pos_chunk, cap,
                                                          window),
            q_positions=pos_chunk if self.rotary else None,
            decode_t=t0 if decode else None, window=window)
        return out, cache_k, cache_v

    def _project_kv_t(self, x_t, positions):
        """Project (and rotate) K/V: x_t (B, S, D) -> (B, S, kv_heads,
        head_dim) each; ``positions`` (S,) or (B, S)."""
        b, s, _ = x_t.shape
        k_t = self.k_proj(x_t).reshape(b, s, self.num_kv_heads,
                                       self.head_dim)
        v_t = self.v_proj(x_t).reshape(b, s, self.num_kv_heads,
                                       self.head_dim)
        if self.rotary:
            from ..ops.attention import rotary_embedding

            k_t = rotary_embedding(k_t, positions, theta=self.rotary_theta)
        return k_t, v_t

    def forward_step_paged(self, x_t, kpool, vpool, table, t_rows,
                           window=None):
        """One decode position per row against a paged cache: project and
        rotate this position's K/V, write it into each row's page at its
        logical cursor (in place; out-of-range cursors drop), attend over
        the row's pages. ``x_t``: (B, 1, D); returns (out, kpool,
        vpool)."""
        from ..ops import paged_kv

        pos_rows = t_rows.to(torch.int32)[:, None]            # (B, 1)
        k_t, v_t = self._project_kv_t(x_t, pos_rows)
        paged_kv.write_rows(kpool, vpool, table, pos_rows[:, 0], k_t, v_t,
                            kpool.shape[1])
        out = paged_kv.attend(self._rotated_q(x_t, pos_rows), kpool, vpool,
                              table, pos_rows[:, 0], window=window)
        b, tq, d = x_t.shape
        return self.out_proj(out.reshape(b, tq, d)), kpool, vpool

    def forward_chunk_paged(self, x_chunk, kpool, vpool, table_row, t0,
                            window=None):
        """S prefill positions for one row (batch 1) against the paged
        cache: chunk-write (in place), then attend position i over the
        pages up to t0+i on the plain path. ``x_chunk``: (1, S, D)."""
        from ..ops import paged_kv
        from ..ops.attention import (cache_keep_mask,
                                     scaled_dot_product_attention)

        b, s, d = x_chunk.shape
        t0 = int(t0)
        pos_chunk = t0 + torch.arange(s, dtype=torch.int32,
                                      device=x_chunk.device)
        k_c, v_c = self._project_kv_t(x_chunk, pos_chunk)
        paged_kv.write_chunk(kpool, vpool, table_row, t0, k_c, v_c,
                             kpool.shape[1])
        # gather only the live page columns [0, t0+S)
        k = paged_kv.gather_rows(kpool, table_row[None], upto=t0 + s)
        v = paged_kv.gather_rows(vpool, table_row[None], upto=t0 + s)
        out = scaled_dot_product_attention(
            self._rotated_q(x_chunk, pos_chunk), k, v,
            mask=cache_keep_mask(pos_chunk, k.shape[1], window),
            use_flash=False)
        return self.out_proj(out.reshape(b, s, d)), kpool, vpool

    def _rotated_q(self, query, positions):
        """Projected (and rotated) q for the paged paths."""
        from ..ops.attention import rotary_embedding

        b, tq, _ = query.shape
        q = self.q_proj(query).reshape(b, tq, self.num_heads, self.head_dim)
        if self.rotary:
            q = rotary_embedding(q, positions, theta=self.rotary_theta)
        return q

    def forward_step(self, x_t, cache_k, cache_v, t, window=None,
                     decode_kernel: bool = False):
        """One decode step (``x_t``: (B, 1, D)) — forward_chunk S=1."""
        return self.forward_chunk(x_t, cache_k, cache_v, t, window=window,
                                  decode_kernel=decode_kernel)

    def forward_step_rows(self, x_t, cache_k, cache_v, t_rows,
                          window=None, decode_kernel: bool = False):
        """One decode position per row at per-row cursors ``t_rows``
        (B,) — the continuous-batching step. Each row's K/V lands at its
        own index (in place; the index clamps to [0, cap-1] as JAX's
        per-row dynamic_update_slice does). ``x_t``: (B, 1, D)."""
        from ..ops.attention import cache_keep_mask

        b = x_t.shape[0]
        cap = cache_k.shape[1]
        pos_rows = t_rows.to(torch.int32)[:, None]            # (B, 1)
        k_t, v_t = self._project_kv_t(x_t, pos_rows)
        rows = torch.arange(b, device=x_t.device)
        idx = pos_rows[:, 0].long().clamp(0, cap - 1)
        cache_k[rows, idx] = k_t[:, 0].to(cache_k.dtype)
        cache_v[rows, idx] = v_t[:, 0].to(cache_v.dtype)
        decode = decode_kernel and self.use_flash
        out = self.attend_kv(
            x_t, cache_k, cache_v,
            attn_mask=None if decode else cache_keep_mask(pos_rows, cap,
                                                          window),
            q_positions=pos_rows if self.rotary else None,
            decode_t=pos_rows[:, 0] if decode else None, window=window)
        return out, cache_k, cache_v

    def forward_chunk_rows(self, x_chunk, cache_k, cache_v, t0_rows,
                           window=None):
        """S positions per row at per-row chunk starts ``t0_rows`` (B,),
        the speculative verify chunk over an arena (each slot scores its
        candidates at its own cursor): row b's chunk lands at
        [t0_b, t0_b+S) (in place; the start clamps to [0, cap-S], as
        JAX's per-row dynamic_update_slice does) and position i attends
        cache positions <= t0_b+i on the masked plain path.
        ``x_chunk``: (B, S, D); returns (out, cache_k, cache_v)."""
        from ..ops.attention import cache_keep_mask

        b, s, _ = x_chunk.shape
        cap = cache_k.shape[1]
        steps = torch.arange(s, dtype=torch.int32, device=x_chunk.device)
        pos_chunk = t0_rows.to(torch.int32)[:, None] + steps[None, :]
        k_c, v_c = self._project_kv_t(x_chunk, pos_chunk)
        start = t0_rows.long().clamp(0, cap - s)
        rows = torch.arange(b, device=x_chunk.device)[:, None]
        idx = start[:, None] + steps.long()[None, :]
        cache_k[rows, idx] = k_c.to(cache_k.dtype)
        cache_v[rows, idx] = v_c.to(cache_v.dtype)
        out = self.attend_kv(
            x_chunk, cache_k, cache_v,
            attn_mask=cache_keep_mask(pos_chunk, cap, window),
            q_positions=pos_chunk if self.rotary else None, window=window)
        return out, cache_k, cache_v

    def forward_chunk_paged_rows(self, x_chunk, kpool, vpool, table,
                                 t0_rows, window=None):
        """S positions per row against the paged cache at per-row chunk
        starts (the paged arena's speculative verify chunk): every row's
        candidates are written at its own logical offset (in place;
        parked rows drop), then attend over the row's gathered pages on
        the masked plain path (S is gamma+1, small; the paged decode
        kernel stays the S=1 path). ``x_chunk``: (B, S, D)."""
        from ..ops import paged_kv
        from ..ops.attention import (cache_keep_mask,
                                     scaled_dot_product_attention)

        b, s, d = x_chunk.shape
        steps = torch.arange(s, dtype=torch.int32, device=x_chunk.device)
        pos_chunk = t0_rows.to(torch.int32)[:, None] + steps[None, :]
        k_c, v_c = self._project_kv_t(x_chunk, pos_chunk)
        paged_kv.write_chunk_rows(kpool, vpool, table, t0_rows, k_c, v_c,
                                  kpool.shape[1])
        k = paged_kv.gather_rows(kpool, table)
        v = paged_kv.gather_rows(vpool, table)
        out = scaled_dot_product_attention(
            self._rotated_q(x_chunk, pos_chunk), k, v,
            mask=cache_keep_mask(pos_chunk, k.shape[1], window),
            use_flash=False)
        return self.out_proj(out.reshape(b, s, d)), kpool, vpool


class MultiHeadAttention(_MHADecodeMixin, Layer):
    """Transformer attention with GQA and rotary embeddings."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = True, use_flash: bool = True,
                 seq_parallel: Optional[str] = None, dtype=None,
                 num_kv_heads: Optional[int] = None,
                 rotary: bool = False, rotary_theta: float = 10000.0, *,
                 device=None, generator=None):
        super().__init__()
        if seq_parallel is not None:
            raise UnimplementedError(
                f"MultiHeadAttention seq_parallel={seq_parallel!r} (context "
                "parallelism) is not ported yet: ROADMAP queue 1 item 11 "
                "(distributed)")
        self.seq_parallel = seq_parallel
        enforce(embed_dim % num_heads == 0,
                "embed_dim %s not divisible by heads %s", embed_dim,
                num_heads)
        device = resolve_device(device)
        self.rotary = rotary
        self.rotary_theta = float(rotary_theta)
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        enforce(num_heads % self.num_kv_heads == 0,
                "num_heads %s not divisible by num_kv_heads %s",
                num_heads, self.num_kv_heads)
        self.dropout_p = dropout
        self.use_flash = use_flash
        kv_dim = self.num_kv_heads * self.head_dim
        kw = dict(bias_attr=bias, dtype=dtype, device=device,
                  generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(embed_dim, kv_dim, **kw)
        self.v_proj = Linear(embed_dim, kv_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def forward(self, query, key=None, value=None, attn_mask=None,
                causal: bool = False, segment_ids=None,
                window: Optional[int] = None):
        from ..ops.attention import (rotary_embedding,
                                     scaled_dot_product_attention)

        key = query if key is None else key
        value = key if value is None else value
        b, tq, d = query.shape
        tk = key.shape[1]
        q = self.q_proj(query).reshape(b, tq, self.num_heads, self.head_dim)
        k, v = self.project_kv(key, value)
        if self.rotary:
            enforce(tk == tq, "rotary MHA is self-attention shaped "
                    "(tq=%s != tk=%s)", tq, tk)
            pos = torch.arange(tq, device=query.device)
            q = rotary_embedding(q, pos, theta=self.rotary_theta)
            k = rotary_embedding(k, pos, theta=self.rotary_theta)
        dropping = self.training and self.dropout_p > 0
        out = scaled_dot_product_attention(
            q, k, v, mask=attn_mask, causal=causal,
            dropout_p=self.dropout_p if dropping else 0.0,
            dropout_key=current_generator() if dropping else None,
            use_flash=self.use_flash, segment_ids=segment_ids,
            window=window)
        return self.out_proj(out.reshape(b, tq, d))


class ReLU(Layer):
    def forward(self, x):
        return OM.relu(x)


class GELU(Layer):
    def __init__(self, approximate: bool = False):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return OM.gelu(x, self.approximate)


class Sigmoid(Layer):
    def forward(self, x):
        return OM.sigmoid(x)


class Tanh(Layer):
    def forward(self, x):
        return OM.tanh(x)


class Softmax(Layer):
    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return ON.softmax(x, self.axis)


class Flatten(Layer):
    """Collapse to 2-D at ``start_axis`` (ops/tensor.py :func:`flatten`)."""

    def __init__(self, start_axis: int = 1):
        super().__init__()
        self.start_axis = start_axis

    def forward(self, x):
        from ..ops.tensor import flatten

        return flatten(x, self.start_axis)


class GRUCell(Layer):
    """One GRU step (reference: dygraph/nn.py GRUUnit):
    ``forward(x, h) -> (new_h, new_h)``, gates r, z, n with z * h +
    (1 - z) * n, parameters ``w_ih`` (in, 3H), ``w_hh`` (H, 3H),
    ``bias`` (3H,)."""

    def __init__(self, input_size: int, hidden_size: int, dtype=None, *,
                 device=None, generator=None):
        super().__init__()
        self.hidden_size = hidden_size
        kw = dict(device=device, generator=generator)
        self.create_parameter("w_ih", (input_size, 3 * hidden_size), dtype,
                              I.XavierUniform(), **kw)
        self.create_parameter("w_hh", (hidden_size, 3 * hidden_size), dtype,
                              I.XavierUniform(), **kw)
        self.create_parameter("bias", (3 * hidden_size,), dtype,
                              I.Constant(0.0), is_bias=True, **kw)

    def forward(self, x, h):
        gates = x @ self.w_ih + self.bias
        hh = h @ self.w_hh
        hs = self.hidden_size
        r = torch.sigmoid(gates[..., :hs] + hh[..., :hs])
        z = torch.sigmoid(gates[..., hs:2 * hs] + hh[..., hs:2 * hs])
        n = torch.tanh(gates[..., 2 * hs:] + r * hh[..., 2 * hs:])
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h


class LSTMCell(Layer):
    """One LSTM step: ``forward(x, (h, c)) -> (new_h, (new_h, new_c))``,
    gates i, f, g, o, ``forget_bias`` added to f before its sigmoid;
    parameters ``w_ih`` (in, 4H), ``w_hh`` (H, 4H), ``bias`` (4H,)."""

    def __init__(self, input_size: int, hidden_size: int,
                 forget_bias: float = 1.0, dtype=None, *, device=None,
                 generator=None):
        super().__init__()
        self.hidden_size, self.forget_bias = hidden_size, forget_bias
        kw = dict(device=device, generator=generator)
        self.create_parameter("w_ih", (input_size, 4 * hidden_size), dtype,
                              I.XavierUniform(), **kw)
        self.create_parameter("w_hh", (hidden_size, 4 * hidden_size), dtype,
                              I.XavierUniform(), **kw)
        self.create_parameter("bias", (4 * hidden_size,), dtype,
                              I.Constant(0.0), is_bias=True, **kw)

    def forward(self, x, state):
        h, c = state
        gates = x @ self.w_ih + h @ self.w_hh + self.bias
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        new_c = (torch.sigmoid(f + self.forget_bias) * c
                 + torch.sigmoid(i) * torch.tanh(g))
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return new_h, (new_h, new_c)


class RNN(Layer):
    """A cell run over time (the reference's recurrent_op / DynamicRNN on
    padded batches): ``forward(x, initial_state, lengths=None) -> (outs,
    final_state)``; with ``lengths`` a padded step freezes the state
    and outputs zeros. ``time_major``: x is (T, B, ...)."""

    def __init__(self, cell: Layer, time_major: bool = False):
        super().__init__()
        self.cell = cell
        self.time_major = time_major

    def forward(self, x, initial_state, lengths=None):
        from ..ops.rnn import dynamic_rnn

        if self.time_major:
            x = x.transpose(0, 1)
        outs, final = dynamic_rnn(self.cell, x, initial_state, lengths)
        if self.time_major:
            outs = outs.transpose(0, 1)
        return outs, final


class MultiBoxHead(Layer):
    """SSD detection head over several feature maps (reference:
    python/paddle/fluid/layers/detection.py multi_box_head): per map a
    3x3 conv predicts box deltas (4A channels) and class logits (CA
    channels), and ops/detection.py :func:`prior_box` gives its priors.

    ``in_channels``: each input map's channel count. Without
    ``min_sizes`` the sizes follow fluid's derivation from ``min_ratio``
    and ``max_ratio``; an entry of ``max_sizes`` may be empty (that map
    has no max-size prior). Parameters ``loc_convs.<i>.weight`` /
    ``.bias`` and ``conf_convs.<i>.*``, created in the JAX package's
    order (map by map, loc then conf), so a state crosses by name.
    ``forward(inputs)`` -> (locations (N, P, 4), confidences (N, P,
    num_classes), priors (P, 4), variances (P, 4)); the priors are made
    on the inputs' device, float64 for float64 inputs and float32
    otherwise, once per map size (they hold no state of the weights)."""

    def __init__(self, in_channels: Sequence[int], image_size,
                 num_classes: int, *, base_size: Optional[int] = None,
                 aspect_ratios: Sequence[Sequence[float]] = (),
                 min_ratio: int = 20, max_ratio: int = 90,
                 min_sizes: Optional[Sequence[float]] = None,
                 max_sizes: Optional[Sequence[float]] = None,
                 steps: Optional[Sequence[float]] = None,
                 variances: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 flip: bool = True, clip: bool = False,
                 offset: float = 0.5, dtype=None, device=None,
                 generator=None):
        import math

        from ..ops import detection as D

        super().__init__()
        n_maps = len(in_channels)
        self.image_size = ((image_size, image_size)
                           if isinstance(image_size, int) else
                           tuple(image_size))
        base = base_size or self.image_size[0]
        if min_sizes is None:
            # fluid's derivation: the first map at 10% of the base, the
            # rest spread from min_ratio to max_ratio
            min_sizes, max_sizes = [base * 0.1], [base * 0.2]
            if n_maps > 1:
                step = int(math.floor((max_ratio - min_ratio)
                                      / max(n_maps - 2, 1)))
                for r in range(min_ratio, max_ratio + 1, max(step, 1)):
                    min_sizes.append(base * r / 100.0)
                    max_sizes.append(base * (r + step) / 100.0)
                min_sizes = min_sizes[:n_maps]
                max_sizes = max_sizes[:n_maps]
        self.min_sizes = [([s] if not isinstance(s, (list, tuple)) else
                           list(s)) for s in min_sizes]
        self.max_sizes = [([s] if not isinstance(s, (list, tuple)) else
                           list(s)) for s in (max_sizes or [])]
        if not aspect_ratios:
            aspect_ratios = [[2.0]] * n_maps
        self.aspect_ratios = [list(a) for a in aspect_ratios]
        self.steps = steps
        self.variances = tuple(variances)
        self.flip, self.clip, self.offset = flip, clip, offset
        self.num_classes = num_classes
        self.num_priors = []
        self._prior_cache = {}
        self.loc_convs = LayerList()
        self.conf_convs = LayerList()
        for i, c_in in enumerate(in_channels):
            a = D.prior_box_count(
                self.min_sizes[i],
                self.max_sizes[i] if self.max_sizes else (),
                self.aspect_ratios[i], flip)
            self.num_priors.append(a)
            self.loc_convs.append(Conv2D(c_in, a * 4, 3, padding=1,
                                         dtype=dtype, device=device,
                                         generator=generator))
            self.conf_convs.append(Conv2D(c_in, a * num_classes, 3,
                                          padding=1, dtype=dtype,
                                          device=device,
                                          generator=generator))

    def _priors(self, i: int, h: int, w: int, x):
        """Map ``i``'s (H*W*A, 4) priors and variances. They depend on the
        configuration and the map's size only, so each (map, size,
        dtype, device) is made once and kept."""
        from ..ops import detection as D

        dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
        key = (i, h, w, dtype, x.device)
        if key not in self._prior_cache:
            step = ((self.steps[i], self.steps[i])
                    if self.steps else (0.0, 0.0))
            b, v = D.prior_box(
                (h, w), self.image_size, self.min_sizes[i],
                self.max_sizes[i] if self.max_sizes else (),
                self.aspect_ratios[i], variances=self.variances,
                flip=self.flip, clip=self.clip, step=step,
                offset=self.offset, dtype=dtype, device=x.device)
            self._prior_cache[key] = (b.reshape(-1, 4), v.reshape(-1, 4))
        return self._prior_cache[key]

    def forward(self, inputs):
        locs, confs, boxes, variances = [], [], [], []
        for i, x in enumerate(inputs):
            n, _, h, w = x.shape
            loc = self.loc_convs[i](x)                    # (N, 4A, H, W)
            conf = self.conf_convs[i](x)                  # (N, CA, H, W)
            locs.append(loc.permute(0, 2, 3, 1).reshape(n, -1, 4))
            confs.append(conf.permute(0, 2, 3, 1).reshape(
                n, -1, self.num_classes))
            b, v = self._priors(i, h, w, x)
            boxes.append(b)
            variances.append(v)
        return (torch.cat(locs, 1), torch.cat(confs, 1),
                torch.cat(boxes, 0), torch.cat(variances, 0))
