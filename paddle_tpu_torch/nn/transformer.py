"""Transformer layers (counterpart of paddle_tpu/nn/transformer.py): the
position-wise FFN, the encoder and decoder blocks in their post-norm
(BERT) and pre-norm forms, the two stacks, the sinusoidal and learned
position signals, and the cached decode step of a decoder block; the
encoder's FFN may be the Switch-MoE FFN of nn/moe.py.

Parameter names are the JAX package's (``layers.<i>.self_attn.q_proj``,
``ffn.fc1``, ``norm1``, ...), so weights cross with
utils/convert.load_numpy_state. Training-mode dropout draws from the
current generator (core/random.py ``rng_scope``); attention dropout
runs inside the flash kernels, cross-attention's too (query and memory
lengths may differ; the memory's padding rides as the kernels'
key-padding mask)."""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from ..core.enforce import InvalidArgumentError, enforce
from ..core.places import resolve_device
from .layer import Layer, LayerList, remat_call, use, weight_placed
from .layers import Dropout, Embedding, LayerNorm, Linear, MultiHeadAttention
from .moe import SwitchFFN, not_recording


class FeedForward(Layer):
    """Position-wise FFN: Linear -> act -> dropout -> Linear. Under a
    sharding plan that places ``fc1`` column-parallel and ``fc2``
    row-parallel (``transformer_tp_rules``), the rank computes its
    columns of the hidden layer and one sum over ``tp`` closes the
    product (parallel/sharding.py ``tp_pair``)."""

    def __init__(self, d_model: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "gelu", *,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.fc1 = Linear(d_model, dim_feedforward, act=activation, **kw)
        self.fc2 = Linear(dim_feedforward, d_model, **kw)
        self.drop = Dropout(dropout)

    def forward(self, x):
        tp = tp_local(self.fc1, self.fc2, "FeedForward")
        if tp is None:
            return self.fc2(self.drop(self.fc1(x)))
        from ..parallel.collective import copy_to_tp

        axis, n, index = tp
        h = self.fc1.column(copy_to_tp(x, axis))
        return self.fc2.row(self.drop.columns(h, index, n), axis)


def tp_local(col, row, kind: str):
    """(axis, size, index) where a sharding plan placed ``col`` column-
    parallel and ``row`` row-parallel over one axis; else None (the
    Linear layers gather at use)."""
    if not (weight_placed(col) or weight_placed(row)):
        return None
    from ..parallel.sharding import tp_pair

    return tp_pair([col], row, kind=kind)


class TransformerEncoderLayer(Layer):
    """Self-attention and FFN, each with dropout on its residual branch:
    pre-norm (``normalize_before``) or post-norm (BERT's).
    ``moe_experts > 0`` makes the FFN a Switch-MoE FFN (nn/moe.py
    ``SwitchFFN``, default tanh GELU whatever ``activation`` says, as in
    the JAX package), whose aux terms ride its buffers
    (``*.ffn.aux_loss``). ``seq_parallel`` ("ring" or "ulysses") shards
    the self-attention over the mesh's ``sp`` axis: the layer takes the
    rank's (B/dp, T/sp, D) rows, and the attention dropout is 0 (the
    residual and FFN dropout stay), as in the JAX layer."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "gelu",
                 normalize_before: bool = True, use_flash: bool = True,
                 seq_parallel=None, attn_window=None,
                 moe_experts: int = 0,
                 moe_capacity_factor: float = 1.25, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.normalize_before = normalize_before
        self.attn_window = attn_window
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=0.0 if seq_parallel else dropout,
            use_flash=use_flash, seq_parallel=seq_parallel, **kw)
        if moe_experts:
            self.ffn = SwitchFFN(d_model, dim_feedforward, moe_experts,
                                 capacity_factor=moe_capacity_factor, **kw)
        else:
            self.ffn = FeedForward(d_model, dim_feedforward, dropout,
                                   activation, **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)

    def forward(self, x, mask=None, segment_ids=None):
        if self.normalize_before:
            x = x + self.drop1(self.self_attn(self.norm1(x), attn_mask=mask,
                                              segment_ids=segment_ids,
                                              window=self.attn_window))
            x = x + self.drop2(self.ffn(self.norm2(x)))
        else:
            x = self.norm1(x + self.drop1(self.self_attn(
                x, attn_mask=mask, segment_ids=segment_ids,
                window=self.attn_window)))
            x = self.norm2(x + self.drop2(self.ffn(x)))
        return x


class TransformerEncoder(Layer):
    """``num_layers`` encoder blocks, with a final LayerNorm in the
    pre-norm form. ``remat=True`` recomputes each block in the backward
    (nn/layer.py :func:`remat_call`: under the forward's policy and
    dropout masks; ``remat_policy="dots"`` keeps the Linears' products).
    ``scan_layers=True`` is the JAX package's ``lax.scan`` over stacked
    layers, whose reason is compile size; PyTorch runs eagerly, so here
    it runs the same per-layer loop, which is the same math, and keeps
    the JAX rule that dropout be 0 in training; the JAX scan drops what
    a Switch-MoE FFN records, so its buffers are not recorded there
    either. ``moe_experts`` with ``remat`` and no ``scan_layers`` raises
    :class:`InvalidArgumentError`: the JAX encoder cannot run it (the
    FFN's buffer write inside ``jax.checkpoint`` raises
    ``UnexpectedTracerError``)."""

    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dim_feedforward: int, dropout: float = 0.1,
                 activation: str = "gelu", normalize_before: bool = True,
                 use_flash: bool = True, seq_parallel=None,
                 remat: bool = False, scan_layers: bool = False,
                 attn_window=None, remat_policy: Optional[str] = None,
                 moe_experts: int = 0, moe_capacity_factor: float = 1.25,
                 *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.layers = LayerList([
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout,
                                    activation, normalize_before, use_flash,
                                    seq_parallel, attn_window=attn_window,
                                    moe_experts=moe_experts,
                                    moe_capacity_factor=moe_capacity_factor,
                                    **kw)
            for _ in range(num_layers)])
        self.final_norm = (LayerNorm(d_model, **kw) if normalize_before
                           else None)
        self.remat = remat
        enforce(remat_policy in (None, "dots"),
                "remat_policy must be None or 'dots', got %r", remat_policy)
        enforce(remat_policy is None or remat,
                "remat_policy=%r requires remat=True", remat_policy)
        self.remat_policy = remat_policy
        self._dropout_p = dropout
        self.scan_layers = scan_layers
        self.moe = bool(moe_experts)
        self._check_moe_remat()

    def _check_moe_remat(self):
        scan = self.scan_layers and len(self.layers) > 1
        if self.moe and self.remat and not scan:
            raise InvalidArgumentError(
                "moe_experts with remat=True (unrolled layers): the JAX "
                "reference cannot run it (the Switch FFN's buffer write "
                "inside jax.checkpoint raises UnexpectedTracerError); use "
                "remat=False")

    def forward(self, x, mask=None, segment_ids=None):
        scan = self.scan_layers and len(self.layers) > 1
        if scan:
            enforce(self._dropout_p == 0.0 or not self.training,
                    "scan_layers needs dropout == 0 in training (one "
                    "traced body would reuse its RNG across layers); "
                    "unroll instead")
        self._check_moe_remat()
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            fn = functools.partial(_unrecorded, layer) if scan else layer
            if remat:
                x = remat_call(fn, x, mask=mask, segment_ids=segment_ids,
                               remat_policy=self.remat_policy)
            else:
                x = fn(x, mask=mask, segment_ids=segment_ids)
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x


def _unrecorded(layer, *args, **kwargs):
    """``layer(*args, **kwargs)`` with its Switch FFN's buffers not
    recorded, in a remat recompute too: the JAX package's scan over
    stacked layers drops them."""
    with not_recording(layer):
        return layer(*args, **kwargs)


class TransformerDecoderLayer(Layer):
    """Causal self-attention, cross-attention over the encoder's memory
    and FFN, each with dropout on its residual branch, pre-norm or
    post-norm. ``attn_window`` bands the self-attention only.
    ``seq_parallel`` shards the self-attention over the ``sp`` axis (the
    rank's target rows, attention dropout 0); the cross-attention keeps
    the plain path over the whole memory, as in the JAX layer."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "gelu",
                 normalize_before: bool = True, use_flash: bool = True,
                 seq_parallel=None, attn_window=None, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.normalize_before = normalize_before
        self.attn_window = attn_window
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=0.0 if seq_parallel else dropout,
            use_flash=use_flash, seq_parallel=seq_parallel, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=dropout,
                                             use_flash=use_flash, **kw)
        self.ffn = FeedForward(d_model, dim_feedforward, dropout,
                               activation, **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
        self.norm3 = LayerNorm(d_model, **kw)
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)
        self.drop3 = Dropout(dropout)

    def forward(self, x, memory, self_mask=None, cross_mask=None,
                causal: bool = True):
        if self.normalize_before:
            x = x + self.drop1(self.self_attn(self.norm1(x),
                                              attn_mask=self_mask,
                                              causal=causal,
                                              window=self.attn_window))
            x = x + self.drop2(self.cross_attn(self.norm2(x), memory, memory,
                                               attn_mask=cross_mask))
            x = x + self.drop3(self.ffn(self.norm3(x)))
        else:
            x = self.norm1(x + self.drop1(self.self_attn(
                x, attn_mask=self_mask, causal=causal,
                window=self.attn_window)))
            x = self.norm2(x + self.drop2(self.cross_attn(
                x, memory, memory, attn_mask=cross_mask)))
            x = self.norm3(x + self.drop3(self.ffn(x)))
        return x


class TransformerDecoder(Layer):
    """``num_layers`` decoder blocks, with a final LayerNorm in the
    pre-norm form."""

    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dim_feedforward: int, dropout: float = 0.1,
                 activation: str = "gelu", normalize_before: bool = True,
                 use_flash: bool = True, seq_parallel=None,
                 attn_window=None, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.layers = LayerList([
            TransformerDecoderLayer(d_model, nhead, dim_feedforward, dropout,
                                    activation, normalize_before, use_flash,
                                    seq_parallel, attn_window=attn_window,
                                    **kw)
            for _ in range(num_layers)])
        self.final_norm = (LayerNorm(d_model, **kw) if normalize_before
                           else None)

    def forward(self, x, memory, self_mask=None, cross_mask=None,
                causal: bool = True):
        for layer in self.layers:
            x = layer(x, memory, self_mask=self_mask, cross_mask=cross_mask,
                      causal=causal)
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x


class PositionalEncoding(Layer):
    """Sinusoidal position signal: ``x * sqrt(d_model) + pe[:t]``, then
    dropout. The (max_len, d_model) table is the JAX package's, made in
    numpy, and a buffer ``pe`` (no parameter, so no key is drawn)."""

    def __init__(self, d_model: int, max_len: int = 4096,
                 dropout: float = 0.0, scale_embedding: bool = True, *,
                 device=None):
        super().__init__()
        enforce(d_model % 2 == 0, "d_model must be even, got %s", d_model)
        pos = np.arange(max_len)[:, None]
        div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
        pe = np.zeros((max_len, d_model), np.float32)
        pe[:, 0::2] = np.sin(pos * div)
        pe[:, 1::2] = np.cos(pos * div)
        self.register_buffer("pe", torch.from_numpy(pe).to(
            resolve_device(device)))
        self.scale = math.sqrt(d_model) if scale_embedding else 1.0
        self.drop = Dropout(dropout)

    def forward(self, x):
        t = x.shape[1]
        out = x * self.scale + use(self.pe)[None, :t].to(x.dtype)
        return self.drop(out)


class LearnedPositionalEmbedding(Layer):
    """BERT-style learned positions: ``x + emb(arange(t))``."""

    def __init__(self, max_len: int, d_model: int, *, device=None,
                 generator=None):
        super().__init__()
        self.emb = Embedding(max_len, d_model, device=device,
                             generator=generator)

    def forward(self, x):
        t = x.shape[1]
        positions = torch.arange(t, device=x.device)[None, :]
        return x + self.emb(positions)


def decoder_layer_step(layer, x_t, mem_k, mem_v, cache_k, cache_v, t,
                       cross_mask=None, decode_kernel: bool = False):
    """One incremental-decode step of a TransformerDecoderLayer
    (``x_t``: (B, 1, D), ``t`` the cache cursor, a Python int): the
    self-attention writes this position's K/V into the layer's caches (in
    place) and attends over them, on the contiguous decode kernel when
    ``decode_kernel``; cross-attention runs against the PRE-PROJECTED
    memory K/V under ``cross_mask``. The pre/post-norm residual layout of
    the layer's forward, without dropout (eval mode). Returns (out_t,
    cache_k, cache_v)."""
    w = layer.attn_window
    if layer.normalize_before:
        h, cache_k, cache_v = layer.self_attn.forward_step(
            layer.norm1(x_t), cache_k, cache_v, t, window=w,
            decode_kernel=decode_kernel)
        x_t = x_t + h
        x_t = x_t + layer.cross_attn.attend_kv(layer.norm2(x_t), mem_k,
                                               mem_v, attn_mask=cross_mask)
        x_t = x_t + layer.ffn(layer.norm3(x_t))
    else:
        h, cache_k, cache_v = layer.self_attn.forward_step(
            x_t, cache_k, cache_v, t, window=w,
            decode_kernel=decode_kernel)
        x_t = layer.norm1(x_t + h)
        x_t = layer.norm2(x_t + layer.cross_attn.attend_kv(
            x_t, mem_k, mem_v, attn_mask=cross_mask))
        x_t = layer.norm3(x_t + layer.ffn(x_t))
    return x_t, cache_k, cache_v
