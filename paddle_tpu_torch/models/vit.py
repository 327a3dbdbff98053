"""Vision Transformer, ViT-B/16 (counterpart of paddle_tpu/models/vit.py):
a strided patch convolution, a [CLS] token and learned positions, the
pre-norm encoder of nn/transformer.py and a linear head over the pooled
state.

Parameter names, layouts and creation order are the JAX package's
(``patch_embed``, ``cls_token``, ``pos_embed``, ``encoder.*``,
``head``), so a JAX state loads by name and the global random stream
advances as the JAX package's does. The model runs on the CUDA card
unless ``device="cpu"`` is passed. At 224 px and patch 16 a row holds
197 tokens (196 under mean pooling), which the flash gate refuses (it
needs multiples of 64), so attention takes the plain path, as it does in
the JAX package."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import initializer as I
from .. import nn
from ..core.enforce import enforce
from ..core.places import resolve_device
from ..nn.layer import use
from ..ops import loss as L


@dataclasses.dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    num_classes: int = 1000
    dropout: float = 0.0
    pool: str = "cls"            # "cls" | "mean"
    layout: str = "NHWC"         # or "NCHW"
    remat: bool = False
    scan_layers: bool = False

    @classmethod
    def tiny(cls):
        """For tests: 32 px, patch 8, hidden 64, 2 layers."""
        return cls(image_size=32, patch_size=8, hidden_size=64,
                   num_layers=2, num_heads=4, intermediate_size=128,
                   num_classes=10)

    @classmethod
    def base(cls):
        """ViT-B/16's geometry (~86M parameters)."""
        return cls()


class ViT(nn.Layer):
    """Patch conv -> [CLS] + learned positions -> pre-norm encoder ->
    pooled head. ``forward(images)`` takes NHWC (B, H, W, C) images (NCHW
    with ``cfg.layout``) and returns (B, num_classes) logits. ``device``:
    the CUDA card when None; ``generator``: the initial weights' stream
    (when None, each parameter's comes from its key off the global
    stream)."""

    def __init__(self, cfg: ViTConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        enforce(cfg.image_size % cfg.patch_size == 0,
                "image %s not divisible by patch %s", cfg.image_size,
                cfg.patch_size)
        enforce(cfg.pool in ("cls", "mean"),
                "pool must be 'cls' or 'mean', got %r", cfg.pool)
        self.cfg = cfg
        kw = dict(device=resolve_device(device), generator=generator)
        grid = cfg.image_size // cfg.patch_size
        self.num_patches = grid * grid
        self.patch_embed = nn.Conv2D(
            cfg.num_channels, cfg.hidden_size, cfg.patch_size,
            stride=cfg.patch_size, data_format=cfg.layout, **kw)
        if cfg.pool == "cls":
            self.create_parameter("cls_token", (1, 1, cfg.hidden_size),
                                  None, I.Normal(scale=0.02), **kw)
        n_tok = self.num_patches + (1 if cfg.pool == "cls" else 0)
        self.create_parameter("pos_embed", (1, n_tok, cfg.hidden_size),
                              None, I.Normal(scale=0.02), **kw)
        self.drop = nn.Dropout(cfg.dropout)
        self.encoder = nn.TransformerEncoder(
            cfg.num_layers, cfg.hidden_size, cfg.num_heads,
            cfg.intermediate_size, dropout=cfg.dropout,
            activation="gelu", normalize_before=True,
            remat=cfg.remat, scan_layers=cfg.scan_layers, **kw)
        self.head = nn.Linear(cfg.hidden_size, cfg.num_classes, **kw)

    def forward(self, images):
        cfg = self.cfg
        p = self.patch_embed(images)
        if cfg.layout == "NHWC":
            b, gh, gw, d = p.shape
        else:
            b, d, gh, gw = p.shape
            p = p.permute(0, 2, 3, 1)
        enforce(gh * gw == self.num_patches,
                "got %sx%s patches for image %s/%s", gh, gw,
                cfg.image_size, cfg.patch_size)
        x = p.reshape(b, self.num_patches, cfg.hidden_size)
        if cfg.pool == "cls":
            cls = use(self.cls_token).expand(b, 1, cfg.hidden_size)
            x = torch.cat([cls.to(x.dtype), x], dim=1)
        x = self.drop(x + use(self.pos_embed).to(x.dtype))
        x = self.encoder(x)
        pooled = x[:, 0] if cfg.pool == "cls" else torch.mean(x, dim=1)
        return self.head(pooled)


def loss_fn(logits, labels):
    """Mean CE over (B, num_classes) logits."""
    return torch.mean(L.softmax_with_cross_entropy(logits, labels))
