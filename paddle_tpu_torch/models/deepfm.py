"""DeepFM — sparse CTR model, BASELINE config 5 (counterpart of
paddle_tpu/models/deepfm.py).

Capability target: the reference's CTR training stack — MultiSlot sparse
ids through lookup tables with sparse gradients (reference:
framework/data_feed.h:55, operators/lookup_table_op.cc sparse-grad
path): FM first- and second-order terms plus a DNN tower. Parameters
are named, laid out and created in the JAX package's order
(``embedding``, ``linear_embed``, ``bias``, ``mlp.*``,
``dense_linear``), so a JAX state loads by name
(utils/convert.py ``load_numpy_state``) and the global random stream
advances as the JAX package's does.

Input convention (Criteo-style): ``sparse_ids`` (B, F) — one id per
categorical field, pre-offset into a single concatenated vocab of size
sum(field vocab sizes); ``dense`` (B, Dn) — continuous features.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from .. import nn
from ..core.enforce import UnimplementedError, enforce
from ..core.places import resolve_device
from ..ops import loss as L


@dataclass
class DeepFMConfig:
    total_vocab: int = 1000          # sum of per-field vocab sizes
    num_fields: int = 26
    dense_dim: int = 13
    embed_dim: int = 16
    mlp_dims: Sequence[int] = (400, 400, 400)
    dropout: float = 0.0
    # 'ep' shards the tables over a mesh (ShardedEmbedding, not ported
    # yet); None keeps them whole on the device
    embedding_axis: Optional[str] = "ep"
    # row-sparse gradient updates for the tables (SelectedRows
    # capability; reference: lookup_table is_sparse) — train through
    # optimizer.sparse_minimize_fn so each step touches O(B*fields) rows
    sparse_grads: bool = False

    @classmethod
    def criteo(cls, total_vocab: int = 1_000_000):
        return cls(total_vocab=total_vocab)

    @classmethod
    def tiny(cls):
        return cls(total_vocab=512, num_fields=8, dense_dim=4, embed_dim=8,
                   mlp_dims=(32, 16))


class DeepFM(nn.Layer):
    """DeepFM over ``cfg`` (``DeepFMConfig()`` when None); the forward
    returns the logits (B,). ``device``: the CUDA card when None;
    ``generator``: the initial weights' stream (when None, each
    parameter's comes from its key off the global stream, which
    ``paddle_tpu_torch.seed`` sets). Under a mixed-precision policy only
    the Linears cast; the tables and the FM terms stay float32, as in the
    JAX package. ``embedding_axis`` other than None (the mesh-sharded
    tables of the JAX package's default) raises
    :class:`UnimplementedError`."""

    def __init__(self, cfg: Optional[DeepFMConfig] = None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg = cfg or DeepFMConfig()
        if cfg.embedding_axis:
            raise UnimplementedError(
                f"DeepFM embedding_axis={cfg.embedding_axis!r} (tables "
                "sharded over a mesh by ShardedEmbedding) is not ported "
                "yet: ROADMAP queue 1 item 11 (distributed); pass "
                "embedding_axis=None")
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.embedding = nn.Embedding(cfg.total_vocab, cfg.embed_dim,
                                      is_sparse=cfg.sparse_grads, **kw)
        self.linear_embed = nn.Embedding(cfg.total_vocab, 1,
                                         is_sparse=cfg.sparse_grads, **kw)
        self.create_parameter("bias", (1,), is_bias=True, **kw)
        mlp = []
        d_in = cfg.num_fields * cfg.embed_dim + cfg.dense_dim
        for d_out in cfg.mlp_dims:
            mlp.append(nn.Linear(d_in, d_out, act="relu", **kw))
            if cfg.dropout:
                mlp.append(nn.Dropout(cfg.dropout))
            d_in = d_out
        mlp.append(nn.Linear(d_in, 1, **kw))
        self.mlp = nn.Sequential(*mlp)
        self.dense_linear = nn.Linear(cfg.dense_dim, 1, **kw)

    def forward(self, sparse_ids, dense=None):
        cfg = self.cfg
        b, f = sparse_ids.shape
        enforce(f == cfg.num_fields, "expected %s fields, got %s",
                cfg.num_fields, f)
        emb = self.embedding(sparse_ids)               # (B, F, K)
        # FM first order: per-id scalar weights (+ dense linear)
        first = torch.sum(self.linear_embed(sparse_ids)[..., 0], dim=1)
        if dense is not None:
            first = first + self.dense_linear(dense)[:, 0]
        # FM second order: 0.5 * ((Σe)² − Σe²) summed over K
        s = torch.sum(emb, dim=1)
        second = 0.5 * torch.sum(s * s - torch.sum(emb * emb, dim=1),
                                 dim=-1)
        # DNN tower over concatenated embeddings (+ dense)
        flat = emb.reshape(b, f * cfg.embed_dim)
        if dense is not None:
            flat = torch.cat([flat, dense], dim=-1)
        deep = self.mlp(flat)[:, 0]
        return first + second + deep + self.bias[0]    # logits (B,)


def loss_fn(logits, labels):
    """Pointwise CTR loss: sigmoid BCE (reference:
    operators/sigmoid_cross_entropy_with_logits_op.cc)."""
    return torch.mean(L.sigmoid_cross_entropy_with_logits(
        logits, labels.to(logits.dtype)))
