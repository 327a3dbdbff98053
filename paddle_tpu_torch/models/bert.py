"""BERT pretraining, MLM + NSP (counterpart of paddle_tpu/models/bert.py,
the repo's BASELINE config 3): a post-norm GELU encoder with learned
positions over nn/transformer.py, the MLM head (dense + GELU, LayerNorm,
decoder) and the NSP head on the pooled [CLS] state.

Parameter names and layouts are the JAX package's
(``bert.encoder.layers.<i>.self_attn.q_proj.weight``, Linear weights
(in, out)), so weights cross with utils/convert.load_numpy_state. The
model runs on the CUDA card unless ``device="cpu"`` is passed; its
attention runs the flash kernels there, with dropout inside them in
training and the segment ids of packed rows (``forward_packed_loss``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import nn
from ..core.dtypes import get_policy
from ..core.places import resolve_device
from ..core.random import make_generator
from ..metrics import accuracy
from ..nn.layer import use
from ..nn.transformer import TransformerEncoder
from ..ops import loss as L
from ..ops.fused_loss import linear_cross_entropy, mean_linear_cross_entropy
from ..parallel.context_parallel import (mesh_parallel, seq_gather,
                                         seq_shard, seq_sharded, token_mean)


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    use_flash: bool = True
    # None | "ring" | "ulysses": shard the encoder over the mesh's 'sp' axis
    seq_parallel: Optional[str] = None
    remat: bool = False        # recompute each block in the backward
    remat_policy: Optional[str] = None  # None (save nothing) | "dots"
    attn_window: Optional[int] = None   # sliding-window attention width
    scan_layers: bool = False  # the same per-layer loop (needs dropout
    #                            == 0 while training, as in JAX)
    # > 0: each block's FFN is a Switch-MoE FFN (nn/moe.py); the
    # per-layer aux terms ride its buffers (*.ffn.aux_loss)
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25

    @classmethod
    def base(cls):
        return cls()

    @classmethod
    def tiny(cls):
        """For tests: 2 layers, hidden 64."""
        return cls(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                   intermediate_size=128, max_position=128, dropout=0.0)

    @classmethod
    def moe_smoke(cls, layers: int = 4):
        """The JAX package's bert_moe smoke configuration (capacity 2.0
        keeps routing drops out of loss-match tolerances)."""
        return cls(vocab_size=256, hidden_size=64, num_layers=layers,
                   num_heads=4, intermediate_size=128, max_position=32,
                   dropout=0.0, moe_experts=4, moe_capacity_factor=2.0)


class BertEmbeddings(nn.Layer):
    """Token + learned position (+ token type) embeddings, LayerNorm,
    dropout."""

    def __init__(self, cfg: BertConfig, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.tok = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.pos = nn.Embedding(cfg.max_position, cfg.hidden_size, **kw)
        self.seg = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size, **kw)
        self.norm = nn.LayerNorm(cfg.hidden_size, **kw)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        t = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(t, device=input_ids.device)[None, :]
        x = self.tok(input_ids) + self.pos(position_ids)
        if token_type_ids is not None:
            x = x + self.seg(token_type_ids)
        return self.drop(self.norm(x))


def _build_kw(cfg_device, generator):
    device = resolve_device(cfg_device)
    if generator is None:
        generator = make_generator(0, device)
    return dict(device=device, generator=generator)


class BertModel(nn.Layer):
    """Embeddings -> post-norm GELU encoder -> tanh pooler on position 0.
    ``device``: the CUDA card when None; ``generator``: the initial
    weights' stream (seed 0 on ``device`` when None)."""

    def __init__(self, cfg: Optional[BertConfig] = None, *, device=None,
                 generator=None):
        super().__init__()
        self.cfg = cfg = cfg or BertConfig.base()
        kw = _build_kw(device, generator)
        self.embeddings = BertEmbeddings(cfg, **kw)
        self.encoder = TransformerEncoder(
            cfg.num_layers, cfg.hidden_size, cfg.num_heads,
            cfg.intermediate_size, cfg.dropout, activation="gelu",
            normalize_before=False, use_flash=cfg.use_flash,
            seq_parallel=cfg.seq_parallel, remat=cfg.remat,
            remat_policy=cfg.remat_policy,
            scan_layers=cfg.scan_layers, attn_window=cfg.attn_window,
            moe_experts=cfg.moe_experts,
            moe_capacity_factor=cfg.moe_capacity_factor, **kw)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size, act="tanh",
                                **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None, segment_ids=None):
        """``segment_ids``/``position_ids``: the packed-batch form
        (data/bucketing.py ``pack_sequences``): attention confined to
        each packed segment, positions restarting per segment. Returns
        (hidden states (B, T, hidden), pooled (B, hidden)).

        Under ``cfg.seq_parallel`` and a mesh whose ``sp`` axis has more
        than one rank, the rank's (B/dp, T) inputs are embedded whole
        (the learned positions before the slice), the encoder runs on
        the rank's T/sp rows (its mask and segment ids too), and the
        hidden states are all-gathered over ``sp`` before the pooler."""
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        sharded = seq_sharded(self.cfg.seq_parallel)
        if sharded:
            x, attention_mask, segment_ids = (
                seq_shard(a) for a in (x, attention_mask, segment_ids))
        mask = None
        if attention_mask is not None:
            # (B, T) keep-mask -> broadcastable (B, 1, 1, T)
            mask = attention_mask[:, None, None, :]
        h = self.encoder(x, mask=mask, segment_ids=segment_ids)
        if sharded:
            h = seq_gather(h)
        pooled = self.pooler(h[:, 0])
        return h, pooled


class BertForPretraining(nn.Layer):
    """The MLM head (dense + GELU, LayerNorm, decoder over the
    vocabulary) and the NSP head on the pooled state."""

    def __init__(self, cfg: Optional[BertConfig] = None, *, device=None,
                 generator=None):
        super().__init__()
        cfg = cfg or BertConfig.base()
        kw = _build_kw(device, generator)
        self.bert = BertModel(cfg, **kw)
        self.mlm_transform = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                       act="gelu", **kw)
        self.mlm_norm = nn.LayerNorm(cfg.hidden_size, **kw)
        self.mlm_decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size, **kw)
        self.nsp = nn.Linear(cfg.hidden_size, 2, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """(MLM logits (B, T, V), NSP logits (B, 2))."""
        h, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        mlm_logits = self.mlm_decoder(self.mlm_norm(self.mlm_transform(h)))
        nsp_logits = self.nsp(pooled)
        return mlm_logits, nsp_logits

    def _mlm_loss(self, h, labels, vocab_chunk):
        """Mean MLM CE through the fused chunked linear-CE head (the (B*T,
        V) logits never exist). Its operands take the policy's compute
        dtype, as the Linear head they replace does (the JAX package's
        casts; GPT's tied head stays float32, BERT's does not); the
        products and sums are float32 (ops/fused_loss.py).

        Under a mesh that spreads the batch or the sequence, the rank's
        rows (its T/sp of them under ``seq_parallel``) give the sum of
        their token losses, divided by the count of masked tokens, both
        summed over the mesh (parallel/context_parallel.py
        ``token_mean``): the mean over the global batch's masked
        tokens, which fall unevenly on the ranks."""
        if seq_sharded(self.bert.cfg.seq_parallel):
            h, labels = seq_shard(h), seq_shard(labels)
        h_mlm = self.mlm_norm(self.mlm_transform(h))
        b, t, d = h_mlm.shape
        pol = get_policy()
        args = (pol.cast_to_compute(h_mlm.reshape(b * t, d)),
                pol.cast_to_compute(use(self.mlm_decoder.weight)),
                pol.cast_to_compute(use(self.mlm_decoder.bias)),
                labels.reshape(-1))
        if mesh_parallel():
            losses = linear_cross_entropy(*args, chunk=vocab_chunk,
                                          ignore_index=-100)
            return token_mean(losses.sum(), (labels != -100).sum())
        return mean_linear_cross_entropy(*args, chunk=vocab_chunk,
                                         ignore_index=-100)

    def forward_fused_loss(self, input_ids, mlm_labels, nsp_label,
                           token_type_ids=None, attention_mask=None,
                           vocab_chunk: int = 4096):
        """The pretraining loss, MLM (labels -100 ignored) + NSP, without
        materializing the (B, T, V) logits. Under a mesh that spreads the
        batch or the sequence, each term is the global batch's mean and
        every rank returns it (``_mlm_loss``)."""
        h, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        mlm_loss = self._mlm_loss(h, mlm_labels, vocab_chunk)
        nsp = L.softmax_with_cross_entropy(self.nsp(pooled), nsp_label)
        if mesh_parallel():
            # the global batch's mean, as the MLM term's: every rank
            # returns the global loss
            nsp_loss = token_mean(nsp.sum(), torch.tensor(
                nsp.numel(), device=nsp.device))
        else:
            nsp_loss = torch.mean(nsp)
        return mlm_loss + nsp_loss

    def forward_packed_loss(self, tokens, positions, segment_ids,
                            mlm_labels, vocab_chunk: int = 4096):
        """MLM loss over a packed batch (``pack_sequences`` layout: many
        sequences per row, segment id 0 = the padding tail). Attention is
        confined to each segment (the flash kernels' segment ids),
        positions restart per segment, and padding tokens are left out of
        the loss. No NSP: a packed row holds unrelated documents."""
        h, _ = self.bert(tokens, position_ids=positions,
                         segment_ids=segment_ids)
        labels = torch.where(segment_ids > 0, mlm_labels, -100)
        return self._mlm_loss(h, labels, vocab_chunk)


def pretrain_loss(outputs, labels):
    """``labels``: dict(mlm_labels (B, T) with -100 = unmasked, nsp_label
    (B,)); the mean MLM CE over masked positions + the mean NSP CE."""
    mlm_logits, nsp_logits = outputs
    mlm_labels = labels["mlm_labels"]
    valid = mlm_labels >= 0
    safe_labels = torch.where(valid, mlm_labels, 0)
    tok_loss = L.softmax_with_cross_entropy(mlm_logits,
                                            safe_labels).squeeze(-1)
    mlm_loss = torch.sum(tok_loss * valid) / torch.clamp(valid.sum(), min=1)
    nsp_loss = torch.mean(
        L.softmax_with_cross_entropy(nsp_logits, labels["nsp_label"]))
    return mlm_loss + nsp_loss


def pretrain_metrics(outputs, labels):
    """MLM accuracy over masked positions and NSP accuracy."""
    mlm_logits, nsp_logits = outputs
    valid = labels["mlm_labels"] >= 0
    pred = torch.argmax(mlm_logits, -1)
    mlm_acc = torch.sum((pred == labels["mlm_labels"]) * valid) / \
        torch.clamp(valid.sum(), min=1)
    return {"mlm_acc": mlm_acc,
            "nsp_acc": accuracy(nsp_logits, labels["nsp_label"])}
