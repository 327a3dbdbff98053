"""Stacked dynamic LSTM sentiment model, the reference's bench model 6
(counterpart of paddle_tpu/models/stacked_lstm.py): word ids ->
embedding -> [Linear -> LSTM] x N -> the last layer's outputs max-pooled
over the live steps, beside its final cell state -> Linear over 2
classes. Variable-length batches are padded (B, T) ids with
``lengths``."""

from __future__ import annotations

import torch

from .. import nn
from ..core.places import resolve_device
from ..core.random import make_generator
from ..metrics import accuracy
from ..ops import loss as L
from ..ops.sequence import sequence_mask


class StackedLSTM(nn.Layer):
    """Parameters ``embedding``, ``fc{i}``, ``lstm{i}`` and ``out`` in the
    JAX package's order and layout. ``scan_unroll`` is passed to each
    LSTM (no effect here, nn/rnn_layers.py). ``device``: the CUDA card
    when None (raises when there is none); ``generator``: the initial
    weights' stream (seed 0 on ``device`` when None)."""

    def __init__(self, vocab_size: int = 5149, embed_dim: int = 512,
                 hidden_dim: int = 512, num_layers: int = 3,
                 num_classes: int = 2, scan_unroll: int = 1, *,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = make_generator(0, device)
        kw = dict(device=device, generator=generator)
        self.embedding = nn.Embedding(vocab_size, embed_dim, **kw)
        self.num_layers = num_layers
        for i in range(num_layers):
            in_dim = embed_dim if i == 0 else hidden_dim
            self.add_module(f"fc{i}", nn.Linear(in_dim, hidden_dim, **kw))
            self.add_module(f"lstm{i}", nn.LSTM(hidden_dim, hidden_dim,
                                                scan_unroll=scan_unroll,
                                                **kw))
        self.out = nn.Linear(2 * hidden_dim, num_classes, **kw)

    def forward(self, ids, lengths):
        h = self.embedding(ids)
        mask = sequence_mask(lengths, ids.shape[1], torch.bool)[:, :, None]
        cell = None
        for i in range(self.num_layers):
            h = getattr(self, f"fc{i}")(h)
            h, (_, cell) = getattr(self, f"lstm{i}")(h, lengths=lengths)
        # the reference pools the outputs' max over time beside the cell
        pooled_h = torch.max(torch.where(mask, h, h.new_tensor(-1e9)),
                             dim=1).values
        feat = torch.cat([pooled_h, cell[0]], dim=-1)
        return self.out(feat)


def loss_fn(logits, label):
    """Mean softmax cross-entropy."""
    return torch.mean(L.softmax_with_cross_entropy(logits, label))


def eval_metrics(logits, label):
    return {"acc": accuracy(logits, label)}
