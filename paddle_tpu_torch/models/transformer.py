"""Transformer NMT, BASELINE config 4 (counterpart of
paddle_tpu/models/transformer.py): an encoder-decoder over
nn/transformer.py with sinusoidal positions, label-smoothed cross
entropy, and greedy and beam decoding, each with and without per-layer
K/V caches.

Parameter names, layouts and creation order are the JAX package's
(``src_emb``, ``tgt_emb``, ``encoder.*``, ``decoder.*``, ``generator``;
the positional table is a buffer), so a JAX state loads by name
(utils/convert.py ``load_numpy_state``) and the global random stream
advances as the JAX package's does. The model runs on the CUDA card
unless ``device="cpu"`` is passed. There the encoder's self-attention,
the decoder's causal self-attention and its cross-attention (query and
memory lengths may differ; the source padding is the kernels' key mask)
run the flash kernels when both lengths are multiples of 64, with
attention dropout inside them in training, and ``greedy_decode_cached``
runs every decoder self-attention step on the contiguous decode kernel.

The decode entry points run under ``torch.inference_mode()`` and their
loops run all ``max_len`` steps, as the JAX package's static
``lax.scan`` does: a finished row emits ``pad_id``, and nothing is read
back to the host inside a loop."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import nn
from ..core.dtypes import get_policy
from ..core.enforce import UnimplementedError, enforce
from ..core.places import resolve_device
from ..nn.transformer import (PositionalEncoding, TransformerDecoder,
                              TransformerEncoder, decoder_layer_step)
from ..ops import decode as DCD
from ..ops import loss as L
from ..ops.fused_loss import mean_linear_cross_entropy
from ..ops.nn import one_hot


@dataclasses.dataclass
class NMTConfig:
    src_vocab: int = 32000
    tgt_vocab: int = 32000
    d_model: int = 512
    num_heads: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    dim_feedforward: int = 2048
    dropout: float = 0.1
    max_len: int = 1024
    label_smooth: float = 0.1
    bos_id: int = 0
    eos_id: int = 1
    pad_id: int = 2
    use_flash: bool = True
    # the decoder's sequence-parallel self-attention raises: ROADMAP
    # queue 1 item 11
    seq_parallel: Optional[str] = None

    @classmethod
    def base(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(src_vocab=512, tgt_vocab=512, d_model=64, num_heads=4,
                   num_encoder_layers=2, num_decoder_layers=2,
                   dim_feedforward=128, dropout=0.0, max_len=128)


class TransformerNMT(nn.Layer):
    """Encoder-decoder NMT over ``cfg`` (``NMTConfig.base()`` when None).
    ``device``: the CUDA card when None; ``generator``: the initial
    weights' stream (when None, each parameter's comes from its key off
    the global stream, which ``paddle_tpu_torch.seed`` sets)."""

    def __init__(self, cfg: Optional[NMTConfig] = None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg = cfg or NMTConfig.base()
        if cfg.seq_parallel is not None:
            raise UnimplementedError(
                f"NMTConfig.seq_parallel={cfg.seq_parallel!r} is not ported "
                "yet: ROADMAP queue 1 item 11 (distributed)")
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.src_emb = nn.Embedding(cfg.src_vocab, cfg.d_model,
                                    padding_idx=cfg.pad_id, **kw)
        self.tgt_emb = nn.Embedding(cfg.tgt_vocab, cfg.d_model,
                                    padding_idx=cfg.pad_id, **kw)
        self.pos_enc = PositionalEncoding(cfg.d_model, cfg.max_len,
                                          dropout=cfg.dropout, device=device)
        self.encoder = TransformerEncoder(
            cfg.num_encoder_layers, cfg.d_model, cfg.num_heads,
            cfg.dim_feedforward, cfg.dropout, use_flash=cfg.use_flash, **kw)
        self.decoder = TransformerDecoder(
            cfg.num_decoder_layers, cfg.d_model, cfg.num_heads,
            cfg.dim_feedforward, cfg.dropout, use_flash=cfg.use_flash,
            seq_parallel=cfg.seq_parallel, **kw)
        self.generator = nn.Linear(cfg.d_model, cfg.tgt_vocab, **kw)

    def encode(self, src_ids):
        """(memory (B, Ts, D), the source keep-mask (B, Ts))."""
        src_pad = src_ids != self.cfg.pad_id
        memory = self.encoder(self.pos_enc(self.src_emb(src_ids)),
                              mask=src_pad[:, None, None, :])
        return memory, src_pad

    def _decode_hidden(self, tgt_ids, memory, src_pad):
        return self.decoder(self.pos_enc(self.tgt_emb(tgt_ids)), memory,
                            cross_mask=src_pad[:, None, None, :],
                            causal=True)

    def forward(self, src_ids, tgt_ids):
        """Teacher-forced logits (B, Tt, tgt_vocab); ``tgt_ids`` is the
        decoder's (shifted) input."""
        memory, src_pad = self.encode(src_ids)
        return self.generator(self._decode_hidden(tgt_ids, memory, src_pad))

    def forward_fused_loss(self, src_ids, tgt_ids, tgt_labels,
                           vocab_chunk: int = 4096):
        """The mean training CE without the (B, T, tgt_vocab) logits: the
        generator head through the chunked linear cross-entropy
        (ops/fused_loss.py), its operands in the policy's compute dtype;
        ``pad_id`` labels are ignored."""
        memory, src_pad = self.encode(src_ids)
        h = self._decode_hidden(tgt_ids, memory, src_pad)
        b, t, d = h.shape
        labels = torch.where(tgt_labels == self.cfg.pad_id, -100, tgt_labels)
        pol = get_policy()
        return mean_linear_cross_entropy(
            pol.cast_to_compute(h.reshape(b * t, d)),
            pol.cast_to_compute(self.generator.weight),
            pol.cast_to_compute(self.generator.bias),
            labels.reshape(-1), chunk=vocab_chunk, ignore_index=-100)

    def _start_tokens(self, b: int, max_len: int, device):
        cfg = self.cfg
        tokens = torch.full((b, max_len + 1), cfg.pad_id, dtype=torch.long,
                            device=device)
        tokens[:, 0] = cfg.bos_id
        return tokens, torch.zeros((b,), dtype=torch.bool, device=device)

    def _emit(self, tokens, finished, logits, t: int):
        """Greedy pick at step ``t``: argmax (the first of equal logits),
        ``pad_id`` for finished rows; written at column t + 1 in place."""
        cfg = self.cfg
        next_tok = torch.argmax(logits, -1)
        next_tok = torch.where(finished, cfg.pad_id, next_tok)
        tokens[:, t + 1] = next_tok
        return finished | (next_tok == cfg.eos_id)

    @torch.inference_mode()
    def greedy_decode(self, src_ids, max_len: int = 64):
        """Fixed-length greedy decode that re-runs the decoder over the
        whole (B, max_len) token buffer at every step and projects only
        row t (the JAX package's ``lax.scan``). Returns (B, max_len)."""
        b = src_ids.shape[0]
        memory, src_pad = self.encode(src_ids)
        tokens, finished = self._start_tokens(b, max_len, src_ids.device)
        for t in range(max_len):
            h = self._decode_hidden(tokens[:, :-1], memory, src_pad)
            finished = self._emit(tokens, finished,
                                  self.generator(h[:, t]), t)
        return tokens[:, 1:]

    def _cached_step_hidden(self, tok, t, mem_kv, caches, cross_mask,
                            decode_kernel: bool = False):
        """One cached decode step shared by greedy and beam: embed the
        current token (B,), add position ``t``'s term (``t`` a Python
        int), run every decoder layer against its K/V cache (updated in
        place), final-norm. Returns (h_t (B, D), caches).
        ``decode_kernel`` puts the self-attention on the contiguous
        decode kernel (greedy; the JAX package keeps beam search off it,
        since its beams run under vmap)."""
        emb = self.tgt_emb(tok[:, None])
        x_t = (emb * self.pos_enc.scale
               + self.pos_enc.pe[t][None, None, :].to(emb.dtype))
        new_caches = []
        for layer, (mk, mv), (ck, cv) in zip(self.decoder.layers, mem_kv,
                                             caches):
            x_t, ck, cv = decoder_layer_step(
                layer, x_t, mk, mv, ck, cv, t, cross_mask=cross_mask,
                decode_kernel=decode_kernel)
            new_caches.append((ck, cv))
        if self.decoder.final_norm is not None:
            x_t = self.decoder.final_norm(x_t)
        return x_t[:, 0], new_caches

    def _check_cached(self, max_len: int, what: str):
        # past the table greedy_decode fails; a cached step would index
        # past it too, so say so here. The step path applies no dropout,
        # which equals greedy_decode in eval mode only
        enforce(max_len <= self.pos_enc.pe.shape[0],
                "max_len %s exceeds the positional table (%s)",
                max_len, self.pos_enc.pe.shape[0])
        enforce(not self.training,
                "%s requires eval mode (the cached step path applies no "
                "dropout); call model.eval()", what)

    @torch.inference_mode()
    def greedy_decode_cached(self, src_ids, max_len: int = 64):
        """Greedy decode with per-layer K/V caches of capacity
        ``max_len`` in the memory's dtype: O(T) work a step; the memory's
        cross-attention K/V are projected once. Every self-attention step
        runs the contiguous decode kernel on the card. Token-identical to
        :meth:`greedy_decode`. Requires eval mode."""
        self._check_cached(max_len, "greedy_decode_cached")
        b = src_ids.shape[0]
        memory, src_pad = self.encode(src_ids)
        cross_mask = src_pad[:, None, None, :]
        mem_kv = [layer.cross_attn.project_kv(memory)
                  for layer in self.decoder.layers]
        caches = [layer.self_attn.init_cache(b, max_len, dtype=memory.dtype)
                  for layer in self.decoder.layers]
        tokens, finished = self._start_tokens(b, max_len, src_ids.device)
        for t in range(max_len):
            h_t, caches = self._cached_step_hidden(
                tokens[:, t], t, mem_kv, caches, cross_mask,
                decode_kernel=True)
            finished = self._emit(tokens, finished, self.generator(h_t), t)
        return tokens[:, 1:]

    @torch.inference_mode()
    def beam_decode(self, src_ids, max_len: int = 64, beam_size: int = 4,
                    length_penalty: float = 0.6):
        """Beam-search decode that re-runs the decoder over each beam's
        whole (max_len + 1) token buffer at every step (the reference's
        beam_search op + beam_search_decode). The JAX package decodes one
        source at a time under vmap; here the B x beam_size beams run
        together, each source's result equal to its own. Returns
        (sequences (B, beam_size, max_len) best-first, scores (B,
        beam_size), raw)."""
        cfg = self.cfg
        b = src_ids.shape[0]
        memory, src_pad = self.encode(src_ids)
        mem_k = memory.repeat_interleave(beam_size, dim=0)
        cross_mask = src_pad.repeat_interleave(beam_size, dim=0)[
            :, None, None, :]

        def step_fn(tokens, tok, t):
            # the state is a fresh gather after every step: write in place
            tokens[:, t] = tok
            h = self.decoder(self.pos_enc(self.tgt_emb(tokens)), mem_k,
                             cross_mask=cross_mask, causal=True)
            return torch.log_softmax(self.generator(h[:, t]), -1), tokens

        init = torch.full((b * beam_size, max_len + 1), cfg.pad_id,
                          dtype=torch.long, device=src_ids.device)
        return DCD._beam_search_rows(
            init, step_fn, batch=b, beam_size=beam_size, max_len=max_len,
            bos_id=cfg.bos_id, end_id=cfg.eos_id,
            length_penalty=length_penalty, device=src_ids.device)

    @torch.inference_mode()
    def beam_decode_cached(self, src_ids, max_len: int = 64,
                           beam_size: int = 4,
                           length_penalty: float = 0.6):
        """:meth:`beam_decode` with per-layer K/V caches in the beam
        state, gathered by parent with the rest of it after every step:
        O(T) a step. The memory's cross-attention K/V are projected once
        per source, then repeated. The self-attention runs the plain
        masked path, as the JAX package's does. Result-identical to
        :meth:`beam_decode`; requires eval mode."""
        cfg = self.cfg
        self._check_cached(max_len, "beam_decode_cached")
        b = src_ids.shape[0]
        memory, src_pad = self.encode(src_ids)
        cross_mask = src_pad.repeat_interleave(beam_size, dim=0)[
            :, None, None, :]
        mem_kv = [tuple(x.repeat_interleave(beam_size, dim=0)
                        for x in layer.cross_attn.project_kv(memory))
                  for layer in self.decoder.layers]

        def step_fn(caches, tok, t):
            h_t, caches = self._cached_step_hidden(tok, t, mem_kv, caches,
                                                   cross_mask)
            return torch.log_softmax(self.generator(h_t), -1), caches

        init = [layer.self_attn.init_cache(b * beam_size, max_len,
                                           dtype=memory.dtype)
                for layer in self.decoder.layers]
        return DCD._beam_search_rows(
            init, step_fn, batch=b, beam_size=beam_size, max_len=max_len,
            bos_id=cfg.bos_id, end_id=cfg.eos_id,
            length_penalty=length_penalty, device=src_ids.device)


def nmt_loss(logits, labels, pad_id: int = 2, label_smooth: float = 0.1):
    """Label-smoothed CE over the non-pad positions (reference: the
    label_smooth op + softmax_with_cross_entropy's soft-label mode). A
    label outside [0, vocab) has a zero one-hot row, as
    ``jax.nn.one_hot`` gives."""
    vocab = logits.shape[-1]
    soft = L.label_smooth(one_hot(labels, vocab, dtype=logits.dtype),
                          epsilon=label_smooth)
    tok_loss = L.softmax_with_cross_entropy(logits, soft,
                                            soft_label=True).squeeze(-1)
    keep = labels != pad_id
    return torch.sum(tok_loss * keep) / torch.clamp_min(torch.sum(keep), 1)


def nmt_metrics(logits, labels, pad_id: int = 2):
    """Token accuracy over the non-pad positions."""
    keep = labels != pad_id
    pred = torch.argmax(logits, -1)
    acc = torch.sum((pred == labels) * keep) / torch.clamp_min(
        torch.sum(keep), 1)
    return {"token_acc": acc}
