"""Decoder-only causal LM, GPT/Llama-style (counterpart of
paddle_tpu/models/gpt.py): RoPE, GQA attention, RMSNorm pre-norm blocks,
SwiGLU FFNs (or Switch-MoE FFNs), a tied LM head, KV-cached decoding
and the fused linear-CE training head.

Parameter names and layouts are the JAX package's
(``blocks.<i>.self_attn.q_proj.weight``, Linear weights (in, out), the
tied head ``embed.weight.T``), so weights cross with
utils/convert.load_numpy_state. The model runs on the CUDA card unless
``device="cpu"`` is passed."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .. import initializer as I
from .. import nn
from ..core.enforce import InvalidArgumentError, enforce
from ..core.places import resolve_device
from ..core.random import make_generator
from ..nn.layer import Layer, remat_call, use, weight_placed
from ..parallel.context_parallel import (mesh_parallel, seq_gather,
                                         seq_shard, seq_sharded, token_mean)


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None   # < num_heads = GQA/MQA
    intermediate_size: int = 2048        # SwiGLU width
    max_position: int = 2048             # decode-cache capacity default
    rope_theta: float = 10000.0
    dropout: float = 0.0                 # residual/FFN dropout
    use_flash: bool = True
    remat: bool = False                  # per-block recompute (training)
    seq_parallel: Optional[str] = None
    attn_window: Optional[int] = None    # sliding-window local attention
    moe_experts: int = 0                 # > 0: Switch-MoE FFN
    moe_capacity_factor: float = 1.25
    tie_embeddings: bool = True          # LM head = embedding^T

    @classmethod
    def tiny(cls):
        """For tests: 2 layers, hidden 128, GQA 4q/2kv, head_dim 32."""
        return cls(vocab_size=512, hidden_size=128, num_layers=2,
                   num_heads=4, num_kv_heads=2, intermediate_size=256,
                   max_position=128)

    @classmethod
    def small(cls):
        """A llama-ish small config: head_dim 64 (decode-kernel eligible)."""
        return cls(vocab_size=32000, hidden_size=768, num_layers=12,
                   num_heads=12, num_kv_heads=4, intermediate_size=2048,
                   max_position=2048)


def _check_supported(cfg: GPTConfig):
    """``moe_experts`` with ``remat`` raises :class:`InvalidArgumentError`:
    the JAX reference cannot run it (the Switch FFN's buffer write inside
    ``jax.checkpoint`` raises ``UnexpectedTracerError``)."""
    if cfg.moe_experts and cfg.remat:
        raise InvalidArgumentError(
            "GPTConfig(moe_experts > 0, remat=True): the JAX reference "
            "cannot run it (the Switch FFN's buffer write inside "
            "jax.checkpoint raises UnexpectedTracerError); use remat=False")


class _SwiGLU(Layer):
    """Gated FFN: down(silu(gate(x)) * up(x)) — the Llama MLP. Under a
    sharding plan that places ``gate`` and ``up`` column-parallel and
    ``down`` row-parallel (``transformer_tp_rules``), the rank computes
    its columns and one sum over ``tp`` closes the product."""

    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.0, *,
                 dtype=None, device=None, generator=None):
        super().__init__()
        kw = dict(bias_attr=False, dtype=dtype, device=device,
                  generator=generator)
        self.gate = nn.Linear(d_model, d_ff, **kw)
        self.up = nn.Linear(d_model, d_ff, **kw)
        self.down = nn.Linear(d_ff, d_model, **kw)
        self.drop = nn.Dropout(dropout)

    def forward(self, x):
        tp = None
        if weight_placed(self.down):
            from ..parallel.sharding import tp_pair

            tp = tp_pair([self.gate, self.up], self.down, kind="SwiGLU")
        if tp is None:
            return self.drop(self.down(F.silu(self.gate(x)) * self.up(x)))
        from ..parallel.collective import copy_to_tp

        xc = copy_to_tp(x, tp[0])
        return self.drop(self.down.row(
            F.silu(self.gate.column(xc)) * self.up.column(xc), tp[0]))


class GPTBlock(Layer):
    """Pre-norm decoder block: x + attn(rms(x)); x + ffn(rms(x)). The
    FFN is SwiGLU, or with ``moe_experts > 0`` a Switch-MoE FFN
    (nn/moe.py) that routes each call's tokens at that call's
    capacity."""

    def __init__(self, cfg: GPTConfig, *, dtype=None, device=None,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.attn_window = cfg.attn_window
        self.norm1 = nn.RMSNorm(cfg.hidden_size, **kw)
        self.self_attn = nn.MultiHeadAttention(
            cfg.hidden_size, cfg.num_heads, dropout=cfg.dropout,
            bias=False, use_flash=cfg.use_flash,
            seq_parallel=cfg.seq_parallel,
            num_kv_heads=cfg.num_kv_heads or cfg.num_heads,
            rotary=True, rotary_theta=cfg.rope_theta, **kw)
        self.norm2 = nn.RMSNorm(cfg.hidden_size, **kw)
        if cfg.moe_experts:
            self.ffn = nn.SwitchFFN(
                cfg.hidden_size, cfg.intermediate_size, cfg.moe_experts,
                capacity_factor=cfg.moe_capacity_factor, **kw)
        else:
            self.ffn = _SwiGLU(cfg.hidden_size, cfg.intermediate_size,
                               cfg.dropout, **kw)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x, kv_mask=None):
        x = x + self.drop(self.self_attn(
            self.norm1(x), causal=True, window=self.attn_window,
            attn_mask=None if kv_mask is None
            else kv_mask[:, None, None, :]))
        return x + self.ffn(self.norm2(x))


class GPTForCausalLM(Layer):
    """Token embedding -> N GPTBlocks -> final RMSNorm -> LM head.

    ``device``: the CUDA card when None (raises when there is none);
    pass ``device="cpu"`` for the CPU. ``generator``: the
    ``torch.Generator`` for the initial weights (seed 0 on ``device``
    when None). ``dtype``: parameter dtype (float32 by default).

    ``cfg.seq_parallel`` ("ring" or "ulysses") under a current mesh whose
    ``sp`` axis has more than one rank: the model takes the rank's (B/dp,
    T) ids, as the JAX Trainer's ``data_sharding`` gives them, embeds
    them and runs the blocks on the rank's T/sp rows
    (parallel/context_parallel.py). ``forward`` all-gathers the final
    hidden state over ``sp`` before the head (its backward is the
    reduce-scatter); ``forward_loss`` builds the default labels on the
    full ids before slicing, so the shift never crosses a shard edge.
    Under any mesh that spreads the batch or the sequence,
    ``forward_loss`` divides the sum of the rank's token losses by the
    count of valid tokens, both summed over the ``dp`` and ``sp`` ranks
    (parallel/context_parallel.py ``token_mean``): every rank gets the
    global loss, and the mean of the ranks' gradients, as
    ``Trainer(mesh=)`` takes it, is its gradient."""

    def __init__(self, cfg: GPTConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        enforce((cfg.hidden_size // cfg.num_heads) % 2 == 0,
                "rotary needs an even head_dim, got %s",
                cfg.hidden_size // cfg.num_heads)
        _check_supported(cfg)
        device = resolve_device(device)
        if generator is None:
            generator = make_generator(0, device)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.blocks = nn.LayerList([GPTBlock(cfg, **kw)
                                    for _ in range(cfg.num_layers)])
        self.norm_f = nn.RMSNorm(cfg.hidden_size, **kw)
        if not cfg.tie_embeddings:
            self.create_parameter("lm_head",
                                  (cfg.hidden_size, cfg.vocab_size), dtype,
                                  I.XavierUniform(), device=device,
                                  generator=generator)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def _head_weight(self):
        # a sharding plan's vocab-sharded table is gathered at use here
        # too (nn/layer.py ``use``)
        return (use(self.embed.weight).T if self.cfg.tie_embeddings
                else use(self.lm_head))

    def _trunk(self, ids, kv_mask=None):
        _check_supported(self.cfg)
        x = self.embed(ids)
        if seq_sharded(self.cfg.seq_parallel):
            x, kv_mask = seq_shard(x), seq_shard(kv_mask)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:
                # per-block recompute, flash forward included, under the
                # forward's policy and dropout masks (nn/layer.py
                # remat_call)
                x = remat_call(blk, x, kv_mask=kv_mask)
            else:
                x = blk(x, kv_mask=kv_mask)
        return self.norm_f(x)

    def forward(self, ids, kv_mask=None):
        h = self._trunk(ids, kv_mask=kv_mask)
        if seq_sharded(self.cfg.seq_parallel):
            h = seq_gather(h)
        return h @ self._head_weight()

    def forward_loss(self, ids, labels=None, kv_mask=None,
                     vocab_chunk: int = 1024, ignore_index: int = -100):
        """Mean next-token CE through the fused chunked linear-CE head
        (the (B*T, V) logits never exist). ``labels`` default to ids
        shifted left, the last position ignored; pass explicit labels
        with ``ignore_index`` holes for masked or padded positions."""
        from ..ops.fused_loss import (linear_cross_entropy,
                                      mean_linear_cross_entropy)

        h = self._trunk(ids, kv_mask=kv_mask)
        if labels is None:
            labels = torch.cat(
                [ids[:, 1:], torch.full((ids.shape[0], 1), ignore_index,
                                        dtype=ids.dtype, device=ids.device)],
                dim=1)
        b, t, d = h.shape
        if mesh_parallel():
            if seq_sharded(self.cfg.seq_parallel):
                labels = seq_shard(labels)
            labels = labels.reshape(-1)
            losses = linear_cross_entropy(
                h.reshape(b * t, d), self._head_weight(), None, labels,
                chunk=vocab_chunk, ignore_index=ignore_index)
            return token_mean(losses.sum(), (labels != ignore_index).sum())
        return mean_linear_cross_entropy(
            h.reshape(b * t, d), self._head_weight(), None,
            labels.reshape(-1), chunk=vocab_chunk, ignore_index=ignore_index)

    def _cached_blocks(self, x, caches, attn_step, head: bool = True):
        """ONE definition of the cached-decode block composition
        (norm1 -> attn -> residual -> ffn -> norm_f @ head) shared by the
        chunk, single-step and per-row entries. ``head=False`` skips the
        (S, V) head projection (cache-only prefill)."""
        new_caches = []
        for blk, (ck, cv) in zip(self.blocks, caches):
            a, ck, cv = attn_step(blk.self_attn, blk.norm1(x), ck, cv)
            x = x + a
            x = x + blk.ffn(blk.norm2(x))
            new_caches.append((ck, cv))
        if not head:
            return None, new_caches
        return self.norm_f(x) @ self._head_weight(), new_caches

    def _chunk_logits(self, toks, caches, t0, head: bool = True,
                      decode_kernel: bool = False):
        """S KV-cached positions in one pass: ``toks`` (B, S) at cache
        indices [t0, t0+S) -> ((B, S, V) logits, caches)."""
        return self._cached_blocks(
            self.embed(toks), caches,
            lambda sa, h, ck, cv: sa.forward_chunk(
                h, ck, cv, t0, window=self.cfg.attn_window,
                decode_kernel=decode_kernel),
            head=head)

    def _step_logits(self, tok, caches, t, decode_kernel: bool = False):
        """One KV-cached position: ``tok`` (B,) -> ((B, V), caches)."""
        logits, caches = self._chunk_logits(tok[:, None], caches, t,
                                            decode_kernel=decode_kernel)
        return logits[:, 0], caches

    def _step_logits_rows(self, tok, caches, t_rows,
                          decode_kernel: bool = False):
        """One KV-cached position per row at per-row cursors ``t_rows``
        (B,) — the continuous-batching step. ``tok`` (B,) -> ((B, V),
        caches)."""
        logits, caches = self._cached_blocks(
            self.embed(tok[:, None]), caches,
            lambda sa, h, ck, cv: sa.forward_step_rows(
                h, ck, cv, t_rows, window=self.cfg.attn_window,
                decode_kernel=decode_kernel))
        return logits[:, 0], caches

    def _chunk_logits_rows(self, toks, caches, t0_rows):
        """S KV-cached positions per row at per-row chunk starts
        ``t0_rows`` (B,), the arena's speculative verify: every slot
        scores its gamma+1 candidates at its own cursor in one pass.
        ``toks`` (B, S) -> ((B, S, V) logits, caches)."""
        return self._cached_blocks(
            self.embed(toks), caches,
            lambda sa, h, ck, cv: sa.forward_chunk_rows(
                h, ck, cv, t0_rows, window=self.cfg.attn_window))

    def _chunk_logits_paged_rows(self, toks, pools, table, t0_rows):
        """S positions per row against paged caches at per-row chunk
        starts (see :meth:`_chunk_logits_rows`). ``toks`` (B, S)."""
        return self._cached_blocks(
            self.embed(toks), pools,
            lambda sa, h, kp, vp: sa.forward_chunk_paged_rows(
                h, kp, vp, table, t0_rows, window=self.cfg.attn_window))

    def _step_logits_paged(self, tok, pools, table, t_rows):
        """One position per row against paged caches: ``pools`` is the
        per-block [(kpool, vpool), ...] list, ``table`` the (B, n_log)
        page table. ``tok`` (B,) -> ((B, V) logits, pools)."""
        logits, pools = self._cached_blocks(
            self.embed(tok[:, None]), pools,
            lambda sa, h, kp, vp: sa.forward_step_paged(
                h, kp, vp, table, t_rows, window=self.cfg.attn_window))
        return logits[:, 0], pools

    def _chunk_logits_paged(self, toks, pools, table_row, t0,
                            head: bool = True):
        """S prefill positions for ONE row against paged caches.
        ``toks`` (1, S)."""
        return self._cached_blocks(
            self.embed(toks), pools,
            lambda sa, h, kp, vp: sa.forward_chunk_paged(
                h, kp, vp, table_row, t0, window=self.cfg.attn_window),
            head=head)

    @torch.inference_mode()
    def generate(self, prompt_ids, max_len: int, *,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, eos_id: Optional[int] = None,
                 capacity: Optional[int] = None):
        """KV-cached continuation of ``prompt_ids`` (B, Tp) to total
        length ``max_len``; returns (B, max_len) token ids.
        ``temperature == 0`` is exact greedy; otherwise tokens are drawn
        from ``generator`` after temperature, top-k and top-p filtering.
        ``eos_id`` freezes a row once it emits eos."""
        from ..ops.sampling import sample_from_logits

        enforce(not self.training,
                "generate runs in eval mode (call .eval())")
        prompt_ids = torch.as_tensor(prompt_ids, device=self.device)
        b, tp = prompt_ids.shape
        cap = capacity or max(self.cfg.max_position, max_len)
        enforce(max_len > tp, "max_len %s must exceed prompt %s", max_len,
                tp)
        enforce(cap >= max_len, "cache capacity %s < max_len %s", cap,
                max_len)
        sampled = float(temperature) != 0.0
        enforce(not sampled or generator is not None,
                "temperature > 0 samples and needs a torch.Generator; pass "
                "temperature=0 for greedy decoding")
        caches = [blk.self_attn.init_cache(b, cap) for blk in self.blocks]
        tok = prompt_ids[:, 0]
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        outs = [tok]
        for t in range(max_len - 1):
            logits, caches = self._step_logits(tok, caches, t,
                                               decode_kernel=True)
            nxt = sample_from_logits(logits, generator, temperature, top_k,
                                     top_p).to(prompt_ids.dtype)
            if eos_id is not None:
                nxt = torch.where(done, eos_id, nxt)
            inside = t + 1 < tp
            # while still inside the prompt, feed the real next token
            tok = prompt_ids[:, t + 1] if inside else nxt
            if eos_id is not None and not inside:
                done = done | (tok == eos_id)
            outs.append(tok)
        return torch.stack(outs, dim=1)

    def greedy_decode(self, prompt_ids, max_len: int,
                      capacity: Optional[int] = None):
        """KV-cached greedy continuation — generate(temperature=0)."""
        return self.generate(prompt_ids, max_len, temperature=0.0,
                             capacity=capacity)


def loss_fn(logits, labels, ignore_index: int = -100):
    """Plain (unfused) next-token CE over (B, T, V) logits — the test
    oracle for forward_loss."""
    b, t, v = logits.shape
    flat = logits.reshape(b * t, v).float()
    lbl = labels.reshape(-1)
    keep = lbl != ignore_index
    picked = torch.log_softmax(flat, dim=-1).gather(
        1, lbl.clamp(0, v - 1)[:, None].long())[:, 0]
    return -torch.where(keep, picked, 0.0).sum() / torch.clamp(
        keep.sum(), min=1)
