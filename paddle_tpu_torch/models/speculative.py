"""Speculative decoding (counterpart of paddle_tpu/models/speculative.py):
a small draft model proposes ``gamma`` tokens autoregressively, the
target scores all gamma+1 positions in one KV-cached chunk, and a
modified rejection test accepts a prefix — the output is distributed
exactly as the target's own sampling chain (the Leviathan/Chen 2023
construction), and greedy output is the target's greedy decode.

The JAX package vmaps one row's ``lax.while_loop`` over the batch; here
each row runs its rounds in a Python loop (eager PyTorch), with the same
caches, cursors and acceptance rule. Rejected positions leave stale K/V
above the row's cursor; the ``<= t`` mask hides them until they are
overwritten. Sampled draws are keyed by (row, round, salt) from a seed
drawn once from ``generator`` (``ops.sampling.keyed_categorical``), as
the JAX function folds its key by row and round."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.enforce import enforce
from ..ops.sampling import (filter_logits, generator_seed,
                            keyed_categorical, keyed_uniform)


@torch.inference_mode()
def speculative_generate(target, draft, prompt_ids, max_len: int, *,
                         gamma: int = 4,
                         generator: Optional[torch.Generator] = None,
                         temperature: float = 1.0, top_k: int = 0,
                         top_p: float = 1.0,
                         eos_id: Optional[int] = None,
                         capacity: Optional[int] = None,
                         return_stats: bool = False):
    """Continue ``prompt_ids`` (B, Tp) to (B, max_len) token ids, drawing
    from the target model's (filtered) distribution while running most
    positions through ``draft``.

    ``temperature == 0`` is exact greedy (accepted drafts are exactly
    the positions where the two argmaxes agree). Otherwise tokens are
    distributed as target sampling with the same temperature, top_k and
    top_p, keyed from ``generator``. ``eos_id`` stops a row once emitted
    and fills the rest of the row with eos. With ``return_stats`` also
    returns per-row ``accepted_drafts`` and ``rounds`` (tokens per
    target call = 1 + accepted / rounds). Both models must share the
    vocabulary and the device."""
    enforce(gamma >= 1, "gamma must be >= 1, got %s", gamma)
    enforce(not target.training and not draft.training,
            "speculative_generate runs in eval mode (call .eval())")
    enforce(target.cfg.vocab_size == draft.cfg.vocab_size,
            "vocab mismatch: target %s vs draft %s",
            target.cfg.vocab_size, draft.cfg.vocab_size)
    dev = target.device
    enforce(draft.device == dev, "the draft lives on %s, the target on %s",
            draft.device, dev)
    prompt_ids = torch.as_tensor(prompt_ids, device=dev)
    b, tp = prompt_ids.shape
    enforce(max_len > tp, "max_len %s must exceed prompt %s", max_len, tp)
    cap = capacity or max(target.cfg.max_position, max_len + gamma)
    enforce(cap >= max_len + gamma,
            "cache capacity %s < max_len + gamma = %s (target chunk writes "
            "run past max_len on the last round)", cap, max_len + gamma)
    sampled = float(temperature) != 0.0
    enforce(not sampled or generator is not None,
            "temperature > 0 samples and needs a torch.Generator; pass "
            "temperature=0 for greedy decoding")
    seed = generator_seed(generator) if sampled else 0
    # padded past max_len so the final round's (gamma+1)-token write
    # never clamps back over valid tokens
    buf_len = max_len + gamma + 1

    def flp(logits):
        return torch.log_softmax(filter_logits(logits, temperature, top_k,
                                               top_p), dim=-1)

    def one_row(row_idx: int):
        prompt_row = prompt_ids[row_idx]
        tokens = torch.zeros((buf_len,), dtype=prompt_ids.dtype,
                             device=dev)
        tokens[:tp] = prompt_row
        caches_t = [blk.self_attn.init_cache(1, cap)
                    for blk in target.blocks]
        caches_d = [blk.self_attn.init_cache(1, cap)
                    for blk in draft.blocks]
        # caches hold [0, tp-1): each round refeeds the token at t-1
        # through both models
        if tp > 1:
            target._chunk_logits(prompt_row[None, :tp - 1], caches_t, 0,
                                 head=False)
            draft._chunk_logits(prompt_row[None, :tp - 1], caches_d, 0,
                                head=False)
        row = torch.full((1,), row_idx, dtype=torch.int64, device=dev)
        t, rnd, acc = tp, 0, 0
        done = False
        while t < max_len and not done:
            nonce = torch.full((1,), rnd, dtype=torch.int64, device=dev)
            last = tokens[t - 1:t]
            drafts, qs = [], []
            tok = last
            for i in range(gamma):
                logits, caches_d = draft._step_logits(tok, caches_d,
                                                      t - 1 + i)
                if sampled:
                    lq = flp(logits)
                    d = keyed_categorical(lq, seed, row, nonce, 1 + i)
                    qs.append(torch.exp(lq[0]))
                else:
                    d = torch.argmax(logits, dim=-1)
                tok = d.to(tokens.dtype)
                drafts.append(tok)
            # also cache d_{gamma-1}'s K/V at t+gamma-1: on a fully
            # accepted round no later write covers it
            draft._step_logits(drafts[-1], caches_d, t - 1 + gamma)
            drafts = torch.cat(drafts)                           # (gamma,)
            chunk = torch.cat([last, drafts])[None]
            logits_t, caches_t = target._chunk_logits(chunk, caches_t,
                                                      t - 1)
            if sampled:
                p_all = torch.exp(flp(logits_t[0]))      # (gamma+1, V)
                q_all = torch.stack(qs)                  # (gamma, V)
                ar = torch.arange(gamma, device=dev)
                pi, qi = p_all[ar, drafts], q_all[ar, drafts]
                u = keyed_uniform(seed, row, nonce, 1 + gamma, gamma)[0]
                accept = u * qi < pi
                n = int(torch.cumprod(accept.to(torch.int32), 0).sum())
                p_n = p_all[n]
                q_n = (q_all[n] if n < gamma
                       else torch.zeros_like(p_n))
                res = torch.clamp(p_n - q_n, min=0.0)
                norm = res.sum()
                res = res / norm if float(norm) > 0 else p_n
                corr = keyed_categorical(
                    torch.where(res > 0, torch.log(res),
                                float("-inf"))[None], seed, row, nonce,
                    2 + gamma)[0]
            else:
                tgt = torch.argmax(logits_t[0], dim=-1)   # (gamma+1,)
                accept = drafts == tgt[:gamma].to(drafts.dtype)
                n = int(torch.cumprod(accept.to(torch.int32), 0).sum())
                corr = tgt[n]
            emitted = torch.cat([drafts[:n], corr.reshape(1).to(
                tokens.dtype)])
            tokens[t:t + n + 1] = emitted
            if eos_id is not None:
                done = bool((emitted == eos_id).any())
            t += n + 1
            rnd += 1
            acc += n
        out = tokens[:max_len]
        if eos_id is not None:
            pos = torch.arange(max_len, device=dev)
            hit = (out == eos_id) & (pos >= tp)
            if bool(hit.any()):
                first = int(torch.argmax(hit.to(torch.int32)))
                out = torch.where(pos > first, eos_id, out)
        return out, acc, rnd

    rows = [one_row(i) for i in range(b)]
    out = torch.stack([r[0] for r in rows])
    if return_stats:
        return out, {"accepted_drafts": torch.tensor([r[1] for r in rows]),
                     "rounds": torch.tensor([r[2] for r in rows])}
    return out
