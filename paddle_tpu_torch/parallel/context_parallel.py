"""Context (sequence) parallelism: ring attention and Ulysses
all-to-all (counterpart of paddle_tpu/parallel/context_parallel.py).

Each rank holds its shard of the sequence under ``P(batch_axis, axis)``:
q (B, T/sp, H, D), k and v (B, T/sp, Hkv, D), the key-padding mask and
the segment ids (B, T/sp); each function returns the rank's shard of the
output (core/mesh.py, the design rule).

- Ring attention keeps the q rows home and rotates the K/V blocks
  around the ``sp`` axis, one ``ppermute`` hop a step, the key mask and
  the kv-side segment ids travelling with their block. Each hop gives
  its block's output and logsumexp, merged across hops with
  ``logaddexp`` (the online softmax lifted to the mesh). Strictly-future
  blocks are skipped under causal (rank r computes r + 1 hops), the
  diagonal block is the causal one, and the last hop's rotation is not
  made. The backward is its own ring: delta = rowsum(do * o) once
  against the final output, each hop's (dq, dk, dv) the exact share of
  that (q rows, kv block) pair under the merged lse, the dk and dv
  accumulators travelling with their block and one last hop bringing
  them home. Two hop computations: the flash kernels' ring entry points
  (``ops/kernels/flash_attention.py`` ``ring_fwd_block`` /
  ``ring_bwd_block``: the CUDA kernels on the card, their plain versions
  on CPU tensors under ``force_flash``, the port's interpret mode), or
  the einsum hop, those plain versions called directly with the hop's
  global offset, which also takes a sliding window (in global
  positions; hops wholly outside the band are skipped). The JAX einsum
  inner differentiates through its scan; the port's runs the same ring
  backward as the flash one (the same gradient, with every rank's
  exchanges in one fixed order).
- Ulysses: all-to-all from sequence to heads, the port's
  ``scaled_dot_product_attention`` over the full sequence and H/sp heads
  (its flash kernels on the card), all-to-all back; the key mask and the
  segment ids are all-gathered.
- ``sharded_flash_attention``: flash attention on the rank's (batch,
  head) shard, no collectives; the dropout key folded with the mesh
  coordinates, so each shard draws its own masks."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.enforce import enforce
from ..core.mesh import get_mesh, reduce_axes
from .collective import _all_to_all, _Ctx, _ppermute, allgather

_NEG_INF = -1e30  # finite, as in the flash kernels


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------


def _ring_step_gate(src, my_idx, *, t_local, causal, window):
    """Does the block from ``src`` reach any of ``my_idx``'s rows? No for
    strictly-future blocks (causal) and blocks wholly outside the window
    band: the ring skips their whole compute."""
    gate = True
    if causal:
        gate &= src <= my_idx
    if window is not None:
        lo_ok = (src + 1) * t_local - 1 >= my_idx * t_local - (window - 1)
        in_band = lo_ok if causal else (
            lo_ok and src * t_local <= (my_idx + 1) * t_local - 1
            + (window - 1))
        gate &= in_band
    return gate


def _rotate(c, perm, *xs):
    """The ring's hop: each tensor to the next rank (None stays None)."""
    moved = iter(_ppermute(c, [x for x in xs if x is not None], perm))
    return tuple(None if x is None else next(moved) for x in xs)


class _Ring(torch.autograd.Function):
    """Ring attention over the ``sp`` group ``c``; ``hop`` is None for
    the einsum hop, else the flash tiles (block_q, block_k, block_q_bwd,
    block_k_bwd) of the kernels' entry points."""

    @staticmethod
    def forward(ctx, q, k, v, km, seg, c, causal, window, scale, hop):
        from ..ops.kernels.flash_attention import (ring_fwd_block,
                                                   ring_fwd_block_plain)

        b, t, h, d = q.shape
        n, my = c.n, c.index
        perm = [(i, (i + 1) % n) for i in range(n)]
        o = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, t), _NEG_INF, dtype=torch.float32,
                         device=q.device)
        kc, vc, kmc, ksc = k, v, km, seg
        for step in range(n):
            src = (my - step) % n
            if _ring_step_gate(src, my, t_local=t, causal=causal,
                               window=window):
                if hop is None:
                    o_s, lse_s = ring_fwd_block_plain(
                        q, kc, vc, kmc, seg, ksc, causal=causal,
                        scale=scale, window=window, offset=(my - src) * t)
                else:
                    o_s, lse_s = ring_fwd_block(
                        q, kc, vc, kmc, seg, ksc,
                        causal=causal and src == my, scale=scale,
                        block_q=hop[0], block_k=hop[1])
                new = torch.logaddexp(lse, lse_s)
                o = (o * torch.exp(lse - new).transpose(1, 2)[..., None]
                     + o_s.float()
                     * torch.exp(lse_s - new).transpose(1, 2)[..., None])
                lse = new
            if step < n - 1:
                kc, vc, kmc, ksc = _rotate(c, perm, kc, vc, kmc, ksc)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, km, seg, o, lse)
        ctx.c, ctx.causal, ctx.window, ctx.scale, ctx.hop = (
            c, causal, window, scale, hop)
        return o

    @staticmethod
    def backward(ctx, do):
        from ..ops.kernels.flash_attention import (ring_bwd_block,
                                                   ring_bwd_block_plain)

        q, k, v, km, seg, o, lse = ctx.saved_tensors
        c, causal, window, scale, hop = (ctx.c, ctx.causal, ctx.window,
                                         ctx.scale, ctx.hop)
        t = q.shape[1]
        n, my = c.n, c.index
        perm = [(i, (i + 1) % n) for i in range(n)]
        do = do.contiguous()
        # hop-invariant, against the final output: once, not n times;
        # (B, T, H) over memory laid out (B, H, T), the hops' layout, so
        # no hop copies it
        delta = (do.float() * o.float()).sum(-1).transpose(
            1, 2).contiguous().transpose(1, 2)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kc, vc, kmc, ksc = k, v, km, seg
        for step in range(n):
            src = (my - step) % n
            if _ring_step_gate(src, my, t_local=t, causal=causal,
                               window=window):
                if hop is None:
                    parts = ring_bwd_block_plain(
                        q, kc, vc, kmc, seg, ksc, o, lse, do, causal=causal,
                        scale=scale, delta=delta, window=window,
                        offset=(my - src) * t)
                else:
                    parts = ring_bwd_block(
                        q, kc, vc, kmc, seg, ksc, o, lse, do,
                        causal=causal and src == my, scale=scale,
                        block_q=hop[2], block_k=hop[3], delta=delta)
                dq += parts[0].float()
                dkc += parts[1].float()
                dvc += parts[2].float()
            if step < n - 1:
                # the block's accumulators travel with it
                kc, vc, kmc, ksc, dkc, dvc = _rotate(c, perm, kc, vc, kmc,
                                                     ksc, dkc, dvc)
        if n > 1:
            # one last hop brings each block's dk and dv home
            dkc, dvc = _rotate(c, perm, dkc, dvc)
        return (dq.to(q.dtype), dkc.to(k.dtype), dvc.to(v.dtype)) + (
            None,) * 7


def _check_local(q, k, v, kv_mask, segment_ids, window):
    b, t, h, d = q.shape
    hkv = k.shape[2]
    enforce(tuple(k.shape) == tuple(v.shape) and k.shape[0] == b
            and k.shape[1] == t and k.shape[3] == d,
            "ring attention is self-attention shaped: k/v must be (%s, %s, "
            "kv_heads, %s), got k=%s v=%s", b, t, d, tuple(k.shape),
            tuple(v.shape))
    enforce(h % hkv == 0,
            "q heads %s must be a multiple of kv heads %s (GQA)", h, hkv)
    for name, arr in (("kv_mask", kv_mask), ("segment_ids", segment_ids)):
        if arr is not None:
            enforce(tuple(arr.shape) == (b, t),
                    "%s must be (batch, seq) = (%s, %s) (the rank's shard), "
                    "got %s", name, b, t, tuple(arr.shape))
    enforce(window is None or window >= 1,
            "window must be >= 1, got %s", window)


def ring_attention(q, k, v, *, causal: bool = False,
                   scale: Optional[float] = None, axis: str = "sp",
                   batch_axis: Optional[str] = "dp", mesh=None,
                   kv_mask=None, segment_ids=None,
                   window: Optional[int] = None,
                   use_flash: bool = True):
    """Sequence-parallel attention over the rank's shards under
    ``P(batch_axis, axis)``: q (B, T/sp, H, D), k/v (B, T/sp, Hkv, D),
    ``kv_mask`` and ``segment_ids`` (B, T/sp); returns the rank's (B,
    T/sp, H, D) output. Causal masking and ``window`` are in global
    positions; segment ids are global per row (a segment spanning a
    shard edge keeps one id). ``use_flash``: each hop on the flash
    kernels' ring entry points where the per-shard shape passes the
    flash gate (on the card, or under ``force_flash``) and no window is
    set; else the einsum hop. GQA: the kv blocks rotate with their fewer
    heads."""
    from ..ops.attention import _flash_ok

    mesh = mesh or get_mesh()
    enforce(batch_axis is None or batch_axis in mesh.shape,
            "batch_axis %r is not a mesh axis", batch_axis)
    c = _Ctx(axis, mesh)
    b, t, h, d = q.shape
    _check_local(q, k, v, kv_mask, segment_ids, window)
    if scale is None:
        scale = d ** -0.5
    hop = None
    if use_flash and window is None and _flash_ok(q, k, causal=causal):
        from ..ops.kernels.flash_attention import resolve_block_sizes

        hop = resolve_block_sizes(t, t, d, causal, dtype=q.dtype)
    seg = None if segment_ids is None else segment_ids.to(torch.int32)
    return _Ring.apply(q, k, v, kv_mask, seg, c, bool(causal), window,
                       float(scale), hop)


# ---------------------------------------------------------------------------
# Ulysses (all-to-all) sequence parallelism
# ---------------------------------------------------------------------------


class _AllToAllMany(torch.autograd.Function):
    """The all-to-all of several tensors over one group, in one order in
    both directions."""

    @staticmethod
    def forward(ctx, c, split, concat, *xs):
        ctx.c, ctx.split, ctx.concat = c, split, concat
        return tuple(_all_to_all(c, x, split, concat) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None) + tuple(
            _all_to_all(ctx.c, g, ctx.concat, ctx.split) for g in gs)


def _a2a(c, split, concat, *xs):
    if c.group is None:
        return xs
    return _AllToAllMany.apply(c, split, concat, *xs)


def ulysses_attention(q, k, v, *, causal: bool = False,
                      scale: Optional[float] = None, axis: str = "sp",
                      batch_axis: Optional[str] = "dp", mesh=None,
                      use_flash: bool = True, kv_mask=None,
                      segment_ids=None, window: Optional[int] = None):
    """DeepSpeed-Ulysses sequence parallelism over the rank's shards:
    all-to-all from (B, T/sp, H, D) to (B, T, H/sp, D), the port's
    ``scaled_dot_product_attention`` over the full sequence (its flash
    kernels on the card), all-to-all back. Heads and kv heads must divide
    by sp (each rank takes whole GQA groups; ring takes kv_heads < sp).
    ``kv_mask`` (B, Tk/sp) and ``segment_ids`` (B, T/sp, self-attention
    only) are all-gathered over the axis."""
    from ..ops.attention import scaled_dot_product_attention

    mesh = mesh or get_mesh()
    enforce(batch_axis is None or batch_axis in mesh.shape,
            "batch_axis %r is not a mesh axis", batch_axis)
    c = _Ctx(axis, mesh)
    n = c.n
    b, t, h, d = q.shape
    hkv = k.shape[2]
    enforce(h % n == 0, "num heads %s must divide sp size %s (Ulysses)", h,
            n)
    enforce(h % hkv == 0,
            "q heads %s must be a multiple of kv heads %s (GQA)", h, hkv)
    enforce(hkv % n == 0,
            "kv heads %s must divide sp size %s (Ulysses GQA shards whole "
            "groups per device; use seq_parallel='ring' for kv_heads < "
            "sp)", hkv, n)
    if kv_mask is not None:
        tk = k.shape[1]
        enforce(tuple(kv_mask.shape) == (b, tk),
                "kv_mask must be (batch, key_seq) = (%s, %s) (the rank's "
                "shard), got %s", b, tk, tuple(kv_mask.shape))
    if segment_ids is not None:
        enforce(q.shape[1] == k.shape[1],
                "segment_ids requires self-attention shapes (tq=%s != "
                "tk=%s)", q.shape[1], k.shape[1])
        enforce(tuple(segment_ids.shape) == (b, t),
                "segment_ids must be (batch, seq) = (%s, %s) (the rank's "
                "shard), got %s", b, t, tuple(segment_ids.shape))
    enforce(window is None or window >= 1,
            "window must be >= 1, got %s", window)
    if scale is None:
        scale = d ** -0.5
    q, k, v = _a2a(c, 2, 1, q, k, v)
    mask = None
    if kv_mask is not None:
        mask = allgather(kv_mask, axis, dim=1, mesh=mesh)[:, None, None, :]
    seg_full = None
    if segment_ids is not None:
        seg_full = allgather(segment_ids, axis, dim=1, mesh=mesh)
    o = scaled_dot_product_attention(q, k, v, mask=mask, causal=causal,
                                     scale=scale, use_flash=use_flash,
                                     segment_ids=seg_full, window=window)
    return _a2a(c, 1, 2, o)[0]


def context_parallel_attention(q, k, v, *, impl: str = "ring", **kw):
    """Dispatch helper: ``impl`` in {"ring", "ulysses"}."""
    if impl == "ring":
        return ring_attention(q, k, v, **kw)
    if impl == "ulysses":
        return ulysses_attention(q, k, v, **kw)
    raise ValueError(f"unknown context-parallel impl {impl!r}")


def sharded_flash_attention(q, k, v, *, mesh=None, batch_axis="dp",
                            head_axis=None, causal=False, scale=None,
                            kv_mask=None, segment_ids=None, window=None,
                            dropout_p=0.0, dropout_key=None):
    """Flash attention on the rank's shard under ``P(batch_axis, None,
    head_axis, None)`` (attention needs no collective over batch or
    heads): q (B/dp, T, H/tp, D), k/v (B/dp, Tk, Hkv/tp, D), the mask and
    the ids (B/dp, T). ``dropout_key``: JAX key data (uint32[2], as
    ``core.random`` keys are); each shard folds its mesh coordinates into
    it (``core.random.fold_in``, ``jax.random.fold_in`` bit for bit) and
    draws its masks from a generator seeded by the folded key
    (``core.random.seed_generator``), so shards drop differently and a
    key gives the same masks every time."""
    from ..core.random import fold_in, seed_generator
    from ..ops.attention import flash_attention

    mesh = mesh or get_mesh()
    for name, ax in (("batch_axis", batch_axis), ("head_axis", head_axis)):
        enforce(ax is None or ax in mesh.shape,
                "%s %r is not a mesh axis (mesh has %s)", name, ax,
                sorted(mesh.shape))
    b, t = q.shape[:2]
    tk = k.shape[1]
    for name, arr, length in (("kv_mask", kv_mask, tk),
                              ("segment_ids", segment_ids, t)):
        if arr is not None:
            enforce(tuple(arr.shape) == (b, length),
                    "%s must be (batch, %s), got %s", name, length,
                    tuple(arr.shape))
    gen = None
    if dropout_key is not None:
        key = dropout_key
        for ax in (batch_axis, head_axis):
            if ax is not None:
                key = fold_in(key, mesh.axis_index(ax))
        gen = seed_generator(torch.Generator(device=q.device), key)
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           kv_mask=kv_mask, segment_ids=segment_ids,
                           window=window, dropout_p=dropout_p,
                           dropout_key=gen)


# ---------------------------------------------------------------------------
# the models' sequence-parallel plumbing
# ---------------------------------------------------------------------------


def seq_sharded(seq_parallel) -> bool:
    """Whether a model built with ``seq_parallel`` shards its sequence
    here: set, and the current mesh's ``sp`` axis has more than one
    rank. With one rank the model runs whole (its attention still takes
    the context-parallel path, a ring of one hop)."""
    return seq_parallel is not None and get_mesh().size_of("sp") > 1


def seq_shard(x, dim: int = 1):
    """The rank's rows of ``x`` along ``dim`` (its ``sp`` shard); None
    stays None. A slice: its backward puts the rank's cotangent back in
    place."""
    if x is None:
        return None
    mesh = get_mesh()
    n = mesh.size_of("sp")
    enforce(x.shape[dim] % n == 0, "sequence length %s must divide sp size "
            "%s", x.shape[dim], n)
    t = x.shape[dim] // n
    return x.narrow(dim, mesh.coordinate.get("sp", 0) * t, t)


def seq_gather(x, dim: int = 1):
    """Every rank's rows along ``dim``, in order: the all-gather over
    ``sp`` (backward: the reduce-scatter, JAX's transpose)."""
    return allgather(x, "sp", dim=dim)


def token_mean(total, count):
    """sum of ``total`` / sum of ``count`` (at least 1), each summed over
    the current mesh's data axes (``core.mesh.reduce_axes``: its batch
    axes, ``dp`` and under a plan ``fsdp``, and ``sp``): the mean over
    every valid token of the global batch, never a mean of the ranks'
    means (ranks count different numbers of tokens: the last ``sp`` rank
    keeps the shift's ignored column, and ignored labels fall anywhere).
    Every rank gets the global loss; each one's gradient is the data
    axes' size times its share (the sum's JAX transpose), so the
    Trainer's mean over them is the gradient of the global loss. ``tp``
    and ``ep`` ranks hold the same rows: the sum leaves them out."""
    from .collective import allreduce

    axes = reduce_axes()
    count = allreduce(count.to(total.dtype), axes)
    return allreduce(total, axes) / torch.clamp(count, min=1.0)


def mesh_parallel() -> bool:
    """Whether the current mesh spreads the batch or the sequence over
    more than one rank (a loss then takes :func:`token_mean`)."""
    return bool(reduce_axes())
