"""Compressed gradient collectives: the int8 all-reduce of a sharding
plan's gradients (counterpart of paddle_tpu/quant/collectives.py).

:func:`quantized_psum` is a ring all-reduce over a named mesh axis,
reduce-scatter then all-gather, built on ``parallel.collective.ppermute``,
whose per-hop payload is the int8 ``quant.ops.absmax_encode`` wire
format: one int8 per element and a float32 abs-max scale per ``group``
elements. A reduce-scatter hop encodes one chunk, sends it on, and the
receiver decodes it and adds it in float32. The owner of each reduced
chunk encodes it once and the all-gather forwards those bytes unchanged,
so every rank, the owner included, decodes the same bytes and the
replicas stay bit for bit the same. The payload goes over the wire (and,
under gloo, through the pinned host staging of ``collective.STAGING``)
as int8 plus the scales, never as float32: ``2 * (n - 1) * (chunk +
4 * chunk / group)`` bytes a rank against ``2 * (n - 1) * 4 * chunk``.

The rails of the JAX package: leaves under ``MIN_COMPRESS_SIZE``
elements and non-float leaves take the plain float32 mean; a zero chunk
encodes exactly; a non-finite input on any rank poisons the whole
output with NaN through a ``min``-reduced finite flag, so the train
loop's nan-guard keeps firing; ``key=`` (JAX key data) rounds
stochastically (``quant.ops.absmax_encode``), the same draws on every
rank for a hop, matching the JAX draws in distribution only.

The JAX package routes both spellings through
``utils.compat.native_int8_allreduce`` when its runtime has an int8
AllReduce; that seam belongs with ``utils/compat.py`` (ROADMAP queue 1
entry 8) and the ring here always runs.

Under fsdp/tp plans the JAX package's GSPMD owns the reduce, and
:func:`compress_grads` applies the same wire format as an encode/decode
round trip at the reduce boundary. Byte accounting is host-side
(``pt_collective_bytes_total{compressed=}``): shapes are static, so the
per-step payload is computed once (:func:`tree_payload_bytes`) and the
Trainer adds it per dispatched step."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..core.enforce import enforce
from ..core.random import fold_in
from .ops import _encode_at, _encode_stochastic, absmax_decode

# elements per float32 scale of the wire format (4 / GROUP_SIZE overhead)
GROUP_SIZE = 1024
# leaves under this many elements take the float32 mean
MIN_COMPRESS_SIZE = 2048

COMPRESSION_MODES = (None, "int8", "int8_sr")


def check_mode(mode: Optional[str]) -> Optional[str]:
    """Validate a ``grad_compression`` value (None, "int8" or "int8_sr",
    the stochastic-rounding variant)."""
    enforce(mode in COMPRESSION_MODES,
            "grad_compression must be one of %s, got %r",
            COMPRESSION_MODES, mode)
    return mode


@telemetry.cached_instruments
def _comm_metrics(reg):
    """The collective byte counters (reached only when telemetry is
    on)."""
    return {
        "bytes_int8": reg.counter(
            "pt_collective_bytes_total",
            "per-device gradient-allreduce payload bytes moved by the "
            "hand-written plan collectives (int8 wire format incl. "
            "scales)", labels={"compressed": "int8"}),
        "bytes_fp32": reg.counter(
            "pt_collective_bytes_total",
            "per-device gradient-allreduce payload bytes moved by the "
            "hand-written plan collectives (fp32 payload)",
            labels={"compressed": "fp32"}),
    }


def record_payload_bytes(int8_bytes: int, fp32_bytes: int) -> None:
    """Add a step's payload bytes to the counters (nothing when telemetry
    is off)."""
    if not telemetry.enabled():
        return
    m = _comm_metrics()
    if int8_bytes:
        m["bytes_int8"].inc(int8_bytes)
    if fp32_bytes:
        m["bytes_fp32"].inc(fp32_bytes)


# --- payload bytes -------------------------------------------------------------

def _ring_chunk(size: int, n: int, group: int) -> int:
    """A rank's ring chunk in elements, padded to the group grid."""
    chunk = -(-size // n)
    return -(-chunk // group) * group


def leaf_payload_bytes(size: int, axis_size: int, *, compressed: bool,
                       group: int = GROUP_SIZE,
                       dtype_bytes: int = 4) -> int:
    """The bytes one rank sends reducing one leaf over an ``axis_size``
    ring: 2 (n - 1) hops of one chunk each, int8 and float32 group
    scales when compressed."""
    n = int(axis_size)
    if n <= 1:
        return 0
    if not compressed:
        return 2 * (n - 1) * (-(-int(size) // n)) * dtype_bytes
    chunk = _ring_chunk(int(size), n, group)
    return 2 * (n - 1) * (chunk + 4 * (chunk // group))


def _shape(leaf):
    shape = getattr(leaf, "_pt_global_shape", None)
    return tuple(leaf.shape if shape is None else shape) \
        if hasattr(leaf, "shape") else ()


def _numel(leaf) -> int:
    out = 1
    for s in _shape(leaf):
        out *= int(s)
    return out


def _is_float(leaf) -> bool:
    dt = getattr(leaf, "dtype", None)
    if isinstance(dt, torch.dtype):
        return dt.is_floating_point
    return dt is not None and getattr(dt, "kind", "") == "f"


def _itemsize(leaf) -> int:
    dt = getattr(leaf, "dtype", None)
    if isinstance(dt, torch.dtype):
        return torch.empty((), dtype=dt).element_size()
    return int(getattr(dt, "itemsize", 4))


def _compressible(leaf, min_size: int) -> bool:
    """A float leaf of at least ``min_size`` elements (a placed shard
    counts by its whole shape)."""
    return _is_float(leaf) and _numel(leaf) >= min_size


def tree_payload_bytes(tree, axis_size: int, *,
                       compression: Optional[str],
                       min_size: int = MIN_COMPRESS_SIZE,
                       group: int = GROUP_SIZE) -> Tuple[int, int]:
    """(int8 bytes, float32 bytes) one rank moves a step reducing
    ``tree`` (tensors or numpy arrays) over an ``axis_size`` ring:
    what ``pt_collective_bytes_total`` advances by. A leaf compresses
    where :func:`quantized_pmean_tree` compresses it."""
    from ..clip import tree_leaves

    i8 = f32 = 0
    for leaf in tree_leaves(tree):
        size = _numel(leaf)
        if compression and _compressible(leaf, min_size):
            i8 += leaf_payload_bytes(size, axis_size, compressed=True,
                                     group=group)
        else:
            f32 += leaf_payload_bytes(size, axis_size, compressed=False,
                                      dtype_bytes=_itemsize(leaf))
    return i8, f32


# --- the int8 ring ---------------------------------------------------------------

def _ring_perm(n: int):
    return [(i, (i + 1) % n) for i in range(n)]


# the jitted JAX package's scale: XLA folds ``absmax / 127`` into a
# product with the float32 reciprocal, an ulp off the quotient at times
_INV_QMAX = float(np.float32(1.0 / 127.0))


def _encode_groups(g, key=None):
    """The wire format of ``g`` (groups, group): (q int8, scale (groups,
    1) float32), each row at its abs-max scale as the jitted JAX package
    computes it (``absmax * float32(1/127)``, at least 1e-10), rounded
    to nearest or, with ``key``, stochastically (``quant.ops``)."""
    absmax = torch.amax(torch.abs(g), dim=1, keepdim=True).float()
    scale = torch.clamp_min(absmax * _INV_QMAX, 1e-10)
    if key is None:
        return _encode_at(g, scale), scale
    return _encode_stochastic(g, scale, key), scale


def _encode_chunk(chunk, group: int, key=None):
    """A chunk -> (q (chunk / group, group) int8, scale (chunk / group,
    1) float32)."""
    return _encode_groups(chunk.reshape(-1, group), key)


def quantized_psum(x, axis_name: str, axis_size: int, *,
                   group: int = GROUP_SIZE, key=None, mesh=None):
    """The int8 ring all-reduce of this rank's ``x`` over ``axis_name``
    (the JAX function inside a ``shard_map`` body): the sum in ``x``'s
    dtype, bit for bit the same on every rank. ``key`` (JAX key data)
    rounds each hop's payload stochastically; hop s folds s into it. The
    error grows about linearly in ``axis_size`` quantization steps (each
    reduce-scatter hop requantizes its running sum), as in the JAX
    package. No gradient: the ring reduces gradients."""
    from ..core.mesh import get_mesh
    from ..parallel.collective import allreduce, ppermute

    n = int(axis_size)
    enforce(n >= 2, "quantized_psum needs axis_size >= 2, got %s", n)
    mesh = mesh or get_mesh()
    enforce(mesh.axis_size(axis_name) == n,
            "quantized_psum: axis %r has %s ranks, not axis_size %s",
            axis_name, mesh.axis_size(axis_name), n)
    with torch.no_grad():
        shape, dt = x.shape, x.dtype
        flat = x.reshape(-1).float()
        size = flat.numel()
        chunk = _ring_chunk(size, n, group)
        parts = torch.nn.functional.pad(flat, (0, n * chunk - size)).view(
            n, chunk).clone()
        idx = mesh.axis_index(axis_name)
        perm = _ring_perm(n)
        # a non-finite input on any rank poisons the sum: quantizing it
        # would launder inf or nan into a finite payload
        ok = torch.isfinite(x).all().to(torch.int32).reshape(1)
        ok_all = allreduce(ok, axis_name, "min", mesh=mesh)
        # reduce-scatter: hop s sends chunk (idx - s) mod n as int8 and
        # scales; the receiver decodes it and adds it in float32
        for s in range(n - 1):
            hop_key = None if key is None else fold_in(key, s)
            q, sc = _encode_chunk(parts[(idx - s) % n], group, hop_key)
            q, sc = ppermute((q, sc), axis_name, perm, mesh=mesh)
            recv = (idx - s - 1) % n
            # the decode and the add in one fused multiply-add, as XLA
            # fuses the JAX package's ``parts + q * scale``
            parts[recv] = torch.addcmul(parts[recv].view(-1, group),
                                        q.float(), sc).reshape(chunk)
        # this rank owns the reduced chunk (idx + 1) mod n: encode it once
        # and forward the bytes unchanged, so every rank decodes the same
        own = (idx + 1) % n
        own_key = None if key is None else fold_in(key, n - 1)
        cur = _encode_chunk(parts[own], group, own_key)
        out_q = [None] * n
        out_s = [None] * n
        out_q[own], out_s[own] = cur
        for s in range(n - 1):
            cur = ppermute(cur, axis_name, perm, mesh=mesh)
            recv = (idx - s) % n
            out_q[recv], out_s[recv] = cur
        out = absmax_decode(torch.cat(out_q), torch.cat(out_s))
        out = out.reshape(-1)[:size]
        out = torch.where(ok_all > 0, out, torch.full_like(out, float("nan")))
        return out.reshape(shape).to(dt)


def quantized_pmean(x, axis_name: str, axis_size: int, *,
                    group: int = GROUP_SIZE, key=None, mesh=None):
    """:func:`quantized_psum` over ``axis_size`` (the mean a gradient
    reduce wants)."""
    return quantized_psum(x, axis_name, axis_size, group=group, key=key,
                          mesh=mesh) / axis_size


def quantized_psum_partitioned(x, axis_name: str, *,
                               group: int = GROUP_SIZE, key=None,
                               mesh=None):
    """The JAX package's ``custom_partitioning`` spelling, multi-
    controller: ``x`` is this rank's shard, over ``axis_name``, of the
    stacked per-shard partials (n_local, ...). The rank sums its rows in
    float32, then one :func:`quantized_psum` ring over the axis runs
    (``key`` with the rank's axis index folded in, as the JAX body
    folds it); the replicated sum (...) comes back in ``x``'s dtype.
    Where the axis has one rank (no mesh) the exact float32 sum of the
    rows is the answer, as the JAX package's eager fallback."""
    from ..core.mesh import get_mesh

    enforce(x.dim() >= 1, "quantized_psum_partitioned stacks per-shard "
            "partials on dim 0 — got a scalar")
    mesh = mesh or get_mesh()
    part = x.float().sum(0)
    n = mesh.axis_size(axis_name) if axis_name in mesh.shape else 1
    if n < 2:
        return part.to(x.dtype)
    if key is not None:
        key = fold_in(key, mesh.axis_index(axis_name))
    return quantized_psum(part, axis_name, n, group=group, key=key,
                          mesh=mesh).to(x.dtype)


def _indexed(tree, fn, counter=None):
    """``tree`` with each leaf replaced by ``fn(i, leaf)``, ``i`` its
    index in the JAX package's leaf order (``clip.tree_leaves``: a dict
    by sorted key)."""
    counter = [0] if counter is None else counter
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out[k] = _indexed(tree[k], fn, counter)
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_indexed(v, fn, counter) for v in tree)
    i = counter[0]
    counter[0] += 1
    return fn(i, tree)


def quantized_pmean_tree(tree, axis_name: str, axis_size: int, *,
                         min_size: int = MIN_COMPRESS_SIZE,
                         group: int = GROUP_SIZE, key=None, mesh=None):
    """A gradient tree's mean over ``axis_name``: float leaves of at
    least ``min_size`` elements take the int8 ring, the others (small
    biases, integer counters) the float32 mean. Each compressed leaf
    folds its index in the JAX leaf order into ``key``, so stochastic
    draws never repeat across leaves."""
    from ..parallel.collective import allreduce

    def one(i, leaf):
        if _compressible(leaf, min_size):
            k = None if key is None else fold_in(key, i)
            return quantized_pmean(leaf, axis_name, axis_size, group=group,
                                   key=k, mesh=mesh)
        with torch.no_grad():
            if leaf.is_floating_point():
                return allreduce(leaf, axis_name, "mean", mesh=mesh)
            # an integer leaf's mean, in float32 (JAX's pmean promotes)
            return allreduce(leaf.float(), axis_name, "mean", mesh=mesh)

    return _indexed(tree, one)


def compress_grads(tree, *, min_size: int = MIN_COMPRESS_SIZE,
                   group: int = GROUP_SIZE, key=None):
    """The int8 wire format's encode/decode round trip over a gradient
    tree whose reduce the plan's layers made (fsdp/tp plans): the same
    per-group abs-max grid as the ring, so the numerics are the
    quantized wire's. Non-finite leaves pass through untouched (the
    nan-guard sees the original values).

    The groups of ``group`` elements run over the WHOLE leaf flattened in
    order, as in the JAX package. A rank that holds a placed shard
    (``_pt_sharding``) whose edge falls inside a group cannot form that
    group's abs-max alone, so it all-gathers the leaf, round-trips it
    (every rank the same, the stochastic draws too: one key) and keeps
    its shard: one gather of the reduced gradient, simpler than trading
    the groups' abs-maxes where a shard's elements are not contiguous in
    the flattened leaf."""
    from ..nn.layer import use

    def one(i, leaf):
        if not _compressible(leaf, min_size):
            return leaf
        k = None if key is None else fold_in(key, i)
        with torch.no_grad():
            whole = use(leaf)
            flat = whole.reshape(-1).float()
            size = flat.numel()
            pad = -(-size // group) * group - size
            g = torch.nn.functional.pad(flat, (0, pad)).view(-1, group)
            q, sc = _encode_groups(g, k)
            deq = absmax_decode(q, sc).reshape(-1)[:size]
            deq = torch.where(torch.isfinite(whole).all(), deq, flat)
            deq = deq.reshape(whole.shape).to(leaf.dtype)
            sh = getattr(leaf, "_pt_sharding", None)
            if sh is not None:
                deq = sh.local(deq).contiguous()
                deq._pt_sharding = sh
                deq._pt_global_shape = tuple(whole.shape)
            return deq

    return _indexed(tree, one)
