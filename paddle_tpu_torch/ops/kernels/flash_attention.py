"""Flash attention over (batch, seq, heads, head_dim) tensors: the
forward and the recompute backward, each a hand-written CUDA kernel for
Hopper (``csrc/flash_attention.cu``) with its plain PyTorch version
beside it.

Replaces (TPU kernels): paddle_tpu/ops/pallas/flash_attention.py
``_fwd_kernel`` (:func:`flash_attention_fwd`), ``_dq_kernel``
(:func:`flash_attention_dq`) and ``_dkv_kernel``
(:func:`flash_attention_dkv`); its ring entry points ``ring_fwd_block``
and ``ring_bwd_block``, the same kernels with the kv side's segment ids
apart (:func:`ring_fwd_block`, :func:`ring_bwd_block`).

Bound: operations. The live scores (B*H*T*(T+1)/2 when causal) cost 4*D
flops each forward, 6*D for dq and 8*D for dk/dv, against a few tens of
MB of operands at the training shape. Design: each thread block owns a
tile of rows (query rows for the forward and dq, key rows for dk/dv) and
walks only the tiles that hold a live entry. All three run their
products on the tensor cores (``mma.sync``): bfloat16 operands directly,
float32 as three TF32 products of a hi/lo split of each operand
("3xTF32", where one TF32 pass keeps three decimal digits), each 8-deep
step summed apart and added to its sum with a rounded float32 add, since
the tensor core truncates as it accumulates: the kernels are about as
close to float64 as the plain float32 versions. Scores, p and ds stay
in the accumulator registers between the products; the forward's online
softmax runs there too (the row max over the four lanes that hold a
row). The walked tiles are double-buffered with 16-byte ``cp.async``
copies; the float32 forward splits each landed k and v tile once for
the block. Under causal the blocks with the most live tiles start first.
dk/dv loop over the GQA group inside the block, so they come back summed
onto the kv heads, with no atomics: two runs give the same bits. The
source file gives the tile shapes, the residency and what is left for a
later change.

Layout at these functions: q (B, Tq, H, D); k, v (B, Tk, Hkv, D); lse
and delta (B, H, Tq) float32; kv_mask (B, Tk) bool, True = attend. Tq
and Tk are multiples of 64 and D is 64, 128 or 256 (the dispatch gate's
rule, ``ops.attention.flash_shape_ok``). Query row r sits at position
r + Tk - Tq (bottom-right causal alignment).

Options: ``segment_ids`` (B, Tq) int: packed rows, a score is live only
where the query's and the key's ids match (segment 0, the padding tail,
attends within itself, as in the TPU kernels); the keys' ids are
``kv_segment_ids`` (B, Tk) where given, else the same array (Tq == Tk).
Ring attention's hops give them apart: the q side's ids stay home and
the kv side's travel with their block (:func:`ring_fwd_block`,
:func:`ring_bwd_block`).
``dropout_p`` with ``seeds`` (B, H) int32: attention-probability
dropout by the TPU kernels' counter-based hash (:func:`hash_keep`, bit
for bit), so the backward rebuilds the forward's mask from the seeds and
the global (row, column) with nothing stored; l sums the undropped p,
o and dv take the kept p times 1 / (1 - p), dq and dk drop dp alike.

Tiles: each kernel is built at a small menu of tiles (the source's
``launch``) and takes one per call. ``block_q`` and ``block_k`` are the
forward's query rows a block owns and the width of the key tiles it
walks; ``block_q_bwd`` is the query rows a dq block owns, and
``block_k_bwd`` the key rows a dk/dv block owns, each walking the other
side 32 at a time. (In the TPU kernels the backward pair is dq's (rows,
walk) and dk/dv's (walk, rows); the port's default backward tiles, dq
128 query rows and dk/dv 64 key rows, both walking 32, are no such
pair.) At D = 64: ``block_q`` in {64, 128}, ``block_k`` in {32, 64},
``block_q_bwd`` in {64, 128}, ``block_k_bwd`` in {32, 64, 128} (it must
divide Tk); at D = 128 and 256 only the defaults (:func:`fwd_tiles`,
:data:`DQ_ROWS`, :data:`DKV_ROWS`). A tile outside the menu raises
:class:`InvalidArgumentError` naming the menu. None takes the tile
:func:`resolve_block_sizes` picks: the tuned-block table's entry for the
shape and input type (``tuning.py``), else the default, the tile the
kernel has always run. ``ops.attention.flash_attention`` resolves the
four tiles once and names them to the three wrappers.

Dispatch: a wrapper takes the plain version only for tensors on the CPU.
For a CUDA tensor it launches the kernel or raises; there is no
fallback. Each wrapper counts its launches in ``.launches``, those of
each dtype instance in ``.dtype_launches`` ({torch dtype: count}) and
those of each tile in ``.tile_launches`` ({(torch dtype, (rows, walk)):
count}); ``.last_tiles`` is the (rows, walk) of its last launch.

Types: float32 and bfloat16. As in the TPU kernels, p is rounded to the
input type before p.v and p^T.do, ds before ds.k and ds^T.q, and every
sum is float32."""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...core.enforce import (InvalidArgumentError, KernelLaunchError,
                             enforce)
from ...utils.flops import attention_flops, costed, tensor_bytes
from ._launches import count_launch

# the TPU kernels' finite mask value (flash_attention.py _NEG_INF); p = 0
# where s <= NEG_INF / 2
NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ----- the tile menus ------------------------------------------------------

# the query rows a forward block owns, by head dim; the default first
FWD_ROWS = {64: (128, 64), 128: (64,), 256: (32,)}
# the key tiles the forward walks, by (input type, head dim); the default
# first
FWD_WALK = {(torch.float32, 64): (32, 64), (torch.bfloat16, 64): (64, 32),
            (torch.float32, 128): (32,), (torch.bfloat16, 128): (64,),
            (torch.float32, 256): (16,), (torch.bfloat16, 256): (16,)}
# the query rows a dq block owns, and the key rows a dk/dv block owns, by
# head dim; the default first. Both walk the other side 32 at a time.
DQ_ROWS = {64: (128, 64), 128: (64,), 256: (32,)}
DKV_ROWS = {64: (64, 32, 128), 128: (64,), 256: (32,)}
BWD_WALK = 32


def fwd_tiles(dtype, d: int):
    """The forward's menu at (``dtype``, ``d``): (query rows, key walk)
    pairs, the default first."""
    return tuple((r, w) for r in FWD_ROWS[d] for w in FWD_WALK[dtype, d])


def _menu_tile(what: str, value: int, menu, seq: int, whole: bool):
    """``value`` checked against its ``menu`` (and, when ``whole``, the
    length ``seq`` it must divide)."""
    if value not in menu:
        raise InvalidArgumentError(
            f"{what}={value} is not in the kernel's tile menu {menu}")
    if whole and seq % value:
        raise InvalidArgumentError(
            f"{what}={value} does not divide the sequence length {seq}; "
            f"pad upstream")
    return value


def kernel_tiles(kind: str, dtype, d: int, tq: int, tk: int, causal: bool,
                 rows=None, walk=None):
    """The (rows, walk) a kernel launches with: ``kind`` "fwd", "dq" or
    "dkv"; a named tile checked against its menu (else
    :class:`InvalidArgumentError`), None the tile
    :func:`resolve_block_sizes` picks for this shape (the tuned-block
    table's, else the default). None for a type or head dim the kernels
    do not take (their plain versions run such shapes on the CPU) when no
    tile is named."""
    if (dtype, d) not in FWD_WALK:
        if rows is None and walk is None:
            return None
        raise InvalidArgumentError(
            f"the flash kernels take float32 or bfloat16 and head_dim in "
            f"{HEAD_DIMS}, got {dtype} and {d}")
    # the plan's None, at a length that is not a multiple of 64: the
    # default, which need not divide it
    plan = (None,) * 4
    if rows is None or (kind == "fwd" and walk is None):
        plan = resolve_block_sizes(tq, tk, d, causal, dtype=dtype)
    if kind == "fwd":
        return (_named_or("block_q", rows, plan[0], FWD_ROWS[d], tk, False),
                _named_or("block_k", walk, plan[1], FWD_WALK[dtype, d], tk,
                          True))
    if kind == "dq":
        return (_named_or("block_q_bwd", rows, plan[2], DQ_ROWS[d], tk,
                          False), BWD_WALK)
    return (_named_or("block_k_bwd", rows, plan[3], DKV_ROWS[d], tk, True),
            BWD_WALK)


def _named_or(what: str, named, planned, menu, tk: int, divides: bool):
    if named is not None:
        return _menu_tile(what, named, menu, tk, divides)
    return menu[0] if planned is None else planned


def resolve_block_sizes(tq: int, tk: int, d: int, causal: bool,
                        block_q=None, block_k=None, block_q_bwd=None,
                        block_k_bwd=None, dtype=torch.float32):
    """The four tiles ``ops.attention.flash_attention`` launches with
    (counterpart of the JAX package's ``resolve_block_sizes``): a given
    tile (clamped to the length, as there; outside the menu it raises),
    else the tuned entry's (``tuning.attention_entry``, keyed with the
    input type), else the default, each candidate clamped to the length
    and taken only where it lies in the menu and, for ``block_k`` and
    ``block_k_bwd``, divides the length. As in the JAX package the
    backward's tiles default to the forward's where those were given or
    tuned; otherwise to the backward's own defaults (the kernels'
    hand-picked tiles, which the JAX pair cannot express). Returns
    (block_q, block_k, block_q_bwd, block_k_bwd); None for each at a
    shape, type or head dim the kernels do not take (the plain versions
    run such shapes on the CPU)."""
    given = (block_q, block_k, block_q_bwd, block_k_bwd)
    if given == (None,) * 4 and ((dtype, d) not in FWD_WALK or tq % 64
                                 or tk % 64):
        # a shape the kernels do not take: their plain versions run it
        # on the CPU, with no tile to pick
        return given
    if (dtype, d) not in FWD_WALK:
        raise InvalidArgumentError(
            f"the flash kernels take float32 or bfloat16 and head_dim in "
            f"{HEAD_DIMS}, got {dtype} and {d}: no tile to pick")
    tuned = {}
    if None in given:
        from .tuning import attention_entry

        tuned = attention_entry(tq, tk, d, causal, dtype)

    def _resolve(given, key, seq, menu, whole, derived):
        if given is not None:
            return _menu_tile(key, min(given, seq), menu, seq, whole)
        for cand in (tuned.get(key), derived):
            if cand and min(cand, seq) in menu and (
                    not whole or seq % min(cand, seq) == 0):
                return min(cand, seq)
        return menu[0]

    named = lambda given, key: given is not None or key in tuned
    fq = _resolve(block_q, "block_q", tq, FWD_ROWS[d], False, None)
    fk = _resolve(block_k, "block_k", tk, FWD_WALK[dtype, d], True, None)
    bq = _resolve(block_q_bwd, "block_q_bwd", tq, DQ_ROWS[d], False,
                  fq if named(block_q, "block_q") else None)
    bk = _resolve(block_k_bwd, "block_k_bwd", tk, DKV_ROWS[d], True,
                  fk if named(block_k, "block_k") else None)
    return fq, fk, bq, bk


# ----- the dropout hash ----------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """x * c mod 2**32, for int64 ``x`` in [0, 2**32) and a constant ``c``:
    two 16-bit halves of ``c``, so no int64 product overflows."""
    c &= _M32
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _xsr(x, k: int):
    """x ^ (x >> k), the shift arithmetic on the int32 whose bits ``x``
    holds (as jnp's ``>>`` on int32)."""
    signed = x - ((x >> 31) << 32)
    return x ^ ((signed >> k) & _M32)


def hash_keep(seed, rows, cols, p: float):
    """The keep-mask of the TPU kernels' counter-based dropout hash
    (paddle_tpu/ops/pallas/flash_attention.py ``_dropout_keep``) for
    broadcastable integer tensors: ``seed`` (one int32 per (batch, query
    head)), ``rows`` (query positions, r + Tk - Tq) and ``cols`` (key
    indices). Bit-identical to it: the int32 products that wrap there
    are taken mod 2**32 in int64 here, and u = (x & 0x7fffffff) * 2**-31
    is compared with ``p`` in float32, as there. The CUDA kernels compute
    the same hash (``dropout_keep`` in csrc/flash_attention.cu)."""
    seed = torch.as_tensor(seed).to(torch.int64) & _M32
    x = (_mul32(torch.as_tensor(rows).to(torch.int64) & _M32, 0x9E3779B9)
         + seed) & _M32
    x = _xsr(x, 16)
    x = _mul32(x, 0x85EBCA77)
    x = _xsr(x, 13)
    x = (x + _mul32(torch.as_tensor(cols).to(torch.int64) & _M32,
                    -1028477379)) & _M32
    x = _xsr(x, 16)
    x = _mul32(x, -1119713537)
    x = _xsr(x, 15)
    x = _mul32(x, 0x9E3779B9)
    x = _xsr(x, 16)
    u = (x & 0x7FFFFFFF).to(torch.float32) * (1.0 / 2147483648.0)
    return u >= torch.tensor(p, dtype=torch.float32)


def dropout_keep(seed, row0: int, col0: int, bq: int, bk: int, p: float):
    """(bq, bk) keep-mask of the block whose first entry is (row0, col0):
    the torch counterpart of ``_dropout_keep(seed, row0, col0, bq, bk,
    dropout_p)``, bit for bit."""
    rows = row0 + torch.arange(bq, dtype=torch.int64)[:, None]
    cols = col0 + torch.arange(bk, dtype=torch.int64)[None, :]
    return hash_keep(seed, rows, cols, p)


def keep_scale(p: float) -> float:
    """1 / (1 - p), by which kept probabilities are scaled; taken in
    float32 where it multiplies, as in the TPU kernels."""
    return 1.0 / (1.0 - p)


# ----- plain versions ------------------------------------------------------

def _keep(b, tq, tk, causal, window, kv_mask, device, segment_ids=None,
          kv_segment_ids=None, offset=0):
    """(B|1, 1, 1, Tq, Tk) keep-mask over the (b, kv head, group, q, k)
    score layout — the kernels' per-entry rule. ``offset``: how far the
    query rows stand after the keys in position (a ring hop's (my - src)
    x T), which causal and the window read."""
    rows = torch.arange(tq, device=device)[:, None] + (tk - tq + offset)
    cols = torch.arange(tk, device=device)[None, :]
    keep = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        keep &= cols <= rows
    if window is not None:
        keep &= rows - cols < window
        if not causal:
            keep &= cols - rows < window
    keep = keep[None, None, None]
    if kv_mask is not None:
        keep = keep & kv_mask.to(device=device, dtype=torch.bool)[
            :, None, None, None, :]
    if segment_ids is not None:
        # packed rows: a query sees the keys of its own segment
        seg = segment_ids.to(device)
        kseg = seg if kv_segment_ids is None else kv_segment_ids.to(device)
        keep = keep & (seg[:, None, None, :, None]
                       == kseg[:, None, None, None, :])
    return keep


def _scores(q, k, causal, scale, window, kv_mask, segment_ids,
            kv_segment_ids=None, offset=0):
    """Masked float32 scores (B, Hkv, G, Tq, Tk) and the grouped q."""
    b, tq, h, d = q.shape
    tk, kv_h = k.shape[1], k.shape[2]
    q5 = q.reshape(b, tq, kv_h, h // kv_h, d)
    s = torch.einsum("bqkgd,btkd->bkgqt", q5.float(), k.float()) * scale
    keep = _keep(b, tq, tk, causal, window, kv_mask, q.device, segment_ids,
                 kv_segment_ids, offset)
    return torch.where(keep, s, NEG_INF), q5


def _drop_mask(shape, seeds, dropout_p, device):
    """The (B, Hkv, G, Tq, Tk) dropout keep-mask of ``seeds`` (B, H), or
    None when dropout is off."""
    if not dropout_p:
        return None
    b, kv_h, g, tq, tk = shape
    rows = torch.arange(tq, device=device)[:, None] + (tk - tq)
    cols = torch.arange(tk, device=device)[None, :]
    seed = seeds.to(device).reshape(b, kv_h, g, 1, 1)
    return hash_keep(seed, rows, cols, dropout_p)


def _dropped(x, keep, dropout_p):
    """x where ``keep`` holds, scaled by 1 / (1 - p); 0 elsewhere."""
    if keep is None:
        return x
    return torch.where(keep, x * keep_scale(dropout_p), 0.0)


def flash_attention_fwd_plain(q, k, v, *, causal: bool, scale: float,
                              window: Optional[int] = None, kv_mask=None,
                              segment_ids=None, seeds=None,
                              dropout_p: float = 0.0, kv_segment_ids=None,
                              offset: int = 0):
    """Plain PyTorch version of :func:`flash_attention_fwd`: the whole
    masked row at once, in float32. Returns (o, lse); l sums the
    undropped p, o the dropped ones. ``offset``: ``_keep``'s."""
    b, tq, h, d = q.shape
    s, _ = _scores(q, k, causal, scale, window, kv_mask, segment_ids,
                   kv_segment_ids, offset)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(s <= NEG_INF * 0.5, 0.0, p)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    p = _dropped(p, _drop_mask(p.shape, seeds, dropout_p, q.device),
                 dropout_p)
    o = torch.einsum("bkgqt,btkd->bkgqd", p.to(v.dtype).float(),
                     v.float()) / l
    o = o.permute(0, 3, 1, 2, 4).reshape(b, tq, h, d).to(q.dtype)
    lse = (m + torch.log(torch.clamp(l, min=1e-37)))[..., 0]
    return o, lse.reshape(b, h, tq)


def _probs(q, k, lse, causal, scale, window, kv_mask, segment_ids,
           kv_segment_ids=None, offset=0):
    s, q5 = _scores(q, k, causal, scale, window, kv_mask, segment_ids,
                    kv_segment_ids, offset)
    b, kv_h, g, tq, _ = s.shape
    p = torch.exp(s - lse.reshape(b, kv_h, g, tq)[..., None])
    return torch.where(s <= NEG_INF * 0.5, 0.0, p), q5


def _ds(p, do5, v, delta, scale, dtype, keep, dropout_p):
    """ds = p * (dp - delta) * scale, dp = do.v^T dropped by ``keep``,
    rounded to ``dtype``."""
    b, kv_h, g, tq, _ = p.shape
    dp = torch.einsum("bqkgd,btkd->bkgqt", do5.float(), v.float())
    dp = _dropped(dp, keep, dropout_p)
    ds = p * (dp - delta.reshape(b, kv_h, g, tq)[..., None]) * scale
    return ds.to(dtype).float()


def flash_attention_dq_plain(q, k, v, do, lse, delta, *, causal: bool,
                             scale: float, window: Optional[int] = None,
                             kv_mask=None, segment_ids=None, seeds=None,
                             dropout_p: float = 0.0, kv_segment_ids=None,
                             offset: int = 0):
    """Plain PyTorch version of :func:`flash_attention_dq`."""
    b, tq, h, d = q.shape
    p, _ = _probs(q, k, lse, causal, scale, window, kv_mask, segment_ids,
                  kv_segment_ids, offset)
    keep = _drop_mask(p.shape, seeds, dropout_p, q.device)
    ds = _ds(p, do.reshape(p.shape[0], tq, p.shape[1], p.shape[2], d), v,
             delta, scale, k.dtype, keep, dropout_p)
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds, k.float())
    return dq.reshape(b, tq, h, d).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, delta, *, causal: bool,
                              scale: float, window: Optional[int] = None,
                              kv_mask=None, segment_ids=None, seeds=None,
                              dropout_p: float = 0.0, kv_segment_ids=None,
                              offset: int = 0):
    """Plain PyTorch version of :func:`flash_attention_dkv`; dk and dv
    summed over each GQA group. Returns (dk, dv)."""
    p, q5 = _probs(q, k, lse, causal, scale, window, kv_mask, segment_ids,
                   kv_segment_ids, offset)
    keep = _drop_mask(p.shape, seeds, dropout_p, q.device)
    do5 = do.reshape(q5.shape)
    # dv takes the dropped probabilities (o = p_dropped . v)
    dv = torch.einsum("bkgqt,bqkgd->btkd",
                      _dropped(p, keep, dropout_p).to(do.dtype).float(),
                      do5.float())
    ds = _ds(p, do5, v, delta, scale, q.dtype, keep, dropout_p)
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds, q5.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ----- wrappers ------------------------------------------------------------

class _FlashArgs(ctypes.Structure):
    """Mirror of ``struct FlashArgs`` in csrc/flash_attention.cu; the
    library's ``pt_flash_args_size()`` is checked against its size when
    the library loads."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "dout", "lse", "delta", "kv_mask", "o",
            "lse_out", "dq", "dk", "dv", "seg", "kseg", "seeds")]
        + [(f"{t}_s{a}", ctypes.c_longlong) for t in ("q", "k", "v", "do")
           for a in "bth"]
        + [(n, ctypes.c_int) for n in (
            "B", "Tq", "Tk", "H", "Hkv", "D", "causal", "window")]
        + [(n, ctypes.c_float) for n in (
            "scale", "dropout_p", "dropout_scale")]
        + [(n, ctypes.c_int) for n in ("tile_rows", "tile_walk")])


def _check_layout(lib):
    """Raise :class:`KernelLaunchError` unless the library's FlashArgs has
    the size of its ctypes mirror: a struct grown on one side only would
    bind garbage without an error."""
    lib.pt_flash_args_size.argtypes = []
    lib.pt_flash_args_size.restype = ctypes.c_size_t
    size = lib.pt_flash_args_size()
    if size != ctypes.sizeof(_FlashArgs):
        raise KernelLaunchError(
            f"FlashArgs is {size} bytes in the library and "
            f"{ctypes.sizeof(_FlashArgs)} in its ctypes mirror")


def _lib():
    """The built library, its layout checked and its C signatures
    declared once (pointers and the stream as c_void_p, so none is cut
    to 32 bits)."""
    from . import _build

    lib = _build.load("flash_attention")
    if not getattr(lib, "_pt_declared", False):
        _check_layout(lib)
        for fn in (lib.pt_flash_fwd, lib.pt_flash_dq, lib.pt_flash_dkv):
            fn.argtypes = [ctypes.c_int, ctypes.POINTER(_FlashArgs),
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._pt_declared = True
    return lib


def _check(q, k, v, window, kv_mask, segment_ids, seeds, dropout_p,
           *extra, kv_segment_ids=None):
    """Shapes and q's dtype for every caller; device, the other operands'
    dtypes and strides for the card."""
    b, tq, h, d = q.shape
    tk, kv_h = k.shape[1], k.shape[2]
    enforce(tuple(k.shape) == tuple(v.shape) and k.shape[0] == b
            and k.shape[3] == d,
            "k/v must both be (B=%s, Tk, Hkv, D=%s), got %s and %s", b, d,
            tuple(k.shape), tuple(v.shape))
    enforce(h % kv_h == 0, "heads %s not divisible by kv heads %s", h,
            kv_h)
    enforce(window is None or window >= 1, "window must be >= 1, got %s",
            window)
    enforce(kv_mask is None or tuple(kv_mask.shape) == (b, tk),
            "kv_mask must be (B, Tk) = (%s, %s), got %s", b, tk,
            None if kv_mask is None else tuple(kv_mask.shape))
    enforce(segment_ids is None or tuple(segment_ids.shape) == (b, tq),
            "segment_ids must be (B, Tq) = (%s, %s), got %s", b, tq,
            None if segment_ids is None else tuple(segment_ids.shape))
    if kv_segment_ids is None:
        enforce(segment_ids is None or tq == tk,
                "one segment_ids array serves both sides only when Tq == "
                "Tk, got Tq=%s, Tk=%s (give kv_segment_ids)", tq, tk)
    else:
        enforce(segment_ids is not None and tuple(kv_segment_ids.shape)
                == (b, tk),
                "kv_segment_ids must be (B, Tk) = (%s, %s) beside "
                "segment_ids, got %s", b, tk, tuple(kv_segment_ids.shape))
    enforce(0.0 <= dropout_p < 1.0, "dropout_p must be in [0, 1), got %s",
            dropout_p)
    enforce(not dropout_p or (seeds is not None
                              and tuple(seeds.shape) == (b, h)),
            "dropout_p > 0 needs seeds of shape (B, H) = (%s, %s), got %s",
            b, h, None if seeds is None else tuple(seeds.shape))
    if q.dtype not in _DTYPE_CODE:
        # the plain versions stand in for the kernels on the CPU, so they
        # refuse what the kernels refuse (float16 among them)
        raise InvalidArgumentError(
            f"the flash kernels take float32 or bfloat16, got {q.dtype}")
    if q.device.type == "cpu":
        return
    enforce(q.is_cuda, "flash attention runs on cuda or cpu, got %s",
            q.device)
    if tq % 64 or tk % 64 or d not in HEAD_DIMS:
        raise InvalidArgumentError(
            f"the flash kernels take sequence lengths divisible by 64 and "
            f"head_dim in {HEAD_DIMS}, got Tq={tq}, Tk={tk}, D={d}")
    for x in (q, k, v) + extra:
        if x.device != q.device:
            raise InvalidArgumentError(
                f"flash attention operands must share one device, got "
                f"{x.device} and {q.device}")
        if x.dtype != q.dtype:
            raise InvalidArgumentError(
                f"q, k, v and do must share one dtype, got {x.dtype} and "
                f"{q.dtype}")
        if x.stride(-1) != 1:
            raise InvalidArgumentError(
                "flash attention operands need a unit head_dim stride")


def _row_stats(x, b, h, tq):
    enforce(tuple(x.shape) == (b, h, tq) and x.dtype == torch.float32,
            "lse/delta must be float32 (B, H, Tq) = (%s, %s, %s), got %s "
            "%s", b, h, tq, x.dtype, tuple(x.shape))
    return x.contiguous()


def _args(q, k, v, do, causal, scale, window, kv_mask, seg, kseg, seeds,
          dropout_p, tiles, **ptrs):
    b, tq, h, d = q.shape
    a = _FlashArgs()
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        if x is not None:
            sb, st, sh, _ = x.stride()
            setattr(a, f"{name}_sb", sb)
            setattr(a, f"{name}_st", st)
            setattr(a, f"{name}_sh", sh)
            setattr(a, "dout" if name == "do" else name, x.data_ptr())
    for name, x in (("kv_mask", kv_mask), ("seg", seg), ("kseg", kseg),
                    ("seeds", seeds)):
        if x is not None:
            ptrs[name] = x
    for name, x in ptrs.items():
        setattr(a, name, x.data_ptr())
    a.B, a.Tq, a.Tk, a.H, a.Hkv, a.D = b, tq, k.shape[1], h, k.shape[2], d
    a.causal = int(bool(causal))
    a.window = int(window or 0)
    a.scale = float(scale)
    a.dropout_p = float(dropout_p)
    a.dropout_scale = keep_scale(dropout_p) if dropout_p else 1.0
    a.tile_rows, a.tile_walk = tiles
    return a


def _rows16(x):
    """``x`` when its rows start on 16-byte boundaries, which the kernels'
    16-byte ``cp.async`` copies need; else a contiguous copy."""
    item = x.element_size()
    if x.data_ptr() % 16 == 0 and all(
            st * item % 16 == 0 for st in x.stride()[:3]):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _options(q, kv_mask, segment_ids, seeds, dropout_p,
             kv_segment_ids=None):
    """The key-padding mask as uint8, the segment ids (both sides) and
    the seeds as int32, contiguous on q's device (None where absent; the
    seeds only under dropout)."""
    dev = q.device
    kvm = (None if kv_mask is None else
           kv_mask.to(device=dev, dtype=torch.uint8).contiguous())
    seg = (None if segment_ids is None else
           segment_ids.to(device=dev, dtype=torch.int32).contiguous())
    kseg = (seg if kv_segment_ids is None else
            kv_segment_ids.to(device=dev, dtype=torch.int32).contiguous())
    sd = (seeds.to(device=dev, dtype=torch.int32).contiguous()
          if dropout_p else None)
    return dict(kv_mask=kvm, seg=seg, kseg=kseg, seeds=sd,
                dropout_p=dropout_p)


def _launch(fn_name, q, a):
    lib = _lib()
    rc = getattr(lib, fn_name)(
        _DTYPE_CODE[q.dtype], ctypes.byref(a),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise KernelLaunchError(
            f"{fn_name} launch failed: return code {rc} (cudaGetLastError(), "
            f"or < 0 for refused arguments)")


def _cost(products: int):
    """The cost of ``products`` of attention's score-sized products
    over q (B, Tq, H, D) and k (B, Tk, Hkv, D), each input read once."""
    def cost(q, k, *args, **kwargs):
        b, tq, h, d = q.shape
        return (products * attention_flops(b, h, tq, k.shape[1], d),
                tensor_bytes((q, k, args, kwargs)))
    return cost


@costed(_cost(2))
def flash_attention_fwd(q, k, v, *, causal: bool, scale: float,
                        window: Optional[int] = None, kv_mask=None,
                        segment_ids=None, seeds=None,
                        dropout_p: float = 0.0, block_q=None, block_k=None,
                        kv_segment_ids=None):
    """Attention of q (B, Tq, H, D) over k/v (B, Tk, Hkv, D). Returns
    (o (B, Tq, H, D) in q's dtype, lse (B, H, Tq) float32); a row with no
    live key gets o = 0 and lse = -1e30. ``segment_ids`` (B, T): packed
    rows, a query sees only the keys of its own segment. ``dropout_p`` >
    0: the probabilities are dropped by the hash of ``seeds`` (B, H)
    int32 (see :func:`hash_keep`) and the kept ones scaled by 1 / (1 -
    p); lse stays that of the undropped row. ``block_q``/``block_k``: the
    tile (see the module docstring; None: the table's, else the
    default). ``kv_segment_ids`` (B, Tk): the keys' ids where they are
    not ``segment_ids``."""
    _check(q, k, v, window, kv_mask, segment_ids, seeds, dropout_p,
           kv_segment_ids=kv_segment_ids)
    tiles = kernel_tiles("fwd", q.dtype, q.shape[3], q.shape[1], k.shape[1],
                         causal, block_q, block_k)
    kw = dict(causal=causal, scale=scale, window=window, kv_mask=kv_mask,
              segment_ids=segment_ids, seeds=seeds, dropout_p=dropout_p,
              kv_segment_ids=kv_segment_ids)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, **kw)
    b, tq, h, d = q.shape
    q, k, v = (_rows16(x) for x in (q, k, v))
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    _launch("pt_flash_fwd", q, _args(
        q, k, v, None, causal, scale, window,
        **_options(q, kv_mask, segment_ids, seeds, dropout_p,
                   kv_segment_ids), tiles=tiles,
        o=o, lse_out=lse))
    count_launch(flash_attention_fwd, q.dtype, tiles)
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.dtype_launches = {}
flash_attention_fwd.tile_launches = {}
flash_attention_fwd.last_tiles = None


@costed(_cost(2))
def flash_attention_dq(q, k, v, do, lse, delta, *, causal: bool,
                       scale: float, window: Optional[int] = None,
                       kv_mask=None, segment_ids=None, seeds=None,
                       dropout_p: float = 0.0, block_q_bwd=None,
                       kv_segment_ids=None):
    """dq (B, Tq, H, D) from the forward's ``lse`` and ``delta`` =
    rowsum(do * o), both (B, H, Tq) float32; the options as the
    forward's. ``block_q_bwd``: the query rows a block owns (None: the
    table's, else the default)."""
    _check(q, k, v, window, kv_mask, segment_ids, seeds, dropout_p, do,
           kv_segment_ids=kv_segment_ids)
    tiles = kernel_tiles("dq", q.dtype, q.shape[3], q.shape[1], k.shape[1],
                         causal, block_q_bwd)
    kw = dict(causal=causal, scale=scale, window=window, kv_mask=kv_mask,
              segment_ids=segment_ids, seeds=seeds, dropout_p=dropout_p,
              kv_segment_ids=kv_segment_ids)
    if q.device.type == "cpu":
        return flash_attention_dq_plain(q, k, v, do, lse, delta, **kw)
    b, tq, h, _ = q.shape
    lse, delta = _row_stats(lse, b, h, tq), _row_stats(delta, b, h, tq)
    q, k, v, do = (_rows16(x) for x in (q, k, v, do))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("pt_flash_dq", q, _args(
        q, k, v, do, causal, scale, window,
        **_options(q, kv_mask, segment_ids, seeds, dropout_p,
                   kv_segment_ids), tiles=tiles,
        lse=lse, delta=delta, dq=dq))
    count_launch(flash_attention_dq, q.dtype, tiles)
    return dq


flash_attention_dq.launches = 0
flash_attention_dq.dtype_launches = {}
flash_attention_dq.tile_launches = {}
flash_attention_dq.last_tiles = None


@costed(_cost(2))
def flash_attention_dkv(q, k, v, do, lse, delta, *, causal: bool,
                        scale: float, window: Optional[int] = None,
                        kv_mask=None, segment_ids=None, seeds=None,
                        dropout_p: float = 0.0, block_k_bwd=None,
                        kv_segment_ids=None):
    """dk and dv (B, Tk, Hkv, D), each summed over the query heads of its
    GQA group (each head with its own dropout seed). Returns (dk, dv).
    ``block_k_bwd``: the key rows a block owns, a divisor of Tk (None:
    the table's, else the default)."""
    _check(q, k, v, window, kv_mask, segment_ids, seeds, dropout_p, do,
           kv_segment_ids=kv_segment_ids)
    tiles = kernel_tiles("dkv", q.dtype, q.shape[3], q.shape[1], k.shape[1],
                         causal, block_k_bwd)
    kw = dict(causal=causal, scale=scale, window=window, kv_mask=kv_mask,
              segment_ids=segment_ids, seeds=seeds, dropout_p=dropout_p,
              kv_segment_ids=kv_segment_ids)
    if q.device.type == "cpu":
        return flash_attention_dkv_plain(q, k, v, do, lse, delta, **kw)
    b, tq, h, _ = q.shape
    lse, delta = _row_stats(lse, b, h, tq), _row_stats(delta, b, h, tq)
    q, k, v, do = (_rows16(x) for x in (q, k, v, do))
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch("pt_flash_dkv", q, _args(
        q, k, v, do, causal, scale, window,
        **_options(q, kv_mask, segment_ids, seeds, dropout_p,
                   kv_segment_ids), tiles=tiles,
        lse=lse, delta=delta, dk=dk, dv=dv))
    count_launch(flash_attention_dkv, q.dtype, tiles)
    return dk, dv


flash_attention_dkv.launches = 0
flash_attention_dkv.dtype_launches = {}
flash_attention_dkv.tile_launches = {}
flash_attention_dkv.last_tiles = None


# ----- ring attention's hops -------------------------------------------------
#
# Ring attention (parallel/context_parallel.py) keeps the q rows home and
# rotates the K/V blocks around the 'sp' axis; each hop runs the kernels
# above on (local q, one kv block). The two entry points differ from a
# single-device call in that the forward's lse is the output the ring
# merges hops with, and the q side's and the kv side's segment ids are
# two arrays (the q ids stay home, the kv ids travel with their block).
# ``causal`` means this block is the diagonal one (the same global
# offsets): past blocks are called with causal=False, future ones not
# at all.


def _ring_delta(o, do, delta):
    """delta (B, H, Tq) float32 from the JAX layout (B, Tq, H), or
    rowsum(do * o) when None. A ``delta`` laid out (B, H, Tq) in memory
    (a transposed view) comes back as it is, uncopied."""
    if delta is None:
        delta = (do.float() * o.float()).sum(-1)
    return delta.float().transpose(1, 2).contiguous()


def ring_fwd_block_plain(q, k, v, kvm, qseg, kseg, *, causal: bool,
                         scale: float, window: Optional[int] = None,
                         offset: int = 0):
    """Plain PyTorch version of :func:`ring_fwd_block`. ``window`` and
    ``offset`` (the hop's (my - src) x T) take causal and a sliding
    window in global positions: ring attention's einsum hop."""
    return flash_attention_fwd_plain(
        q, k, v, causal=causal, scale=scale, window=window, kv_mask=kvm,
        segment_ids=qseg, kv_segment_ids=None if qseg is None else kseg,
        offset=offset)


@costed(_cost(2))
def ring_fwd_block(q, k, v, kvm, qseg, kseg, *, causal: bool, scale: float,
                   block_q=None, block_k=None, interpret=None):
    """One ring hop's forward: local q (B, Tq, H, D) against one kv block
    (B, Tk, Hkv, D; Hkv | H, the block rotates with its fewer heads).
    Returns (o, lse): o (B, Tq, H, D) in q's dtype, normalised within the
    block, and lse (B, H, Tq) float32 its per-row logsumexp, the pair the
    ring's logaddexp merge takes. A row with no live key in the block
    gets o = 0 and lse = -1e30. ``kvm`` (B, Tk) keep-mask, ``qseg`` (B,
    Tq) and ``kseg`` (B, Tk) segment ids (both or neither). On a CUDA
    tensor the forward kernel launches (``block_q``/``block_k``: its
    tile, None the table's, else the default); on a CPU tensor, or with
    ``interpret``, the plain version runs. Counts its launches in
    ``.launches`` (the forward kernel's wrapper counts them too)."""
    enforce((qseg is None) == (kseg is None),
            "ring_fwd_block takes both segment id arrays or neither")
    if interpret or q.device.type == "cpu":
        _check(q, k, v, None, kvm, qseg, None, 0.0,
               kv_segment_ids=None if qseg is None else kseg)
        return ring_fwd_block_plain(q, k, v, kvm, qseg, kseg, causal=causal,
                                    scale=scale)
    out = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                              kv_mask=kvm, segment_ids=qseg,
                              kv_segment_ids=kseg, block_q=block_q,
                              block_k=block_k)
    count_launch(ring_fwd_block, q.dtype, flash_attention_fwd.last_tiles)
    return out


ring_fwd_block.launches = 0
ring_fwd_block.dtype_launches = {}
ring_fwd_block.tile_launches = {}
ring_fwd_block.last_tiles = None


def ring_bwd_block_plain(q, k, v, kvm, qseg, kseg, o, lse, do, *,
                         causal: bool, scale: float, delta=None,
                         window: Optional[int] = None, offset: int = 0):
    """Plain PyTorch version of :func:`ring_bwd_block`; ``window`` and
    ``offset`` as in :func:`ring_fwd_block_plain`."""
    kw = dict(causal=causal, scale=scale, window=window, kv_mask=kvm,
              segment_ids=qseg, kv_segment_ids=None if qseg is None else kseg,
              offset=offset)
    dl = _ring_delta(o, do, delta)
    dq = flash_attention_dq_plain(q, k, v, do, lse, dl, **kw)
    dk, dv = flash_attention_dkv_plain(q, k, v, do, lse, dl, **kw)
    return dq, dk, dv


@costed(_cost(4))
def ring_bwd_block(q, k, v, kvm, qseg, kseg, o, lse, do, *, causal: bool,
                   scale: float, block_q=None, block_k=None, interpret=None,
                   delta=None):
    """One ring hop's backward under the ring's global softmax: p is
    recomputed against the merged ``lse`` (B, H, Tq) and delta =
    rowsum(do * o) is taken with the final output ``o``, so (dq, dk, dv)
    are this (q rows, kv block) pair's exact shares of the global
    gradients. ``delta``: optional (B, Tq, H) float32 (the JAX layout),
    hop-invariant, so the ring computes it once; ``o`` is not read when
    it is given. dk and dv come back summed over each GQA group onto the
    block's Hkv heads. On CUDA tensors the dq kernel and the dk/dv kernel
    launch (``block_q``: dq's query rows, ``block_k``: dk/dv's key rows;
    None the table's, else the default); on CPU tensors, or with
    ``interpret``, the plain versions run. Counts one launch per call that
    ran the kernels in ``.launches`` (the dq and dk/dv wrappers count
    theirs)."""
    enforce((qseg is None) == (kseg is None),
            "ring_bwd_block takes both segment id arrays or neither")
    if interpret or q.device.type == "cpu":
        _check(q, k, v, None, kvm, qseg, None, 0.0, do,
               kv_segment_ids=None if qseg is None else kseg)
        return ring_bwd_block_plain(q, k, v, kvm, qseg, kseg, o, lse, do,
                                    causal=causal, scale=scale, delta=delta)
    kw = dict(causal=causal, scale=scale, kv_mask=kvm, segment_ids=qseg,
              kv_segment_ids=kseg)
    dl = _ring_delta(o, do, delta)
    dq = flash_attention_dq(q, k, v, do, lse, dl, block_q_bwd=block_q, **kw)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, dl, block_k_bwd=block_k,
                                 **kw)
    count_launch(ring_bwd_block, q.dtype, (flash_attention_dq.last_tiles[0],
                                           flash_attention_dkv.last_tiles[0]))
    return dq, dk, dv


ring_bwd_block.launches = 0
ring_bwd_block.dtype_launches = {}
ring_bwd_block.tile_launches = {}
ring_bwd_block.last_tiles = None
