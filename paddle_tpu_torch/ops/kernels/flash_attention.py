"""Flash attention over (batch, seq, heads, head_dim) tensors: the
forward and the recompute backward, each a hand-written CUDA kernel for
Hopper (``csrc/flash_attention.cu``) with its plain PyTorch version
beside it.

Replaces (TPU kernels): paddle_tpu/ops/pallas/flash_attention.py
``_fwd_kernel`` (:func:`flash_attention_fwd`), ``_dq_kernel``
(:func:`flash_attention_dq`) and ``_dkv_kernel``
(:func:`flash_attention_dkv`).

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

Options: ``segment_ids`` (B, T) int, Tq == Tk: packed rows, a score is
live only where the query's and the key's ids match (segment 0, the
padding tail, attends within itself, as in the TPU kernels).
``dropout_p`` with ``seeds`` (B, H) int32: attention-probability
dropout by the TPU kernels' counter-based hash (:func:`hash_keep`, bit
for bit), so the backward rebuilds the forward's mask from the seeds and
the global (row, column) with nothing stored; l sums the undropped p,
o and dv take the kept p times 1 / (1 - p), dq and dk drop dp alike.

Dispatch: a wrapper takes the plain version only for tensors on the CPU.
For a CUDA tensor it launches the kernel or raises; there is no
fallback. Each wrapper counts its launches in ``.launches``, and those of
each dtype instance in ``.dtype_launches`` ({torch dtype: count}).

Types: float32 and bfloat16. As in the TPU kernels, p is rounded to the
input type before p.v and p^T.do, ds before ds.k and ds^T.q, and every
sum is float32."""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...core.enforce import (InvalidArgumentError, KernelLaunchError,
                             enforce)
from ._launches import count_launch

# the TPU kernels' finite mask value (flash_attention.py _NEG_INF); p = 0
# where s <= NEG_INF / 2
NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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

def _keep(b, tq, tk, causal, window, kv_mask, device, segment_ids=None):
    """(B|1, 1, 1, Tq, Tk) keep-mask over the (b, kv head, group, q, k)
    score layout — the kernels' per-entry rule."""
    rows = torch.arange(tq, device=device)[:, None] + (tk - tq)
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
        # packed rows: a query sees the keys of its own segment (Tq == Tk)
        seg = segment_ids.to(device)
        keep = keep & (seg[:, None, None, :, None]
                       == seg[:, None, None, None, :])
    return keep


def _scores(q, k, causal, scale, window, kv_mask, segment_ids):
    """Masked float32 scores (B, Hkv, G, Tq, Tk) and the grouped q."""
    b, tq, h, d = q.shape
    tk, kv_h = k.shape[1], k.shape[2]
    q5 = q.reshape(b, tq, kv_h, h // kv_h, d)
    s = torch.einsum("bqkgd,btkd->bkgqt", q5.float(), k.float()) * scale
    keep = _keep(b, tq, tk, causal, window, kv_mask, q.device, segment_ids)
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
                              dropout_p: float = 0.0):
    """Plain PyTorch version of :func:`flash_attention_fwd`: the whole
    masked row at once, in float32. Returns (o, lse); l sums the
    undropped p, o the dropped ones."""
    b, tq, h, d = q.shape
    s, _ = _scores(q, k, causal, scale, window, kv_mask, segment_ids)
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


def _probs(q, k, lse, causal, scale, window, kv_mask, segment_ids):
    s, q5 = _scores(q, k, causal, scale, window, kv_mask, segment_ids)
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
                             dropout_p: float = 0.0):
    """Plain PyTorch version of :func:`flash_attention_dq`."""
    b, tq, h, d = q.shape
    p, _ = _probs(q, k, lse, causal, scale, window, kv_mask, segment_ids)
    keep = _drop_mask(p.shape, seeds, dropout_p, q.device)
    ds = _ds(p, do.reshape(p.shape[0], tq, p.shape[1], p.shape[2], d), v,
             delta, scale, k.dtype, keep, dropout_p)
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds, k.float())
    return dq.reshape(b, tq, h, d).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, delta, *, causal: bool,
                              scale: float, window: Optional[int] = None,
                              kv_mask=None, segment_ids=None, seeds=None,
                              dropout_p: float = 0.0):
    """Plain PyTorch version of :func:`flash_attention_dkv`; dk and dv
    summed over each GQA group. Returns (dk, dv)."""
    p, q5 = _probs(q, k, lse, causal, scale, window, kv_mask, segment_ids)
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
            "lse_out", "dq", "dk", "dv", "seg", "seeds")]
        + [(f"{t}_s{a}", ctypes.c_longlong) for t in ("q", "k", "v", "do")
           for a in "bth"]
        + [(n, ctypes.c_int) for n in (
            "B", "Tq", "Tk", "H", "Hkv", "D", "causal", "window")]
        + [(n, ctypes.c_float) for n in (
            "scale", "dropout_p", "dropout_scale")])


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
           *extra):
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
    enforce(segment_ids is None or (tq == tk and tuple(segment_ids.shape)
                                    == (b, tq)),
            "segment_ids must be (B, T) = (%s, %s) with Tq == Tk, got %s "
            "(Tk=%s)", b, tq,
            None if segment_ids is None else tuple(segment_ids.shape), tk)
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


def _args(q, k, v, do, causal, scale, window, kv_mask, seg, seeds,
          dropout_p, **ptrs):
    b, tq, h, d = q.shape
    a = _FlashArgs()
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        if x is not None:
            sb, st, sh, _ = x.stride()
            setattr(a, f"{name}_sb", sb)
            setattr(a, f"{name}_st", st)
            setattr(a, f"{name}_sh", sh)
            setattr(a, "dout" if name == "do" else name, x.data_ptr())
    for name, x in (("kv_mask", kv_mask), ("seg", seg), ("seeds", seeds)):
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
    return a


def _rows16(x):
    """``x`` when its rows start on 16-byte boundaries, which the kernels'
    16-byte ``cp.async`` copies need; else a contiguous copy."""
    item = x.element_size()
    if x.data_ptr() % 16 == 0 and all(
            st * item % 16 == 0 for st in x.stride()[:3]):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _options(q, kv_mask, segment_ids, seeds, dropout_p):
    """The key-padding mask as uint8, the segment ids and the seeds as
    int32, contiguous on q's device (None where absent; the seeds only
    under dropout)."""
    dev = q.device
    kvm = (None if kv_mask is None else
           kv_mask.to(device=dev, dtype=torch.uint8).contiguous())
    seg = (None if segment_ids is None else
           segment_ids.to(device=dev, dtype=torch.int32).contiguous())
    sd = (seeds.to(device=dev, dtype=torch.int32).contiguous()
          if dropout_p else None)
    return dict(kv_mask=kvm, seg=seg, seeds=sd, dropout_p=dropout_p)


def _launch(fn_name, q, a):
    lib = _lib()
    rc = getattr(lib, fn_name)(
        _DTYPE_CODE[q.dtype], ctypes.byref(a),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise KernelLaunchError(
            f"{fn_name} launch failed: cudaGetLastError() = {rc}")


def flash_attention_fwd(q, k, v, *, causal: bool, scale: float,
                        window: Optional[int] = None, kv_mask=None,
                        segment_ids=None, seeds=None,
                        dropout_p: float = 0.0):
    """Attention of q (B, Tq, H, D) over k/v (B, Tk, Hkv, D). Returns
    (o (B, Tq, H, D) in q's dtype, lse (B, H, Tq) float32); a row with no
    live key gets o = 0 and lse = -1e30. ``segment_ids`` (B, T): packed
    rows, a query sees only the keys of its own segment. ``dropout_p`` >
    0: the probabilities are dropped by the hash of ``seeds`` (B, H)
    int32 (see :func:`hash_keep`) and the kept ones scaled by 1 / (1 -
    p); lse stays that of the undropped row."""
    _check(q, k, v, window, kv_mask, segment_ids, seeds, dropout_p)
    kw = dict(causal=causal, scale=scale, window=window, kv_mask=kv_mask,
              segment_ids=segment_ids, seeds=seeds, dropout_p=dropout_p)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, **kw)
    b, tq, h, d = q.shape
    q, k, v = (_rows16(x) for x in (q, k, v))
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    _launch("pt_flash_fwd", q, _args(
        q, k, v, None, causal, scale, window,
        **_options(q, kv_mask, segment_ids, seeds, dropout_p), o=o,
        lse_out=lse))
    count_launch(flash_attention_fwd, q.dtype)
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.dtype_launches = {}


def flash_attention_dq(q, k, v, do, lse, delta, *, causal: bool,
                       scale: float, window: Optional[int] = None,
                       kv_mask=None, segment_ids=None, seeds=None,
                       dropout_p: float = 0.0):
    """dq (B, Tq, H, D) from the forward's ``lse`` and ``delta`` =
    rowsum(do * o), both (B, H, Tq) float32; the options as the
    forward's."""
    _check(q, k, v, window, kv_mask, segment_ids, seeds, dropout_p, do)
    kw = dict(causal=causal, scale=scale, window=window, kv_mask=kv_mask,
              segment_ids=segment_ids, seeds=seeds, dropout_p=dropout_p)
    if q.device.type == "cpu":
        return flash_attention_dq_plain(q, k, v, do, lse, delta, **kw)
    b, tq, h, _ = q.shape
    lse, delta = _row_stats(lse, b, h, tq), _row_stats(delta, b, h, tq)
    q, k, v, do = (_rows16(x) for x in (q, k, v, do))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("pt_flash_dq", q, _args(
        q, k, v, do, causal, scale, window,
        **_options(q, kv_mask, segment_ids, seeds, dropout_p), lse=lse,
        delta=delta, dq=dq))
    count_launch(flash_attention_dq, q.dtype)
    return dq


flash_attention_dq.launches = 0
flash_attention_dq.dtype_launches = {}


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal: bool,
                        scale: float, window: Optional[int] = None,
                        kv_mask=None, segment_ids=None, seeds=None,
                        dropout_p: float = 0.0):
    """dk and dv (B, Tk, Hkv, D), each summed over the query heads of its
    GQA group (each head with its own dropout seed). Returns (dk, dv)."""
    _check(q, k, v, window, kv_mask, segment_ids, seeds, dropout_p, do)
    kw = dict(causal=causal, scale=scale, window=window, kv_mask=kv_mask,
              segment_ids=segment_ids, seeds=seeds, dropout_p=dropout_p)
    if q.device.type == "cpu":
        return flash_attention_dkv_plain(q, k, v, do, lse, delta, **kw)
    b, tq, h, _ = q.shape
    lse, delta = _row_stats(lse, b, h, tq), _row_stats(delta, b, h, tq)
    q, k, v, do = (_rows16(x) for x in (q, k, v, do))
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch("pt_flash_dkv", q, _args(
        q, k, v, do, causal, scale, window,
        **_options(q, kv_mask, segment_ids, seeds, dropout_p), lse=lse,
        delta=delta, dk=dk, dv=dv))
    count_launch(flash_attention_dkv, q.dtype)
    return dk, dv


flash_attention_dkv.launches = 0
flash_attention_dkv.dtype_launches = {}
