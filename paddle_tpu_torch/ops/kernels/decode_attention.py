"""Single-position decode attention: the contiguous and the paged
KV-cache forms, the paged one over float or int8 pools, each a
hand-written CUDA kernel for Hopper (``csrc/decode_attention.cu``) with
its plain PyTorch version beside it.

Replaces (TPU kernels): paddle_tpu/ops/pallas/flash_decode.py
``_decode_kernel`` (through ``flash_decode``), ``_paged_kernel``
(through ``flash_decode_paged``) and ``_paged_kernel_quant`` (through
``flash_decode_paged(k_scale=, v_scale=)``), which share
``_decode_core``.

Bound: bytes. A call must read every live K and V vector once:
``sum_b (min(t_b, L-1) - lo_b + 1) * Hkv * 2 * D * itemsize`` (int8
pools: ``(D + 4)`` bytes per vector, its float32 scale included),
against 3.35 TB/s on an H100 SXM. Design: a split over the cache length
— one thread block per (row, kv head, chunk of ``CHUNK`` = 256
positions), S = ceil(L / 256) chunks from the static length L — each
walking only its live 64-key tiles, loading each K/V tile into shared
memory once for the whole GQA group with 16-byte ``cp.async`` copies
(double-buffered), with the online softmax in float32; the last block
of each (row, kv head) merges the chunks' partials (m, l, acc) with the
log-sum-exp rule in the same launch. The wrappers allocate the partials
scratch per call and keep the merge counters per device and stream.
:func:`_attend_plain_split` is the plain version of that walk and merge.

Dispatch: a wrapper takes the plain version only for tensors on the
CPU. For a CUDA tensor it launches the kernel or raises — there is no
fallback. Each wrapper counts its launches in ``.launches`` (a plain
integer, bumped only where the kernel launches), and those of each dtype
instance in ``.dtype_launches`` ({torch dtype: count}). The kernels copy K/V
rows as 16-byte vectors: on the card, ``head_dim * itemsize`` must be a
multiple of 16 and the planes 16-byte aligned, or the wrapper raises.

Types: float32 (the JAX default, what parity runs at) and bfloat16 (what
a server on the card would run), both accumulated in float32. Unlike the
TPU kernel, p stays float32 in the p.V product for bfloat16 inputs. The
int8 form takes int8 value planes with float32 scale planes, q in
float32 or bfloat16, and computes in float32 (the TPU kernel casts q to
float32); its output is in q's dtype."""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...core.enforce import (InvalidArgumentError, KernelLaunchError,
                             enforce)
from ._launches import count_launch

# the TPU kernel's finite mask value (flash_attention.py _NEG_INF) and
# its dead-score threshold (flash_decode.py: p = 0 where s <= -5e29)
NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448     # bytes of shared memory one block may use
CHUNK = 256              # cache positions per split (the kernel's kChunk)


# ----- plain versions ------------------------------------------------------

def _attend_plain_split(q, k, v, t, window, scale, chunk: int = CHUNK):
    """The kernels' split walk in plain PyTorch: :func:`_attend_plain`
    over each ``chunk`` of cache positions separately, giving partials
    (m, l, unnormalized acc) per chunk (an empty chunk: m = -1e30,
    l = 0), merged with the log-sum-exp rule — weights exp(m_s - max m)
    over the chunks with l > 0, l == 0 read as 1 after the merge."""
    b, _, h, d = q.shape
    length, kv_h = k.shape[1], k.shape[2]
    g = h // kv_h
    qf = q[:, 0].float().reshape(b, kv_h, g, d)
    cols = torch.arange(length, device=q.device)[None, :]
    live = cols <= t[:, None]
    if window is not None:
        live &= cols > (t - window)[:, None]
    ms, ls, accs = [], [], []
    for c0 in range(0, length, chunk):
        kc, vc = k[:, c0:c0 + chunk].float(), v[:, c0:c0 + chunk].float()
        s = torch.einsum("bkgd,blkd->bkgl", qf, kc) * scale
        s = torch.where(live[:, None, None, c0:c0 + chunk], s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        p = torch.where(s <= NEG_INF * 0.5, 0.0, p)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bkgl,blkd->bkgd", p, vc))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    mx = torch.where(l > 0, m, NEG_INF).amax(dim=0)
    w = torch.where(l > 0, torch.exp(m - mx), 0.0)
    l = (l * w).sum(dim=0)
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc * w).sum(dim=0) / l
    return out.reshape(b, 1, h, d).to(q.dtype)


def _attend_plain(q, k, v, t, window, scale):
    """q (B, 1, H, D) against a logical cache k/v (B, L, Hkv, D), keys
    [lo, t] live, in float32 with the TPU kernel's masking values: the
    split walk with the whole row as one chunk (its merge weight is
    exp(0) = 1)."""
    return _attend_plain_split(q, k, v, t, window, scale,
                               chunk=max(k.shape[1], 1))


def decode_attention_plain(q, k, v, t, window: Optional[int] = None,
                           scale: Optional[float] = None):
    """Plain PyTorch version of :func:`decode_attention`."""
    b, _, _, d = q.shape
    t = _cursors(t, b, q.device)
    return _attend_plain(q, k, v, t, window,
                         d ** -0.5 if scale is None else scale)


def gather_pages(pool, table):
    """Each row's logical cache from a page pool: (B, n_log*ps, Hkv, D),
    with page ids clamped to [0, pages) as the kernel clamps them."""
    b, n_log = table.shape
    pages, ps = pool.shape[:2]
    ids = table.long().clamp(0, pages - 1)
    return pool[ids].reshape(b, n_log * ps, *pool.shape[2:])


def decode_attention_paged_plain(q, kpool, vpool, table, t,
                                 window: Optional[int] = None,
                                 scale: Optional[float] = None):
    """Plain PyTorch version of :func:`decode_attention_paged`: gather
    the pages with the table, then the masked softmax in float32."""
    b, _, _, d = q.shape
    t = _cursors(t, b, q.device)
    return _attend_plain(q, gather_pages(kpool, table),
                         gather_pages(vpool, table), t, window,
                         d ** -0.5 if scale is None else scale)


def dequantize_pages(qpool, spool, table):
    """Each row's logical cache from an int8 value plane and its scale
    plane: ``q * scale`` in float32, (B, n_log*ps, Hkv, D)."""
    return (gather_pages(qpool, table).float()
            * gather_pages(spool, table)[..., None])


def decode_attention_paged_quant_plain(q, kq, ks, vq, vs, table, t,
                                       window: Optional[int] = None,
                                       scale: Optional[float] = None):
    """Plain PyTorch version of :func:`decode_attention_paged_quant`:
    gather and dequantize the pages, then the masked softmax in
    float32."""
    b, _, _, d = q.shape
    t = _cursors(t, b, q.device)
    return _attend_plain(q, dequantize_pages(kq, ks, table),
                         dequantize_pages(vq, vs, table), t, window,
                         d ** -0.5 if scale is None else scale)


# ----- wrappers ------------------------------------------------------------

def _cursors(t, b: int, device) -> torch.Tensor:
    """Scalar or (B,) cursors -> a contiguous (B,) int32 tensor."""
    if not torch.is_tensor(t):
        return torch.full((b,), int(t), dtype=torch.int32, device=device)
    return t.to(device=device, dtype=torch.int32).expand(b).contiguous()


def _check_common(q, window, kv_heads: int, d_kv: int):
    b, tq, h, d = q.shape
    enforce(tq == 1, "decode attention takes one query position, got %s",
            tq)
    enforce(window is None or window >= 1,
            "window must be >= 1, got %s", window)
    enforce(d_kv == d, "cache head_dim %s != q head_dim %s", d_kv, d)
    enforce(h % kv_heads == 0, "heads %s not divisible by kv heads %s", h,
            kv_heads)


def _check_cuda(*tensors):
    dt = tensors[0].dtype
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev:
            raise InvalidArgumentError(
                f"decode attention operands must share one device, got "
                f"{x.device} and {dev}")
        if x.dtype != dt:
            raise InvalidArgumentError(
                f"q, k and v must share one dtype, got {x.dtype} and {dt}")
        if not x.is_contiguous():
            raise InvalidArgumentError(
                "decode attention operands must be contiguous")
    if dt not in _DTYPE_CODE:
        raise InvalidArgumentError(
            f"decode attention kernels take float32 or bfloat16, got {dt}")


def _check_rows(planes, d: int):
    """The kernels copy K/V rows in 16-byte vectors: rows of a multiple
    of 16 bytes, planes 16-byte aligned."""
    item = planes[0].element_size()
    if (d * item) % 16 or any(x.data_ptr() % 16 for x in planes):
        raise InvalidArgumentError(
            f"the decode kernels copy 16-byte vectors: head_dim {d} x "
            f"{item} bytes must be a multiple of 16 and the K/V planes "
            f"16-byte aligned")


_smem_ok = set()


def _check_smem(lib, g: int, d: int, kv_bytes: int):
    if (g, d, kv_bytes) in _smem_ok:
        return
    need = lib.pt_decode_attention_smem_bytes(g, d, kv_bytes)
    if need > _SMEM_LIMIT:
        raise InvalidArgumentError(
            f"group size {g} at head_dim {d} needs {need} bytes of shared "
            f"memory per block; the card allows {_SMEM_LIMIT}")
    _smem_ok.add((g, d, kv_bytes))


_scratch = {}


def _split_operands(q, kv_h: int, length: int):
    """S, the partials scratch (B*H*S*(D+2) float32, contents undefined),
    the merge counters (B*Hkv ints) and the stream handle. Scratch and
    counters are kept per device and stream and grown on demand: calls
    on one stream run in order and a launch has merged its partials
    before it ends, and the kernel leaves the counters at 0, so a call
    on another stream cannot see a count in progress."""
    b, _, h, d = q.shape
    splits = -(-length // CHUNK)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    key = (q.device, stream)
    need = b * h * splits * (d + 2)
    part, cnt = _scratch.get(key, (None, None))
    if part is None or part.numel() < need or cnt.numel() < b * kv_h:
        part = torch.empty(need, dtype=torch.float32, device=q.device)
        cnt = torch.zeros(max(b * kv_h, 256), dtype=torch.int32,
                          device=q.device)
        _scratch[key] = (part, cnt)
    return splits, part, cnt, stream


def _lib():
    """The built library, its C signatures declared once (every pointer
    and the stream as c_void_p, so none is cut to 32 bits)."""
    from . import _build

    lib = _build.load("decode_attention")
    if not getattr(lib, "_pt_declared", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        f32 = ctypes.c_float
        lib.pt_decode_attention_smem_bytes.argtypes = [i32] * 3
        lib.pt_decode_attention_smem_bytes.restype = ctypes.c_size_t
        lib.pt_decode_attention.argtypes = (
            [i32] + [ptr] * 7 + [i32] * 6 + [f32, i32, ptr])
        lib.pt_decode_attention.restype = i32
        lib.pt_decode_attention_paged.argtypes = (
            [i32] + [ptr] * 8 + [i32] * 8 + [f32, i32, ptr])
        lib.pt_decode_attention_paged.restype = i32
        lib.pt_decode_attention_paged_quant.argtypes = (
            [i32] + [ptr] * 10 + [i32] * 8 + [f32, i32, ptr])
        lib.pt_decode_attention_paged_quant.restype = i32
        lib._pt_declared = True
    return lib


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise KernelLaunchError(
            f"{what} launch failed: cudaGetLastError() = {rc}")


def decode_attention(q, k, v, t, *, window: Optional[int] = None,
                     scale: Optional[float] = None):
    """One decode position: q (B, 1, H, D) against caches k/v
    (B, cap, Hkv, D); ``t`` a scalar or (B,) per-row cursors; keys
    ``pos <= t`` (and inside ``window``) attend. Returns (B, 1, H, D)."""
    b, _, h, d = q.shape
    cap, kv_h = k.shape[1], k.shape[2]
    _check_common(q, window, kv_h, k.shape[3])
    enforce(tuple(k.shape) == tuple(v.shape) and k.shape[0] == b,
            "k/v must both be (B=%s, cap, Hkv, D), got %s and %s", b,
            tuple(k.shape), tuple(v.shape))
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, t, window, scale)
    enforce(q.is_cuda, "decode attention runs on cuda or cpu, got %s",
            q.device)
    t = _cursors(t, b, q.device)
    _check_cuda(q, k, v)
    _check_rows((k, v), d)
    lib = _lib()
    _check_smem(lib, h // kv_h, d, k.element_size())
    out = torch.empty_like(q)
    splits, part, cnt, stream = _split_operands(q, kv_h, cap)
    rc = lib.pt_decode_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        t.data_ptr(), out.data_ptr(), part.data_ptr(), cnt.data_ptr(), b,
        cap, h, kv_h, d, window or 0,
        float(d ** -0.5 if scale is None else scale), splits, stream)
    _raise_on(rc, "decode_attention")
    count_launch(decode_attention, q.dtype)
    return out


decode_attention.launches = 0
decode_attention.dtype_launches = {}


def decode_attention_paged(q, kpool, vpool, table, t, *,
                           window: Optional[int] = None,
                           scale: Optional[float] = None):
    """Paged decode attention: the cache lives in a shared page pool
    (pages, page_size, Hkv, D); row b's logical cache is the page
    sequence ``table[b]`` (B, n_log) int32. Entries past a row's live
    range may hold anything (ids are clamped into the pool). Returns
    (B, 1, H, D)."""
    b, _, h, d = q.shape
    pages, ps, kv_h = kpool.shape[0], kpool.shape[1], kpool.shape[2]
    _check_common(q, window, kv_h, kpool.shape[3])
    enforce(tuple(kpool.shape) == tuple(vpool.shape),
            "kpool %s and vpool %s differ", tuple(kpool.shape),
            tuple(vpool.shape))
    enforce(table.ndim == 2 and table.shape[0] == b,
            "table must be (B=%s, n_log), got %s", b, tuple(table.shape))
    n_log = table.shape[1]
    if q.device.type == "cpu":
        return decode_attention_paged_plain(q, kpool, vpool, table, t,
                                            window, scale)
    enforce(q.is_cuda, "decode attention runs on cuda or cpu, got %s",
            q.device)
    t = _cursors(t, b, q.device)
    table = table.to(device=q.device, dtype=torch.int32).contiguous()
    _check_cuda(q, kpool, vpool)
    _check_rows((kpool, vpool), d)
    lib = _lib()
    _check_smem(lib, h // kv_h, d, kpool.element_size())
    out = torch.empty_like(q)
    splits, part, cnt, stream = _split_operands(q, kv_h, n_log * ps)
    rc = lib.pt_decode_attention_paged(
        _DTYPE_CODE[q.dtype], q.data_ptr(), kpool.data_ptr(),
        vpool.data_ptr(), table.data_ptr(), t.data_ptr(), out.data_ptr(),
        part.data_ptr(), cnt.data_ptr(), b, pages, ps, n_log, h, kv_h, d,
        window or 0, float(d ** -0.5 if scale is None else scale), splits,
        stream)
    _raise_on(rc, "decode_attention_paged")
    count_launch(decode_attention_paged, q.dtype)
    return out


decode_attention_paged.launches = 0
decode_attention_paged.dtype_launches = {}


def _check_quant_planes(q, kq, ks, vq, vs):
    """The int8 kernel's operand contract: int8 value planes with 16-byte
    aligned rows (head_dim a multiple of 16) and float32 scale planes,
    all contiguous on q's device."""
    if q.dtype not in _DTYPE_CODE or not q.is_contiguous():
        raise InvalidArgumentError(
            f"the int8 decode kernel takes a contiguous q in float32 or "
            f"bfloat16, got {q.dtype}")
    for name, x, dt in (("kq", kq, torch.int8), ("vq", vq, torch.int8),
                        ("ks", ks, torch.float32), ("vs", vs, torch.float32)):
        if x.device != q.device or x.dtype != dt or not x.is_contiguous():
            raise InvalidArgumentError(
                f"{name} must be a contiguous {dt} tensor on {q.device}, "
                f"got {x.dtype} on {x.device}")
    if kq.shape[3] % 16 or kq.data_ptr() % 16 or vq.data_ptr() % 16:
        raise InvalidArgumentError(
            f"the int8 decode kernel loads 16-byte vectors: head_dim "
            f"{kq.shape[3]} must be a multiple of 16 and the value planes "
            f"16-byte aligned")


def decode_attention_paged_quant(q, kq, ks, vq, vs, table, t, *,
                                 window: Optional[int] = None,
                                 scale: Optional[float] = None):
    """Paged decode attention over int8 pools: value planes ``kq``/``vq``
    (pages, page_size, Hkv, D) int8 and their per-(page, position, kv
    head) float32 scale planes ``ks``/``vs`` (pages, page_size, Hkv);
    each K/V element is ``value * scale``. ``table`` (B, n_log) int32,
    ``t`` scalar or (B,) cursors, as :func:`decode_attention_paged`.
    Returns (B, 1, H, D) in q's dtype."""
    b, _, h, d = q.shape
    pages, ps, kv_h = kq.shape[0], kq.shape[1], kq.shape[2]
    _check_common(q, window, kv_h, kq.shape[3])
    enforce(tuple(kq.shape) == tuple(vq.shape),
            "kq %s and vq %s differ", tuple(kq.shape), tuple(vq.shape))
    for name, sc in (("ks", ks), ("vs", vs)):
        enforce(tuple(sc.shape) == (pages, ps, kv_h),
                "%s must be the pool's (pages, page_size, kv_heads) scale "
                "plane %s, got %s", name, (pages, ps, kv_h),
                tuple(sc.shape))
    enforce(table.ndim == 2 and table.shape[0] == b,
            "table must be (B=%s, n_log), got %s", b, tuple(table.shape))
    n_log = table.shape[1]
    if q.device.type == "cpu":
        return decode_attention_paged_quant_plain(q, kq, ks, vq, vs, table,
                                                  t, window, scale)
    enforce(q.is_cuda, "decode attention runs on cuda or cpu, got %s",
            q.device)
    t = _cursors(t, b, q.device)
    table = table.to(device=q.device, dtype=torch.int32).contiguous()
    _check_quant_planes(q, kq, ks, vq, vs)
    lib = _lib()
    _check_smem(lib, h // kv_h, d, 1)
    out = torch.empty_like(q)
    splits, part, cnt, stream = _split_operands(q, kv_h, n_log * ps)
    rc = lib.pt_decode_attention_paged_quant(
        _DTYPE_CODE[q.dtype], q.data_ptr(), kq.data_ptr(), ks.data_ptr(),
        vq.data_ptr(), vs.data_ptr(), table.data_ptr(), t.data_ptr(),
        out.data_ptr(), part.data_ptr(), cnt.data_ptr(), b, pages, ps,
        n_log, h, kv_h, d, window or 0,
        float(d ** -0.5 if scale is None else scale), splits, stream)
    _raise_on(rc, "decode_attention_paged_quant")
    count_launch(decode_attention_paged_quant, q.dtype)
    return out


decode_attention_paged_quant.launches = 0
decode_attention_paged_quant.dtype_launches = {}
