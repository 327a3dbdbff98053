"""Single-position decode attention: the contiguous and the paged
KV-cache forms, each a hand-written CUDA kernel for Hopper
(``csrc/decode_attention.cu``) with its plain PyTorch version beside it.

Replaces (TPU kernels): paddle_tpu/ops/pallas/flash_decode.py
``_decode_kernel`` (through ``flash_decode``) and ``_paged_kernel``
(through ``flash_decode_paged``), which share ``_decode_core``.

Bound: bytes. A call must read every live K and V vector once:
``sum_b (min(t_b, L-1) - lo_b + 1) * Hkv * D * 2 * itemsize``, against
3.35 TB/s on an H100 SXM. Design: one thread block per (row, kv head)
walks only the live key range in tiles of 64 keys, loading each K/V
tile into shared memory once for the whole GQA group (the TPU kernel's
O(t) reads), with the online softmax in float32. The source file says
what is left for a later change (too few blocks for 132 SMs at small
batch; no double buffering).

Dispatch: a wrapper takes the plain version only for tensors on the
CPU. For a CUDA tensor it launches the kernel or raises — there is no
fallback. Each wrapper counts its launches in ``.launches`` (a plain
integer, bumped only where the kernel launches).

Types: float32 (the JAX default, what parity runs at) and bfloat16 (what
a server on the card would run), both accumulated in float32. Unlike the
TPU kernel, p stays float32 in the p.V product for bfloat16 inputs."""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...core.enforce import (InvalidArgumentError, KernelLaunchError,
                             enforce)

# the TPU kernel's finite mask value (flash_attention.py _NEG_INF) and
# its dead-score threshold (flash_decode.py: p = 0 where s <= -5e29)
NEG_INF = -1e30
DEFAULT_DECODE_BLOCK_K = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448     # bytes of shared memory one block may use


def decode_block_k(capacity: int) -> Optional[int]:
    """The JAX package's kv block for a cache capacity (largest of 256,
    128, 64 that divides it); None = shape ineligible for the kernel
    (the dispatch gate's rule). The CUDA kernel itself tiles by 64."""
    for bk in (DEFAULT_DECODE_BLOCK_K, 128, 64):
        if capacity % bk == 0:
            return bk
    return None


# ----- plain versions ------------------------------------------------------

def _attend_plain(q, k, v, t, window, scale):
    """q (B, 1, H, D) against a logical cache k/v (B, L, Hkv, D), keys
    [lo, t] live, in float32 with the TPU kernel's masking values."""
    b, _, h, d = q.shape
    length, kv_h = k.shape[1], k.shape[2]
    g = h // kv_h
    qf = q[:, 0].float().reshape(b, kv_h, g, d)
    s = torch.einsum("bkgd,blkd->bkgl", qf, k.float()) * scale
    cols = torch.arange(length, device=q.device)[None, :]
    live = cols <= t[:, None]
    if window is not None:
        live &= cols > (t - window)[:, None]
    s = torch.where(live[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(s <= NEG_INF * 0.5, 0.0, p)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bkgl,blkd->bkgd", p, v.float()) / l
    return out.reshape(b, 1, h, d).to(q.dtype)


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


def _check_smem(lib, g: int, d: int):
    need = lib.pt_decode_attention_smem_bytes(g, d)
    if need > _SMEM_LIMIT:
        raise InvalidArgumentError(
            f"group size {g} at head_dim {d} needs {need} bytes of shared "
            f"memory per block; the card allows {_SMEM_LIMIT}")


def _lib():
    """The built library, its C signatures declared once (every pointer
    and the stream as c_void_p, so none is cut to 32 bits)."""
    from . import _build

    lib = _build.load("decode_attention")
    if not getattr(lib, "_pt_declared", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.pt_decode_attention_smem_bytes.argtypes = [i32, i32]
        lib.pt_decode_attention_smem_bytes.restype = ctypes.c_size_t
        lib.pt_decode_attention.argtypes = (
            [i32] + [ptr] * 5 + [i32] * 6 + [ctypes.c_float, ptr])
        lib.pt_decode_attention.restype = i32
        lib.pt_decode_attention_paged.argtypes = (
            [i32] + [ptr] * 6 + [i32] * 8 + [ctypes.c_float, ptr])
        lib.pt_decode_attention_paged.restype = i32
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
    lib = _lib()
    _check_smem(lib, h // kv_h, d)
    out = torch.empty_like(q)
    rc = lib.pt_decode_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        t.data_ptr(), out.data_ptr(), b, cap, h, kv_h, d, window or 0,
        float(d ** -0.5 if scale is None else scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


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
    lib = _lib()
    _check_smem(lib, h // kv_h, d)
    out = torch.empty_like(q)
    rc = lib.pt_decode_attention_paged(
        _DTYPE_CODE[q.dtype], q.data_ptr(), kpool.data_ptr(),
        vpool.data_ptr(), table.data_ptr(), t.data_ptr(), out.data_ptr(),
        b, pages, ps, n_log, h, kv_h, d, window or 0,
        float(d ** -0.5 if scale is None else scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "decode_attention_paged")
    decode_attention_paged.launches += 1
    return out


decode_attention_paged.launches = 0
