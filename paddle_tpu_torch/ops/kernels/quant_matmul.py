"""int8 x int8 matrix product with int32 accumulation and a fused
dequant epilogue, and its fused form for a frozen Linear layer: a
hand-written CUDA kernel for Hopper (``csrc/quant_matmul.cu``: TMA loads,
wgmma) with a plain PyTorch version beside each entry point.

Replaces (TPU kernel): paddle_tpu/ops/pallas/quant_matmul.py ``_kernel``
(through ``quant_matmul``); the fused form computes what
paddle_tpu/quant/int8.py ``int8_linear`` computes around it, plus the
layer's ReLU.

``quant_matmul``: ``out = float32(a_i8 @ b_i8) * (a_scale * b_scale[n])``
in ``out_dtype``: a (M, K) int8 with a per-tensor scale, b (K, N) int8
(the JAX layout, weights (in, out)) with a per-tensor or per-channel
(N,) scale. Integer products are exact, so the kernel, its plain version
and the JAX package agree exactly: the product of the scales is taken
first, then one float32 multiply, then one rounding to ``out_dtype``.

``quant_linear``: the same product with x (M, K) float encoded in the
kernel's prologue at ``a_scale`` (``quant/ops.py`` ``_encode_at``), the
bias added after the scale multiply and ReLU after that, all in float32,
then one rounding to ``out_dtype``. It takes the weight packed once by
:func:`pack_weight`: (N, K) with K contiguous, the layout the kernel's
tensor cores read, zero-padded to a multiple of 16 columns.

Bound: bytes, at MNIST's shapes: A (``M*K`` int8, ``4*M*K`` float32 in
the fused form), the weight and scales read once, ``4*M*N`` written, over
3.35 TB/s; the operations (``2*M*N*K``) are far below the int8
tensor-core peak. Design: see the source's header.

Tiles and dispatch, as the JAX package's ``quant_matmul`` takes them:
``tile_m`` (BM: 64 or 128), ``tile_n`` (BN: 16, 64, 128 or 256) and
``tile_k`` (the K values the ring of 64-deep stages holds: 128, 192 or
256) pick the kernel's tile from its menu (:data:`TILE_M`,
:data:`TILE_N`, :data:`TILE_K`); a value outside it raises
:class:`InvalidArgumentError` naming it. None takes the tuned-block
table's entry for the shape (``tuning.matmul_key`` with the activations'
type: int8 here, float32 for the fused form), else the default
(:func:`default_tiles`). The product is exact in integers, so every tile
gives the same bits. ``use_pallas=False``, or a tuned ``use_pallas:
false``, runs the exact integer product the plain version computes, on
the tensors' device (a routing by the table counts in
``pt_tuning_routed_off_total``); ``interpret=True`` runs the plain
version. Both are explicit choices: no path of the port passes them.

``quant_matmul_packed`` is ``quant_matmul`` with the weight packed once
(the int8 convolution's entry, ``quant/int8.py`` ``Int8Conv2D``: its
activations come im2col'd into K16 columns, so a launch copies
nothing).

Dispatch: the plain versions only for CPU tensors; a CUDA tensor
launches the kernel or raises. Zero-sized M, N or K return the empty or
zero result without a launch. ``quant_matmul.launches`` and
``quant_linear.launches`` count launches, ``.dtype_launches`` those of
each output type and ``.tile_launches`` those of each (output type,
(BM, BN, BK)); ``.last_tiles`` is the last launch's (BM, BN, BK)."""

from __future__ import annotations

import ctypes

import torch

from ...core.enforce import (InvalidArgumentError, KernelLaunchError,
                             enforce)
from ...utils.flops import costed, tensor_bytes
from ._launches import count_launch

_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the tile menu: BM, BN, and the K values the ring holds (2-4 stages of 64)
TILE_M = (64, 128)
TILE_N = (16, 64, 128, 256)
TILE_K = (128, 192, 256)


def default_tiles(m: int, n: int):
    """The kernel's default (BM, BN, BK) for an (M, N) output: BN the
    smallest of 16/64/128/256 that covers N (256 above); BM 128 (two
    consumer warpgroups) when 128-row tiles still make ~a wave (>= 120
    tiles on 132 SMs), else 64 for twice the tiles; a ring of 4 stages
    (256 K values)."""
    bn = next((x for x in TILE_N if n <= x), TILE_N[-1])
    tiles128 = -(-m // 128) * -(-n // bn)
    return (128 if tiles128 >= 120 else 64, bn, TILE_K[-1])


def _given(tile_m, tile_n, tile_k):
    """The named tiles, each checked against its menu."""
    for name, value, menu in (("tile_m", tile_m, TILE_M),
                              ("tile_n", tile_n, TILE_N),
                              ("tile_k", tile_k, TILE_K)):
        if value is not None and value not in menu:
            raise InvalidArgumentError(
                f"{name}={value} is not in the int8 kernel's tile menu "
                f"{menu}")
    return tile_m, tile_n, tile_k


def _dispatch(kernel: str, m: int, n: int, k: int, a_type, tiles,
              use_pallas):
    """(BM, BN, BK) and whether the kernel runs, for a launch on the
    card: the named tiles, else the tuned entry's (in the menu), else the
    default; ``use_pallas`` None takes the entry's verdict."""
    tuned = {}
    if None in tiles or use_pallas is None:
        from .tuning import matmul_entry

        tuned = matmul_entry(m, n, k, a_type)
    out = []
    for given, key, menu, default in zip(tiles, ("tile_m", "tile_n",
                                                 "tile_k"),
                                         (TILE_M, TILE_N, TILE_K),
                                         default_tiles(m, n)):
        out.append(given if given is not None else
                   tuned[key] if tuned.get(key) in menu else default)
    if use_pallas is None:
        use_pallas = bool(tuned.get("use_pallas", True))
        if not use_pallas:
            from .tuning import note_route_off

            note_route_off(kernel)
    return tuple(out), use_pallas


def _scales(a_scale, b_scale, n: int, device):
    """(1,) a scale and (N,) b scale, float32 on ``device``."""
    sa = torch.as_tensor(a_scale, dtype=torch.float32,
                         device=device).reshape(1)
    sb = torch.as_tensor(b_scale, dtype=torch.float32, device=device)
    return sa, sb.expand(n).contiguous()


def _epilogue(acc, sa, sb, out_dtype):
    """``acc.float() * (sa * sb)`` — the scales' product first, as the
    JAX kernel and its XLA path compute it."""
    return (acc.float() * (sa * sb)[None, :]).to(out_dtype)


def _round16(k: int) -> int:
    return -(-k // 16) * 16


def pack_weight(b_i8):
    """The kernel's weight layout: (K, N) int8 -> (N, K16) int8, K
    contiguous, K16 = K rounded up to a multiple of 16 with zero
    columns (TMA takes rows of 16-byte multiples; zeros add nothing)."""
    enforce(b_i8.ndim == 2 and b_i8.dtype == torch.int8,
            "pack_weight takes a 2-D int8 (K, N) weight, got %s %s",
            b_i8.dtype, tuple(b_i8.shape))
    k, n = b_i8.shape
    if _round16(k) == k:
        return b_i8.t().contiguous()
    packed = b_i8.new_zeros((n, _round16(k)))
    packed[:, :k] = b_i8.t()
    return packed


def _pad_cols(x, k: int):
    """x (M, K0) with zero columns up to k (K0 <= k), contiguous and
    16-byte aligned."""
    if x.shape[1] != k:
        padded = x.new_zeros((x.shape[0], k))
        padded[:, :x.shape[1]] = x
        return padded
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def quant_matmul_plain(a_i8, b_i8, a_scale, b_scale, *,
                       out_dtype=torch.float32):
    """Plain PyTorch version of :func:`quant_matmul`, exact on both
    devices: an int32 product on the CPU; on CUDA (no int32 matmul
    there) a float64 one, exact while 127^2 * K < 2^53."""
    n = b_i8.shape[1]
    if a_i8.device.type == "cpu":
        acc = torch.matmul(a_i8.to(torch.int32), b_i8.to(torch.int32))
    else:
        acc = torch.matmul(a_i8.double(), b_i8.double())
    sa, sb = _scales(a_scale, b_scale, n, a_i8.device)
    return _epilogue(acc, sa, sb, out_dtype)


def _lib():
    """The built library, its C signature declared once."""
    from . import _build

    lib = _build.load("quant_matmul")
    if not getattr(lib, "_pt_declared", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.pt_quant_matmul.argtypes = ([i32] * 2 + [ptr] * 6 + [i32] * 8
                                        + [ptr])
        lib.pt_quant_matmul.restype = i32
        lib._pt_declared = True
    return lib


def _launch(a_kind: int, a, b_packed, sa, sb, bias, out, k: int,
            relu: bool, tiles, what: str):
    m, n = out.shape
    rc = _lib().pt_quant_matmul(
        a_kind, _OUT_CODE[out.dtype], a.data_ptr(), b_packed.data_ptr(),
        sa.data_ptr(), sb.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, n, k,
        b_packed.shape[1], int(relu), *tiles,
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise KernelLaunchError(
            f"{what} launch failed: return code {rc} (cudaGetLastError(), "
            f"or < 0 for refused arguments)")


def _check_out_dtype(out_dtype, what: str):
    if out_dtype not in _OUT_CODE:
        raise InvalidArgumentError(
            f"{what} writes float32 or bfloat16, got {out_dtype}")


def _gemm_cost(a, b, *args, **kwargs):
    """2 M N K integer operations for a (M, K) and b (K, N); the
    operands and scales read once."""
    return (2.0 * a.shape[0] * b.shape[1] * a.shape[1],
            tensor_bytes((a, b, args, kwargs)))


def _packed_cost(a, w_packed, *args, **kwargs):
    """The same with the weight packed (N, K16), bias included."""
    return (2.0 * a.shape[0] * w_packed.shape[0] * a.shape[1],
            tensor_bytes((a, w_packed, args, kwargs)))


@costed(_gemm_cost)
def quant_matmul(a_i8, b_i8, a_scale, b_scale, *,
                 out_dtype=torch.float32, tile_m=None, tile_n=None,
                 tile_k=None, use_pallas=None, interpret: bool = False):
    """``dequant(a_i8 @ b_i8)``: a_i8 (M, K) int8 with a scalar
    ``a_scale``; b_i8 (K, N) int8 with a scalar or per-channel (N,)
    ``b_scale``. Returns (M, N) ``out_dtype`` (float32 or bfloat16).
    On the card b is packed for the kernel on every call
    (:func:`pack_weight`); a caller that reuses its weight packs it once
    and calls :func:`quant_matmul_packed` (or, for a Linear layer,
    :func:`quant_linear`). The tiles, ``use_pallas`` and ``interpret``:
    see the module docstring."""
    enforce(a_i8.ndim == 2 and b_i8.ndim == 2,
            "quant_matmul takes 2-D operands, got %s and %s",
            tuple(a_i8.shape), tuple(b_i8.shape))
    m, ka = a_i8.shape
    kb, n = b_i8.shape
    enforce(ka == kb, "inner dims differ: %s vs %s", ka, kb)
    enforce(a_i8.dtype == torch.int8 and b_i8.dtype == torch.int8,
            "quant_matmul takes int8 operands, got %s/%s", a_i8.dtype,
            b_i8.dtype)
    _check_out_dtype(out_dtype, "quant_matmul")
    tiles = _given(tile_m, tile_n, tile_k)
    if a_i8.device.type == "cpu" or interpret or use_pallas is False:
        return quant_matmul_plain(a_i8, b_i8, a_scale, b_scale,
                                  out_dtype=out_dtype)
    return quant_matmul_packed(a_i8, pack_weight(b_i8), a_scale, b_scale,
                               out_dtype=out_dtype, tile_m=tiles[0],
                               tile_n=tiles[1], tile_k=tiles[2],
                               use_pallas=use_pallas)


@costed(_packed_cost)
def quant_matmul_packed(a_i8, w_packed, a_scale, b_scale, *,
                        out_dtype=torch.float32, tile_m=None, tile_n=None,
                        tile_k=None, use_pallas=None,
                        interpret: bool = False):
    """:func:`quant_matmul` with the weight packed beforehand by
    :func:`pack_weight`: a_i8 (M, K) int8, ``w_packed`` (N, K16) int8
    with K16 = K rounded up to 16 (an ``a_i8`` that already has K16
    columns, the last ones zero, takes no padding copy). Returns (M, N)
    ``out_dtype``. One launch of the same kernel, counted in
    ``quant_matmul.launches``; on CPU tensors the plain version. The
    tiles, ``use_pallas`` and ``interpret`` as :func:`quant_matmul`'s."""
    enforce(a_i8.ndim == 2 and w_packed.ndim == 2,
            "quant_matmul_packed takes 2-D a and a packed (N, K16) weight, "
            "got %s and %s", tuple(a_i8.shape), tuple(w_packed.shape))
    enforce(a_i8.dtype == torch.int8 and w_packed.dtype == torch.int8,
            "quant_matmul_packed takes int8 operands, got %s/%s",
            a_i8.dtype, w_packed.dtype)
    m, ka = a_i8.shape
    n, k = w_packed.shape
    enforce(k == _round16(ka),
            "the packed weight (N, %s) does not fit a's K = %s (want K "
            "rounded up to 16: pack_weight)", k, ka)
    _check_out_dtype(out_dtype, "quant_matmul_packed")
    tiles = _given(tile_m, tile_n, tile_k)
    if a_i8.device.type == "cpu" or interpret:
        return quant_matmul_plain(a_i8, w_packed[:, :ka].t(), a_scale,
                                  b_scale, out_dtype=out_dtype)
    enforce(a_i8.is_cuda and w_packed.device == a_i8.device,
            "quant_matmul operands must share one cuda device, got %s and "
            "%s", a_i8.device, w_packed.device)
    sa, sb = _scales(a_scale, b_scale, n, a_i8.device)
    if min(m, n, ka) == 0:
        acc = torch.zeros((m, n), dtype=torch.int32, device=a_i8.device)
        return _epilogue(acc, sa, sb, out_dtype)
    tiles, kernel = _dispatch("quant_matmul", m, n, ka, "int8", tiles,
                              use_pallas)
    if not kernel:
        return quant_matmul_plain(a_i8, w_packed[:, :ka].t(), a_scale,
                                  b_scale, out_dtype=out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=a_i8.device)
    _launch(0, _pad_cols(a_i8, k), _pad_cols(w_packed, k), sa, sb, None,
            out, k, False, tiles, "quant_matmul")
    count_launch(quant_matmul, out_dtype, tiles)
    return out


quant_matmul.launches = 0
quant_matmul.dtype_launches = {}
quant_matmul.tile_launches = {}
quant_matmul.last_tiles = None


def _check_linear(x, w_packed, out_dtype):
    enforce(x.ndim == 2 and w_packed.ndim == 2,
            "quant_linear takes 2-D x and a packed (N, K16) weight, got %s "
            "and %s", tuple(x.shape), tuple(w_packed.shape))
    enforce(w_packed.dtype == torch.int8,
            "quant_linear takes an int8 packed weight, got %s",
            w_packed.dtype)
    enforce(x.is_floating_point(), "quant_linear encodes float x, got %s",
            x.dtype)
    enforce(w_packed.shape[1] == _round16(x.shape[1]),
            "the packed weight (N, %s) does not fit x's K = %s (want K "
            "rounded up to 16: pack_weight)", w_packed.shape[1],
            x.shape[1])
    _check_out_dtype(out_dtype, "quant_linear")


def quant_linear_plain(x, w_packed, a_scale, w_scale, bias=None,
                       relu: bool = False, *, out_dtype=torch.float32):
    """Plain PyTorch version of :func:`quant_linear`: ``_encode_at``, then
    :func:`quant_matmul_plain`, then the bias, then ReLU, in float32,
    then ``out_dtype``."""
    from ...quant.ops import _encode_at

    _check_linear(x, w_packed, out_dtype)
    k = x.shape[1]
    out = quant_matmul_plain(_encode_at(x, a_scale), w_packed[:, :k].t(),
                             a_scale, w_scale)
    if bias is not None:
        out = out + bias
    if relu:
        out = torch.relu(out)
    return out.to(out_dtype)


@costed(_packed_cost)
def quant_linear(x, w_packed, a_scale, w_scale, bias=None,
                 relu: bool = False, *, out_dtype=torch.float32,
                 tile_m=None, tile_n=None, tile_k=None, use_pallas=None,
                 interpret: bool = False):
    """A frozen Linear layer in one launch: x (M, K) float encoded at the
    scalar ``a_scale`` (round half to even, clipped to +-127), times the
    packed int8 weight ``w_packed`` (N, K16) from :func:`pack_weight`,
    dequantized at ``a_scale * w_scale[n]`` (scalar or (N,)), plus
    ``bias`` (N,) and ReLU when ``relu``. Returns (M, N) ``out_dtype``
    (float32 or bfloat16). The tiles, ``use_pallas`` and ``interpret`` as
    :func:`quant_matmul`'s (the table's key takes float32, the type the
    kernel reads the activations in)."""
    _check_linear(x, w_packed, out_dtype)
    m, k = x.shape
    n = w_packed.shape[0]
    tiles = _given(tile_m, tile_n, tile_k)
    if x.device.type == "cpu" or interpret:
        return quant_linear_plain(x, w_packed, a_scale, w_scale, bias, relu,
                                  out_dtype=out_dtype)
    enforce(x.is_cuda and w_packed.device == x.device,
            "quant_linear operands must share one cuda device, got %s and "
            "%s", x.device, w_packed.device)
    if bias is not None:
        enforce(tuple(bias.shape) == (n,) and bias.device == x.device,
                "bias must be (N=%s,) on %s, got %s on %s", n, x.device,
                tuple(bias.shape), bias.device)
        enforce(bias.dtype in (torch.float32, torch.bfloat16,
                               torch.float16),
                "quant_linear adds a float32/bfloat16/float16 bias, got %s",
                bias.dtype)
        bias = bias.to(torch.float32).contiguous()   # exact widening
    sa, sb = _scales(a_scale, w_scale, n, x.device)
    if min(m, n, k) == 0:
        acc = torch.zeros((m, n), dtype=torch.int32, device=x.device)
        out = _epilogue(acc, sa, sb, torch.float32)
        if bias is not None:
            out = out + bias
        return (torch.relu(out) if relu else out).to(out_dtype)
    tiles, kernel = _dispatch("quant_linear", m, n, k, "float32", tiles,
                              use_pallas)
    if not kernel:
        return quant_linear_plain(x, w_packed, a_scale, w_scale, bias, relu,
                                  out_dtype=out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    # the kernel reads float32 rows of 16-byte multiples: K % 4 == 0
    k4 = -(-k // 4) * 4
    _launch(1, _pad_cols(x.to(torch.float32), k4),
            _pad_cols(w_packed, w_packed.shape[1]), sa, sb, bias, out, k4,
            relu, tiles, "quant_linear")
    count_launch(quant_linear, out_dtype, tiles)
    return out


quant_linear.launches = 0
quant_linear.dtype_launches = {}
quant_linear.tile_launches = {}
quant_linear.last_tiles = None


def quantize_tensor(x, *, per_channel_axis=None):
    """Symmetric int8 quantization: returns (x_i8, scale), per channel
    along ``per_channel_axis`` (weights), per tensor otherwise
    (activations); ``scale = max(absmax / 127, 1e-10)``."""
    if per_channel_axis is None:
        scale = torch.clamp_min(torch.amax(torch.abs(x)) / 127.0, 1e-10)
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return q, scale
    axis = per_channel_axis % x.ndim
    axes = tuple(i for i in range(x.ndim) if i != axis)
    scale = torch.clamp_min(torch.amax(torch.abs(x), dim=axes) / 127.0,
                            1e-10)
    shape = [1] * x.ndim
    shape[axis] = -1
    q = torch.clamp(torch.round(x / scale.reshape(shape)), -127,
                    127).to(torch.int8)
    return q, scale
