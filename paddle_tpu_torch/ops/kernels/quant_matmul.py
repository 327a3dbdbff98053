"""int8 x int8 matrix product with int32 accumulation and a fused
dequant epilogue: a hand-written CUDA kernel for Hopper
(``csrc/quant_matmul.cu``) with its plain PyTorch version beside it.

Replaces (TPU kernel): paddle_tpu/ops/pallas/quant_matmul.py ``_kernel``
(through ``quant_matmul``).

``out = float32(a_i8 @ b_i8) * (a_scale * b_scale[n])`` in ``out_dtype``:
a (M, K) int8 with a per-tensor scale, b (K, N) int8 (the JAX layout,
weights (in, out)) with a per-tensor or per-channel (N,) scale. Integer
products are exact, so the kernel, its plain version and the JAX package
agree exactly: the product of the scales is taken first, then one
float32 multiply, then one rounding to ``out_dtype``.

Bound: at MNIST's shapes, bytes (``M*K + K*N`` int8 read once, ``4*M*N``
written) over 3.35 TB/s; the operations (``2*M*N*K``) are far below the
int8 tensor-core peak. Design: see the source's header. The JAX knobs
``tile_*``, ``use_pallas`` and ``interpret`` pick TPU tiles and the
Pallas route and are not accepted (the tuned-block table is ROADMAP
queue 1 item 4).

Dispatch: the plain version only for CPU tensors; a CUDA tensor launches
the kernel or raises. Zero-sized M, N or K return the empty or zero
result without a launch. ``quant_matmul.launches`` counts launches."""

from __future__ import annotations

import ctypes

import torch

from ...core.enforce import (InvalidArgumentError, KernelLaunchError,
                             enforce)

_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
        lib.pt_quant_matmul.argtypes = [i32] + [ptr] * 5 + [i32] * 3 + [ptr]
        lib.pt_quant_matmul.restype = i32
        lib._pt_declared = True
    return lib


def quant_matmul(a_i8, b_i8, a_scale, b_scale, *,
                 out_dtype=torch.float32):
    """``dequant(a_i8 @ b_i8)``: a_i8 (M, K) int8 with a scalar
    ``a_scale``; b_i8 (K, N) int8 with a scalar or per-channel (N,)
    ``b_scale``. Returns (M, N) ``out_dtype`` (float32 or bfloat16)."""
    enforce(a_i8.ndim == 2 and b_i8.ndim == 2,
            "quant_matmul takes 2-D operands, got %s and %s",
            tuple(a_i8.shape), tuple(b_i8.shape))
    m, ka = a_i8.shape
    kb, n = b_i8.shape
    enforce(ka == kb, "inner dims differ: %s vs %s", ka, kb)
    enforce(a_i8.dtype == torch.int8 and b_i8.dtype == torch.int8,
            "quant_matmul takes int8 operands, got %s/%s", a_i8.dtype,
            b_i8.dtype)
    if out_dtype not in _OUT_CODE:
        raise InvalidArgumentError(
            f"quant_matmul writes float32 or bfloat16, got {out_dtype}")
    if a_i8.device.type == "cpu":
        return quant_matmul_plain(a_i8, b_i8, a_scale, b_scale,
                                  out_dtype=out_dtype)
    enforce(a_i8.is_cuda and b_i8.device == a_i8.device,
            "quant_matmul operands must share one cuda device, got %s and "
            "%s", a_i8.device, b_i8.device)
    sa, sb = _scales(a_scale, b_scale, n, a_i8.device)
    if min(m, n, ka) == 0:
        acc = torch.zeros((m, n), dtype=torch.int32, device=a_i8.device)
        return _epilogue(acc, sa, sb, out_dtype)
    a_i8, b_i8 = a_i8.contiguous(), b_i8.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=a_i8.device)
    rc = _lib().pt_quant_matmul(
        _OUT_CODE[out_dtype], a_i8.data_ptr(), b_i8.data_ptr(),
        sa.data_ptr(), sb.data_ptr(), out.data_ptr(), m, n, ka,
        torch.cuda.current_stream(a_i8.device).cuda_stream)
    if rc != 0:
        raise KernelLaunchError(
            f"quant_matmul launch failed: cudaGetLastError() = {rc}")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0


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
