"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for an NVIDIA
H100 (Hopper, sm_90a).

It sits beside the JAX package and never imports it. Modules keep the
JAX package's paths and names (``models/gpt.py``, ``serving.py``,
``ops/attention.py``, ...), so each has an obvious counterpart; every
Pallas kernel on a ported path becomes a hand-written CUDA kernel under
``csrc/``, bound with ctypes (``ops/kernels/``). Entry points run on the
CUDA card unless the caller passes ``device="cpu"``. Subpackages load
on first access (``paddle_tpu_torch.fleet``), as in the JAX package.
"""

__version__ = "0.1.0"

from . import amp, core, ops
from .core import (FLAGS, CPUPlace, EnforceError, Place, TPUPlace,
                   UnimplementedError, build_mesh, default_place,
                   device_count, get_mesh, is_compiled_with_tpu,
                   make_generator, resolve_device, seed, set_device,
                   set_mesh)

__all__ = ["amp", "core", "ops", "FLAGS", "CPUPlace", "EnforceError",
           "Place", "TPUPlace", "UnimplementedError", "build_mesh",
           "default_place", "device_count", "get_mesh",
           "is_compiled_with_tpu", "make_generator", "resolve_device",
           "seed", "set_device", "set_mesh"]

# subpackages loaded on first access (the JAX package's lazy map, for
# the modules the port has)
_LAZY = {name: "." + name for name in (
    "nn", "optimizer", "parallel", "data", "models", "metrics",
    "telemetry", "analysis", "initializer", "regularizer", "clip",
    "checkpoint", "quant", "fleet", "resilience", "train_loop", "slim",
    "utils")}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name], __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'paddle_tpu_torch' has no attribute {name!r}")
