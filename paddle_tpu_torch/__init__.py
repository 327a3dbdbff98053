"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for an NVIDIA
H100 (Hopper, sm_90a).

It sits beside the JAX package and never imports it. Modules keep the
JAX package's paths and names (``models/gpt.py``, ``serving.py``,
``ops/attention.py``, ...), so each has an obvious counterpart; every
Pallas kernel on a ported path becomes a hand-written CUDA kernel under
``csrc/``, bound with ctypes (``ops/kernels/``). Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from . import amp, core, ops
from .core import (FLAGS, CPUPlace, EnforceError, Place, TPUPlace,
                   UnimplementedError, default_place, device_count,
                   is_compiled_with_tpu, make_generator, resolve_device,
                   seed, set_device)

__all__ = ["amp", "core", "ops", "FLAGS", "CPUPlace", "EnforceError",
           "Place", "TPUPlace", "UnimplementedError", "default_place",
           "device_count", "is_compiled_with_tpu", "make_generator",
           "resolve_device", "seed", "set_device"]
