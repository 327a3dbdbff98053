"""Core runtime of the port: flags, errors, dtypes and the
mixed-precision policy, devices and places, random streams."""

from .config import FLAGS
from .dtypes import (Policy, default_dtype, get_policy, policy_scope,
                     set_policy, to_dtype)
from .enforce import (DeviceUnavailableError, EnforceError,
                      InvalidArgumentError, KernelCompileError,
                      KernelLaunchError, NotFoundError, UnimplementedError,
                      enforce, enforce_eq, enforce_in)
from .places import (CPUPlace, Place, TPUPlace, default_place, device_count,
                     device_pool, is_compiled_with_tpu, resolve_device,
                     set_device)
from .random import (current_generator, get_seed, make_generator,
                     next_key, rng_scope, seed)

__all__ = [
    "FLAGS",
    "Policy", "default_dtype", "get_policy", "policy_scope", "set_policy",
    "to_dtype",
    "DeviceUnavailableError", "EnforceError", "InvalidArgumentError",
    "KernelCompileError", "KernelLaunchError", "NotFoundError",
    "UnimplementedError", "enforce", "enforce_eq", "enforce_in",
    "CPUPlace", "Place", "TPUPlace", "default_place", "device_count",
    "device_pool", "is_compiled_with_tpu", "resolve_device", "set_device",
    "current_generator", "get_seed", "make_generator", "next_key",
    "rng_scope", "seed",
]
