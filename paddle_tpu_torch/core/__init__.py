"""Core runtime of the port: errors, dtypes and the mixed-precision
policy, devices, random streams."""

from .dtypes import (Policy, default_dtype, get_policy, policy_scope,
                     set_policy, to_dtype)
from .enforce import (DeviceUnavailableError, EnforceError,
                      InvalidArgumentError, KernelCompileError,
                      KernelLaunchError, UnimplementedError, enforce)
from .places import resolve_device
from .random import (current_generator, get_seed, make_generator,
                     next_key, rng_scope, seed)

__all__ = [
    "Policy", "default_dtype", "get_policy", "policy_scope", "set_policy",
    "to_dtype",
    "DeviceUnavailableError", "EnforceError", "InvalidArgumentError",
    "KernelCompileError", "KernelLaunchError", "UnimplementedError",
    "enforce", "resolve_device", "current_generator", "get_seed",
    "make_generator", "next_key", "rng_scope", "seed",
]
