"""Core runtime of the port: errors, dtypes, devices, random streams."""

from .dtypes import default_dtype, to_dtype
from .enforce import (DeviceUnavailableError, EnforceError,
                      InvalidArgumentError, KernelCompileError,
                      KernelLaunchError, UnimplementedError, enforce)
from .places import resolve_device
from .random import make_generator

__all__ = [
    "default_dtype", "to_dtype",
    "DeviceUnavailableError", "EnforceError", "InvalidArgumentError",
    "KernelCompileError", "KernelLaunchError", "UnimplementedError",
    "enforce", "resolve_device", "make_generator",
]
