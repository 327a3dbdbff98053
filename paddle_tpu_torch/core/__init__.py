"""Core runtime of the port: flags, errors, dtypes and the
mixed-precision policy, devices and places, meshes, random streams,
and the profiler's historical surface (``core.profiler``)."""

from .config import FLAGS, DistributeConfig
from .dtypes import (Policy, default_dtype, get_policy, policy_scope,
                     set_policy, to_dtype)
from .enforce import (DeviceUnavailableError, EnforceError,
                      InvalidArgumentError, KernelCompileError,
                      KernelLaunchError, NotFoundError, UnimplementedError,
                      enforce, enforce_eq, enforce_in)
from .mesh import (AXIS_NAMES, auto_mesh, axis_size, build_hybrid_mesh,
                   build_mesh, build_multihost_mesh, get_mesh, mesh_scope,
                   replicated, set_mesh, sharding)
from .places import (CPUPlace, Place, TPUPlace, default_place, device_count,
                     device_pool, is_compiled_with_tpu, resolve_device,
                     set_device)
from .random import (current_generator, get_seed, make_generator,
                     next_key, rng_scope, seed)
from .profiler import RecordEvent, profiler, start_profiler, stop_profiler

__all__ = [
    "FLAGS", "DistributeConfig",
    "AXIS_NAMES", "auto_mesh", "axis_size", "build_hybrid_mesh",
    "build_mesh", "build_multihost_mesh", "get_mesh", "mesh_scope",
    "replicated", "set_mesh", "sharding",
    "Policy", "default_dtype", "get_policy", "policy_scope", "set_policy",
    "to_dtype",
    "DeviceUnavailableError", "EnforceError", "InvalidArgumentError",
    "KernelCompileError", "KernelLaunchError", "NotFoundError",
    "UnimplementedError", "enforce", "enforce_eq", "enforce_in",
    "CPUPlace", "Place", "TPUPlace", "default_place", "device_count",
    "device_pool", "is_compiled_with_tpu", "resolve_device", "set_device",
    "current_generator", "get_seed", "make_generator", "next_key",
    "rng_scope", "seed",
    "RecordEvent", "profiler", "start_profiler", "stop_profiler",
]
