"""Typed flags with environment overrides, and the strategy classes
(counterpart of paddle_tpu/core/config.py, the port's own copy).

One registry of typed flags, each overridable by a ``FLAGS_<name>``
environment variable (``TrainLoop``'s nan guard reads
``check_nan_inf``), and the compile/run strategy dataclasses as plain
data. ``Trainer(build_strategy=)`` does not read them yet (ROADMAP
queue 1 item 1)."""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional

from .enforce import InvalidArgumentError, enforce

_BOOL_TRUE = {"1", "true", "yes", "on"}
_BOOL_FALSE = {"0", "false", "no", "off"}


def _parse_bool(s: str) -> bool:
    ls = s.strip().lower()
    if ls in _BOOL_TRUE:
        return True
    if ls in _BOOL_FALSE:
        return False
    raise InvalidArgumentError(f"cannot parse bool from {s!r}")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: int,
    float: float,
    str: str,
}


@dataclasses.dataclass
class _Flag:
    name: str
    default: Any
    type: type
    help: str
    value: Any = None


class FlagRegistry:
    """Registry of named typed flags, env-overridable as ``FLAGS_<name>``."""

    def __init__(self) -> None:
        self._flags: Dict[str, _Flag] = {}

    def define(self, name: str, default: Any, help: str = "") -> None:
        enforce(name not in self._flags, "flag %s already defined", name)
        ty = type(default)
        enforce(ty in _PARSERS, "unsupported flag type %s", ty)
        flag = _Flag(name=name, default=default, type=ty, help=help)
        env = os.environ.get(f"FLAGS_{name}")
        flag.value = _PARSERS[ty](env) if env is not None else default
        self._flags[name] = flag

    def get(self, name: str) -> Any:
        enforce(name in self._flags, "unknown flag %s", name)
        return self._flags[name].value

    def set(self, name: str, value: Any) -> None:
        enforce(name in self._flags, "unknown flag %s", name)
        flag = self._flags[name]
        # Strings go through the same parser as env vars so "false"/"0"/"off"
        # behave identically everywhere.
        if isinstance(value, str):
            flag.value = _PARSERS[flag.type](value)
        else:
            flag.value = flag.type(value)

    def reset(self, name: str) -> None:
        flag = self._flags[name]
        flag.value = flag.default

    def all(self) -> Dict[str, Any]:
        return {f.name: f.value for f in self._flags.values()}

    def __contains__(self, name: str) -> bool:
        return name in self._flags


FLAGS = FlagRegistry()

# Core flags (whitelist mirroring the reference's read_env_flags).
FLAGS.define("check_nan_inf", False, "insert nan/inf checks on op outputs (debug mode)")
FLAGS.define("benchmark", False, "synchronize and time every step")
FLAGS.define("default_dtype", "float32", "default parameter dtype")
FLAGS.define("compute_dtype", "bfloat16", "default matmul/conv compute dtype")
FLAGS.define("seed", 0, "global random seed (0 = nondeterministic)")
FLAGS.define("log_level", 0, "verbosity, VLOG-style")
FLAGS.define("allocator_strategy", "pjrt",
             "device memory strategy (informational; the same default as the "
             "JAX package, so a flag set for it parses here)")
FLAGS.define("compile_cache_capacity", 128, "max cached executables per Executor")
FLAGS.define("deterministic", False, "force deterministic reductions/collectives")
FLAGS.define("static_verify", True,
             "run the static analyzers (analysis/) at compile boundaries: "
             "Program IR verification on the Executor's first compile of a "
             "program version, donation-provenance checks at Trainer "
             "compile time; 0 disables all wired-in passes")


@dataclasses.dataclass
class ExecutionStrategy:
    """Runtime knobs for an executor (reference: details/execution_strategy.h)."""

    num_iteration_per_drop_scope: int = 1  # kept for API parity
    use_experimental_executor: bool = False
    sync_every_step: bool = False  # block_until_ready each step (benchmark mode)


@dataclasses.dataclass
class BuildStrategy:
    """Compile-time strategy (reference: details/build_strategy.h:36).

    Most reference fields (fusion toggles, memory-optimize passes) are subsumed
    by the compiler; the fields are kept as the JAX package has them.
    """

    reduce_strategy: str = "all_reduce"  # "all_reduce" | "reduce_scatter"
    gradient_scale_strategy: str = "coeff_one"  # "coeff_one" | "one_over_n"
    fuse_all_reduce_ops: bool = True  # grad coalescing (a hint)
    donate_inputs: bool = True  # buffer donation for train state (in-place update)
    remat_policy: Optional[str] = None  # None | "full" | "dots"

    class ReduceStrategy:
        """reference: details/build_strategy.h:57 ReduceStrategy enum."""

        AllReduce = "all_reduce"
        Reduce = "reduce_scatter"

        def __init__(self, value: str = "all_reduce"):
            self.value = value

    class GradientScaleStrategy:
        """reference: details/build_strategy.h:59 GradientScaleStrategy."""

        CoeffNumDevice = "coeff_one"
        One = "one"
        Customized = "customized"

        def __init__(self, value: str = "coeff_one"):
            self.value = value


@dataclasses.dataclass
class DistributeConfig:
    """Mesh/parallelism config — the successor of DistributeTranspilerConfig
    (reference: transpiler/distribute_transpiler.py:130) expressed as mesh axes."""

    dp: int = 1  # data parallel
    tp: int = 1  # tensor parallel
    pp: int = 1  # pipeline parallel
    sp: int = 1  # sequence/context parallel
    ep: int = 1  # expert parallel

    def total(self) -> int:
        return self.dp * self.tp * self.pp * self.sp * self.ep
