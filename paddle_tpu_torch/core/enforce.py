"""Error-checking helpers: ``enforce`` and the typed ``EnforceError``
family (counterpart of paddle_tpu/core/enforce.py, kept as its own copy
so the port never imports the JAX package)."""

from __future__ import annotations

from typing import Any, NoReturn


class EnforceError(RuntimeError):
    """Raised when an ``enforce`` condition fails."""


class NotFoundError(EnforceError):
    pass


class InvalidArgumentError(EnforceError, ValueError):
    pass


class UnimplementedError(EnforceError, NotImplementedError):
    """An option or path that a later slice of the port adds; the message
    names its ROADMAP.md item."""


class DeviceUnavailableError(EnforceError):
    """The requested device (by default the CUDA card) is not present.
    Entry points raise it instead of carrying on quietly on the CPU."""


class KernelCompileError(EnforceError):
    """A CUDA source did not compile, or ``nvcc`` is missing."""


class KernelLaunchError(EnforceError):
    """A kernel launch was refused (``cudaGetLastError`` was not 0)."""


def enforce(cond: Any, msg: str = "", *args: Any) -> None:
    """Raise :class:`EnforceError` unless ``cond`` is truthy. ``msg`` may
    be a format string applied to ``*args`` lazily."""
    if not cond:
        raise EnforceError(msg % args if args else (msg or "enforce failed"))


def enforce_eq(a: Any, b: Any, msg: str = "") -> None:
    if a != b:
        raise EnforceError(f"enforce_eq failed: {a!r} != {b!r}. {msg}")


def enforce_in(item: Any, container: Any, msg: str = "") -> None:
    if item not in container:
        raise EnforceError(
            f"enforce_in failed: {item!r} not in {container!r}. {msg}")


def not_found(msg: str) -> NoReturn:
    raise NotFoundError(msg)


def invalid_argument(msg: str) -> NoReturn:
    raise InvalidArgumentError(msg)


def unimplemented(msg: str) -> NoReturn:
    raise UnimplementedError(msg)
