"""Devices: Place handles and device resolution (counterpart of
paddle_tpu/core/places.py).

The port runs on the CUDA card by default. The CPU is used only when a
caller asks for it (the tests do); with no card and no explicit device,
:func:`resolve_device` raises :class:`DeviceUnavailableError` rather
than carrying on quietly on the CPU.

A :class:`Place` is a hashable handle, ``kind`` "cpu" or "cuda" plus an
ordinal, printed as the JAX package prints its places (``CPUPlace(0)``,
``CUDAPlace(0)``). ``TPUPlace`` and ``is_compiled_with_tpu`` keep their
JAX names so that scripts written for the JAX package run unchanged;
here they mean the CUDA card. Unlike the JAX package, whose CPU devices
stand in for the accelerator when there is none, a cuda place with no
card raises. :func:`default_place` is a query and answers
``CPUPlace(0)`` with no card, but no entry point takes its device from
it: only :func:`set_device`, an explicit request, changes what
``resolve_device(None)`` returns."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import torch

from .enforce import DeviceUnavailableError, enforce, not_found

DeviceLike = Union[None, str, torch.device]

_NO_CARD = ("no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' to run on the CPU")

# the device set_device chose; None: the CUDA card
_default_device: Optional[torch.device] = None


def _kind(kind: str) -> str:
    """"tpu" (the JAX package's accelerator kind) names the card."""
    kind = "cuda" if kind == "tpu" else kind
    enforce(kind in ("cpu", "cuda"),
            "place kind must be cpu or cuda (tpu names the card), got %s",
            kind)
    return kind


@dataclasses.dataclass(frozen=True)
class Place:
    """A logical device handle: ``kind`` in {"cpu", "cuda"} plus
    ordinal ("tpu" is taken as "cuda")."""

    kind: str
    ordinal: int = 0

    def __post_init__(self):
        object.__setattr__(self, "kind", _kind(self.kind))

    def device(self) -> torch.device:
        """The torch device; a cuda place raises
        :class:`DeviceUnavailableError` with no card, and any place
        ``NotFoundError`` for an ordinal beyond the devices found."""
        if self.kind == "cuda" and not torch.cuda.is_available():
            raise DeviceUnavailableError(_NO_CARD)
        n = _count(self.kind)
        if self.ordinal >= n:
            not_found(f"no {self.kind} device with ordinal {self.ordinal} "
                      f"(found {n})")
        if self.kind == "cpu":
            return torch.device("cpu")       # as resolve_device("cpu")
        return torch.device("cuda", self.ordinal)

    def __repr__(self) -> str:
        return f"{self.kind.upper()}Place({self.ordinal})"


def CPUPlace(ordinal: int = 0) -> Place:
    return Place("cpu", ordinal)


def TPUPlace(ordinal: int = 0) -> Place:
    """The CUDA card of that ordinal (the JAX package's accelerator
    place, kept by name)."""
    return Place("cuda", ordinal)


def _count(kind: str) -> int:
    if kind == "cpu":
        return 1                 # torch addresses the host as one device
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def is_compiled_with_tpu() -> bool:
    """True when a CUDA card is present (the JAX package's name for "an
    accelerator is live")."""
    return torch.cuda.is_available()


def device_pool(kind: Optional[str] = None) -> List[Place]:
    """All local places of ``kind`` (default: the card if present, else
    the CPU)."""
    if kind is None:
        kind = "cuda" if is_compiled_with_tpu() else "cpu"
    kind = _kind(kind)
    return [Place(kind, i) for i in range(_count(kind))]


def default_place() -> Place:
    """``TPUPlace(0)`` (the card) if present, else ``CPUPlace(0)``. A
    query only: entry points do not fall back to it."""
    return TPUPlace(0) if is_compiled_with_tpu() else CPUPlace(0)


def device_count(kind: Optional[str] = None) -> int:
    return len(device_pool(kind))


def set_device(place: Place):
    """Make ``place`` what ``resolve_device(None)`` returns (and, for a
    card, torch's current CUDA device). Checked: a cuda place with no
    card raises."""
    global _default_device
    dev = place.device()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _default_device = dev
    return place


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the device :func:`set_device` chose, else the CUDA
    card (raises when there is none); ``"cpu"`` -> the CPU;
    ``"cuda[:i]"`` -> that card, checked."""
    if device is None and _default_device is not None:
        return _default_device
    dev = torch.device("cuda" if device is None else device)
    enforce(dev.type in ("cpu", "cuda"),
            "device must be cpu or cuda, got %s", dev)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(_NO_CARD)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        enforce(dev.index < torch.cuda.device_count(),
                "no cuda device with ordinal %s (found %s)", dev.index,
                torch.cuda.device_count())
    return dev
