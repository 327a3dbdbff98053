"""Device resolution (counterpart of paddle_tpu/core/places.py).

The port runs on the CUDA card by default. The CPU is used only when a
caller asks for it (the tests do); with no card and no explicit device,
:func:`resolve_device` raises :class:`DeviceUnavailableError` rather
than carrying on quietly on the CPU."""

from __future__ import annotations

from typing import Union

import torch

from .enforce import DeviceUnavailableError, enforce

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA card (raises when there is none); ``"cpu"``
    -> the CPU; ``"cuda[:i]"`` -> that card, checked."""
    dev = torch.device("cuda" if device is None else device)
    enforce(dev.type in ("cpu", "cuda"),
            "device must be cpu or cuda, got %s", dev)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "no CUDA device is available; the port runs on the card "
                "by default — pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        enforce(dev.index < torch.cuda.device_count(),
                "no cuda device with ordinal %s (found %s)", dev.index,
                torch.cuda.device_count())
    return dev
