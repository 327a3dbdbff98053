"""Models of the port (counterpart of paddle_tpu/models)."""

from . import (bert, deepfm, gpt, mnist, resnet, speculative, transformer,
               vit)

__all__ = ["bert", "deepfm", "gpt", "mnist", "resnet", "speculative",
           "transformer", "vit"]
