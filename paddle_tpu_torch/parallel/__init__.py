"""Training drivers of the port (counterpart of paddle_tpu/parallel);
single device for now."""

from .api import Trainer

__all__ = ["Trainer"]
