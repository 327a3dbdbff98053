"""Data helpers of the port (counterpart of paddle_tpu/data)."""

from .bucketing import pack_sequences

__all__ = ["pack_sequences"]
