"""Utilities of the port: atomic writes, FLOPs accounting and MFU,
memory estimation (counterpart of paddle_tpu/utils)."""

from .atomic import atomic_write_bytes, atomic_write_text
from .flops import device_peak_flops, lowered_flops, mfu
from .memory import (bytes_of_tree, estimate_training_memory, format_bytes,
                     memory_usage)

__all__ = ["atomic_write_bytes", "atomic_write_text", "bytes_of_tree",
           "estimate_training_memory", "format_bytes", "memory_usage",
           "device_peak_flops", "lowered_flops", "mfu"]
