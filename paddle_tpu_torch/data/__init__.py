"""Data helpers of the port (counterpart of paddle_tpu/data)."""

from .bucketing import pack_sequences, round_to_bucket
from .device_loader import BucketPadder, DevicePrefetcher, prefetch_to_device

__all__ = ["BucketPadder", "DevicePrefetcher", "pack_sequences",
           "prefetch_to_device", "round_to_bucket"]
