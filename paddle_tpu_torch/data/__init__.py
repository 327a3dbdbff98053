"""Data helpers of the port (counterpart of paddle_tpu/data): length
bucketing and sequence packing, and the device prefetcher."""

from .bucketing import (bucket_by_length, pack_sequences, pad_to,
                        quantile_boundaries, round_to_bucket)
from .device_loader import BucketPadder, DevicePrefetcher, prefetch_to_device

__all__ = ["BucketPadder", "DevicePrefetcher", "bucket_by_length",
           "pack_sequences", "pad_to", "prefetch_to_device",
           "quantile_boundaries", "round_to_bucket"]
