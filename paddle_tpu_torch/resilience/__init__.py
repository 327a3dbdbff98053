"""The fault-tolerance plane of the port (counterpart of
paddle_tpu/resilience): the preemption grace handler, bounded retry of
transient I/O, checkpoint checksums and seeded fault injection. The
request-reliability plane and the fleet controller come with the
serving fleet and distribution (ROADMAP queue 1 items 8 and 11)."""

from . import faults, integrity, preemption, retry
from .faults import POINTS, FaultError, FaultInjector
from .integrity import ChecksumError, checksum_bytes, verify_bytes
from .preemption import PreemptionHandler
from .retry import DEFAULT_POLICY, RetryPolicy, retry_io

__all__ = [
    "ChecksumError", "DEFAULT_POLICY", "FaultError", "FaultInjector",
    "POINTS", "PreemptionHandler", "RetryPolicy", "checksum_bytes",
    "faults", "integrity", "preemption", "retry", "retry_io",
    "verify_bytes",
]
