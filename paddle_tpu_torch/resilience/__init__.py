"""The fault-tolerance plane of the port (counterpart of
paddle_tpu/resilience): the preemption grace handler, bounded retry of
transient I/O, checkpoint checksums, seeded fault injection, and the
elastic fleet controller (:class:`FleetController`: the step-agreed
preemption, the two-phase global commit of every periodic save, the
restore-step agreement; :class:`BarrierTimeoutError` names the ranks a
coordination wait lacked). The request-reliability plane comes with the
serving fleet (ROADMAP queue 1 item 8)."""

from . import controller, faults, integrity, preemption, retry
from .controller import (BarrierTimeoutError, FileNotice,
                         FleetController, HttpNotice)
from .faults import POINTS, FaultError, FaultInjector
from .integrity import ChecksumError, checksum_bytes, verify_bytes
from .preemption import PreemptionHandler
from .retry import DEFAULT_POLICY, RetryPolicy, retry_io

__all__ = [
    "BarrierTimeoutError", "ChecksumError", "DEFAULT_POLICY",
    "FaultError", "FaultInjector", "FileNotice", "FleetController",
    "HttpNotice", "POINTS", "PreemptionHandler", "RetryPolicy",
    "checksum_bytes", "controller", "faults", "integrity", "preemption",
    "retry", "retry_io", "verify_bytes",
]
