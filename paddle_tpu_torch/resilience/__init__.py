"""The fault-tolerance plane of the port (counterpart of
paddle_tpu/resilience): the preemption grace handler, bounded retry of
transient I/O, checkpoint checksums, seeded fault injection, the request
reliability plane (end-to-end :class:`Deadline` budgets propagated
beside the trace context, retry budgets, hedge thresholds and per-replica
circuit breakers) and the elastic fleet controller
(:class:`FleetController`: the step-agreed preemption, the two-phase
global commit of every periodic save, the restore-step agreement, the
pod-level ``/podz`` and ``/tracez`` fan-outs; :class:`BarrierTimeoutError`
names the ranks a coordination wait lacked).

Everything here is opt-in: with no handler installed and no injector
armed, the training and serving hot paths run no resilience code."""

from typing import Any, Dict

from . import controller, faults, integrity, preemption, reliability, retry
from .controller import (BarrierTimeoutError, FileNotice,
                         FleetController, HttpNotice)
from .faults import POINTS, FaultError, FaultInjector
from .integrity import ChecksumError, checksum_bytes, verify_bytes
from .preemption import PreemptionHandler
from .reliability import (DEADLINE_HEADER, Deadline, DeadlineExceededError,
                          LatencyTracker, ReliabilityConfig,
                          ReliabilityPlane, ReplicaHealth, RetryBudget,
                          RetryBudgetExhaustedError)
from .retry import DEFAULT_POLICY, RetryPolicy, retry_io

__all__ = [
    "BarrierTimeoutError", "ChecksumError", "DEADLINE_HEADER",
    "DEFAULT_POLICY", "Deadline", "DeadlineExceededError", "FaultError",
    "FaultInjector", "FileNotice", "FleetController", "HttpNotice",
    "LatencyTracker", "POINTS", "PreemptionHandler", "ReliabilityConfig",
    "ReliabilityPlane", "ReplicaHealth", "RetryBudget",
    "RetryBudgetExhaustedError", "RetryPolicy", "checksum_bytes",
    "controller", "faults", "integrity", "preemption", "reliability",
    "retry", "retry_io", "statusz", "verify_bytes",
]


def statusz() -> Dict[str, Any]:
    """Resilience section of the debug server's /statusz: the ambient
    preemption handler, the armed injector's schedule and the fleet
    controller (each usually absent; the absence is the signal)."""
    handler = preemption.active()
    inj = faults.active()
    ctl = controller.active()
    return {"preemption": (handler.statusz() if handler is not None
                           else {"installed": False}),
            "faults": (inj.statusz() if inj is not None
                       else {"armed": False}),
            "controller": (ctl.statusz() if ctl is not None
                           else {"active": False})}
