"""The port's request-reliability plane (paddle_tpu_torch/resilience/
reliability.py) against the JAX package's on the same inputs: the
``X-PT-Deadline`` header both ways, the ambient deadline's binding, and
the decisions of the retry budget, the latency tracker's hedge
threshold and the replica breakers on one seeded event sequence (the
router that drives them comes with the serving fleet)."""

import numpy as np
import pytest

from paddle_tpu.resilience import reliability as J
from paddle_tpu_torch.resilience import reliability as T


def test_deadline_header_round_trips_between_the_packages():
    for make in (J.Deadline.after, T.Deadline.after):
        d = make(3.5)
        hdr = d.to_header()
        for other in (J.Deadline, T.Deadline):
            back = other.from_header(hdr)
            assert back.t_end == d.t_end
            assert back.to_header() == hdr
    assert J.DEADLINE_HEADER == T.DEADLINE_HEADER == "X-PT-Deadline"
    for bad in ("", "soon", None):
        assert T.Deadline.from_header(bad) is None
        assert J.Deadline.from_header(bad) is None


def test_bound_deadline_and_expiry_match():
    for mod in (J, T):
        assert mod.current() is None
        d = mod.Deadline(0.0)
        with mod.bind(d):
            assert mod.current() is d
            with mod.bind(None):
                assert mod.current() is None
            assert mod.current().expired()
            with pytest.raises(mod.DeadlineExceededError,
                               match="prefill"):
                mod.current().check("prefill")
        assert mod.current() is None
        assert not mod.Deadline.after(60).expired()


def _events(seed):
    rng = np.random.default_rng(seed)
    return [(("take", "ok", "lat", "timeout", "queue")[k], float(v))
            for k, v in zip(rng.integers(0, 5, 300),
                            rng.exponential(0.05, 300))]


def _drive(mod, events):
    """One seeded sequence through a plane: retries, successes,
    per-replica latencies, queue depths and timeouts over three
    replicas, recording every decision."""
    plane = mod.ReliabilityPlane(mod.ReliabilityConfig(
        retry_budget=4, retry_refill=0.25, hedge_min_samples=10,
        consecutive_timeouts=3))
    out = []
    for i, (kind, v) in enumerate(events):
        h = plane.health(f"r{i % 3}")
        if kind == "take":
            out.append(plane.budget.take())
        elif kind == "ok":
            plane.budget.note_success()
        elif kind == "lat":
            # replica r2 is the slow one
            s = v * (8.0 if h.name == "r2" else 1.0) + 0.06
            h.note_latency(s)
            plane.latency.observe(s)
        elif kind == "timeout":
            h.note_timeout()
        else:
            h.note_queue(v * 100)
        reason = plane.quarantine_reason(h)
        if reason:
            h.trip(reason)
            out.append((h.name, reason))
        out.append(plane.hedge_threshold())
    st = plane.statusz()
    return out, st["budget"], {n: {k: v for k, v in r.items()}
                               for n, r in st["replicas"].items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_budget_hedge_and_breakers_decide_alike(seed):
    events = _events(seed)
    assert _drive(J, events) == _drive(T, events)


def test_breaker_cycle_and_latency_tracker():
    for mod in (J, T):
        h = mod.ReplicaHealth("a")
        h.trip("x")
        assert h.state == "open" and h.probe_due(0.0)
        h.half_open()
        h.reopen()
        assert h.state == "open" and h.opened_count == 1
        h.close()
        assert h.snapshot()["state"] == "closed"
        lt = mod.LatencyTracker(window=8, min_samples=4, quantile=0.5)
        assert lt.threshold() is None
        for s in (5, 1, 4, 2, 3, 9, 7, 8, 6, 0):
            lt.observe(s)
        assert lt.count() == 8
    lts = []
    for mod in (J, T):
        lt = mod.LatencyTracker(window=8, min_samples=4, quantile=0.5)
        for s in (5, 1, 4, 2, 3, 9, 7, 8, 6, 0):
            lt.observe(s)
        lts.append(lt.threshold())
    assert lts[0] == lts[1]
    assert T.statusz_section() == J.statusz_section()
