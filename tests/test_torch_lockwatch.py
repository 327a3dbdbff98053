"""The port's runtime lock-order watchdog (paddle_tpu_torch/telemetry/
lockwatch.py) against the JAX package's on the same acquisition
sequences: the same edges, the same inversion (cycle, closing edge, the
prior edge's thread), the same static-graph verdict, and the seeded
``lock.acquire`` fault rule of the port's ``resilience/faults.py``
driving a real two-thread inversion that the port's watchdog names with
both witness stacks."""

import threading
import time

import pytest

from paddle_tpu.resilience.faults import FaultInjector as JFI
from paddle_tpu.telemetry import lockwatch as JL
from paddle_tpu_torch.resilience.faults import FaultInjector as TFI
from paddle_tpu_torch.telemetry import lockwatch as TL


@pytest.fixture(autouse=True)
def clean():
    for lw in (JL, TL):
        lw.disable()
    yield
    for lw in (JL, TL):
        lw.disable()


def _run_threads(*fns):
    ts = [threading.Thread(target=fn, name=f"pt-lw-{fn.__name__}")
          for fn in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in ts), "worker wedged"


def _sequence(lw):
    """A, B, C acquired in orders that close one cycle (C -> A after
    A -> B -> C), one thread after the other (no real deadlock)."""
    wd = lw.enable()
    a, b, c = (lw.WatchedLock(n) for n in "ABC")

    def first():
        with a, b:
            pass
        with b, c:
            pass

    def second():
        with c, a:
            pass

    for fn in (first, second):
        _run_threads(fn)
    rep = wd.report()
    verdict = wd.verify_static({("A", "B"): "w", ("B", "C"): "w",
                                ("X", "Y"): "w"})
    lw.disable()
    return rep, verdict


def test_inversion_and_static_verdict_match_jax():
    (jrep, jver), (trep, tver) = _sequence(JL), _sequence(TL)
    assert jrep["edges"] == trep["edges"] == {"A -> B": 1, "B -> C": 1,
                                              "C -> A": 1}
    for key in ("cycle", "edge", "prior_edge", "prior_thread", "thread"):
        assert jrep["violations"][0][key] == trep["violations"][0][key]
    assert trep["violations"][0]["witness"]
    assert trep["violations"][0]["prior_witness"]
    assert jver == tver


def test_disabled_lock_is_the_plain_lock_and_fires_nothing():
    for lw, fi in ((JL, JFI), (TL, TFI)):
        inj = fi(seed=3).on("lock.acquire", delay_s=0.0)
        with inj:
            lk = lw.WatchedLock("Z")
            with lk:
                assert lk.locked()
            assert not lk.locked()
        assert inj.calls["lock.acquire"] == 0
        assert lw.active() is None
        with pytest.raises(lw.LockOrderError):
            lw.enable(raise_on_inversion=True)
            x, y = lw.WatchedLock("X"), lw.WatchedLock("Y")
            with x, y:
                pass
            with y, x:
                pass
        assert not x.locked() and not y.locked()
        lw.disable()


def test_seeded_delay_drives_a_real_inversion():
    """The JAX package's chaos drive on the port: a seeded delay rule
    (``match`` one lock, ``times=1``) lands on the inverted path's first
    acquisition, so the two workers' orders interleave the same way every
    run, both orders are really taken, and no worker deadlocks."""
    wd = TL.enable()
    outer, inner = TL.WatchedLock("router.mu"), TL.WatchedLock("replica.mu")
    inj = TFI(seed=7).on("lock.acquire", delay_s=0.05, match="replica.mu",
                         times=1)

    def forward_path():
        with outer:
            time.sleep(0.02)
            with inner:
                pass

    def inverted_path():
        time.sleep(0.01)             # inside forward's hold window
        with inner:
            time.sleep(0.02)
            with outer:
                pass

    with inj:
        _run_threads(forward_path, inverted_path)
    assert inj.fired["lock.acquire"] == 1
    assert len(wd.violations) == 1
    v = wd.violations[0]
    assert set(v["cycle"]) == {"router.mu", "replica.mu"}
    both = v["witness"] + v["prior_witness"]
    assert any("forward_path" in f for f in both)
    assert any("inverted_path" in f for f in both)
