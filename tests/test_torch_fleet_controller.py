"""The port's fleet controller (paddle_tpu_torch/resilience/controller.py)
against the JAX package's tests/test_fleet_controller.py, in process:

- the transports: the file store (the JAX key layout, so a JAX and a
  port controller share one root), the ``torch.distributed`` store
  transport (a HashStore here; a missing key reads as None without
  blocking, a store whose host died reads as missing), the auto pick;
- the notice sources, the watcher and the ``fleet.notice`` injection
  point;
- the preempt agreement with thread ranks (max of the acks, dead and
  done ranks dropped, the typed timeout naming the missing ranks, the
  one-key hot path), its lockstep form for ranks whose steps are
  collective, the commit confirmation, the barrier diagnostics;
- TrainLoop.run(controller=): a rank commits the agreed step, a clean
  end announces done, one flag with an explicit handler, two in-process
  ranks commit the same agreed step;
- across the packages: a JAX controller and a port controller on one
  FileTransport root agree on one step.

The pod-level aggregation: publish_endpoint, podz and tracez_fanout over
a debug server."""

import json
import threading
import time
import urllib.request
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

import paddle_tpu.launch as jlaunch
from paddle_tpu.resilience import controller as JC
from paddle_tpu_torch import checkpoint as ckpt_mod
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.core import EnforceError
from paddle_tpu_torch.models.mnist import MnistMLP
from paddle_tpu_torch.parallel import Trainer
from paddle_tpu_torch.resilience import (BarrierTimeoutError, FaultInjector,
                                         FileNotice, FleetController,
                                         HttpNotice, PreemptionHandler)
from paddle_tpu_torch.resilience import controller as C
from paddle_tpu_torch.train_loop import TrainLoop


@pytest.fixture(autouse=True)
def _telemetry_off():
    telemetry.disable()
    yield
    telemetry.disable()


def _controller(tmp_path, rank, world, **kw):
    kw.setdefault("poll_interval_s", 0.0)
    kw.setdefault("hold_poll_s", 0.005)
    kw.setdefault("agree_timeout_s", 5.0)
    kw.setdefault("commit_timeout_s", 5.0)
    return FleetController(
        rank=rank, world=world,
        transport=C.FileTransport(str(tmp_path / "fleet"), "t1"), **kw)


def make_loop(d, **kw):
    model = MnistMLP(16, 8, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    tr = Trainer.supervised(model, TO.Adam(1e-3), torch.nn.functional
                            .cross_entropy)
    return TrainLoop(tr, str(d), **kw)


def batches(n, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield {"x": torch.from_numpy(rng.normal(size=(4, 784)).astype(
                   np.float32)),
               "label": torch.from_numpy(rng.integers(0, 10, 4))}


class _DeadStore:
    """A store whose host rank died: every call raises, as a TCPStore
    client's do."""

    def __getattr__(self, name):
        def call(*a, **kw):
            raise RuntimeError("Connection reset by peer")
        return call


class TestTransports:
    def test_file_transport_roundtrip_and_namespacing(self, tmp_path):
        a = C.FileTransport(str(tmp_path), "runA")
        b = C.FileTransport(str(tmp_path), "runB")
        a.put("preempt.ack.0", "7")
        assert a.get("preempt.ack.0") == "7"
        assert b.get("preempt.ack.0") is None
        assert a.get("nope") is None
        # the JAX package's layout, byte for byte
        assert (tmp_path / "runA.preempt.ack.0").read_text() == "7"
        assert JC.FileTransport(str(tmp_path), "runA").get(
            "preempt.ack.0") == "7"

    def test_sweep_removes_only_stale_foreign_keys(self, tmp_path):
        old = C.FileTransport(str(tmp_path), "runOld", stale_age_s=0.0)
        old.put("preempt.ack.0", "3")
        time.sleep(0.02)
        new = C.FileTransport(str(tmp_path), "runNew", stale_age_s=0.0)
        new.put("debug.0", "x")
        assert new.sweep() == 1
        assert new.get("debug.0") == "x"
        assert old.get("preempt.ack.0") is None

    def test_auto_transport_file_fallback_honors_env(self, tmp_path,
                                                     monkeypatch):
        monkeypatch.setenv(C.ENV_FLEET_DIR, str(tmp_path / "f"))
        monkeypatch.setenv(C.ENV_RUN_ID, "envrun")
        assert C.coordination_client() is None   # no process group here
        t = C.auto_transport()
        assert t.kind == "file"
        assert t.root == str(tmp_path / "f") and t.run_id == "envrun"

    def test_store_transport_probes_without_blocking(self):
        store = dist.HashStore()
        store.set_timeout(timedelta(seconds=30))
        a = C.ClientTransport(store, "runA")
        b = C.ClientTransport(store, "runB")
        t0 = time.monotonic()
        assert a.get("preempt.ack.0") is None    # check(), not get()
        assert time.monotonic() - t0 < 1.0
        a.put("preempt.ack.0", "7")
        a.put("preempt.ack.0", "8")              # every rank may rewrite
        assert a.get("preempt.ack.0") == "8"
        assert b.get("preempt.ack.0") is None
        assert store.get("pt_fleet/runA/preempt.ack.0") == b"8"
        a.delete("preempt.ack.0")                # kept: a peer may read it
        assert a.get("preempt.ack.0") == "8"
        assert a.sweep() == 0

    def test_dead_store_host_reads_as_missing(self):
        t = C.ClientTransport(_DeadStore(), "r")
        assert t.get("preempt.ack.0") is None
        with pytest.raises(RuntimeError):
            t.put("x", "1")


class TestNoticeSources:
    def test_from_env(self, monkeypatch):
        monkeypatch.delenv(C.ENV_NOTICE, raising=False)
        assert C.notice_source_from_env() is None
        monkeypatch.setenv(C.ENV_NOTICE, "/tmp/notice")
        src = C.notice_source_from_env()
        assert isinstance(src, FileNotice)
        assert src.describe() == "file:/tmp/notice"
        monkeypatch.setenv(C.ENV_NOTICE, "http://meta/x")
        src = C.notice_source_from_env()
        assert isinstance(src, HttpNotice) and src.url == "http://meta/x"

    def test_watcher_raises_flag_on_file_notice(self, tmp_path):
        notice = tmp_path / "notice"
        ctl = FleetController(rank=0, world=1,
                              notice_source=FileNotice(str(notice)),
                              watch_interval_s=0.01)
        ctl.start()
        try:
            assert ctl.check(3) is None
            notice.write_text("1")
            deadline = time.time() + 5
            while not ctl.handler.requested() and time.time() < deadline:
                time.sleep(0.01)
            assert ctl.handler.requested()
            assert ctl.request_reason == "notice"
            ctl._watcher.join(timeout=5)
            assert not ctl._watcher.is_alive()   # one-shot
            assert ctl.check(4) == 4
        finally:
            ctl.stop()

    def test_fleet_notice_injection_point_is_deterministic(self, tmp_path):
        ctl = FleetController(
            rank=0, world=1,
            notice_source=FileNotice(str(tmp_path / "never")),
            watch_interval_s=0.01)
        inj = FaultInjector(seed=11).on("fleet.notice", at=(3,),
                                        corrupt=True)
        with inj:
            ctl.start()
            try:
                deadline = time.time() + 5
                while not ctl.handler.requested() and \
                        time.time() < deadline:
                    time.sleep(0.01)
                assert ctl.handler.requested()
                assert inj.fired["fleet.notice"] == 1
                assert inj.calls["fleet.notice"] == 3
            finally:
                ctl.stop()


def _run_threads(*fns):
    out, ts = {}, []
    for i, fn in enumerate(fns):
        def body(i=i, fn=fn):
            out[i] = fn()
        ts.append(threading.Thread(target=body, name=f"pt-test-r{i}"))
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=20)
    return [out.get(i) for i in range(len(fns))]


class TestAgreement:
    def test_world_one_agrees_on_own_step(self):
        ctl = FleetController(rank=0, world=1)
        assert ctl.check(5) is None
        ctl.request()
        assert ctl.check(5) == 5
        assert ctl.confirm_committed(5) == {0: 5}

    def test_two_ranks_agree_on_max_ack(self, tmp_path):
        c0 = _controller(tmp_path, 0, 2)
        c1 = _controller(tmp_path, 1, 2)
        c1.request()

        def rank0():
            deadline = time.time() + 5
            while c0.check(12) is None and time.time() < deadline:
                time.sleep(0.01)
            return c0.agreed_step

        got1, got0 = _run_threads(lambda: c1.check(7), rank0)
        assert got1 == 12 and got0 == 12       # nobody rewinds
        assert c1.acked_step == 7

    def test_simultaneous_sigterm_both_ranks(self, tmp_path):
        c0 = _controller(tmp_path, 0, 2)
        c1 = _controller(tmp_path, 1, 2)
        c0.request()
        c1.request()
        assert _run_threads(lambda: c0.check(5),
                            lambda: c1.check(9)) == [9, 9]

    def test_agreement_timeout_is_typed_and_names_missing(self, tmp_path):
        c1 = _controller(tmp_path, 1, 2, agree_timeout_s=0.3)
        c1.request()
        with pytest.raises(BarrierTimeoutError) as ei:
            c1.check(4)
        assert ei.value.missing == [0] and ei.value.world == 2
        assert "preempt-agreement" in str(ei.value)

    def test_timeout_bumps_barrier_timeouts_counter(self, tmp_path):
        telemetry.enable()
        c1 = _controller(tmp_path, 1, 2, agree_timeout_s=0.2)
        c1.request()
        with pytest.raises(BarrierTimeoutError):
            c1.check(4)
        c = telemetry.registry().get("pt_barrier_timeouts_total")
        assert c is not None and c.value >= 1

    def test_dead_rank_is_dropped_from_agreement(self, tmp_path):
        c1 = _controller(tmp_path, 1, 2, agree_timeout_s=2.0)
        c1.transport.put("dead.0", "1")
        c1.request()
        assert c1.check(6) == 6
        assert c1.confirm_committed(6) == {1: 6}

    def test_dead_ranks_published_ack_still_bounds_the_max(self, tmp_path):
        c1 = _controller(tmp_path, 1, 3)
        c1.transport.put("preempt.ack.0", "4")
        c1.transport.put("preempt.ack.2", "10")
        c1.transport.put("dead.2", "1")
        c1.request()
        assert c1.check(4) == 10

    def test_hot_path_peek_is_one_key(self, tmp_path):
        c0 = _controller(tmp_path, 0, 16)
        reads = []
        orig = c0.transport.get
        c0.transport.get = lambda key: reads.append(key) or orig(key)
        assert c0.check(3) is None
        assert reads == ["preempt.flag"]

    def test_done_rank_is_dropped_from_agreement(self, tmp_path):
        c0 = _controller(tmp_path, 0, 2)
        c1 = _controller(tmp_path, 1, 2)
        c1.note_done(11)
        c0.request()
        assert c0.check(4) == 4
        assert c0.confirm_committed(4) == {0: 4}

    def test_launcher_file_markers_visible_on_store_transport(
            self, tmp_path, monkeypatch):
        """The launcher writes its dead markers to the file root whatever
        the workers coordinate over (the JAX launcher's _mark_dead here)."""
        monkeypatch.setenv(C.ENV_FLEET_DIR, str(tmp_path / "fleet"))
        c1 = FleetController(
            rank=1, world=2, run_id="cx",
            transport=C.ClientTransport(dist.HashStore(), "cx"),
            agree_timeout_s=2.0, poll_interval_s=0.0, hold_poll_s=0.005)
        jlaunch._mark_dead(str(tmp_path / "fleet"), "cx", 0)
        c1.request()
        assert c1.check(8) == 8
        assert c1.confirm_committed(8) == {1: 8}

    def test_dead_store_host_ends_in_typed_timeout_naming_it(self):
        """Rank 0 hosts the TCPStore; when it dies every read of the
        survivors raises. The wait ends in BarrierTimeoutError naming
        rank 0, never a hang or a bare RuntimeError."""
        c1 = FleetController(rank=1, world=2, run_id="d",
                             transport=C.ClientTransport(_DeadStore(), "d"),
                             agree_timeout_s=0.3, hold_poll_s=0.01)
        with pytest.raises(BarrierTimeoutError) as ei:
            c1._wait_all("preempt.ack", timeout_s=0.3,
                         what="preempt-agreement")
        assert 0 in ei.value.missing

    def test_confirm_committed_gathers_all_ranks(self, tmp_path):
        c0 = _controller(tmp_path, 0, 2)
        c1 = _controller(tmp_path, 1, 2)
        v = _run_threads(lambda: c0.confirm_committed(9),
                         lambda: c1.confirm_committed(9))
        assert v == [{0: 9, 1: 9}, {0: 9, 1: 9}]
        assert c0.last_committed_step == 9

    def test_check_is_cheap_until_preempted(self, tmp_path):
        c0 = _controller(tmp_path, 0, 2, poll_interval_s=3600.0)
        peeks = []
        orig = c0.transport.get
        c0.transport.get = lambda key: peeks.append(key) or orig(key)
        for s in range(50):
            assert c0.check(s) is None
        assert peeks == []

    def test_lockstep_ranks_agree_without_holding(self, tmp_path):
        """Ranks whose steps are collective: the requester at boundary 5
        acks 6 and trains on; the peer notices at boundary 5 or 6 and
        acks one more; both stop at the max, and no check holds."""
        c0 = _controller(tmp_path, 0, 2, poll_interval_s=3600.0)
        c1 = _controller(tmp_path, 1, 2, poll_interval_s=3600.0)
        c1.request()
        assert c1.check(5, lockstep=True) is None     # acked 6, trains on
        assert c1.acked_step == 6
        # the peer sees the flag at 5 and acks 6: every ack is in, it
        # trains on to 6 (5 < 6), as the requester does
        assert c0.check(5, lockstep=True) == 6
        assert c0.acked_step == 6
        assert c1.check(6, lockstep=True) == 6
        # a peer that notices a boundary later moves the agreement on
        d0 = _controller(tmp_path / "b", 0, 2)
        d1 = _controller(tmp_path / "b", 1, 2)
        d1.request()
        assert d1.check(5, lockstep=True) is None     # acks 6
        assert d1.check(6, lockstep=True) is None     # rank 0's ack missing
        assert d0.check(6, lockstep=True) == 7        # noticed at 6: acks 7
        assert d1.check(7, lockstep=True) == 7

    def test_lockstep_agreement_times_out_typed(self, tmp_path):
        c1 = _controller(tmp_path, 1, 2, agree_timeout_s=0.05)
        c1.request()
        assert c1.check(3, lockstep=True) is None
        time.sleep(0.1)
        with pytest.raises(BarrierTimeoutError) as ei:
            c1.check(4, lockstep=True)
        assert ei.value.missing == [0]


class TestBarrierDiagnostics:
    def test_file_barrier_timeout_names_missing_ranks(self, tmp_path):
        target = str(tmp_path / "ckpt" / "step_1")
        (tmp_path / "ckpt").mkdir()
        before = ckpt_mod.barrier_stats()["timeouts"]
        with pytest.raises(BarrierTimeoutError) as ei:
            ckpt_mod._file_barrier(target, "diag1", rank=1, world=3,
                                   timeout_s=0.3)
        assert ei.value.missing == [0, 2] and ei.value.world == 3
        assert ckpt_mod.barrier_stats()["timeouts"] == before + 1

    def test_file_barrier_timeout_counts_metric(self, tmp_path):
        telemetry.enable()
        (tmp_path / "ckpt").mkdir()
        c = telemetry.registry().counter("pt_barrier_timeouts_total")
        before = c.value
        with pytest.raises(BarrierTimeoutError):
            ckpt_mod._file_barrier(str(tmp_path / "ckpt" / "step_1"),
                                   "diag2", rank=0, world=2, timeout_s=0.2)
        assert c.value == before + 1

    def test_barrier_timeout_is_enforce_error(self):
        assert issubclass(BarrierTimeoutError, EnforceError)


class TestStatus:
    def test_statusz_reports_controller_view(self, tmp_path):
        ctl = _controller(tmp_path, 0, 2,
                          notice_source=FileNotice(str(tmp_path / "n")))
        with ctl:
            assert C.active() is ctl
            view = ctl.statusz()
            assert view["active"] and view["world_size"] == 2
            assert view["transport"] == "file"
            assert view["notice_source"] == f"file:{tmp_path / 'n'}"
            assert "last_barrier_latency_s" in view
        assert C.active() is None

    @pytest.mark.parametrize("call", ["podz", "publish_endpoint",
                                      "tracez_fanout"])
    def test_pod_aggregation_raises_naming_item_8(self, tmp_path, call):
        """The pod-level aggregation the telemetry slice ported (it
        raised before): rank 0 publishes its debug server, rank 1
        publishes nothing; both fan-outs render a row per rank."""
        from paddle_tpu_torch.telemetry import DebugServer

        ctl = _controller(tmp_path, 0, 2)
        with DebugServer(port=0) as srv:
            ctl.publish_endpoint(srv.host, srv.port)
            assert ctl.transport.get("debug.0") == \
                f"{srv.host}:{srv.port}"
            if call == "podz":
                view = ctl.podz()
                assert view["world_size"] == 2
                assert view["ranks"]["0"]["healthz"]["status"] == "ok"
                assert view["ranks"]["1"]["endpoint"] is None
            elif call == "tracez_fanout":
                view = ctl.tracez_fanout(None)
                assert view["ranks"]["0"]["source"] == "local"
                assert view["ranks"]["1"]["error"] == \
                    "no endpoint published"
                assert "traceEvents" in view["trace"]


class TestTrainLoopCoordinated:
    def test_single_rank_commits_agreed_step(self, tmp_path):
        ctl = FleetController(rank=0, world=1)
        loop = make_loop(tmp_path / "ckpt", checkpoint_every=100)

        def on_step(step, loss, metrics):
            if step == 3:
                ctl.request()

        assert loop.run(batches(20), on_step=on_step, controller=ctl) == 3
        assert loop.status == "preempted"
        assert loop.history["preempt_agreed_step"] == 3
        assert loop.manager.latest_step() == 3
        assert ctl.last_committed_step == 3
        assert not ctl.started
        assert make_loop(tmp_path / "ckpt").maybe_resume() == 3

    def test_completed_loop_announces_done(self, tmp_path):
        c0 = _controller(tmp_path, 0, 2)
        loop = make_loop(tmp_path / "ckpt", checkpoint_every=100)
        assert loop.run(batches(10), num_steps=2, controller=c0) == 2
        assert loop.status == "completed"
        assert c0.transport.get("done.0") == "2"
        c1 = _controller(tmp_path, 1, 2)
        c1.request()
        assert c1.check(5) == 5

    def test_explicit_preemption_handler_shares_controller_flag(
            self, tmp_path):
        h = PreemptionHandler()
        ctl = FleetController(rank=0, world=1)
        loop = make_loop(tmp_path / "ckpt", checkpoint_every=100)

        def on_step(step, loss, metrics):
            if step == 2:
                h.request()

        assert loop.run(batches(10), on_step=on_step, preemption=h,
                        controller=ctl) == 2
        assert loop.status == "preempted" and ctl.handler is h
        assert loop.manager.latest_step() == 2

    def test_two_inprocess_ranks_commit_same_agreed_step(self, tmp_path):
        """Two loops and two controllers on one file transport: a request
        on rank 0 makes both commit one agreed step, globally."""
        kw = dict(poll_interval_s=0.01, agree_timeout_s=30.0,
                  commit_timeout_s=30.0)
        c0 = _controller(tmp_path, 0, 2, **kw)
        c1 = _controller(tmp_path, 1, 2, **kw)
        loop0 = make_loop(tmp_path / "ckpt0", checkpoint_every=3)
        loop1 = make_loop(tmp_path / "ckpt1", checkpoint_every=3)
        err = []

        def rank1():
            try:
                loop1.run(batches(4000, 1), controller=c1)
            except BaseException as e:       # surfaced below
                err.append(e)

        t = threading.Thread(target=rank1, name="pt-test-loop1")

        def on_step(step, loss, metrics):
            if step == 2:
                t.start()
            if step == 6:
                c0.request()

        loop0.run(batches(4000), on_step=on_step, controller=c0)
        t.join(timeout=60)
        assert not t.is_alive() and not err, err
        assert loop0.status == loop1.status == "preempted"
        agreed = c0.agreed_step
        assert agreed is not None and agreed == c1.agreed_step
        for loop in (loop0, loop1):
            assert loop.manager.latest_step() == agreed
            assert loop.history["preempt_agreed_step"] == agreed
            assert agreed in loop.manager.globally_committed_steps()
        assert c0.committed_view == {0: agreed, 1: agreed}


def test_jax_and_port_controllers_agree_on_one_step(tmp_path):
    """A JAX FleetController (rank 0) and a port one (rank 1) on one
    FileTransport root: the same key files, the same agreed step, the
    same commit view."""
    kw = dict(poll_interval_s=0.0, hold_poll_s=0.005, agree_timeout_s=5.0,
              commit_timeout_s=5.0)
    root = str(tmp_path / "fleet")
    j0 = JC.FleetController(rank=0, world=2,
                            transport=JC.FileTransport(root, "mix"), **kw)
    p1 = FleetController(rank=1, world=2,
                         transport=C.FileTransport(root, "mix"), **kw)
    p1.request()

    def rank0():
        deadline = time.time() + 5
        while j0.check(11) is None and time.time() < deadline:
            time.sleep(0.01)
        return j0.agreed_step

    got1, got0 = _run_threads(lambda: p1.check(8), rank0)
    assert got0 == got1 == 11
    assert _run_threads(lambda: j0.confirm_committed(11),
                        lambda: p1.confirm_committed(11)) == \
        [{0: 11, 1: 11}] * 2
    # the restore agreement crosses too: the newest common step
    assert _run_threads(lambda: j0.agree_restore_step([2, 4, 6]),
                        lambda: p1.agree_restore_step([4, 6, 8])) == [6, 6]


class TestPodAggregation:
    """The pod-level views over two ranks, each with its own debug server
    (as ``TrainLoop.run(controller=, debug_port=)`` mounts them), held
    against the JAX controller's row and view layout."""

    def test_podz_and_tracez_fanout_over_two_ranks(self, tmp_path):
        from paddle_tpu.resilience.controller import \
            FleetController as JaxController
        from paddle_tpu_torch.telemetry import DebugServer
        from paddle_tpu_torch.telemetry import tracing

        telemetry.enable()
        c0, c1 = (_controller(tmp_path, r, 2) for r in (0, 1))
        c1.request(reason="test")
        # the agreement leaves its breadcrumbs on the trace ring
        def rank0():
            deadline = time.time() + 5
            while c0.check(3) is None and time.time() < deadline:
                time.sleep(0.01)
            return c0.agreed_step

        assert _run_threads(lambda: c1.check(3), rank0) == [3, 3]
        names = [s["name"] for s in tracing.spans()]
        for n in ("fleet.preempt.request", "fleet.preempt.ack",
                  "fleet.preempt.agreed"):
            assert n in names
        with DebugServer(port=0) as s0, DebugServer(port=0) as s1:
            for ctl, srv in ((c0, s0), (c1, s1)):
                ctl.publish_endpoint(srv.host, srv.port)
                srv.set_fleet(ctl.podz)
                srv.set_trace_fanin(ctl.tracez_fanout)
            view = c0.podz()
            assert view["world_size"] == 2 and view["aggregator_rank"] == 0
            for r in ("0", "1"):
                row = view["ranks"][r]
                assert row["healthz"]["status"] == "ok"
                assert row["endpoint"] and not row["dead"]
            jrow = JaxController(rank=0, world=1)._podz_row(0)
            assert set(jrow) <= set(view["ranks"]["0"])
            # the fan-in over /tracez: one merged chrome trace, rank lanes
            with urllib.request.urlopen(s1.url("/tracez?fanin=1"),
                                        timeout=10) as r:
                merged = json.loads(r.read())
            assert {row.get("source") for row in merged["ranks"].values()} \
                == {"local", f"{s0.host}:{s0.port}"}
            lanes = {e["args"]["name"] for e in merged["trace"]["traceEvents"]
                     if e.get("name") == "process_name"}
            assert lanes & {"rank0", "rank1"}
            with urllib.request.urlopen(s0.url("/podz"), timeout=10) as r:
                assert json.loads(r.read())["world_size"] == 2
        telemetry.reset()
