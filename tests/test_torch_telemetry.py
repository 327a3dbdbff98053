"""The port's metrics export, flight recorder, device-memory view and
debug server against the JAX package's on the same inputs:

- ``prometheus_text`` / ``openmetrics_text`` / ``summary`` of the same
  instrument updates (labels, exemplars, histograms) are equal byte for
  byte;
- ``FlightRecorder``: the same decisions (anomaly kinds, policies,
  dumps) on one seeded step sequence, and the same bundle layout;
- ``device_memory`` with no card: the JAX package's ``memory_stats:
  None`` contract with the live-tensor fallback; no peak without stats;
- ``DebugServer``: the endpoints, content types, status codes and
  ``/statusz`` sections of the JAX package's server (loopback, port 0,
  every thread joined); ``/profilez``'s 404 -> 409 -> 200 machine; the
  ``X-PT-Trace`` and ``X-PT-Deadline`` headers bound for a POST
  handler."""

import json
import math
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu import telemetry as JT
from paddle_tpu_torch import telemetry as TT
from paddle_tpu_torch.resilience import reliability as TRel
from paddle_tpu_torch.telemetry import profiling as TP
from paddle_tpu_torch.telemetry import tracing as TTG


@pytest.fixture(autouse=True)
def clean():
    for t in (JT, TT):
        t.enable()
        t.reset()
    yield
    for t in (JT, TT):
        t.reset()
        t.disable()


def _updates(T):
    reg = T.registry()
    c = reg.counter("pt_test_requests_total", "requests")
    c.inc(3)
    reg.counter("pt_test_rej_total", "rejects", labels={"cause": "shed"}
                ).inc()
    reg.counter("pt_test_rej_total", "rejects",
                labels={"cause": "deadline"}).inc(2)
    reg.gauge("pt_test_depth", "queue depth").set(7.25)
    h = reg.histogram("pt_test_latency_seconds", "latency", unit="s")
    rng = np.random.default_rng(4)
    for i, v in enumerate(rng.exponential(0.02, 50)):
        h.observe(float(v), exemplar=f"trace{i}" if i % 7 == 0 else None)
    reg.gauge("pt_test_nan", "not a number").set(float("nan"))


def test_exposition_is_byte_equal(monkeypatch):
    # the exemplars carry their wall-clock stamp: one clock for both
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    _updates(JT)
    _updates(TT)
    assert TT.prometheus_text() == JT.prometheus_text()
    assert TT.openmetrics_text() == JT.openmetrics_text()
    assert TT.summary() == JT.summary()
    assert "# EOF" in TT.openmetrics_text()


def _feed(T, dump_dir, policy):
    rec = T.FlightRecorder(str(dump_dir), policy=policy, warmup_steps=5,
                           max_dumps=2, run_config={"cell": "test"})
    rng = np.random.default_rng(9)
    out = []
    for step in range(1, 41):
        loss = float(rng.normal(2.0, 0.1))
        gn = float(rng.uniform(0.5, 1.5))
        dt = float(rng.uniform(0.01, 0.012))
        if step == 12:
            gn = 40.0                       # a grad spike
        if step == 18:
            dt = 1.0                        # a stall
        if step in (25, 30):
            loss = float("nan")
        out.append(rec.record_step(step, loss=loss, grad_norm=gn,
                                   step_time=dt, loss_scale=2.0 ** 15,
                                   queue_depth=2))
    return rec, out


@pytest.mark.parametrize("policy", ["record", "halt"])
def test_flight_recorder_decides_alike(tmp_path, policy):
    jrec, jout = _feed(JT, tmp_path / "j", policy)
    trec, tout = _feed(TT, tmp_path / "t", policy)
    assert jout == tout
    assert [(a["step"], a["kind"]) for a in jrec.anomalies] == \
        [(a["step"], a["kind"]) for a in trec.anomalies] == \
        [(12, "grad_spike"), (18, "step_stall"), (25, "nan_loss"),
         (30, "nan_loss")]
    assert len(trec.dumps) == 2 and trec.anomalies_total == 4
    jb = json.load(open(jrec.dumps[0]))
    tb = json.load(open(trec.dumps[0]))
    assert sorted(jb) == sorted(tb)
    assert jb["ring"][-1].keys() == tb["ring"][-1].keys()
    assert str(trec.halt_error("step 30")) .startswith(
        "flight recorder halt at step 30: nan_loss")
    with pytest.raises(ValueError):
        TT.FlightRecorder(str(tmp_path), policy="panic")


def test_device_memory_contract_without_a_card():
    held = np.ones(1 << 16, np.float32)
    import torch

    t = torch.from_numpy(held)
    mem = TT.device_memory()
    assert len(mem) == 1 and mem[0]["platform"] == "cpu"
    assert mem[0]["memory_stats"] is None
    assert mem[0]["live_array_bytes"] >= t.numel() * 4
    assert TT.peak_memory_bytes() is None
    assert set(mem[0]) == set(JT.device_memory()[0])


def _get(srv, path):
    try:
        with urllib.request.urlopen(srv.url(path), timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _post(srv, path, body=b"{}", headers=None):
    req = urllib.request.Request(srv.url(path), data=body,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_debug_server_endpoints_match_jax():
    views = {}
    for name, T in (("jax", JT), ("port", TT)):
        with T.DebugServer(port=0, run_config={"role": "test"}) as srv:
            srv.add_status("arena", lambda: {"slots": 2})
            srv.note("step")
            got = {p: _get(srv, p) for p in
                   ("/", "/metrics", "/healthz", "/readyz", "/statusz",
                    "/tracez", "/memz", "/podz", "/nope")}
            srv.set_ready(lambda: False)
            got["/readyz-set"] = _get(srv, "/readyz")
            got["/profilez"] = _post(srv, "/profilez")
        assert not srv.running and srv.port > 0
        views[name] = got
    j, t = views["jax"], views["port"]
    for path in j:
        assert j[path][0] == t[path][0], path
        assert j[path][1] == t[path][1], path
    assert json.loads(t["/"][2]) == json.loads(j["/"][2])
    js, ts = json.loads(j["/statusz"][2]), json.loads(t["/statusz"][2])
    assert sorted(js) == sorted(ts)
    assert ts["devices"][0]["platform"] == "cpu" == ts["backend"]
    assert ts["status"] == {"arena": {"slots": 2}}
    assert sorted(ts["resilience"]) == sorted(js["resilience"])
    assert sorted(ts["goodput"]) == sorted(js["goodput"])
    assert ts["costs"]["peaks"]["nominal"] is True
    assert sorted(json.loads(t["/tracez"][2])) == \
        sorted(json.loads(j["/tracez"][2]))
    assert sorted(json.loads(t["/healthz"][2])) == \
        sorted(json.loads(j["/healthz"][2]))
    mz = json.loads(t["/memz"][2])
    assert mz["devices"][0]["memory_stats"] is None
    assert mz["peak_mem_bytes"] is None


def test_post_edge_binds_trace_and_deadline_and_profilez_states(tmp_path,
                                                               monkeypatch):
    seen = {}

    def handler(body):
        seen["trace"] = TTG.current()
        seen["deadline"] = TRel.current()
        if body == b"bad":
            raise ValueError("bad request")
        return {"ok": True}

    monkeypatch.setenv("PT_PROFILEZ_DIR", str(tmp_path))
    ctx = TTG.new_trace(sampled=True)
    with TT.DebugServer(port=0) as srv:
        srv.add_post("/submit", handler)
        code, out = _post(srv, "/submit", headers={
            "X-PT-Trace": ctx.to_header(),
            "X-PT-Deadline": TRel.Deadline.after(30).to_header()})
        assert code == 200 and out == {"ok": True}
        assert seen["trace"].trace_id == ctx.trace_id
        assert seen["deadline"].remaining() > 25
        assert _post(srv, "/submit", b"bad")[0] == 400
        assert any(s["name"] == "http.POST /submit"
                   for s in TTG.spans(ctx.trace_id))
        assert _post(srv, "/profilez")[0] == 404
        srv.add_post("/profilez", TP.make_profilez())
        # one capture at a time: a POST while one is in flight is a 409
        assert TP._capture_lock.acquire(blocking=False)
        try:
            assert TP.capture_busy()
            assert _post(srv, "/profilez")[0] == 409
        finally:
            TP._capture_lock.release()
        results = [_post(srv, "/profilez",
                         json.dumps({"duration_ms": 150}).encode())]
        code, rec = results[0]
        assert code == 200 and rec["device"] == "cpu"
        assert rec["duration_ms"] == 150.0
        assert (tmp_path / rec["artifact_id"] / "trace.json").exists()
        status, ctype, tar = _get(srv, f"/profilez/artifact?id="
                                       f"{rec['artifact_id']}")
        assert status == 200 and ctype == "application/x-tar"
        assert _get(srv, "/profilez/artifact?id=..")[0] == 404
    assert not math.isnan(rec["wall_ms"])
