"""The serving arena's telemetry hooks (paddle_tpu_torch/serving.py)
against the JAX package's on a 2-layer GPT (``GPTConfig.tiny()``, the
same weights), paged (page_size 64), slots 2:

- with telemetry on, the same requests give the JAX arena's counter
  values: requests, completions, tokens, the TTFT and decode-latency
  observation counts, the rejection causes, the signature counts per
  site, the serving goodput; the tokens equal a telemetry-off run's;
- a request submitted under an expired ``Deadline`` is dropped in both
  packages: no tokens, ``deadline_exceeded``, counted under
  ``cause="deadline"``;
- a ``KVHandoff`` exported under a bound trace context and deadline, by
  either package, is read by the other with both on it;
- ``run(debug_port=0, flight_recorder=..., preemption=...)``: a scrape
  of the live server during the run, one recorder entry per tick, a
  grace signal that drains the requests in flight and leaves the queue
  (the server's thread joined after)."""

import json
import threading
import urllib.request

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import telemetry as JT
from paddle_tpu.models import gpt as JG
from paddle_tpu.resilience import reliability as JR
from paddle_tpu.serving import BatchedDecoder as JaxDecoder
from paddle_tpu.serving import KVHandoff as JaxHandoff
from paddle_tpu.telemetry import tracing as JTG
from paddle_tpu_torch import telemetry as TT
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.resilience import PreemptionHandler
from paddle_tpu_torch.resilience import reliability as TR
from paddle_tpu_torch.serving import BatchedDecoder, KVHandoff
from paddle_tpu_torch.telemetry import tracing as TTG
from paddle_tpu_torch.utils.convert import load_numpy_state

PAGED = dict(pages=8, page_size=64)
LENS, MAX_NEW = (5, 40, 12), (4, 3, 5)


@pytest.fixture(scope="module")
def models():
    pt.seed(61)
    jm = JG.GPTForCausalLM(JG.GPTConfig.tiny()).eval()
    tm = TG.GPTForCausalLM(TG.GPTConfig.tiny(), device="cpu").eval()
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in LENS]
    return jm, tm, prompts


@pytest.fixture(autouse=True)
def clean():
    for t in (JT, TT):
        t.reset()
    yield
    for t in (JT, TT):
        t.reset()
        t.disable()


COUNTERS = ("pt_serving_requests_total", "pt_serving_completed_total",
            "pt_serving_tokens_total")


def _view(T):
    reg = T.registry()
    out = {n: reg.get(n).value for n in COUNTERS}
    for n in ("pt_serving_ttft_seconds",
              "pt_serving_decode_latency_seconds"):
        out[n] = reg.get(n).count
    for cause in ("pool_exhausted", "capacity", "shed", "deadline"):
        out[cause] = reg.get("pt_serving_admission_rejections_total",
                             {"cause": cause}).value
    for site in ("serving.step", "serving.prefill"):
        out[site] = reg.get("pt_jit_compiles_total", {"site": site}).value
    return out


def _run(dec, prompts, expired=None):
    rids = [dec.submit(p, n) for p, n in zip(prompts, MAX_NEW)]
    if expired is not None:
        with expired[0].bind(expired[0].Deadline(0.0)):
            rids.append(dec.submit(prompts[0], 2))
    return dec, rids, dec.run()


def test_counters_and_deadline_drop_match_jax(models):
    jm, tm, prompts = models
    off = _run(BatchedDecoder(tm, slots=2, capacity=128, device="cpu",
                              **PAGED), prompts)[2]
    for T in (JT, TT):
        T.enable()
    jdec, jrids, jout = _run(JaxDecoder(jm, slots=2, capacity=128,
                                        **PAGED), prompts, (JR,))
    tdec, trids, tout = _run(BatchedDecoder(tm, slots=2, capacity=128,
                                            device="cpu", **PAGED),
                             prompts, (TR,))
    for r in trids[:3]:
        np.testing.assert_array_equal(tout[r], off[r])
        assert len(tout[r]) == len(jout[r])
    # the expired request: dropped typed in both, never computed
    assert jout[jrids[3]] is None and tout[trids[3]] is None
    jv, tv = _view(JT), _view(TT)
    assert jv == tv
    assert tv["deadline"] == 1 and tv["pt_serving_requests_total"] == 4
    assert tv["pt_serving_ttft_seconds"] == 3
    assert tv["pt_serving_tokens_total"] == sum(MAX_NEW)
    assert tdec.tick_count == jdec.tick_count
    assert tv["pt_serving_decode_latency_seconds"] == tdec.tick_count
    assert TT.profiling.goodput().snapshot() == \
        {**JT.profiling.goodput().snapshot()}
    assert set(TT.costs.ledger()) == {"serving.step[k=1]",
                                      "serving.prefill[paged,16]",
                                      "serving.prefill[paged,48]"}


def test_handoff_with_trace_and_deadline_crosses_both_ways(models):
    jm, tm, prompts = models
    for T in (JT, TT):
        T.enable()
    jctx, tctx = JTG.new_trace(sampled=True), TTG.new_trace(sampled=True)
    jdl, tdl = JR.Deadline.after(120), TR.Deadline.after(120)
    with JTG.bind(jctx), JR.bind(jdl):
        jh = JaxDecoder(jm, slots=2, capacity=128,
                        **PAGED).prefill_export(prompts[1])
    tdec = BatchedDecoder(tm, slots=2, capacity=128, device="cpu", **PAGED)
    with TTG.bind(tctx), TR.bind(tdl):
        th = tdec.prefill_export(prompts[1])
    assert th.trace.trace_id == tctx.trace_id and th.deadline is tdl
    got = KVHandoff.from_bytes(jh.to_bytes())
    assert got.trace.to_header() == jctx.to_header()
    assert got.deadline.t_end == jdl.t_end
    back = JaxHandoff.from_bytes(th.to_bytes())
    assert back.trace.trace_id == tctx.trace_id
    assert back.deadline.to_header() == tdl.to_header()
    # the decode side adopts the handoff's trace: its spans land on it
    rid = tdec.inject_prefilled(got, 2)
    assert len(tdec.run()[rid]) == 2
    names = {s["name"] for s in TTG.spans(jctx.trace_id)}
    assert {"serve.handoff.import", "serve.first_token",
            "serve.done"} <= names
    assert "serve.prefill.export" in {s["name"] for s in
                                      TTG.spans(tctx.trace_id)}
    # an expired handoff deadline is dropped at admission
    dead = KVHandoff.from_bytes(th.to_bytes())
    dead.deadline = TR.Deadline(0.0)
    rid = tdec.inject_prefilled(dead, 2)
    assert tdec.run()[rid] is None


def test_run_hooks_serve_record_and_drain(models, tmp_path):
    _, tm, prompts = models
    dec = BatchedDecoder(tm, slots=1, capacity=128, device="cpu", **PAGED)
    rec = TT.FlightRecorder(str(tmp_path), warmup_steps=1000)
    handler = PreemptionHandler()
    seen = {}

    def on_tick():
        srv = dec.debug_server
        if "statusz" not in seen and srv is not None and srv.running:
            with urllib.request.urlopen(srv.url("/statusz"),
                                        timeout=10) as r:
                seen["statusz"] = json.loads(r.read())
            with urllib.request.urlopen(srv.url("/readyz"),
                                        timeout=10) as r:
                seen["readyz"] = r.status
            handler.request()              # drain from here on

    step = dec._step

    def step_and_scrape():
        step()
        on_tick()

    dec._step = step_and_scrape
    rids = [dec.submit(p, n) for p, n in zip(prompts, MAX_NEW)]
    out = dec.run(debug_port=0, flight_recorder=rec, preemption=handler)
    assert TT.enabled()                    # the debug port enabled it
    assert dec.preempted and not dec.debug_server.running
    assert not handler.installed           # run() uninstalled its own
    assert list(out) == [rids[0]] and len(out[rids[0]]) == MAX_NEW[0]
    assert [r.rid for r in dec.queue] == rids[1:]
    st = seen["statusz"]
    assert st["status"]["serving"]["slots"] == 1
    assert st["devices"][0]["platform"] == "cpu"
    assert seen["readyz"] == 200
    # one entry per loop iteration (each runs at most one decode tick)
    assert len(rec.ring) >= dec.tick_count > 0 and not rec.anomalies
    assert TT.registry().get("pt_preempt_clean_exits_total").value == 1
    assert not [t for t in threading.enumerate()
                if t.name == "pt-debug-server"]


def test_itl_sentinel_reads_the_tick_not_its_occupancy(models, monkeypatch):
    """The ITL sentinel's sample is a slot's inter-token latency, the
    tick's wall over the tokens each slot gets: ticks of one wall that
    emit 2, then 1 token (the arena draining) feed one baseline and trip
    nothing, while the decode-latency histogram keeps the JAX package's
    per-token reading. A tick twice as slow still trips PT-PERF-802."""
    import paddle_tpu_torch.serving as S
    from paddle_tpu_torch.telemetry import profiling as TP

    _, tm, _ = models
    TT.enable()
    dec = BatchedDecoder(tm, slots=2, capacity=128, device="cpu", **PAGED)
    clock = [0.0]
    monkeypatch.setattr(S.time, "perf_counter", lambda: clock[0])
    wall = 0.01
    for n_emitted in (2, 2, 2, 1, 1, 1):
        clock[0] += wall
        dec._note_tick("serving.step[k=1]", n_emitted, 1, 2,
                       clock[0] - wall, None)
    sen = TP.sentinel()
    assert sen.diagnostics() == []
    assert sen.baselines()["serving.step[k=1]|cpu"]["ewma"] == \
        pytest.approx(wall)
    hist = TT.registry().get("pt_serving_decode_latency_seconds")
    assert hist.count == 6 and hist.sum == pytest.approx(
        3 * wall / 2 + 3 * wall)
    clock[0] += 2 * wall
    dec._note_tick("serving.step[k=1]", 2, 1, 2, clock[0] - 2 * wall, None)
    assert [d.code for d in sen.diagnostics()] == ["PT-PERF-802"]
