"""The port's tracing surface against the JAX package's on the same
inputs: request trace contexts (``telemetry/tracing.py``: the
``X-PT-Trace`` header both ways, binding, span and event records, the
cross-process merge of one package's collection with the other's), the
span profiler (``telemetry/trace.py`` and its ``core.profiler`` shim:
nesting, the chrome-trace and JSONL files), and the signature tracker
(``telemetry/recompile.py``: the same compile and recompile counts on
one call sequence)."""

import json

import numpy as np
import pytest
import torch

import paddle_tpu.core as JC
from paddle_tpu import telemetry as JT
from paddle_tpu.telemetry import recompile as JR
from paddle_tpu.telemetry import trace as JTR
from paddle_tpu.telemetry import tracing as JTG
import paddle_tpu_torch.core as TC
from paddle_tpu_torch import telemetry as TT
from paddle_tpu_torch.telemetry import recompile as TR
from paddle_tpu_torch.telemetry import trace as TTR
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
    for tr in (JTR, TTR):
        tr.stop_profiler()
        tr.reset()


def test_header_round_trips_between_the_packages():
    assert JTG.TRACE_HEADER == TTG.TRACE_HEADER == "X-PT-Trace"
    for make, read in ((JTG.new_trace, TTG.from_header),
                       (TTG.new_trace, JTG.from_header)):
        for sampled in (True, False):
            ctx = make(sampled=sampled)
            back = read(ctx.to_header())
            assert (back.trace_id, back.span_id, back.sampled) == \
                (ctx.trace_id, ctx.span_id, sampled)
            assert back.to_header() == ctx.to_header()
    for bad in ("", None, "abc", "a--01", "a-b"):
        assert TTG.from_header(bad) is None and JTG.from_header(bad) is None


def _record(G):
    """One request's spans and events: a bound root, a nested span with
    an annotation, an instant event, an unsampled span that records
    nothing."""
    root = G.new_trace(sampled=True)
    with G.bind(root):
        assert G.current() is root
        with G.span("outer", step=1) as sp:
            assert G.current().span_id == sp.context.span_id
            with G.span("inner"):
                G.event("tick", k=2)
            sp.annotate(replica="r0")
        with G.span("skipped", ctx=G.new_trace(sampled=False)):
            pass
    assert G.current() is None
    return root


def _shape(recs):
    """The records up to ids and clocks: names, parents by name, args."""
    by_id = {r["span_id"]: r["name"] for r in recs}
    return sorted((r["name"], by_id.get(r["parent_id"]), r.get("instant",
                                                                False),
                   json.dumps(r["args"], sort_keys=True)) for r in recs)


def test_span_records_match_and_merge_across_packages():
    jroot, troot = _record(JTG), _record(TTG)
    jrecs, trecs = JTG.spans(jroot.trace_id), TTG.spans(troot.trace_id)
    assert sorted(jrecs[0]) == sorted(trecs[0])
    assert _shape(jrecs) == _shape(trecs)
    # either package's merge reads both collections, one lane each
    colls = [JTG.collection(jroot.trace_id, proc="jax"),
             TTG.collection(troot.trace_id, proc="port")]
    # one test process: give the port's collection a pid of its own, as a
    # peer process's would carry
    colls[1]["pid"] += 1
    for sp in colls[1]["spans"]:
        sp["pid"] += 1
    for merge in (JTG.merge_chrome_trace, TTG.merge_chrome_trace):
        ev = merge(colls)["traceEvents"]
        names = sorted(e["name"] for e in ev if e.get("ph") != "M")
        assert names == sorted(2 * ["outer", "inner", "tick"])
        lanes = {e["args"]["name"] for e in ev
                 if e.get("name") == "process_name"}
        assert {"jax", "port"} <= lanes
    # disabled: nothing records
    TT.disable()
    with TTG.span("off", ctx=TTG.new_trace(sampled=True)):
        TTG.event("off")
    assert TTG.total() == len(trecs)


def test_record_event_nesting_and_files_match(tmp_path):
    out = {}
    for name, tr, core in (("jax", JTR, JC), ("port", TTR, TC)):
        assert core.RecordEvent is tr.RecordEvent
        with core.profiler(str(tmp_path / f"{name}.json")):
            with core.RecordEvent("step"):
                with tr.span("fwd", cat="compute"):
                    pass
                with tr.span("bwd"):
                    pass
        events = tr.get_events()
        tr.export_jsonl(events, str(tmp_path / f"{name}.jsonl"))
        chrome = json.load(open(tmp_path / f"{name}.json"))
        lines = [json.loads(x) for x in open(tmp_path / f"{name}.jsonl")]
        out[name] = (
            sorted((e["name"], e["ph"], e.get("cat"),
                    e.get("args", {}).get("depth"),
                    e.get("args", {}).get("parent"))
                   for e in chrome["traceEvents"] if e["ph"] != "M"),
            sorted(chrome), [sorted(x) for x in lines],
            sorted((x["name"], x["depth"], x["parent"]) for x in lines))
    assert out["jax"] == out["port"]
    assert not TTR.tracing()


def test_signature_tracker_counts_alike():
    seq = [np.zeros((4, 8), np.float32), np.zeros((4, 8), np.float32),
           np.zeros((2, 8), np.float32), np.zeros((4, 8), np.int32),
           {"a": np.zeros(3), "b": 1.0}, np.zeros((4, 8), np.float32)]
    snaps = []
    for T, R, conv in ((JT, JR, np.asarray), (TT, TR, torch.from_numpy)):
        for x in seq:
            R.record("site", conv(x) if isinstance(x, np.ndarray) else x)
        R.record("other", weights=R.Opaque(7))
        R.record("other", weights=R.Opaque(8))
        snaps.append((R.tracker().stats(),
                      T.registry().get("pt_jit_recompiles_total",
                                       {"site": "site"}).value,
                      T.registry().get("pt_jit_compiles_total",
                                       {"site": "other"}).value))
    assert snaps[0] == snaps[1]
    assert snaps[1][0]["site"] == {"signatures": 4, "calls": 6,
                                   "recompiles": 3}
