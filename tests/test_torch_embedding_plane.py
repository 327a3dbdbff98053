"""The embedding plane of the port (paddle_tpu_torch/embedding: RowCache,
HostBackedTable, the sparse exchange and sparse_ep_minimize_fn; the
``ep`` axis of the Plan; ``DevicePrefetcher(mesh=, sharding=,
stage_per_shard=)``) against the JAX package's, on the CPU and on 4 gloo
ranks (tests/torch_world.py, the jobs in tests/torch_embedding_jobs.py)
beside a 4-device submesh of the CPU sim. It mirrors
tests/test_embedding_plane.py and the single-host cases of
tests/test_embedding_ckpt.py.

Tolerances and why:
- RowCache: slots, misses, evictions and counters identical (the same
  deterministic clock);
- HostBackedTable on the CPU: rows bit-equal to the host array;
- byte accounting and ``should_compress``: equal integers and verdicts;
- ``sparse_ep_update`` at dp=2 x ep=2 against JAX's: float32 within
  1e-5 (+ 1e-5 relative; Adam's row-wise moments too), int8 within the
  JAX test's 5e-2 with the untouched rows bit-equal, a non-finite
  gradient on one rank poisoning every touched row;
- the ``Plan(dp=2, ep=2)`` step of DeepFM tiny (sparse tables, Adam)
  over 3 steps against the unsharded ``sparse_minimize_fn`` loop of the
  port and JAX's ``sparse_ep_minimize_fn`` under the same plan: the
  losses within 1e-5, the parameters and the tables' Adam moments
  within 1e-5 (the JAX test's bound: the exchange sums the rows in
  another order); the byte counters advanced by the payload x steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNS
from jax.sharding import PartitionSpec as JP_

import paddle_tpu as pt
import torch_embedding_jobs as E
import torch_world as W
from paddle_tpu import embedding as JE
from paddle_tpu import optimizer as JO
from paddle_tpu.models import deepfm as JD
from paddle_tpu.parallel.plan import Plan as JPlan
from paddle_tpu_torch import embedding as TE
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.core import mesh as TM
from paddle_tpu_torch.data.device_loader import DevicePrefetcher
from paddle_tpu_torch.models import deepfm as TD
from paddle_tpu_torch.optimizer.sparse import sparse_minimize_fn
from paddle_tpu_torch.parallel.plan import Plan as TPlan
from paddle_tpu_torch.utils.convert import load_numpy_state

V, D = 64, 8
RNG = np.random.default_rng(31)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


# --- RowCache ----------------------------------------------------------------

@pytest.mark.parametrize("capacity,vocab,calls", [(4, 12, 40), (16, 40, 60),
                                                  (2, 6, 30)])
def test_row_cache_evicts_exactly_as_jax(capacity, vocab, calls):
    """The same id streams (distinct ids a call, at most the capacity)
    through both caches: every call's slots, misses and evictions, then
    the counters and the slot map, identical."""
    rng = np.random.default_rng(capacity)
    jc, tc = JE.RowCache(capacity), TE.RowCache(capacity)
    for _ in range(calls):
        n = int(rng.integers(1, capacity + 1))
        ids = rng.choice(vocab, size=n, replace=False)
        js, jm, je = jc.admit(ids)
        ts, tm, te = tc.admit(ids)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tm, jm)
        assert te == je
    assert tc.stats() == jc.stats()
    probe = np.arange(vocab)
    np.testing.assert_array_equal(tc.slots_of(probe), jc.slots_of(probe))
    assert len(tc) == len(jc) and (3 in tc) == (3 in jc)


def test_row_cache_refusals_match_jax():
    for C in (JE.RowCache, TE.RowCache):
        with pytest.raises(Exception, match="capacity"):
            C(2).admit(np.array([1, 2, 3]))
        with pytest.raises(Exception, match=">= 0"):
            C(2).admit(np.array([-1]))
        with pytest.raises(Exception, match="capacity"):
            C(0)


# --- HostBackedTable on the CPU --------------------------------------------

def _table(**kw):
    return TE.HostBackedTable(V, D, device="cpu", **kw)


def test_host_table_lookup_and_the_capacity_bound():
    t = _table(capacity=16, seed=1)
    j = JE.HostBackedTable(V, D, capacity=16, seed=1)
    np.testing.assert_array_equal(t.rows, j.rows)   # numpy's draws
    ids = np.array([[1, 5], [63, 1]])
    out = t.lookup(ids)
    assert tuple(out.shape) == (2, 2, D)
    np.testing.assert_array_equal(out.numpy(), t.rows[ids])
    big = TE.HostBackedTable(10_000, D, capacity=8, device="cpu")
    assert big.device_bytes == 8 * D * 4
    assert big.host_bytes == 10_000 * D * 4


def test_prefetch_then_lookup_is_all_hits():
    t = _table(capacity=16, seed=2)
    ids = np.array([4, 9, 4, 30])
    assert t.prefetch(ids) == 3
    before = t.cache.stats()["misses"]
    np.testing.assert_array_equal(t.lookup(ids).numpy(), t.rows[ids])
    assert t.cache.stats()["misses"] == before
    j = JE.HostBackedTable(V, D, capacity=16, seed=2)
    j.prefetch(ids)
    j.lookup(ids)
    assert t.hit_rate == j.hit_rate == 0.5      # unique ids are admitted


def test_update_writes_through_across_eviction():
    t = _table(capacity=2, seed=3)
    t.lookup(np.array([1]))
    t.update(np.array([1]), np.full((1, D), 7.0))
    np.testing.assert_array_equal(t.lookup(np.array([1])).numpy(),
                                  np.full((1, D), 7.0, np.float32))
    t.lookup(np.array([10, 20]))
    assert t.cache.slots_of(np.array([1]))[0] == -1
    np.testing.assert_array_equal(t.lookup(np.array([1])).numpy(),
                                  np.full((1, D), 7.0, np.float32))


def test_range_check_and_statusz():
    t = _table(capacity=4, name="ad_ids")
    for bad in (lambda: t.lookup(np.array([V])),
                lambda: t.prefetch(np.array([-1])),
                lambda: t.update(np.array([V]), np.zeros((1, D)))):
        with pytest.raises(Exception, match="out of range"):
            bad()
    t.lookup(np.array([0, 1]))
    j = JE.HostBackedTable(V, D, capacity=4, name="ad_ids")
    j.lookup(np.array([0, 1]))
    assert t.statusz() == j.statusz()
    assert repr(t) == repr(j)


def test_counters_advance_as_jax_with_telemetry_on():
    """The four pt_embedding_* counters advance by the calls' hits,
    misses, evictions and prefetched rows, as the JAX table's do."""
    from paddle_tpu import telemetry as JT
    from paddle_tpu.embedding.host_table import _emb_metrics as j_metrics
    from paddle_tpu_torch import telemetry as TT
    from paddle_tpu_torch.embedding.host_table import _emb_metrics

    def run(table, tel, metrics):
        tel.enable()
        try:
            m = metrics()
            before = {k: c.value for k, c in m.items()}
            table.prefetch(np.array([1, 2, 3]))
            table.lookup(np.array([[2, 3], [4, 5]]))
            table.lookup(np.array([6, 7, 1]))
            return {k: c.value - before[k] for k, c in m.items()}
        finally:
            tel.disable()

    got = run(_table(capacity=4), TT, _emb_metrics)
    want = run(JE.HostBackedTable(V, D, capacity=4), JT, j_metrics)
    assert got == want
    assert got == {"hits": 2, "misses": 8, "evictions": 4,
                   "prefetched_rows": 3}


def test_exchange_rows_stochastic_rounding_in_distribution():
    """exchange_rows(key=) off the wire (axis None) against JAX's: the ids
    as given, every entry within one quantization step of its row, the
    mean over 64 keys within 1.5 steps everywhere and unbiased (signed
    mean error within 0.02 of a step), one draw's spread within 0.7-1.4
    of JAX's; a non-finite row poisons every row."""
    rows = RNG.normal(size=(16, 32)).astype(np.float32)
    uids = np.arange(16)
    step = np.abs(rows).max(axis=1, keepdims=True) / 127
    got, want = [], []
    for k in range(64):
        ti, tr = TE.exchange_rows(torch.from_numpy(uids),
                                  torch.from_numpy(rows), None,
                                  key=np.array([0, k], np.uint32))
        ji, jr = JE.exchange_rows(jnp.asarray(uids), jnp.asarray(rows),
                                  None, key=jax.random.key(k))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        got.append(tr.numpy())
        want.append(np.asarray(jr))
    got, want = np.stack(got), np.stack(want)
    assert (np.abs(got - rows) <= step * (1 + 1e-5)).all()
    assert (np.abs(got.mean(0) - rows) <= 1.5 * step).all()
    assert abs(((got - rows) / step).mean()) < 0.02
    ratio = (got - rows).std() / (want - rows).std()
    assert 0.7 < ratio < 1.4, ratio
    bad = rows.copy()
    bad[3, 4] = np.inf
    _, poisoned = TE.exchange_rows(torch.from_numpy(uids),
                                   torch.from_numpy(bad), None)
    assert torch.isnan(poisoned).all()


def test_device_prefetcher_hook_stages_every_batch():
    t = _table(capacity=16, seed=4)
    batches = [{"ids": np.array([1, 2, 3])}, {"ids": np.array([3, 4, 5])}]
    staged = list(DevicePrefetcher(
        batches, size=2, device="cpu",
        prefetch_rows=lambda b: t.prefetch(b["ids"])))
    assert len(staged) == 2
    before = t.cache.stats()["misses"]
    for b in batches:
        t.lookup(b["ids"])
    assert t.cache.stats()["misses"] == before


def test_save_load_round_trip_is_the_jax_layout(tmp_path):
    """save/load through the port's checkpoint plane; the JAX package's
    HostBackedTable.load reads the port's save and the other way."""
    t = _table(capacity=8, seed=3, name="t")
    t.update(np.array([5]), np.full((1, D), 2.5, np.float32))
    t.save(str(tmp_path / "tbl"))
    t2 = TE.HostBackedTable.load(str(tmp_path / "tbl"), capacity=8,
                                 device="cpu")
    np.testing.assert_array_equal(t2.rows, t.rows)
    np.testing.assert_array_equal(t2.lookup(np.array([5])).numpy(),
                                  np.full((1, D), 2.5, np.float32))
    j = JE.HostBackedTable.load(str(tmp_path / "tbl"), capacity=8)
    np.testing.assert_array_equal(j.rows, t.rows)
    j.save(str(tmp_path / "jtbl"))
    back = TE.HostBackedTable.load(str(tmp_path / "jtbl"), capacity=8,
                                   device="cpu")
    np.testing.assert_array_equal(back.rows, t.rows)


def test_from_array_gathers_a_placed_table(world):
    host = RNG.normal(size=(V, D)).astype(np.float32)
    for rows, got, dev_bytes in world.run(E.job_from_array, host):
        np.testing.assert_array_equal(rows, host)
        np.testing.assert_array_equal(got, host[[0, 63, 17]])
        assert dev_bytes == 4 * D * 4
    whole = TE.HostBackedTable.from_array(torch.from_numpy(host), capacity=4,
                                          device="cpu")
    np.testing.assert_array_equal(whole.rows, host)


# --- DevicePrefetcher onto a mesh ------------------------------------------

@pytest.mark.parametrize("kw", [dict(place="mesh"),
                                dict(place="sharding"),
                                dict(place="sharding", stage_per_shard=True)],
                         ids=["mesh", "sharding", "stage_per_shard"])
def test_prefetcher_stages_the_rank_rows(world, kw):
    batches = [{"ids": np.arange(8 * 3).reshape(8, 3) + 100 * i,
                "dense": RNG.normal(size=(8, 2)).astype(np.float32)}
               for i in range(3)]
    res = world.run(E.job_prefetcher, kw, batches)
    for r in res:
        assert r["per_shard"] is True
        assert r["seen"] == [(8, 3)] * 3      # the whole host batch
        d = r["coordinate"]["dp"]
        for got, want in zip(r["staged"], batches):
            for k in want:
                np.testing.assert_array_equal(got[k],
                                              want[k][4 * d:4 * d + 4])


def test_prefetcher_stage_per_shard_needs_a_sharding():
    with pytest.raises(Exception, match="stage_per_shard needs a sharding"):
        DevicePrefetcher([], device="cpu", stage_per_shard=True)
    assert DevicePrefetcher([], device="cpu").stage_per_shard is False


# --- the ep axis of the Plan (tests/test_embedding_plane.py TestPlanEpAxis) --

def test_plan_table_registration_resolves_row_sharding():
    plan = TPlan(dp=2, ep=4, tables=[r"emb\.weight$"])
    assert plan.mesh.shape == {"dp": 2, "fsdp": 1, "tp": 1, "ep": 4}
    w = np.zeros((V, D), np.float32)
    assert tuple(plan.spec_for("emb.weight", w)) == ("ep", None)
    assert tuple(plan.spec_for("fc.w", w)) == ()


def test_plan_ep1_keeps_the_three_axis_mesh():
    plan = TPlan(dp=2, fsdp=2, tables=[r"emb\.weight$"])
    j = JPlan(dp=2, fsdp=2, tables=[r"emb\.weight$"],
              devices=jax.devices()[:4])
    assert tuple(plan.mesh.axis_names) == ("dp", "fsdp", "tp")
    w = np.zeros((V, D), np.float32)
    assert "ep" not in tuple(plan.spec_for("emb.weight", w))
    assert tuple(plan.spec_for("emb.weight", w)) == tuple(
        j.spec_for("emb.weight", w))


def test_plan_indivisible_vocab_falls_through():
    plan = TPlan(ep=8, tables=[r"emb\.weight$"], min_shard_size=1)
    assert tuple(plan.spec_for("emb.weight",
                               np.zeros((V + 1, D), np.float32))) == ()


def test_plan_batch_sharding_never_splits_over_ep():
    plan = TPlan(dp=2, ep=4, tables=[r"emb\.weight$"])
    j = JPlan(dp=2, ep=4, tables=[r"emb\.weight$"],
              devices=jax.devices()[:8])
    spec = tuple(plan.batch_sharding().spec)
    flat = [a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))]
    assert "ep" not in flat and "dp" in flat
    assert spec == tuple(j.batch_sharding().spec)
    d, jd = plan.describe(), j.describe()
    assert d["axes"]["ep"] == 4 and d["tables"] == 1
    assert {k: d[k] for k in ("axes", "tables", "mode", "devices")} == \
        {k: jd[k] for k in ("axes", "tables", "mode", "devices")}


def test_plan_place_cuts_the_table_rows_and_labels_pjit(world):
    table = RNG.normal(size=(V, D)).astype(np.float32)
    for placed, coord in world.run(E.job_plan_place, table):
        rows, spec = placed["emb.weight"]
        e = coord["ep"]
        np.testing.assert_array_equal(rows, table[32 * e:32 * e + 32])
        assert spec == ("ep", None)
        assert placed["fc.w"][1] is None
    from paddle_tpu_torch.parallel import compile_step

    plan = TPlan(dp=2, ep=4, tables=[r"emb\.weight$"])
    step = compile_step(plan, lambda s: s, in_shardings=({},),
                        out_shardings={})
    assert step.compiled_via == "pjit"


# --- byte accounting ---------------------------------------------------------

@pytest.mark.parametrize("ids,dim,n", [(4096, 64, 8), (4096, 16, 2),
                                       (106496, 1, 2), (8, 8, 2),
                                       (1000, 16, 1)])
def test_payload_bytes_and_should_compress_match_jax(ids, dim, n):
    for comp in (True, False):
        assert TE.exchange_payload_bytes(ids, dim, n, compressed=comp) == \
            JE.exchange_payload_bytes(ids, dim, n, compressed=comp)
    assert TE.dense_grad_bytes(1_000_000, dim, n) == \
        JE.dense_grad_bytes(1_000_000, dim, n)
    assert TE.should_compress(ids, n, dim) == JE.should_compress(ids, n, dim)


def test_sparse_payload_beats_the_dense_gradient_by_orders():
    int8 = TE.exchange_payload_bytes(4096, 64, 8, compressed=True)
    fp32 = TE.exchange_payload_bytes(4096, 64, 8, compressed=False)
    dense = TE.dense_grad_bytes(10_000_000, 64, 8)
    assert int8 < fp32 < dense and dense / int8 > 1000
    assert TE.exchange_payload_bytes(4096, 64, 1, compressed=True) == 0
    assert not TE.should_compress(8, 2, D)
    assert TE.should_compress(4096, 2, 64)


# --- sparse_ep_update --------------------------------------------------------

@pytest.fixture(scope="module")
def jmesh():
    return pt.build_mesh(dp=2, ep=2, devices=jax.devices()[:4])


def _update_case(seed, B=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(V, D)).astype(np.float32),
            rng.integers(0, V, size=(B,)),
            rng.normal(size=(B, D)).astype(np.float32))


def _jax_update(jmesh, opt, table, ids, grads, compress, key=None):
    jo = getattr(JO, opt[0])(*opt[1:])
    t = jnp.asarray(table)
    k = None if key is None else jax.random.wrap_key_data(
        jnp.asarray(key, jnp.uint32))
    new, st = jax.jit(lambda t, i, g: JE.sparse_ep_update(
        jo, t, i, g, jo.init_leaf(t), opt[1], 0, mesh=jmesh,
        compress=compress, key=k))(t, jnp.asarray(ids), jnp.asarray(grads))
    return np.asarray(new), {k: np.asarray(v) for k, v in st.items()
                             if getattr(v, "ndim", 0) and v.shape[0] == V}


def _whole(res, key, sub=None):
    """The ep shards of a per-rank result, in order (dp ranks agree)."""
    out = []
    for e in range(2):
        rs = [r for r in res if r["coordinate"]["ep"] == e]
        vals = [r[key] if sub is None else r[key][sub] for r in rs]
        for v in vals[1:]:
            np.testing.assert_array_equal(v, vals[0])
        out.append(vals[0])
    return np.concatenate(out)


@pytest.mark.parametrize("opt,compress,key", [
    (("SGD", 0.1), False, None), (("SGD", 0.1), True, None),
    (("Adam", 1e-2), False, None), (("SGD", 0.1), True, (0, 7))],
    ids=["sgd-f32", "sgd-int8", "adam-f32", "sgd-int8-sr"])
def test_sparse_ep_update_matches_jax(world, jmesh, opt, compress, key):
    """float32 within 1e-5; int8 within 5e-2 with the untouched rows
    exact; stochastic rounding (the key folded with each rank's ep and dp
    index, the draws JAX's in distribution only) within the same 5e-2."""
    table, ids, grads = _update_case({"SGD": 0, "Adam": 2}[opt[0]]
                                     + int(compress))
    want, want_st = _jax_update(jmesh, opt, table, ids, grads, compress,
                                key)
    res = world.run(E.job_sparse_update, dict(dp=2, ep=2), opt, table, ids,
                    grads, compress, key=key)
    got = _whole(res, "table")
    if compress:
        np.testing.assert_allclose(got, want, atol=5e-2)
        untouched = np.setdiff1d(np.arange(V), ids)
        np.testing.assert_array_equal(got[untouched], table[untouched])
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    for k, v in want_st.items():
        np.testing.assert_allclose(_whole(res, "state", k), v, atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    assert set(res[0]["state"]) == set(want_st)


def test_sparse_ep_update_nonfinite_poisons_every_touched_row(world):
    table, ids, grads = _update_case(3)
    res = world.run(E.job_sparse_update, dict(dp=2, ep=2), ("SGD", 0.1),
                    table, ids, grads, True, inf_dp=1)
    got = _whole(res, "table")
    assert not np.isfinite(got[ids]).any()
    untouched = np.setdiff1d(np.arange(V), ids)
    np.testing.assert_array_equal(got[untouched], table[untouched])


def test_sparse_ep_update_indivisible_vocab_raises_as_jax(jmesh):
    bad = np.zeros((V + 1, D), np.float32)
    jo, to = JO.SGD(0.1), TO.SGD(0.1)
    with pytest.raises(Exception, match="vocab"):
        JE.sparse_ep_update(jo, jnp.asarray(bad), jnp.zeros((8,), jnp.int32),
                            jnp.zeros((8, D)), jo.init_leaf(bad), 0.1, 0,
                            mesh=jmesh)
    mesh = TM.build_mesh(dp=2, ep=2, devices=range(4), device="cpu")
    tb = torch.from_numpy(bad)
    with pytest.raises(Exception, match="vocab"):
        TE.sparse_ep_update(to, tb, torch.zeros(8, dtype=torch.long),
                            torch.zeros(8, D), to.init_leaf(tb), 0.1, 0,
                            mesh=mesh)


# --- the full Plan(dp=2, ep=2) step ------------------------------------------

def _sparse_cfg():
    cfg = JD.DeepFMConfig.tiny()
    cfg.embedding_axis, cfg.sparse_grads = None, True
    return cfg


def _batches(cfg, n, B=16):
    rng = np.random.default_rng(12)
    return [(rng.integers(0, cfg.total_vocab, (B, cfg.num_fields)),
             rng.normal(size=(B, cfg.dense_dim)).astype(np.float32))
            for _ in range(n)]


def _jax_ep_loop(jm, plan, batches, lr):
    """JAX's sparse_ep_minimize_fn under ``plan`` through compile_step (as
    tests/test_embedding_plane.py runs it)."""
    from paddle_tpu.parallel import compile_step

    def fl(p, ids, dense):
        logits, _ = jm.functional_call(p, ids, dense)
        return JD.loss_fn(logits, (ids[:, 0] % 2).astype(jnp.float32))

    init_fn, step_fn = JE.sparse_ep_minimize_fn(jm, fl, JO.Adam(lr),
                                                plan=plan, compress=False)
    params = plan.place(jm.named_parameters())
    state = init_fn(params)
    vocab = jm.cfg.total_vocab
    rep = JNS(plan.mesh, JP_())
    s_sh = jax.tree_util.tree_map(
        lambda x: (JNS(plan.mesh, JP_("ep", None))
                   if getattr(x, "ndim", 0) >= 1 and x.shape[0] == vocab
                   else rep), state)
    state = jax.tree_util.tree_map(jax.device_put, state, s_sh)
    p_sh = jax.tree_util.tree_map(lambda x: x.sharding, params)
    bs = plan.batch_sharding()
    step = compile_step(plan, step_fn, in_shardings=(p_sh, s_sh, bs, bs),
                        out_shardings=(rep, p_sh, s_sh))
    losses = []
    for ids, dense in batches:
        loss, params, state = step(params, state, jnp.asarray(ids),
                                   jnp.asarray(dense))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in params.items()}, state


def test_plan_sparse_step_matches_the_unsharded_loop_and_jax(world):
    """3 steps of DeepFM tiny (sparse tables, Adam(1e-2)) under
    Plan(dp=2, ep=2, tables=...) through sparse_ep_minimize_fn
    (float32 wire) against the port's unsharded sparse_minimize_fn loop
    and JAX's sparse_ep_minimize_fn under the same plan."""
    cfg = _sparse_cfg()
    pt.seed(4)
    jm = JD.DeepFM(cfg)
    state = {k: np.asarray(v) for k, v in jm.named_parameters().items()}
    batches = _batches(cfg, 3)
    plan = JPlan(dp=2, ep=2, tables=[E.TABLES], devices=jax.devices()[:4])
    j_losses, j_params, j_state = _jax_ep_loop(jm, plan, batches, 1e-2)

    tm = TD.DeepFM(TD.DeepFMConfig(**_cfg_kw(cfg)), device="cpu")
    load_numpy_state(tm, state)

    def fl(p, ids, dense):
        logits, _ = tm.functional_call(p, ids, dense)
        return TD.loss_fn(logits, (ids[:, 0] % 2).float())

    init_fn, step_fn = sparse_minimize_fn(tm, fl, TO.Adam(1e-2))
    params = dict(tm.named_parameters())
    st = init_fn(params)
    u_losses = []
    for ids, dense in batches:
        loss, params, st = step_fn(params, st, torch.from_numpy(ids),
                                   torch.from_numpy(dense))
        u_losses.append(float(loss))

    res = world.run(E.job_sparse_plan, _cfg_kw(cfg), state, batches, 1e-2,
                    False)
    for r in res:
        np.testing.assert_allclose(r["losses"], u_losses, atol=1e-5)
        np.testing.assert_allclose(r["losses"], j_losses, atol=1e-5)
    got = res[0]["params"]
    for k, v in params.items():
        np.testing.assert_allclose(got[k], v.detach().numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[k], j_params[k], atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    for name, u_st in st["sparse"].items():
        for k in ("moment1", "moment2"):
            if k not in u_st:
                continue
            mine = np.concatenate([next(
                r["moments"][name][k] for r in res
                if r["coordinate"]["ep"] == e) for e in range(2)])
            np.testing.assert_allclose(mine, u_st[k].numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=f"{name}/{k}")
            np.testing.assert_allclose(
                mine, np.asarray(j_state["sparse"][name][k]), atol=1e-5,
                rtol=1e-5, err_msg=f"{name}/{k}")
    # every step recorded each table's float32 payload over dp=2
    n_ids = 8 * cfg.num_fields
    per_step = sum(TE.exchange_payload_bytes(n_ids, dim, 2,
                                             compressed=False)
                   for dim in (cfg.embed_dim, 1))
    for r in res:
        assert r["recorded"] == (0, 3 * per_step)


def _cfg_kw(cfg):
    return dict(total_vocab=cfg.total_vocab, num_fields=cfg.num_fields,
                dense_dim=cfg.dense_dim, embed_dim=cfg.embed_dim,
                mlp_dims=tuple(cfg.mlp_dims), embedding_axis=None,
                sparse_grads=True)
