"""The sharded embedding tables of the port
(paddle_tpu_torch/parallel/sharded_embedding.py and DeepFM's
``embedding_axis="ep"``) against the JAX package's, on 4 gloo ranks
(tests/torch_world.py, the jobs in tests/torch_embedding_jobs.py) and a
4-device submesh of the CPU sim; it mirrors
tests/test_sharded_embedding.py.

Tolerances and why:
- the lookup: bit for bit against JAX's and a dense gather (a sum of one
  row and exact zeros);
- the table gradient of sum(sin(lookup) * cot): within 1e-6 of JAX's and
  of the dense gather's scatter-add (the same rows summed in another
  order). An ``ep``-times gradient (a psum-to-psum backward) would be off
  by 1x-3x;
- DeepFM under ``Plan(dp=2, ep=2)``, 2 Adam(1e-2) steps against the JAX
  Trainer under the same plan on the same weights and batch: the losses
  within 1e-5 relative, the parameters within 1e-5 of each leaf's
  largest entry, step 1's table gradients (the mean of the dp ranks'
  local ones, as the port's Trainer reduces them) within 1e-5 of each
  table's largest JAX-gradient entry;
- the default ``DeepFM()`` (tables over "ep") on one rank: the logits
  within 1e-5 of JAX's and equal to the ``embedding_axis=None`` model's
  on the same weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import torch_embedding_jobs as E
import torch_world as W
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JP
from paddle_tpu.core.enforce import InvalidArgumentError as JErr
from paddle_tpu.models import deepfm as JD
from paddle_tpu.parallel import sharded_embedding as JSE
from paddle_tpu.parallel.plan import Plan as JPlan
from paddle_tpu_torch.core import InvalidArgumentError
from paddle_tpu_torch.core import mesh as TM
from paddle_tpu_torch.models import deepfm as TD
from paddle_tpu_torch.parallel import sharded_embedding as TSE
from paddle_tpu_torch.utils.convert import load_numpy_state

V, D = 64, 8
RNG = np.random.default_rng(5)
SIZES = {"ep4": dict(ep=4), "dp2ep2": dict(dp=2, ep=2)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


def _jmesh(sizes):
    return pt.build_mesh(dp=sizes.get("dp", 1), ep=sizes["ep"],
                         devices=jax.devices()[:4])


def _whole_grad(res, sizes):
    """The dp ranks' shard gradients summed, the ep shards in order."""
    ep = sizes["ep"]
    shards = [sum(r["grad"] for r in res if r["coordinate"]["ep"] == e)
              for e in range(ep)]
    return np.concatenate(shards)


@pytest.mark.parametrize("name", ["ep4", "dp2ep2"])
def test_lookup_and_its_gradient_match_jax_and_a_dense_gather(world, name):
    sizes = SIZES[name]
    table = RNG.normal(size=(V, D)).astype(np.float32)
    ids = RNG.integers(0, V, size=(8, 5))
    cot = RNG.normal(size=(8, 5, D)).astype(np.float32)
    jmesh = _jmesh(sizes)

    def f(t):
        out = JSE.sharded_embedding_lookup(jnp.asarray(ids), t, mesh=jmesh)
        return jnp.sum(out * cot), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(table))
    dense = table[ids]
    want_grad = np.zeros_like(table)
    np.add.at(want_grad, ids.reshape(-1), cot.reshape(-1, D))
    res = world.run(E.job_lookup, sizes, table, ids, cot)
    dp = sizes.get("dp", 1)
    got = np.concatenate([next(r["out"] for r in res
                               if r["coordinate"]["dp"] == d)
                          for d in range(dp)])
    np.testing.assert_array_equal(got, np.asarray(jout))
    np.testing.assert_array_equal(got, dense)
    grad = _whole_grad(res, sizes)
    np.testing.assert_allclose(grad, np.asarray(jgrad), atol=1e-6, rtol=0)
    np.testing.assert_allclose(grad, want_grad, atol=1e-6, rtol=0)


def test_padding_idx_rows_are_exact_zeros(world):
    table = np.ones((V, D), np.float32)
    ids = np.array([[0, 3], [3, 0], [5, 0], [0, 9]])
    res = world.run(E.job_lookup, SIZES["dp2ep2"], table, ids,
                    np.ones((4, 2, D), np.float32), padding_idx=0)
    jout = JSE.sharded_embedding_lookup(jnp.asarray(ids), jnp.asarray(table),
                                        mesh=_jmesh(SIZES["dp2ep2"]),
                                        padding_idx=0)
    got = np.concatenate([res[0]["out"], next(
        r["out"] for r in res if r["coordinate"]["dp"] == 1)])
    np.testing.assert_array_equal(got, np.asarray(jout))
    assert (got[ids == 0] == 0).all() and (got[ids != 0] == 1).all()
    # the pad rows take no gradient: only ids 3, 5 and 9 do
    grad = _whole_grad(res, SIZES["dp2ep2"])
    assert set(np.flatnonzero(grad.any(axis=1))) == {3, 5, 9}


def _layout_mesh(ep):
    """A layout-only ep mesh in this process (no process group): the
    checks that raise before any collective run on it."""
    return TM.build_mesh(ep=ep, devices=range(ep), device="cpu")


@pytest.mark.parametrize("case", ["over", "negative", "pad-exempt",
                                  "pad-not-exempt", "indivisible",
                                  "no-axis"])
def test_lookup_checks_raise_as_jax(case):
    """The out-of-vocab raise (typed, "out-of-vocab"), the exempt
    out-of-range pad, the indivisible vocab and the mesh without the
    axis: each raises (or not) where JAX's does."""
    table = np.ones((V, D), np.float32)
    ids, kw = {"over": ([1, V], {}), "negative": ([-1, 2], {}),
               "pad-exempt": ([[5, -1], [-1, 7]], {"padding_idx": -1}),
               "pad-not-exempt": ([5, V], {"padding_idx": -1}),
               "indivisible": ([0, 1, 2, 3], {}),
               "no-axis": ([0, 1], {})}[case]
    if case == "indivisible":
        table = np.zeros((30, D), np.float32)
    jmesh, tmesh = _jmesh(dict(ep=4)), _layout_mesh(4)
    if case == "no-axis":
        from jax.sharding import Mesh

        jmesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
        tmesh = TM.Mesh(np.arange(4), ("dp",), device="cpu")
    args = (np.asarray(ids), table)
    if case == "pad-exempt":
        want = JSE.sharded_embedding_lookup(*map(jnp.asarray, args),
                                            mesh=jmesh, **kw)
        got = TSE.sharded_embedding_lookup(
            *map(torch.from_numpy, args), mesh=tmesh, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got.numpy()[np.asarray(ids) == -1] == 0).all()
        return
    match = {"indivisible": "vocab", "no-axis": "axis"}.get(
        case, "out-of-vocab")
    with pytest.raises(Exception, match=match) as jerr:
        JSE.sharded_embedding_lookup(*map(jnp.asarray, args), mesh=jmesh,
                                     **kw)
    with pytest.raises(Exception, match=match) as terr:
        TSE.sharded_embedding_lookup(*map(torch.from_numpy, args),
                                     mesh=tmesh, **kw)
    if match == "out-of-vocab":
        assert isinstance(jerr.value, JErr)
        assert isinstance(terr.value, InvalidArgumentError)
        assert str(terr.value) == str(jerr.value)


def test_layer_places_its_rows_and_matches_its_gather(world):
    ids = RNG.integers(0, V, size=(8,))
    res = world.run(E.job_layer, dict(dp=2, ep=2), 7, ids)
    whole = res[0]["whole"]
    for r in res:
        np.testing.assert_array_equal(r["whole"], whole)
        assert r["local"] == (V // 2, D) and r["spec"] == ("ep", None)
    got = np.concatenate([res[0]["out"], res[3]["out"]])
    np.testing.assert_array_equal(got, whole[ids])
    # JAX's layer on the same weight gives the same rows
    pt.seed(7)
    jemb = JSE.ShardedEmbedding(V, D, mesh=_jmesh(dict(dp=2, ep=2)))
    jemb.set_parameters({"weight": jnp.asarray(whole)})
    np.testing.assert_array_equal(np.asarray(jemb(jnp.asarray(ids))),
                                  whole[ids])
    assert tuple(jemb.weight_sharding().spec) == res[0]["spec"]


def test_embedding_ep_rules_match_jax():
    pt.seed(0)
    ptt.seed(0)
    jm = JD.DeepFM(JD.DeepFMConfig.tiny())
    tm = TD.DeepFM(TD.DeepFMConfig.tiny(), device="cpu")
    want = [(pat, tuple(spec)) for pat, spec in JSE.embedding_ep_rules(jm)]
    got = [(pat, tuple(spec)) for pat, spec in TSE.embedding_ep_rules(tm)]
    assert got == want and len(got) == 2
    assert isinstance(tm.embedding, TSE.ShardedEmbedding)
    assert tm.embedding.is_sparse is False


def _tiny_state(seed):
    pt.seed(seed)
    jm = JD.DeepFM(JD.DeepFMConfig.tiny())
    return jm, {k: np.asarray(v) for k, v in jm.named_parameters().items()}


def test_deepfm_over_ep_trains_as_the_jax_trainer_under_the_plan(world):
    """DeepFM tiny (tables over "ep", dense gradients) 2 Adam(1e-2) steps
    under Plan(dp=2, ep=2, tables=...) on 4 ranks against the JAX
    Trainer under the same plan: losses, parameters and step 1's table
    gradients (where an ep-times gradient would show)."""
    jm, state = _tiny_state(3)
    cfg = JD.DeepFMConfig.tiny()
    rng = np.random.default_rng(8)
    ids = rng.integers(0, cfg.total_vocab, (16, cfg.num_fields))
    dense = rng.normal(size=(16, cfg.dense_dim)).astype(np.float32)
    plan = JPlan(dp=2, ep=2, tables=[E.TABLES], devices=jax.devices()[:4])

    def lossf(params, buffers, batch):
        logits, nb = jm.functional_call(params, batch["ids"], batch["dense"],
                                        buffers=buffers)
        labels = (batch["ids"][:, 0] % 2).astype(jnp.float32)
        return JD.loss_fn(logits, labels), nb

    def jbuild(params, buffers, rng_, bt):
        loss, nb = lossf(params, buffers, bt)
        return loss, ({}, nb)

    batch = {"ids": jnp.asarray(ids), "dense": jnp.asarray(dense)}
    with pt.core.mesh.mesh_scope(plan.mesh):
        jgrad = jax.grad(lambda p: lossf(p, {}, batch)[0])(
            jm.named_parameters())
        jt = JP.Trainer(jm, JO.Adam(1e-2), jbuild, plan=plan)
        want = []
        for _ in range(2):
            loss, _ = jt.train_step(batch)
            want.append((float(loss), {k: np.asarray(v) for k, v in
                                       jt.params.items()}))
    cfg_kw = dict(total_vocab=cfg.total_vocab, num_fields=cfg.num_fields,
                  dense_dim=cfg.dense_dim, embed_dim=cfg.embed_dim,
                  mlp_dims=tuple(cfg.mlp_dims))
    res = world.run(E.job_deepfm_plan, cfg_kw, state, ids, dense, 2, 1e-2)
    assert res[0]["via"] == "pjit"
    assert res[0]["local"] == (cfg.total_vocab // 2, cfg.embed_dim)
    for step, (j_loss, j_params) in enumerate(want):
        for r in res:
            np.testing.assert_allclose(r["steps"][step][0], j_loss,
                                       rtol=1e-5)
        got = res[0]["steps"][step][1]
        for k, v in j_params.items():
            scale = max(float(np.abs(v).max()), 1e-30)
            np.testing.assert_allclose(got[k], v, atol=1e-5 * scale,
                                       rtol=0, err_msg=k)
    for name in res[0]["grads"]:
        shards = [sum(r["grads"][name] for r in res
                      if r["coordinate"]["ep"] == e) / 2 for e in range(2)]
        want_g = np.asarray(jgrad[name])
        scale = float(np.abs(want_g).max())
        np.testing.assert_allclose(np.concatenate(shards), want_g,
                                   atol=1e-5 * scale, rtol=0, err_msg=name)


def test_default_deepfm_runs_on_one_rank_as_jax():
    """``DeepFM()`` (the default config: tables over "ep") on the
    one-rank mesh: the logits JAX's default model gives on the same
    weights, and those of the ``embedding_axis=None`` model."""
    pt.seed(1)
    jm = JD.DeepFM()
    state = {k: np.asarray(v) for k, v in jm.named_parameters().items()}
    tm = TD.DeepFM(device="cpu")
    load_numpy_state(tm, state)
    plain_cfg = TD.DeepFMConfig(embedding_axis=None)
    plain = TD.DeepFM(plain_cfg, device="cpu")
    load_numpy_state(plain, state)
    cfg = jm.cfg
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg.total_vocab, (8, cfg.num_fields))
    dense = rng.normal(size=(8, cfg.dense_dim)).astype(np.float32)
    with pt.core.mesh.mesh_scope(pt.build_mesh(devices=jax.devices()[:1])):
        want, _ = jax.jit(lambda p: jm.functional_call(
            p, jnp.asarray(ids), jnp.asarray(dense)))(jm.named_parameters())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(dense))
        base = plain(torch.from_numpy(ids), torch.from_numpy(dense))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(got.numpy(), base.numpy())
