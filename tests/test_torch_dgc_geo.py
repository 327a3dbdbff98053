"""DGC and geo-SGD in the port (paddle_tpu_torch/parallel/dgc.py and
geo_sgd.py) against the JAX package's, on the CPU and on 4 gloo ranks
(tests/torch_world.py, the jobs in tests/torch_dgc_jobs.py) beside a
4-device submesh of the CPU sim. It mirrors tests/test_dgc.py and
tests/test_geo_sgd.py.

Tolerances and why:
- ``top_k_sparsify``: bit for bit (a selection; ties all kept);
- ``DGCMomentum``: 6 steps across ``rampup_begin_step`` on the same
  parameters and gradients within 1e-6 (the same float32 arithmetic,
  one selection a step);
- ``quantized_allreduce`` against JAX's jitted one under ``shard_map``:
  within one float32 ulp of the largest output (1.2e-7 of it), where
  XLA may order the four-chunk sum or the scale's quotient otherwise,
  and against the exact sum within the JAX test's 2.5 max|x| n / 127
  with correlation above 0.999; ``dgc_allreduce`` likewise, its exact
  (non-quantized and indivisible) leaves within 1e-6;
- ``GeoSGDTrainer`` (MnistMLP(16, 8) with Momentum, and the BatchNorm
  net of tests/torch_world.py with SGD) against JAX's on the same
  weights and batch: the losses, each replica and the flushed
  parameters, buffers and optimizer state within 1e-5 (the gradients
  of two packages in float32), the divergence pattern of
  tests/test_geo_sgd.py exactly (at K=3: diverged, diverged, synced,
  ... with synced below 1e-6), and a corrupted second row of each rank
  changing the loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP_

import paddle_tpu as pt
import torch_dgc_jobs as G
import torch_world as W
from paddle_tpu import nn as JNN
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JPAR
from paddle_tpu.models import mnist as JM
from paddle_tpu.parallel import dgc as JD
from paddle_tpu.parallel.geo_sgd import GeoSGDTrainer as JGeo
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.parallel import dgc as TD

RNG = np.random.default_rng(41)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


# --- top_k_sparsify and DGCMomentum (one process) -----------------------------

@pytest.mark.parametrize("case", ["normal", "ties", "tiny", "all-equal",
                                  "matrix"])
@pytest.mark.parametrize("sparsity", [0.9, 0.5, 0.999])
def test_top_k_sparsify_matches_jax(case, sparsity):
    g = {"normal": RNG.normal(size=(100,)),
         "ties": RNG.integers(-3, 4, size=(50,)),
         "tiny": RNG.normal(size=(5,)),
         "all-equal": np.full((12,), -2.0),
         "matrix": RNG.normal(size=(16, 24))}[case].astype(np.float32)
    jk, jr = JD.top_k_sparsify(jnp.asarray(g), sparsity)
    tk, tr = TD.top_k_sparsify(torch.from_numpy(g), sparsity)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert int((tk != 0).sum()) >= 1
    np.testing.assert_array_equal((tk + tr).numpy(), g)


@pytest.mark.parametrize("kw", [dict(momentum=0.9, rampup_begin_step=3),
                                dict(momentum=0.0, rampup_begin_step=0),
                                dict(momentum=0.9, use_nesterov=True,
                                     rampup_begin_step=2)],
                         ids=["rampup3", "plain", "nesterov"])
def test_dgc_momentum_trajectory_matches_jax(kw):
    shapes = {"w": (64,), "b": (8, 16)}
    params = {k: RNG.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: RNG.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(6)]
    jo = JD.DGCMomentum(0.1, sparsity=0.75, **kw)
    to = TD.DGCMomentum(0.1, sparsity=0.75, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for step, g in enumerate(grads):
        jp, js = jo.apply(jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        to.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=0,
                                       err_msg=f"step {step} {k}")
        for jl, tl in zip(js["leaf"], ts["leaf"]):
            for name in ("u", "v"):
                np.testing.assert_allclose(tl[name].numpy(),
                                           np.asarray(jl[name]), atol=1e-6,
                                           rtol=0)
    assert ts["step"] == 6


def test_dgc_dense_warmup_and_error_feedback():
    """tests/test_dgc.py's two contracts: before rampup every entry is
    applied at once with no residual; after it, small entries still move
    once their accumulated residual crosses the threshold."""
    opt = TD.DGCMomentum(0.1, momentum=0.0, sparsity=0.75,
                         rampup_begin_step=5)
    p = {"w": torch.zeros(4)}
    st = opt.init(p)
    g = {"w": torch.tensor([1.0, 0.5, 0.1, 0.05])}
    opt.apply(p, g, st)
    np.testing.assert_allclose(p["w"].numpy(), -0.1 * g["w"].numpy(),
                               rtol=1e-6)
    assert float(st["leaf"][0]["v"].abs().max()) == 0.0
    opt = TD.DGCMomentum(0.1, momentum=0.0, sparsity=0.5)
    p = {"w": torch.zeros(4)}
    st = opt.init(p)
    g = {"w": torch.tensor([1.0, 0.3, 0.2, 0.15])}
    for _ in range(8):
        opt.apply(p, g, st)
    assert (p["w"] < 0).all()


# --- the quantized all-reduce on 4 ranks --------------------------------------

def _jmesh4():
    return Mesh(np.asarray(jax.devices()[:4]), ("dp",))


def _jax_qar(x_rows):
    f = jax.jit(jax.shard_map(
        lambda xs: JD.quantized_allreduce(xs[0], "dp")[None],
        mesh=_jmesh4(), in_specs=JP_("dp"), out_specs=JP_("dp")))
    return np.asarray(f(jnp.asarray(x_rows)))


@pytest.mark.parametrize("shape", [(4, 128), (4, 8, 16), (4, 4)])
def test_quantized_allreduce_matches_jax_and_the_exact_sum(world, shape):
    x = RNG.normal(size=shape).astype(np.float32)
    want = _jax_qar(x)
    res = world.run(G.job_quantized_allreduce, x)
    exact = x.sum(axis=0)
    for r, got in enumerate(res):
        np.testing.assert_array_equal(got, res[0])
        np.testing.assert_allclose(got, want[r], rtol=0,
                                   atol=1.2e-7 * np.abs(want[r]).max())
        tol = 2.5 * np.abs(x).max() * 4 / 127
        np.testing.assert_allclose(got, exact, atol=tol)
        assert np.corrcoef(got.ravel(), exact.ravel())[0, 1] > 0.999


def test_quantized_allreduce_needs_a_divisible_size(world):
    with pytest.raises(RuntimeError, match="axis_size == 0"):
        world.run(G.job_quantized_allreduce, RNG.normal(
            size=(4, 6)).astype(np.float32))


@pytest.mark.parametrize("quantize", [True, False])
def test_dgc_allreduce_matches_jax(world, quantize):
    tree = {"a": RNG.normal(size=(4, 64)).astype(np.float32),
            "b": RNG.normal(size=(4, 8, 16)).astype(np.float32),
            "odd": RNG.normal(size=(4, 18)).astype(np.float32)}

    def f(t):
        out = JD.dgc_allreduce({k: v[0] for k, v in t.items()}, "dp",
                               sparsity=0.5, quantize=quantize)
        return {k: v[None] for k, v in out.items()}

    spec = {k: JP_("dp") for k in tree}
    want = jax.jit(jax.shard_map(f, mesh=_jmesh4(), in_specs=(spec,),
                                 out_specs=spec))(
        {k: jnp.asarray(v) for k, v in tree.items()})
    res = world.run(G.job_dgc_allreduce, tree, 0.5, quantize)
    for r, got in enumerate(res):
        for k in tree:
            w = np.asarray(want[k])[r]
            exact_path = (not quantize) or k == "odd"
            np.testing.assert_allclose(
                got[k], w, rtol=0,
                atol=(1e-6 if exact_path else 1.2e-7) * np.abs(w).max(),
                err_msg=k)
    kept = {k: np.stack([np.asarray(JD.top_k_sparsify(jnp.asarray(v[i]),
                                                      0.5)[0])
                         for i in range(4)]).sum(0) for k, v in tree.items()}
    assert np.corrcoef(res[0]["a"].ravel(), kept["a"].ravel())[0, 1] > 0.999


# --- GeoSGDTrainer -------------------------------------------------------------

class JBNNet(JNN.Layer):
    """tests/torch_world.py ``BNNet`` in the JAX package."""

    def __init__(self):
        super().__init__()
        self.fc = JNN.Linear(8, 6)
        self.bn = JNN.BatchNorm(6)
        self.head = JNN.Linear(6, 3)

    def forward(self, x):
        return self.head(jax.nn.relu(self.bn(self.fc(x))))


def _geo_case(kind, seed=0):
    pt.seed(seed)
    rng = np.random.default_rng(seed)
    if kind == "mnist":
        jm = JM.MnistMLP(hidden1=16, hidden2=8)
        x = rng.normal(size=(8, 784)).astype(np.float32)
        y = rng.integers(0, 10, 8).astype(np.int32)
        opt, cfg = ("Momentum", 0.1, 0.9), dict(hidden1=16, hidden2=8)
    else:
        jm = JBNNet()
        x = (rng.normal(size=(8, 8)) * np.repeat([0.5, 1, 2, 4], 2)[:, None]
             ).astype(np.float32)
        y = rng.integers(0, 3, 8).astype(np.int32)
        opt, cfg = ("SGD", 0.5), {}
    state = {k: np.asarray(v) for k, v in jm.named_parameters().items()}
    state.update({k: np.asarray(v) for k, v in jm.named_buffers().items()})
    return jm, state, x, y, opt, cfg


def _jax_geo(jm, x, y, opt, sync_every, steps, flush):
    mesh = pt.build_mesh(dp=4, devices=jax.devices()[:4])
    jt = JPAR.Trainer.supervised(jm, getattr(JO, opt[0])(*opt[1:]),
                                 JM.loss_fn, mesh=mesh)
    geo = JGeo(jt, sync_every=sync_every)
    batch = {"x": jax.device_put(x, jt.data_sharding()),
             "label": jax.device_put(y, jt.data_sharding())}
    out = []
    for _ in range(steps):
        loss, _ = geo.train_step(batch)
        out.append((float(loss), float(geo.divergence)))
    replicas = ({k: np.asarray(v) for k, v in geo._params.items()},
                {k: np.asarray(v) for k, v in geo._buffers.items()},
                [{k: np.asarray(v) for k, v in s.items()}
                 for s in geo._opt_state["leaf"]])
    if flush:
        geo.sync()
    return out, replicas, jt


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                               err_msg=what)


@pytest.mark.parametrize("kind", ["mnist", "bn"])
def test_geo_sgd_matches_jax_and_flushes_the_consensus(world, kind):
    jm, state, x, y, opt, cfg = _geo_case(kind)
    want, (jp, jb, js), jt = _jax_geo(jm, x, y, opt, 2, 3, flush=True)
    res = world.run(G.job_geo, kind, cfg, state, x, y, 2, 3, opt, True)
    for r in res:
        for (loss, div), (jloss, jdiv) in zip(r["steps"], want):
            np.testing.assert_allclose(loss, jloss, atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(div, jdiv, atol=1e-5, rtol=1e-4)
        rank = r["rank"]
        for k, v in r["replica"]["params"].items():
            _close(v, jp[k][rank], f"replica {rank} {k}")
        for k, v in r["replica"]["buffers"].items():
            _close(v, jb[k][rank], f"replica {rank} buffer {k}")
        for got, wl in zip(r["replica"]["opt_state"], js):
            for k, v in got.items():
                _close(v, wl[k][rank], f"replica {rank} state {k}")
        flushed = r["flushed"]
        for k, v in flushed["params"].items():
            _close(v, np.asarray(jt.params[k]), f"flushed {k}")
            np.testing.assert_array_equal(v, res[0]["flushed"]["params"][k])
        for k, v in flushed["buffers"].items():
            _close(v, np.asarray(jt.buffers[k]), f"flushed buffer {k}")
        for got, wl in zip(flushed["opt_state"], jt.opt_state["leaf"]):
            for k, v in got.items():
                _close(v, np.asarray(wl[k]), f"flushed state {k}")
        assert flushed["step"] == 3 and r["divergence"] < 1e-6
    if kind == "bn":
        assert any(np.ptp(jb[k], axis=0).max() > 0 for k in jb)


def test_geo_sgd_sync_interval_pattern_matches_jax(world):
    jm, state, x, y, opt, cfg = _geo_case("mnist", seed=1)
    want, _, _ = _jax_geo(jm, x, y, ("SGD", 0.1), 3, 6, flush=False)
    jpattern = [d < 1e-6 for _, d in want]
    assert jpattern == [False, False, True, False, False, True]
    res = world.run(G.job_geo, "mnist", cfg, state, x, y, 3, 6,
                    ("SGD", 0.1), False)
    for r in res:
        assert [d < 1e-6 for _, d in r["steps"]] == jpattern
        assert all(d > 0 for (_, d), s in zip(r["steps"], jpattern)
                   if not s)


def test_geo_sgd_trains_every_row_of_each_rank(world):
    """A corrupted second row of each rank changes the loss (each replica
    trains on its whole shard), in both packages alike."""
    jm, state, x, y, opt, cfg = _geo_case("mnist", seed=2)
    bad = x.copy()
    bad[1::2] = 999.0
    clean = world.run(G.job_geo, "mnist", cfg, state, x, y, 10, 1,
                      ("SGD", 0.1), False)[0]["steps"][0][0]
    corrupted = world.run(G.job_geo, "mnist", cfg, state, bad, y, 10, 1,
                          ("SGD", 0.1), False)[0]["steps"][0][0]
    assert not np.isclose(clean, corrupted)
    want, _, _ = _jax_geo(jm, bad, y, ("SGD", 0.1), 10, 1, flush=False)
    np.testing.assert_allclose(corrupted, want[0][0], rtol=1e-5)
