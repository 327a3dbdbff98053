"""Pipelines in the port (paddle_tpu_torch/parallel/pipeline.py) against
the JAX package's on the CPU: the pure schedule functions, and
``pipeline_apply`` on 4 gloo ranks (tests/torch_world.py, the jobs in
tests/torch_pipeline_jobs.py) against JAX's ``pipeline_apply`` on a
4-device submesh of the CPU sim and against the sequential fold.

Each pipelined case checks the output, the input's gradient (every pp
rank gets stage 0's: the pp sum of the replicated input's cotangent) and
every stacked leaf's gradient (the last stage's output cotangent taken
once, not summed over the pp ranks that each compute the objective),
for GPipe and the interleaved schedule (v = 2, and v = 4 over 16
layers), the stack whole or placed over ``pp``, in logical or ring
order. Tolerance 2e-5 absolute (float32; the folds' products agree to
~1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import torch_pipeline_jobs as PJ
import torch_world as W
from paddle_tpu.parallel import pipeline as JPL
from paddle_tpu_torch.core import mesh as TM
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.parallel import pipeline as TPL

L, D, B = 8, 16, 16
TOL = 2e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


def _params(seed=0, layers=L, bias=True):
    rng = np.random.default_rng(seed)
    p = {"w": rng.normal(scale=0.5 if layers == L else 0.35,
                         size=(layers, D, D)).astype(np.float32)}
    if bias:
        p["b"] = rng.normal(scale=0.1, size=(layers, D)).astype(np.float32)
    return p


def _jax_block(p, h):
    h = h @ p["w"] + p["b"] if "b" in p else h @ p["w"]
    return jnp.tanh(h)


def _jax_aux_block(p, h):
    h2 = h + p["w"]
    return h2, jnp.stack([jnp.sum(h2), jnp.max(h2)])


def _jax_pipeline(sizes, params, x, m, aux_size=0, **kw):
    """JAX's output, aux, dx and param grads for the jobs' objective."""
    mesh = pt.build_mesh(**sizes, devices=jax.devices()[:4])
    block = _jax_aux_block if aux_size else _jax_block

    def loss(p, x):
        out = JPL.pipeline_apply(block, p, x, num_microbatches=m,
                                 mesh=mesh, aux_size=aux_size, **kw)
        aux = None
        if aux_size:
            out, aux = out
        val = jnp.sum(out ** 2) / x.shape[0]
        if aux_size:
            val = val + jnp.sum(aux) * 0.1
        return val, (out, aux)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    return (np.asarray(out), None if aux is None else np.asarray(aux),
            np.asarray(gx), {k: np.asarray(v) for k, v in gp.items()})


def _seq_grads(params, x, block=PJ.tanh_block):
    """The sequential fold's output and gradients, in torch."""
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    h = xt
    for i in range(len(p["w"])):
        h = block({k: v[i] for k, v in p.items()}, h)
    ((h ** 2).sum() / x.shape[0]).backward()
    return (h.detach().numpy(), xt.grad.numpy(),
            {k: v.grad.numpy() for k, v in p.items()})


def _check(res, want, dp=1, seq=None):
    """Each rank's output and input-gradient rows (rank r's dp index is
    r // (4 / dp)), its aux and its whole leaf gradients against
    ``want``; rank 0's against the sequential fold's."""
    out, aux, dx, grads = want
    rows = out.shape[0] // dp
    for rank, r in enumerate(res):
        d = rank // (4 // dp)
        sl = slice(d * rows, (d + 1) * rows)
        np.testing.assert_allclose(r["out"], out[sl], atol=TOL)
        np.testing.assert_allclose(r["dx"], dx[sl], atol=TOL)
        if aux is not None:
            np.testing.assert_allclose(r["aux"], aux, atol=TOL)
        for k, g in grads.items():
            np.testing.assert_allclose(r["grads"][k], g, atol=TOL,
                                       err_msg=k)
    if seq is not None:
        np.testing.assert_allclose(res[0]["dx"], seq[1][:rows], atol=TOL)
        for k, g in seq[2].items():
            np.testing.assert_allclose(res[0]["grads"][k], g, atol=TOL)


CASES = [
    # (sizes, m, schedule, v, placed, ring, layers)
    (dict(pp=4), 6, "gpipe", 1, False, False, L),
    (dict(dp=2, pp=2), 4, "gpipe", 1, True, False, L),
    (dict(pp=4), 6, "interleaved", 2, True, True, L),
    (dict(pp=4), 8, "interleaved", 2, True, False, L),
    (dict(dp=2, pp=2), 4, "interleaved", 2, True, True, L),
    (dict(pp=4), 6, "interleaved", 4, True, True, 16),
    (dict(dp=2, pp=2), 2, "interleaved", 4, False, False, 16),
]


@pytest.mark.parametrize(
    "sizes,m,schedule,v,placed,ring,layers", CASES,
    ids=[f"{'x'.join(f'{k}{s}' for k, s in c[0].items())}-m{c[1]}-{c[2]}"
         f"{c[3]}-{'placed' if c[4] else 'whole'}"
         f"{'-ring' if c[5] else ''}-L{c[6]}" for c in CASES])
def test_pipeline_matches_jax_and_the_fold(world, sizes, m, schedule, v,
                                           placed, ring, layers):
    bias = layers == L
    params = _params(layers, layers, bias)
    dp = sizes.get("dp", 1)
    x = np.random.default_rng(layers + m).normal(
        size=(2 * m * dp, D)).astype(np.float32)
    jax_want = _jax_pipeline(sizes, params, x, m, schedule=schedule,
                             virtual_stages=v)
    res = world.run(PJ.job_pipeline, sizes, "tanh" if bias else "tanh_w",
                    params, x, m, schedule, v, placed, ring)
    seq = _seq_grads(params, x, PJ.tanh_block if bias else PJ.tanh_block_w)
    np.testing.assert_allclose(jax_want[0], seq[0], atol=TOL)
    _check(res, jax_want, dp, seq)
    if placed:
        # a pp rank holds its own chunk(s) of the stack and nothing else
        n = sizes["pp"]
        assert all(r["shapes"]["w"] == (layers // n, D, D) for r in res)


def test_pipeline_without_remat_and_the_aux_carry(world):
    """tests/test_moe_pipeline.py's aux contract (sums over the layers a
    microbatch passes, the mean over the microbatches) for both
    schedules, with and without remat, against JAX."""
    rng = np.random.default_rng(0)
    p = {"w": rng.normal(size=(4, 4)).astype(np.float32)}
    x = rng.normal(size=(8, 4)).astype(np.float32)
    # dp=1: a microbatch's aux is its whole content's
    for sizes, schedule, v in ((dict(pp=4), "gpipe", 1),
                               (dict(pp=2, tp=2), "interleaved", 2)):
        want = _jax_pipeline(sizes, p, x, 2, aux_size=2, schedule=schedule,
                             virtual_stages=v)
        # remat only changes what the backward recomputes: one
        # schedule without it
        for remat in (True, False) if schedule == "gpipe" else (True,):
            res = world.run(PJ.job_pipeline, sizes, "aux", p, x, 2,
                            schedule, v, aux_size=2, remat=remat)
            _check(res, want)


def test_one_stage_pipeline_is_the_microbatched_fold():
    """With one pp rank (no process group) both packages fold
    sequentially, per microbatch for the aux."""
    rng = np.random.default_rng(0)
    p = {"w": rng.normal(size=(4, 4)).astype(np.float32)}
    x = rng.normal(size=(8, 4)).astype(np.float32)
    jmesh = pt.build_mesh(dp=2, pp=1, devices=jax.devices()[:2])
    jh, ja = JPL.pipeline_apply(_jax_aux_block, jax.tree_util.tree_map(
        jnp.asarray, p), jnp.asarray(x), num_microbatches=2, mesh=jmesh,
        aux_size=2)
    th, ta = TPL.pipeline_apply(PJ.aux_block, {"w": torch.from_numpy(
        p["w"])}, torch.from_numpy(x), num_microbatches=2, aux_size=2)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    h2, a2 = TPL.microbatched_aux_fold(
        PJ.aux_block, {"w": torch.from_numpy(p["w"])}, torch.from_numpy(x),
        num_microbatches=2, aux_size=2, remat=False)
    np.testing.assert_array_equal(h2.numpy(), th.numpy())
    np.testing.assert_array_equal(a2.numpy(), ta.numpy())
    params = _params()
    xx = np.random.default_rng(3).normal(size=(B, D)).astype(np.float32)
    out = TPL.pipeline_apply(PJ.tanh_block, {k: torch.from_numpy(v) for k, v
                                             in params.items()},
                             torch.from_numpy(xx), num_microbatches=4)
    np.testing.assert_allclose(out.numpy(), _seq_grads(params, xx)[0],
                               atol=TOL)


def test_gpipe_layer_wrapper(world):
    """GPipe over Linear(D, D, act="tanh") blocks on pp=4 against the
    blocks applied in order and JAX's GPipe on the same weights."""
    import paddle_tpu.nn as jnn

    rng = np.random.default_rng(6)
    state = {"weight": rng.normal(scale=0.3, size=(L, D, D)).astype(
        np.float32), "bias": rng.normal(scale=0.1, size=(L, D)).astype(
            np.float32)}
    x = rng.normal(size=(B, D)).astype(np.float32)
    pt.seed(11)
    jblocks = [jnn.Linear(D, D, act="tanh") for _ in range(L)]
    jmesh = pt.build_mesh(pp=4, devices=jax.devices()[:4])
    jgp = JPL.GPipe(jblocks, num_microbatches=4, mesh=jmesh)
    want = np.asarray(jgp(jnp.asarray(x), stacked_params={
        k: jnp.asarray(v) for k, v in state.items()}))
    res = world.run(PJ.job_gpipe_layers, dict(pp=4), state, x, 4)
    h = x
    for i in range(L):
        h = np.tanh(h @ state["weight"][i] + state["bias"][i])
    for r in res:
        np.testing.assert_allclose(r, want, atol=TOL)
        np.testing.assert_allclose(r, h, atol=TOL)


# --- the pure functions -----------------------------------------------------

@pytest.mark.parametrize("n,m,v", [(4, 8, 2), (4, 6, 2), (2, 4, 1),
                                   (4, 6, 4), (2, 3, 2), (1, 4, 1)])
def test_ticks_and_bubble_match_jax(n, m, v):
    assert TPL.gpipe_ticks(n, m) == JPL.gpipe_ticks(n, m)
    assert TPL.interleaved_ticks(n, m, v) == JPL.interleaved_ticks(n, m, v)
    assert TPL.bubble_fraction(n, m, "interleaved", v) == \
        JPL.bubble_fraction(n, m, "interleaved", v)
    assert TPL.bubble_fraction(n, m) == JPL.bubble_fraction(n, m)
    # every microbatch's last chunk is banked once, the last at the end
    banks = TPL._bank_ticks(n, m, v, "interleaved")
    assert sorted(banks) == list(range(m))
    assert max(banks.values()) == TPL.interleaved_ticks(n, m, v) - 1


def test_bubble_values_and_errors():
    assert abs(TPL.bubble_fraction(2, 4) - 0.2) < 1e-12
    assert abs(TPL.bubble_fraction(4, 8, "interleaved", 2) - 3 / 19) < 1e-12
    with pytest.raises(EnforceError, match="schedule must be"):
        TPL.bubble_fraction(2, 4, "1f1b")
    with pytest.raises(EnforceError, match="no virtual stages"):
        TPL.bubble_fraction(2, 4, "gpipe", 2)


@pytest.mark.parametrize("n,v,k", [(4, 2, 3), (2, 4, 1), (2, 2, 2)])
def test_ring_order_and_stage_layouts_match_jax(n, v, k):
    Lr = n * v * k
    a = np.arange(Lr * 2, dtype=np.float32).reshape(Lr, 2)
    jt = {"w": jnp.asarray(a)}
    tt = {"w": torch.from_numpy(a)}
    r = TPL.ring_order_layers(tt, n, v)["w"].numpy()
    np.testing.assert_array_equal(r, np.asarray(
        JPL.ring_order_layers(jt, n, v)["w"]))
    np.testing.assert_array_equal(TPL.ring_order_layers(
        {"w": torch.from_numpy(r)}, n, v, inverse=True)["w"].numpy(), a)
    for name in ("_stack_to_stages",):
        np.testing.assert_array_equal(
            getattr(TPL, name)(tt, n)["w"].numpy(),
            np.asarray(getattr(JPL, name)(jt, n)["w"]))
    for name in ("_interleave_to_stages", "_ring_to_stages"):
        np.testing.assert_array_equal(
            getattr(TPL, name)(tt, n, v)["w"].numpy(),
            np.asarray(getattr(JPL, name)(jt, n, v)["w"]))
    # the interleaved layout of a ring-ordered stack is a reshape
    np.testing.assert_array_equal(
        TPL._ring_to_stages({"w": torch.from_numpy(r)}, n, v)["w"].numpy(),
        TPL._interleave_to_stages(tt, n, v)["w"].numpy())


@pytest.mark.parametrize("kw,layers,match", [
    (dict(), 6, "divide pp"),
    (dict(schedule="interleaved", virtual_stages=3), 8, "virtual stages"),
    (dict(virtual_stages=2), 8, "gpipe schedule"),
    (dict(schedule="1f1b"), 8, "schedule must be"),
    (dict(layers_in_ring_order=True), 8, "layers_in_ring_order"),
    (dict(num_microbatches=3), 8, "must divide batch size"),
], ids=["layers", "virtual", "gpipe-v", "schedule", "ring", "microbatch"])
def test_bad_configurations_raise_typed_as_jax(kw, layers, match):
    """The configurations JAX rejects raise EnforceError in the port, on a
    layout-only pp=4 mesh (the checks run before any collective)."""
    kw = {"num_microbatches": 4, **kw}
    p = {"w": np.zeros((layers, D, D), np.float32)}
    x = np.zeros((8, D), np.float32)
    jmesh = pt.build_mesh(pp=4, devices=jax.devices()[:4])
    with pytest.raises(Exception, match=match):
        JPL.pipeline_apply(_jax_block, jax.tree_util.tree_map(
            jnp.asarray, p), jnp.asarray(x), mesh=jmesh, **kw)
    tmesh = TM.build_mesh(pp=4, devices=range(4), device="cpu")
    with pytest.raises(EnforceError, match=match):
        TPL.pipeline_apply(PJ.tanh_block_w, {"w": torch.from_numpy(p["w"])},
                           torch.from_numpy(x), mesh=tmesh, **kw)


def test_stage_param_sharding_places_each_chunk():
    tmesh = TM.build_mesh(pp=4, devices=range(4), device="cpu")
    sh = TPL.stage_param_sharding({"w": torch.zeros(L, D, D),
                                   "b": torch.zeros(L, D)}, 4, mesh=tmesh)
    assert tuple(sh["w"].spec) == ("pp", None, None)
    assert tuple(sh["b"].spec) == ("pp", None)
    assert sh["w"].local_shape((L, D, D)) == (L // 4, D, D)
    with pytest.raises(EnforceError, match="stages"):
        TPL.stage_param_sharding({"w": torch.zeros(L, D)}, 2, mesh=tmesh)
