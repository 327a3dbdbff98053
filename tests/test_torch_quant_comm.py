"""The int8 gradient all-reduce in the port (paddle_tpu_torch/quant/
collectives.py and ``grad_compression=`` on the Plan and the Trainer)
against the JAX package's, on 4 gloo ranks (tests/torch_world.py, the
jobs in tests/torch_quant_jobs.py) and a 4-device submesh of the CPU sim.

Tolerances and why:
- the ring with nearest rounding: bit for bit (``assert_array_equal``)
  against JAX's jitted ``quantized_psum`` under ``shard_map`` on the
  same rows: the same encodes (the scale as XLA computes it, absmax
  times float32(1/127)), the decode-and-add as one fused multiply-add
  (XLA fuses it so), in the same order, and one encoding of each
  reduced chunk decoded on every rank; the partitioned form likewise
  against the shard_map form on the per-rank partials (the JAX
  partitioned spelling itself does not run on this JAX: its six tests
  fail in tests/test_quant_comm.py), and ``compress_grads`` against the
  jitted JAX function.
- stochastic rounding: the port's draws are not JAX's bits, so it is
  held in distribution: every rank the same bytes, each element within
  2 n steps of the exact sum as the JAX test bounds it, the mean over
  32 keys within 1.5 steps of it everywhere and the signed mean error
  within 0.02 of a step (unbiased), the spread of one draw within
  0.7-1.4 of the JAX draws'.
- payload bytes: equal integers.
- the Trainer (MnistMLP(16, 8), SGD(0.5), B=16, 2 steps; the JAX Trainer
  on the same weights and batch under the same plan): losses within
  1e-5 relative; each parameter within, per group of 1024 entries of
  the flattened leaf, lr times one quantization step of that group's
  JAX gradient (absmax / 127) a step: the two packages' gradients
  differ by float32 rounding before the encode, which may move a code
  by one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

import paddle_tpu as pt
import torch_quant_jobs as Q
import torch_world as W
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JPAR
from paddle_tpu.models import mnist as JM
from paddle_tpu.parallel import plan as JPL
from paddle_tpu.quant import collectives as JQC
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.models import mnist as TMN
from paddle_tpu_torch.parallel import Plan, Trainer
from paddle_tpu_torch.quant import collectives as TQC

RNG = np.random.default_rng(23)
LR = 0.5
MNIST = dict(hidden1=16, hidden2=8)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


def _jax_ring(x_rows, **kw):
    f = jax.shard_map(lambda v: JQC.quantized_psum(v[0], "dp", 4, **kw),
                  mesh=Mesh(np.asarray(jax.devices()[:4]), ("dp",)),
                  in_specs=JP("dp"), out_specs=JP(), check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(x_rows)))


def _jax_sr_draws(x_rows, seeds):
    """JAX's stochastic ring once per seed, compiled once (the key an
    argument)."""
    f = jax.jit(jax.shard_map(
        lambda v, k: JQC.quantized_psum(v[0], "dp", 4, key=k),
        mesh=Mesh(np.asarray(jax.devices()[:4]), ("dp",)),
        in_specs=(JP("dp"), JP()), out_specs=JP(), check_vma=False))
    x = jnp.asarray(x_rows)
    return np.stack([np.asarray(f(x, jax.random.key(k))) for k in seeds])


# --- the shared abs-max helper (tests/test_quant_comm.py TestSharedAbsMax) ---

@pytest.mark.parametrize("case", ["nearest", "stochastic", "whole",
                                  "zero"])
def test_shared_absmax_round_trip_matches_jax_bounds(case):
    """quant.ops' encode/decode under the JAX test's bounds: nearest
    within half a step (codes and scales equal to JAX's), stochastic
    within one step and unbiased, the whole-tensor and recorded-absmax
    forms on one grid, a zero input exact."""
    from paddle_tpu.quant.ops import absmax_decode as jdec
    from paddle_tpu.quant.ops import absmax_encode as jenc
    from paddle_tpu_torch.quant.ops import absmax_decode, absmax_encode

    if case == "zero":
        q, sc = absmax_encode(torch.zeros(16))
        assert int(q.sum()) == 0
        np.testing.assert_array_equal(absmax_decode(q, sc).numpy(),
                                      np.zeros(16, np.float32))
        return
    shape = {"nearest": (64, 128), "stochastic": (256, 256),
             "whole": (33,)}[case]
    x = RNG.normal(size=shape).astype(np.float32)
    xt = torch.from_numpy(x)
    if case == "whole":
        q, sc = absmax_encode(xt)
        assert sc.shape == ()
        np.testing.assert_allclose(absmax_decode(q, sc).numpy(), x,
                                   atol=float(sc) / 2 * (1 + 1e-5))
        q2, _ = absmax_encode(xt, absmax=xt.abs().max())
        assert torch.equal(q, q2)
        return
    key = np.array([0, 1], np.uint32) if case == "stochastic" else None
    q, sc = absmax_encode(xt, axis=1, key=key)
    err = absmax_decode(q, sc).numpy() - x
    bound = sc.numpy() * (1 + 1e-5) * (0.5 if key is None else 1.0)
    assert (np.abs(err) <= bound).all()
    if key is None:
        jq, js = jenc(jnp.asarray(x), axis=1)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(js))
        np.testing.assert_array_equal(absmax_decode(q, sc).numpy(),
                                      np.asarray(jdec(jq, js)))
    else:
        assert abs(err.mean()) < float(sc.numpy().mean()) * 0.02


# --- the ring ----------------------------------------------------------------

@pytest.mark.parametrize("n,group", [(3000, 256), (1024, 1024), (5, 1024),
                                     (4097, 512)])
def test_ring_is_bit_for_bit_jax_and_the_same_on_every_rank(world, n,
                                                            group):
    x = RNG.normal(size=(4, n)).astype(np.float32)
    want = _jax_ring(x, group=group)
    res = world.run(Q.job_ring, x, dict(group=group))
    for r in res:
        np.testing.assert_array_equal(r, want)
    atol = np.abs(x).max() / 127 * 4 * 1.5
    np.testing.assert_allclose(res[0], x.sum(0), atol=atol)


def test_the_wire_carries_int8_and_the_scales(world):
    """Each of the ring's 2 (n - 1) hops hands the exchange one int8
    chunk (chunk / group, group) and its float32 scales (chunk / group,
    1): no float32 payload crosses."""
    n, group = 3000, 256
    chunk = -(-(-(-n // 4)) // group) * group
    x = RNG.normal(size=(4, n)).astype(np.float32)
    for sent in world.run(Q.job_ring_wire, x, group):
        assert sent == [("torch.int8", (chunk // group, group)),
                        ("torch.float32", (chunk // group, 1))] * 6


def test_zero_input_sums_to_exactly_zero(world):
    res = world.run(Q.job_ring, np.zeros((4, 512), np.float32), {})
    for r in res:
        np.testing.assert_array_equal(r, np.zeros(512, np.float32))


@pytest.mark.parametrize("bad", [np.nan, np.inf], ids=["nan", "inf"])
def test_nonfinite_input_poisons_every_rank(world, bad):
    x = RNG.normal(size=(4, 512)).astype(np.float32)
    x[2, 7] = bad
    assert np.isnan(_jax_ring(x)).all()
    for r in world.run(Q.job_ring, x, {}):
        assert np.isnan(r).all()


def test_stochastic_rounding_bound_mean_and_replicas(world):
    x = RNG.normal(size=(4, 2048)).astype(np.float32)
    exact = x.sum(0)
    step = np.abs(x).max() / 127
    keys = [np.array([0, k], np.uint32) for k in range(32)]
    res = world.run(Q.job_sr_draws, x, keys)
    for r in res[1:]:
        np.testing.assert_array_equal(r, res[0])
    draws = res[0]
    # the JAX test's bound: one step a hop
    assert np.abs(draws - exact).max() <= step * 4 * 2
    jdraws = _jax_sr_draws(x, range(4))
    assert np.abs(jdraws - exact).max() <= step * 4 * 2
    # unbiased: the mean over the keys closes on the exact sum, and the
    # spread of one draw is the JAX draws' spread
    assert np.abs(draws.mean(0) - exact).max() < step * 1.5
    assert abs((draws - exact).mean()) < step * 0.02
    spread, jspread = np.abs(draws - exact).mean(), np.abs(
        jdraws - exact).mean()
    assert 0.7 < spread / jspread < 1.4, (spread, jspread)
    # different keys draw differently
    assert not np.array_equal(draws[0], draws[1])


def test_tree_mean_leaves_small_and_integer_leaves_exact(world):
    big = RNG.normal(size=(4, 4096)).astype(np.float32)
    small = RNG.normal(size=(4, 4)).astype(np.float32)
    cnt = np.arange(4, dtype=np.int32).reshape(4, 1)
    f = jax.shard_map(lambda b, s, c: JQC.quantized_pmean_tree(
        {"w": b[0], "b": s[0], "step": c[0]}, "dp", 4),
        mesh=Mesh(np.asarray(jax.devices()[:4]), ("dp",)),
        in_specs=(JP("dp"),) * 3, out_specs=JP(), check_vma=False)
    want = jax.jit(f)(jnp.asarray(big), jnp.asarray(small),
                      jnp.asarray(cnt))
    res = world.run(Q.job_tree, big, small, cnt)
    for r in res:
        np.testing.assert_array_equal(r["w"], np.asarray(want["w"]))
        np.testing.assert_allclose(r["b"], np.asarray(want["b"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(r["b"], small.mean(0), rtol=1e-6)
        np.testing.assert_array_equal(r["step"], np.asarray(want["step"]))
        assert r["step"].dtype == np.asarray(want["step"]).dtype


# --- the partitioned form -------------------------------------------------------

def test_partitioned_is_bit_for_bit_the_shard_map_ring(world):
    stacked = RNG.normal(size=(8, 3000)).astype(np.float32)
    partials = stacked.reshape(4, 2, 3000).sum(1)
    want = _jax_ring(partials, group=256)
    for r in world.run(Q.job_partitioned, stacked, dict(group=256)):
        np.testing.assert_array_equal(r, want)


def test_partitioned_keeps_the_rails_and_the_stochastic_mode(world):
    stacked = RNG.normal(size=(4, 2048)).astype(np.float32)
    atol = np.abs(stacked).max() / 127 * 4 * 2
    res = world.run(Q.job_partitioned, stacked, {},
                    key=np.array([0, 3], np.uint32))
    for r in res:
        np.testing.assert_array_equal(r, res[0])
        np.testing.assert_allclose(r, stacked.sum(0), atol=atol)
    stacked[1, 5] = np.inf
    for r in world.run(Q.job_partitioned, stacked, {}):
        assert np.isnan(r).all()


def test_partitioned_without_a_mesh_is_the_exact_sum():
    x = RNG.normal(size=(4, 300)).astype(np.float32)
    got = TQC.quantized_psum_partitioned(torch.from_numpy(x), "dp")
    # the JAX function's eager body (its ``ref``): the float32 sum
    np.testing.assert_array_equal(got.numpy(), x.sum(0, dtype=np.float32))


# --- compress_grads -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3000,), (64, 128), (6, 1000)])
def test_compress_grads_matches_jax(shape):
    tree = {"big": RNG.normal(size=shape).astype(np.float32),
            "small": RNG.normal(size=(16,)).astype(np.float32)}
    want = jax.jit(JQC.compress_grads)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    got = TQC.compress_grads({k: torch.from_numpy(v)
                              for k, v in tree.items()})
    np.testing.assert_array_equal(got["big"].numpy(),
                                  np.asarray(want["big"]))
    np.testing.assert_array_equal(got["small"].numpy(), tree["small"])
    bad = tree["big"].copy()
    bad.reshape(-1)[3] = np.nan
    out = TQC.compress_grads({"g": torch.from_numpy(bad)})["g"].numpy()
    np.testing.assert_array_equal(out, bad)


@pytest.mark.parametrize("spec", [("fsdp", None), (None, "fsdp")],
                         ids=["rows", "cols"])
def test_compress_grads_on_shards_takes_the_whole_leafs_groups(world,
                                                                spec):
    """(8, 1000) rows or (6, 1000) columns over fsdp=4: a rank's shard
    (2000 contiguous entries, or 250 columns of every row) cuts through
    the 1024-entry groups of the flattened leaf; each rank's round trip
    is the whole leaf's, bit for bit the JAX function's, and with a key
    every rank keeps the same draws, within one step of each group."""
    g = RNG.normal(size=(8, 1000)).astype(np.float32) if spec[0] else \
        RNG.normal(size=(6, 1000)).astype(np.float32)
    want = np.asarray(jax.jit(JQC.compress_grads)(
        {"g": jnp.asarray(g)})["g"])
    for r in world.run(Q.job_compress_sharded, g, spec):
        np.testing.assert_array_equal(r, want)
    sr = world.run(Q.job_compress_sharded, g, spec,
                   key=np.array([0, 9], np.uint32))
    for r in sr[1:]:
        np.testing.assert_array_equal(r, sr[0])
    scale = np.abs(np.pad(g.reshape(-1), (0, -g.size % 1024)).reshape(
        -1, 1024)).max(1) / 127
    err = np.abs(np.pad((sr[0] - g).reshape(-1), (0, -g.size % 1024))
                 .reshape(-1, 1024))
    assert (err <= scale[:, None] * (1 + 1e-5)).all()


# --- payload bytes ------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_payload_bytes_match_jax(n):
    tree = {"w1": np.zeros((784, 1024), np.float32),
            "w2": np.zeros((1024, 1024), np.float32),
            "b1": np.zeros((1024,), np.float32),
            "h": np.zeros((3000,), np.float16),
            "step": np.zeros((), np.int32)}
    for comp in (None, "int8", "int8_sr"):
        assert TQC.tree_payload_bytes(tree, n, compression=comp) == \
            JQC.tree_payload_bytes(tree, n, compression=comp)
    for size in (1, 1023, 1024, 5000, 2 ** 20):
        for c in (True, False):
            assert TQC.leaf_payload_bytes(size, n, compressed=c) == \
                JQC.leaf_payload_bytes(size, n, compressed=c)
    i8, rest = TQC.tree_payload_bytes(tree, 8, compression="int8")
    _, full = TQC.tree_payload_bytes(tree, 8, compression=None)
    assert full / (i8 + rest) >= 3.5


def test_mode_validation():
    assert TQC.COMPRESSION_MODES == JQC.COMPRESSION_MODES
    assert (TQC.GROUP_SIZE, TQC.MIN_COMPRESS_SIZE) == (
        JQC.GROUP_SIZE, JQC.MIN_COMPRESS_SIZE)
    with pytest.raises(EnforceError, match="grad_compression"):
        TQC.check_mode("int4")
    assert Plan(dp=4, grad_compression="int8").describe()[
        "grad_compression"] == "int8"


# --- the Trainer -------------------------------------------------------------------

def _batch():
    rng = np.random.default_rng(5)
    return {"x": rng.normal(size=(16, 784)).astype(np.float32),
            "label": rng.integers(0, 10, 16).astype(np.int32)}


def _jax_run(sizes, comp, steps):
    pt.seed(7)
    jm = JM.MnistMLP(**MNIST)
    state = {k: np.asarray(v) for k, v in jm.named_parameters().items()}
    n = int(np.prod(list(sizes.values())))
    plan = JPL.Plan(**sizes, min_shard_size=64, grad_compression=comp,
                    devices=jax.devices()[:n])
    jt = JPAR.Trainer.supervised(jm, JO.SGD(LR), JM.loss_fn, plan=plan)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    out, prev = [], state
    for _ in range(steps):
        loss, _ = jt.train_step(batch)
        now = {k: np.asarray(v) for k, v in jt.params.items()}
        # (p_before - p_after) / lr is the step's gradient under SGD
        out.append((float(loss), now, {k: (prev[k] - now[k]) / LR
                                       for k in now}))
        prev = now
    return state, out, jt


def _within_a_step(got, want, bound):
    """|got - want| within ``bound`` (per group of 1024 entries of the
    flattened leaf, broadcast back)."""
    size = got.size
    pad = -size % 1024
    diff = np.abs(np.pad((got - want).reshape(-1), (0, pad))).reshape(
        -1, 1024)
    assert (diff <= bound[:, None] + 1e-6).all(), (diff.max(), bound.max())


def _group_steps(g):
    pad = -g.size % 1024
    return np.abs(np.pad(g.reshape(-1), (0, pad))).reshape(
        -1, 1024).max(1) / 127


@pytest.mark.parametrize("sizes,via", [(dict(dp=4), "shard_map"),
                                       (dict(fsdp=4), "pjit")],
                         ids=["pure-dp", "fsdp"])
def test_trainer_trajectory_matches_jax(world, sizes, via):
    state, want, jt = _jax_run(sizes, "int8", 2)
    assert jt._jit_step.compiled_via == via
    res = world.run(Q.job_trainer, state, _batch(), 2, sizes, comp="int8")
    assert all(r["via"] == via and r["mode"] == "int8" for r in res)
    if via == "shard_map":
        assert all(r["same"] for r in res)
    bound = {k: np.zeros(-(-v.size // 1024)) for k, v in state.items()}
    for step, (j_loss, j_params, j_grads) in enumerate(want):
        for r in res:
            np.testing.assert_allclose(r["steps"][step][0], j_loss,
                                       rtol=1e-5)
        got = res[0]["steps"][step][1]
        for k, p in j_params.items():
            bound[k] = bound[k] + LR * _group_steps(j_grads[k])
            if TQC._compressible(p, TQC.MIN_COMPRESS_SIZE):
                _within_a_step(got[k], p, bound[k])
            else:
                np.testing.assert_allclose(got[k], p, atol=2e-5,
                                           err_msg=k)


def test_grad_accum_micro_steps_take_the_ring(world):
    """grad_accum_steps=2 under Plan(dp=4, grad_compression="int8"):
    each micro-step's gradients reduce through the ring before they
    accumulate (the JAX Trainer's ``_accum_step`` reduce boundary); 4
    micro-steps' losses within 1e-5 relative of the JAX Trainer's and
    the parameters within a step of each group a micro-step."""
    pt.seed(7)
    jm = JM.MnistMLP(**MNIST)
    state = {k: np.asarray(v) for k, v in jm.named_parameters().items()}
    plan = JPL.Plan(dp=4, min_shard_size=64, grad_compression="int8",
                    devices=jax.devices()[:4])
    jt = JPAR.Trainer.supervised(jm, JO.SGD(LR), JM.loss_fn, plan=plan,
                                 grad_accum_steps=2)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    want, prev = [], state
    for _ in range(4):
        loss, _ = jt.train_step(batch)
        now = {k: np.asarray(v) for k, v in jt.params.items()}
        want.append((float(loss), now, {k: (prev[k] - now[k]) / LR
                                        for k in now}))
        prev = now
    res = world.run(Q.job_trainer, state, _batch(), 4, dict(dp=4),
                    comp="int8", accum=2)
    bound = {k: np.zeros(-(-v.size // 1024)) for k, v in state.items()}
    for step, (j_loss, j_params, j_grads) in enumerate(want):
        for r in res:
            np.testing.assert_allclose(r["steps"][step][0], j_loss,
                                       rtol=1e-5)
        if step % 2 == 0:
            continue                     # no update on the first micro-step
        for k, p in j_params.items():
            # both micro-steps' rounding moves the applied mean
            bound[k] = bound[k] + 2 * LR * _group_steps(j_grads[k])
            _within_a_step(res[0]["steps"][step][1][k], p, bound[k])


def test_trainer_knob_beats_the_plan_and_counts_bytes(world):
    """Trainer(grad_compression="int8_sr") over Plan(dp=4) without one:
    the trainer's mode rules, the replicas stay bit-equal, and the
    counters advance by the JAX per-step payload times the steps (2
    train_step calls and one train_steps(3))."""
    state, _, _ = _jax_run(dict(dp=4), None, 1)
    res = world.run(Q.job_trainer, state, _batch(), 2, dict(dp=4),
                    trainer_comp="int8_sr", multi=3)
    jq = JPAR.Trainer.supervised(JM.MnistMLP(**MNIST), JO.SGD(LR),
                                 JM.loss_fn, plan=JPL.Plan(
                                     dp=4, devices=jax.devices()[:4]),
                                 grad_compression="int8_sr")
    assert jq.grad_compression == "int8_sr"
    for r in res:
        assert r["mode"] == "int8_sr" and r["same"]
        assert tuple(r["comm_bytes"]) == tuple(jq._comm_bytes)
        assert r["comm_bytes"][0] > 0
        assert tuple(r["advance"]) == tuple(5 * b for b in jq._comm_bytes)
        assert all(np.isfinite(loss) for loss, _ in r["steps"])


def test_compression_needs_a_multi_device_plan():
    with pytest.raises(EnforceError, match="multi-device"):
        Trainer.supervised(TMN.MnistMLP(**MNIST, device="cpu"),
                           TO.SGD(0.1), TMN.loss_fn,
                           plan=Plan(dp=1, device="cpu"),
                           grad_compression="int8")
    from paddle_tpu.core.enforce import EnforceError as JEE

    with pytest.raises(JEE, match="multi-device"):
        JPAR.Trainer.supervised(JM.MnistMLP(**MNIST), JO.SGD(0.1),
                                JM.loss_fn, plan=JPL.Plan(
                                    dp=1, devices=jax.devices()[:1]),
                                grad_compression="int8")


def test_no_quant_code_runs_when_off(world):
    state, want, _ = _jax_run(dict(dp=4), None, 1)
    res = world.run(Q.job_compression_off_runs_no_quant_code, state,
                    _batch())
    for loss in res:
        np.testing.assert_allclose(loss, want[0][0], rtol=1e-5)
