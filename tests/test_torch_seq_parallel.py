"""Sequence-parallel models and training of the port against the JAX
package on the same weights (crossed with load_numpy_state), float32.

The port runs in a world of 4 gloo ranks (tests/torch_world.py) on the
mesh dp=2 x sp=2, each rank on its shard as the JAX Trainer's
``data_sharding`` gives it (the batch split over dp, the full sequence,
for the models; the rows under ``P("dp", "sp")`` for the layers); the
JAX side runs the global batch on the same mesh over 4 of the 8 CPU
devices, jitted (no force_flash on either side: head_dim 32 keeps the
ring on its einsum hop, Ulysses on the plain attention).

- GPT tiny (2 layers, hidden 128, 4 heads over 2 kv heads) with
  ``seq_parallel="ring"`` and ``"ulysses"``: the logits (all-gathered
  over sp), ``forward_loss`` with ignored labels falling unevenly on the
  dp and sp ranks, and every parameter's gradient, the ranks' gradients
  averaged over the mesh as ``Trainer(mesh=)`` averages them: loss and
  logits at 1e-5, each gradient within 1e-5 of its parameter's largest
  JAX entry (at least 0.1; float32 through 2 blocks, summed across
  ranks in another order).
- The BERT encoder stack (post-norm, 2 layers, a key-padding mask) and
  a rotary GQA attention layer under ``seq_parallel``: outputs and input
  gradients at 1e-5, parameter gradients summed over the ranks within
  1e-4 of each parameter's largest entry (at least 0.1: k_proj.bias's
  gradient is 0 in exact arithmetic).
- ``Trainer(mesh=)`` (ring, dp=2 x sp=2) and ``DataParallel`` (dp=4, a
  different number of ignored labels on each rank) for two SGD steps against the JAX Trainer and DataParallel on the same
  global batch: the losses at 1e-5 and every parameter after each step
  at 1e-5, as tests/test_torch_train.py holds the single-device SGD
  trajectory (the parameters move by lr x the gradient, so they carry
  the gradients).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import torch_world as W
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JP
from paddle_tpu.core.mesh import mesh_scope
from paddle_tpu.models import gpt as JG
from paddle_tpu.nn import layers as JL
from paddle_tpu.nn import transformer as JT

CFG = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_size=256, max_position=128)
B, T = 2, 64
SIZES = dict(dp=2, sp=2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


@functools.lru_cache(maxsize=None)
def _jmesh(dp, sp):
    return pt.build_mesh(dp=dp, sp=sp, devices=jax.devices()[:dp * sp])


def _state(layer):
    return {k: np.asarray(v) for k, v in layer.named_parameters().items()}


def _ids(seed, b=B):
    return np.random.default_rng(seed).integers(1, 512, (b, T)).astype(
        np.int32)


def _close_grads(got, want, atol, floor=0.1):
    for name, w in want.items():
        w = np.asarray(w)
        scale = max(np.abs(w).max(), floor)
        np.testing.assert_allclose(got[name] / scale, w / scale, atol=atol,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_gpt_seq_parallel_matches_jax(world, impl):
    pt.seed(1)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**CFG, seq_parallel=impl))
    ids = _ids(2)
    labels = np.concatenate([ids[:, 1:], np.full((B, 1), -100, np.int32)],
                            axis=1)
    # ignored labels unevenly over the dp rows and the sp halves
    labels[0, 5:9] = -100
    labels[1, 40:52] = -100

    def jloss(p):
        out, _ = jm.functional_call(p, jnp.asarray(ids), training=True,
                                    labels=jnp.asarray(labels),
                                    vocab_chunk=96, method="forward_loss")
        return out

    with mesh_scope(_jmesh(**SIZES)):
        j_logits = jax.jit(lambda p: jm.functional_call(
            p, jnp.asarray(ids))[0])(jm.named_parameters())
        j_loss, j_grads = jax.jit(jax.value_and_grad(jloss))(
            jm.named_parameters())
    res = world.run(W.job_gpt_seq, impl, SIZES, CFG, _state(jm), ids,
                    labels)
    for rank, (logits, loss, _) in enumerate(res):
        dp = rank // 2
        np.testing.assert_allclose(logits, np.asarray(j_logits)[dp:dp + 1],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(loss, float(j_loss), atol=1e-5, rtol=0)
    _close_grads(res[0][2], j_grads, 1e-5)


def _layer_check(world, kind, impl, jlayer, kw, x, mask, causal=False):
    rng = np.random.default_rng(9)
    ct = rng.normal(size=x.shape).astype(np.float32)

    def jout(p, xx):
        extra = ({"mask": jnp.asarray(mask)[:, None, None]}
                 if mask is not None else {"causal": causal})
        out, _ = jlayer.functional_call(p, xx, training=True, **extra)
        return out

    with mesh_scope(_jmesh(**SIZES)):
        want, vjp = jax.vjp(jax.jit(jout), jlayer.named_parameters(),
                            jnp.asarray(x))
        want_g, want_x = vjp(jnp.asarray(ct))
    res = world.run(W.job_layer_seq, kind, impl, SIZES, kw, _state(jlayer),
                    x, mask, ct, causal)
    b, t = x.shape[:2]
    for rank, (out, gx, _) in enumerate(res):
        dp, sp = divmod(rank, 2)
        rows = (slice(dp * b // 2, (dp + 1) * b // 2),
                slice(sp * t // 2, (sp + 1) * t // 2))
        np.testing.assert_allclose(out, np.asarray(want)[rows], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(gx, np.asarray(want_x)[rows], atol=1e-5,
                                   rtol=0)
    _close_grads(res[0][2], want_g, 1e-4)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_bert_encoder_stack_seq_parallel(world, impl):
    kw = dict(num_layers=2, d_model=64, nhead=4, dim_feedforward=128,
              dropout=0.0, normalize_before=False)
    pt.seed(3)
    je = JT.TransformerEncoder(**kw, seq_parallel=impl)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, T, 64)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 50:] = False
    _layer_check(world, "encoder", impl, je, kw, x, mask)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_mha_seq_parallel_with_rope(world, impl):
    """Rotary positions are global: rank (dp, sp) rotates its rows from
    sp * T/2 on, as the JAX layer rotates the global q and k."""
    kw = dict(embed_dim=64, num_heads=4, num_kv_heads=2, rotary=True,
              bias=False)
    pt.seed(5)
    jl = JL.MultiHeadAttention(**kw, seq_parallel=impl)
    x = np.random.default_rng(6).normal(size=(B, T, 64)).astype(np.float32)
    _layer_check(world, "mha", impl, jl, kw, x, None, causal=True)


def _jax_trainer(jm, opt, mesh):
    def loss_builder(params, buffers, rng, batch):
        out, nb = jm.functional_call(params, batch, buffers=buffers,
                                     rng=rng, training=rng is not None,
                                     vocab_chunk=96, method="forward_loss")
        return out, ({}, nb)

    return JP.Trainer(jm, opt, loss_builder, mesh=mesh)


def test_trainer_mesh_matches_jax_trainer(world):
    pt.seed(7)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**CFG, seq_parallel="ring"))
    state = _state(jm)
    ids = _ids(8)
    jmesh = _jmesh(**SIZES)
    with mesh_scope(jmesh):
        jt = _jax_trainer(jm, JO.SGD(0.5), jmesh)
        want = []
        for _ in range(2):
            loss, _ = jt.train_step(jnp.asarray(ids))
            want.append((float(loss), {k: np.asarray(v)
                                       for k, v in jt.params.items()}))
    res = world.run(W.job_trainer_seq, "ring", SIZES, CFG, state, ids, 2,
                    0.5)
    for step, (j_loss, j_params) in enumerate(want):
        for rank in range(4):
            np.testing.assert_allclose(res[rank][step][0], j_loss,
                                       atol=1e-5, rtol=0)
        got = res[0][step][1]
        for name, p in j_params.items():
            np.testing.assert_allclose(got[name], p, atol=1e-5, rtol=0,
                                       err_msg=name)


def test_data_parallel_matches_jax(world):
    pt.seed(9)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**CFG))
    state = _state(jm)
    ids = _ids(10, b=4)
    labels = np.concatenate([ids[:, 1:], np.full((4, 1), -100, np.int32)],
                            axis=1)
    # 1, 9, 31 and 57 ignored labels on the four ranks' rows: the global
    # token mean, not a mean of the ranks' means
    labels[1, 10:18] = -100
    labels[2, 0:30] = -100
    labels[3, 3:59] = -100
    jt = JP.DataParallel(jm, JO.SGD(0.5), JG.loss_fn,
                         devices=jax.devices()[:4])
    want = []
    for _ in range(2):
        loss, _ = jt.train_step({"x": jnp.asarray(ids),
                                 "label": jnp.asarray(labels)})
        want.append((float(loss), {k: np.asarray(v)
                                   for k, v in jt.params.items()}))
    res = world.run(W.job_data_parallel, CFG, state, ids, labels, 2, 0.5)
    for step, (j_loss, j_params) in enumerate(want):
        for rank in range(4):
            np.testing.assert_allclose(res[rank][step][0], j_loss,
                                       atol=1e-5, rtol=0)
        for name, p in j_params.items():
            np.testing.assert_allclose(res[0][step][1][name], p, atol=1e-5,
                                       rtol=0, err_msg=name)
