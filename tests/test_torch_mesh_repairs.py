"""What a model computes from its batch under a mesh is the global
batch's, as the JAX Trainer without a plan takes it (GSPMD), float32, on
4 gloo ranks (tests/torch_world.py) against the JAX package:

- BatchNorm: a Linear -> BatchNorm -> ReLU -> Linear net, two SGD steps
  of ``Trainer.supervised(mesh=build_mesh(dp=4))`` against the JAX
  Trainer on the global batch: the losses, the parameters and both
  running buffers within 1e-5, and the buffers equal on every rank.
  Under the pure data-parallel ``Plan(dp=4)`` (the JAX package's
  shard_map regime) each rank normalises with its own rows and the
  buffers are averaged, as the JAX plan's are.
- Switch-MoE routing: GPT tiny with 4 experts at capacity factor 1.0
  (an expert crowded past capacity: the JAX run drops tokens),
  ``forward_loss`` and its gradients on dp=2 x sp=2 (ring) against
  JAX's on the global batch: the loss, the gradients' mean over the mesh
  within 1e-5 of each parameter's largest entry, and every block's aux,
  z and kept terms as the JAX layer records them. And
  ``Trainer.supervised(aux_loss_weight=0.01, router_z_loss_weight=1e-3)``
  on dp=4, two SGD steps against the JAX Trainer.

The dropout masks are tests/test_torch_tensor_parallel.py's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import torch_world as W
from paddle_tpu import nn as JNN
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JPAR
from paddle_tpu.core.mesh import mesh_scope
from paddle_tpu.models import gpt as JG
from paddle_tpu.models import mnist as JM
from paddle_tpu.parallel import plan as JPL
from test_torch_plan import _jax_steps, _state, check_against

MOE_CFG = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
               num_kv_heads=2, intermediate_size=256, max_position=128,
               moe_experts=4, moe_capacity_factor=1.0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


@functools.lru_cache(maxsize=None)
def _jmesh(dp, sp):
    return pt.build_mesh(dp=dp, sp=sp, devices=jax.devices()[:dp * sp])


class JBNNet(JNN.Layer):
    """tests/torch_world.py ``BNNet`` in the JAX package."""

    def __init__(self):
        super().__init__()
        self.fc = JNN.Linear(8, 6)
        self.bn = JNN.BatchNorm(6)
        self.head = JNN.Linear(6, 3)

    def forward(self, x):
        return self.head(jax.nn.relu(self.bn(self.fc(x))))


@pytest.mark.parametrize("regime", ["mesh", "plan"])
def test_batch_norm_takes_the_global_batch(world, regime):
    pt.seed(31)
    jm = JBNNet()
    state = _state(jm)
    rng = np.random.default_rng(32)
    # rows of different scales on each rank: per-rank statistics differ
    x = (rng.normal(size=(16, 8)) * np.repeat([0.5, 1, 2, 4], 4)[:, None]
         + np.repeat([0, 1, -1, 3], 4)[:, None]).astype(np.float32)
    batch = {"x": x, "label": rng.integers(0, 3, 16).astype(np.int32)}
    if regime == "mesh":
        jt = JPAR.Trainer.supervised(jm, JO.SGD(0.5), JM.loss_fn,
                                     mesh=_jmesh(4, 1))
        kw = dict(mesh_sizes=dict(dp=4))
    else:
        jplan = JPL.Plan(dp=4, devices=jax.devices()[:4])
        jt = JPAR.Trainer.supervised(jm, JO.SGD(0.5), JM.loss_fn,
                                     plan=jplan)
        kw = dict(plan=dict(dp=4))
    with mesh_scope(jt.mesh):
        want = _jax_steps(jt, {k: jnp.asarray(v) for k, v in batch.items()},
                          2)
    res = world.run(W.job_plan_trainer, "bn", {}, state, batch, 2,
                    ("SGD", 0.5), **kw)
    check_against(res, want, tol=1e-5)
    for name in ("bn.mean", "bn.variance"):
        for r in res:
            np.testing.assert_array_equal(r["buffers"][name],
                                          res[0]["buffers"][name])
        np.testing.assert_allclose(res[0]["buffers"][name],
                                   np.asarray(jt.buffers[name]), atol=1e-5,
                                   rtol=0, err_msg=name)


def _moe_model(seed, **extra):
    pt.seed(seed)
    return JG.GPTForCausalLM(JG.GPTConfig(**MOE_CFG, **extra))


def test_moe_routes_the_global_batch(world):
    jm = _moe_model(33, seq_parallel="ring")
    state = _state(jm)
    ids = np.random.default_rng(34).integers(1, 512, (4, 64)).astype(
        np.int32)

    def jloss(p):
        return jm.functional_call(p, jnp.asarray(ids), training=True,
                                  vocab_chunk=96, method="forward_loss")

    with mesh_scope(_jmesh(2, 2)):
        (j_loss, j_bufs), j_grads = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(jm.named_parameters())
    kept = [float(j_bufs[f"blocks.{i}.ffn.kept_fraction"]) for i in (0, 1)]
    assert min(kept) < 1.0, kept          # an expert is crowded
    res = world.run(W.job_moe_seq, dict(dp=2, sp=2),
                    dict(MOE_CFG, seq_parallel="ring"), state, ids)
    for loss, _, terms in res:
        np.testing.assert_allclose(loss, float(j_loss), atol=1e-5, rtol=0)
        for i, (aux, z, k) in enumerate(terms):
            np.testing.assert_allclose(
                (aux, z, k), [float(j_bufs[f"blocks.{i}.ffn.{n}"]) for n in
                              ("aux_loss", "router_z_loss",
                               "kept_fraction")], atol=1e-5, rtol=1e-6)
    grads = res[0][1]
    for name, g in j_grads.items():
        g = np.asarray(g)
        scale = max(np.abs(g).max(), 0.1)
        np.testing.assert_allclose(grads[name] / scale, g / scale,
                                   atol=1e-5, rtol=0, err_msg=name)


def test_supervised_moe_aux_terms_under_dp(world):
    jm = _moe_model(35)
    state = _state(jm)
    ids = np.random.default_rng(36).integers(1, 512, (8, 32)).astype(
        np.int32)
    weights = dict(aux_loss_weight=0.01, router_z_loss_weight=1e-3)
    with mesh_scope(_jmesh(4, 1)):
        jt = JPAR.Trainer.supervised(jm, JO.SGD(0.5), JG.loss_fn,
                                     mesh=_jmesh(4, 1), **weights)
        want = _jax_steps(jt, {"x": jnp.asarray(ids),
                               "label": jnp.asarray(ids)}, 2)
    res = world.run(W.job_plan_trainer, "gpt_sup", MOE_CFG, state,
                    {"x": ids, "label": ids}, 2, ("SGD", 0.5),
                    mesh_sizes=dict(dp=4), aux=weights)
    check_against(res, want)
