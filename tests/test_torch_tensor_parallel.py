"""Tensor parallelism in the port against the JAX package, float32, on 4
gloo ranks (tests/torch_world.py) against the JAX Trainer under the same
plan on 4 devices of the CPU sim (GSPMD: the global batch, one program):

- BERT tiny under ``Plan(fsdp=2, tp=2, rules=transformer_tp_rules())``:
  attention and FFN compute on the rank's heads and columns, the rest
  gathers at use; losses and whole parameters after each of two SGD
  steps within 2e-5, every leaf the spec's share of the whole.
- GPT tiny (4 q heads, 2 kv heads) under ``Plan(dp=2, tp=2)`` (2 q heads
  and 1 kv head a rank, SwiGLU's gate/up columns and down rows) and
  under ``Plan(tp=4)``, where tp divides no kv head count: attention
  falls back to gather at use (counted, 2 layers x 2 steps a rank),
  SwiGLU stays local.
- Dropout: a tp rank draws the unsharded layer's masks (attention seeds
  of its heads, its columns of the FFN mask, the residual masks whole),
  so GPT tiny and BERT tiny with dropout on train under ``Plan(tp=4)``
  (one head a rank) as without a mesh from the same seed; and under
  ``build_mesh(dp=2, tp=2)`` the layer masks differ across dp ranks,
  keep the rate within binomial bounds and are bit-equal across the tp
  ranks of a group, while a one-rank mesh draws today's masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import torch_world as W
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JPAR
from paddle_tpu.models import bert as JB
from paddle_tpu.models import gpt as JG
from paddle_tpu.parallel import plan as JPL
from test_torch_plan import (BERT_CFG, GPT_CFG, _bert_batch, _jax_steps,
                             _state, check_against, check_layout)

CHUNK = 96


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


def _jplan(**sizes):
    n = int(np.prod(list(sizes.values())))
    return JPL.Plan(**sizes, rules=JPAR.transformer_tp_rules(),
                    devices=jax.devices()[:n])


def test_bert_fsdp_tp_matches_jax_trainer(world):
    pt.seed(21)
    jm = JB.BertForPretraining(JB.BertConfig(**BERT_CFG))
    state = _state(jm)
    batch = _bert_batch(22)
    jplan = _jplan(fsdp=2, tp=2)
    jt = JPAR.Trainer.supervised(jm, JO.SGD(0.5), JB.pretrain_loss,
                                 plan=jplan)
    want = _jax_steps(jt, jax.tree_util.tree_map(jnp.asarray, batch), 2)
    res = world.run(W.job_plan_trainer, "bert", BERT_CFG, state, batch, 2,
                    ("SGD", 0.5), plan=dict(fsdp=2, tp=2, rules="tp"))
    check_against(res, want)
    check_layout(res, jplan)
    assert all(r["fallbacks"] == {} and r["via"] == "pjit" for r in res)
    layout = res[3]["layout"]
    q = layout["bert.encoder.layers.0.self_attn.q_proj.weight"]
    assert q[:3] == ((64, 32), (64, 64), "(None, 'tp')")


def _gpt_trainer(jm, opt, plan):
    def loss_builder(params, buffers, rng, batch):
        out, nb = jm.functional_call(params, batch, buffers=buffers,
                                     rng=rng, training=rng is not None,
                                     vocab_chunk=CHUNK,
                                     method="forward_loss")
        return out, ({}, nb)

    return JPAR.Trainer(jm, opt, loss_builder, plan=plan)


def _ids(seed, b=4, t=64):
    return np.random.default_rng(seed).integers(1, 512, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize("sizes,fallbacks", [
    (dict(dp=2, tp=2), {}),
    (dict(tp=4), {"MultiHeadAttention": 4}),
], ids=["dp2-tp2", "tp4-fallback"])
def test_gpt_tp_matches_jax_trainer(world, sizes, fallbacks):
    pt.seed(23)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**GPT_CFG))
    state = _state(jm)
    ids = _ids(24)
    jplan = _jplan(**sizes)
    want = _jax_steps(_gpt_trainer(jm, JO.SGD(0.5), jplan), jnp.asarray(ids),
                      2)
    res = world.run(W.job_plan_trainer, "gpt", GPT_CFG, state, ids, 2,
                    ("SGD", 0.5), plan=dict(**sizes, rules="tp"))
    check_against(res, want)
    check_layout(res, jplan)
    assert all(r["fallbacks"] == fallbacks for r in res)


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_tp_rank_draws_the_unsharded_masks(world, kind):
    """tp=4 over 4 heads: one head a rank (GPT's 4 kv heads too)."""
    pt.seed(25)
    if kind == "gpt":
        cfg = dict(GPT_CFG, num_kv_heads=4, dropout=0.1)
        jm = JG.GPTForCausalLM(JG.GPTConfig(**cfg))
        batch = _ids(26)
    else:
        cfg = dict(BERT_CFG, dropout=0.1)
        jm = JB.BertForPretraining(JB.BertConfig(**cfg))
        batch = _bert_batch(26)
    res = world.run(W.job_tp_against_whole, kind, cfg, _state(jm), batch,
                    dict(tp=4, rules="tp"), 2, ("SGD", 0.5), 27)
    for (sharded, whole) in res:
        np.testing.assert_allclose(sharded[0], whole[0], atol=2e-6, rtol=0)
        for name, p in whole[1].items():
            np.testing.assert_allclose(sharded[1][name], p, atol=2e-6,
                                       rtol=0, err_msg=name)
        # dropout is on: two steps from one batch differ
        assert sharded[0][0] != sharded[0][1]


def test_dropout_masks_differ_over_dp_and_agree_over_tp(world):
    res = world.run(W.job_dropout_masks, dict(dp=2, tp=2), 2)
    by = {(c["dp"], c["tp"]): masks for c, masks in res}
    for step in range(2):
        for dp in range(2):
            np.testing.assert_array_equal(by[dp, 0][step], by[dp, 1][step])
        assert (by[0, 0][step] != by[1, 0][step]).mean() > 0.3
        for masks in by.values():
            # 4096 draws at p = 0.5: 6 standard deviations is 0.047
            assert abs(masks[step].mean() - 0.5) < 0.047
    assert (by[0, 0][0] != by[0, 0][1]).any()


def test_one_rank_mesh_keeps_todays_masks():
    import torch

    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.core import mesh as TM
    from paddle_tpu_torch.core.random import seed as set_seed
    from paddle_tpu_torch.parallel import Trainer

    masks = []
    for mesh in (None, TM.build_mesh(dp=1, devices=[0], device="cpu")):
        set_seed(3)
        drop = tnn.Dropout(0.5)
        tt = Trainer(tnn.Linear(8, 1, device="cpu"), TO.SGD(0.0),
                     lambda m, b, g: (m(drop(torch.ones(4, 8))).sum(), {
                         "keep": drop(torch.ones(64, 64)) != 0}), mesh=mesh)
        masks.append(tt.train_step(None)[1]["keep"].numpy())
    np.testing.assert_array_equal(masks[0], masks[1])
