"""Composed dp x tp x pp steps in the port (paddle_tpu_torch/parallel/
hybrid.py) against the JAX package's builders, float32, on 4 gloo ranks
(tests/torch_world.py, the jobs in tests/torch_pipeline_jobs.py) and a
4-device submesh of the CPU sim (the JAX steps jitted).

Each case runs the JAX builder's step twice and the port's on the same
weights (``utils.convert.hybrid_params``; the transformer builder draws
the JAX builder's numpy weights itself) and batch (the JAX feed's
numpy draws, each dp rank's share of every microbatch):

- losses within 1e-5 relative;
- after each step, every parameter reassembled from the shards within
  1e-5 of the leaf's largest JAX entry, at least 1e-2 (float32 sums over
  tp and the microbatches in another order; the floor for k_proj.bias,
  zero at the start with a zero gradient in exact arithmetic);
- the leaves that replicate over pp (the embedding, the final norm, the
  heads) bit-equal on the pp ranks of each (dp, tp) coordinate: the
  pipeline's input gradient reaches every pp rank;
- the port's ``ref_step`` (the sequential fold) within the same bounds
  of its pipelined step.

Configurations: GPipe on dp=1 x pp=2 x tp=2 and the interleaved
schedule (v=2) on dp=2 x pp=2 for GPT; GPipe on dp=1 x pp=2 x tp=2 for
BERT and for BERT with Switch-MoE blocks over pp=2 x ep=2 (the JAX MoE
test's composition at 4 ranks); the transformer builder on both meshes.
A GPT at head dim 64 runs the flash entry points (their plain versions
on the CPU) at the tp rank's heads, as many calls as the schedule and
remat imply."""

import dataclasses

import jax
import numpy as np
import pytest

import paddle_tpu as pt
import torch_pipeline_jobs as PJ
import torch_world as W
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.parallel import hybrid as JH

RTOL = 1e-5
PTOL = 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_steps(kind, sizes, kw, steps=2):
    """The JAX builder's params (numpy) and its (loss, params) after each
    of ``steps`` jitted steps, flattened as the job flattens them."""
    mesh = pt.build_mesh(**sizes, devices=jax.devices()[:4])
    build = {"transformer": JH.build_hybrid_transformer_step,
             "bert": JH.build_bert_hybrid_step,
             "gpt": JH.build_gpt_hybrid_step}[kind]
    if kind == "transformer":
        step, params, feed = build(mesh, **kw)
    else:
        step, _, params, feed = build(mesh, **kw)
    js = jax.jit(step)
    out, p = [], params
    for _ in range(steps):
        loss, p = js(p, *feed)
        flat = _np(p) if kind == "transformer" else {
            f"{g}/{k}": np.asarray(v) for g in p for k, v in p[g].items()}
        out.append((float(loss), flat))
    return _np(params), out


def _close(got, want, what):
    for k, w in want.items():
        # the floor: an attention's k_proj.bias starts at zero and has a
        # zero gradient in exact arithmetic, so its largest entry is
        # rounding noise of either package
        scale = max(float(np.abs(w).max()), 1e-2)
        err = float(np.abs(got[k] - w).max()) / scale
        assert err <= PTOL, (what, k, err)


def _check_pp_replicas(res):
    """The unsharded leaves of ranks that differ only in pp are equal."""
    by = {}
    for r in res:
        c = dict(r["coordinate"])
        c.pop("pp")
        key = tuple(sorted(c.items()))
        if key in by:
            for k, v in r["rest"].items():
                np.testing.assert_array_equal(v, by[key][k], err_msg=k)
        else:
            by[key] = r["rest"]


CASES = [
    ("transformer", dict(dp=1, pp=2, tp=2), {}),
    ("transformer", dict(dp=2, pp=2), {}),
    ("gpt", dict(dp=1, pp=2, tp=2), {}),
    ("gpt", dict(dp=2, pp=2), dict(pipeline_schedule="interleaved",
                                   virtual_stages=2)),
    ("bert", dict(dp=1, pp=2, tp=2), {}),
    ("bert_moe", dict(pp=2, ep=2), dict(seq_len=32)),
]


@pytest.mark.parametrize("kind,sizes,kw", CASES, ids=[
    f"{c[0]}-{'x'.join(f'{k}{s}' for k, s in c[1].items())}"
    f"{'-' + c[2]['pipeline_schedule'] if 'pipeline_schedule' in c[2] else ''}"
    for c in CASES])
def test_hybrid_step_matches_jax(world, kind, sizes, kw):
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if kind == "bert_moe":
        kind = "bert"
        jcfg = JBertConfig.moe_smoke(2)
        jkw["cfg"] = jcfg
        tkw["cfg"] = dataclasses.asdict(jcfg)
    arrays, want = _jax_steps(kind, sizes, jkw)
    res = world.run(PJ.job_hybrid, kind, sizes, tkw,
                    arrays=None if kind == "transformer" else arrays)
    if kind == "transformer":
        # the port draws the JAX builder's weights itself
        got0 = res[0]["init"]
        for k, v in arrays.items():
            np.testing.assert_array_equal(got0[k], v)
    for step, (loss, params) in enumerate(want):
        for r in res:
            np.testing.assert_allclose(r["steps"][step][0], loss,
                                       rtol=RTOL)
        _close(res[0]["steps"][step][1], params, f"step {step}")
    if kind != "transformer":
        _check_pp_replicas(res)
        ref_loss, ref_params = res[0]["ref"]
        np.testing.assert_allclose(ref_loss, want[0][0], rtol=RTOL)
        _close(ref_params, want[0][1], "ref_step")


@pytest.mark.parametrize("schedule,v", [("gpipe", 1), ("interleaved", 2)])
def test_gpt_flash_calls_at_the_tp_heads(world, schedule, v):
    """GPT at head dim 64 (hidden 128, 2 q heads, 2 kv heads, 4 layers,
    T=64, B=4, 2 microbatches) under dp=1 x pp=2 x tp=2 with the flash
    entry points: every call at (1, 1) heads a rank; per step a rank runs
    each of its layers once per microbatch, the forward twice (remat's
    recompute): 2 x 2 x 2 forward, 2 x 2 dq and dk/dv calls; losses and
    parameters as its ref_step's."""
    cfg = dict(vocab_size=256, hidden_size=128, num_layers=4, num_heads=2,
               num_kv_heads=2, intermediate_size=256, max_position=64)
    kw = dict(cfg=cfg, batch=4, seq_len=64, num_microbatches=2,
              pipeline_schedule=schedule, virtual_stages=v)
    res = world.run(PJ.job_hybrid, "gpt", dict(dp=1, pp=2, tp=2), kw,
                    steps=1, flash=True)
    per_rank = (cfg["num_layers"] // 2) * kw["num_microbatches"]
    for r in res:
        assert {tuple(h) for _, *h in r["calls"]} == {(1, 1)}
        assert r["n_calls_step"] == dict(fwd=2 * per_rank, dq=per_rank,
                                         dkv=per_rank)
        np.testing.assert_allclose(r["ref"][0], r["steps"][0][0],
                                   rtol=RTOL)
    _close(res[0]["ref"][1], res[0]["steps"][0][1], "ref_step")


def test_trainer_on_a_pp_mesh_trains_pp_replicas(world):
    """Trainer(mesh=build_mesh(dp=2, pp=2)) without a pipeline, as the
    JAX Trainer on such a mesh: the batch cut over dp only, the pp ranks
    replicas that reduce nothing over pp; MnistMLP(64, 32), SGD(0.5), 2
    steps: losses and parameters within 2e-5 of the JAX Trainer's, every
    rank the same losses."""
    import jax.numpy as jnp

    from paddle_tpu import optimizer as JO
    from paddle_tpu import parallel as JPAR
    from paddle_tpu.models import mnist as JM
    from test_torch_plan import (MNIST, _jax_steps, _mnist_batch, _state,
                                 check_against)

    pt.seed(17)
    jm = JM.MnistMLP(**MNIST)
    state = _state(jm)
    batch = _mnist_batch(18)
    jt = JPAR.Trainer.supervised(jm, JO.SGD(0.5), JM.loss_fn,
                                 mesh=pt.build_mesh(
                                     dp=2, pp=2, devices=jax.devices()[:4]))
    want = _jax_steps(jt, {k: jnp.asarray(v) for k, v in batch.items()}, 2)
    res = world.run(W.job_plan_trainer, "mnist", MNIST, state, batch, 2,
                    ("SGD", 0.5), mesh_sizes=dict(dp=2, pp=2))
    check_against(res, want)
    for r in res[1:]:
        assert [s[0] for s in r["steps"]] == [s[0] for s in res[0]["steps"]]
