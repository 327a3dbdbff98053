"""Sharding plans in the port (paddle_tpu_torch/parallel/plan.py and
sharding.py) against the JAX package's, float32.

- Spec resolution, port against JAX on the same named shapes: the five
  cases of tests/test_sharding_plan.py ``TestSpecResolution``, the batch
  sharding's degenerate axes, ``infer_param_spec`` with
  ``transformer_tp_rules`` on BERT tiny and GPT tiny, and
  ``OptStateRules.spec_for``. The JAX ``Plan`` runs on the 8-device CPU
  sim; the port's on a layout-only mesh (no process group).
- ``compile_step``'s selection and labels, ``describe``, the typed
  errors, ``host_init`` and the resharding guard.
- Training on 4 gloo ranks (tests/torch_world.py) against the JAX
  Trainer on the global batch, losses and parameters within 2e-5:
  MnistMLP under ``Plan(fsdp=4)`` (SGD) and under the pure data-parallel
  ``Plan(dp=4)`` (the shard_map regime), and BERT tiny under
  ``Trainer(mesh=dp4, opt_state_rules=zero_dp_rules(min_size=1024))``
  with Adam, the recipe of tests/test_tensor_parallel.py
  ``test_zero_opt_state_sharding_matches_single_device``; each rank's
  leaves hold their spec's share of the whole.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP_

import paddle_tpu as pt
import torch_world as W
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JPAR
from paddle_tpu.models import bert as JB
from paddle_tpu.models import gpt as JG
from paddle_tpu.models import mnist as JM
from paddle_tpu.models import transformer as JT
from paddle_tpu.parallel import plan as JPL
from paddle_tpu_torch.core import mesh as TM
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.core.sharding_types import PartitionSpec as TP_
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models import mnist as TMN
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.nn import transformer as TNT
from paddle_tpu_torch.parallel import plan as TPL
from paddle_tpu_torch.parallel import sharding as TS

BERT_CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                intermediate_size=128, max_position=128, dropout=0.0)
GPT_CFG = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
               num_kv_heads=2, intermediate_size=256, max_position=128)
MNIST = dict(hidden1=64, hidden2=32)
# NMTConfig.tiny()'s widths at one layer a side: the (128, 64)
# positional table is a buffer past min_shard_size
NMT_CFG = dict(src_vocab=512, tgt_vocab=512, d_model=64, num_heads=4,
               num_encoder_layers=1, num_decoder_layers=1,
               dim_feedforward=128, dropout=0.0, max_len=128)


def _t(spec):
    """A spec of either package as a plain tuple."""
    return None if spec is None else tuple(spec)


def _rules(rules, P):
    return [(pat, P(*spec)) for pat, spec in rules]


# --- spec resolution ---------------------------------------------------------

SPEC_RULES = [(r"\.weight$", (None, "fsdp"))]


def _plans(**kw):
    kw.setdefault("min_shard_size", 1)
    j = JPL.Plan(dp=1, fsdp=4, tp=1, rules=_rules(SPEC_RULES, JP_),
                 params={"fc1.weight": JP_("fsdp", None)},
                 devices=jax.devices()[:4], **kw)
    t = TPL.Plan(dp=1, fsdp=4, tp=1, rules=_rules(SPEC_RULES, TP_),
                 params={"fc1.weight": TP_("fsdp", None)}, **kw)
    return j, t


@pytest.mark.parametrize("name,shape,kw", [
    ("fc1.weight", (8, 8), {}),                 # explicit beats pattern
    ("fc2.weight", (8, 8), {}),                 # pattern beats default
    ("opt.m", (4, 16), {}),                     # the largest divisible dim
    ("bias", (8,), {}),
    ("odd.weight", (8, 6), {}),                 # undivisible rule: default
    ("tiny", (2, 3), {"min_shard_size": 1024}),  # small: replicated
    ("small.bias", (8,), {"min_shard_size": 1024}),
], ids=["explicit", "pattern", "default-2d", "default-1d", "undivisible",
        "small", "small-bias"])
def test_spec_for_matches_jax(eight_devices, name, shape, kw):
    j, t = _plans(**kw)
    leaf = np.zeros(shape, np.float32)
    assert _t(t.spec_for(name, leaf)) == _t(j.spec_for(name, leaf))
    assert _t(t.requested_spec(name)) == _t(j.requested_spec(name))


@pytest.mark.parametrize("sizes", [dict(fsdp=8), dict(dp=8),
                                   dict(dp=2, fsdp=4)])
def test_batch_sharding_drops_degenerate_axes(eight_devices, sizes):
    j = JPL.Plan(**sizes, devices=jax.devices()[:8])
    t = TPL.Plan(**sizes)
    assert _t(t.batch_sharding().spec) == _t(j.batch_sharding().spec)
    assert t.explicit == j.explicit and repr(t) == repr(j)


def _named_shapes(model):
    return {n: np.zeros(tuple(p.shape), np.float32)
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("which", ["bert", "gpt"])
@pytest.mark.parametrize("tp", [2, 4])
def test_infer_param_spec_matches_jax(which, tp):
    pt.seed(0)
    if which == "bert":
        shapes = _named_shapes(TB.BertForPretraining(
            TB.BertConfig(**BERT_CFG), device="cpu"))
    else:
        shapes = _named_shapes(TG.GPTForCausalLM(
            TG.GPTConfig(**GPT_CFG), device="cpu"))
    jmesh = pt.build_mesh(tp=tp, devices=jax.devices()[:tp])
    want = JPAR.infer_param_spec(shapes, JPAR.transformer_tp_rules(),
                                 mesh=jmesh)
    got = TS.infer_param_spec(shapes, TS.transformer_tp_rules(),
                              mesh=TM.build_mesh(tp=tp,
                                                 devices=range(tp),
                                                 device="cpu"))
    assert {k: _t(v) for k, v in got.items()} == \
        {k: _t(v) for k, v in want.items()}
    assert got, "the rules matched nothing"


@pytest.mark.parametrize("shape", [(4096,), (64, 64), (6, 1024), (3, 5),
                                   (2, 4096), (1023,)])
def test_opt_state_rules_spec_for_matches_jax(shape):
    leaf = np.zeros(shape, np.float32)
    jmesh = pt.build_mesh(dp=4, devices=jax.devices()[:4])
    want = JPAR.zero_dp_rules(min_size=1024).spec_for(leaf, jmesh)
    got = TS.zero_dp_rules(min_size=1024).spec_for(
        leaf, TM.build_mesh(dp=4, devices=range(4), device="cpu"))
    assert _t(got) == _t(want)


def test_transformer_tp_rules_are_the_jax_regexes():
    want = [(pat, _t(spec)) for pat, spec in JPAR.transformer_tp_rules()]
    got = [(pat, _t(spec)) for pat, spec in TS.transformer_tp_rules()]
    assert got == want


# --- compile_step, describe, typed errors ------------------------------------

@pytest.mark.parametrize("sizes,via", [
    (None, "jit"), (dict(dp=1), "jit"), (dict(dp=8), "shard_map"),
    (dict(dp=2, fsdp=4), "pjit"), (dict(tp=2), "pjit"),
])
def test_compile_step_selection_matches_jax(eight_devices, sizes, via):
    jplan = None if sizes is None else JPL.Plan(
        **sizes, devices=jax.devices()[:int(np.prod(list(sizes.values())))])
    tplan = None if sizes is None else TPL.Plan(**sizes)
    shardings = {}
    if jplan is not None and jplan.explicit:
        shardings = dict(in_shardings=(), out_shardings=())
    j = JPL.compile_step(jplan, lambda s, b: s, **shardings)
    t = TPL.compile_step(tplan, lambda s, b: s, **shardings)
    assert t.compiled_via == j.compiled_via == via
    assert TPL.pmean_axes(tplan) == JPL.pmean_axes(jplan)


def test_explicit_compile_requires_shardings():
    with pytest.raises(EnforceError, match="in_shardings"):
        TPL.compile_step(TPL.Plan(dp=2, fsdp=4), lambda s, b: s)


def test_trainer_selects_as_the_jax_trainer(eight_devices):
    pt.seed(0)
    model = TMN.MnistMLP(**MNIST, device="cpu")
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.parallel import Trainer

    t = Trainer.supervised(model, TO.SGD(0.1), TMN.loss_fn)
    assert t._jit_step.compiled_via == "jit"
    with pytest.raises(EnforceError, match="plan subsumes"):
        Trainer.supervised(TMN.MnistMLP(**MNIST, device="cpu"),
                           TO.SGD(0.1), TMN.loss_fn, plan=TPL.Plan(dp=8),
                           param_spec={"fc1.weight": TP_()})
    # grad_compression is ported (tests/test_torch_quant_comm.py): the
    # plan keeps a valid mode and refuses another, as the JAX plan
    assert TPL.Plan(dp=2, grad_compression="int8").grad_compression == \
        JPL.Plan(dp=2, grad_compression="int8",
                 devices=jax.devices()[:2]).grad_compression == "int8"
    with pytest.raises(EnforceError, match="grad_compression"):
        TPL.Plan(dp=2, grad_compression="int4")


def test_describe_matches_jax(eight_devices):
    pt.seed(0)
    jm = JM.MnistMLP(**MNIST)
    jplan = JPL.Plan(dp=2, fsdp=4, min_shard_size=64,
                     devices=jax.devices()[:8])
    tplan = TPL.Plan(dp=2, fsdp=4, min_shard_size=64)
    shapes = {k: np.asarray(v) for k, v in jm.named_parameters().items()}
    want, got = jplan.describe(shapes), tplan.describe(shapes)
    want.pop("audit")
    assert got == want


def test_host_init_builds_on_the_cpu_and_place_cuts_shards():
    with TPL.host_init():
        model = TMN.MnistMLP(**MNIST)
    assert all(p.device.type == "cpu" for p in model.parameters())
    plan = TPL.Plan(fsdp=4, min_shard_size=64)
    whole = model.fc1.weight.detach().clone()
    placed = plan.place(dict(model.named_parameters()))
    w = placed["fc1.weight"]
    assert _t(TS.sharding_of(w).spec) == ("fsdp", None)
    assert tuple(w.shape) == (784 // 4, 64)
    assert w._pt_global_shape == (784, 64)
    torch.testing.assert_close(w.detach(), whole[:196])     # rank 0
    assert TPL.device_bytes({"w": w}) == {0: 196 * 64 * 4}


def test_state_shardings_and_sharded_checkpoints(eight_devices, tmp_path):
    """``state_shardings`` names each leaf's layout as the JAX trainer's
    does. A checkpoint of shards is written per host by every rank of
    the plan's process group (tests/test_torch_multihost_ckpt.py); here
    the plan's 4 ranks are a layout with no process group behind it, so
    no rank would write the other regions, and the save says so."""
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.parallel import Trainer

    pt.seed(0)
    jm = JM.MnistMLP(**MNIST)
    jt = JPAR.Trainer.supervised(jm, JO.Adam(1e-3), JM.loss_fn,
                                 plan=JPL.Plan(fsdp=4, min_shard_size=64,
                                               devices=jax.devices()[:4]))
    tt = Trainer.supervised(TMN.MnistMLP(**MNIST, device="cpu"),
                            TO.Adam(1e-3), TMN.loss_fn,
                            plan=TPL.Plan(fsdp=4, min_shard_size=64))
    want, got = jt.state_shardings(), tt.state_shardings()
    for name, sh in want["params"].items():
        assert _t(got["params"][name].spec) == _t(sh.spec), name
    for j_slot, t_slot in zip(want["opt_state"]["leaf"],
                              got["opt_state"]["leaf"]):
        assert {k: _t(v.spec) for k, v in t_slot.items()} == \
            {k: _t(v.spec) for k, v in j_slot.items()}
    with pytest.raises(EnforceError, match="no process group"):
        tt.save_checkpoint(str(tmp_path / "ck"))


def test_buffers_replicate_unless_a_rule_names_them():
    """``place(buffers=True)`` skips the fsdp default tier: a layer may
    read a buffer whole (a positional table by row); a rule still cuts
    the buffer it names."""
    pe = TNT.PositionalEncoding(64, max_len=128, device="cpu").pe
    whole = pe.detach().clone()
    plan = TPL.Plan(fsdp=4)
    assert plan.spec_for("pos_enc.pe", pe) == TP_("fsdp", None)
    plan.place({"pos_enc.pe": pe}, buffers=True)
    assert TS.sharding_of(pe) is None
    torch.testing.assert_close(pe, whole)
    ruled = TPL.Plan(fsdp=4, rules=[(r"pe$", TP_(None, "fsdp"))])
    cut = TNT.PositionalEncoding(64, max_len=128, device="cpu").pe
    ruled.place({"pos_enc.pe": cut}, buffers=True)
    assert _t(TS.sharding_of(cut).spec) == (None, "fsdp")
    assert tuple(cut.shape) == (128, 16)


@pytest.mark.parametrize("drift", ["whole", "resharded", "recut"])
def test_guard_no_resharding_catches_a_leaf_out_of_its_layout(drift):
    """A placed leaf whose local shape or sharding changed inside the
    guard raises; its siblings left alone keep it quiet."""
    plan = TPL.Plan(fsdp=4, min_shard_size=64)
    leaves = {"a": torch.arange(256.0).reshape(16, 16),
              "b": torch.arange(256.0).reshape(16, 16)}
    whole = leaves["a"].detach().clone()
    plan.place(leaves)
    with TPL.guard_no_resharding():
        leaves["b"].mul_(2.0)                    # in place: same layout
    a = leaves["a"]
    with pytest.raises(EnforceError, match="1 placed leaves out"):
        with TPL.guard_no_resharding():
            if drift == "whole":
                a.data = whole.clone()
            elif drift == "resharded":
                a._pt_sharding = plan.replicated()
            else:
                a.data = a.data[:2].clone()


def test_guard_no_resharding_counts_constraint_copies():
    x = torch.arange(8.0)
    m = TM.build_mesh(dp=1, devices=[0], device="cpu")
    with TPL.guard_no_resharding():
        assert TS.constraint(x, TP_(), mesh=m) is x
    plan = TPL.Plan(fsdp=4)
    with pytest.raises(EnforceError, match="resharding"):
        with TPL.guard_no_resharding():
            TS.constraint(x, TP_("fsdp"), mesh=plan.mesh)


# --- training on 4 gloo ranks ------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


def _state(model):
    return {k: np.asarray(v) for k, v in model.named_parameters().items()}


def _jax_steps(jt, batch, steps):
    out = []
    for _ in range(steps):
        loss, _ = jt.train_step(batch)
        out.append((float(loss), {k: np.asarray(v)
                                  for k, v in jt.params.items()}))
    return out


def check_against(res, want, tol=2e-5):
    """Every rank's losses and rank 0's whole parameters after each
    step against the JAX Trainer's."""
    for step, (j_loss, j_params) in enumerate(want):
        for rank in range(len(res)):
            np.testing.assert_allclose(res[rank]["steps"][step][0], j_loss,
                                       atol=tol, rtol=0)
        got = res[0]["steps"][step][1]
        assert set(got) == set(j_params)
        for name, p in j_params.items():
            np.testing.assert_allclose(got[name], p, atol=tol, rtol=0,
                                       err_msg=name)


def check_layout(res, plan):
    """Each rank's leaves: the whole shape over the spec's ranks, and
    the spec the JAX plan resolves for the same name and shape."""
    for r in res:
        for name, (local, whole, spec, n) in r["layout"].items():
            assert int(np.prod(local)) * n == int(np.prod(whole)), name
            want = plan.spec_for(name, np.zeros(whole, np.float32))
            assert spec == (None if want == JP_() else str(_t(want))), name


def _mnist_batch(seed, b=16):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(b, 784)).astype(np.float32),
            "label": rng.integers(0, 10, b).astype(np.int32)}


@pytest.mark.parametrize("sizes,via", [(dict(fsdp=4), "pjit"),
                                       (dict(dp=4), "shard_map")])
def test_mnist_plan_matches_jax_trainer(world, sizes, via):
    pt.seed(7)
    jm = JM.MnistMLP(**MNIST)
    state = _state(jm)
    batch = _mnist_batch(8)
    jplan = JPL.Plan(**sizes, devices=jax.devices()[:4])
    jt = JPAR.Trainer.supervised(jm, JO.SGD(0.5), JM.loss_fn, plan=jplan)
    assert jt._jit_step.compiled_via == via
    want = _jax_steps(jt, {k: jnp.asarray(v) for k, v in batch.items()}, 2)
    res = world.run(W.job_plan_trainer, "mnist", MNIST, state, batch, 2,
                    ("SGD", 0.5), plan=sizes)
    assert all(r["via"] == via for r in res)
    check_against(res, want)
    check_layout(res, jplan)
    if via == "pjit":
        # fc1 (784 x 64) and fc2 (64 x 32) are sharded over fsdp, and
        # their SGD-free moments follow; the rank holds a quarter
        assert res[1]["layout"]["fc1.weight"][:3] == (
            (196, 64), (784, 64), "('fsdp', None)")


def _nmt_batch(seed, b=4, ts=16, tt=12, vocab=512):
    """A padded source tail in row 1 and a fully padded source row 2;
    a few pad labels, which the loss ignores."""
    rng = np.random.default_rng(seed)
    src = rng.integers(3, vocab, (b, ts))
    src[1, ts // 2:] = 2
    src[2, :] = 2
    labels = rng.integers(3, vocab, (b, tt))
    labels[0, -3:] = 2
    return {"src": src.astype(np.int32),
            "tgt": rng.integers(3, vocab, (b, tt)).astype(np.int32),
            "labels": labels.astype(np.int32)}


def test_nmt_buffers_stay_whole_under_fsdp(world):
    """TransformerNMT under ``Plan(dp=2, fsdp=2)``: its positional table
    (a buffer of 8192 entries) stays whole on every rank, so each rank
    adds the positions of its own rows; losses and parameters within
    2e-5 of the JAX Trainer's on the global batch."""
    pt.seed(31)
    jm = JT.TransformerNMT(JT.NMTConfig(**NMT_CFG))
    state = _state(jm)
    batch = _nmt_batch(32)
    jplan = JPL.Plan(dp=2, fsdp=2, devices=jax.devices()[:4])
    pe = np.asarray(jm.named_buffers()["pos_enc.pe"])

    def jbuild(params, buffers, rng, b):
        out, nb = jm.functional_call(
            params, b["src"], b["tgt"], b["labels"], buffers=buffers,
            rng=rng, training=rng is not None, vocab_chunk=96,
            method="forward_fused_loss")
        return out, ({}, nb)

    jt = JPAR.Trainer(jm, JO.SGD(0.5), jbuild, plan=jplan)
    want = _jax_steps(jt, {k: jnp.asarray(v) for k, v in batch.items()}, 2)
    res = world.run(W.job_plan_trainer, "nmt", NMT_CFG, state, batch, 2,
                    ("SGD", 0.5), plan=dict(dp=2, fsdp=2))
    check_against(res, want)
    check_layout(res, jplan)
    for r in res:
        np.testing.assert_array_equal(r["buffers"]["pos_enc.pe"], pe)


def _bert_batch(seed, b=4, t=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 512, (b, t)).astype(np.int32)
    mlm = np.where(rng.random((b, t)) < 0.15, ids, -100).astype(np.int32)
    return {"x": ids, "label": {"mlm_labels": mlm,
                                "nsp_label": rng.integers(0, 2, (b,))
                                .astype(np.int32)}}


@pytest.mark.parametrize("opt", [("Adam", 1e-3), ("Momentum", 0.5, 0.9)],
                         ids=["adam", "momentum"])
def test_zero_moments_match_jax_trainer(world, opt):
    """Adam is the JAX test's recipe; its losses are held here. Its
    parameters are not: the key projection's bias has a gradient of zero
    in exact arithmetic (a constant added to a row's scores), and Adam
    scales that rounding noise up to +-lr. Momentum's velocity, sharded
    as Adam's moments are, keeps the parameters within 2e-5."""
    pt.seed(42)
    jm = JB.BertForPretraining(JB.BertConfig(**BERT_CFG))
    state = _state(jm)
    batch = _bert_batch(43)
    jmesh = pt.build_mesh(dp=4, devices=jax.devices()[:4])
    rules = JPAR.zero_dp_rules(min_size=1024)
    jt = JPAR.Trainer.supervised(jm, getattr(JO, opt[0])(*opt[1:]),
                                 JB.pretrain_loss, mesh=jmesh,
                                 opt_state_rules=rules)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    want = _jax_steps(jt, jbatch, 2)
    res = world.run(W.job_plan_trainer, "bert", BERT_CFG, state, batch, 2,
                    opt, mesh_sizes=dict(dp=4), zero=1024)
    if opt[0] == "Adam":
        for step, (j_loss, _) in enumerate(want):
            for r in res:
                np.testing.assert_allclose(r["steps"][step][0], j_loss,
                                           atol=2e-5, rtol=0)
    else:
        check_against(res, want)
    # the moments of every leaf of at least 1024 entries are the rank's
    # quarter along their first divisible dim, as the JAX rules place
    # them; the parameters stay whole
    names = sorted(state)
    sharded = 0
    for name, slots in zip(names, res[2]["moments"]):
        want_spec = rules.spec_for(state[name], jmesh)
        for _, spec, shape in slots:
            assert spec == (None if want_spec is None
                            else str(_t(want_spec))), name
            if spec is not None:
                sharded += 1
                assert int(np.prod(shape)) * 4 == state[name].size
    assert sharded >= 2
    assert all(spec is None for _, _, spec, _ in res[0]["layout"].values())


@pytest.mark.parametrize("inf_rank", [None, 2], ids=["finite", "rank2-inf"])
def test_fp16_step_skips_on_every_rank_or_none(world, inf_rank):
    """A rank sees its shards' grads only: one rank's non-finite shard
    must skip the step, and move the loss scale, on every rank."""
    res = world.run(W.job_fp16_skip_agrees, inf_rank)
    assert {r for r in res} == {(inf_rank is None,
                                 8.0 if inf_rank is None else 4.0)}
