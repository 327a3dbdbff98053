"""The port's Switch-MoE FFN (paddle_tpu_torch/nn/moe.py) and its wiring
(the MoE encoder, BERT, GPT trained and served, ``Trainer.supervised``'s
aux weights) against the JAX package's on the same weights and inputs
(numpy seeds), float32 on the CPU, the JAX side jitted:

- ``switch_moe`` at top-1 and top-2, at a capacity factor that drops
  tokens and one that drops none, and with a tie in the router
  probabilities: y, aux, z and kept, and the gradients of
  ``sum(y * cot) + aux + z`` to x and every weight;
- ``SwitchFFN`` and its buffers, the MoE encoder (and its
  ``scan_layers`` form, with and without remat, whose JAX scan drops the
  buffers),
  ``BertConfig.moe_smoke()``'s ``forward_fused_loss``, a tiny GPT-moe's
  ``forward_loss`` + 0.01 x aux with their gradients;
- ``Trainer.supervised(aux_loss_weight=, router_z_loss_weight=)`` for 12
  Adam steps against the JAX Trainer's losses;
- the serving arena: a tiny GPT-moe (4 experts, capacity factor 1.0, 4
  slots, 5 requests, so that ticks drop tokens) through the port's
  BatchedDecoder and the JAX one: every request's tokens and every
  call's kept fraction, the last of them the layers' final
  ``kept_fraction``.

Tolerances: outputs and losses 1e-5 (1e-4 through a whole model),
gradients 1e-5 of each parameter's largest JAX-gradient entry (1e-4
through a whole model; the key projections' biases, whose gradient is 0
in exact arithmetic, of the model's largest JAX-gradient entry); tokens exactly; kept fractions 1e-6 (an integer
count over the assignments: jitted XLA divides by a reciprocal, one
float32 rounding from the port's quotient)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JP
from paddle_tpu.models import bert as JB
from paddle_tpu.models import gpt as JG
from paddle_tpu.nn import moe as JM
from paddle_tpu.nn import transformer as JT
from paddle_tpu.ops import loss as JL
from paddle_tpu.serving import BatchedDecoder as JaxDecoder
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.core import InvalidArgumentError
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.nn import moe as TM
from paddle_tpu_torch.nn import transformer as TT
from paddle_tpu_torch.ops import loss as TL
from paddle_tpu_torch.parallel import Trainer
from paddle_tpu_torch.serving import BatchedDecoder
from paddle_tpu_torch.utils.convert import load_numpy_state

S, D, E, FF = 24, 16, 4, 32


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=what)


def _grads_close(got, want, rtol, names=None):
    top = max(np.abs(np.asarray(w)).max() for w in want.values())
    for k in names or want:
        w = np.asarray(want[k])
        # a key projection's bias has a gradient of 0 in exact
        # arithmetic: held to the largest gradient entry of the model
        scale = max(np.abs(w).max(), top if k.endswith("k_proj.bias")
                    else 1e-30)
        np.testing.assert_allclose(_np(got[k]) / scale, w / scale, rtol=0,
                                   atol=rtol, err_msg=k)


def _tgrads(model):
    return {k: torch.zeros_like(p) if p.grad is None else p.grad
            for k, p in model.named_parameters()}


def _state(jm):
    return {k: np.asarray(v) for k, v in {**jm.named_parameters(),
                                          **jm.named_buffers()}.items()}


def _moe_inputs(case):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(S, D)).astype(np.float32)
    router = rng.normal(size=(D, E)).astype(np.float32)
    if case == "tie":
        # experts 1 and 2 get equal logits and lead every token
        router[:, 2] = router[:, 1]
        router[:, 1:3] += 0.5 * np.sign(x.sum(0))[:, None]
    w = [rng.normal(size=s).astype(np.float32) * 0.3
         for s in ((E, D, FF), (E, FF), (E, FF, D), (E, D))]
    cot = rng.normal(size=(S, D)).astype(np.float32)
    return [x, router] + w + [cot]


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("case,cf", [("drops", 0.5), ("no_drops", 4.0),
                                     ("tie", 1.0)])
def test_switch_moe_matches_jax(top_k, case, cf):
    *args, cot = _moe_inputs(case)
    cap = max(1, int(np.ceil(S * top_k / E * cf)))

    def jf(*a):
        y, aux, z, kept = JM.switch_moe(*a, capacity=cap, top_k=top_k)
        return jnp.sum(y * cot) + aux + z, (y, aux, z, kept)

    (_, jout), jg = jax.jit(jax.value_and_grad(
        jf, argnums=tuple(range(6)), has_aux=True))(*map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    y, aux, z, kept = TM.switch_moe(*targs, capacity=cap, top_k=top_k)
    (torch.sum(y * torch.from_numpy(cot)) + aux + z).backward()
    for got, want, what in zip((y, aux, z), jout[:3], ("y", "aux", "z")):
        _close(got, want, 1e-5, what)
    _close(kept, jout[3], 1e-6, "kept")
    if case == "drops":
        assert float(kept) < 1.0
        dropped = ~np.asarray(jout[0]).any(-1)
        assert dropped.any() and not _np(y)[dropped].any()   # exact zeros
    elif case == "no_drops":
        assert float(kept) == 1.0
    names = ["x", "router_w", "w1", "b1", "w2", "b2"]
    _grads_close({n: t.grad for n, t in zip(names, targs)},
                 dict(zip(names, jg)), 1e-5)


def test_switch_ffn_and_its_buffers():
    pt.seed(0)
    jm = jnn.SwitchFFN(D, FF, E, capacity_factor=1.0)
    tm = TM.SwitchFFN(D, FF, E, capacity_factor=1.0, device="cpu")
    assert [n for n, _ in tm.named_parameters()] == list(
        jm.named_parameters())
    assert [n for n, _ in tm.named_buffers()] == list(jm.named_buffers())
    load_numpy_state(tm, _state(jm))
    assert tm.capacity(10) == jm.capacity(10) == 3
    x = np.random.default_rng(1).normal(size=(2, 12, D)).astype(np.float32)
    jy, jb = jm.functional_call(jm.named_parameters(), jnp.asarray(x))
    ty = tm(torch.from_numpy(x))
    _close(ty, jy, 1e-5)
    for k, v in tm.named_buffers():
        _close(v, jb[k], 1e-6, k)
    # a training forward's buffers carry the graph (loss + w * aux
    # trains the router); detach_buffers leaves plain values
    assert tm.aux_loss.requires_grad and tm.router_z_loss.requires_grad
    tm.aux_loss.backward()
    assert tm.router_w.grad.abs().max() > 0
    from paddle_tpu_torch.nn.layer import detach_buffers

    detach_buffers(tm)
    assert not any(b.requires_grad for b in tm.buffers())
    with torch.no_grad():
        tm(torch.from_numpy(x))
    assert not tm.aux_loss.requires_grad


ENC = dict(num_layers=2, d_model=32, nhead=4, dim_feedforward=64,
           dropout=0.0, moe_experts=4, moe_capacity_factor=1.0)


@pytest.mark.parametrize("scan,remat", [(False, False), (True, False),
                                        (True, True)],
                         ids=["unrolled", "scan", "scan_remat"])
def test_moe_encoder_matches_jax(scan, remat):
    pt.seed(1)
    jm = JT.TransformerEncoder(scan_layers=scan, remat=remat, **ENC)
    tm = TT.TransformerEncoder(scan_layers=scan, remat=remat, device="cpu",
                               **ENC)
    load_numpy_state(tm, _state(jm))
    x = np.random.default_rng(2).normal(size=(2, 8, 32)).astype(np.float32)
    cot = np.random.default_rng(3).normal(size=(2, 8, 32)).astype(
        np.float32)

    def jf(p):
        out, nb = jm.functional_call(p, jnp.asarray(x), training=True)
        aux = sum(v for k, v in nb.items() if k.endswith("aux_loss"))
        return jnp.sum(out * cot) + aux, (out, nb)

    (_, (jout, jb)), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jm.named_parameters())
    tm.train()
    out = tm(torch.from_numpy(x))
    bufs = dict(tm.named_buffers())
    (torch.sum(out * torch.from_numpy(cot)) + sum(
        v for k, v in bufs.items() if k.endswith("aux_loss"))).backward()
    _close(out, jout, 1e-5)
    for k, v in bufs.items():
        _close(v, jb[k], 1e-6, k)
    if scan:     # the JAX scan drops what the blocks record, also in
        #          the remat recompute the backward ran
        assert all(float(v) == 0.0 for k, v in tm.named_buffers()
                   if k.endswith("aux_loss"))
    _grads_close(_tgrads(tm), jg, 1e-5)


def test_moe_with_remat_raises_typed_error():
    """The JAX encoder and GPT cannot run a Switch FFN under remat (its
    buffer write inside jax.checkpoint raises UnexpectedTracerError), so
    the port refuses it; scan_layers' remat wraps the scan body there
    and runs."""
    with pytest.raises(InvalidArgumentError, match="UnexpectedTracerError"):
        TT.TransformerEncoder(remat=True, device="cpu", **ENC)
    TT.TransformerEncoder(remat=True, scan_layers=True, device="cpu", **ENC)
    cfg = TG.GPTConfig.tiny()
    cfg.moe_experts, cfg.remat = 4, True
    with pytest.raises(InvalidArgumentError, match="UnexpectedTracerError"):
        TG.GPTForCausalLM(cfg, device="cpu")
    cfg.remat = False
    model = TG.GPTForCausalLM(cfg, device="cpu")
    model.cfg.remat = True
    with pytest.raises(InvalidArgumentError, match="remat"):
        model(torch.ones((1, 4), dtype=torch.long))


def test_bert_moe_smoke_fused_loss_and_grads():
    pt.seed(2)
    cfg = JB.BertConfig.moe_smoke(layers=2)
    jm = JB.BertForPretraining(cfg)
    tm = TB.BertForPretraining(TB.BertConfig.moe_smoke(layers=2),
                               device="cpu")
    load_numpy_state(tm, _state(jm))
    rng = np.random.default_rng(4)
    ids = rng.integers(0, cfg.vocab_size, (2, 32))
    mlm = np.where(rng.random((2, 32)) < 0.3, ids, -100)
    nsp = rng.integers(0, 2, (2,))

    def jf(p):
        out, nb = jm.functional_call(
            p, *map(jnp.asarray, (ids, mlm, nsp)), training=True,
            method="forward_fused_loss")
        return out + 0.01 * sum(v for k, v in nb.items()
                                if k.endswith("ffn.aux_loss")), out

    (jloss, _), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jm.named_parameters())
    tm.train()
    task = tm.forward_fused_loss(*(torch.from_numpy(a) for a in
                                   (ids, mlm, nsp)))
    loss = task + 0.01 * sum(v for k, v in tm.named_buffers()
                             if k.endswith("ffn.aux_loss"))
    loss.backward()
    _close(loss, jloss, 1e-4)
    _grads_close(_tgrads(tm), jg, 1e-4)


def _gpt_moe(seed=8, cf=2.0):
    pt.seed(seed)
    cfg = JG.GPTConfig.tiny()
    cfg.moe_experts, cfg.moe_capacity_factor = 4, cf
    jm = JG.GPTForCausalLM(cfg)
    tcfg = TG.GPTConfig.tiny()
    tcfg.moe_experts, tcfg.moe_capacity_factor = 4, cf
    tm = TG.GPTForCausalLM(tcfg, device="cpu")
    load_numpy_state(tm, _state(jm))
    return jm, tm


def test_gpt_moe_forward_loss_with_aux_and_grads():
    """tests/test_gpt.py's MoE training case, held against the port."""
    jm, tm = _gpt_moe()
    ids = np.random.default_rng(8).integers(0, 512, (2, 16)).astype(
        np.int32)

    def jf(p):
        out, nb = jm.functional_call(p, jnp.asarray(ids), training=True,
                                     method="forward_loss")
        return out + 0.01 * sum(v for k, v in nb.items()
                                if k.endswith("ffn.aux_loss"))

    jloss, jg = jax.jit(jax.value_and_grad(jf))(jm.named_parameters())
    tm.train()
    loss = tm.forward_loss(torch.from_numpy(ids).long()) + 0.01 * sum(
        v for k, v in tm.named_buffers() if k.endswith("ffn.aux_loss"))
    loss.backward()
    _close(loss, jloss, 1e-4)
    _grads_close(_tgrads(tm), jg, 1e-4)
    router = [k for k, p in tm.named_parameters() if k.endswith("router_w")]
    assert router and all(tm.get_parameter(k).grad.abs().max() > 0
                          for k in router)


class _TinyMoENet:
    """tests/test_moe.py's TinyMoENet in both packages."""

    @staticmethod
    def jax():
        class Net(jnn.Layer):
            def __init__(self):
                super().__init__()
                self.ffn = jnn.SwitchFFN(8, 16, num_experts=2,
                                         capacity_factor=2.0)
                self.head = jnn.Linear(8, 2)

            def forward(self, x):
                return self.head(self.ffn(x).mean(axis=1))

        return Net()

    @staticmethod
    def torch():
        class Net(tnn.Layer):
            def __init__(self):
                super().__init__()
                self.ffn = tnn.SwitchFFN(8, 16, num_experts=2,
                                         capacity_factor=2.0, device="cpu")
                self.head = tnn.Linear(8, 2, device="cpu")

            def forward(self, x):
                return self.head(self.ffn(x).mean(dim=1))

        return Net()


@pytest.mark.parametrize("z_weight", [0.0, 1e-3])
def test_trainer_supervised_aux_weights_match_jax(z_weight):
    pt.seed(8)
    jm, tm = _TinyMoENet.jax(), _TinyMoENet.torch()
    load_numpy_state(tm, _state(jm))
    kw = dict(aux_loss_weight=0.01, router_z_loss_weight=z_weight)
    jt = JP.Trainer.supervised(
        jm, JO.Adam(1e-2),
        lambda out, y: jnp.mean(JL.softmax_with_cross_entropy(out, y)),
        mesh=pt.build_mesh(dp=1, devices=jax.devices()[:1]), **kw)
    tt = Trainer.supervised(
        tm, TO.Adam(1e-2),
        lambda out, y: torch.mean(TL.softmax_with_cross_entropy(out, y)),
        **kw)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 4, 8)).astype(np.float32)
    y = rng.integers(0, 2, 16)
    jb = {"x": jnp.asarray(x), "label": jnp.asarray(y)}
    tb = {"x": torch.from_numpy(x), "label": torch.from_numpy(y)}
    want = [float(jt.train_step(jb)[0]) for _ in range(12)]
    got = [float(tt.train_step(tb)[0]) for _ in range(12)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert want[-1] < want[0]
    # no graph outlives a step; eval reports the task loss alone
    assert not any(b.requires_grad for b in tm.buffers())
    _close(tt.eval_step(tb)[0], jt.eval_step(jb)[0], 1e-5)
    task = torch.mean(TL.softmax_with_cross_entropy(
        tm(torch.from_numpy(x)), torch.from_numpy(y)))
    _close(tt.eval_step(tb)[0], task.detach(), 1e-7)


def _recording(monkeypatch, module, kept):
    """Wrap ``module.switch_moe`` to append each call's kept fraction."""
    orig = module.switch_moe

    if module is JM:
        def wrapped(*a, **kw):
            out = orig(*a, **kw)
            jax.debug.callback(lambda k: kept.append(float(k)), out[3],
                               ordered=True)
            return out
    else:
        def wrapped(*a, **kw):
            out = orig(*a, **kw)
            kept.append(float(out[3]))
            return out

    monkeypatch.setattr(module, "switch_moe", wrapped)


def test_moe_arena_matches_jax(monkeypatch):
    """Capacity is per call: a prefill routes its padded bucket, a tick
    routes every slot's token, idle slots' included, at its own
    capacity, so tokens and kept fractions match the JAX arena only if
    the port makes the same calls on the same token sets."""
    jm, tm = _gpt_moe(seed=3, cf=1.0)
    jm.eval()
    tm.eval()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 512, n).astype(np.int32)
               for n in (5, 17, 3, 9, 12)]
    max_new = (6, 4, 8, 5, 7)
    kept = {"jax": [], "port": []}
    _recording(monkeypatch, JM, kept["jax"])
    _recording(monkeypatch, TM, kept["port"])
    outs = {}
    for name, dec in (
            ("jax", JaxDecoder(jm, slots=4, capacity=64)),
            ("port", BatchedDecoder(tm, slots=4, capacity=64,
                                    device="cpu"))):
        rids = [dec.submit(p, n) for p, n in zip(prompts, max_new)]
        res = dec.run()
        outs[name] = [np.asarray(res[r]) for r in rids]
    jax.effects_barrier()
    for g, w in zip(outs["port"], outs["jax"]):
        np.testing.assert_array_equal(g, w)
    _close(kept["port"], kept["jax"], 1e-6)
    assert min(kept["port"]) < 1.0          # some calls dropped tokens
    layers = len(tm.blocks)
    _close([float(b.ffn.kept_fraction) for b in tm.blocks],
           kept["jax"][-layers:], 1e-6)
