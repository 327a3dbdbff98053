"""The port's training slice against the JAX package on the same weights
(crossed with load_numpy_state), float32 on the CPU: a 2-layer GPT with
head_dim 64 (vocab 512, hidden 256, 4 heads over 2 kv heads, SwiGLU 512),
batch 2, T=64.

- ``forward_loss`` and every parameter's gradient, with remat off and
  on. The JAX side runs under force_flash, so its attention is the
  Pallas forward and backward kernels in interpret mode; the port's
  dispatch gate is opened on the CPU, so its attention is
  ``flash_attention`` over the plain kernel versions. Loss at atol 1e-5,
  grads at atol 1e-5: float32 sums in two frameworks' orders through 2
  blocks and a 512-wide head (observed ~1e-7 on the loss, ~1e-6 on
  grads).
- A 3-step ``Trainer`` trajectory against JAX's ``parallel.Trainer``
  (XLA attention on both sides): SGD(0.5), every parameter after each
  step at atol 1e-5 (the same float32 grads, applied linearly); Adam(1e-3),
  the losses at atol 1e-4. Adam divides each moment by sqrt of the second
  moment, so a parameter whose gradient is near zero moves by about lr
  whatever its sign noise; the losses, not single parameters, are the
  stable quantity to hold.
- Mixed precision: ``forward_loss`` and every grad under ``mixed_bf16``
  and ``"bfloat16"``, remat off and on, with the flash paths as above and
  ``backward()`` called after the policy scope has closed (the remat
  recompute must re-enter the policy). Loss at atol 2e-2, each grad
  within 2e-2 of its parameter's largest JAX grad entry: bfloat16 keeps 8
  bits, so each product rounds by up to 2^-8 of its magnitude, and the
  two frameworks round different partial results. A 3-step
  ``Trainer(amp="mixed_bf16")`` Adam trajectory: losses at 2e-2.
- Gradient accumulation (``grad_accum_steps=2``) against the JAX
  Trainer's: SGD parameters after 2 and 4 micro-steps (and unchanged
  after 1 and 3) at 1e-5 in float32; with ``amp.decorate`` and
  ``"mixed_fp16"``, at 1e-3 of each parameter's largest entry (float16
  keeps 11 bits) and the loss-scale state exactly.
- Dropout 0.1 under remat: grads equal to no remat within 1e-6 (the
  recompute replays the generator), three Adam steps finite and
  falling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import amp as JAMP
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JP
from paddle_tpu.models import gpt as JG
from paddle_tpu.ops import attention as JA
from paddle_tpu.core import dtypes as JD
import paddle_tpu_torch
from paddle_tpu_torch import amp as TAMP
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.core import EnforceError, InvalidArgumentError
from paddle_tpu_torch.core import dtypes as TD
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.parallel import Trainer
from paddle_tpu_torch.utils.convert import load_numpy_state

CFG = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_size=512, max_position=64)
B, T = 2, 64


def _pair(seed=0, **over):
    cfg = dict(CFG, **over)
    pt.seed(seed)
    jm = JG.GPTForCausalLM(JG.GPTConfig(**cfg))
    tm = TG.GPTForCausalLM(TG.GPTConfig(**cfg), device="cpu")
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    return jm, tm


def _ids(seed):
    return np.random.default_rng(seed).integers(1, 512, (B, T)).astype(
        np.int32)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.fixture
def flash_on_cpu(monkeypatch):
    """Open the port's flash gate for CPU tensors, as it is on the card,
    and record the dtype of q at each call."""
    calls = []
    real = TA.flash_attention
    monkeypatch.setattr(TA, "_flash_ok", lambda q, k, **kw: TA.flash_shape_ok(
        q.shape[1], k.shape[1], q.shape[-1]))
    monkeypatch.setattr(TA, "flash_attention", lambda *a, **kw: calls.append(
        a[0].dtype) or real(*a, **kw))
    return calls


@pytest.fixture(autouse=True)
def float32_policy():
    yield
    TD.set_policy("float32")
    JD.set_policy("float32")


@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_and_grads_match_jax(remat, flash_on_cpu):
    jm, tm = _pair(1, remat=remat)
    ids = _ids(2)
    labels = np.concatenate([ids[:, 1:], np.full((B, 1), -100, np.int32)],
                            axis=1)
    labels[0, 5:9] = -100                  # ignore_index holes

    def jloss(p):
        out, _ = jm.functional_call(p, jnp.asarray(ids), training=True,
                                    labels=jnp.asarray(labels),
                                    vocab_chunk=96, method="forward_loss")
        return out

    with JA.force_flash():      # traced fresh inside the context
        want, want_g = jax.jit(jax.value_and_grad(jloss))(
            jm.named_parameters())
    tm.train()
    got = tm.forward_loss(torch.from_numpy(ids),
                          labels=torch.from_numpy(labels), vocab_chunk=96)
    got.backward()
    # per layer one forward, plus one recompute under remat
    assert len(flash_on_cpu) == CFG["num_layers"] * (2 if remat else 1)
    _close(got.detach(), want, 1e-5)
    for name, p in tm.named_parameters():
        _close(p.grad, want_g[name], 1e-5)


def test_forward_loss_matches_unfused_oracle():
    _, tm = _pair(3)
    ids = torch.from_numpy(_ids(4))
    with torch.no_grad():
        fused = tm.forward_loss(ids, vocab_chunk=100)
        labels = torch.cat([ids[:, 1:], torch.full((B, 1), -100)], dim=1)
        oracle = TG.loss_fn(tm(ids), labels)
    _close(fused, oracle, 1e-5)


def test_loss_fn_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(2, 7, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    labels[1, 2] = -100
    _close(TG.loss_fn(torch.from_numpy(logits), torch.from_numpy(labels)),
           JG.loss_fn(jnp.asarray(logits), jnp.asarray(labels)), 1e-6)


def _jax_trainer(jm, opt, **kw):
    def loss_builder(params, buffers, rng, batch):
        out, nb = jm.functional_call(params, batch, buffers=buffers,
                                     rng=rng, training=rng is not None,
                                     method="forward_loss")
        return out, ({}, nb)

    return JP.Trainer(jm, opt, loss_builder, **kw)


def _torch_trainer(tm, opt, **kw):
    return Trainer(tm, opt, lambda model, batch, gen: (
        model.forward_loss(batch), {}), **kw)


def test_trainer_sgd_trajectory_matches_jax():
    jm, tm = _pair(6)
    jt, tt = _jax_trainer(jm, JO.SGD(0.5)), _torch_trainer(tm, TO.SGD(0.5))
    ids = _ids(7)
    for _ in range(3):
        jl, _ = jt.train_step(jnp.asarray(ids))
        tl, _ = tt.train_step(torch.from_numpy(ids))
        _close(tl, jl, 1e-5)
        for name, p in tm.named_parameters():
            _close(p.detach(), jt.params[name], 1e-5)


def test_trainer_adam_losses_match_jax():
    jm, tm = _pair(8)
    jt, tt = _jax_trainer(jm, JO.Adam(1e-3)), _torch_trainer(tm,
                                                             TO.Adam(1e-3))
    ids = _ids(9)
    losses = []
    for _ in range(3):
        jl, _ = jt.train_step(jnp.asarray(ids))
        tl, _ = tt.train_step(torch.from_numpy(ids))
        _close(tl, jl, 1e-4)
        losses.append(float(tl))
    assert losses[-1] < losses[0], losses
    jl2, _ = jt.eval_step(jnp.asarray(ids))
    tl2, _ = tt.eval_step(torch.from_numpy(ids))
    _close(tl2, jl2, 1e-4)


def test_train_steps_runs_n_updates_and_supervised():
    _, tm = _pair(10)
    tt = _torch_trainer(tm, TO.SGD(0.1))
    ids = torch.from_numpy(_ids(11))
    first, _ = tt.train_step(ids)
    last, _ = tt.train_steps(ids, 3)
    assert tt.opt_state["step"] == 4 and float(last) < float(first)
    sup = Trainer.supervised(
        tm, TO.SGD(0.1),
        lambda logits, label: TG.loss_fn(logits, label),
        metrics_fn=lambda logits, label: {"n": torch.tensor(label.numel())})
    loss, metrics = sup.train_step({"x": ids, "label": ids})
    assert torch.isfinite(loss) and int(metrics["n"]) == B * T


@pytest.mark.parametrize("kw,item", [
    # mesh=, plan=, param_spec= and opt_state_rules= are ported
    # (tests/test_torch_seq_parallel.py, test_torch_plan.py,
    # test_torch_tensor_parallel.py): an argument of another type raises
    # a typed error; grad_compression= (tests/test_torch_quant_comm.py)
    # needs a multi-device plan, as in the JAX Trainer
    pytest.param(dict(mesh=object()), "takes a mesh", id="kw0-item 11"),
    pytest.param(dict(plan=object()), "takes a Plan", id="kw1-item 11"),
    pytest.param(dict(param_spec=object()), "takes a {name",
                 id="kw2-item 11"),
    pytest.param(dict(opt_state_rules=object()), "takes OptStateRules",
                 id="kw3-item 11"),
    pytest.param(dict(grad_compression="int8"), "multi-device plan",
                 id="kw4-item 11"),
])
def test_trainer_unported_arguments_raise(kw, item):
    _, tm = _pair(12)
    with pytest.raises(EnforceError if "grad_compression" in kw
                       else InvalidArgumentError, match=item):
        Trainer(tm, TO.SGD(0.1), lambda *a: None, **kw)


def test_trainer_unknown_amp_policy_raises():
    _, tm = _pair(12)
    with pytest.raises(EnforceError, match="unknown amp policy bf16"):
        Trainer(tm, TO.SGD(0.1), lambda *a: None, amp="bf16")
    with pytest.raises(EnforceError, match="grad_accum_steps"):
        Trainer(tm, TO.SGD(0.1), lambda *a: None, grad_accum_steps=0)


# ----- mixed precision ------------------------------------------------------

BF16_TOL = 2e-2


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("policy", ["mixed_bf16", "bfloat16"])
def test_forward_loss_and_grads_match_jax_under_policy(policy, remat,
                                                       flash_on_cpu):
    jm, tm = _pair(13, remat=remat)
    ids = _ids(14)

    def jloss(p):
        with JD.policy_scope(policy):
            out, _ = jm.functional_call(p, jnp.asarray(ids), training=True,
                                        vocab_chunk=96,
                                        method="forward_loss")
        return out

    with JA.force_flash():
        want, want_g = jax.jit(jax.value_and_grad(jloss))(
            jm.named_parameters())
    tm.train()
    with TD.policy_scope(policy):
        got = tm.forward_loss(torch.from_numpy(ids), vocab_chunk=96)
    got.backward()                      # the scope has closed
    # q reaches the flash kernels in the Linears' output dtype, in the
    # forward and in each remat recompute
    q_dtype = torch.bfloat16 if policy == "bfloat16" else torch.float32
    assert flash_on_cpu == [q_dtype] * (CFG["num_layers"]
                                        * (2 if remat else 1))
    assert got.dtype == torch.float32
    _close(got.detach(), want, BF16_TOL)
    for name, p in tm.named_parameters():
        assert p.grad.dtype == torch.float32, name
        ref = np.abs(np.asarray(want_g[name], np.float32)).max()
        _close(p.grad, np.asarray(want_g[name], np.float32), BF16_TOL * ref)


def test_remat_equals_no_remat_under_mixed_bf16():
    """The recompute re-enters the forward's policy: with remat the loss
    and grads are those without it, though backward() runs outside the
    scope."""
    _, plain = _pair(15)
    _, remat = _pair(15, remat=True)
    ids = torch.from_numpy(_ids(16))
    for m in (plain, remat):
        m.train()
        with TD.policy_scope("mixed_bf16"):
            loss = m.forward_loss(ids)
        loss.backward()
        m.loss = loss.detach()
    assert torch.equal(plain.loss, remat.loss)
    for (name, p), q in zip(plain.named_parameters(), remat.parameters()):
        torch.testing.assert_close(q.grad, p.grad, atol=1e-6, rtol=0,
                                   msg=name)


def test_trainer_mixed_bf16_adam_losses_match_jax():
    jm, tm = _pair(17)
    jt = _jax_trainer(jm, JO.Adam(1e-3), amp="mixed_bf16")
    tt = _torch_trainer(tm, TO.Adam(1e-3), amp="mixed_bf16")
    ids = _ids(18)
    losses = []
    for _ in range(3):
        jl, _ = jt.train_step(jnp.asarray(ids))
        tl, _ = tt.train_step(torch.from_numpy(ids))
        _close(tl, jl, BF16_TOL)
        losses.append(float(tl))
    assert losses[-1] < losses[0], losses
    assert TD.get_policy() == TD.POLICIES["float32"]
    for p in tm.parameters():
        assert p.dtype == torch.float32


@pytest.mark.parametrize("amp", [None, "mixed_fp16"])
def test_grad_accum_sgd_matches_jax(amp):
    jm, tm = _pair(19)
    if amp is None:
        jopt, topt = JO.SGD(0.5), TO.SGD(0.5)
    else:
        jopt = JAMP.decorate(JO.SGD(0.5), init_loss_scaling=2.0 ** 12)
        topt = TAMP.decorate(TO.SGD(0.5), init_loss_scaling=2.0 ** 12)
    jt = _jax_trainer(jm, jopt, amp=amp, grad_accum_steps=2)
    tt = _torch_trainer(tm, topt, amp=amp, grad_accum_steps=2)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    for micro in range(4):
        ids = _ids(20 + micro)
        jl, _ = jt.train_step(jnp.asarray(ids))
        tl, _ = tt.train_step(torch.from_numpy(ids))
        _close(tl, jl, 1e-5 if amp is None else 1e-3)
        for name, p in tm.named_parameters():
            if micro % 2 == 0:          # accumulated, not applied yet
                assert torch.equal(p.detach(), before[name]), name
                continue
            want = np.asarray(jt.params[name])
            atol = 1e-5 if amp is None else 1e-3 * np.abs(want).max()
            _close(p.detach(), want, atol)
        before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    if amp is None:
        assert tt.opt_state["step"] == 2
    else:
        assert tt.opt_state["inner"]["step"] == 2
        for key in ("scale", "good_steps", "bad_steps"):
            assert tt.opt_state["scaler"][key].item() == np.asarray(
                jt.opt_state["scaler"][key]).item(), key
    with pytest.raises(EnforceError, match="plain steps only"):
        tt.train_steps(torch.from_numpy(_ids(24)), 2)


def test_gpt_with_dropout_remat_equals_no_remat_and_trains(flash_on_cpu):
    """GPTConfig(dropout=0.1) (it raised before dropout was ported) under
    remat: the recompute replays the generator, so the grads equal those
    without remat within 1e-6, and three Adam steps train."""
    ids = torch.from_numpy(np.random.default_rng(13).integers(
        1, 512, (B, T)))
    grads, losses = [], []
    for remat in (False, True):
        paddle_tpu_torch.seed(14)     # the same start key for both trainers
        model = TG.GPTForCausalLM(
            TG.GPTConfig(**dict(CFG, dropout=0.1, remat=remat)),
            device="cpu", generator=torch.Generator().manual_seed(14))
        trainer = Trainer(model, TO.Adam(1e-3),
                          lambda m, b, g: (m.forward_loss(b), {}))
        run = [float(trainer.train_step(ids)[0])]
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        run += [float(trainer.train_step(ids)[0]) for _ in range(2)]
        losses.append(run)
    np.testing.assert_allclose(losses[1], losses[0], atol=1e-6, rtol=0)
    assert all(np.isfinite(losses[0])) and losses[0][-1] < losses[0][0]
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name],
                                   atol=1e-6, rtol=0, msg=name)
