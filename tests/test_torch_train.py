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
  stable quantity to hold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JP
from paddle_tpu.models import gpt as JG
from paddle_tpu.ops import attention as JA
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.core import UnimplementedError
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
    and count the calls."""
    calls = []
    real = TA.flash_attention
    monkeypatch.setattr(TA, "_flash_ok", lambda q, k: TA.flash_shape_ok(
        q.shape[1], k.shape[1], q.shape[-1]))
    monkeypatch.setattr(TA, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


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


def _jax_trainer(jm, opt):
    def loss_builder(params, buffers, rng, batch):
        out, nb = jm.functional_call(params, batch, buffers=buffers,
                                     rng=rng, training=rng is not None,
                                     method="forward_loss")
        return out, ({}, nb)

    return JP.Trainer(jm, opt, loss_builder)


def _torch_trainer(tm, opt):
    return Trainer(tm, opt, lambda model, batch, gen: (
        model.forward_loss(batch), {}))


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
    (dict(mesh=object()), "item 11"), (dict(plan=object()), "item 11"),
    (dict(param_spec={}), "item 11"), (dict(opt_state_rules=object()),
                                       "item 11"),
    (dict(grad_compression="int8"), "item 11"), (dict(amp="bf16"),
                                                 "item 3"),
    (dict(grad_accum_steps=2), "item 3"),
])
def test_trainer_unported_arguments_raise(kw, item):
    _, tm = _pair(12)
    with pytest.raises(UnimplementedError, match=item):
        Trainer(tm, TO.SGD(0.1), lambda *a: None, **kw)
