"""The port's BERT pretraining slice (paddle_tpu_torch/models/bert.py)
against the JAX package on the same weights (crossed with
load_numpy_state), on the CPU: a config with head_dim 64 (vocab 1024,
hidden 128, 2 heads, 2 layers, FFN 256, max_position 64), batch 2,
T=64, dropout 0 for the parity tests.

The port's flash gate is opened on the CPU (as on the card), so its
attention is ``flash_attention`` over the plain kernel versions, segment
ids included; the JAX side runs under force_flash (the Pallas kernels in
interpret mode, jitted).

- ``forward`` (h, pooled, MLM and NSP logits), ``forward_fused_loss``,
  ``forward_packed_loss`` and every parameter's gradient, in float32
  (outputs and losses at 1e-5; each grad within 1e-4 of its parameter's
  largest JAX grad entry, floored at 0.1 for the key projection's bias,
  whose grad is 0 in exact arithmetic) and under ``mixed_bf16`` (2e-2 of
  the loss and of each parameter's largest grad: bfloat16 keeps 8 bits);
  ``pretrain_loss`` and ``pretrain_metrics`` on the unfused logits.
- Weight carry: every parameter name of the JAX ``BertForPretraining``
  is a parameter of the port's, with its shape.
- Training: a ``Trainer`` with packed BERT at dropout 0.1 takes 3 Adam
  steps (losses finite and falling, the same from the same seed); remat
  equals no remat under dropout 0.1 within 1e-6 (the recompute must
  replay the generator, nn/layer.py ``remat_call``; GPT's counterpart is
  in test_torch_train.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import dtypes as JD
from paddle_tpu.data.bucketing import pack_sequences
from paddle_tpu.models import bert as JB
from paddle_tpu.ops import attention as JA
import paddle_tpu_torch
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.core import dtypes as TD
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.parallel import Trainer
from paddle_tpu_torch.utils.convert import load_numpy_state

CFG = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=2,
           intermediate_size=256, max_position=64, dropout=0.0)
B, T = 2, 64
CHUNK = 256                     # the fused head scans the vocabulary in 4
TOL = {"float32": (1e-5, 1e-4), "mixed_bf16": (2e-2, 2e-2)}


def _pair(seed=0, **over):
    cfg = dict(CFG, **over)
    pt.seed(seed)
    jm = JB.BertForPretraining(JB.BertConfig(**cfg))
    tm = TB.BertForPretraining(TB.BertConfig(**cfg), device="cpu")
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    return jm, tm


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _grads_close(tm, want_g, rtol):
    for name, p in tm.named_parameters():
        w = np.asarray(want_g[name], np.float32)
        # a parameter the loss does not read (the packed loss skips NSP)
        # has no grad here and a zero one in JAX
        g = torch.zeros_like(p) if p.grad is None else p.grad
        scale = max(np.abs(w).max(), 0.1)
        _close(g / scale, w / scale, rtol)


@pytest.fixture
def flash_on_cpu(monkeypatch):
    """Open the port's flash gate for CPU tensors and record whether each
    call carried segment ids."""
    calls = []
    real = TA.flash_attention
    monkeypatch.setattr(TA, "_flash_ok", lambda q, k: TA.flash_shape_ok(
        q.shape[1], k.shape[1], q.shape[-1]))
    monkeypatch.setattr(TA, "flash_attention", lambda *a, **kw: calls.append(
        kw.get("segment_ids") is not None) or real(*a, **kw))
    return calls


@pytest.fixture(autouse=True)
def float32_policy():
    yield
    TD.set_policy("float32")
    JD.set_policy("float32")


def _padded_batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], (B, T)).astype(np.int32)
    types = (np.arange(T)[None, :] >= 30).astype(np.int32).repeat(B, 0)
    mask = np.ones((B, T), bool)
    mask[1, 50:] = False
    mlm = np.where(rng.random((B, T)) < 0.3, ids, -100).astype(np.int32)
    nsp = rng.integers(0, 2, (B,)).astype(np.int32)
    return ids, types, mask, mlm, nsp


def _packed_batch(seed, batch=B):
    rng = np.random.default_rng(seed)

    def docs():
        while True:
            yield rng.integers(3, CFG["vocab_size"], int(rng.integers(8, 41)))

    b = next(iter(pack_sequences(docs, capacity=T, batch_size=batch)()))
    return b["tokens"].astype(np.int32), b["positions"], b["segment_ids"]


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


def test_parameter_names_carry_across():
    jm, tm = _pair()
    jp = {k: np.shape(v) for k, v in jm.named_parameters().items()}
    tp = {k: tuple(v.shape) for k, v in tm.named_parameters()}
    assert jp == tp
    # embeddings 5, 16 a layer, the pooler 2, the heads 8
    assert len(tp) == 5 + 2 * 16 + 2 + 8


def test_forward_matches_jax(flash_on_cpu):
    jm, tm = _pair(1)
    ids, types, mask, _, _ = _padded_batch(2)
    args = (jnp.asarray(ids), jnp.asarray(types), jnp.asarray(mask))

    def jfwd(p):
        (mlm, nsp), _ = jm.functional_call(p, *args, training=False)
        (h, pooled), _ = jm.bert.functional_call(
            {k[5:]: v for k, v in p.items() if k.startswith("bert.")},
            *args, training=False)
        return h, pooled, mlm, nsp

    with JA.force_flash():
        want = jax.jit(jfwd)(jm.named_parameters())
    tm.eval()
    with torch.no_grad():
        h, pooled = tm.bert(_t(ids), _t(types), torch.from_numpy(mask))
        mlm, nsp = tm(_t(ids), _t(types), torch.from_numpy(mask))
    assert flash_on_cpu == [False] * 4
    for got, w in zip((h, pooled, mlm, nsp), want):
        _close(got, w, 1e-5)


@pytest.mark.parametrize("policy", ["float32", "mixed_bf16"])
def test_fused_loss_and_grads_match_jax(policy, flash_on_cpu):
    jm, tm = _pair(3)
    ids, types, mask, mlm, nsp = _padded_batch(4)

    def jloss(p):
        with JD.policy_scope(policy):
            out, _ = jm.functional_call(
                p, jnp.asarray(ids), jnp.asarray(mlm), jnp.asarray(nsp),
                jnp.asarray(types), jnp.asarray(mask), vocab_chunk=CHUNK,
                training=True, method="forward_fused_loss")
        return out

    with JA.force_flash():
        want, want_g = jax.jit(jax.value_and_grad(jloss))(
            jm.named_parameters())
    tm.train()
    with TD.policy_scope(policy):
        got = tm.forward_fused_loss(_t(ids), _t(mlm), _t(nsp), _t(types),
                                    torch.from_numpy(mask),
                                    vocab_chunk=CHUNK)
    got.backward()
    assert flash_on_cpu == [False] * CFG["num_layers"]
    loss_tol, grad_tol = TOL[policy]
    _close(got.detach(), want, loss_tol)
    _grads_close(tm, want_g, grad_tol)


@pytest.mark.parametrize("policy", ["float32", "mixed_bf16"])
def test_packed_loss_and_grads_match_jax(policy, flash_on_cpu):
    jm, tm = _pair(5)
    tokens, positions, segs = _packed_batch(6)
    assert (segs == 0).any() and segs.max() >= 2     # a tail, packed rows

    def jloss(p):
        with JD.policy_scope(policy):
            out, _ = jm.functional_call(
                p, jnp.asarray(tokens), jnp.asarray(positions),
                jnp.asarray(segs), jnp.asarray(tokens), vocab_chunk=CHUNK,
                training=True, method="forward_packed_loss")
        return out

    with JA.force_flash():
        want, want_g = jax.jit(jax.value_and_grad(jloss))(
            jm.named_parameters())
    tm.train()
    with TD.policy_scope(policy):
        got = tm.forward_packed_loss(_t(tokens), _t(positions),
                                     torch.from_numpy(segs), _t(tokens),
                                     vocab_chunk=CHUNK)
    got.backward()
    assert flash_on_cpu == [True] * CFG["num_layers"]
    loss_tol, grad_tol = TOL[policy]
    _close(got.detach(), want, loss_tol)
    _grads_close(tm, want_g, grad_tol)


def test_pretrain_loss_and_metrics_match_jax():
    jm, tm = _pair(7)
    ids, types, mask, mlm, nsp = _padded_batch(8)
    labels_j = {"mlm_labels": jnp.asarray(mlm), "nsp_label": jnp.asarray(nsp)}
    labels_t = {"mlm_labels": _t(mlm), "nsp_label": _t(nsp)}
    out_j, _ = jm.functional_call(jm.named_parameters(), jnp.asarray(ids),
                                  jnp.asarray(types), jnp.asarray(mask),
                                  training=False)
    tm.eval()
    with torch.no_grad():
        out_t = tm(_t(ids), _t(types), torch.from_numpy(mask))
    _close(TB.pretrain_loss(out_t, labels_t),
           JB.pretrain_loss(out_j, labels_j), 1e-5)
    want = JB.pretrain_metrics(out_j, labels_j)
    got = TB.pretrain_metrics(out_t, labels_t)
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) < 1e-6, k


# ----- training --------------------------------------------------------------

def _packed_trainer(seed):
    # the stream seeded too: a trainer's start key is its next key
    paddle_tpu_torch.seed(seed)
    gen = torch.Generator().manual_seed(seed)
    model = TB.BertForPretraining(TB.BertConfig(**dict(CFG, dropout=0.1)),
                                  device="cpu", generator=gen)
    return Trainer(model, TO.Adam(1e-3),
                   lambda m, batch, g: (m.forward_packed_loss(
                       *batch, vocab_chunk=CHUNK), {}))


def test_trainer_packed_bert_with_dropout_trains(flash_on_cpu):
    tokens, positions, segs = _packed_batch(9, batch=4)
    batch = (_t(tokens), _t(positions), torch.from_numpy(segs), _t(tokens))
    runs = []
    for _ in range(2):
        trainer = _packed_trainer(10)
        runs.append([float(trainer.train_step(batch)[0]) for _ in range(3)])
    losses = runs[0]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert runs[0] == runs[1]                 # reproducible from the seed
    assert flash_on_cpu == [True] * CFG["num_layers"] * 6


@pytest.mark.parametrize("remat_policy", [None, "dots"])
def test_bert_remat_equals_no_remat_under_dropout(flash_on_cpu,
                                                  remat_policy):
    """The recompute draws the forward's dropout masks again (layer and
    attention dropout) and leaves the generator where it found it."""
    tokens, positions, segs = _packed_batch(11)
    batch = (_t(tokens), _t(positions), torch.from_numpy(segs), _t(tokens))
    out = []
    for remat in (False, True):
        paddle_tpu_torch.seed(12)     # the same start key for both trainers
        model = TB.BertForPretraining(
            TB.BertConfig(**dict(CFG, dropout=0.1, remat=remat,
                                 remat_policy=remat_policy if remat
                                 else None)),
            device="cpu", generator=torch.Generator().manual_seed(12))
        trainer = Trainer(model, TO.SGD(0.0), lambda m, b, g: (
            m.forward_packed_loss(*b, vocab_chunk=CHUNK), {}))
        loss, _ = trainer.train_step(batch)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        out.append((loss, grads, trainer._generator.get_state()))
    (l0, g0, s0), (l1, g1, s1) = out
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert g0.keys() == g1.keys()
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], atol=1e-6, rtol=0,
                                   msg=name)
