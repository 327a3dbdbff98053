"""The port's Transformer NMT slice (paddle_tpu_torch/nn/transformer.py's
decoder side and paddle_tpu_torch/models/transformer.py) against the JAX
package on the same weights (crossed with load_numpy_state), float32 on
the CPU, inputs from numpy seeds, the JAX side jitted.

- ``TransformerDecoderLayer`` and ``TransformerDecoder`` (d_model 32, 4
  heads, FFN 64), pre-norm and post-norm, a target of 8 against a
  memory of 10 with a padded tail and a fully padded row: outputs at
  1e-5, every gradient within 1e-5 of its parameter's largest JAX
  gradient entry (the key projections' biases, whose grads are 0 in
  exact arithmetic, within 1e-5 absolutely). ``decoder_layer_step`` over a cache equals the
  layer's causal forward position by position (1e-5).
- ``PositionalEncoding`` (its table exactly, the scaled sum at 1e-6) and
  ``LearnedPositionalEmbedding`` (1e-6).
- ``TransformerNMT``: every parameter name and shape of the JAX model;
  ``forward`` logits at 1e-4 and ``forward_fused_loss`` (1e-5) with
  every gradient (1e-5 of the parameter's largest) at src 16 / tgt 12
  (the plain path). Then at src 128 / tgt 64, a padded source tail and
  one fully padded source row, where the port's attention runs
  ``flash_attention`` (the gate opened on the CPU, over the kernels'
  plain versions) and the JAX package's its Pallas kernels in interpret
  mode (``force_flash``): NMTConfig of head dim 64 (d_model 128, 2 heads,
  1 + 1 layers, FFN 256, vocab 512), attention dropout 0 and 0.1 (the
  port handed the JAX call's (B, H) seeds call by call; the layer
  dropouts set to 0, whose masks the two frameworks draw differently).
  Cross-attention there is Tq 64 against Tk 128, so the dropout hash's
  row offset tk - tq is held against the TPU kernels'.
- ``nmt_loss`` (1e-6), ``nmt_metrics`` (exact) and ``label_smooth``
  (1e-7, with and without ``prior_dist``), with pad labels, a negative
  and an out-of-range label (zero one-hot rows, as ``jax.nn.one_hot``).
- Decoding: ``greedy_decode`` tokens equal the JAX package's, the
  teacher-forced logits at the emitted tokens within 1e-4, and
  ``greedy_decode_cached`` equals ``greedy_decode``; ``beam_decode`` and
  ``beam_decode_cached`` sequences equal the JAX package's and scores
  within 1e-5, a fully padded source row included.
- A Trainer over ``nmt_loss`` takes 8 Adam(1e-3) steps with the loss
  falling; each loss within 1e-4 of the JAX Trainer's (dropout 0).
- The cached entry points raise outside eval mode and past the
  positional table; ``seq_parallel`` raises naming its ROADMAP item."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JP
from paddle_tpu.models import transformer as JT
from paddle_tpu.nn import transformer as JNT
from paddle_tpu.ops import attention as JA
from paddle_tpu.ops import loss as JL
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.core import EnforceError, UnimplementedError
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.nn import transformer as TNT
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.ops import loss as TL
from paddle_tpu_torch.parallel import Trainer
from paddle_tpu_torch.utils.convert import load_numpy_state

# the module (the package re-exports its function under the same name)
JPF = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")


def _close(got, want, atol, msg=""):
    if torch.is_tensor(got):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=msg)


def _grads_close(named_params, want_g, rtol):
    """Each grad within ``rtol`` of its parameter's largest JAX entry; a
    key projection's bias, whose grad is 0 in exact arithmetic (a
    softmax ignores a shift shared by a row's scores), absolutely."""
    for name, p in named_params:
        w = np.asarray(want_g[name], np.float32)
        scale = (1.0 if name.endswith("k_proj.bias")
                 else max(float(np.abs(w).max()), 1e-30))
        _close(p.grad.numpy() / scale, w / scale, rtol, name)


def _cross(jlayer, tlayer):
    load_numpy_state(tlayer, {k: np.asarray(v) for k, v in
                              jlayer.named_parameters().items()})


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ----- the decoder layers ---------------------------------------------------

D, H, FF, TQ, TK = 32, 4, 64, 8, 10


def _decoder_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, TQ, D)).astype(np.float32)
    mem = rng.normal(size=(3, TK, D)).astype(np.float32)
    keep = np.ones((3, TK), bool)
    keep[1, 6:] = False             # a padded tail
    keep[2, :] = False              # a row with no live key
    ct = rng.normal(size=(3, TQ, D)).astype(np.float32)
    return x, mem, keep, ct


@pytest.mark.parametrize("pre_norm", [True, False])
@pytest.mark.parametrize("stack", [False, True])
def test_decoder_matches_jax(pre_norm, stack):
    pt.seed(1)
    if stack:
        jl = JNT.TransformerDecoder(2, D, H, FF, dropout=0.0,
                                    normalize_before=pre_norm)
        tl = TNT.TransformerDecoder(2, D, H, FF, dropout=0.0,
                                    normalize_before=pre_norm, device="cpu")
    else:
        jl = JNT.TransformerDecoderLayer(D, H, FF, dropout=0.0,
                                         normalize_before=pre_norm)
        tl = TNT.TransformerDecoderLayer(D, H, FF, dropout=0.0,
                                         normalize_before=pre_norm,
                                         device="cpu")
    assert ([k for k, _ in tl.named_parameters()]
            == list(jl.named_parameters()))
    _cross(jl, tl)
    x, mem, keep, ct = _decoder_inputs(2)
    mask = keep[:, None, None, :]

    def jloss(p, x, mem):
        out, _ = jl.functional_call(p, x, mem, cross_mask=jnp.asarray(mask),
                                    training=False)
        return jnp.sum(out * ct), out

    (_, want), grads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
            jl.named_parameters(), jnp.asarray(x), jnp.asarray(mem))
    want_g, want_gx, want_gm = grads
    tx, tm = _t(x).requires_grad_(), _t(mem).requires_grad_()
    out = tl(tx, tm, cross_mask=_t(mask))
    (out * _t(ct)).sum().backward()
    _close(out.detach(), want, 1e-5)
    assert np.isfinite(out.detach().numpy()).all()
    _grads_close(tl.named_parameters(), want_g, 1e-5)
    for g, w in ((tx.grad, want_gx), (tm.grad, want_gm)):
        scale = float(np.abs(np.asarray(w)).max())
        _close(g.numpy() / scale, np.asarray(w) / scale, 1e-5)


@pytest.mark.parametrize("pre_norm", [True, False])
def test_decoder_layer_step_equals_the_causal_forward(pre_norm):
    ptt.seed(2)
    layer = TNT.TransformerDecoderLayer(D, H, FF, dropout=0.0,
                                        normalize_before=pre_norm,
                                        device="cpu").eval()
    x, mem, keep, _ = _decoder_inputs(3)
    x, mem, mask = _t(x), _t(mem), _t(keep[:, None, None, :])
    with torch.no_grad():
        want = layer(x, mem, cross_mask=mask)
        mk, mv = layer.cross_attn.project_kv(mem)
        ck, cv = layer.self_attn.init_cache(3, TQ)
        for t in range(TQ):
            out, ck, cv = TNT.decoder_layer_step(
                layer, x[:, t:t + 1], mk, mv, ck, cv, t, cross_mask=mask,
                decode_kernel=bool(t % 2))
            _close(out[:, 0], want[:, t], 1e-5, f"t={t}")


def test_positional_encodings_match_jax():
    jp = JNT.PositionalEncoding(16, max_len=40)
    tp = TNT.PositionalEncoding(16, max_len=40, device="cpu")
    assert not list(tp.named_parameters())
    np.testing.assert_array_equal(tp.pe.numpy(), np.asarray(jp.pe))
    x = np.random.default_rng(4).normal(size=(2, 9, 16)).astype(np.float32)
    _close(tp(_t(x)), jp(jnp.asarray(x)), 1e-6)
    unscaled = TNT.PositionalEncoding(8, max_len=16, scale_embedding=False,
                                      device="cpu")
    out = unscaled(torch.zeros(1, 4, 8))
    _close(out[0, 0, 0::2], np.zeros(4), 1e-6)
    _close(out[0, 0, 1::2], np.ones(4), 1e-6)
    pt.seed(5)
    jl = JNT.LearnedPositionalEmbedding(12, 16)
    tl = TNT.LearnedPositionalEmbedding(12, 16, device="cpu")
    _cross(jl, tl)
    _close(tl(_t(x)), jl(jnp.asarray(x)), 1e-6)


def test_seq_parallel_raises_naming_its_item():
    with pytest.raises(UnimplementedError, match="item 11"):
        TNT.TransformerDecoderLayer(D, H, FF, seq_parallel="sp",
                                    device="cpu")
    cfg = TT.NMTConfig.tiny()
    cfg.seq_parallel = "sp"
    with pytest.raises(UnimplementedError, match="item 11"):
        TT.TransformerNMT(cfg, device="cpu")


# ----- the model --------------------------------------------------------------

FLASH_CFG = dict(src_vocab=512, tgt_vocab=512, d_model=128, num_heads=2,
                 num_encoder_layers=1, num_decoder_layers=1,
                 dim_feedforward=256, dropout=0.0, max_len=256)


def _pair(seed, **cfg):
    pt.seed(seed)
    ptt.seed(seed)
    jcfg = JT.NMTConfig(**cfg) if cfg else JT.NMTConfig.tiny()
    tcfg = TT.NMTConfig(**cfg) if cfg else TT.NMTConfig.tiny()
    jm = JT.TransformerNMT(jcfg)
    tm = TT.TransformerNMT(tcfg, device="cpu")
    _cross(jm, tm)
    return jm, tm


def _batch(seed, b, ts, tt, vocab=512):
    """src with a padded tail in row 1 and a fully padded row 2; the
    decoder input and labels, a few labels pad."""
    rng = np.random.default_rng(seed)
    src = rng.integers(3, vocab, (b, ts))
    src[1, ts // 2:] = 2
    src[2, :] = 2
    tgt = rng.integers(3, vocab, (b, tt))
    labels = rng.integers(3, vocab, (b, tt))
    labels[0, -3:] = 2
    return src, tgt, labels


def test_parameter_names_and_shapes_carry_across():
    jm, tm = _pair(0)
    jp = {k: np.shape(v) for k, v in jm.named_parameters().items()}
    tp = {k: tuple(v.shape) for k, v in tm.named_parameters()}
    assert jp == tp
    # embeddings 2, 16 an encoder layer, 26 a decoder layer, 2 final
    # norms of 2, the generator 2
    assert len(tp) == 2 + 2 * 16 + 2 * 26 + 4 + 2
    assert [k for k, _ in tm.named_buffers()] == ["pos_enc.pe"]


def test_forward_and_fused_loss_match_jax():
    jm, tm = _pair(6)
    src, tgt, labels = _batch(7, 4, 16, 12)
    want = jax.jit(lambda p: jm.functional_call(
        p, jnp.asarray(src), jnp.asarray(tgt), training=False)[0])(
            jm.named_parameters())
    tm.eval()
    with torch.no_grad():
        got = tm(_t(src), _t(tgt))
    _close(got, want, 1e-4)
    assert np.isfinite(got.numpy()).all()

    def jloss(p):
        return jm.functional_call(p, jnp.asarray(src), jnp.asarray(tgt),
                                  jnp.asarray(labels), vocab_chunk=128,
                                  training=True,
                                  method="forward_fused_loss")[0]

    want_l, want_g = jax.jit(jax.value_and_grad(jloss))(
        jm.named_parameters())
    tm.train()
    loss = tm.forward_fused_loss(_t(src), _t(tgt), _t(labels),
                                 vocab_chunk=128)
    loss.backward()
    _close(loss.detach(), want_l, 1e-5)
    _grads_close(tm.named_parameters(), want_g, 1e-5)


@pytest.fixture
def flash_on_cpu(monkeypatch):
    """The port's flash gate opened for CPU tensors; each call's (tq, tk,
    causal, kv_mask given) recorded."""
    calls = []
    real = TA.flash_attention
    monkeypatch.setattr(TA, "_flash_ok", lambda q, k: TA.flash_shape_ok(
        q.shape[1], k.shape[1], q.shape[-1]))

    def record(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("causal"),
                      kw.get("kv_mask") is not None))
        return real(q, k, v, **kw)

    monkeypatch.setattr(TA, "flash_attention", record)
    return calls


def _attention_dropout_only(model, p):
    """Attention dropout p, every layer dropout 0."""
    mods = (model.named_modules() if isinstance(model, torch.nn.Module)
            else model.named_sublayers())
    for _, mod in mods:
        if type(mod).__name__ == "MultiHeadAttention":
            mod.dropout_p = p
        elif type(mod).__name__ == "Dropout":
            mod.p = 0.0


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_flash_path_with_padding_and_dropout_matches_pallas(
        p, flash_on_cpu, monkeypatch):
    jm, tm = _pair(8, **FLASH_CFG)
    for model in (jm, tm):
        _attention_dropout_only(model, p)
    src, tgt, labels = _batch(9, 3, 128, 64)
    seeds = []
    real = JPF.flash_attention

    def jflash(q, k, v, **kw):
        if kw.get("dropout_p", 0.0) > 0.0:
            seeds.append(jax.random.randint(
                kw["dropout_key"], (q.shape[0], q.shape[2]), -2 ** 31,
                2 ** 31 - 1, dtype=jnp.int32))
        return real(q, k, v, **kw)

    # the JAX dispatch caches its kernel getter: replace the getter
    monkeypatch.setattr(JA, "_get_flash", lambda: jflash)

    def jloss(prm, key):
        seeds.clear()
        loss, _ = jm.functional_call(
            prm, jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(labels),
            vocab_chunk=256, rng=key, training=True,
            method="forward_fused_loss")
        return loss, list(seeds)

    with JA.force_flash():
        (want_l, want_seeds), want_g = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(jm.named_parameters(),
                                  jax.random.key(3))
    assert len(want_seeds) == (3 if p else 0)
    handed = iter([torch.from_numpy(np.array(s)) for s in want_seeds])
    monkeypatch.setattr(TA, "_dropout_seeds",
                        lambda gen, b, h, dev: next(handed))
    tm.train()
    with ptt.core.rng_scope(torch.Generator().manual_seed(0)):
        loss = tm.forward_fused_loss(_t(src), _t(tgt), _t(labels),
                                     vocab_chunk=256)
    loss.backward()
    # encoder self-attention, decoder self-attention (causal) and
    # cross-attention at Tq 64 against Tk 128, all on the flash path
    assert flash_on_cpu == [(128, 128, False, True), (64, 64, True, False),
                            (64, 128, False, True)]
    assert next(handed, None) is None
    _close(loss.detach(), want_l, 1e-5)
    _grads_close(tm.named_parameters(), want_g, 1e-5)


# ----- losses -------------------------------------------------------------------

def test_loss_metrics_and_label_smooth_match_jax():
    rng = np.random.default_rng(10)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5))
    labels[0, 3:] = 2                # pad positions
    labels[1, 1] = -1                # a negative label: a zero one-hot row
    labels[2, 4] = 11                # out of range: a zero one-hot row
    for eps in (0.1, 0.0):
        _close(TT.nmt_loss(_t(logits), _t(labels), pad_id=2,
                           label_smooth=eps),
               JT.nmt_loss(jnp.asarray(logits), jnp.asarray(labels),
                           pad_id=2, label_smooth=eps), 1e-6)
    got = TT.nmt_metrics(_t(logits), _t(labels), pad_id=2)["token_acc"]
    want = JT.nmt_metrics(jnp.asarray(logits), jnp.asarray(labels), 2)
    assert float(got) == pytest.approx(float(want["token_acc"]), abs=0)
    onehot = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (4,))]
    prior = rng.random(7).astype(np.float32)
    prior /= prior.sum()
    _close(TL.label_smooth(_t(onehot), 0.2),
           JL.label_smooth(jnp.asarray(onehot), 0.2), 1e-7)
    _close(TL.label_smooth(_t(onehot), 0.2, prior_dist=_t(prior)),
           JL.label_smooth(jnp.asarray(onehot), 0.2,
                           prior_dist=jnp.asarray(prior)), 1e-7)
    # all positions pad: the denominator is held at 1
    assert float(TT.nmt_loss(_t(logits), torch.full((3, 5), 2))) == 0.0


# ----- decoding -----------------------------------------------------------------

@pytest.fixture(scope="module")
def decode_pair():
    jm, tm = _pair(13)
    jm.eval()
    tm.eval()
    src, _, _ = _batch(31, 3, 12, 4)
    return jm, tm, src


def test_greedy_decode_matches_jax(decode_pair):
    jm, tm, src = decode_pair
    want = np.asarray(jax.jit(lambda p, s: jm.functional_call(
        p, s, max_len=10, method="greedy_decode", training=False)[0])(
            jm.named_parameters(), jnp.asarray(src)))
    got = tm.greedy_decode(_t(src), max_len=10)
    assert got.shape == (3, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tm.greedy_decode_cached(_t(src), max_len=10).numpy(), want)
    # the logits of each emitted token, teacher-forced, agree with JAX's
    shifted = np.concatenate([np.zeros((3, 1), want.dtype), want[:, :-1]],
                             axis=1)
    want_logits = jm(jnp.asarray(src), jnp.asarray(shifted))
    with torch.no_grad():
        got_logits = tm(_t(src), _t(shifted))
    _close(got_logits, want_logits, 1e-4)


def test_beam_decode_matches_jax(decode_pair):
    jm, tm, src = decode_pair
    kw = dict(max_len=8, beam_size=3)
    seq_j, sc_j = jax.jit(lambda p, s: jm.functional_call(
        p, s, method="beam_decode", training=False, **kw)[0])(
            jm.named_parameters(), jnp.asarray(src))
    seq, sc = tm.beam_decode(_t(src), **kw)
    assert seq.shape == (3, 3, 8) and sc.shape == (3, 3)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(seq_j))
    _close(sc, sc_j, 1e-5)
    seq_c, sc_c = tm.beam_decode_cached(_t(src), **kw)
    np.testing.assert_array_equal(seq_c.numpy(), seq.numpy())
    _close(sc_c, sc, 1e-5)


def test_cached_decoders_raise_outside_eval_and_past_the_table():
    ptt.seed(0)
    tm = TT.TransformerNMT(TT.NMTConfig.tiny(), device="cpu")
    src = torch.full((1, 4), 5)
    for fn in (tm.greedy_decode_cached, tm.beam_decode_cached):
        with pytest.raises(EnforceError, match="eval mode"):
            fn(src, max_len=4)
    tm.eval()
    for fn in (tm.greedy_decode_cached, tm.beam_decode_cached):
        with pytest.raises(EnforceError, match="positional table"):
            fn(src, max_len=129)


# ----- training -----------------------------------------------------------------

def test_trainer_losses_match_the_jax_trainer():
    jm, tm = _pair(0)
    cfg = tm.cfg
    src, tgt, labels = _batch(0, 4, 16, 12)

    def jbuild(params, buffers, rng_key, batch):
        logits, nb = jm.functional_call(
            params, batch["src"], batch["tgt_in"], buffers=buffers,
            rng=rng_key, training=rng_key is not None)
        loss = JT.nmt_loss(logits, batch["labels"], pad_id=cfg.pad_id,
                           label_smooth=cfg.label_smooth)
        return loss, (JT.nmt_metrics(logits, batch["labels"], cfg.pad_id),
                      nb)

    def tbuild(model, batch, gen):
        logits = model(batch["src"], batch["tgt_in"])
        return (TT.nmt_loss(logits, batch["labels"], pad_id=cfg.pad_id,
                            label_smooth=cfg.label_smooth),
                TT.nmt_metrics(logits, batch["labels"], cfg.pad_id))

    jt = JP.Trainer(jm, JO.Adam(1e-3), jbuild)
    tt = Trainer(tm, TO.Adam(1e-3), tbuild)
    np.testing.assert_array_equal(tt._key,
                                  np.asarray(jax.random.key_data(jt._rng)))
    jb = {"src": jnp.asarray(src), "tgt_in": jnp.asarray(tgt),
          "labels": jnp.asarray(labels)}
    tb = {k: _t(v) for k, v in (("src", src), ("tgt_in", tgt),
                                ("labels", labels))}
    losses = []
    for _ in range(8):
        jl, _ = jt.train_step(jb)
        tl, metrics = tt.train_step(tb)
        _close(float(tl), float(jl), 1e-4)
        losses.append(float(tl))
    assert losses[-1] < losses[0], losses
    assert 0.0 <= float(metrics["token_acc"]) <= 1.0
