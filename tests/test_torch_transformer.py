"""The port's encoder pieces against the JAX package, float32 on the CPU:
``Dropout``, ``LayerNorm``, ``TransformerEncoder`` (post-norm and
pre-norm), ``pack_sequences``, ``softmax_with_cross_entropy`` and
``accuracy``.

- Dropout: eval mode is the identity and ``downgrade_in_infer`` scales by
  1 - p, exactly; in training the keep rate lies within 5 sigma of 1 - p
  (binomial over the entries), kept entries are exactly x / (1 - p)
  (``upscale_in_train``) or x (``downgrade_in_infer``), the mask is a
  function of the generator's seed, and a training forward with no
  generator in scope raises. The masks are torch's, not JAX's (the two
  random streams differ), so only these properties are compared.
- LayerNorm at 1e-6 (float32 mean and variance over 48 entries in two
  frameworks' orders).
- TransformerEncoder, 2 layers, d_model 128, 2 heads (head_dim 64), FFN
  256, dropout 0, batch 2, T=64, weights crossed with load_numpy_state:
  outputs at 1e-5, each parameter's grad within 1e-4 of its largest JAX
  grad entry (float32 sums through two blocks, observed ~1e-6); the
  key projection's bias, whose grad is 0 in exact arithmetic, at 1e-5
  absolute.
- Packed isolation: a row [A | B] gives segment A the encoder output of
  A alone (1e-5), as tests/test_transformer.py holds the JAX package to.
- pack_sequences: the same batches as the JAX package's for one reader,
  exactly. The loss and metric ops: 1e-6 and exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import metrics as JM
from paddle_tpu.data.bucketing import pack_sequences as jpack
from paddle_tpu.nn import layers as JL
from paddle_tpu.nn import transformer as JT
from paddle_tpu.ops import loss as JLoss
from paddle_tpu_torch import metrics as TM
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import EnforceError, rng_scope
from paddle_tpu_torch.data import pack_sequences as tpack
from paddle_tpu_torch.nn import transformer as TT
from paddle_tpu_torch.ops import loss as TLoss
from paddle_tpu_torch.utils.convert import load_numpy_state


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=0)


# ----- Dropout ---------------------------------------------------------------

def test_dropout_eval_mode():
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tnn.Dropout(0.3).eval()(x), x)
    assert torch.equal(tnn.Dropout(0.0).train()(x), x)
    down = tnn.Dropout(0.3, mode="downgrade_in_infer").eval()
    assert torch.equal(down(x), x * (1.0 - 0.3))


@pytest.mark.parametrize("mode", ["upscale_in_train", "downgrade_in_infer"])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_training(mode, p):
    x = torch.rand(64, 256, generator=torch.Generator().manual_seed(1)) + 1
    layer = tnn.Dropout(p, mode=mode).train()
    with rng_scope(torch.Generator().manual_seed(7)):
        y = layer(x)
    kept = y != 0
    n = x.numel()
    rate = kept.float().mean().item()
    assert abs(rate - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)
    want = x / (1 - p) if mode == "upscale_in_train" else x
    assert torch.equal(y[kept], want[kept])
    # the same seed gives the same mask, another seed another one
    with rng_scope(torch.Generator().manual_seed(7)):
        assert torch.equal(layer(x), y)
    with rng_scope(torch.Generator().manual_seed(8)):
        assert not torch.equal(layer(x), y)


def test_dropout_without_a_generator_raises():
    x = torch.ones(4, 4)
    with pytest.raises(EnforceError, match="torch.Generator"):
        tnn.Dropout(0.1).train()(x)
    mha = tnn.MultiHeadAttention(32, 2, dropout=0.1, device="cpu").train()
    with pytest.raises(EnforceError, match="torch.Generator"):
        mha(torch.zeros(1, 4, 32))


# ----- LayerNorm -------------------------------------------------------------

@pytest.mark.parametrize("scale,shift", [(True, True), (False, True),
                                         (True, False)])
def test_layer_norm_matches_jax(scale, shift):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32) * 3 + 1
    jl = JL.LayerNorm(48, scale=scale, shift=shift)
    tl = tnn.LayerNorm(48, scale=scale, shift=shift, device="cpu")
    params = {k: rng.normal(size=np.shape(v)).astype(np.float32)
              for k, v in jl.named_parameters().items()}
    assert set(params) == set(dict(tl.named_parameters()))
    load_numpy_state(tl, params)
    want, _ = jl.functional_call({k: jnp.asarray(v)
                                  for k, v in params.items()},
                                 jnp.asarray(x))
    _close(tl(torch.from_numpy(x)).detach(), want, 1e-6)


# ----- TransformerEncoder ----------------------------------------------------

ENC = dict(num_layers=2, d_model=128, nhead=2, dim_feedforward=256,
           dropout=0.0)


def _encoder_pair(normalize_before, seed=0):
    pt.seed(seed)
    je = JT.TransformerEncoder(normalize_before=normalize_before, **ENC)
    te = TT.TransformerEncoder(normalize_before=normalize_before,
                               device="cpu", **ENC)
    load_numpy_state(te, {k: np.asarray(v)
                          for k, v in je.named_parameters().items()})
    return je, te


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_and_grads_match_jax(normalize_before):
    je, te = _encoder_pair(normalize_before)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 64, 128)).astype(np.float32)
    ct = rng.normal(size=(2, 64, 128)).astype(np.float32)
    mask = np.ones((2, 1, 1, 64), bool)
    mask[1, ..., 50:] = False

    def jout(p):
        out, _ = je.functional_call(p, jnp.asarray(x),
                                    mask=jnp.asarray(mask), training=True)
        return out

    want, vjp = jax.vjp(jout, je.named_parameters())
    (want_g,) = vjp(jnp.asarray(ct))
    te.train()
    got = te(torch.from_numpy(x), mask=torch.from_numpy(mask))
    (got * torch.from_numpy(ct)).sum().backward()
    _close(got.detach(), want, 1e-5)
    for name, p in te.named_parameters():
        w = np.asarray(want_g[name])
        # k_proj.bias's grad is 0 in exact arithmetic (a bias added to
        # every key shifts a softmax row, which cancels), ~1e-6 of
        # rounding here: the floor of 0.1 holds it at 1e-5 absolute
        scale = max(np.abs(w).max(), 0.1)
        _close(p.grad / scale, w / scale, 1e-4)


def test_packed_segments_are_isolated():
    """A packed row of [A | B] gives segment A the same encoder output
    as running A alone: attention never crosses segments."""
    _, te = _encoder_pair(False, seed=1)
    te.eval()
    rng = np.random.default_rng(4)
    la, lb = 24, 40
    a = torch.from_numpy(rng.normal(size=(1, la, 128)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(1, lb, 128)).astype(np.float32))
    segs = torch.tensor([[1] * la + [2] * lb], dtype=torch.int32)
    with torch.no_grad():
        packed = te(torch.cat([a, b], 1), segment_ids=segs)
        alone = te(a, segment_ids=torch.ones((1, la), dtype=torch.int32))
    _close(packed[0, :la], alone[0], 1e-5)


def test_encoder_options_of_later_slices_raise():
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.core import InvalidArgumentError

    # the Switch-MoE FFN (item 9) is ported (tests/test_torch_moe.py
    # holds it against the JAX encoder); with unrolled remat it raises
    # a typed error, as the JAX encoder cannot run it
    enc = TT.TransformerEncoder(moe_experts=4, device="cpu", **ENC)
    assert type(enc.layers[0].ffn).__name__ == "SwitchFFN"
    assert enc(torch.zeros(1, 8, 128)).shape == (1, 8, 128)
    with pytest.raises(InvalidArgumentError, match="remat"):
        TT.TransformerEncoder(moe_experts=4, remat=True, device="cpu",
                              **ENC)
    # seq_parallel is ported (tests/test_torch_seq_parallel.py): with no
    # mesh the ring is one hop, the plain encoder's attention
    seed(2)
    ring = TT.TransformerEncoder(seq_parallel="ring", device="cpu", **ENC)
    seed(2)
    plain = TT.TransformerEncoder(device="cpu", **ENC)
    x = torch.randn(1, 8, 128, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        _close(ring(x), plain(x), 1e-5)
    enc = TT.TransformerEncoder(scan_layers=True, device="cpu",
                                **dict(ENC, dropout=0.1)).train()
    with pytest.raises(EnforceError, match="scan_layers"):
        enc(torch.zeros(1, 8, 128))


# ----- data, loss and metric ops -------------------------------------------

def test_pack_sequences_matches_jax():
    def reader():
        rng = np.random.default_rng(5)
        for _ in range(40):
            yield rng.integers(3, 1000, int(rng.integers(4, 33)))

    for kw in (dict(capacity=32, batch_size=3),
               dict(capacity=48, batch_size=2, pad_value=-1, min_fill=0.5)):
        want = list(jpack(reader, **kw)())
        got = list(tpack(reader, **kw)())
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("soft", [False, True])
def test_softmax_with_cross_entropy_matches_jax(soft):
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(5, 7)).astype(np.float32) * 3
    if soft:
        label = rng.random(size=(5, 7)).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
    else:
        label = np.array([0, 6, -100, 3, 2])
    want, want_sm = JLoss.softmax_with_cross_entropy(
        jnp.asarray(logits), jnp.asarray(label), soft_label=soft,
        return_softmax=True)
    got, got_sm = TLoss.softmax_with_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(label), soft_label=soft,
        return_softmax=True)
    assert got.shape == want.shape
    _close(got, want, 1e-6)
    _close(got_sm, want_sm, 1e-6)


@pytest.mark.parametrize("k", [1, 3])
def test_accuracy_matches_jax(k):
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(64, 10)).astype(np.float32)
    logits[0, :] = 0.0              # a tie
    label = rng.integers(0, 10, (64, 1))
    want = JM.accuracy(jnp.asarray(logits), jnp.asarray(label), k=k)
    got = TM.accuracy(torch.from_numpy(logits), torch.from_numpy(label),
                      k=k)
    assert got.item() == float(want)
