"""The port's layers and ops (paddle_tpu_torch) against the JAX package on
the same numpy inputs, float32 on the CPU, atol 1e-5: Linear, Embedding,
RMSNorm, rotary_embedding, xla_attention and the decoding filters."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.ops import attention as JA
from paddle_tpu.ops import sampling as JS
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.ops import sampling as TS
from paddle_tpu_torch.utils.convert import load_numpy_state

ATOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _cross(jax_layer, torch_layer):
    load_numpy_state(torch_layer, {k: np.asarray(v) for k, v in
                                   jax_layer.named_parameters().items()})


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    pt.seed(1)
    jl = pt.nn.Linear(24, 40, bias_attr=bias)
    tl = tnn.Linear(24, 40, bias_attr=bias, device="cpu")
    if bias:
        # a non-zero bias, so the add is exercised
        jl.set_parameters({"bias": _rng(2).normal(size=(40,)).astype(
            np.float32)})
    _cross(jl, tl)
    x = _rng(3).normal(size=(2, 5, 24)).astype(np.float32)
    _close(tl(torch.from_numpy(x)).detach(), jl(jnp.asarray(x)))


@pytest.mark.parametrize("padding_idx", [None, 3])
def test_embedding(padding_idx):
    pt.seed(4)
    je = pt.nn.Embedding(50, 16, padding_idx=padding_idx)
    te = tnn.Embedding(50, 16, padding_idx=padding_idx, device="cpu")
    _cross(je, te)
    ids = _rng(5).integers(0, 50, (3, 7))
    ids[0, 0] = 3
    _close(te(torch.from_numpy(ids)).detach(), je(jnp.asarray(ids)))


def test_rms_norm():
    jn = pt.nn.RMSNorm(32)
    tn = tnn.RMSNorm(32, device="cpu")
    jn.set_parameters({"weight": _rng(6).normal(size=(32,)).astype(
        np.float32)})
    _cross(jn, tn)
    x = _rng(7).normal(size=(2, 3, 32)).astype(np.float32) * 3.0
    _close(tn(torch.from_numpy(x)).detach(), jn(jnp.asarray(x)))


@pytest.mark.parametrize("pos_shape", ["T", "BT"])
@pytest.mark.parametrize("d", [32, 64])
def test_rotary_embedding(pos_shape, d):
    rng = _rng(8)
    x = rng.normal(size=(2, 9, 4, d)).astype(np.float32)
    if pos_shape == "T":
        pos = np.arange(9, dtype=np.int32) + 100
    else:
        pos = rng.integers(0, 2048, (2, 9)).astype(np.int32)
    got = TA.rotary_embedding(torch.from_numpy(x), torch.from_numpy(pos))
    want = JA.rotary_embedding(jnp.asarray(x), jnp.asarray(pos))
    _close(got, want)


def _attn_case(name, rng):
    b, tq, tk, h, kv, d = 2, 6, 6, 4, 2, 16
    kw = {}
    if name == "gqa":
        pass
    elif name == "mqa_causal":
        kv = 1
        kw["causal"] = True
    elif name == "key_mask":
        m = np.ones((b, 1, 1, tk), bool)
        m[0, ..., 4:] = False
        kw["mask"] = m
    elif name == "per_query_mask":
        tq = 4
        kw["mask"] = rng.random((tq, tk)) > 0.3
    elif name == "fully_masked_row":
        m = np.ones((1, 1, tq, tk), bool)
        m[..., 2, :] = False
        kw["mask"] = m
    elif name == "causal_window":
        kw.update(causal=True, window=3)
    elif name == "band_window":
        kw["window"] = 2
    elif name == "causal_key_mask":
        m = np.ones((b, 1, 1, tk), bool)
        m[1, ..., :2] = False
        kw.update(causal=True, mask=m)
    q = rng.normal(size=(b, tq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, tk, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, tk, kv, d)).astype(np.float32)
    return q, k, v, kw


@pytest.mark.parametrize("name", [
    "gqa", "mqa_causal", "key_mask", "per_query_mask", "fully_masked_row",
    "causal_window", "band_window", "causal_key_mask"])
def test_xla_attention(name):
    q, k, v, kw = _attn_case(name, _rng(9))
    tkw = {key: torch.from_numpy(val) if isinstance(val, np.ndarray)
           else val for key, val in kw.items()}
    jkw = {key: jnp.asarray(val) if isinstance(val, np.ndarray) else val
           for key, val in kw.items()}
    got = TA.xla_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), **tkw)
    want = JA.xla_attention(jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v), **jkw)
    _close(got, want)
    if name == "fully_masked_row":
        assert np.all(got.numpy()[:, 2] == 0.0)


def _logits_case(name):
    rng = _rng(10)
    x = rng.normal(size=(3, 40)).astype(np.float32) * 2.0
    if name == "ties_at_kth":
        # rows whose 3rd and 4th largest values tie: both survive top-3
        x[:, :5] = np.array([5.0, 4.0, 3.0, 3.0, 2.0], np.float32)
        x[:, 5:] = -10.0
    elif name == "dominant_top":
        x[:, 7] = 40.0
    return x


@pytest.mark.parametrize("name,temperature,top_k,top_p", [
    ("plain", 0.7, 0, 1.0),
    ("ties_at_kth", 1.0, 3, 1.0),
    ("plain", 1.3, 5, 1.0),
    ("plain", 1.0, 0, 0.9),
    ("plain", 0.8, 10, 0.5),
    ("dominant_top", 1.0, 0, 0.01),
    ("plain", 1.0, 0, 0.999999),
    ("ties_at_kth", 1.0, 0, 0.6),
])
def test_filter_logits(name, temperature, top_k, top_p):
    x = _logits_case(name)
    got = TS.filter_logits(torch.from_numpy(x), temperature, top_k, top_p)
    want = JS.filter_logits(jnp.asarray(x), temperature, top_k, top_p)
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    _close(got, want)
    if name == "ties_at_kth" and top_k == 3:
        assert np.all(np.isfinite(got[:, :4]))


def test_top_p_rejects_nonpositive():
    from paddle_tpu_torch.core import EnforceError

    with pytest.raises(EnforceError, match="top_p"):
        TS.top_p_logits(torch.zeros(2, 4), 0.0)
