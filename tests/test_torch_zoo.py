"""The rest of the CNN zoo (``models/vgg.py``, ``alexnet.py``,
``googlenet.py``, ``se_resnext.py``) against the JAX package's models on
the same weights, float32 on the CPU, the JAX side jitted. The JAX
models are built with zero initializers (their eager random draws
compile one kernel per parameter shape, most of such a test's time) and
take the port's random weights.

Each model's parameter and buffer names and shapes equal the JAX
model's; then a training-mode forward with dropout at 0 (the two
frameworks draw different masks): the logits, the loss and every
gradient, and the BatchNorm buffers it moved:

- vgg16 at 32 px (``image_size=32``), 10 classes, batch 2;
- alexnet at 224 px (its classifier fixes 6x6 maps), 10 classes,
  batch 1;
- googlenet at 64 px without the auxiliary heads, and each auxiliary
  head at its 14x14 input, with the v1 loss over the (logits, aux1,
  aux2) tuple;
- an SE-ResNeXt of one block a stage in NCHW and NHWC at 64 px (at
  32 px the last stage's BatchNorm normalises 2 values a channel, where
  float32 rounding grows past the limit in both packages' gradients),
  and se_resnext50's eval logits at 32 px in NHWC.

Tolerances: logits and the loss 1e-4 of their largest magnitude (at
least 1); gradients 1e-4 of each parameter's largest JAX-gradient
entry; buffers 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import initializer as JI
from paddle_tpu.models import alexnet as JA
from paddle_tpu.models import googlenet as JG
from paddle_tpu.models import se_resnext as JS
from paddle_tpu.models import vgg as JV
from paddle_tpu_torch.models import alexnet as TA
from paddle_tpu_torch.models import googlenet as TG
from paddle_tpu_torch.models import se_resnext as TS
from paddle_tpu_torch.models import vgg as TV

TOL, BUF_TOL = 1e-4, 1e-5


@pytest.fixture
def zero_init(monkeypatch):
    def zeros(self, key, shape, dtype=jnp.float32):
        return jnp.asarray(np.zeros(shape, np.float32), dtype)

    for cls in (JI.MSRA, JI.XavierUniform):
        monkeypatch.setattr(cls, "__call__", zeros)


def _pair(jm, tm):
    """Names and shapes equal; the JAX model takes the port's weights."""
    jp, jb = jm.named_parameters(), jm.named_buffers()
    tp, tb = dict(tm.named_parameters()), dict(tm.named_buffers())
    assert list(jp) == list(tp) and sorted(jb) == sorted(tb)
    for k in tp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape), k
    for k in tb:
        assert tuple(tb[k].shape) == tuple(jb[k].shape), k
    jm.set_parameters({k: jnp.asarray(v.detach().numpy())
                       for k, v in tp.items()})


def _no_dropout(*models):
    for m in models:
        mods = m.modules() if isinstance(m, torch.nn.Module) else [
            sub for _, sub in m.named_sublayers()]
        for sub in mods:
            if type(sub).__name__ == "Dropout":
                sub.p = 0.0


def _close(got, want, tol, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def _train_check(jm, tm, x, y, jloss, tloss):
    """One training-mode forward and backward in both packages."""
    def f(p):
        out, nb = jm.functional_call(p, jnp.asarray(x), training=True)
        return jloss(out, jnp.asarray(y)), (out, nb)

    (jl, (jout, jnb)), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jm.named_parameters())
    tm.train()
    out = tm(torch.from_numpy(x))
    loss = tloss(out, torch.from_numpy(y))
    loss.backward()
    outs = out if isinstance(out, tuple) else (out,)
    jouts = jout if isinstance(jout, tuple) else (jout,)
    assert len(outs) == len(jouts)
    for i, (o, jo) in enumerate(zip(outs, jouts)):
        _close(o.detach().numpy(), jo, TOL, f"output {i}")
    _close(loss.item(), float(jl), TOL, "loss")
    for k, p in tm.named_parameters():
        g = np.asarray(jg[k])
        got = np.zeros_like(g) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(
            got, g, rtol=0, atol=TOL * max(float(np.abs(g).max()), 1e-30),
            err_msg=k)
    for k, b in tm.named_buffers():
        _close(b.numpy(), jnb[k], BUF_TOL, k)


def _batch(shape, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.integers(0, classes, (shape[0],)).astype(np.int32))


def test_vgg16_matches_jax(zero_init):
    jm = JV.vgg16(10, image_size=32, dropout=0.0)
    tm = TV.vgg16(10, image_size=32, dropout=0.0, device="cpu")
    _pair(jm, tm)
    assert len(dict(tm.named_buffers())) == 2 * 13
    _train_check(jm, tm, *_batch((2, 3, 32, 32)), JV.loss_fn, TV.loss_fn)


def test_alexnet_matches_jax(zero_init):
    jm = JA.alexnet(10, dropout=0.0)
    tm = TA.alexnet(10, dropout=0.0, device="cpu")
    _pair(jm, tm)
    _train_check(jm, tm, *_batch((1, 3, 224, 224), seed=1), JA.loss_fn,
                 TA.loss_fn)


def test_googlenet_matches_jax(zero_init):
    jm = JG.googlenet(10, aux_heads=False)
    tm = TG.googlenet(10, aux_heads=False, device="cpu")
    _pair(jm, tm)
    _no_dropout(jm, tm)
    _train_check(jm, tm, *_batch((2, 3, 64, 64), seed=2), JG.loss_fn,
                 TG.loss_fn)
    # the full model keeps the aux heads' names and shapes; eval mode
    # returns the logits alone
    full = TG.googlenet(10, device="cpu").eval()
    assert "aux2.fc2.weight" in dict(full.named_parameters())
    with torch.no_grad():
        assert full(torch.zeros(1, 3, 64, 64)).shape == (1, 10)


def test_googlenet_aux_heads_and_v1_loss(zero_init):
    """Each auxiliary head at its 14x14 input (i4a's and i4d's maps at
    224 px), and the v1 loss over the (logits, aux1, aux2) tuple."""
    jh, th = JG.AuxHead(512, 10), TG.AuxHead(512, 10, device="cpu")
    _pair(jh, th)
    _no_dropout(jh, th)
    x, y = _batch((2, 512, 14, 14), seed=3)

    def jloss(out, lbl):
        return JG.loss_fn((out, out * 0.5, out * 2.0), lbl)

    def tloss(out, lbl):
        return TG.loss_fn((out, out * 0.5, out * 2.0), lbl)

    _train_check(jh, th, x, y, jloss, tloss)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_se_resnext_matches_jax(zero_init, fmt):
    jm = JS.SEResNeXt((1, 1, 1, 1), 10, data_format=fmt)
    tm = TS.SEResNeXt((1, 1, 1, 1), 10, data_format=fmt, device="cpu")
    _pair(jm, tm)
    _train_check(jm, tm, *_batch((2, 3, 64, 64), seed=4), JS.loss_fn,
                 TS.loss_fn)


def test_se_resnext50_names_and_eval_logits(zero_init):
    jm = JS.se_resnext50(10, data_format="NHWC")
    tm = TS.se_resnext50(10, data_format="NHWC", device="cpu")
    _pair(jm, tm)
    assert len(dict(tm.named_buffers())) == 2 * (1 + 16 * 3 + 4)
    x, _ = _batch((1, 3, 32, 32), seed=5)
    jm.eval()
    want = jax.jit(lambda a: jm(a))(jnp.asarray(x))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got.numpy(), want, TOL, "se_resnext50 logits")
