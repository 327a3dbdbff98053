"""The convolutional models (``models/mnist.py`` MnistCNN,
``models/resnet.py``) against the JAX package's on the same weights
(crossed with ``load_numpy_state``, BatchNorm buffers included), float32
on the CPU:

- MnistCNN and ``resnet20_cifar`` in both layouts: the training-mode
  logits, the loss and every gradient, then one ``Trainer.supervised``
  Adam(1e-3) step against the JAX Trainer's: its loss, the gradients it
  took and the BatchNorm buffers after it;
- ``resnet50``: its parameter and buffer names and shapes equal the JAX
  model's, and one eval forward at 32 px, batch 1, ``num_classes=10``;
- a ``resnet20_cifar`` JAX Trainer checkpoint restores into the port's
  Trainer (parameters, buffers, Adam state and key bit for bit) and the
  port's, one step later, back into the JAX Trainer.

Tolerances: logits and the loss 1e-4 (float32 through up to 20 convs in
two libraries' orders; ResNet-50's eval logits, ~400 at random weights,
1e-4 of their largest magnitude); gradients within 1e-4 of each
parameter's largest JAX-gradient entry; buffers 1e-5; checkpoints
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JP
from paddle_tpu.models import mnist as JM
from paddle_tpu.models import resnet as JR
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.models import mnist as TM
from paddle_tpu_torch.models import resnet as TR
from paddle_tpu_torch.parallel import Trainer
from paddle_tpu_torch.utils.convert import load_numpy_state

LOGIT_TOL, GRAD_TOL, BUF_TOL = 1e-4, 1e-4, 1e-5


def _state(jm):
    return {k: np.asarray(v) for k, v in {**jm.named_parameters(),
                                          **jm.named_buffers()}.items()}


def _models(name):
    pt.seed(0)
    if name == "mnist_cnn":
        jm, tm = JM.MnistCNN(), TM.MnistCNN(device="cpu")
        shape = (4, 1, 28, 28)
    else:
        fmt = name.split("_")[-1].upper()
        jm = JR.resnet20_cifar(data_format=fmt)
        tm = TR.resnet20_cifar(data_format=fmt, device="cpu")
        shape = (2, 3, 16, 16)
    load_numpy_state(tm, _state(jm))
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    y = rng.integers(0, 10, (shape[0],)).astype(np.int32)
    return jm, tm, x, y


def _close(got, want, tol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("name", ["mnist_cnn", "resnet20_nchw",
                                  "resnet20_nhwc"])
def test_forward_grads_and_a_trainer_step_match_jax(name):
    jm, tm, x, y = _models(name)
    loss_fn = JM.loss_fn if name == "mnist_cnn" else JR.loss_fn
    tloss_fn = TM.loss_fn if name == "mnist_cnn" else TR.loss_fn
    params = jm.named_parameters()

    def jloss(p):
        out, nb = jm.functional_call(p, jnp.asarray(x), training=True)
        return loss_fn(out, jnp.asarray(y)), (out, nb)

    (jl, (jout, jbuf)), jgrad = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    tm.train()
    tout = tm(torch.from_numpy(x))
    _close(tout.detach().numpy(), jout, LOGIT_TOL, "logits")
    # the same step through both Trainers
    jt = JP.Trainer.supervised(jm, JO.Adam(1e-3), loss_fn)
    tt = Trainer.supervised(tm, TO.Adam(1e-3), tloss_fn)
    load_numpy_state(tm, _state(jm))           # undo the forward above
    jstep, _ = jt.train_step({"x": jnp.asarray(x), "label": jnp.asarray(y)})
    tstep, _ = tt.train_step({"x": torch.from_numpy(x),
                              "label": torch.from_numpy(y)})
    _close(float(tstep), float(jl), LOGIT_TOL, "loss")
    _close(float(tstep), float(jstep), LOGIT_TOL, "trainer loss")
    for k, g in jgrad.items():
        g = np.asarray(g)
        _close(tt.params[k].grad.numpy(), g,
               GRAD_TOL * max(1.0, float(np.abs(g).max())), k)
    bufs = dict(tm.named_buffers())
    assert set(bufs) == set(jt.buffers)
    assert len(bufs) == (0 if name == "mnist_cnn" else 2 * 21)
    for k, b in bufs.items():
        _close(b.numpy(), jt.buffers[k], BUF_TOL, k)
        _close(b.numpy(), jbuf[k], BUF_TOL, k)


def test_resnet50_names_shapes_and_a_forward(monkeypatch):
    # the JAX model is built with zero weights (its eager initializers
    # compile one random kernel per parameter shape, most of the time
    # such a test would take) and then takes the port's random weights
    from paddle_tpu import initializer as JI

    def zeros(self, key, shape, dtype=jnp.float32):
        return jnp.asarray(np.zeros(shape, np.float32), dtype)

    for cls in (JI.MSRA, JI.XavierUniform):
        monkeypatch.setattr(cls, "__call__", zeros)
    jm = JR.resnet50(10)
    tm = TR.resnet50(10, device="cpu")
    jp, jb = jm.named_parameters(), jm.named_buffers()
    tp, tb = dict(tm.named_parameters()), dict(tm.named_buffers())
    assert sorted(jp) == sorted(tp) and sorted(jb) == sorted(tb)
    assert len(tb) == 2 * 53                     # a BatchNorm per conv
    for k in tp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape), k
    for k in tb:
        assert tuple(tb[k].shape) == tuple(jb[k].shape), k
        assert tb[k].dtype == torch.float32
    jm.set_parameters({k: jnp.asarray(v.detach().numpy())
                       for k, v in tp.items()})
    x = np.random.default_rng(2).normal(size=(1, 3, 32, 32)).astype(
        np.float32)
    jm.eval()
    want = jax.jit(lambda a: jm(a))(jnp.asarray(x))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (1, 10)
    # BatchNorm at its initial statistics (0, 1) normalises nothing in eval
    # mode, so random weights carry the logits to ~400: held relative to
    # their largest magnitude
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    _close(got.numpy(), want, LOGIT_TOL * scale, "resnet50 logits")


def _key(jt):
    return np.asarray(jax.random.key_data(jt._rng))


def _assert_same_state(tt, jt):
    for k, p in tt.params.items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(jt.params[k]), k)
    for k, b in tt._buffers().items():
        np.testing.assert_array_equal(b.numpy(), np.asarray(jt.buffers[k]),
                                      k)
    jst = jax.tree_util.tree_map(np.asarray, jt.opt_state)
    for k in ("m", "v"):
        if k in jst:
            for name, v in jst[k].items():
                np.testing.assert_array_equal(
                    tt.opt_state[k][name].numpy(), v, name)
    np.testing.assert_array_equal(tt._key, _key(jt))


def test_resnet20_checkpoints_cross_both_ways(tmp_path):
    jm, tm, x, y = _models("resnet20_nchw")
    jt = JP.Trainer.supervised(jm, JO.Adam(1e-3), JR.loss_fn)
    tt = Trainer.supervised(tm, TO.Adam(1e-3), TR.loss_fn)
    jbatch = {"x": jnp.asarray(x), "label": jnp.asarray(y)}
    tbatch = {"x": torch.from_numpy(x), "label": torch.from_numpy(y)}
    jt.train_step(jbatch)
    jt.save_checkpoint(str(tmp_path / "jax"))
    tt.restore_checkpoint(str(tmp_path / "jax"))
    _assert_same_state(tt, jt)
    tt.train_step(tbatch)
    tt.save_checkpoint(str(tmp_path / "port"))
    jt.restore_checkpoint(str(tmp_path / "port"))
    _assert_same_state(tt, jt)
    jl, _ = jt.train_step(jbatch)
    tl, _ = tt.train_step(tbatch)
    _close(float(tl), float(jl), LOGIT_TOL, "loss after the round trip")
