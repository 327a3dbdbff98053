"""The port's ViT (paddle_tpu_torch/models/vit.py) against the JAX
package on the same weights (crossed with load_numpy_state), float32 on
the CPU, images from numpy seeds, the JAX side jitted, at
``ViTConfig.tiny()`` (32 px, patch 8, hidden 64, 2 layers, 4 heads):

- every parameter name and shape (the creation order, which moves the
  global random stream, is held by tests/test_torch_random.py);
- logits (1e-5), the loss (1e-5) and every gradient (1e-5 of its
  parameter's largest JAX entry; the key projections' biases, whose
  grads are 0 in exact arithmetic, within 1e-5 absolutely) in NHWC and
  NCHW, cls and mean pooling; remat equal to no remat (1e-6), and
  ``scan_layers`` equal to the unrolled encoder;
- a Trainer step (Adam) lowers the loss, as tests/test_vit.py holds the
  JAX package to;
- the flash gate refuses ViT-B/16's attention (197 and 196 tokens at
  head dim 64), as the JAX package's ``flash_shape_ok`` does, so the
  model's attention takes the plain path in both packages;
- typed errors for a patch that does not divide the image, an unknown
  pool and a wrong image size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import vit as JV
from paddle_tpu.ops import attention as JA
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.core import EnforceError
from paddle_tpu_torch.models import vit as TV
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.parallel import Trainer
from paddle_tpu_torch.utils.convert import load_numpy_state


def _close(got, want, atol, msg=""):
    if torch.is_tensor(got):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=msg)


def _pair(seed, **over):
    pt.seed(seed)
    ptt.seed(seed)
    jcfg, tcfg = JV.ViTConfig.tiny(), TV.ViTConfig.tiny()
    for cfg in (jcfg, tcfg):
        for k, v in over.items():
            setattr(cfg, k, v)
    jm, tm = JV.ViT(jcfg), TV.ViT(tcfg, device="cpu")
    load_numpy_state(tm, {k: np.asarray(v)
                          for k, v in jm.named_parameters().items()})
    return jm, tm


def _images(seed, layout, b=3):
    rng = np.random.default_rng(seed)
    shape = (b, 32, 32, 3) if layout == "NHWC" else (b, 3, 32, 32)
    return (rng.normal(size=shape).astype(np.float32),
            rng.integers(0, 10, (b,)))


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_parameter_names_and_shapes_carry_across(pool):
    jm, tm = _pair(0, pool=pool)
    jp = {k: np.shape(v) for k, v in jm.named_parameters().items()}
    tp = {k: tuple(v.shape) for k, v in tm.named_parameters()}
    assert jp == tp
    assert ("cls_token" in tp) == (pool == "cls")
    assert tp["pos_embed"] == (1, 16 + (pool == "cls"), 64)


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_logits_loss_and_grads_match_jax(layout, pool):
    jm, tm = _pair(1, layout=layout, pool=pool)
    x, y = _images(2, layout)

    def jloss(p):
        logits, _ = jm.functional_call(p, jnp.asarray(x), training=True)
        return JV.loss_fn(logits, jnp.asarray(y)), logits

    (want_l, want_logits), want_g = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jm.named_parameters())
    tm.train()
    logits = tm(torch.from_numpy(x))
    loss = TV.loss_fn(logits, torch.from_numpy(y))
    loss.backward()
    assert logits.shape == (3, 10)
    _close(logits, want_logits, 1e-5)
    _close(loss, want_l, 1e-5)
    for name, p in tm.named_parameters():
        w = np.asarray(want_g[name], np.float32)
        scale = (1.0 if name.endswith("k_proj.bias")
                 else max(float(np.abs(w).max()), 1e-30))
        _close(p.grad / scale, w / scale, 1e-5, name)


@pytest.mark.parametrize("option", ["remat", "scan_layers"])
def test_remat_and_scan_layers_are_the_same_math(option):
    _, plain = _pair(3)
    _, other = _pair(3, **{option: True})
    x, y = _images(4, "NHWC")
    out = {}
    for name, model in (("plain", plain), ("other", other)):
        model.train()
        loss = TV.loss_fn(model(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        out[name] = (loss.detach(), {n: p.grad for n, p in
                                     model.named_parameters()})
    _close(out["other"][0], out["plain"][0], 1e-6)
    for n, g in out["plain"][1].items():
        _close(out["other"][1][n], g, 1e-6, n)


def test_trainer_step_lowers_the_loss():
    ptt.seed(5)
    model = TV.ViT(TV.ViTConfig.tiny(), device="cpu")
    x, y = _images(6, "NHWC", b=8)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    tr = Trainer(model, TO.Adam(1e-3),
                 lambda m, b, g: (TV.loss_fn(m(b[0]), b[1]), {}))
    losses = [float(tr.train_step(batch)[0]) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_flash_gate_refuses_vit_b16_attention():
    for t in (197, 196):
        assert not TA.flash_shape_ok(t, t, 64)
        with JA.force_flash():
            assert not JA.flash_shape_ok(t, t, 64)
    assert TA.flash_shape_ok(192, 192, 64)
    base = TV.ViTConfig.base()
    assert (base.image_size // base.patch_size) ** 2 + 1 == 197
    assert base.hidden_size // base.num_heads == 64


def test_typed_errors():
    cfg = TV.ViTConfig.tiny()
    cfg.patch_size = 7
    with pytest.raises(EnforceError, match="divisible"):
        TV.ViT(cfg, device="cpu")
    cfg = TV.ViTConfig.tiny()
    cfg.pool = "max"
    with pytest.raises(EnforceError, match="pool"):
        TV.ViT(cfg, device="cpu")
    model = TV.ViT(TV.ViTConfig.tiny(), device="cpu")
    with pytest.raises(EnforceError, match="patches"):
        model(torch.zeros(1, 40, 40, 3))
