"""The SSD head path of the port against the JAX package's, on the CPU:
``nn.MultiBoxHead`` at MobileNet-SSD's geometry (PaddlePaddle models'
``PaddleCV/ssd/mobilenet_ssd.py``: six maps of 19, 10, 5, 3, 2 and 1
cells, 300 px, 21 classes, min sizes 60-285, the first map with no max
size, aspect ratios [2] then [2, 3], flip: 1917 priors) at narrow
widths (8-16 channels a map), the JAX weights carried across by name
(``load_numpy_state``), on seeded numpy feature maps and padded ground
truth (1-4 boxes an image, labels in 1..20):

- the head's locations and confidences within 1e-5, its priors and
  variances within 1e-6;
- ``ssd_loss`` (mean over the batch) within 1e-4 and every parameter's
  gradient within 1e-4 of its largest JAX entry;
- one Adam(1e-3) step through each package's Trainer: the losses within
  1e-4, the parameters after it within 1e-5;
- ``detection_output`` on the same head outputs: labels and valid
  masks equal, scores and boxes within 1e-5;
- ``DetectionMAP`` over the decoded boxes against the JAX package's
  ``detection_map`` (its ``DetectionMAP`` cannot be built: ROADMAP's
  observations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import metrics as JMet
from paddle_tpu.nn import layers as jnn
from paddle_tpu import optimizer as JO
from paddle_tpu import parallel as JP
from paddle_tpu.ops import detection as JD
from paddle_tpu_torch import metrics as TMet
from paddle_tpu_torch.nn import layers as tnn
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.ops import detection as TD
from paddle_tpu_torch.parallel import Trainer
from paddle_tpu_torch.utils.convert import load_numpy_state

MAPS = (19, 10, 5, 3, 2, 1)
CHANNELS = (8, 16, 8, 8, 8, 8)
HEAD = dict(image_size=300, num_classes=21, base_size=300,
            min_sizes=[60.0, 105.0, 150.0, 195.0, 240.0, 285.0],
            max_sizes=[[], 150.0, 195.0, 240.0, 285.0, 300.0],
            aspect_ratios=[[2.0]] + [[2.0, 3.0]] * 5, flip=True,
            offset=0.5)
B, G = 2, 4


def _features(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, c, s, s)).astype(np.float32)
            for c, s in zip(CHANNELS, MAPS)]


def _ground_truth(seed=1):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.0, 0.6, (B, G, 2))
    wh = rng.uniform(0.1, 0.4, (B, G, 2))
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    label = rng.integers(1, 21, (B, G)).astype(np.int32)
    mask = np.arange(G)[None, :] < np.array([[4], [1]])
    return gt, label, mask


@pytest.fixture(scope="module")
def heads():
    pt.seed(0)
    ptt.seed(0)
    jh = jnn.MultiBoxHead(CHANNELS, **HEAD)
    th = tnn.MultiBoxHead(CHANNELS, **HEAD, device="cpu")
    load_numpy_state(th, {k: np.asarray(v)
                          for k, v in jh.named_parameters().items()})
    return jh, th


def _jax_loss(jh, gt, label, mask):
    def loss(params, feats):
        (loc, conf, pb, pv), _ = jh.functional_call(params, feats)
        return jnp.mean(JD.ssd_loss(loc, conf, gt, label, pb, pv, mask)), (
            loc, conf, pb, pv)
    return loss


def test_head_geometry_and_outputs_match_jax(heads):
    jh, th = heads
    assert th.num_priors == jh.num_priors == [3, 6, 6, 6, 6, 6]
    assert sorted(dict(th.named_parameters())) == sorted(
        jh.named_parameters())
    assert "loc_convs.0.weight" in dict(th.named_parameters())
    feats = _features()
    (want, _) = jax.jit(lambda p, f: jh.functional_call(p, f))(
        jh.named_parameters(), [jnp.asarray(f) for f in feats])
    got = th([torch.from_numpy(f) for f in feats])
    assert got[0].shape == (B, 1917, 4) and got[1].shape == (B, 1917, 21)
    assert got[2].shape == got[3].shape == (1917, 4)
    for i, (g, w) in enumerate(zip(got, want)):
        tol = 1e-5 if i < 2 else 1e-6
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=tol, rtol=tol, err_msg=str(i))


def test_ssd_loss_and_gradients_match_jax(heads):
    jh, th = heads
    feats = _features()
    gt, label, mask = _ground_truth()
    (jl, _), jg = jax.jit(jax.value_and_grad(
        _jax_loss(jh, gt, label, mask), has_aux=True))(
        jh.named_parameters(), [jnp.asarray(f) for f in feats])
    th.zero_grad()
    loc, conf, pb, pv = th([torch.from_numpy(f) for f in feats])
    tl = TD.ssd_loss(loc, conf, torch.from_numpy(gt),
                     torch.from_numpy(label), pb, pv,
                     torch.from_numpy(mask)).mean()
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-4, rtol=1e-4)
    for k, p in th.named_parameters():
        want = np.asarray(jg[k])
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-4 * scale,
                                   rtol=0, err_msg=k)


def test_one_adam_step_matches_the_jax_trainer():
    pt.seed(3)
    ptt.seed(3)
    jh = jnn.MultiBoxHead(CHANNELS, **HEAD)
    th = tnn.MultiBoxHead(CHANNELS, **HEAD, device="cpu")
    load_numpy_state(th, {k: np.asarray(v)
                          for k, v in jh.named_parameters().items()})
    gt, label, mask = _ground_truth(2)

    def jbuild(params, buffers, rng, feats):
        (loc, conf, pb, pv), nb = jh.functional_call(
            params, feats, buffers=buffers, rng=rng)
        return jnp.mean(JD.ssd_loss(loc, conf, gt, label, pb, pv, mask)), (
            {}, nb)

    tgt = [torch.from_numpy(a) for a in (gt, label, mask)]

    def tbuild(model, feats, gen):
        loc, conf, pb, pv = model(feats)
        return TD.ssd_loss(loc, conf, tgt[0], tgt[1], pb, pv,
                           tgt[2]).mean(), {}

    jt = JP.Trainer(jh, JO.Adam(1e-3), jbuild)
    tt = Trainer(th, TO.Adam(1e-3), tbuild)
    feats = _features(4)
    jl, _ = jt.train_step([jnp.asarray(f) for f in feats])
    tl, _ = tt.train_step([torch.from_numpy(f) for f in feats])
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-4, rtol=1e-4)
    for k, p in tt.params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jt.params[k]), atol=1e-5,
                                   err_msg=k)


def test_detection_output_and_map_match_jax(heads):
    jh, _ = heads
    feats = _features()
    (loc, conf, pb, pv), _ = jax.jit(lambda p, f: jh.functional_call(p, f))(
        jh.named_parameters(), [jnp.asarray(f) for f in feats])
    # the same head outputs into both decoders, logits spread so that
    # near-equal class scores do not hang on rounding
    loc, conf, pb, pv = (np.asarray(a) for a in (loc, conf, pb, pv))
    conf = conf * 4.0
    kw = dict(nms_threshold=0.45, nms_top_k=100, keep_top_k=50)
    want = jax.jit(lambda *a: JD.detection_output(*a, **kw))(
        loc, conf, pb, pv)
    got = TD.detection_output(*(torch.from_numpy(a) for a in
                                (loc, conf, pb, pv)), **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0][..., 0].numpy(),
                                  np.asarray(want[0])[..., 0])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=1e-5)
    assert bool(got[1].any())
    gt, label, mask = _ground_truth()
    metric = TMet.DetectionMAP(num_classes=21, overlap_threshold=0.1)
    maps = []
    for i in range(B):
        out, valid = got[0][i], got[1][i]
        det = (out[valid, 2:], out[valid, 1], out[valid, 0].long())
        gts = (torch.from_numpy(gt[i][mask[i]]),
               torch.from_numpy(label[i][mask[i]]))
        metric.update(*det, *gts)
        maps.append(JMet.detection_map(
            *(d.numpy() for d in det), *(g.numpy() for g in gts),
            num_classes=21, overlap_threshold=0.1))
    assert metric.eval() == pytest.approx(float(np.mean(maps)), abs=1e-12)
    with pytest.raises(TypeError):
        JMet.DetectionMAP(num_classes=21)
