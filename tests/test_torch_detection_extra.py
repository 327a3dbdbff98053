"""``ops/detection_extra.py`` of the port against the JAX package's, on
the CPU: one case per function, the same numpy-seeded inputs through
both (the JAX side jitted), float outputs within atol 1e-5 + rtol 1e-5
(integer and bool outputs equal), gradients of a fixed random
projection within 1e-5 (1e-4 for ``yolov3_loss``, a loss over a head).

The cases hold: a RoI batch index past the batch (``x[b]`` clamps),
``mine_hard_examples`` with equal losses (``jnp.argsort`` is stable),
``box_decoder_and_assign`` with deltas exactly at and past its clip
bound (the gradient splits at the bound), ``yolov3_loss`` with padded
ground truth, two gts in one cell (``.at[].max``) and the label-smoothed
targets. The host-side mask ops are held against the JAX package's own
golden vectors (``tests/test_chunk_mask_ops.py``, the pycocotools frPoly
output) and against the JAX functions on the same polygons."""

import functools

import numpy as np
import pytest

from paddle_tpu.ops import detection_extra as J
from paddle_tpu_torch.ops import detection_extra as T
from test_chunk_mask_ops import GOLDEN_MASK, GOLDEN_POLY
from torch_parity import check_pair

RNG = np.random.default_rng(12)
P = functools.partial


def f32(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def boxes(n, scale=1.0):
    xy = RNG.uniform(0.0, 0.7, (n, 2))
    wh = RNG.uniform(0.05, 0.35, (n, 2))
    return (np.concatenate([xy, xy + wh], 1) * scale).astype(np.float32)


def _rois5(n, batch, scale):
    return np.concatenate([np.asarray(batch, np.float32)[:, None],
                           boxes(n, scale)], 1)


def _quads(n, batch):
    """(R, 9) [batch, tl, tr, br, bl] quads inside a 9 x 8 map, one
    reaching past its edge."""
    out = []
    for i in range(n):
        x0, y0 = RNG.uniform(0, 4, 2)
        w, h = RNG.uniform(2, 4, 2)
        q = [x0, y0, x0 + w, y0 + 0.3, x0 + w + 0.5, y0 + h, x0 - 0.2,
             y0 + h - 0.4]
        out.append([batch[i]] + q)
    out[-1][5:7] = [12.0, 10.0]
    return np.asarray(out, np.float32)


ANCHORS9 = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90, 156,
            198, 373, 326]


def _yolo_gt(n, b):
    cxcy = RNG.uniform(0.05, 0.95, (n, b, 2))
    wh = RNG.uniform(0.02, 0.6, (n, b, 2))
    gt = np.concatenate([cxcy, wh], -1).astype(np.float32)
    gt[0, -2:] = 0.0                              # padded slots
    gt[1, 1, :2] = gt[1, 0, :2]                   # two gts in one cell
    return gt, RNG.integers(0, 4, (n, b)).astype(np.int32)


YOLO_GT, YOLO_LABEL = _yolo_gt(2, 6)
DEC_TARGET = f32(5, 12) * 3
DEC_TARGET[0, 2] = np.float32(4.135)       # exactly at the clip bound
DEC_TARGET[1, 7] = -9.0                     # past it
TIED_LOSS = np.array([[0.5, 0.2, 0.5, 0.9, 0.5, 0.1, 0.5, 0.3],
                      [0.4, 0.4, 0.4, 0.4, 0.1, 0.1, 0.2, 0.3]], np.float32)

# name -> (JAX fn, port fn, args, grad positions, atol)
CASES = {
    "psroi_pool": (P(J.psroi_pool, output_size=(3, 3), spatial_scale=0.5),
                   P(T.psroi_pool, output_size=(3, 3), spatial_scale=0.5),
                   [f32(2, 18, 7, 8), _rois5(4, [0, 1, 3, 0], 14)], (0,),
                   1e-5),
    "roi_perspective_transform": (
        P(J.roi_perspective_transform, transformed_height=4,
          transformed_width=5),
        P(T.roi_perspective_transform, transformed_height=4,
          transformed_width=5),
        [f32(2, 3, 8, 9), _quads(3, [1, 0, 5])], (0, 1), 1e-5),
    "rpn_target_assign": (P(J.rpn_target_assign, rpn_positive_overlap=0.5),
                          P(T.rpn_target_assign, rpn_positive_overlap=0.5),
                          [boxes(30, 100), boxes(4, 100)], (), 1e-5),
    "mine_hard_examples": (P(J.mine_hard_examples, neg_pos_ratio=1.5),
                           P(T.mine_hard_examples, neg_pos_ratio=1.5),
                           [TIED_LOSS, np.array([[0, 1, 0, 0, 2, 0, 0, 0],
                                                 [1, 0, 0, 0, 0, 0, 0, 0]],
                                                np.int32)], (), 1e-5),
    "box_decoder_and_assign": (
        J.box_decoder_and_assign, T.box_decoder_and_assign,
        [boxes(5, 50), np.where(RNG.random((5, 4)) < 0.5, 1.0, 0.2).astype(
            np.float32), DEC_TARGET,
         np.array([[0.1, 0.7, 0.7], [0.3, 0.2, 0.1], [0.0, 0.5, 0.9],
                   [0.4, 0.4, 0.4], [0.9, 0.1, 0.2]], np.float32)],
        (0, 1, 2), 1e-5),
    "generate_proposal_labels": (
        P(J.generate_proposal_labels, bg_thresh_lo=0.05),
        P(T.generate_proposal_labels, bg_thresh_lo=0.05),
        [np.concatenate([boxes(10)]), boxes(3), np.array([3, 1, 7],
                                                         np.int32)],
        (), 1e-5),
    "yolov3_loss": (
        P(J.yolov3_loss, anchors=ANCHORS9, anchor_mask=[3, 4, 5],
          class_num=4, downsample_ratio=32),
        P(T.yolov3_loss, anchors=ANCHORS9, anchor_mask=[3, 4, 5],
          class_num=4, downsample_ratio=32),
        [f32(2, 27, 4, 4), YOLO_GT, YOLO_LABEL], (0, 1), 1e-4),
    "yolov3_loss_smooth": (
        P(J.yolov3_loss, anchors=ANCHORS9, anchor_mask=[0, 1, 2],
          class_num=4, downsample_ratio=16, use_label_smooth=True),
        P(T.yolov3_loss, anchors=ANCHORS9, anchor_mask=[0, 1, 2],
          class_num=4, downsample_ratio=16, use_label_smooth=True),
        [f32(2, 27, 5, 4), YOLO_GT, YOLO_LABEL], (0,), 1e-4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_detection_extra_op_matches_jax(name):
    jfn, tfn, args, grad, atol = CASES[name]
    check_pair(jfn, tfn, args, atol=atol, rtol=1e-5, grad=grad)


def test_poly2mask_matches_the_golden_vectors_and_jax():
    np.testing.assert_array_equal(T.poly2mask(GOLDEN_POLY, 8, 8),
                                  GOLDEN_MASK)
    poly = [0.5, 0.5, 9.2, 1.1, 7.7, 8.9, 1.3, 6.4]
    np.testing.assert_array_equal(T.poly2mask(poly, 10, 11),
                                  J.poly2mask(poly, 10, 11))


def test_polys_to_mask_wrt_box_matches_jax():
    polys = [GOLDEN_POLY,
             [2.97, 1.88, 3.81, 1.68, 1.69, 6.63, 6.94, 6.58, 2.97, 0.88]]
    box = [1.69, 0.88, 6.94, 6.63]
    np.testing.assert_array_equal(T.polys_to_mask_wrt_box(polys, box, 8),
                                  J.polys_to_mask_wrt_box(polys, box, 8))


@pytest.mark.parametrize("crowd", [[0, 0, 0], [0, 1, 0]])
def test_generate_mask_labels_matches_jax(crowd):
    import torch

    segs = [[GOLDEN_POLY], [[8.0, 8.0, 14.0, 8.5, 13.0, 15.0, 9.0, 14.0]],
            [[2.0, 9.0, 6.0, 9.0, 6.0, 13.0]]]
    rois = np.array([[1.69, 1.88, 5.94, 6.53], [0.0, 0.0, 1.0, 1.0],
                     [8.0, 8.0, 14.0, 15.0], [2.0, 9.0, 6.5, 13.0],
                     [7.0, 7.5, 13.0, 14.0]], np.float32)
    labels = np.array([2, 0, 1, 2, 1], np.int32)
    kw = dict(im_info=None, gt_classes=np.array([2, 1, 2]),
              is_crowd=np.array(crowd), gt_segms=segs, num_classes=3,
              resolution=6)
    got = T.generate_mask_labels(rois=torch.from_numpy(rois),
                                 roi_labels=torch.from_numpy(labels), **kw)
    want = J.generate_mask_labels(rois=rois, roi_labels=labels, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    empty = T.generate_mask_labels(None, None, None, [], rois, labels, 3, 6)
    assert [e.shape for e in empty] == [(0, 4), (5,), (0, 108)]
