"""``ops/detection.py`` of the port against the JAX package's, on the CPU:
one case per function, the same numpy-seeded inputs through both (the
JAX side jitted), float outputs within atol 1e-5 + rtol 1e-5 (integer
and bool outputs equal), and where the op is differentiable the
gradients of a fixed random projection of the outputs within 1e-5
(1e-4 for ``ssd_loss``, a loss after a head).

The cases hold what a plain torch port gets wrong:
- ties: ``nms``, ``multiclass_nms`` and ``matrix_nms`` with equal
  scores, where ``lax.top_k`` and ``jnp.argsort`` put the lower index
  first, and the label column of the invalid (``-inf``) slots, which
  the JAX package leaves as those ties order it;
- kinks: boxes that exactly touch (the ``maximum(., 0)`` of the IoU and
  the area), RoI samples on the clip bounds;
- static shapes: capacities above the candidates (padded slots), and
  ``target_assign`` with a match index past the ground truth (``gt[i]``
  clamps)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import detection as J
from paddle_tpu_torch.ops import detection as T
from torch_parity import check_pair, compare

RNG = np.random.default_rng(11)
P = functools.partial
CPU = dict(device="cpu")


def f32(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def boxes(n, scale=1.0):
    xy = RNG.uniform(0.0, 0.7, (n, 2))
    wh = RNG.uniform(0.05, 0.35, (n, 2))
    return (np.concatenate([xy, xy + wh], 1) * scale).astype(np.float32)


def touching():
    """Boxes that exactly touch or nest (IoU at the kinks), and a
    degenerate one."""
    return np.array([[0.0, 0.0, 1.0, 1.0], [1.0, 0.0, 2.0, 1.0],
                     [0.0, 1.0, 1.0, 2.0], [0.25, 0.25, 0.75, 0.75],
                     [0.5, 0.5, 0.5, 0.9]], np.float32)


def scores_with_ties(*shape):
    s = RNG.uniform(0.0, 1.0, shape).astype(np.float32)
    flat = s.reshape(-1)
    flat[1::4] = flat[0]                      # repeated values
    return s


VAR = (0.1, 0.1, 0.2, 0.2)
PRIORS = boxes(20)
DELTAS = (f32(3, 20, 4) * 0.3).astype(np.float32)


def _variances(m):
    return np.tile(np.array(VAR, np.float32), (m, 1))


# name -> (JAX fn, port fn, args, grad positions)
CASES = {
    "_area": (J._area, T._area, [np.concatenate([boxes(6), touching()])],
              (0,)),
    "iou_similarity": (J.iou_similarity, T.iou_similarity,
                       [boxes(5), boxes(7)], (0, 1)),
    "iou_similarity_touching": (J.iou_similarity, T.iou_similarity,
                                [touching(), touching()], (0, 1)),
    "box_coder_encode": (P(J.box_coder, code_type="encode_center_size"),
                         P(T.box_coder, code_type="encode_center_size"),
                         [PRIORS[:6], VAR, boxes(4)], (0, 2)),
    "box_coder_encode_tensor_var": (
        P(J.box_coder, box_normalized=False),
        P(T.box_coder, box_normalized=False),
        [PRIORS[:6] * 20, _variances(6), boxes(4) * 20], (0, 2)),
    "box_coder_decode": (P(J.box_coder, code_type="decode_center_size"),
                         P(T.box_coder, code_type="decode_center_size"),
                         [PRIORS, _variances(20), DELTAS], (0, 2)),
    "box_coder_decode_2d": (P(J.box_coder, code_type="decode_center_size"),
                            P(T.box_coder, code_type="decode_center_size"),
                            [PRIORS, VAR, DELTAS[0]], (0, 2)),
    "box_clip": (P(J.box_clip, im_shape=(8, 9)), P(T.box_clip,
                                                    im_shape=(8, 9)),
                 [np.concatenate([boxes(6) * 12 - 2,
                                  np.array([[0.0, 7.0, 8.0, 3.0]],
                                           np.float32)])], (0,)),
    "box_clip_tensor_shape": (J.box_clip, T.box_clip,
                              [boxes(6) * 12 - 2,
                               np.array([8.0, 9.0], np.float32)], (0,)),
    "polygon_box_transform": (J.polygon_box_transform,
                              T.polygon_box_transform, [f32(2, 8, 3, 4)],
                              (0,)),
    "yolo_box": (P(J.yolo_box, anchors=[10, 13, 16, 30, 33, 23], class_num=4,
                   conf_thresh=0.3, downsample_ratio=32),
                 P(T.yolo_box, anchors=[10, 13, 16, 30, 33, 23], class_num=4,
                   conf_thresh=0.3, downsample_ratio=32),
                 [f32(2, 27, 3, 4), np.array([[320, 416], [256, 256]],
                                             np.int32)], (0,)),
    "nms": (P(J.nms, iou_threshold=0.4, max_out=5),
            P(T.nms, iou_threshold=0.4, max_out=5),
            [boxes(12), scores_with_ties(12)], ()),
    "nms_padded": (P(J.nms, iou_threshold=0.3, score_threshold=0.4,
                     max_out=15),
                   P(T.nms, iou_threshold=0.3, score_threshold=0.4,
                     max_out=15),
                   [boxes(12), scores_with_ties(12)], ()),
    "nms_duplicates": (P(J.nms, iou_threshold=0.5, max_out=6),
                       P(T.nms, iou_threshold=0.5, max_out=6),
                       [np.repeat(boxes(3), 2, axis=0),
                        np.array([0.5, 0.5, 0.9, 0.9, 0.2, 0.2],
                                 np.float32)], ()),
    "multiclass_nms": (P(J.multiclass_nms, nms_top_k=6, keep_top_k=5,
                         score_threshold=0.2),
                       P(T.multiclass_nms, nms_top_k=6, keep_top_k=5,
                         score_threshold=0.2),
                       [boxes(10), scores_with_ties(4, 10)], ()),
    "multiclass_nms_invalid_slots": (
        P(J.multiclass_nms, nms_top_k=4, keep_top_k=30,
          score_threshold=0.5, background_label=2),
        P(T.multiclass_nms, nms_top_k=4, keep_top_k=30,
          score_threshold=0.5, background_label=2),
        [boxes(10), scores_with_ties(4, 10)], ()),
    "matrix_nms": (P(J.matrix_nms, keep_top_k=12, score_threshold=0.1),
                   P(T.matrix_nms, keep_top_k=12, score_threshold=0.1),
                   [boxes(10), scores_with_ties(3, 10)], ()),
    "matrix_nms_gaussian_padded": (
        P(J.matrix_nms, keep_top_k=40, use_gaussian=True,
          post_threshold=0.3),
        P(T.matrix_nms, keep_top_k=40, use_gaussian=True,
          post_threshold=0.3),
        [boxes(10), scores_with_ties(3, 10)], ()),
    "roi_align": (P(J.roi_align, output_size=(2, 3), spatial_scale=0.5),
                  P(T.roi_align, output_size=(2, 3), spatial_scale=0.5),
                  [f32(3, 8, 9), np.concatenate([
                      boxes(4, 16), np.array([[-4.0, -3.0, 6.0, 20.0],
                                              [14.0, 2.0, 22.0, 18.0]],
                                             np.float32)])], (0, 1)),
    "roi_align_aligned": (P(J.roi_align, output_size=(3, 2),
                            sampling_ratio=1, aligned=True),
                          P(T.roi_align, output_size=(3, 2),
                            sampling_ratio=1, aligned=True),
                          [f32(2, 6, 7), boxes(3, 7)], (0, 1)),
    "roi_pool": (P(J.roi_pool, output_size=(2, 3), spatial_scale=0.5),
                 P(T.roi_pool, output_size=(2, 3), spatial_scale=0.5),
                 [f32(3, 8, 9), np.concatenate([
                     boxes(4, 16), np.array([[30.0, 30.0, 40.0, 40.0]],
                                            np.float32)])], (0,)),
    "bipartite_match": (J.bipartite_match, T.bipartite_match,
                        [np.array([[0.9, 0.2, 0.9, -0.1, 0.0, 0.3],
                                   [0.9, 0.8, 0.1, 0.0, 0.5, 0.3],
                                   [0.1, 0.8, 0.7, 0.2, 0.0, 0.3],
                                   [0.0, -0.5, 0.0, 0.0, 0.0, 0.0]],
                                  np.float32)], (0,)),
    "target_assign": (P(J.target_assign, mismatch_value=-2.0),
                      P(T.target_assign, mismatch_value=-2.0),
                      [f32(3, 2), np.array([-1, 0, 2, 1, -1, 5], np.int32)],
                      (0,)),
    "distribute_fpn_proposals": (J.distribute_fpn_proposals,
                                 T.distribute_fpn_proposals,
                                 [boxes(12, 800)], ()),
    "collect_fpn_proposals": (
        lambda r1, r2, r3, s1, s2, s3: J.collect_fpn_proposals(
            [r1, r2, r3], [s1, s2, s3], post_nms_top_n=7),
        lambda r1, r2, r3, s1, s2, s3: T.collect_fpn_proposals(
            [r1, r2, r3], [s1, s2, s3], post_nms_top_n=7),
        [boxes(4), boxes(3), boxes(5), np.array([0.5, 0.2, 0.5, 0.1],
                                                np.float32),
         np.array([0.5, 0.9, 0.2], np.float32), scores_with_ties(5)],
        (0, 1, 2, 3, 4, 5)),
    "_encode_matched": (J._encode_matched, T._encode_matched,
                        [PRIORS, _variances(20), boxes(20)], (0, 2)),
    "ssd_match": (P(J.ssd_match, overlap_threshold=0.3),
                  P(T.ssd_match, overlap_threshold=0.3),
                  [boxes(3), np.array([True, True, False]), PRIORS], ()),
    "ssd_match_bipartite": (P(J.ssd_match, match_type="bipartite"),
                            P(T.ssd_match, match_type="bipartite"),
                            [boxes(4), np.array([True, False, True, True]),
                             PRIORS], ()),
    "detection_output": (P(J.detection_output, nms_top_k=10, keep_top_k=15,
                           nms_threshold=0.45),
                         P(T.detection_output, nms_top_k=10, keep_top_k=15,
                           nms_threshold=0.45),
                         [DELTAS[:2], f32(2, 20, 4) * 2, PRIORS,
                          _variances(20)], ()),
    "detection_output_no_var": (P(J.detection_output, keep_top_k=60,
                                  background_label=1),
                                P(T.detection_output, keep_top_k=60,
                                  background_label=1),
                                [DELTAS[:2], f32(2, 20, 3), PRIORS], ()),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_detection_op_matches_jax(name):
    jfn, tfn, args, grad = CASES[name]
    check_pair(jfn, tfn, args, atol=1e-5, rtol=1e-5, grad=grad)


def _gt(b, g, n_valid):
    """Padded ground truth: (B, G, 4) boxes, labels in 1..3, mask."""
    gt = np.stack([boxes(g) for _ in range(b)])
    mask = np.arange(g)[None, :] < np.asarray(n_valid)[:, None]
    lab = RNG.integers(1, 4, (b, g)).astype(np.int32)
    return gt, lab, mask


@pytest.mark.parametrize("match_type,normalize", [
    ("per_prediction", True), ("bipartite", False)])
def test_ssd_loss_and_its_gradients_match_jax(match_type, normalize):
    gt, lab, mask = _gt(3, 4, [4, 2, 1])
    kw = dict(match_type=match_type, normalize=normalize,
              overlap_threshold=0.3)
    check_pair(lambda loc, conf, g, l, p, v, m: J.ssd_loss(
                   loc, conf, g, l, p, v, m, **kw),
               lambda loc, conf, g, l, p, v, m: T.ssd_loss(
                   loc, conf, g, l, p, v, m, **kw),
               [DELTAS, f32(3, 20, 4), gt, lab, PRIORS, _variances(20),
                mask], atol=1e-4, rtol=1e-4, grad=(0, 1))


def test_ssd_loss_defaults_match_jax():
    gt, lab, _ = _gt(2, 3, [3, 3])
    check_pair(J.ssd_loss, T.ssd_loss,
               [DELTAS[:2], f32(2, 20, 4), gt, lab, PRIORS], atol=1e-4,
               rtol=1e-4, grad=(0, 1))


@pytest.mark.parametrize("clip,step", [(True, (0.0, 0.0)),
                                       (False, (9.0, 11.0))])
def test_prior_box_matches_jax(clip, step):
    kw = dict(variances=(0.1, 0.1, 0.2, 0.2), flip=True, clip=clip,
              step=step, offset=0.5)
    args = ((3, 4), (30, 40), [8.0, 16.0], [12.0, 20.0], [2.0, 3.0])
    compare(T.prior_box(*args, **kw, **CPU), J.prior_box(*args, **kw),
            1e-6, 1e-6)


def test_density_prior_box_and_anchor_generator_match_jax():
    args = ((2, 3), (16, 24), [4.0, 8.0], [1.0, 2.0], [2, 1])
    compare(T.density_prior_box(*args, clip=True, **CPU),
            J.density_prior_box(*args, clip=True), 1e-6, 1e-6)
    args = ((3, 4), [32.0, 64.0], [0.5, 1.0, 2.0], (16.0, 8.0))
    compare(T.anchor_generator(*args, offset=0.25, **CPU),
            J.anchor_generator(*args, offset=0.25), 1e-5, 1e-6)


def test_aspect_ratio_expansion_and_prior_count_match_jax():
    for ars, flip in (([2.0, 3.0], True), ([2.0, 2.0, 1.0], False), ([], True)):
        assert T.expand_aspect_ratios(ars, flip) == J.expand_aspect_ratios(
            ars, flip)
        assert T.prior_box_count([60.0], [150.0], ars, flip) == \
            J.prior_box_count([60.0], [150.0], ars, flip)


def test_generate_proposals_matches_jax():
    a = 40
    anchors = boxes(a, 60)
    var = np.tile(np.array(VAR, np.float32), (a, 1))
    kw = dict(pre_nms_top_n=20, post_nms_top_n=12, nms_thresh=0.5,
              min_size=2.0)
    check_pair(lambda s, d, an, v: J.generate_proposals(s, d, an, v,
                                                        (50, 60), **kw),
               lambda s, d, an, v: T.generate_proposals(s, d, an, v,
                                                        (50, 60), **kw),
               [scores_with_ties(a), f32(a, 4), anchors, var], atol=1e-5,
               rtol=1e-5, grad=(1, 2))


def test_the_multiclass_invalid_label_column_follows_the_tie_order():
    """What ``multiclass_nms_invalid_slots`` compares, spelled out: the
    invalid slots keep the label that the stable order of the ``-inf``
    ties picks (class 0 first), with score and box zeroed."""
    b = torch.from_numpy(boxes(6))
    s = torch.zeros(3, 6)
    s[1, 2] = 0.9
    out, valid = T.multiclass_nms(b, s, nms_top_k=3, keep_top_k=5,
                                  score_threshold=0.5)
    assert valid.tolist() == [True, False, False, False, False]
    assert out[0, 0] == 1 and out[0, 1] == pytest.approx(0.9)
    assert out[1:, 0].tolist() == [0.0, 0.0, 0.0, 1.0]
    assert torch.all(out[1:, 1:] == 0)
    want = J.multiclass_nms(jnp.asarray(b.numpy()), jnp.asarray(s.numpy()),
                            nms_top_k=3, keep_top_k=5, score_threshold=0.5)
    compare((out, valid), want, 0, 0)


def test_every_public_name_has_a_case():
    import inspect

    covered = {n for n in CASES} | {
        "ssd_loss", "prior_box", "density_prior_box", "anchor_generator",
        "expand_aspect_ratios", "prior_box_count", "generate_proposals"}
    covered |= {n.rsplit("_", 1)[0] for n in CASES}
    for name, f in vars(J).items():
        if inspect.isfunction(f) and f.__module__ == J.__name__:
            assert any(c == name or c.startswith(name) for c in covered), \
                name
