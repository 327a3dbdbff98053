"""Detection ops (counterpart of paddle_tpu/ops/detection.py; reference:
paddle/fluid/operators/detection/): IoU and box coding, priors and
anchors, YOLOv3 decoding, the NMS family, RoI pooling, proposals and
matching, and the SSD head's matching, loss and decode.

The JAX package's static-shape contract holds: every op returns
fixed-capacity buffers plus a validity mask, never a length read back
from the data, and invalid slots carry the JAX package's padding values.
Nothing here reads a value back to the host, so each op runs on the
card with no synchronisation inside its loops.

Where the JAX package maps a greedy loop over images or classes
(``vmap`` of a fixed-length ``lax.scan``), the port runs one Python loop
of that fixed length over the whole batch at once: ``nms`` takes
``max_out`` steps over every (image, class) row of ``multiclass_nms`` and
``detection_output`` together, and ``ssd_loss`` matches its B images in
one loop of G steps. No loop stops early on the data.

Orders follow the JAX package: ``lax.top_k`` puts the lower index first
among equal scores, which a stable descending sort gives (``torch.topk``
on the card promises no order); ``jnp.argsort`` is stable; an argmax
takes the first maximum. ``multiclass_nms`` and ``matrix_nms`` leave the
label column of an invalid slot as the order of the ``-inf`` ties makes
it, so those orders show in the output.

Boxes are [x1, y1, x2, y2] unless noted. The creation ops (priors,
anchors) take ``device=`` (the card when None; with no card they raise
:class:`DeviceUnavailableError`) and ``dtype=`` (float32, as in the JAX
package)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..core.enforce import enforce
from ..core.places import resolve_device
from .math import _clip, _maximum, _minimum
from .tensor import _drop_grad, _in_range, _wrap_clamp

__all__ = [
    "iou_similarity", "box_coder", "box_clip", "prior_box",
    "density_prior_box", "anchor_generator", "yolo_box", "nms",
    "multiclass_nms", "matrix_nms", "roi_align", "roi_pool",
    "generate_proposals", "bipartite_match", "target_assign",
    "distribute_fpn_proposals", "collect_fpn_proposals",
    "polygon_box_transform",
]

_INF = float("inf")


# ---------------------------------------------------------------------------
# IoU + coding
# ---------------------------------------------------------------------------

def _area(boxes):
    return (_maximum(boxes[..., 2] - boxes[..., 0], 0.0)
            * _maximum(boxes[..., 3] - boxes[..., 1], 0.0))


def _iou(boxes1, boxes2):
    """Pairwise IoU over the last two dims: (..., N, 4) x (..., M, 4) ->
    (..., N, M), batch dims broadcast."""
    a = boxes1[..., :, None, :]
    b = boxes2[..., None, :, :]
    iw = _maximum(_minimum(a[..., 2], b[..., 2])
                  - _maximum(a[..., 0], b[..., 0]), 0.0)
    ih = _maximum(_minimum(a[..., 3], b[..., 3])
                  - _maximum(a[..., 1], b[..., 1]), 0.0)
    inter = iw * ih
    union = _area(boxes1)[..., :, None] + _area(boxes2)[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def iou_similarity(boxes1, boxes2):
    """Pairwise IoU, (N, 4) x (M, 4) -> (N, M).
    reference: operators/detection/iou_similarity_op.cc"""
    return _iou(boxes1, boxes2)


def _per_coord(out, pv, divide: bool):
    """``out`` (..., 4) divided (or multiplied) by the variances ``pv``:
    four numbers (applied per coordinate with no tensor made from host
    data) or a tensor that broadcasts."""
    if torch.is_tensor(pv):
        return out / pv if divide else out * pv
    pv = [float(v) for v in pv] if hasattr(pv, "__len__") else [float(pv)]
    if len(pv) == 1:
        return out / pv[0] if divide else out * pv[0]
    cols = [out[..., i] / pv[i] if divide else out[..., i] * pv[i]
            for i in range(4)]
    return torch.stack(cols, dim=-1)


def box_coder(prior_boxes, prior_variances, target, *,
              code_type: str = "encode_center_size",
              box_normalized: bool = True):
    """Encode boxes against priors, or decode deltas back to boxes
    (reference: operators/detection/box_coder_op.cc, center-size coding).

    encode: target (N, 4) boxes, priors (M, 4) -> (N, M, 4) deltas;
    decode: target (N, M, 4) (or (M, 4)) deltas -> boxes.
    ``prior_variances``: four numbers, or a tensor of (4,) or (M, 4)."""
    norm = 0.0 if box_normalized else 1.0
    pw = prior_boxes[:, 2] - prior_boxes[:, 0] + norm
    ph = prior_boxes[:, 3] - prior_boxes[:, 1] + norm
    pcx = prior_boxes[:, 0] + pw * 0.5
    pcy = prior_boxes[:, 1] + ph * 0.5
    if code_type == "encode_center_size":
        tw = target[:, 2] - target[:, 0] + norm
        th = target[:, 3] - target[:, 1] + norm
        tcx = target[:, 0] + tw * 0.5
        tcy = target[:, 1] + th * 0.5
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        dy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        dw = torch.log(_maximum(tw[:, None] / pw[None, :], 1e-10))
        dh = torch.log(_maximum(th[:, None] / ph[None, :], 1e-10))
        return _per_coord(torch.stack([dx, dy, dw, dh], dim=-1),
                          prior_variances, True)
    enforce(code_type == "decode_center_size",
            "unknown code_type %s", code_type)
    deltas = target if target.ndim == 3 else target[None]
    d = _per_coord(deltas, prior_variances, False)
    cx = d[..., 0] * pw + pcx
    cy = d[..., 1] * ph + pcy
    w = torch.exp(d[..., 2]) * pw
    h = torch.exp(d[..., 3]) * ph
    boxes = torch.stack([cx - w * 0.5, cy - h * 0.5,
                         cx + w * 0.5 - norm, cy + h * 0.5 - norm], dim=-1)
    return boxes if target.ndim == 3 else boxes[0]


def box_clip(boxes, im_shape):
    """Clip boxes into [0, w-1] x [0, h-1]; ``im_shape`` (h, w) numbers or
    a tensor. reference: operators/detection/box_clip_op.cc"""
    h, w = im_shape[0], im_shape[1]
    return torch.stack([_clip(boxes[..., 0], 0.0, w - 1),
                        _clip(boxes[..., 1], 0.0, h - 1),
                        _clip(boxes[..., 2], 0.0, w - 1),
                        _clip(boxes[..., 3], 0.0, h - 1)], dim=-1)


def polygon_box_transform(x):
    """(B, 8, H, W) quad offsets -> absolute coords (EAST-style).
    reference: operators/detection/polygon_box_transform_op.cc"""
    _, c, h, w = x.shape
    gy = torch.arange(h, device=x.device).reshape(1, 1, h, 1)
    gx = torch.arange(w, device=x.device).reshape(1, 1, 1, w)
    is_x = (torch.arange(c, device=x.device) % 2 == 0).reshape(1, c, 1, 1)
    return torch.where(is_x, 4 * gx, 4 * gy) - x


# ---------------------------------------------------------------------------
# Anchors
# ---------------------------------------------------------------------------

def expand_aspect_ratios(aspect_ratios: Sequence[float],
                         flip: bool = False) -> list:
    """The SSD prior aspect-ratio expansion (dedup + optional reciprocal),
    shared by prior_box and nn.MultiBoxHead so conv channel counts always
    match generated prior counts."""
    ars = [1.0]
    for ar in aspect_ratios:
        if all(abs(ar - a) > 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    return ars


def prior_box_count(min_sizes: Sequence[float], max_sizes: Sequence[float],
                    aspect_ratios: Sequence[float],
                    flip: bool = False) -> int:
    """Number of priors per spatial cell that prior_box will generate."""
    ars = expand_aspect_ratios(aspect_ratios, flip)
    return len(min_sizes) * len(ars) + len(list(zip(min_sizes, max_sizes)))


def _centers(h: int, w: int, step_h: float, step_w: float, offset: float,
             dtype, device):
    """(cx, cy) grids (H, W) of cell centres."""
    cx = (torch.arange(w, dtype=dtype, device=device) + offset) * step_w
    cy = (torch.arange(h, dtype=dtype, device=device) + offset) * step_h
    return cx[None, :].expand(h, w), cy[:, None].expand(h, w)


def _boxes_from_sizes(cx, cy, whs, dtype):
    """(H, W, A, 4) boxes centred on (cx, cy) with the (w, h) pairs
    ``whs``; each half-size rounded to ``dtype`` first, as the JAX
    package's float32 (A, 2) array is."""
    out = []
    for bw, bh in whs:
        # a host (CPU) scalar: rounding it copies nothing to the card
        hw = float(torch.tensor(bw, dtype=dtype)) / 2.0
        hh = float(torch.tensor(bh, dtype=dtype)) / 2.0
        out.append(torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], -1))
    return torch.stack(out, dim=2)


def _normalise(boxes, img_h, img_w, clip: bool):
    """Boxes over the image size. Each column is divided by a 0-d tensor,
    not a number: CUDA divides by a number as a product with its
    reciprocal, which can round one ulp away from the CPU's division,
    and priors of equal area inside one ground-truth box tie in IoU, so
    an ulp would break the ties of ``ssd_match`` differently on the two
    devices."""
    cols = [boxes[..., i] / torch.full((), float(v), dtype=boxes.dtype,
                                       device=boxes.device)
            for i, v in enumerate((img_w, img_h, img_w, img_h))]
    boxes = torch.stack(cols, dim=-1)
    return _clip(boxes, 0.0, 1.0) if clip else boxes


def _variances(variances, like):
    """The variances broadcast to ``like``'s shape, made on its device
    from a fill per coordinate (no host data copied over)."""
    cols = [torch.full(like.shape[:-1], float(v), dtype=like.dtype,
                       device=like.device) for v in variances]
    return torch.stack(cols, dim=-1)


def prior_box(feature_hw: Tuple[int, int], image_hw: Tuple[int, int],
              min_sizes: Sequence[float], max_sizes: Sequence[float] = (),
              aspect_ratios: Sequence[float] = (1.0,), *,
              variances: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
              flip: bool = False, clip: bool = False,
              step: Tuple[float, float] = (0.0, 0.0),
              offset: float = 0.5, dtype=torch.float32, device=None):
    """SSD prior boxes for one feature map -> ((H, W, A, 4) boxes, vars).
    reference: operators/detection/prior_box_op.cc"""
    dev = resolve_device(device)
    h, w = feature_hw
    img_h, img_w = image_hw
    step_h = step[0] or img_h / h
    step_w = step[1] or img_w / w
    ars = expand_aspect_ratios(aspect_ratios, flip)
    whs = [(ms * (ar ** 0.5), ms / (ar ** 0.5)) for ms in min_sizes
           for ar in ars]
    whs += [((ms * mx) ** 0.5, (ms * mx) ** 0.5)
            for ms, mx in zip(min_sizes, max_sizes)]
    cx, cy = _centers(h, w, step_h, step_w, offset, dtype, dev)
    boxes = _normalise(_boxes_from_sizes(cx, cy, whs, dtype), img_h, img_w,
                       clip)
    return boxes, _variances(variances, boxes)


def density_prior_box(feature_hw, image_hw, fixed_sizes, fixed_ratios,
                      densities, *, variances=(0.1, 0.1, 0.2, 0.2),
                      offset: float = 0.5, clip: bool = False,
                      step=(0.0, 0.0), dtype=torch.float32, device=None):
    """Densified priors (several shifted centres per cell).
    reference: operators/detection/density_prior_box_op.cc"""
    dev = resolve_device(device)
    h, w = feature_hw
    img_h, img_w = image_hw
    step_h = step[0] or img_h / h
    step_w = step[1] or img_w / w
    cxg, cyg = _centers(h, w, step_h, step_w, offset, dtype, dev)
    all_boxes = []
    for size, density in zip(fixed_sizes, densities):
        shift = step_w / density
        for ratio in fixed_ratios:
            bw = size * (ratio ** 0.5)
            bh = size / (ratio ** 0.5)
            for di in range(density):
                for dj in range(density):
                    ccx = cxg - step_w / 2.0 + shift / 2.0 + dj * shift
                    ccy = cyg - step_h / 2.0 + shift / 2.0 + di * shift
                    all_boxes.append(torch.stack(
                        [ccx - bw / 2, ccy - bh / 2, ccx + bw / 2,
                         ccy + bh / 2], -1))
    boxes = _normalise(torch.stack(all_boxes, dim=2), img_h, img_w, clip)
    return boxes, _variances(variances, boxes)


def anchor_generator(feature_hw, anchor_sizes, aspect_ratios, stride, *,
                     variances=(0.1, 0.1, 0.2, 0.2), offset: float = 0.5,
                     dtype=torch.float32, device=None):
    """RPN anchors -> ((H, W, A, 4), vars), absolute pixel coords.
    reference: operators/detection/anchor_generator_op.cc"""
    dev = resolve_device(device)
    h, w = feature_hw
    whs = []
    for ar in aspect_ratios:
        for s in anchor_sizes:
            area = float(s) * float(s)
            bw = (area / ar) ** 0.5
            whs.append((bw, bw * ar))
    cx, cy = _centers(h, w, stride[1], stride[0], offset, dtype, dev)
    anchors = _boxes_from_sizes(cx, cy, whs, dtype)
    return anchors, _variances(variances, anchors)


def yolo_box(x, img_size, anchors: Sequence[int], class_num: int,
             conf_thresh: float, downsample_ratio: int):
    """Decode one YOLOv3 head: (B, A*(5+C), H, W) -> boxes (B, H*W*A, 4),
    scores (B, H*W*A, C). reference: operators/detection/yolo_box_op.cc"""
    b, _, h, w = x.shape
    a = len(anchors) // 2
    x = x.reshape(b, a, 5 + class_num, h, w)
    dev = x.device
    gx = torch.arange(w, dtype=x.dtype, device=dev).reshape(1, 1, 1, w)
    gy = torch.arange(h, dtype=x.dtype, device=dev).reshape(1, 1, h, 1)
    bx = (torch.sigmoid(x[:, :, 0]) + gx) / w
    by = (torch.sigmoid(x[:, :, 1]) + gy) / h
    input_w = downsample_ratio * w
    input_h = downsample_ratio * h
    # each anchor's size a number (no host data copied to the card)
    bw = torch.stack([torch.exp(x[:, i, 2]) * float(anchors[2 * i])
                      for i in range(a)], dim=1) / input_w
    bh = torch.stack([torch.exp(x[:, i, 3]) * float(anchors[2 * i + 1])
                      for i in range(a)], dim=1) / input_h
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    img_h = img_size[..., 0].reshape(b, 1, 1, 1).to(x.dtype)
    img_w = img_size[..., 1].reshape(b, 1, 1, 1).to(x.dtype)
    boxes = torch.stack([(bx - bw / 2) * img_w, (by - bh / 2) * img_h,
                         (bx + bw / 2) * img_w, (by + bh / 2) * img_h],
                        dim=-1)                           # (B, A, H, W, 4)
    keep = conf > conf_thresh
    boxes = torch.where(keep[..., None], boxes, torch.zeros_like(boxes))
    probs = torch.where(keep[:, :, None], probs, torch.zeros_like(probs))
    # both flattened in (h, w, a) order, so scores[b, i] matches boxes[b, i]
    boxes = boxes.permute(0, 2, 3, 1, 4).reshape(b, h * w * a, 4)
    scores = probs.permute(0, 3, 4, 1, 2).reshape(b, h * w * a, class_num)
    return boxes, scores


# ---------------------------------------------------------------------------
# NMS family — fixed-capacity outputs
# ---------------------------------------------------------------------------

def _top_k(x, k: int):
    """``lax.top_k`` over the last axis: the k largest, the lower index
    first among equal values (a stable descending sort, then a slice)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _nms_rows(boxes, scores, iou_threshold: float, score_threshold: float,
              max_out: int):
    """Greedy hard-NMS on every row at once: boxes (R, n, 4), scores
    (R, n) -> (indices (R, max_out), valid (R, max_out)). One fixed loop
    of min(max_out, n) steps, each picking every row's best live box (the
    first maximum) and killing what overlaps it."""
    r, n = scores.shape
    k = min(max_out, n)
    # what survives each box: IoU under the threshold (NaN survives, as
    # ~(iou >= t) does in JAX), never the box itself
    keep = ~(_iou(boxes, boxes) >= iou_threshold)             # (R, n, n)
    keep &= ~torch.eye(n, dtype=torch.bool, device=scores.device)
    # a live box has a score above the threshold, so above -inf: a row
    # with any live box has a pick
    live = scores > score_threshold
    neg = torch.full((), -_INF, dtype=scores.dtype, device=scores.device)
    idxs, oks = [], []
    for _ in range(k):
        i = torch.argmax(torch.where(live, scores, neg), dim=1)   # (R,)
        ok = live.any(dim=1)
        live = live & torch.gather(keep, 1, i[:, None, None].expand(
            r, 1, n))[:, 0]
        idxs.append(i * ok)
        oks.append(ok)
    idx = torch.stack(idxs, dim=1) if idxs else scores.new_zeros(
        (r, 0), dtype=torch.long)
    ok = torch.stack(oks, dim=1) if oks else torch.zeros(
        (r, 0), dtype=torch.bool, device=scores.device)
    if k < max_out:
        idx = torch.cat([idx, idx.new_zeros((r, max_out - k))], dim=1)
        ok = torch.cat([ok, ok.new_zeros((r, max_out - k))], dim=1)
    return idx, ok


def nms(boxes, scores, *, iou_threshold: float = 0.3,
        score_threshold: float = -_INF, max_out: int = 100):
    """Greedy hard-NMS. Returns (indices (max_out,), valid_mask
    (max_out,)): the static-capacity contract for the reference's
    variable-output NMS (reference: operators/detection/
    multiclass_nms_op.cc NMSFast); invalid slots have index 0 and mask
    False."""
    idx, ok = _nms_rows(boxes[None], scores[None], iou_threshold,
                        score_threshold, max_out)
    return idx[0], ok[0]


def _pack(labels, best, boxes, keep_top_k: int):
    """The (.., keep_top_k, 6) [label, score, box] rows and their valid
    mask from the top-k picks (invalid: score and box 0, the label as
    picked), padded with zero rows up to ``keep_top_k``."""
    valid = best > -_INF
    zero = torch.zeros((), dtype=best.dtype, device=best.device)
    out = torch.cat([labels.to(best.dtype)[..., None],
                     torch.where(valid, best, zero)[..., None],
                     torch.where(valid[..., None], boxes.to(best.dtype),
                                 zero)], dim=-1)
    k = best.shape[-1]
    if k < keep_top_k:
        pad = keep_top_k - k
        out = torch.cat([out, out.new_zeros(out.shape[:-2] + (pad, 6))],
                        dim=-2)
        valid = torch.cat([valid, valid.new_zeros(valid.shape[:-1]
                                                  + (pad,))], dim=-1)
    return out, valid


def _multiclass_nms_batch(boxes, scores, score_threshold: float,
                          nms_threshold: float, nms_top_k: int,
                          keep_top_k: int, background_label: int):
    """:func:`multiclass_nms` on B images at once: boxes (B, N, 4),
    scores (B, C, N); every (image, class) row runs in one NMS loop."""
    b, c, n = scores.shape
    top = min(nms_top_k, n)
    s, order = _top_k(scores, top)                            # (B, C, top)
    cand = torch.gather(boxes[:, None].expand(b, c, n, 4), 2,
                        order[..., None].expand(b, c, top, 4))
    idx, ok = _nms_rows(cand.reshape(b * c, top, 4), s.reshape(b * c, top),
                        nms_threshold, score_threshold, top)
    idx, ok = idx.reshape(b, c, top), ok.reshape(b, c, top)
    cls_idx = torch.gather(order, 2, idx)
    cls_score = torch.gather(s, 2, idx)
    labels = torch.arange(c, device=scores.device)[None, :, None].expand(
        b, c, top)
    neg = torch.full((), -_INF, dtype=scores.dtype, device=scores.device)
    flat = torch.where(ok & (labels != background_label), cls_score,
                       neg).reshape(b, -1)
    k = min(keep_top_k, flat.shape[1])
    best, fi = _top_k(flat, k)
    sel = torch.gather(cls_idx.reshape(b, -1), 1, fi)
    sel_box = torch.gather(boxes, 1, sel[..., None].expand(b, k, 4))
    sel_label = torch.gather(labels.reshape(b, -1), 1, fi)
    return _pack(sel_label, best, sel_box, keep_top_k)


def multiclass_nms(boxes, scores, *, score_threshold: float = 0.01,
                   nms_threshold: float = 0.3, nms_top_k: int = 64,
                   keep_top_k: int = 100, background_label: int = 0):
    """Per-class NMS, then the global top k, one image: boxes (N, 4),
    scores (C, N) -> ((keep_top_k, 6) [label, score, x1, y1, x2, y2],
    valid mask). reference: detection/multiclass_nms_op.cc."""
    out, valid = _multiclass_nms_batch(
        boxes[None], scores[None], score_threshold, nms_threshold,
        nms_top_k, keep_top_k, background_label)
    return out[0], valid[0]


def matrix_nms(boxes, scores, *, score_threshold: float = 0.01,
               post_threshold: float = 0.0, keep_top_k: int = 100,
               use_gaussian: bool = False, gaussian_sigma: float = 2.0):
    """Parallel (non-iterative) NMS by pairwise decay, scores (C, N): each
    class's scores in stable descending order decay by the IoU with every
    higher-scored box, compensated by that box's own worst overlap."""
    c, n = scores.shape
    iou = _iou(boxes, boxes)
    order = torch.argsort(-scores, dim=1, stable=True)        # (C, N)
    s_sorted = torch.gather(scores, 1, order)
    iou_s = iou[order[:, :, None], order[:, None, :]]         # (C, N, N)
    upper = torch.triu(iou_s, diagonal=1)
    max_iou = upper.amax(dim=1)                               # (C, N)
    if use_gaussian:
        decay = torch.exp(-(upper ** 2 - max_iou[:, :, None] ** 2)
                          / gaussian_sigma).amin(dim=1)
    else:
        comp = (1 - upper) / _maximum(1 - max_iou[:, :, None], 1e-10)
        decay = torch.where(upper > 0, comp,
                            torch.ones_like(comp)).amin(dim=1)
    dec = s_sorted * _minimum(decay, 1.0)
    labels = torch.arange(c, device=scores.device)[:, None].expand(c, n)
    neg = torch.full((), -_INF, dtype=scores.dtype, device=scores.device)
    flat = torch.where(dec > max(score_threshold, post_threshold), dec,
                       neg).reshape(-1)
    k = min(keep_top_k, flat.shape[0])
    best, fi = _top_k(flat, k)
    sel_box = boxes[order.reshape(-1)[fi]]
    return _pack(labels.reshape(-1)[fi], best, sel_box, keep_top_k)


# ---------------------------------------------------------------------------
# RoI ops
# ---------------------------------------------------------------------------

def roi_align(x, rois, *, output_size: Tuple[int, int],
              spatial_scale: float = 1.0, sampling_ratio: int = 2,
              aligned: bool = False):
    """RoIAlign: x (C, H, W), rois (R, 4) -> (R, C, oh, ow). Bilinear
    samples at sampling_ratio^2 points per output bin, averaged; samples
    more than one pixel outside the map count 0 (reference:
    detection/roi_align_op.cc)."""
    c, h, w = x.shape
    oh, ow = output_size
    s = max(sampling_ratio, 1)
    off = 0.5 if aligned else 0.0
    x1 = rois[:, 0] * spatial_scale - off
    y1 = rois[:, 1] * spatial_scale - off
    x2 = rois[:, 2] * spatial_scale - off
    y2 = rois[:, 3] * spatial_scale - off
    rw = _maximum(x2 - x1, 1.0 if not aligned else 1e-6)
    rh = _maximum(y2 - y1, 1.0 if not aligned else 1e-6)
    bw = rw / ow
    bh = rh / oh
    dev = x.device

    def grid(n, start, size):
        i = torch.arange(n * s, device=dev)
        f = ((i % s).to(x.dtype) + 0.5) / s
        return start[:, None] + ((i // s).to(x.dtype)[None, :] + f[None, :]) \
            * size[:, None]

    ys = grid(oh, y1, bh)                                   # (R, oh*s)
    xs = grid(ow, x1, bw)                                   # (R, ow*s)
    y0 = _clip(torch.floor(ys), 0.0, h - 1).detach()
    x0 = _clip(torch.floor(xs), 0.0, w - 1).detach()
    y1c = torch.clamp(y0 + 1, 0, h - 1)
    x1c = torch.clamp(x0 + 1, 0, w - 1)
    wy = _clip(ys, 0.0, h - 1) - y0
    wx = _clip(xs, 0.0, w - 1) - x0
    y0i, x0i, y1i, x1i = (v.long() for v in (y0, x0, y1c, x1c))
    # (C, R, Sy, Sx) per corner
    v00 = x[:, y0i[:, :, None], x0i[:, None, :]]
    v01 = x[:, y0i[:, :, None], x1i[:, None, :]]
    v10 = x[:, y1i[:, :, None], x0i[:, None, :]]
    v11 = x[:, y1i[:, :, None], x1i[:, None, :]]
    wy_ = wy[None, :, :, None]
    wx_ = wx[None, :, None, :]
    val = (v00 * (1 - wy_) * (1 - wx_) + v01 * (1 - wy_) * wx_
           + v10 * wy_ * (1 - wx_) + v11 * wy_ * wx_)
    oky = (ys >= -1.0) & (ys <= h)
    okx = (xs >= -1.0) & (xs <= w)
    mask = (oky[:, :, None] & okx[:, None, :])[None]
    val = torch.where(mask, val, torch.zeros_like(val))
    val = val.reshape(c, -1, oh, s, ow, s).mean(dim=(3, 5))
    return val.permute(1, 0, 2, 3)


def roi_pool(x, rois, *, output_size: Tuple[int, int],
             spatial_scale: float = 1.0):
    """RoI max-pool with quantized bins (reference:
    detection/roi_pool_op.cc): each bin the max over the whole rows and
    columns it spans (two separable masks); an empty bin gives 0. RoIs
    go through in chunks, so memory stays near (C, chunk, oh, H, W)
    (the JAX package maps one RoI at a time)."""
    c, h, w = x.shape
    oh, ow = output_size
    dev = x.device
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    neg = torch.finfo(x.dtype).min
    negt = torch.full((), neg, dtype=x.dtype, device=dev)
    i = torch.arange(oh, dtype=x.dtype, device=dev)
    j = torch.arange(ow, dtype=x.dtype, device=dev)
    # the (C, chunk, oh, H, W) select: ~1 GiB of float64 on the card,
    # a quarter of that on the host
    budget = (1 << 27) if x.is_cuda else (1 << 25)
    chunk = max(1, budget // max(1, c * oh * h * w))
    outs = []
    for start in range(0, rois.shape[0], chunk):
        roi = rois[start:start + chunk].to(x.dtype)
        x1 = torch.round(roi[:, 0] * spatial_scale)
        y1 = torch.round(roi[:, 1] * spatial_scale)
        x2 = torch.round(roi[:, 2] * spatial_scale)
        y2 = torch.round(roi[:, 3] * spatial_scale)
        bh = _maximum(y2 - y1 + 1, 1.0) / oh
        bw = _maximum(x2 - x1 + 1, 1.0) / ow
        hs = torch.clamp(torch.floor(i[None] * bh[:, None]) + y1[:, None],
                         0, h)
        he = torch.clamp(torch.ceil((i[None] + 1) * bh[:, None])
                         + y1[:, None], 0, h)
        ws = torch.clamp(torch.floor(j[None] * bw[:, None]) + x1[:, None],
                         0, w)
        we = torch.clamp(torch.ceil((j[None] + 1) * bw[:, None])
                         + x1[:, None], 0, w)
        my = (rows >= hs[..., None]) & (rows < he[..., None])   # (r, oh, H)
        mx = (cols >= ws[..., None]) & (cols < we[..., None])   # (r, ow, W)
        tmp = torch.where(my[None, :, :, :, None], x[:, None, None], negt)
        tmp = tmp.amax(dim=3)                                   # (C, r, oh, W)
        out = torch.where(mx[None, :, None], tmp[:, :, :, None, :], negt)
        out = out.amax(dim=4)                                   # (C, r, oh, ow)
        outs.append(torch.where(out == neg, torch.zeros_like(out), out))
    if not outs:
        return x.new_zeros((0, c, oh, ow))
    return torch.cat(outs, dim=1).permute(1, 0, 2, 3)


# ---------------------------------------------------------------------------
# Proposals + matching
# ---------------------------------------------------------------------------

def generate_proposals(scores, bbox_deltas, anchors, variances, im_shape, *,
                       pre_nms_top_n: int = 6000, post_nms_top_n: int = 1000,
                       nms_thresh: float = 0.7, min_size: float = 0.0):
    """RPN proposal generation, one image: objectness (A,), deltas (A, 4),
    anchors (A, 4) -> (post_nms_top_n, 4) + mask.
    reference: detection/generate_proposals_op.cc"""
    a = scores.shape[0]
    k = min(pre_nms_top_n, a)
    top_scores, order = _top_k(scores, k)
    d = bbox_deltas[order] * variances[order]
    boxes = box_coder(anchors[order], (1.0, 1.0, 1.0, 1.0), d,
                      code_type="decode_center_size")
    boxes = box_clip(boxes, im_shape)
    bw = boxes[:, 2] - boxes[:, 0]
    bh = boxes[:, 3] - boxes[:, 1]
    ok_size = (bw >= min_size) & (bh >= min_size)
    sc = torch.where(ok_size, top_scores,
                     torch.full((), -_INF, dtype=top_scores.dtype,
                                device=top_scores.device))
    idx, ok = nms(boxes, sc, iou_threshold=nms_thresh, max_out=post_nms_top_n)
    return torch.where(ok[:, None], boxes[idx], torch.zeros_like(
        boxes[idx])), ok


def bipartite_match(sim):
    """Greedy bipartite matching, N rows to M columns: min(N, M) steps,
    each taking the largest entry left (the first in row-major order).
    Returns (match_indices (M,), match_dist (M,)): each column's row, or
    -1. reference: detection/bipartite_match_op.cc"""
    n, m = sim.shape
    dev = sim.device
    neg = torch.full((), -_INF, dtype=sim.dtype, device=dev)
    s = torch.where(sim > 0, sim, neg)
    col_match = torch.full((m,), -1, dtype=torch.int32, device=dev)
    col_dist = sim.new_zeros((m,))
    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    for _ in range(min(n, m)):
        flat = torch.argmax(s.reshape(-1))
        i, j = flat // m, flat % m
        best = s.reshape(-1)[flat]
        ok = best > -_INF
        at = ok & (cols == j)
        col_match = torch.where(at, i.to(torch.int32), col_match)
        col_dist = torch.where(at, best, col_dist)
        s = torch.where(ok & ((rows[:, None] == i) | (cols[None, :] == j)),
                        neg, s)
    return col_match, col_dist


def target_assign(gt, match_indices, *, mismatch_value=0.0):
    """Scatter matched gt rows to prediction slots: gt (N, K),
    match_indices (M,) -> out (M, K), weights (M,). A match index past N
    reads row N - 1, as ``gt[idx]`` in JAX does (its gradient dropped).
    reference: detection/target_assign_op.cc"""
    matched = match_indices >= 0
    safe = torch.clamp_min(match_indices.long(), 0)
    rows = _drop_grad(gt[_wrap_clamp(safe, gt.shape[0])],
                      _in_range(safe, gt.shape[0]))
    out = torch.where(matched[:, None], rows,
                      torch.full((), mismatch_value, dtype=gt.dtype,
                                 device=gt.device))
    return out, matched.to(gt.dtype)


def distribute_fpn_proposals(rois, *, min_level: int = 2, max_level: int = 5,
                             refer_level: int = 4, refer_scale: int = 224):
    """FPN level routing: (R, 4) -> per-level masks (L, R) + each RoI's
    level: the static form of the reference's dynamic splits
    (detection/distribute_fpn_proposals_op.cc)."""
    w = rois[:, 2] - rois[:, 0]
    h = rois[:, 3] - rois[:, 1]
    scale = torch.sqrt(_maximum(w * h, 1e-10))
    lvl = torch.floor(torch.log2(scale / refer_scale + 1e-6)) + refer_level
    lvl = torch.clamp(lvl, min_level, max_level).to(torch.int32)
    levels = torch.arange(min_level, max_level + 1, device=rois.device)
    return lvl[None, :] == levels[:, None], lvl


def collect_fpn_proposals(multi_rois, multi_scores, *, post_nms_top_n: int):
    """Concatenate per-level (rois, scores) and keep the global top n.
    reference: detection/collect_fpn_proposals_op.cc"""
    rois = torch.cat(list(multi_rois), dim=0)
    scores = torch.cat(list(multi_scores), dim=0)
    top, idx = _top_k(scores, min(post_nms_top_n, scores.shape[0]))
    return rois[idx], top


# ---------------------------------------------------------------------------
# SSD head: matching, loss, inference decode
# ---------------------------------------------------------------------------

def _encode_matched(prior_boxes, prior_variances, gt):
    """Center-size encode each prior's matched gt box (..., M, 4) ->
    (..., M, 4) deltas (the per-prior form of box_coder's pairwise
    encode)."""
    pw = prior_boxes[:, 2] - prior_boxes[:, 0]
    ph = prior_boxes[:, 3] - prior_boxes[:, 1]
    pcx = prior_boxes[:, 0] + pw * 0.5
    pcy = prior_boxes[:, 1] + ph * 0.5
    tw = gt[..., 2] - gt[..., 0]
    th = gt[..., 3] - gt[..., 1]
    tcx = gt[..., 0] + tw * 0.5
    tcy = gt[..., 1] + th * 0.5
    out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                       torch.log(_maximum(tw / pw, 1e-10)),
                       torch.log(_maximum(th / ph, 1e-10))], dim=-1)
    return _per_coord(out, prior_variances, True)


def _ssd_match_batch(gt_boxes, gt_mask, prior_boxes, overlap_threshold,
                     match_type):
    """:func:`ssd_match` on B images at once: gt (B, G, 4), mask (B, G)
    -> (match_idx (B, M) int32, matched (B, M) bool); one loop of G
    bipartite steps over the batch."""
    b, g = gt_boxes.shape[:2]
    m = prior_boxes.shape[0]
    dev = gt_boxes.device
    iou = _iou(gt_boxes, prior_boxes[None])                   # (B, G, M)
    minus1 = torch.full((), -1.0, dtype=iou.dtype, device=dev)
    iou = torch.where(gt_mask[:, :, None], iou, minus1)
    best_iou = iou.amax(dim=1)
    match_idx = torch.argmax(iou, dim=1)                      # first max
    matched = best_iou > (overlap_threshold
                          if match_type == "per_prediction" else 1.1)
    rows = torch.arange(g, device=dev)[None, :, None]
    cols = torch.arange(m, device=dev)[None, None, :]
    col1 = torch.arange(m, device=dev)[None, :]
    live = iou
    for _ in range(g):
        flat = torch.argmax(live.reshape(b, -1), dim=1)       # (B,)
        gi, mi = flat // m, flat % m
        ok = torch.gather(live.reshape(b, -1), 1, flat[:, None])[:, 0] > 0
        at = ok[:, None] & (col1 == mi[:, None])
        match_idx = torch.where(at, gi[:, None], match_idx)
        matched = matched | at
        kill = ok[:, None, None] & ((rows == gi[:, None, None])
                                    | (cols == mi[:, None, None]))
        live = torch.where(kill, minus1, live)
    return match_idx.to(torch.int32), matched


def ssd_match(gt_boxes, gt_mask, prior_boxes, *,
              overlap_threshold: float = 0.5,
              match_type: str = "per_prediction"):
    """SSD matching for one image: bipartite (every gt claims its best
    prior, highest IoU pair first) and, with ``per_prediction``, any
    prior whose best IoU passes the threshold takes its best gt. Padded
    gt slots (gt_mask False) never match. Returns (match_idx (M,) int32,
    matched (M,) bool). reference: operators/detection/
    bipartite_match_op.cc + layers/detection.py ssd_loss's matching."""
    idx, ok = _ssd_match_batch(gt_boxes[None], gt_mask[None], prior_boxes,
                               overlap_threshold, match_type)
    return idx[0], ok[0]


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, gt_mask=None, *,
             background_label: int = 0, overlap_threshold: float = 0.5,
             neg_pos_ratio: float = 3.0, loc_loss_weight: float = 1.0,
             conf_loss_weight: float = 1.0,
             match_type: str = "per_prediction",
             mining_type: str = "max_negative", normalize: bool = True):
    """SSD multibox loss (reference: python/paddle/fluid/layers/
    detection.py ssd_loss; ops mine_hard_examples / target_assign /
    bipartite_match), padded ground truth with a mask: gt_box (N, G, 4),
    gt_label (N, G), gt_mask (N, G) bool; location (N, M, 4) deltas,
    confidence (N, M, C) logits, priors (M, 4). Returns each image's
    loss (N,), hard-negative mined and divided by its matched count when
    ``normalize``."""
    from .detection_extra import mine_hard_examples
    from .loss import smooth_l1_loss, softmax_with_cross_entropy

    n, m, _ = location.shape
    if gt_mask is None:
        gt_mask = torch.ones(gt_box.shape[:2], dtype=torch.bool,
                             device=gt_box.device)
    if prior_box_var is None:
        prior_box_var = torch.ones_like(prior_box)
    midx, matched = _ssd_match_batch(gt_box, gt_mask.bool(), prior_box,
                                     overlap_threshold, match_type)
    midx = midx.long()
    tgt_label = torch.where(matched, torch.gather(gt_label.long(), 1, midx),
                            torch.full((), background_label,
                                       dtype=torch.long,
                                       device=gt_label.device))
    conf_loss = softmax_with_cross_entropy(confidence, tgt_label)[..., 0]
    sel = mine_hard_examples(conf_loss.detach(), matched.to(torch.int32),
                             neg_pos_ratio=neg_pos_ratio,
                             mining_type=mining_type).to(conf_loss.dtype)
    gt_m = torch.gather(gt_box, 1, midx[..., None].expand(n, m, 4))
    tgt_loc = _encode_matched(prior_box, prior_box_var, gt_m)
    loc_l = smooth_l1_loss(location.reshape(n * m, 4),
                           tgt_loc.reshape(n * m, 4).to(location.dtype))
    loc_l = loc_l.reshape(n, m)
    mf = matched.to(conf_loss.dtype)
    total = (conf_loss_weight * torch.sum(conf_loss * sel, dim=1)
             + loc_loss_weight * torch.sum(loc_l * mf, dim=1))
    if normalize:
        total = total / torch.clamp_min(torch.sum(mf, dim=1), 1.0)
    return total


def detection_output(loc, scores, prior_box, prior_box_var=None, *,
                     background_label: int = 0,
                     nms_threshold: float = 0.3, nms_top_k: int = 400,
                     keep_top_k: int = 200, score_threshold: float = 0.01):
    """SSD inference decode: each image's boxes decoded, the softmax of
    its logits, then multiclass NMS over every (image, class) at once
    (reference: layers/detection.py detection_output: box_coder decode +
    multiclass_nms). loc (N, M, 4) deltas, scores (N, M, C) logits,
    priors (M, 4). Returns ((N, keep_top_k, 6) [label, score, x1, y1,
    x2, y2], valid mask)."""
    if prior_box_var is None:
        prior_box_var = torch.ones_like(prior_box)
    boxes = box_coder(prior_box, prior_box_var, loc,
                      code_type="decode_center_size")          # (N, M, 4)
    probs = torch.softmax(scores, dim=-1).transpose(1, 2)      # (N, C, M)
    return _multiclass_nms_batch(
        boxes, probs, score_threshold, nms_threshold,
        min(nms_top_k, loc.shape[1]), keep_top_k, background_label)
