"""The rest of the detection suite (counterpart of
paddle_tpu/ops/detection_extra.py; reference:
paddle/fluid/operators/detection/{psroi_pool_op.cc,
roi_perspective_transform_op.cc, rpn_target_assign_op.cc,
mine_hard_examples_op.cc, box_decoder_and_assign_op.cc,
generate_proposal_labels_op.cc, yolov3_loss_op.cc} and mask_util.cc).

The device ops keep the JAX package's static shapes and read nothing
back to the host. ``poly2mask``, ``polys_to_mask_wrt_box`` and
``generate_mask_labels`` are host-side numpy, as in the JAX package:
ragged polygon lists are data preparation, not device work."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.enforce import enforce
from .detection import iou_similarity
from .math import _clip, _maximum, _minimum
from .math import abs as _abs
from .math import softplus
from .nn import one_hot
from .tensor import _wrap_clamp, cast


def psroi_pool(x, rois, *, output_size: Tuple[int, int],
               spatial_scale: float = 1.0):
    """Position-sensitive RoI pooling (reference: detection/
    psroi_pool_op.cc, R-FCN): input channels C = out_c * ph * pw; output
    bin (i, j) average-pools its own channel group over its cell.
    x: (N, C, H, W); rois: (R, 5) [batch_idx, x1, y1, x2, y2]. Each bin's
    mask is a product of a row mask and a column mask, so a bin's sums
    are two contractions over the image's map (no per-RoI copy of it); a
    batch index out of range reads the last image, as ``x[b]`` in JAX."""
    ph, pw = output_size
    n, c, h, w = x.shape
    enforce(c % (ph * pw) == 0,
            "psroi_pool needs C %% (ph*pw) == 0, got C=%s bins=%s", c,
            ph * pw)
    out_c = c // (ph * pw)
    b = _wrap_clamp(cast(rois[:, 0], torch.int64), n)
    boxes = rois[:, 1:].to(x.dtype) * spatial_scale
    x1, y1, x2, y2 = boxes.unbind(1)
    rh = _maximum(y2 - y1, 1e-4) / ph
    rw = _maximum(x2 - x1, 1e-4) / pw
    ys = torch.arange(h, dtype=x.dtype, device=x.device)
    xs = torch.arange(w, dtype=x.dtype, device=x.device)
    # each pixel's bin, clipped into [0, ph) x [0, pw), and whether the
    # pixel lies in the RoI
    bin_y = torch.clamp(torch.floor((ys[None] - y1[:, None]) / rh[:, None]),
                        0, ph - 1)
    bin_x = torch.clamp(torch.floor((xs[None] - x1[:, None]) / rw[:, None]),
                        0, pw - 1)
    in_y = (ys[None] >= y1[:, None]) & (ys[None] < y2[:, None])
    in_x = (xs[None] >= x1[:, None]) & (xs[None] < x2[:, None])
    onehot_b = (b[:, None] == torch.arange(n, device=x.device)[None]).to(
        x.dtype)                                              # (R, N)
    outs = []
    for i in range(ph):
        my = ((bin_y == i) & in_y).to(x.dtype)               # (R, H)
        for j in range(pw):
            mx = ((bin_x == j) & in_x).to(x.dtype)           # (R, W)
            g = (i * pw + j) * out_c
            group = x[:, g:g + out_c]                         # (N, oc, H, W)
            rows = torch.einsum("rh,nchw->rncw", my, group)
            s = torch.einsum("rncw,rw,rn->rc", rows, mx, onehot_b)
            cnt = _maximum(my.sum(1) * mx.sum(1), 1.0)
            outs.append(s / cnt[:, None])
    out = torch.stack(outs, dim=2)                            # (R, oc, bins)
    return out.reshape(rois.shape[0], out_c, ph, pw)


def roi_perspective_transform(x, rois, *, transformed_height: int,
                              transformed_width: int,
                              spatial_scale: float = 1.0):
    """reference: detection/roi_perspective_transform_op.cc: each
    quadrilateral RoI warped onto a fixed rectangle (the bilinear surface
    through its corners, as in the JAX package), sampled bilinearly.
    rois: (R, 9) [batch_idx, x1, y1, ..., x4, y4], corners in (tl, tr,
    br, bl) order -> (R, C, th, tw)."""
    th, tw = transformed_height, transformed_width
    n, c, h, w = x.shape
    b = _wrap_clamp(cast(rois[:, 0], torch.int64), n)
    quads = rois[:, 1:].to(x.dtype).reshape(-1, 4, 2) * spatial_scale
    gy = torch.linspace(0.0, 1.0, th, dtype=x.dtype,
                        device=x.device)[:, None].expand(th, tw)
    gx = torch.linspace(0.0, 1.0, tw, dtype=x.dtype,
                        device=x.device)[None, :].expand(th, tw)
    tl, tr, br, bl = (quads[:, k][:, None, None, :] for k in range(4))
    top = tl + (tr - tl) * gx[None, :, :, None]
    bot = bl + (br - bl) * gx[None, :, :, None]
    pts = top + (bot - top) * gy[None, :, :, None]            # (R, th, tw, 2)
    sx = _clip(pts[..., 0], 0.0, w - 1)
    sy = _clip(pts[..., 1], 0.0, h - 1)
    # x0 < x1 always, so the weights sum to 1 at the right and bottom edge
    x0 = torch.clamp(torch.floor(sx), 0, w - 2).detach()
    y0 = torch.clamp(torch.floor(sy), 0, h - 2).detach()
    x1, y1 = x0 + 1, y0 + 1
    wa = (x1 - sx) * (y1 - sy)
    wb = (sx - x0) * (y1 - sy)
    wc = (x1 - sx) * (sy - y0)
    wd = (sx - x0) * (sy - y0)
    bi = b[:, None, None]
    x0i, y0i, x1i, y1i = (v.long() for v in (x0, y0, x1, y1))

    def at(yy, xx):
        return x[bi, :, yy, xx].permute(0, 3, 1, 2)            # (R, C, th, tw)

    return (at(y0i, x0i) * wa[:, None] + at(y0i, x1i) * wb[:, None]
            + at(y1i, x0i) * wc[:, None] + at(y1i, x1i) * wd[:, None])


def rpn_target_assign(anchors, gt_boxes, *, rpn_batch_size_per_im: int = 256,
                      rpn_positive_overlap: float = 0.7,
                      rpn_negative_overlap: float = 0.3,
                      key: Optional[object] = None):
    """reference: detection/rpn_target_assign_op.cc: label each anchor
    fg (1: IoU at or over the positive threshold, or a gt's best anchor),
    bg (0: under the negative threshold) or ignored (-1); returns (labels
    (A,) int32, each anchor's best gt). The static form: the reference's
    random subsampling to the batch quota is left to the caller."""
    iou = iou_similarity(anchors, gt_boxes)                   # (A, G)
    best_gt = torch.argmax(iou, dim=1)
    best_iou = iou.amax(dim=1)
    labels = torch.full((anchors.shape[0],), -1, dtype=torch.int32,
                        device=anchors.device)
    labels = torch.where(best_iou < rpn_negative_overlap,
                         torch.zeros_like(labels), labels)
    labels = torch.where(best_iou >= rpn_positive_overlap,
                         torch.ones_like(labels), labels)
    # every gt's best anchor is positive whatever its IoU
    best_anchor_per_gt = torch.argmax(iou, dim=0)             # (G,)
    labels = labels.index_fill(0, best_anchor_per_gt, 1)
    return labels, best_gt


def mine_hard_examples(cls_loss, labels, *, neg_pos_ratio: float = 3.0,
                       mining_type: str = "max_negative"):
    """reference: detection/mine_hard_examples_op.cc, SSD hard-negative
    mining: every positive and the (ratio * #pos) highest-loss negatives,
    as a 0/1 float32 mask of cls_loss's (N, M) shape. The ranking is a
    stable sort, as ``jnp.argsort``'s, so equal losses keep the lower
    index first."""
    enforce(mining_type == "max_negative",
            "only max_negative mining is supported, got %s", mining_type)
    pos = labels > 0
    num_pos = torch.sum(pos, dim=1, keepdim=True)
    num_neg = (num_pos * neg_pos_ratio).to(torch.int32)
    neg_loss = torch.where(pos, torch.full((), -float("inf"),
                                           dtype=cls_loss.dtype,
                                           device=cls_loss.device), cls_loss)
    order = torch.argsort(-neg_loss, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    return (pos | (rank < num_neg)).to(torch.float32)


def box_decoder_and_assign(prior_box, prior_var, target_box, box_score, *,
                           box_clip: float = 4.135):
    """reference: detection/box_decoder_and_assign_op.cc: per-class box
    deltas decoded, then each box's best-scoring class decode (the first
    maximum). target_box: (N, 4*C) deltas; box_score: (N, C) ->
    (decoded (N, C, 4), assigned (N, 4))."""
    n, c4 = target_box.shape
    c = c4 // 4
    pw = prior_box[:, 2] - prior_box[:, 0]
    ph = prior_box[:, 3] - prior_box[:, 1]
    px = prior_box[:, 0] + pw * 0.5
    py = prior_box[:, 1] + ph * 0.5
    t = target_box.reshape(n, c, 4) * prior_var.reshape(n, 1, 4)
    dx, dy = t[..., 0], t[..., 1]
    dw = _clip(t[..., 2], -box_clip, box_clip)
    dh = _clip(t[..., 3], -box_clip, box_clip)
    cx = px[:, None] + dx * pw[:, None]
    cy = py[:, None] + dy * ph[:, None]
    ow = torch.exp(dw) * pw[:, None]
    oh = torch.exp(dh) * ph[:, None]
    decoded = torch.stack([cx - ow / 2, cy - oh / 2, cx + ow / 2,
                           cy + oh / 2], dim=-1)              # (N, C, 4)
    best = torch.argmax(box_score, dim=1)
    assigned = torch.gather(decoded, 1, best[:, None, None].expand(
        n, 1, 4))[:, 0]
    return decoded, assigned


def generate_proposal_labels(rois, gt_boxes, gt_classes, *,
                             fg_thresh: float = 0.5,
                             bg_thresh_hi: float = 0.5,
                             bg_thresh_lo: float = 0.0):
    """reference: detection/generate_proposal_labels_op.cc: RoIs labelled
    against the ground truth for the second stage: (labels (R,) int32,
    0 background and -1 ignored, each RoI's best gt, fg mask)."""
    iou = iou_similarity(rois, gt_boxes)
    best_gt = torch.argmax(iou, dim=1)
    best_iou = iou.amax(dim=1)
    fg = best_iou >= fg_thresh
    bg = (best_iou < bg_thresh_hi) & (best_iou >= bg_thresh_lo)
    zero = torch.zeros((), dtype=gt_classes.dtype, device=rois.device)
    labels = torch.where(fg, gt_classes[best_gt], zero)
    labels = torch.where(fg | bg, labels, torch.full_like(labels, -1))
    return labels.to(torch.int32), best_gt, fg


def yolov3_loss(x, gt_box, gt_label, *, anchors: Sequence[int],
                anchor_mask: Sequence[int], class_num: int,
                ignore_thresh: float = 0.7, downsample_ratio: int = 32,
                use_label_smooth: bool = False):
    """reference: detection/yolov3_loss_op.cc, single-scale YOLOv3 loss:
    objectness, box (x, y on sigmoids, w, h L2) and class BCE, each gt
    owned by its best anchor over all anchors (by (w, h) IoU at the
    origin) when that anchor is in this scale's mask; the cells no gt
    owns take the negative objectness term.

    x: (N, A*(5+C), H, W) raw head output; gt_box: (N, B, 4) in [0, 1]
    (cx, cy, w, h); gt_label: (N, B) int; padded gts have w == 0."""
    n, _, h, w = x.shape
    a = len(anchor_mask)
    c = class_num
    x = x.reshape(n, a, 5 + c, h, w)
    pred_xy = torch.sigmoid(x[:, :, 0:2])
    pred_wh = x[:, :, 2:4]
    pred_obj = x[:, :, 4]
    pred_cls = x[:, :, 5:]
    dev, dt = x.device, x.dtype
    input_w = w * downsample_ratio
    input_h = h * downsample_ratio
    gt_box = gt_box.to(dt)

    # responsibility: each gt's best anchor by IoU of (w, h) at the
    # origin, anchors as numbers (no host data copied to the card)
    gw = gt_box[..., 2] * input_w                             # (N, B)
    gh = gt_box[..., 3] * input_h
    ious = []
    for k in range(len(anchors) // 2):
        aw, ah = float(anchors[2 * k]), float(anchors[2 * k + 1])
        inter = _minimum(gw, aw) * _minimum(gh, ah)
        union = gw * gh + aw * ah - inter
        ious.append(inter / _maximum(union, 1e-9))
    best_anchor = torch.argmax(torch.stack(ious, dim=-1), dim=-1)

    valid = gt_box[..., 2] > 1e-6
    gi = torch.clamp(cast(gt_box[..., 0] * w, torch.int64), 0, w - 1)
    gj = torch.clamp(cast(gt_box[..., 1] * h, torch.int64), 0, h - 1)

    def bce(logit, target):
        return softplus(logit) - target * logit

    # every gt at once (the JAX package loops over them; its obj_target
    # takes the max of each gt's mark, which does not depend on order):
    # the gt's anchor in this scale's mask, or mask anchor 0 where none
    # is (JAX reads that slot and masks its loss)
    in_mask = torch.zeros_like(valid)
    local_a = torch.zeros(valid.shape, dtype=torch.long, device=dev)
    aw = torch.full(valid.shape, float(anchors[2 * anchor_mask[0]]),
                    dtype=dt, device=dev)
    ah = torch.full(valid.shape, float(anchors[2 * anchor_mask[0] + 1]),
                    dtype=dt, device=dev)
    for k, am in enumerate(anchor_mask):
        hit = best_anchor == am
        in_mask = in_mask | hit
        local_a = torch.where(hit, k, local_a)
        aw = torch.where(hit, float(anchors[2 * am]), aw)
        ah = torch.where(hit, float(anchors[2 * am + 1]), ah)
    sel = valid.to(dt) * in_mask.to(dt)                      # (N, B)
    bidx = torch.arange(n, device=dev)[:, None].expand_as(local_a)
    px = pred_xy[bidx, local_a, 0, gj, gi]
    py = pred_xy[bidx, local_a, 1, gj, gi]
    pw_ = pred_wh[bidx, local_a, 0, gj, gi]
    ph_ = pred_wh[bidx, local_a, 1, gj, gi]
    tx = gt_box[..., 0] * w - gi
    ty = gt_box[..., 1] * h - gj
    tw = torch.log(_maximum(gw, 1e-9) / aw)
    th = torch.log(_maximum(gh, 1e-9) / ah)
    scale = 2.0 - gt_box[..., 2] * gt_box[..., 3]
    box_loss = (_abs(px - tx) ** 2 + _abs(py - ty) ** 2
                + _abs(pw_ - tw) ** 2 + _abs(ph_ - th) ** 2) * scale
    po = pred_obj[bidx, local_a, gj, gi]
    obj_loss = bce(po, torch.ones_like(po))
    tgt = one_hot(gt_label, c, dt)                            # (N, B, C)
    if use_label_smooth:
        tgt = tgt * (1 - 1.0 / c) + 1.0 / (2 * c)
    pc = pred_cls[bidx, local_a, :, gj, gi]                   # (N, B, C)
    cls_loss = torch.sum(bce(pc, tgt), dim=-1)
    total = torch.sum(sel * (box_loss + obj_loss + cls_loss))
    # obj_target.at[...].max(sel): each gt's cell, the max of the marks
    flat = ((bidx * a + local_a) * h + gj) * w + gi
    obj_target = torch.zeros((n * a * h * w,), dtype=dt, device=dev)
    obj_target = obj_target.scatter_reduce(
        0, flat.reshape(-1), sel.reshape(-1), "amax").reshape(n, a, h, w)
    neg_loss = bce(pred_obj, torch.zeros_like(pred_obj)) * (1.0 - obj_target)
    return (total + torch.sum(neg_loss)) / n


# ---------------------------------------------------------------------------
# Host-side mask targets (numpy; the JAX package's own numpy code)
# ---------------------------------------------------------------------------

def poly2mask(xy, h: int, w: int):
    """Rasterize one polygon to an (h, w) binary mask with the COCO
    frPoly algorithm (reference: operators/detection/mask_util.cc
    Poly2Mask, whose contract is pycocotools frPyObjects+decode):
    vertices upsampled x5, edges traced, x-boundary crossings
    downsampled, column-major parity fill. Boundary-inclusive."""
    pts = np.asarray(xy, np.float64).reshape(-1, 2)
    k = len(pts)
    scale = 5.0
    x = np.trunc(scale * pts[:, 0] + 0.5).astype(np.int64)
    y = np.trunc(scale * pts[:, 1] + 0.5).astype(np.int64)
    x = np.append(x, x[0])
    y = np.append(y, y[0])
    us, vs = [], []
    for j in range(k):
        xs, xe, ys, ye = int(x[j]), int(x[j + 1]), int(y[j]), int(y[j + 1])
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe, ys, ye = xe, xs, ye, ys
        if dx >= dy:
            s = 0.0 if dx == 0 else (ye - ys) / dx
            d = np.arange(dx + 1)
            t = (dx - d) if flip else d
            us.append(t + xs)
            vs.append(np.trunc(ys + s * t + 0.5).astype(np.int64))
        else:
            s = 0.0 if dy == 0 else (xe - xs) / dy
            d = np.arange(dy + 1)
            t = (dy - d) if flip else d
            vs.append(t + ys)
            us.append(np.trunc(xs + s * t + 0.5).astype(np.int64))
    u = np.concatenate(us)
    v = np.concatenate(vs)
    # x-boundary crossings, downsampled back to pixel space
    bx, by = [], []
    for j in range(1, len(u)):
        if u[j] == u[j - 1]:
            continue
        xd = float(u[j] if u[j] < u[j - 1] else u[j] - 1)
        xd = (xd + 0.5) / scale - 0.5
        if np.floor(xd) != xd or xd < 0 or xd > w - 1:
            continue
        yd = float(min(v[j], v[j - 1]))
        yd = (yd + 0.5) / scale - 0.5
        yd = min(max(yd, 0.0), float(h))
        yd = np.ceil(yd)
        bx.append(int(xd))
        by.append(int(yd))
    # run-length fill over the column-major index space
    a = np.array([cx * h + cy for cx, cy in zip(bx, by)], np.int64)
    a = np.append(a, np.int64(h * w))
    a.sort()
    d = np.diff(np.concatenate([[np.int64(0)], a]))
    runs = [int(d[0])]
    j = 1
    while j < len(d):
        if d[j] > 0:
            runs.append(int(d[j]))
            j += 1
        else:
            j += 1
            if j < len(d):
                runs[-1] += int(d[j])
                j += 1
    msk = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for run in runs:
        msk[pos:pos + run] = val
        pos += run
        val = 1 - val
    return msk.reshape(w, h).T


def polys_to_mask_wrt_box(polygons, box, mask_size: int):
    """Rasterize an instance's polygon list into a (mask_size, mask_size)
    grid over ``box`` (reference: mask_util.cc Polys2MaskWrtBox): each
    polygon mapped into box-relative pixel space, frPoly-rasterized,
    unioned."""
    box = np.asarray(box, np.float32)
    x0, y0 = box[0], box[1]
    w = np.maximum(box[2] - box[0], np.float32(1.0))
    h = np.maximum(box[3] - box[1], np.float32(1.0))
    mask = np.zeros((mask_size, mask_size), np.uint8)
    m = np.float32(mask_size)
    for poly in polygons:
        # the whole mapping in float32, like the reference's C float
        # math: only then does a pixel-boundary tie quantize the same way
        p = np.asarray(poly, np.float32).reshape(-1, 2)
        p = np.stack([(p[:, 0] - x0) * m / w, (p[:, 1] - y0) * m / h],
                     axis=1)
        mask |= poly2mask(p.reshape(-1), mask_size, mask_size)
    return mask


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         roi_labels, num_classes: int, resolution: int = 14):
    """Mask R-CNN mask targets (reference:
    operators/detection/generate_mask_labels_op.cc), host-side numpy.

    gt_segms: list (per gt) of polygon lists ([x0, y0, x1, y1, ...]).
    rois (R, 4), roi_labels (R,) class per roi (0 = background); tensors
    or arrays. Returns numpy (mask_rois (P, 4), roi_has_mask (R,),
    mask_targets (P, num_classes * resolution**2) with -1 outside the
    roi's class section, P = the foreground rois with a match)."""
    rois = _host(rois).astype(np.float64)
    roi_labels = _host(roi_labels).astype(np.int64)
    if len(gt_segms) == 0:
        return (np.zeros((0, 4), np.float32),
                np.zeros(len(rois), np.int32),
                np.zeros((0, num_classes * resolution ** 2), np.float32))
    gt_boxes = []
    for segs in gt_segms:
        allpts = np.concatenate([np.asarray(s, np.float64).reshape(-1, 2)
                                 for s in segs], axis=0)
        gt_boxes.append([allpts[:, 0].min(), allpts[:, 1].min(),
                         allpts[:, 0].max(), allpts[:, 1].max()])
    gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
    fg = np.flatnonzero(roi_labels > 0)
    lt = np.maximum(rois[:, None, :2], gt_boxes[None, :, :2])
    rb = np.minimum(rois[:, None, 2:], gt_boxes[None, :, 2:])
    wh = np.maximum(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]

    def area(b):
        return (np.maximum(b[:, 2] - b[:, 0], 0)
                * np.maximum(b[:, 3] - b[:, 1], 0))

    union = area(rois)[:, None] + area(gt_boxes)[None, :] - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)
    # crowd gts never give mask targets; a roi only matches a gt of its
    # own class
    if is_crowd is not None:
        crowd = _host(is_crowd).astype(bool).reshape(-1)
        iou[:, crowd] = -1.0
    if gt_classes is not None:
        gcls = _host(gt_classes).astype(np.int64).reshape(-1)
        iou = np.where(gcls[None, :] == roi_labels[:, None], iou, -1.0)
    best_gt = iou.argmax(axis=1)
    has_match = iou.max(axis=1) > 0
    mask_rois, targets = [], []
    for r in fg:
        if not has_match[r]:
            continue
        box = rois[r]
        m = polys_to_mask_wrt_box(gt_segms[int(best_gt[r])], box, resolution)
        tgt = np.full((num_classes, resolution * resolution), -1.0,
                      np.float32)
        tgt[int(roi_labels[r])] = m.reshape(-1).astype(np.float32)
        mask_rois.append(box)
        targets.append(tgt.reshape(-1))
    roi_has_mask = ((roi_labels > 0) & has_match).astype(np.int32)
    if not mask_rois:
        return (np.zeros((0, 4), np.float32), roi_has_mask,
                np.zeros((0, num_classes * resolution ** 2), np.float32))
    return (np.asarray(mask_rois, np.float32), roi_has_mask,
            np.stack(targets))


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)
