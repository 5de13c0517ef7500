"""Bounding-box ops of the SSD detection suite (paddle_tpu/ops/detection.py;
reference DetectionUtil.cpp: encodeBBoxWithVar/decodeBBoxWithVar,
jaccardOverlap, matchBBox, applyNMSFast). Fixed-shape tensor programs,
as in the JAX package, which computes them outside any Pallas kernel:
variable box counts are padded arrays with validity masks, and NMS keeps
a fixed number of candidates.

Boxes are [xmin, ymin, xmax, ymax], normalised to [0, 1]. Where the JAX
package breaks ties by index (a stable ``argsort``, ``argmax``), these
use a stable ``torch.sort`` and ``argmax`` (first maximum), so tied scores
pick the same rows. ``nms`` takes leading batch dimensions, so a caller
runs every (image, class) pair's suppression in one loop.
"""

import torch

_EPS = 1e-8


def bbox_area(boxes):
    zero = boxes.new_zeros(())
    w = torch.maximum(boxes[..., 2] - boxes[..., 0], zero)
    h = torch.maximum(boxes[..., 3] - boxes[..., 1], zero)
    return w * h


def jaccard_overlap(a, b):
    """IoU matrix of two box sets: a [..., N, 4], b [..., M, 4] ->
    [..., N, M] (reference: jaccardOverlap)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.maximum(rb - lt, a.new_zeros(()))
    inter = wh[..., 0] * wh[..., 1]
    union = bbox_area(a)[..., :, None] + bbox_area(b)[..., None, :] - inter
    return inter / torch.maximum(union, union.new_full((), _EPS))


def _size_center(box):
    eps = box.new_full((), _EPS)
    w = torch.maximum(box[..., 2] - box[..., 0], eps)
    h = torch.maximum(box[..., 3] - box[..., 1], eps)
    return w, h, (box[..., 0] + box[..., 2]) * 0.5, \
        (box[..., 1] + box[..., 3]) * 0.5


def encode_box(prior, variance, gt):
    """Ground truth encoded against its prior with the variance
    (reference: encodeBBoxWithVar); [..., 4] each."""
    pw, ph, pcx, pcy = _size_center(prior)
    gw, gh, gcx, gcy = _size_center(gt)
    return torch.stack([
        (gcx - pcx) / pw / variance[..., 0],
        (gcy - pcy) / ph / variance[..., 1],
        torch.log(gw / pw) / variance[..., 2],
        torch.log(gh / ph) / variance[..., 3]], dim=-1)


def decode_box(prior, variance, loc):
    """The inverse of ``encode_box``, clipped to [0, 1] (reference:
    decodeBBoxWithVar)."""
    pw, ph, pcx, pcy = _size_center(prior)
    cx = loc[..., 0] * variance[..., 0] * pw + pcx
    cy = loc[..., 1] * variance[..., 1] * ph + pcy
    w = torch.exp(torch.clamp(loc[..., 2] * variance[..., 2], -10.0,
                              10.0)) * pw
    h = torch.exp(torch.clamp(loc[..., 3] * variance[..., 3], -10.0,
                              10.0)) * ph
    return torch.clamp(torch.stack([cx - w * 0.5, cy - h * 0.5,
                                    cx + w * 0.5, cy + h * 0.5], dim=-1),
                       0.0, 1.0)


def match_priors(priors, gt_boxes, gt_valid, overlap_threshold):
    """Bipartite then per-prior matching (reference: matchBBox), batched:
    priors [P, 4]; gt_boxes [B, G, 4]; gt_valid [B, G] bool. Returns
    (match [B, P] int64, a gt index or -1; match_iou [B, P]). Every valid
    gt claims its best prior (the lowest index among ties); the other
    priors take their best gt where its IoU passes the threshold."""
    batch, num_g = gt_valid.shape
    num_p = priors.shape[0]
    iou = jaccard_overlap(priors.expand(batch, num_p, 4), gt_boxes)
    iou = torch.where(gt_valid[:, None, :], iou, iou.new_full((), -1.0))
    best_gt_iou, best_gt = iou.amax(dim=2), torch.argmax(iou, dim=2)
    match = torch.where(best_gt_iou > overlap_threshold, best_gt,
                        torch.full_like(best_gt, -1))
    # each valid gt claims its best prior; a later gt wins a prior two
    # claim (JAX's scatter order); invalid gts claim nothing
    best_prior = torch.argmax(iou, dim=1)  # [B, G], first maximum
    for g in range(num_g):
        claimed = torch.zeros_like(match, dtype=torch.bool).scatter(
            1, best_prior[:, g:g + 1], gt_valid[:, g:g + 1])
        match = torch.where(claimed, torch.full_like(match, g), match)
    picked = iou.gather(2, torch.clamp(match, min=0)[..., None])[..., 0]
    match_iou = torch.where(match >= 0, picked, best_gt_iou)
    return match, match_iou


def hard_negatives(neg_score, num_neg):
    """The hard-negative mask [B, P] of SSD's mining: in each row the
    ``num_neg[b]`` largest of ``neg_score`` (-inf where a prior may not
    be a negative), ties in index order, as the JAX package's stable
    argsort of the negated scores ranks them."""
    order = torch.sort(neg_score, dim=1, descending=True,
                       stable=True).indices
    ranks = torch.arange(neg_score.shape[1], device=neg_score.device)
    rank = torch.empty_like(order).scatter_(
        1, order, ranks.expand_as(order).contiguous())
    return rank < num_neg[:, None]


def nms(boxes, scores, valid, iou_threshold, top_k):
    """Greedy NMS with a fixed output size (reference: applyNMSFast),
    over leading batch dimensions: boxes [..., N, 4], scores [..., N],
    valid [..., N] bool. Only the ``top_k`` best-scored candidates enter
    suppression (an [top_k, top_k] IoU, not [N, N]). Returns (indices
    [..., k], keep [..., k]): indices into the input, the kept ones first
    in score order, ties in index order."""
    n = boxes.shape[-2]
    k = min(top_k, n)
    lowest = torch.finfo(scores.dtype).min
    s = torch.where(valid, scores, scores.new_full((), lowest))
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices
    order = order[..., :k]
    boxes_o = boxes.gather(-2, order[..., None].expand(
        order.shape + (4,)))
    valid_o = valid.gather(-1, order)
    iou = jaccard_overlap(boxes_o, boxes_o)  # [..., k, k]
    keep = torch.zeros_like(valid_o)
    for i in range(k):
        # suppressed by any higher-ranked kept box overlapping it
        sup = ((iou[..., i, :i] > iou_threshold) & keep[..., :i]).any(-1)
        keep[..., i] = valid_o[..., i] & ~sup
    rank = torch.arange(k, device=boxes.device)
    kept_rank = torch.where(keep, rank, torch.full_like(rank, k))
    sel = torch.sort(kept_rank, dim=-1, stable=True).indices
    return order.gather(-1, sel), keep.gather(-1, sel)
