"""The SSD detection layers: priorbox, cross_channel_norm, multibox_loss,
detection_output (paddle_tpu/layer/detection.py; reference PriorBox.cpp,
CrossChannelNormLayer.cpp, MultiBoxLossLayer.cpp,
DetectionOutputLayer.cpp over DetectionUtil.cpp; the box ops are
``ops/detection.py``).

The prior boxes are a constant [P, 8] table (box, variance) made from the
feature-map geometry at build time and put on the feature map's device
at the first evaluation there. Ground truth arrives as a padded SequenceBatch of
[label, xmin, ymin, xmax, ymax, difficult] rows. Matching, hard-negative
mining and NMS are fixed-shape masked programs batched over the images;
``detection_output`` is a fixed [B, keep_top_k, 7] tensor with label -1
on its padding rows.
"""

import numpy as np
import torch

from paddle_tpu_torch.graph import auto_name
from paddle_tpu_torch.layer.base import (ImageValue, data_of, is_seq, like,
                                         make_node, register_layer, to_list,
                                         weight_spec)
from paddle_tpu_torch.ops import detection as det_ops
from paddle_tpu_torch.utils.error import enforce


def _make_priors(layer_h, layer_w, image_h, image_w, min_size, max_size,
                 aspect_ratio, variance, clip=True):
    """The prior grid as a [P, 8] numpy table (reference: PriorBox.cpp's
    loop order: per cell, per min size: the min box, the sqrt(min * max)
    box, then the aspect ratios and their inverses)."""
    min_size = list(np.atleast_1d(min_size).astype(np.float64))
    max_size = (list(np.atleast_1d(max_size).astype(np.float64))
                if max_size else [])
    ars = [1.0]
    for r in np.atleast_1d(aspect_ratio).astype(np.float64):
        if abs(r - 1.0) < 1e-6:
            continue
        ars.extend([float(r), 1.0 / float(r)])
    step_w = float(image_w) / layer_w
    step_h = float(image_h) / layer_h
    rows = []
    for h in range(layer_h):
        for w in range(layer_w):
            cx = (w + 0.5) * step_w
            cy = (h + 0.5) * step_h
            for si, ms in enumerate(min_size):
                sizes = [(ms, ms)]
                if max_size:
                    s = np.sqrt(ms * max_size[si])
                    sizes.append((s, s))
                for r in ars[1:]:
                    sizes.append((ms * np.sqrt(r), ms / np.sqrt(r)))
                for bw, bh in sizes:
                    box = [(cx - bw / 2.0) / image_w,
                           (cy - bh / 2.0) / image_h,
                           (cx + bw / 2.0) / image_w,
                           (cy + bh / 2.0) / image_h]
                    if clip:
                        box = [min(max(v, 0.0), 1.0) for v in box]
                    rows.append(box + list(variance))
    return np.asarray(rows, np.float32)


@register_layer("priorbox")
def priorbox(input, image, aspect_ratio, variance, min_size, max_size=None,
             name=None, layer_attr=None):
    """SSD prior boxes of one feature map (reference: the priorbox_layer
    DSL): ``input`` is the feature map (its height and width set the
    grid), ``image`` the network input (its size normalises). The value
    is the constant [P, 8] table, one (box, variance) row a prior."""
    from paddle_tpu_torch.layer.conv import _img_shape

    _, lh, lw = _img_shape(input)
    _, ih, iw = _img_shape(image)
    priors = _make_priors(lh, lw, ih, iw, min_size, max_size, aspect_ratio,
                          variance)
    # the table per device and inference mode it was asked for (a
    # tensor made under inference_mode cannot enter a recorded graph)
    tables = {}

    def forward(params, values, ctx):
        value = values[0]
        device = (value.nhwc if isinstance(value, ImageValue)
                  else data_of(value)).device
        key = (device, torch.is_inference_mode_enabled())
        table = tables.get(key)
        if table is None:
            table = tables[key] = torch.as_tensor(priors, device=device)
        return table

    node = make_node("priorbox", forward, [input, image], name=name,
                     size=priors.shape[0] * 8, layer_attr=layer_attr)
    node.num_priors = priors.shape[0]
    return node


@register_layer("cross_channel_norm")
def cross_channel_norm(input, name=None, param_attr=None, layer_attr=None):
    """L2 normalisation across the channels at each position, then one
    learned scale a channel (reference: CrossChannelNormLayer; SSD's
    conv4_3 normaliser): the weight [C]."""
    from paddle_tpu_torch.layer.conv import _img_shape

    c, h, w = _img_shape(input)
    name = name or auto_name("cross_channel_norm")
    wspec = weight_spec(name, 0, (c,), param_attr, fan_in=1)

    def forward(params, values, ctx):
        x = data_of(values[0]).reshape(-1, c, h * w)
        norm = torch.sqrt((x * x).sum(dim=1, keepdim=True) + 1e-12)
        y = x / norm * params[wspec.name][None, :, None]
        return like(values[0], y.reshape(-1, c * h * w))

    node = make_node("cross_channel_norm", forward, [input], name=name,
                     size=input.size, param_specs=[wspec],
                     layer_attr=layer_attr)
    node.out_img_shape = (c, h, w)
    return node


def _predictions(values, num_classes):
    """(priors [P, 8], loc [B, P, 4], conf [B, P, classes]) from the prior
    tables and the per-map prediction layers, concatenated in map order
    (each map's flat rows read as [P_map, 4] / [P_map, classes])."""
    tables, locs, confs = values
    priors = torch.cat(list(tables), dim=0)
    loc = torch.cat([data_of(v).reshape(data_of(v).shape[0], -1, 4)
                     for v in locs], dim=1)
    conf = torch.cat([data_of(v).reshape(data_of(v).shape[0], -1,
                                         num_classes) for v in confs], dim=1)
    return priors, loc, conf


@register_layer("multibox_loss")
def multibox_loss(input_loc, input_conf, priorbox, label, num_classes,
                  overlap_threshold=0.5, neg_pos_ratio=3.0, neg_overlap=0.5,
                  background_id=0, name=None, layer_attr=None):
    """SSD training cost [B] (reference: MultiBoxLossLayer): smooth-L1 on
    the matched priors' encoded boxes plus softmax cross-entropy on the
    matched priors and the hardest negatives (``neg_pos_ratio`` times the
    positives, among the priors whose best IoU is at most
    ``neg_overlap``; ties in index order), over the number of positives.
    ``input_loc`` / ``input_conf`` are the per-map prediction layers
    (lists allowed), ``priorbox`` the matching priorbox layers, ``label``
    the ground-truth sequence."""
    locs, confs, priors = (to_list(v) for v in (input_loc, input_conf,
                                                 priorbox))
    name = name or auto_name("multibox_loss")
    inputs = [label] + priors + locs + confs
    n_prior, n_loc = len(priors), len(locs)

    def forward(params, values, ctx):
        gt = values[0]
        enforce(is_seq(gt), "multibox_loss label must be a sequence")
        table, loc, conf = _predictions(
            (values[1:1 + n_prior], values[1 + n_prior:1 + n_prior + n_loc],
             values[1 + n_prior + n_loc:]), num_classes)
        pbox, pvar = table[:, :4], table[:, 4:]
        num_p = table.shape[0]
        enforce(loc.shape[1] == num_p, "loc predictions/prior count mismatch")
        # each label row is one image's instance set, matched against
        # that image's predictions; the JAX package's per-image map
        # refuses a label whose rows are not the images' (a packed row of
        # two images' boxes), where broadcasting would match one image's
        # boxes against every image
        enforce(gt.data.shape[0] == loc.shape[0],
                "multibox_loss: the label has %d rows and the predictions "
                "%d images; each label row holds one image's ground truth",
                gt.data.shape[0], loc.shape[0])
        gt_label = gt.data[..., 0].long()
        gt_box = gt.data[..., 1:5]
        match, match_iou = det_ops.match_priors(pbox, gt_box, gt.mask(),
                                                overlap_threshold)
        pos = match >= 0  # [B, P]
        safe = torch.clamp(match, 0, gt_box.shape[1] - 1)
        target = det_ops.encode_box(
            pbox, pvar, gt_box.gather(1, safe[..., None].expand(
                safe.shape + (4,))))
        ad = (loc - target).abs()
        sl1 = torch.where(ad < 1.0, 0.5 * ad * ad, ad - 0.5).sum(dim=-1)
        zero = torch.zeros_like(sl1)
        loc_loss = torch.where(pos, sl1, zero).sum(dim=1)
        target_cls = torch.where(pos, gt_label.gather(1, safe),
                                 torch.full_like(safe, background_id))
        ce = -torch.log_softmax(conf, dim=-1).gather(
            2, target_cls[..., None])[..., 0]
        # hard negatives: the largest background losses, at most ratio x
        # positives
        num_pos = pos.sum(dim=1)
        num_neg = torch.minimum((neg_pos_ratio * num_pos).long(),
                                num_p - num_pos)
        neg_ok = ~pos & (match_iou <= neg_overlap)
        neg_score = torch.where(neg_ok, ce.detach(),
                                torch.full_like(ce, -float("inf")))
        chosen = pos | det_ops.hard_negatives(neg_score, num_neg)
        conf_loss = torch.where(chosen, ce, zero).sum(dim=1)
        denom = torch.clamp(num_pos.to(ce.dtype), min=1.0)
        return (loc_loss + conf_loss) / denom

    return make_node("multibox_loss", forward, inputs, name=name, size=1,
                     layer_attr=layer_attr)


@register_layer("detection_output")
def detection_output(input_loc, input_conf, priorbox, num_classes,
                     nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
                     confidence_threshold=0.01, background_id=0, name=None,
                     layer_attr=None):
    """The SSD inference head (reference: DetectionOutputLayer): decoded
    boxes, NMS per class of the boxes scoring above
    ``confidence_threshold`` (the ``nms_top_k`` best), then the
    ``keep_top_k`` best of all classes. [B, keep_top_k, 7] rows of
    [image, label, score, xmin, ymin, xmax, ymax], label -1 on the rows
    nothing filled (ties in index order, class by class)."""
    locs, confs, priors = (to_list(v) for v in (input_loc, input_conf,
                                                 priorbox))
    name = name or auto_name("detection_output")
    inputs = priors + locs + confs
    n_prior, n_loc = len(priors), len(locs)
    classes = [c for c in range(num_classes) if c != background_id]

    def forward(params, values, ctx):
        table, loc, conf = _predictions(
            (values[:n_prior], values[n_prior:n_prior + n_loc],
             values[n_prior + n_loc:]), num_classes)
        batch, num_p = loc.shape[:2]
        boxes = det_ops.decode_box(table[:, :4], table[:, 4:], loc)
        probs = torch.softmax(conf, dim=-1)
        score = probs[..., classes].transpose(1, 2)  # [B, K, P]
        cand = boxes[:, None].expand(batch, len(classes), num_p, 4)
        idx, keep = det_ops.nms(cand, score, score > confidence_threshold,
                                nms_threshold, min(nms_top_k, num_p))
        k = idx.shape[-1]
        all_boxes = cand.gather(2, idx[..., None].expand(idx.shape + (4,)))
        all_scores = score.gather(2, idx).reshape(batch, -1)
        all_keep = keep.reshape(batch, -1)
        all_cls = torch.as_tensor(classes, device=loc.device).repeat_interleave(
            k).expand(batch, -1)
        s = torch.where(all_keep, all_scores,
                        torch.full_like(all_scores, -1.0))
        k_out = min(keep_top_k, s.shape[1])
        top = torch.sort(s, dim=1, descending=True, stable=True).indices[
            :, :k_out]
        kept = all_keep.gather(1, top)
        label = torch.where(kept, all_cls.gather(1, top),
                            torch.full_like(top, -1))
        rows = torch.cat([
            torch.arange(batch, device=loc.device, dtype=loc.dtype)[
                :, None, None].expand(batch, k_out, 1),
            label[..., None].to(loc.dtype),
            all_scores.gather(1, top)[..., None],
            all_boxes.reshape(batch, -1, 4).gather(
                1, top[..., None].expand(batch, k_out, 4))], dim=2)
        if k_out < keep_top_k:
            rows = torch.cat([rows, rows.new_full(
                (batch, keep_top_k - k_out, 7), -1.0)], dim=1)
        return rows

    return make_node("detection_output", forward, inputs, name=name,
                     size=keep_top_k * 7, layer_attr=layer_attr)
