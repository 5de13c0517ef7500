"""Evaluators: streaming metrics computed inside the train step
(paddle_tpu/evaluator.py; reference gserver/evaluators/Evaluator.cpp,
ChunkEvaluator.cpp, CTCErrorEvaluator.cpp).

An evaluator is a LayerNode whose forward returns a small dict of batch
statistics as device tensors, computed in the same step as the cost (and
so inside the fused loop's captured graph); the trainer reads them back
with the cost, the host accumulates them with ``merge`` and finalizes
with ``result``: the JAX package's ``_mk_eval`` / ``_acc_add`` rules, in
float64 on the host. Every forward is written without a read of a device
value, so it can be captured.
"""

import numpy as np
import torch

from paddle_tpu_torch.layer.base import data_of, is_seq, make_node
from paddle_tpu_torch.utils.error import enforce


class EvalNode:
    """Mixin marker: LayerNodes with .merge/.result are evaluators."""


def _mk_eval(kind, forward, inputs, name, merge_fn, result_fn):
    node = make_node("evaluator:" + kind, forward, inputs, name=name, size=1)
    node.is_evaluator = True
    node.merge = merge_fn
    node.result = result_fn
    return node


def _acc_add(acc, stats):
    if acc is None:
        return {k: np.asarray(v, dtype=np.float64) for k, v in stats.items()}
    return {k: acc[k] + np.asarray(v, dtype=np.float64)
            for k, v in stats.items()}


def host_stats(stats):
    """A forward's stats dict as numpy arrays (floating ones as float32),
    the form ``merge`` takes."""
    out = {}
    for k, v in stats.items():
        v = v.detach()
        if v.is_floating_point():
            v = v.float()
        out[k] = v.cpu().numpy()
    return out


def _count(like, n):
    """A float32 scalar ``n`` on ``like``'s device, made by a fill (no
    host-to-device copy, so it can be captured)."""
    return torch.full((), float(n), dtype=torch.float32, device=like.device)


def _shift_right(x, fill):
    """x[:, :-1] padded on the left with ``fill`` (jnp.pad(x[:, :-1],
    ((0, 0), (1, 0))))."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _shift_left(x, fill):
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def classification_error(input, label, weight=None, name=None, top_k=1):
    """Fraction of wrongly classified samples (reference:
    ClassificationErrorEvaluator; sequences via masking, sample
    weights)."""
    inputs = [input, label] + ([weight] if weight is not None else [])

    def forward(params, values, ctx):
        out, lab = values[0], values[1]
        x, y = data_of(out), data_of(lab).long()
        if top_k == 1:
            pred_ok = torch.argmax(x, dim=-1) == y
        else:
            top_idx = torch.topk(x, top_k, dim=-1).indices
            pred_ok = (top_idx == y[..., None]).any(dim=-1)
        wrong = (~pred_ok).float()
        if is_seq(lab):
            m = lab.mask(torch.float32)
            if weight is not None:
                m = m * data_of(values[2]).float().reshape(m.shape)
            return {"wrong": torch.sum(wrong * m), "total": torch.sum(m)}
        if weight is not None:
            w = data_of(values[2]).float().reshape(wrong.shape)
            return {"wrong": torch.sum(wrong * w), "total": torch.sum(w)}
        return {"wrong": torch.sum(wrong),
                "total": _count(wrong, wrong.numel())}

    def result(acc):
        if not acc or acc["total"] == 0:
            return 0.0
        return float(acc["wrong"] / acc["total"])

    return _mk_eval("classification_error", forward, inputs, name, _acc_add,
                    result)


def seq_classification_error(input, label, name=None):
    """Whole-sequence classification error: a sequence counts as ONE error
    if ANY of its frames is misclassified; the denominator is the number
    of sequences (reference: SequenceClassificationErrorEvaluator)."""
    inputs = [input, label]

    def forward(params, values, ctx):
        out, lab = values[0], values[1]
        enforce(is_seq(out) and is_seq(lab),
                "seq_classification_error expects sequence input AND label "
                "(the reference requires sequenceStartPositions)")
        x, y = data_of(out), data_of(lab).long()
        wrong = torch.argmax(x, dim=-1) != y
        m = lab.mask(torch.float32)
        frame_errs = torch.sum(wrong.float() * m, dim=-1)
        live = (torch.sum(m, dim=-1) > 0).float()
        return {"wrong": torch.sum((frame_errs > 0).float() * live),
                "total": torch.sum(live)}

    def result(acc):
        if not acc or acc["total"] == 0:
            return 0.0
        return float(acc["wrong"] / acc["total"])

    return _mk_eval("seq_classification_error", forward, inputs, name,
                    _acc_add, result)


def sum_evaluator(input, weight=None, name=None):
    """Sum of input values (reference: SumEvaluator)."""
    inputs = [input] + ([weight] if weight is not None else [])

    def forward(params, values, ctx):
        x = data_of(values[0]).float()
        if weight is not None:
            x = x * data_of(values[1]).float().reshape(
                x.shape[:1] + (1,) * (x.dim() - 1))
        return {"sum": torch.sum(x), "count": _count(x, x.shape[0])}

    def result(acc):
        return float(acc["sum"]) if acc else 0.0

    return _mk_eval("sum", forward, inputs, name, _acc_add, result)


def column_sum_evaluator(input, weight=None, name=None):
    """Per-column mean stats (reference: ColumnSumEvaluator)."""
    inputs = [input] + ([weight] if weight is not None else [])

    def forward(params, values, ctx):
        x = data_of(values[0]).float()
        x2 = x.reshape(-1, x.shape[-1])
        return {"col_sum": torch.sum(x2, dim=0),
                "count": _count(x2, x2.shape[0])}

    def result(acc):
        if not acc or acc["count"] == 0:
            return None
        return (acc["col_sum"] / acc["count"]).tolist()

    return _mk_eval("column_sum", forward, inputs, name, _acc_add, result)


def auc(input, label, weight=None, name=None, num_thresholds=1024):
    """Streaming AUC via score histograms (reference: AucEvaluator).
    input column 1 (or the single column) is P(positive)."""
    inputs = [input, label] + ([weight] if weight is not None else [])

    def forward(params, values, ctx):
        x = data_of(values[0]).float()
        y = data_of(values[1]).reshape(-1)
        score = x[..., 1] if x.shape[-1] > 1 else x[..., 0]
        score = score.reshape(-1)
        w = (data_of(values[2]).float().reshape(-1)
             if weight is not None else torch.ones_like(score))
        bins = torch.clamp((score * num_thresholds).to(torch.int32), 0,
                           num_thresholds - 1).long()
        zeros = torch.zeros((num_thresholds,), dtype=torch.float32,
                            device=score.device)
        pos = zeros.index_add(0, bins, w * (y > 0).float())
        neg = zeros.index_add(0, bins, w * (y <= 0).float())
        return {"pos_hist": pos, "neg_hist": neg}

    def result(acc):
        if not acc:
            return 0.0
        pos, neg = acc["pos_hist"], acc["neg_hist"]
        # integrate ROC from the high-score end (trapezoid on bin boundaries)
        tp = np.cumsum(pos[::-1])
        fp = np.cumsum(neg[::-1])
        tot_pos, tot_neg = tp[-1], fp[-1]
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tpr = np.concatenate([[0.0], tp / tot_pos])
        fpr = np.concatenate([[0.0], fp / tot_neg])
        return float(np.trapezoid(tpr, fpr))

    return _mk_eval("auc", forward, inputs, name, _acc_add, result)


def _one_hot(idx, n):
    return (idx[:, None] == torch.arange(n, device=idx.device)[None, :]) \
        .float()


def precision_recall(input, label, weight=None, name=None,
                     positive_label=None):
    """Per-class precision/recall/F1, macro + micro (reference:
    PrecisionRecallEvaluator)."""
    inputs = [input, label] + ([weight] if weight is not None else [])
    num_classes = input.size

    def forward(params, values, ctx):
        x = data_of(values[0]).float()
        y = data_of(values[1]).reshape(-1).long()
        pred = torch.argmax(x.reshape(-1, x.shape[-1]), dim=-1)
        w = (data_of(values[2]).float().reshape(-1)
             if weight is not None
             else torch.ones(pred.shape, dtype=torch.float32,
                             device=pred.device))
        oh_pred = _one_hot(pred, num_classes) * w[:, None]
        oh_true = _one_hot(y, num_classes) * w[:, None]
        return {"tp": torch.sum(oh_pred * oh_true, dim=0),
                "pred_count": torch.sum(oh_pred, dim=0),
                "true_count": torch.sum(oh_true, dim=0)}

    def result(acc):
        if not acc:
            return {}
        tp, pc, tc = acc["tp"], acc["pred_count"], acc["true_count"]
        if positive_label is not None:
            tp, pc, tc = (a[positive_label] for a in (tp, pc, tc))
        prec = np.where(pc > 0, tp / np.maximum(pc, 1), 0.0)
        rec = np.where(tc > 0, tp / np.maximum(tc, 1), 0.0)
        f1 = np.where(prec + rec > 0,
                      2 * prec * rec / np.maximum(prec + rec, 1e-12), 0.0)
        micro_p = tp.sum() / max(pc.sum(), 1.0) if np.ndim(tp) else prec
        micro_r = tp.sum() / max(tc.sum(), 1.0) if np.ndim(tp) else rec
        return {
            "precision": prec.tolist() if np.ndim(prec) else float(prec),
            "recall": rec.tolist() if np.ndim(rec) else float(rec),
            "f1": f1.tolist() if np.ndim(f1) else float(f1),
            "macro_f1": float(np.mean(f1)) if np.ndim(f1) else float(f1),
            "micro_precision": float(micro_p) if np.ndim(tp) else float(prec),
            "micro_recall": float(micro_r) if np.ndim(tp) else float(rec),
        }

    return _mk_eval("precision_recall", forward, inputs, name, _acc_add,
                    result)


def chunk(input, label, chunk_scheme="IOB", num_chunk_types=None,
          excluded_chunk_types=None, name=None):
    """Chunk-level precision/recall/F1 for sequence tagging — the NER
    metric (reference: ChunkEvaluator.cpp). Tag encoding: tag =
    chunk_type * num_tag_types + tag_type, O = num_chunk_types *
    num_tag_types; schemes plain, IOB, IOE, IOBES. A predicted chunk is
    correct iff no begin/end/type disagreement occurs anywhere inside its
    span (a prefix sum of mismatch flags), as the JAX package computes
    it."""
    scheme = chunk_scheme
    n_tag = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}[scheme]
    enforce(num_chunk_types is not None, "chunk: num_chunk_types required")
    o_tag = num_chunk_types * n_tag
    excluded = set(excluded_chunk_types or ())

    def split(tags):
        """-> (chunk_type, tag_type, is_o) with excluded types forced to O."""
        is_o = tags >= o_tag
        minus = torch.full_like(tags, -1)
        ctype = torch.where(is_o, minus, tags // n_tag)
        ttype = torch.where(is_o, minus, tags % n_tag)
        for ex in excluded:
            is_o = is_o | (ctype == ex)
        ctype = torch.where(is_o, minus, ctype)
        return ctype, ttype, is_o

    def begins_ends(tags, valid):
        ctype, ttype, is_o = split(tags)
        prev_c, prev_t = _shift_right(ctype, -1), _shift_right(ttype, -1)
        next_c, next_t = _shift_left(ctype, -1), _shift_left(ttype, -1)
        prev_o = _shift_right(is_o, True) | ~_shift_right(valid, False)
        next_o = _shift_left(is_o, True) | ~_shift_left(valid, False)
        diff_prev = prev_o | (prev_c != ctype)
        diff_next = next_o | (next_c != ctype)
        if scheme == "plain":
            begin, end = diff_prev, diff_next
        elif scheme == "IOB":          # tag_type: B=0, I=1
            begin = (ttype == 0) | diff_prev
            end = diff_next | (next_t == 0)
        elif scheme == "IOE":          # tag_type: I=0, E=1
            begin = diff_prev | (prev_t == 1)
            end = (ttype == 1) | diff_next
        else:                          # IOBES: B=0, I=1, E=2, S=3
            begin = (ttype == 0) | (ttype == 3) | diff_prev
            end = (ttype == 2) | (ttype == 3) | diff_next
        ok = valid & ~is_o
        return begin & ok, end & ok, ctype, ok

    def count_correct(p_beg, p_end, p_c, l_beg, l_end, l_c, l_in_chunk):
        mismatch = (p_beg != l_beg) | (p_end != l_end) | \
            (p_beg & l_beg & (p_c != l_c)) | ((p_c != l_c) & l_in_chunk)
        mis_cum = torch.cumsum(mismatch.long(), dim=1)
        t = p_beg.shape[1]
        pos = torch.arange(t, device=p_beg.device)[None, :]
        # last begin position at or before i (in pred)
        lastb = torch.cummax(torch.where(p_beg, pos, torch.full_like(
            pos, -1).expand_as(p_beg)), dim=1).values
        at = torch.clamp(lastb, 0, t - 1)
        s_cum = torch.gather(mis_cum, 1, at)
        s_mis = torch.gather(mismatch.long(), 1, at)
        span_clean = (mis_cum - s_cum + s_mis) == 0
        return torch.sum(p_end & l_end & (lastb >= 0) & span_clean)

    def forward(params, values, ctx):
        pred, lab = values[0], values[1]
        enforce(is_seq(pred) and is_seq(lab), "chunk expects sequences")
        p_tags = data_of(pred)
        if p_tags.dim() == 3:  # score matrix: take argmax tags
            p_tags = torch.argmax(p_tags, dim=-1)
        p_tags = p_tags.long()
        l_tags = data_of(lab).long()
        valid = lab.mask()
        p_beg, p_end, p_c, _ = begins_ends(p_tags, valid)
        l_beg, l_end, l_c, l_in_chunk = begins_ends(l_tags, valid)
        correct = count_correct(p_beg, p_end, p_c, l_beg, l_end, l_c,
                                l_in_chunk)
        return {"num_correct": correct.float(),
                "num_pred": torch.sum(p_beg).float(),
                "num_label": torch.sum(l_beg).float()}

    def result(acc):
        if not acc:
            return {}
        prec = acc["num_correct"] / max(acc["num_pred"], 1.0)
        rec = acc["num_correct"] / max(acc["num_label"], 1.0)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return {"precision": float(prec), "recall": float(rec),
                "f1": float(f1)}

    return _mk_eval("chunk", forward, [input, label], name, _acc_add, result)


def ctc_error(input, label, name=None):
    """Sequence-normalized CTC edit distance (reference:
    CTCErrorEvaluator.cpp — best-path decode then Levenshtein against the
    label). blank = 0, matching the ctc layer contract."""

    def forward(params, values, ctx):
        pred, lab = values[0], values[1]
        enforce(is_seq(pred) and is_seq(lab), "ctc_error expects sequences")
        frames = torch.argmax(data_of(pred), dim=-1)        # [B, T]
        fmask = pred.mask()
        # collapse repeats then drop blanks (best-path decode)
        keep = (frames != _shift_right(frames, -1)) & (frames != 0) & fmask
        t = frames.shape[1]
        pos = torch.arange(t, device=frames.device)[None, :]
        order = torch.where(keep, pos, torch.full_like(pos, t)
                            .expand_as(keep))
        idx = torch.argsort(order, dim=1, stable=True)
        dec = torch.gather(torch.where(keep, frames,
                                       torch.zeros_like(frames)), 1, idx)
        dec_len = torch.sum(keep, dim=1)
        ref = data_of(lab).long()
        ref_len = lab.lengths
        dist = _edit_distance(dec, dec_len, ref, ref_len)
        ref_f = ref_len.float()
        return {"dist": torch.sum(dist / torch.clamp(ref_f, min=1.0)),
                "count": _count(dist, dist.shape[0]),
                "total_dist": torch.sum(dist),
                "total_ref": torch.sum(ref_f)}

    def result(acc):
        if not acc or acc["count"] == 0:
            return 0.0
        return float(acc["dist"] / acc["count"])

    return _mk_eval("ctc_error", forward, [input, label], name, _acc_add,
                    result)


def _edit_distance(a, a_len, b, b_len):
    """Batched Levenshtein distance over padded id arrays: a [B, Ta], b
    [B, Tb] -> [B] float32, the JAX package's DP row by row (its two
    ``lax.scan`` loops as Python loops of fixed trip count)."""
    ta, tb = a.shape[1], b.shape[1]
    jb = torch.arange(tb + 1, dtype=torch.float32, device=a.device)
    row = jb[None, :].expand(a.shape[0], tb + 1)  # distance from empty a
    for i in range(ta):
        sub_cost = (a[:, i:i + 1] != b).float()       # [B, Tb]
        left = row[:, 0] + 1.0
        cols = [left]
        for j in range(tb):
            left = torch.minimum(torch.minimum(left + 1.0, row[:, j + 1]
                                               + 1.0),
                                 row[:, j] + sub_cost[:, j])
            cols.append(left)
        new_row = torch.stack(cols, dim=1)
        # rows beyond a's length keep the old row
        row = torch.where((i < a_len)[:, None], new_row, row)
    return torch.gather(row, 1, b_len[:, None].long())[:, 0]


def pnpair(input, label, query_id, weight=None, name=None):
    """Positive-negative pair statistic for ranking (reference:
    PnpairEvaluator — within each query, concordant / discordant / tied
    score pairs over label-ordered pairs)."""
    inputs = [input, label, query_id] + ([weight] if weight is not None
                                         else [])

    def forward(params, values, ctx):
        score = data_of(values[0]).float().reshape(-1)
        y = data_of(values[1]).reshape(-1).float()
        q = data_of(values[2]).reshape(-1).long()
        w = (data_of(values[3]).float().reshape(-1)
             if weight is not None else torch.ones_like(score))
        mask = (q[:, None] == q[None, :]) & (y[:, None] > y[None, :])
        pair_w = (w[:, None] + w[None, :]) * 0.5
        sdiff = score[:, None] - score[None, :]
        zero = torch.zeros_like(pair_w)
        return {"pos": torch.sum(torch.where(mask & (sdiff > 0), pair_w,
                                             zero)),
                "neg": torch.sum(torch.where(mask & (sdiff < 0), pair_w,
                                             zero)),
                "spe": torch.sum(torch.where(mask & (sdiff == 0), pair_w,
                                             zero))}

    def result(acc):
        if not acc:
            return {}
        pos, neg, spe = acc["pos"], acc["neg"] + 1e-12, acc["spe"]
        return {"pos/neg": float(pos / neg),
                "pos": float(pos), "neg": float(acc["neg"]),
                "spe": float(spe)}

    return _mk_eval("pnpair", forward, inputs, name, _acc_add, result)


def detection_map(input, label, overlap_threshold=0.5, background_id=0,
                  evaluate_difficult=False, ap_type="11point", name=None):
    """Mean average precision over detection_output rows (reference:
    DetectionMAPEvaluator.cpp; paddle_tpu/evaluator.py detection_map).
    ``input`` is a detection_output layer ([B, K, 7] rows), ``label`` the
    ground-truth box sequence ([label, xmin, ymin, xmax, ymax,
    difficult]).

    Per batch the device marks each detection a true positive by a greedy
    match in score order (ties in index order) against the unclaimed
    ground truth of its class, one loop step per detection slot batched
    over the images; without ``evaluate_difficult`` a detection whose
    only match is a difficult box is ignored (VOC). The host accumulates
    (class, score, tp) and the per-class positives and finalises AP by
    the 11-point or the integral rule."""
    from paddle_tpu_torch.ops import detection as det_ops

    def forward(params, values, ctx):
        det, gt = values[0], values[1]
        rows = data_of(det)  # [B, K, 7]
        enforce(is_seq(gt), "detection_map label must be a sequence")
        gt_rows = data_of(gt)  # [B, G, 6]
        gvalid = gt.mask()
        dcls = rows[..., 1].long()
        dvalid = dcls >= 0
        gcls = gt_rows[..., 0].long()
        gdiff = gt_rows[..., 5] > 0.5
        gkeep = gvalid if evaluate_difficult else (gvalid & ~gdiff)
        iou = det_ops.jaccard_overlap(rows[..., 3:7], gt_rows[..., 1:5])
        same_cls = dcls[:, :, None] == gcls[:, None, :]
        cand = torch.where(same_cls & gkeep[:, None, :], iou,
                           torch.zeros_like(iou))
        score = torch.where(dvalid, rows[..., 2],
                            torch.full_like(rows[..., 2], -float("inf")))
        order = torch.sort(score, dim=1, descending=True,
                           stable=True).indices
        batch = torch.arange(rows.shape[0], device=rows.device)
        claimed = torch.zeros_like(gvalid, dtype=torch.bool)
        tp = torch.zeros_like(dvalid)
        minus_one = cand.new_full((), -1.0)
        for k in range(rows.shape[1]):
            i = order[:, k]
            ious = torch.where(claimed, minus_one, cand[batch, i])
            j = torch.argmax(ious, dim=1)
            hit = (ious[batch, j] > overlap_threshold) & dvalid[batch, i]
            claimed[batch, j] |= hit
            tp[batch, i] = hit
        if evaluate_difficult:
            ignore = torch.zeros_like(tp)
        else:
            diff_cand = ((iou > overlap_threshold) & same_cls
                         & (gvalid & gdiff)[:, None, :])
            ignore = ~tp & diff_cand.any(dim=2)
        return {"rows_cls": rows[..., 1], "rows_score": rows[..., 2],
                "tp": tp, "ignore": ignore,
                "gt_cls": torch.where(gkeep, gcls, torch.full_like(gcls, -1))}

    def merge(acc, stats):
        stats = {k: np.asarray(v) for k, v in stats.items()}
        if acc is None:
            acc = {"cls": [], "score": [], "tp": [], "npos": {}}
        cls = stats["rows_cls"].reshape(-1)
        keep = (cls >= 0) & ~stats["ignore"].reshape(-1)
        acc["cls"].append(cls[keep])
        acc["score"].append(stats["rows_score"].reshape(-1)[keep])
        acc["tp"].append(stats["tp"].reshape(-1)[keep])
        for c in stats["gt_cls"].reshape(-1):
            if c >= 0:
                acc["npos"][int(c)] = acc["npos"].get(int(c), 0) + 1
        return acc

    def result(acc):
        if not acc or not acc["cls"]:
            return 0.0
        cls = np.concatenate(acc["cls"])
        score = np.concatenate(acc["score"])
        tp = np.concatenate(acc["tp"])
        aps = []
        for c, npos in acc["npos"].items():
            sel = cls == c
            if npos == 0:
                continue
            if not sel.any():
                aps.append(0.0)
                continue
            tps = tp[sel][np.argsort(-score[sel])]
            tp_cum = np.cumsum(tps)
            fp_cum = np.cumsum(~tps)
            rec = tp_cum / npos
            prec = tp_cum / np.maximum(tp_cum + fp_cum, 1)
            if ap_type == "11point":
                ap = np.mean([prec[rec >= t].max() if (rec >= t).any()
                              else 0.0 for t in np.linspace(0, 1, 11)])
            else:  # integral
                ap = float(np.sum(np.diff(np.concatenate([[0.0], rec]))
                                  * prec))
            aps.append(float(ap))
        return float(np.mean(aps)) if aps else 0.0

    return _mk_eval("detection_map", forward, [input, label], name, merge,
                    result)


def value_printer(input, name=None):
    """Print layer values each eval (reference: ValuePrinter gadget)."""
    from paddle_tpu_torch.layer.sequence import print_layer

    return print_layer(input, name=name)


def _printer(kind, inputs, name, extract, render):
    """Shared shape of the printer evaluators (reference: Evaluator.cpp
    printer gadgets — side-channel debugging output, result is None)."""
    from paddle_tpu_torch.utils.logger import logger

    def forward(params, values, ctx):
        return extract(values)

    def merge(acc, stats):
        logger.info("%s: %s", kind, render(stats))
        return acc or {}

    def result(acc):
        return None

    return _mk_eval(kind, forward, inputs, name, merge, result)


def gradient_printer(input, name=None):
    """Print the mean/absmax of the layer's output values, the JAX
    package's analogue of the reference's GradientPrinter."""
    return _printer(
        "gradient_printer", [input], name,
        lambda values: {"mean": torch.mean(data_of(values[0]).float()),
                        "absmax": torch.max(torch.abs(
                            data_of(values[0]).float()))},
        lambda s: "mean=%.6g absmax=%.6g" % (float(s["mean"]),
                                             float(s["absmax"])))


def maxid_printer(input, num_results=5, name=None):
    """Print the top-k ids of each sample (reference: MaxIdPrinter)."""
    def extract(values):
        x = data_of(values[0])
        x = x.reshape(-1, x.shape[-1])
        return {"ids": torch.topk(x, min(num_results, x.shape[-1]),
                                  dim=-1).indices}

    return _printer("maxid_printer", [input], name, extract,
                    lambda s: np.asarray(s["ids"]).tolist())


def maxframe_printer(input, num_frames=5, name=None):
    """Print the per-sequence frames with maximal value (reference:
    MaxFramePrinter)."""
    def extract(values):
        x = values[0]
        enforce(is_seq(x), "maxframe_printer expects a sequence")
        score = torch.max(data_of(x).float(), dim=-1).values
        score = torch.where(x.mask(), score,
                            torch.full_like(score, -float("inf")))
        return {"frames": torch.topk(score, min(num_frames, score.shape[1]),
                                     dim=-1).indices}

    return _printer("maxframe_printer", [input], name, extract,
                    lambda s: np.asarray(s["frames"]).tolist())


def seqtext_printer(input, id_to_word=None, name=None):
    """Print decoded id sequences, optionally mapped through a vocabulary
    dict (reference: SeqTextPrinter)."""
    def extract(values):
        x = values[0]
        enforce(is_seq(x), "seqtext_printer expects an id sequence")
        ids = data_of(x)
        if ids.dim() == 3:
            ids = torch.argmax(ids, dim=-1)
        return {"ids": ids.to(torch.int32), "lengths": x.lengths}

    def render(s):
        out = []
        for row, n in zip(np.asarray(s["ids"]), np.asarray(s["lengths"])):
            toks = row[: int(n)].tolist()
            if id_to_word:
                toks = [id_to_word.get(t, "<unk>") for t in toks]
            out.append(" ".join(str(t) for t in toks))
        return " | ".join(out)

    return _printer("seqtext_printer", [input], name, extract, render)


def classification_error_printer(input, label, name=None):
    """Print per-sample 0/1 classification errors (reference:
    ClassificationErrorPrinter)."""
    def extract(values):
        x = data_of(values[0])
        y = data_of(values[1]).reshape(-1).long()
        pred = torch.argmax(x.reshape(-1, x.shape[-1]), dim=-1)
        return {"err": (pred != y).float()}

    return _printer("classification_error_printer", [input, label], name,
                    extract, lambda s: np.asarray(s["err"]).tolist())


# reference-DSL alias names (trainer_config_helpers/evaluators.py)
classification_error_evaluator = classification_error
seq_classification_error_evaluator = seq_classification_error
auc_evaluator = auc
pnpair_evaluator = pnpair
precision_recall_evaluator = precision_recall
ctc_error_evaluator = ctc_error
chunk_evaluator = chunk
detection_map_evaluator = detection_map
value_printer_evaluator = value_printer
gradient_printer_evaluator = gradient_printer
maxid_printer_evaluator = maxid_printer
maxframe_printer_evaluator = maxframe_printer
seqtext_printer_evaluator = seqtext_printer
classification_error_printer_evaluator = classification_error_printer
