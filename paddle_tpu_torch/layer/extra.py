"""The structured and sampled losses and the remaining reference layer
types (paddle_tpu/layer/extra.py): crf and crf_decoding (reference:
CRFLayer, CRFDecodingLayer over LinearChainCRF.cpp; the weight
``<name>.w0`` is the reference's (L+2) x L matrix: start, stop, then the
transitions), ctc / warp_ctc (CTCLayer, WarpCTCLayer), nce (NCELayer),
hsigmoid (HierarchicalSigmoidLayer), data_norm (DataNormLayer) and
featmap_expand (FeatureMapExpandLayer)."""

import copy

import numpy as np
import torch

from paddle_tpu_torch.attr import ParamAttr
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.graph import auto_name
from paddle_tpu_torch.initializer import Constant
from paddle_tpu_torch.layer.base import (
    bias_spec,
    data_of,
    is_seq,
    like,
    make_node,
    register_layer,
    reject_packed,
    weight_spec,
)
from paddle_tpu_torch.ops import crf as crf_ops
from paddle_tpu_torch.ops import ctc as ctc_ops
from paddle_tpu_torch.utils.error import enforce

_EPS = 1e-8


@register_layer("crf")
def crf(input, label, size=None, weight=None, param_attr=None, name=None,
        layer_attr=None):
    """Linear-chain CRF negative log-likelihood: ``input`` a sequence of
    per-label scores [B, T, L], ``label`` a sequence of label ids; the
    per-sequence cost [B], times the optional per-sequence ``weight``.
    The node's size is the number of labels (the reference's CRFLayer
    convention)."""
    size = size or input.size
    name = name or auto_name("crf_layer")
    wspec = weight_spec(name, 0, (size + 2, size), param_attr, fan_in=size)
    inputs = [input, label] + ([weight] if weight is not None else [])

    def forward(params, values, ctx):
        scores, labels = values[0], values[1]
        enforce(is_seq(scores) and is_seq(labels), "crf expects sequences")
        # chain transitions would bridge packed neighbours
        reject_packed(scores, "crf")
        reject_packed(labels, "crf")
        nll = crf_ops.crf_nll(scores.data, labels.data, scores.mask(),
                              params[wspec.name])
        if weight is not None:
            nll = nll * data_of(values[2]).reshape(nll.shape)
        return nll

    return make_node("crf", forward, inputs, name=name, size=size,
                     param_specs=[wspec], layer_attr=layer_attr)


@register_layer("crf_decoding")
def crf_decoding(input, size=None, label=None, param_attr=None, name=None,
                 layer_attr=None):
    """Viterbi decode (reference: CRFDecodingLayer). Without ``label``
    the best path as an int32 sequence; with ``label`` a per-sequence
    0/1 error indicator (1: the path differs from the label somewhere in
    the valid region)."""
    size = size or input.size
    name = name or auto_name("crf_decoding_layer")
    wspec = weight_spec(name, 0, (size + 2, size), param_attr, fan_in=size)
    inputs = [input] + ([label] if label is not None else [])

    def forward(params, values, ctx):
        scores = values[0]
        enforce(is_seq(scores), "crf_decoding expects a sequence")
        reject_packed(scores, "crf_decoding")  # viterbi bridges segments
        paths, _ = crf_ops.crf_decode(scores.data, scores.mask(),
                                      params[wspec.name])
        if label is not None:
            gold = values[1].data.to(torch.int32)
            diff = (paths != gold) & scores.mask()
            return torch.any(diff, dim=1).to(torch.float32)
        return SequenceBatch(paths, scores.lengths)

    return make_node("crf_decoding", forward, inputs, name=name,
                     size=1 if label is not None else size,
                     param_specs=[wspec], layer_attr=layer_attr)


@register_layer("ctc")
def ctc(input, label, size=None, name=None, norm_by_times=False, blank=0,
        layer_attr=None):
    """CTC cost [B] (reference: CTCLayer over LinearChainCTC; the JAX
    package's contract): blank 0 only, ``size`` = classes + 1 (default:
    the label layer's size + 1, config_parser's CTCLayer rule). A softmax
    input is read in log space (log(p + 1e-8)), raw scores through
    log_softmax; ``norm_by_times`` divides each cost by its input length.
    Packed sequences are refused (an alignment would bridge segments)."""
    enforce(blank == 0, "ctc: only blank=0 is supported (the reference's "
            "default convention; remap class ids so blank is 0)")
    size = size or (getattr(label, "size", 0) + 1 if label is not None
                    else input.size)
    is_probs = getattr(input, "output_activation", None) == "softmax"

    def forward(params, values, ctx):
        scores, labels = values[0], values[1]
        enforce(is_seq(scores) and is_seq(labels), "ctc expects sequences")
        reject_packed(scores, "ctc")
        reject_packed(labels, "ctc")
        x = scores.data
        logp = (torch.log(x + _EPS) if is_probs
                else x - torch.logsumexp(x, dim=-1, keepdim=True))
        nll = ctc_ops.ctc_loss(logp, scores.lengths, labels.data,
                               labels.lengths)
        if norm_by_times:
            nll = nll / torch.clamp(scores.lengths.to(nll.dtype), min=1.0)
        return nll

    return make_node("ctc", forward, [input, label], name=name, size=size,
                     layer_attr=layer_attr)


warp_ctc = ctc  # the reference's WarpCTCLayer: the same loss


@register_layer("nce")
def nce(input, label, num_classes=None, param_attr=None, bias_attr=None,
        num_neg_samples=10, neg_distribution=None, weight=None, name=None,
        layer_attr=None):
    """Noise-contrastive estimation cost [B] (reference: NCELayer): the
    logistic loss of the label against ``num_neg_samples`` negatives
    drawn from ``neg_distribution`` (uniform by default), each logit less
    log(q * K). In train mode the negatives are drawn from the
    evaluation's generator (``Topology.apply(rng=)``; the JAX package's
    key stream is not reproduced), in test mode they are the JAX
    package's strided pseudo-negatives, so test-mode costs agree exactly.
    The weight [num_classes, input.size] (default classes: the label
    layer's width), the bias [num_classes]."""
    enforce(bias_attr is not False, "nce has a bias: bias_attr=False "
            "fails in the JAX package (its forward reads the bias)")
    name = name or auto_name("nce_layer")
    if num_classes is None:
        num_classes = label.size
    feat_dim = input.size
    wspec = weight_spec(name, 0, (num_classes, feat_dim), param_attr,
                        fan_in=feat_dim)
    bspec = bias_spec(name, (num_classes,),
                      bias_attr if bias_attr is not None else True)
    if neg_distribution is not None:
        neg_dist = np.asarray(neg_distribution, np.float32)
        enforce(len(neg_dist) == num_classes,
                "neg_distribution size mismatch")
        neg_dist = neg_dist / neg_dist.sum()
    else:
        neg_dist = np.full((num_classes,), 1.0 / num_classes, np.float32)
    log_q = np.log(neg_dist * num_neg_samples + 1e-20).astype(np.float32)
    stride = num_classes // (num_neg_samples + 1) + 1

    def forward(params, values, ctx):
        x = data_of(values[0])
        y = data_of(values[1]).reshape(-1).long()
        batch = x.shape[0]
        if ctx.is_train:
            dist = torch.as_tensor(neg_dist, device=x.device)
            neg = torch.multinomial(dist.expand(batch, num_classes),
                                    num_neg_samples, replacement=True,
                                    generator=ctx.rng_for(x))
        else:  # strided pseudo-negatives, as the JAX package's
            neg = (y[:, None] + 1 + torch.arange(
                num_neg_samples, device=x.device)[None, :] * stride) \
                % num_classes
        ids = torch.cat([y[:, None], neg], dim=1)  # [B, 1 + K]
        logits = (torch.einsum("bd,bkd->bk", x, params[wspec.name][ids])
                  + params[bspec.name][ids]
                  - torch.as_tensor(log_q, device=x.device)[ids])
        labels01 = torch.zeros_like(logits)
        labels01[:, 0] = 1.0
        # the stable sigmoid cross-entropy
        ce = (torch.maximum(logits, torch.zeros_like(logits))
              - logits * labels01 + torch.log1p(torch.exp(-logits.abs())))
        cost = ce.sum(dim=1)
        if weight is not None:  # the per-sample weight input
            cost = cost * data_of(values[2]).reshape(-1)
        return cost

    inputs = [input, label] + ([weight] if weight is not None else [])
    return make_node("nce", forward, inputs, name=name, size=1,
                     param_specs=[wspec, bspec], layer_attr=layer_attr)


@register_layer("hsigmoid")
def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, layer_attr=None):
    """Hierarchical sigmoid cost [B] over a complete binary tree
    (reference: HierarchicalSigmoidLayer): num_classes - 1 internal
    nodes in heap order, class c the leaf num_classes + c; the logistic
    decisions along the leaf's path to the root, ``max_depth`` steps of
    which those past the root add nothing. The weight [num_classes - 1,
    input.size], the bias [num_classes - 1]."""
    enforce(bias_attr is not False, "hsigmoid has a bias: bias_attr=False "
            "fails in the JAX package (its forward reads the bias)")
    name = name or auto_name("hsigmoid_layer")
    num_internal = num_classes - 1
    wspec = weight_spec(name, 0, (num_internal, input.size), param_attr,
                        fan_in=input.size)
    bspec = bias_spec(name, (num_internal,),
                      bias_attr if bias_attr is not None else True)
    max_depth = int(np.ceil(np.log2(max(num_classes, 2)))) + 1

    def forward(params, values, ctx):
        x = data_of(values[0])
        idx = data_of(values[1]).reshape(-1).long() + num_classes
        w, b = params[wspec.name], params[bspec.name]
        total = x.new_zeros(x.shape[:1])
        for _ in range(max_depth):
            parent = idx // 2
            sign = 1.0 - 2.0 * (idx % 2).to(x.dtype)  # -1: a right child
            node = torch.clamp(parent - 1, 0, num_internal - 1)
            score = (x * w[node]).sum(dim=1) + b[node]
            step = (torch.log1p(torch.exp(-score.abs()))
                    + torch.maximum(-sign * score, torch.zeros_like(score)))
            total = total + torch.where(parent >= 1, step,
                                        torch.zeros_like(step))
            idx = parent
        return total

    return make_node("hsigmoid", forward, [input, label], name=name, size=1,
                     param_specs=[wspec, bspec], layer_attr=layer_attr)


@register_layer("data_norm")
def data_norm(input, data_norm_strategy="z-score", name=None,
              param_attr=None, layer_attr=None):
    """Normalisation by precomputed statistics (reference: DataNormLayer):
    a static (untrained) parameter [5, D] of rows mean, std, min, max and
    decimal scale; ``z-score``, ``min-max`` or ``decimal-scaling``."""
    enforce(data_norm_strategy in ("z-score", "min-max", "decimal-scaling"),
            "unknown data_norm_strategy %r", data_norm_strategy)
    name = name or auto_name("data_norm")
    size = input.size
    # a copy: a caller's ParamAttr may be shared
    attr = copy.copy(ParamAttr.to_attr(param_attr))
    attr.is_static = True
    if attr.initializer is None:
        attr.initializer = Constant(0.0)
    wspec = weight_spec(name, 0, (5, size), attr, fan_in=size)

    def forward(params, values, ctx):
        x = data_of(values[0])
        mean, std, lo, hi, dec = params[wspec.name]
        if data_norm_strategy == "z-score":
            out = (x - mean) / (std + _EPS)
        elif data_norm_strategy == "min-max":
            out = (x - lo) / (hi - lo + _EPS)
        else:
            out = x / (dec + _EPS)
        return like(values[0], out)

    return make_node("data_norm", forward, [input], name=name, size=size,
                     param_specs=[wspec], layer_attr=layer_attr)


@register_layer("featmap_expand")
def featmap_expand(input, num_filters, as_row_vector=True, name=None,
                   layer_attr=None):
    """[.., C] -> [.., C * num_filters] (reference: FeatureMapExpandLayer):
    ``num_filters`` copies of the row side by side (``as_row_vector``),
    else each feature repeated in place."""
    name = name or auto_name("featmap_expand")

    def forward(params, values, ctx):
        x = data_of(values[0])
        out = (torch.cat([x] * num_filters, dim=-1) if as_row_vector
               else torch.repeat_interleave(x, num_filters, dim=-1))
        return like(values[0], out)

    return make_node("featmap_expand", forward, [input], name=name,
                     size=input.size * num_filters, layer_attr=layer_attr)
