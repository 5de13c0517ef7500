"""The linear-chain CRF layers: crf (the cost) and crf_decoding (Viterbi)
(reference: CRFLayer, CRFDecodingLayer over LinearChainCRF.cpp;
paddle_tpu/layer/extra.py:31-95). The weight ``<name>.w0`` is the
reference's (L+2) x L matrix: start, stop, then the transitions. The
other structured and sampled losses of the JAX module (ctc, warp_ctc,
nce, hsigmoid) come with a later part of the port."""

import torch

from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.layer.base import (
    data_of,
    is_seq,
    make_node,
    register_layer,
    reject_packed,
    weight_spec,
)
from paddle_tpu_torch.ops import crf as crf_ops
from paddle_tpu_torch.utils.error import enforce


@register_layer("crf")
def crf(input, label, size=None, weight=None, param_attr=None, name=None,
        layer_attr=None):
    """Linear-chain CRF negative log-likelihood: ``input`` a sequence of
    per-label scores [B, T, L], ``label`` a sequence of label ids; the
    per-sequence cost [B], times the optional per-sequence ``weight``.
    The node's size is the number of labels (the reference's CRFLayer
    convention)."""
    size = size or input.size
    from paddle_tpu_torch.graph import auto_name

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
    from paddle_tpu_torch.graph import auto_name

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
