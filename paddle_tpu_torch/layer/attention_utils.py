"""Attention helper layers (paddle_tpu/layer/attention_utils.py; support
for networks.simple_attention)."""

import torch

from paddle_tpu_torch.layer.base import is_seq, make_node
from paddle_tpu_torch.utils.error import enforce


def sequence_softmax_pool(scores, values, name=None):
    """Softmax of the per-step scalar ``scores`` over each sequence's
    valid steps, then the weighted sum of the ``values`` sequence: one
    vector per sequence (the fused tail of the reference's
    simple_attention). Padded logits are set to the dtype's lowest finite
    value, so their weight is exactly 0 in bfloat16 too, and a sequence of
    length 0 pools to zeros."""

    def forward(params, vals, ctx):
        s, v = vals[0], vals[1]
        enforce(is_seq(s) and is_seq(v), "attention expects sequences")
        logits = s.data[..., 0]
        mask = s.mask()
        masked = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        w = torch.exp(masked - masked.max(dim=1, keepdim=True).values)
        w = w * mask.to(w.dtype)
        w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)
        return torch.bmm(w[:, None, :], v.data)[:, 0]

    return make_node("attention_pool", forward, [scores, values], name=name,
                     size=values.size)
