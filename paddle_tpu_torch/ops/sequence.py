"""Sequence ops on padded [B, T, ...] data (paddle_tpu/ops/sequence.py):
the shift of a batch within its sequences, the context window and the
lookahead row convolution built on it, and expand. The JAX package computes these outside any Pallas kernel
(shift, mask and concatenate, fused by XLA), and so do these."""

import torch


def shift_steps(data, mask, offset, pad_value=0.0):
    """Shift a [B, T, D] batch by ``offset`` steps within each sequence:
    out[:, t] = data[:, t + offset] where that step is valid, else
    ``pad_value``; ``mask`` [B, T] keeps padding from leaking across a
    sequence's end."""
    mask = mask.to(torch.bool)
    if offset == 0:
        shifted, valid = data, mask
    elif offset > 0:
        shifted = torch.cat([data[:, offset:],
                             torch.zeros_like(data[:, :offset])], dim=1)
        valid = torch.cat([mask[:, offset:],
                           torch.zeros_like(mask[:, :offset])], dim=1)
    else:
        k = -offset
        shifted = torch.cat([torch.zeros_like(data[:, :k]), data[:, :-k]],
                            dim=1)
        valid = torch.cat([torch.zeros_like(mask[:, :k]), mask[:, :-k]],
                          dim=1)
    return torch.where(valid[..., None], shifted,
                       torch.full((), pad_value, dtype=data.dtype,
                                  device=data.device))


def context_projection(data, mask, context_start, context_len,
                       padding=None):
    """The sliding window of ``context_len`` steps from ``context_start``
    concatenated on the feature axis (reference: ContextProjection):
    out[:, t] = concat over o in [start, start + len) of data[:, t + o].
    A step outside its sequence reads zeros, or with ``padding`` (the
    trainable padding, [max(0, -start) + max(0, start + len - 1), D]) the
    row for that offset: the first |o| steps of a sequence read row
    ``begin_pad + o`` for o < 0, its last o valid steps row
    ``begin_pad + o - 1`` for o > 0."""
    mask = mask.to(torch.bool)
    steps = torch.arange(data.shape[1], device=data.device)[None, :, None]
    lengths = mask.sum(dim=1)[:, None, None]
    begin_pad = max(0, -context_start)
    cols = []
    for i in range(context_len):
        offset = context_start + i
        col = shift_steps(data, mask, offset)
        if padding is not None and offset < 0:
            use_pad = (steps < -offset) & mask[..., None]
            col = torch.where(use_pad, padding[begin_pad + offset], col)
        elif padding is not None and offset > 0:
            use_pad = (steps >= lengths - offset) & mask[..., None]
            col = torch.where(use_pad, padding[begin_pad + offset - 1], col)
        cols.append(col)
    return torch.cat(cols, dim=-1)


def row_conv(data, mask, weights):
    """Lookahead row convolution (reference: RowConvOp, RowConvLayer):
    out[:, t] = sum over i < k of w[i] * data[:, t + i], within each
    sequence, zero on padding steps; ``weights`` [k, D]."""
    out = torch.zeros_like(data)
    for i in range(weights.shape[0]):
        out = out + shift_steps(data, mask, i) * weights[i]
    return out * mask[..., None].to(data.dtype)


def expand_to(data, target_mask):
    """Broadcast one row per sequence across its timesteps (reference:
    ExpandLayer): data [B, D] -> [B, T, D], zero where ``target_mask``
    [B, T] is false."""
    out = data[:, None, :].expand(data.shape[0], target_mask.shape[1],
                                  data.shape[-1])
    return out * target_mask[..., None].to(data.dtype)
