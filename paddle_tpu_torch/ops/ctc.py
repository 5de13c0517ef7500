"""CTC loss and greedy decode (paddle_tpu/ops/ctc.py; reference
LinearChainCTC.cpp and the warp-ctc binding, WarpCTCLayer). The JAX
package computes these outside any Pallas kernel, and so does the port:
the log-space alpha recursion over the extended label sequence (blank,
l1, blank, l2, ..., blank; 2S+1 states), one loop step per timestep on
[B, 2S+1] tensors, frozen past each input's length. Blank id 0.

``NEG_INF`` is finite (-1e30) and ``_log_add`` clamps its differences at
it, as the JAX package does, so that autograd meets no ``-inf - -inf``.
"""

import torch

NEG_INF = -1e30


def _neg_inf_like(x):
    return torch.full((), NEG_INF, dtype=x.dtype, device=x.device)


def _log_add(a, b):
    """log(exp(a) + exp(b)), stable, with finite ``NEG_INF`` floors."""
    mx = torch.maximum(a, b)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    floor = _neg_inf_like(a)
    return mx + torch.log(torch.exp(torch.maximum(a - mx, floor))
                          + torch.exp(torch.maximum(b - mx, floor)))


def ctc_loss(log_probs, input_lengths, labels, label_lengths, blank=0):
    """Per-sample CTC negative log-likelihood [B].

    log_probs [B, T, C] (log softmax over C, blank included);
    input_lengths [B]; labels int [B, S] (padded with anything);
    label_lengths [B]."""
    b, t_max, _ = log_probs.shape
    s_max = labels.shape[1]
    ext = 2 * s_max + 1
    device = log_probs.device
    labels = labels.long()
    label_lengths = label_lengths.long()
    input_lengths = input_lengths.long()
    neg = _neg_inf_like(log_probs)

    ext_labels = torch.full((b, ext), blank, dtype=torch.long, device=device)
    ext_labels[:, 1::2] = labels
    ext_valid = (torch.arange(ext, device=device)[None, :]
                 < (2 * label_lengths[:, None] + 1))
    # the skip s-2 -> s only onto a non-blank that differs from the label
    # two states back
    prev2 = torch.cat([torch.full((b, 2), -1, dtype=torch.long,
                                  device=device), ext_labels[:, :-2]], dim=1)
    can_skip = (ext_labels != blank) & (ext_labels != prev2)

    alpha = torch.full((b, ext), NEG_INF, dtype=log_probs.dtype,
                       device=device)
    first_label = log_probs[:, 0, :].gather(1, ext_labels[:, 1:2])[:, 0]
    alpha = torch.cat([
        log_probs[:, 0, blank][:, None],
        torch.where(label_lengths > 0, first_label, neg)[:, None],
        alpha[:, 2:]], dim=1)
    for t in range(1, t_max):
        from_prev = torch.cat([alpha.new_full((b, 1), NEG_INF),
                               alpha[:, :-1]], dim=1)
        from_skip = torch.cat([alpha.new_full((b, 2), NEG_INF),
                               alpha[:, :-2]], dim=1)
        from_skip = torch.where(can_skip, from_skip, neg)
        merged = _log_add(_log_add(alpha, from_prev), from_skip)
        new_alpha = merged + log_probs[:, t, :].gather(1, ext_labels)
        new_alpha = torch.where(ext_valid, new_alpha, neg)
        # frozen past each sequence's input length
        active = (t < input_lengths)[:, None]
        alpha = torch.where(active, new_alpha, alpha)

    # the last blank and the last label states
    a_blank = alpha.gather(1, (2 * label_lengths)[:, None])[:, 0]
    last_label = torch.clamp(2 * label_lengths - 1, min=0)
    a_label = alpha.gather(1, last_label[:, None])[:, 0]
    a_label = torch.where(label_lengths > 0, a_label, neg)
    return -_log_add(a_blank, a_label)


def ctc_greedy_decode(log_probs, input_lengths, blank=0):
    """Best-path decode: argmax per frame, repeats collapsed, blanks
    dropped. Returns (ids [B, T] padded with -1, lengths [B]), int32."""
    ids = torch.argmax(log_probs, dim=-1).to(torch.int32)  # [B, T]
    steps = torch.arange(ids.shape[1], device=ids.device)[None, :]
    valid = steps < input_lengths[:, None]
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    keep = valid & (ids != blank) & (ids != prev)
    # a stable left compaction of the kept ids
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    compacted = ids.gather(1, order)
    kept = keep.gather(1, order)
    out = torch.where(kept, compacted, torch.full_like(compacted, -1))
    return out, keep.sum(dim=1).to(torch.int32)
