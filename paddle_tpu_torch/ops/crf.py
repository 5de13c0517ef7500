"""Linear-chain CRF: negative log-likelihood and Viterbi decode
(paddle_tpu/ops/crf.py:18-103; reference LinearChainCRF.cpp).

Plain PyTorch, as in the JAX package, which runs these as lax.scan
programs outside any Pallas kernel: one loop step per timestep, autograd
for the backward (the forward-backward marginals the reference codes by
hand). Everything runs in the emissions' dtype (bfloat16 under the
mixed-precision policy, as the JAX functions do).

Parameter layout (the reference's (L+2) x L weight matrix): row 0 the
start scores, row 1 the stop scores, rows 2.. the transitions, where
trans[i, j] scores moving from label i to label j.
"""

import torch


def _split_weights(w):
    return w[0], w[1], w[2:]


def _logsumexp(x, dim):
    """log(sum(exp(x))) over ``dim`` as JAX computes it: the max taken out
    and held constant for the gradient, which is then exp(x - max) / sum.
    (``torch.logsumexp``'s gradient, exp(x - result), reads the result
    rounded to x's dtype: in bfloat16 at the partition function's scale,
    a few hundred, that rounding is up to 1, and the forward algorithm
    compounds it over the steps.)"""
    m = torch.amax(x, dim=dim, keepdim=True).detach()
    return (m + torch.log(torch.sum(torch.exp(x - m), dim=dim,
                                    keepdim=True))).squeeze(dim)


def crf_nll(emissions, labels, mask, w):
    """Negative log-likelihood of the label paths: emissions [B, T, L],
    labels int [B, T] (clipped to [0, L-1], so padding may hold
    anything), mask [B, T] (at least one valid step per row), w
    [L+2, L] -> [B] in the emissions' dtype."""
    num_labels = emissions.shape[-1]
    start, stop, trans = _split_weights(w)
    maskf = mask.to(emissions.dtype)
    labels = torch.clamp(labels.long(), 0, num_labels - 1)

    # the path score
    emit = torch.gather(emissions, -1, labels[..., None])[..., 0]
    emit_total = torch.sum(emit * maskf, dim=1)
    start_total = start[labels[:, 0]]
    trans_total = torch.sum(trans[labels[:, :-1], labels[:, 1:]]
                            * maskf[:, 1:], dim=1)
    lengths = (mask > 0).sum(dim=1)
    last = torch.gather(labels, 1,
                        torch.clamp(lengths - 1, min=0)[:, None])[:, 0]
    path_score = emit_total + start_total + trans_total + stop[last]

    # the partition function (forward algorithm)
    alpha = start[None, :] + emissions[:, 0, :]
    for t in range(1, emissions.shape[1]):
        scores = alpha[:, :, None] + trans[None, :, :]
        new_alpha = _logsumexp(scores, 1) + emissions[:, t, :]
        alpha = torch.where(mask[:, t, None] > 0, new_alpha, alpha)
    log_z = _logsumexp(alpha + stop[None, :], 1)
    return log_z - path_score


def crf_decode(emissions, mask, w):
    """Viterbi decode: (best paths int32 [B, T], zero past each row's
    length; best scores [B])."""
    batch, steps, num_labels = emissions.shape
    start, stop, trans = _split_weights(w)
    identity = torch.arange(num_labels, device=emissions.device)[None, :] \
        .expand(batch, num_labels)
    delta = start[None, :] + emissions[:, 0, :]
    backpointers = []
    for t in range(1, steps):
        scores = delta[:, :, None] + trans[None, :, :]  # [B, from, to]
        best_prev = torch.argmax(scores, dim=1)
        new_delta = torch.amax(scores, dim=1) + emissions[:, t, :]
        valid = mask[:, t, None] > 0
        delta = torch.where(valid, new_delta, delta)
        # an identity backpointer on padded steps
        backpointers.append(torch.where(valid, best_prev, identity))
    final = delta + stop[None, :]
    cur = torch.argmax(final, dim=1)
    best_score = torch.amax(final, dim=1)
    path = [cur]
    for bp in reversed(backpointers):
        cur = torch.gather(bp, 1, cur[:, None])[:, 0]
        path.append(cur)
    paths = torch.stack(path[::-1], dim=1)
    return (paths * (mask > 0)).to(torch.int32), best_score
