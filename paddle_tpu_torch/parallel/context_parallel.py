"""Sequence/context parallelism: ring attention and Ulysses all-to-all
(paddle_tpu/parallel/context_parallel.py).

The sequence axis of attention is split over a mesh axis:

- ``ring_attention``: the K/V blocks travel round the axis ring (one
  neighbour step at a time, parallel/collectives.py :func:`shift`) while
  each rank streams them through an online-softmax accumulator; no rank
  materializes the [L, L] score matrix, and its memory for scores is
  O(L/N x L/N) a step.
- ``ulysses_attention``: two all-to-alls trade the sequence split for a
  head split, full attention runs on H/N heads over the whole sequence,
  and the result is traded back; needs heads % N == 0.

Both are differentiable: the backward of a ring step is the reverse step
and the backward of an all-to-all is the transposed all-to-all, so the
backward is also a ring / all-to-all program. The math is plain tensor
ops, as in the JAX package (no kernel there either).
"""

import torch

from paddle_tpu_torch.parallel.collectives import all_to_all, shift, split
from paddle_tpu_torch.parallel.mesh import Mesh, NamedSharding, P
from paddle_tpu_torch.utils.error import enforce

_NEG = -1e30  # finite mask value: keeps exp() and the gradients NaN-free


def full_attention(q, k, v, causal=False, scale=None, lengths=None):
    """Reference (unsharded) scaled-dot-product attention. q, k, v:
    [B, L, H, D]; returns [B, L, H, D]. ``lengths`` ([B] int) masks out
    padded key positions."""
    lq, d = q.shape[1], q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    neg = torch.tensor(_NEG, dtype=s.dtype, device=s.device)
    if causal:
        qp = torch.arange(lq, device=q.device)
        kp = torch.arange(k.shape[1], device=q.device)
        s = torch.where((qp[:, None] >= kp[None, :])[None, None], s, neg)
    if lengths is not None:
        kp = torch.arange(k.shape[1], device=q.device)
        kmask = kp[None, :] < torch.as_tensor(lengths,
                                              device=q.device)[:, None]
        s = torch.where(kmask[:, None, None, :], s, neg)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def ring_local(q, k, v, seq, causal=False, scale=None):
    """Ring attention on this rank's chunks [B, Lc, H, D] of the sequence
    split over the axis ``seq``: the K/V blocks make a full tour of the
    ring (one shift of the stacked pair a step), softmax accumulates
    online. The running maximum is a stabilizer the result does not
    depend on, so it carries no gradient."""
    b, lc, h, d = q.shape
    n, idx = seq.size, seq.index
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    q_pos = idx * lc + torch.arange(lc, device=q.device)
    neg = torch.tensor(_NEG, dtype=q.dtype, device=q.device)
    m = torch.full((b, h, lc), _NEG, dtype=q.dtype, device=q.device)
    l = torch.zeros((b, h, lc), dtype=q.dtype, device=q.device)
    o = torch.zeros((b, lc, h, d), dtype=q.dtype, device=q.device)
    kv = torch.stack([k, v])
    for step in range(n):
        src = (idx - step) % n                    # owner of the block
        s = torch.einsum("bqhd,bkhd->bhqk", q, kv[0]) * scale
        if causal:
            k_pos = src * lc + torch.arange(lc, device=q.device)
            s = torch.where((q_pos[:, None] >= k_pos[None, :])[None, None],
                            s, neg)
        m_new = torch.maximum(m, s.detach().amax(dim=-1))
        alpha = torch.exp(m - m_new)              # rescale the accumulators
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = (o * alpha.transpose(1, 2)[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", p, kv[1]))
        m = m_new
        if step < n - 1:
            kv = shift(kv, seq, 1)
    return o / l.clamp_min(1e-30).transpose(1, 2)[..., None]


def ulysses_local(q, k, v, seq, causal=False, scale=None):
    """Ulysses attention on this rank's chunks [B, Lc, H, D]: all-to-all
    to [B, L, H/N, D], full attention, all-to-all back."""
    def seq_to_heads(x):
        return all_to_all(x, seq, 2, 1)

    out = full_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                         causal=causal, scale=scale)
    return all_to_all(out, seq, 1, 2)


def _sharded(fn, q, k, v, mesh, seq_axis, causal, scale, batch_axis):
    seq = mesh.axis(seq_axis)
    dp = None if batch_axis is None else mesh.axis(batch_axis)
    blocks = [split(split(t, dp, 0), seq, 1) for t in (q, k, v)]
    return fn(*blocks, seq, causal=causal, scale=scale)


def ring_attention(q, k, v, mesh, seq_axis="seq", causal=False, scale=None,
                   batch_axis=None):
    """Ring attention over ``mesh``'s ``seq_axis``. Global q, k, v:
    [B, L, H, D]; L must divide over the axis. Returns this rank's block
    [B, L/N, H, D] of the global result (its rows too, with
    ``batch_axis``: the axis B is split over). The gradients of the
    global inputs are whole on every rank."""
    enforce(isinstance(mesh, Mesh), "ring_attention needs a Mesh")
    axis_size = mesh.shape[seq_axis]
    enforce(q.shape[1] % axis_size == 0,
            "seq axis size %d must divide seq len %d", axis_size, q.shape[1])
    return _sharded(ring_local, q, k, v, mesh, seq_axis, causal, scale,
                    batch_axis)


def ulysses_attention(q, k, v, mesh, seq_axis="seq", causal=False,
                      scale=None, batch_axis=None):
    """Ulysses (all-to-all) sequence parallelism over ``mesh``'s
    ``seq_axis``; the contract of :func:`ring_attention`, and the heads
    must divide over the axis too."""
    enforce(isinstance(mesh, Mesh), "ulysses_attention needs a Mesh")
    axis_size = mesh.shape[seq_axis]
    enforce(q.shape[1] % axis_size == 0,
            "seq axis size %d must divide seq len %d", axis_size, q.shape[1])
    enforce(q.shape[2] % axis_size == 0,
            "seq axis size %d must divide num heads %d", axis_size,
            q.shape[2])
    return _sharded(ulysses_local, q, k, v, mesh, seq_axis, causal, scale,
                    batch_axis)


class SequenceParallel:
    """Pick a strategy and a mesh once, call like a function.

    >>> sp = SequenceParallel(mesh, strategy="ring")
    >>> out = sp(q, k, v, causal=True)
    """

    def __init__(self, mesh, seq_axis="seq", strategy="ring",
                 batch_axis=None):
        enforce(strategy in ("ring", "ulysses"),
                "unknown sequence-parallel strategy %r", strategy)
        self.mesh = mesh
        self.seq_axis = seq_axis
        self.strategy = strategy
        self.batch_axis = batch_axis

    def __call__(self, q, k, v, causal=False, scale=None):
        fn = ring_attention if self.strategy == "ring" else ulysses_attention
        return fn(q, k, v, self.mesh, seq_axis=self.seq_axis, causal=causal,
                  scale=scale, batch_axis=self.batch_axis)

    def shard_sequence(self, x):
        """This rank's block of a [B, L, ...] tensor: L split over the
        sequence axis (and B over ``batch_axis`` when configured), the
        layout __call__ works in."""
        spec = P(*([self.batch_axis, self.seq_axis]
                   + [None] * (x.dim() - 2)))
        return NamedSharding(self.mesh, spec).shard(x)
