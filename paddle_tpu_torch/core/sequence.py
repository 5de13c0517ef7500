"""Variable-length sequence batches in the padded-with-lengths form.

``SequenceBatch``: data [B, T, ...] + lengths [B]; the [B, T] validity mask
is derived on demand. Same contract as paddle_tpu/core/sequence.py,
host converters included (``from_sequences``, ``from_flat``, ``to_flat``,
``to_sequences``). ``PackedSequenceBatch`` adds the per-position segment
ids of packed rows; ``NestedSequenceBatch`` is data [B, S, T, ...] with
outer lengths [B] and inner lengths [B, S].
"""

import numpy as np
import torch

from paddle_tpu_torch.utils.error import enforce


def bucket_length(n, buckets=(16, 32, 64, 128, 256, 512, 1024, 2048, 4096)):
    """Round a max-length up to a bucket so few distinct shapes occur."""
    for b in buckets:
        if n <= b:
            return b
    return int(n)


class SequenceBatch:
    """A batch of variable-length sequences: padded data + per-sequence lengths."""

    def __init__(self, data, lengths):
        self.data = data
        self.lengths = lengths

    @property
    def batch_size(self):
        return self.data.shape[0]

    @property
    def max_len(self):
        return self.data.shape[1]

    def mask(self, dtype=None):
        """[B, T] validity mask (bool, or ``dtype``)."""
        t = torch.arange(self.max_len, device=self.lengths.device)[None, :]
        m = t < self.lengths[:, None]
        return m if dtype is None else m.to(dtype)

    def segment_ids(self):
        """Flat [B*T] int32 segment ids: row b's valid steps get b, padding
        -1 (the padded form of sequenceStartPositions)."""
        ids = torch.arange(self.batch_size, dtype=torch.int32,
                           device=self.lengths.device)[:, None].expand(
                               self.batch_size, self.max_len)
        return torch.where(self.mask(), ids,
                           torch.full_like(ids, -1)).reshape(-1)

    @staticmethod
    def from_sequences(seqs, max_len=None, dtype=None, pad_value=0, *,
                       device=None):
        """Build from a list of per-sequence numpy arrays (ragged), padded
        with ``pad_value`` to ``max_len`` (default: the length bucket of
        the longest), in ``dtype`` (default: the first sequence's), on
        ``device`` (default: the CPU)."""
        enforce(len(seqs) > 0, "empty sequence batch")
        seqs = [np.asarray(s) for s in seqs]
        lengths = np.array([len(s) for s in seqs], dtype=np.int32)
        tmax = max_len or bucket_length(int(lengths.max()))
        data = np.full((len(seqs), tmax) + seqs[0].shape[1:], pad_value,
                       dtype=dtype or seqs[0].dtype)
        for i, s in enumerate(seqs):
            enforce(len(s) <= tmax, "sequence %d longer than max_len %d", i,
                    tmax)
            data[i, : len(s)] = s
        return SequenceBatch(torch.as_tensor(data, device=device),
                             torch.as_tensor(lengths, device=device))

    @staticmethod
    def from_flat(flat, start_positions, max_len=None, *, device=None):
        """From the reference layout: contiguous [sum(T_i), ...] rows plus
        start positions [N+1] (cf. Argument.sequenceStartPositions)."""
        flat = np.asarray(flat)
        pos = np.asarray(start_positions, dtype=np.int64)
        seqs = [flat[pos[i]: pos[i + 1]] for i in range(len(pos) - 1)]
        return SequenceBatch.from_sequences(seqs, max_len=max_len,
                                            device=device)

    def to_flat(self):
        """Back to (flat rows, start positions) as host numpy arrays."""
        seqs = self.to_sequences()
        pos = np.zeros(len(seqs) + 1, dtype=np.int64)
        np.cumsum([len(s) for s in seqs], out=pos[1:])
        return np.concatenate(seqs, axis=0), pos

    def to_sequences(self):
        """The valid steps of each row, as host numpy arrays."""
        data = self.data.detach().cpu().numpy()
        lengths = self.lengths.cpu().numpy()
        return [data[i, : lengths[i]] for i in range(len(lengths))]

    def map_data(self, fn):
        return SequenceBatch(fn(self.data), self.lengths)

    def masked_data(self, pad_value=0.0):
        """The data with every padding step set to ``pad_value``."""
        m = self.mask()
        m = m.reshape(m.shape + (1,) * (self.data.dim() - 2))
        return torch.where(m, self.data,
                           torch.as_tensor(pad_value, dtype=self.data.dtype,
                                           device=self.data.device))

    def last_step(self):
        """The last valid step of each sequence [B, ...] (step 0 for a
        sequence of length 0; cf. SequenceLastInstanceLayer). A gather,
        whose backward is a scatter-add: an indexed read's backward
        would read its index count back to the host."""
        idx = torch.clamp(self.lengths.long() - 1, min=0)
        idx = idx.reshape((-1, 1) + (1,) * (self.data.dim() - 2)).expand(
            (-1, 1) + tuple(self.data.shape[2:]))
        return torch.gather(self.data, 1, idx).squeeze(1)

    def first_step(self):
        return self.data[:, 0]

    def reverse(self):
        """Each sequence reversed within its valid region, the padding
        left where it is (paddle_tpu/core/sequence.py:126-133; for
        bidirectional RNNs): position t < length takes length - 1 - t."""
        t = torch.arange(self.max_len, device=self.lengths.device)[None, :]
        lens = self.lengths.long()[:, None]
        idx = torch.where(t < lens, lens - 1 - t, t)
        idx = idx.reshape(idx.shape + (1,) * (self.data.dim() - 2))
        return SequenceBatch(
            torch.gather(self.data, 1, idx.expand(self.data.shape)),
            self.lengths)

    def __repr__(self):
        return "SequenceBatch(data=%s%s, lengths=%s)" % (
            self.data.dtype, tuple(self.data.shape),
            tuple(self.lengths.shape))


class PackedSequenceBatch(SequenceBatch):
    """A SequenceBatch whose rows each hold SEVERAL concatenated source
    sequences (sequence packing; paddle_tpu/core/sequence.py
    PackedSequenceBatch): ``data`` [B, T, ...], ``lengths`` [B] (the
    total valid length of each packed row) and ``segments`` [B, T], the
    ordinal of the source sequence at each position within its row (0, 1,
    2, ...; -1 in padding).

    The recurrent scans reset their carry at every segment start
    (``reset_mask``; ops/rnn.py ``reset_bt``), so a packed row computes
    what its sequences compute unpacked; built by
    ``paddle_tpu_torch.data.bucketing.pack_feed``."""

    def __init__(self, data, lengths, segments):
        super().__init__(data, lengths)
        self.segments = segments

    def map_data(self, fn):
        return PackedSequenceBatch(fn(self.data), self.lengths,
                                   self.segments)

    def reset_mask(self, dtype=None):
        """[B, T] mask, true at every packed-segment start (where a
        recurrent carry resets to its initial state)."""
        seg = self.segments
        prev = torch.cat([torch.full_like(seg[:, :1], -2), seg[:, :-1]],
                         dim=1)
        m = (seg >= 0) & (seg != prev)
        return m if dtype is None else m.to(dtype)

    def segment_count(self):
        """The number of real (unpacked) sequences in the batch."""
        return torch.sum(torch.amax(self.segments, dim=1) + 1)

    def reverse(self):
        """Each PACKED SEGMENT reversed in place (not the whole row), for
        reverse-direction recurrent layers; the segment spans, and so
        ``segments`` and the reset mask, are unchanged."""
        b, t_max = self.segments.shape
        seg = self.segments.long()
        t = torch.arange(t_max, device=seg.device).expand(b, t_max)
        # padding gets its own segment id t_max, apart from every real
        # segment ordinal (< t_max)
        sid = torch.where(seg >= 0, seg, torch.full_like(seg, t_max))
        first = torch.full((b, t_max + 1), t_max, dtype=torch.long,
                           device=seg.device).scatter_reduce(
                               1, sid, t, "amin")
        last = torch.full((b, t_max + 1), -1, dtype=torch.long,
                          device=seg.device).scatter_reduce(
                              1, sid, t, "amax")
        idx = torch.where(seg >= 0, torch.gather(first, 1, sid)
                          + torch.gather(last, 1, sid) - t, t)
        idx = idx.reshape(idx.shape + (1,) * (self.data.dim() - 2))
        return PackedSequenceBatch(
            torch.gather(self.data, 1, idx.expand(self.data.shape)),
            self.lengths, self.segments)

    def __repr__(self):
        return "PackedSequenceBatch(data=%s%s, lengths=%s, segments=%s)" % (
            self.data.dtype, tuple(self.data.shape),
            tuple(self.lengths.shape), tuple(self.segments.shape))


class NestedSequenceBatch:
    """Two-level nested sequences: data [B, S, T, ...], outer lengths [B]
    (sub-sequences per row) and inner lengths [B, S] (steps per
    sub-sequence); paddle_tpu/core/sequence.py NestedSequenceBatch, the
    reference's subSequenceStartPositions (paragraphs of sentences of
    tokens)."""

    def __init__(self, data, outer_lengths, inner_lengths):
        self.data = data
        self.outer_lengths = outer_lengths
        self.inner_lengths = inner_lengths

    @property
    def batch_size(self):
        return self.data.shape[0]

    @property
    def max_subseqs(self):
        return self.data.shape[1]

    @property
    def max_len(self):
        return self.data.shape[2]

    def outer_mask(self, dtype=None):
        """[B, S] mask of the real sub-sequences."""
        s = torch.arange(self.max_subseqs,
                         device=self.outer_lengths.device)[None, :]
        m = s < self.outer_lengths[:, None]
        return m if dtype is None else m.to(dtype)

    def inner_mask(self, dtype=None):
        """[B, S, T] mask of the real steps of the real sub-sequences."""
        t = torch.arange(self.max_len,
                         device=self.inner_lengths.device)[None, None, :]
        m = (t < self.inner_lengths[:, :, None]) & self.outer_mask()[:, :,
                                                                     None]
        return m if dtype is None else m.to(dtype)

    @staticmethod
    def from_nested(nested, max_subseqs=None, max_len=None, dtype=None,
                    pad_value=0, *, device=None):
        """From a list (batch) of lists (sub-sequences) of arrays (steps),
        padded to ``max_subseqs`` sub-sequences (default: the most in a
        row) of ``max_len`` steps (default: the length bucket of the
        longest), on ``device`` (default: the CPU)."""
        enforce(len(nested) > 0, "empty nested batch")
        outer = np.array([len(subs) for subs in nested], dtype=np.int32)
        smax = max_subseqs or int(outer.max())
        tmax = max_len or bucket_length(max(len(s) for subs in nested
                                            for s in subs))
        first = np.asarray(nested[0][0])
        data = np.full((len(nested), smax, tmax) + first.shape[1:],
                       pad_value, dtype=dtype or first.dtype)
        inner = np.zeros((len(nested), smax), dtype=np.int32)
        for i, subs in enumerate(nested):
            for j, s in enumerate(subs):
                s = np.asarray(s)
                data[i, j, : len(s)] = s
                inner[i, j] = len(s)
        return NestedSequenceBatch(torch.as_tensor(data, device=device),
                                   torch.as_tensor(outer, device=device),
                                   torch.as_tensor(inner, device=device))

    def flatten_to_subsequences(self):
        """A SequenceBatch over every sub-sequence slot [B*S, T, ...]; a
        slot past its row's outer length has length 0."""
        b, s = self.batch_size, self.max_subseqs
        data = self.data.reshape((b * s,) + tuple(self.data.shape[2:]))
        lengths = torch.where(self.outer_mask().reshape(-1),
                              self.inner_lengths.reshape(-1),
                              torch.zeros_like(self.inner_lengths
                                               .reshape(-1)))
        return SequenceBatch(data, lengths)

    def outer_sequence_of(self, per_subseq):
        """Per-sub-sequence features [B*S, ...] wrapped back into the outer
        SequenceBatch [B, S, ...]."""
        data = per_subseq.reshape((self.batch_size, self.max_subseqs)
                                  + tuple(per_subseq.shape[1:]))
        return SequenceBatch(data, self.outer_lengths)

    def map_data(self, fn):
        return NestedSequenceBatch(fn(self.data), self.outer_lengths,
                                   self.inner_lengths)

    def __repr__(self):
        return "NestedSequenceBatch(data=%s, outer=%s, inner=%s)" % (
            tuple(self.data.shape), tuple(self.outer_lengths.shape),
            tuple(self.inner_lengths.shape))
