"""Variable-length sequence batches in the padded-with-lengths form.

``SequenceBatch``: data [B, T, ...] + lengths [B]; the [B, T] validity mask
is derived on demand. Same contract as paddle_tpu/core/sequence.py,
host converters included (``from_sequences``, ``from_flat``, ``to_flat``,
``to_sequences``); packed and nested batches come with later parts of
the port.
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
        sequence of length 0; cf. SequenceLastInstanceLayer)."""
        idx = torch.clamp(self.lengths.long() - 1, min=0)
        return self.data[torch.arange(self.batch_size,
                                      device=self.data.device), idx]

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
