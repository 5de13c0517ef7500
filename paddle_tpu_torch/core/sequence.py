"""Variable-length sequence batches in the padded-with-lengths form.

``SequenceBatch``: data [B, T, ...] + lengths [B]; the [B, T] validity mask
is derived on demand. Same contract as paddle_tpu/core/sequence.py; packed
and nested batches come with later parts of the port.
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

    @staticmethod
    def from_sequences(seqs, device=None, max_len=None):
        """Build from a list of per-sequence numpy arrays (ragged), zero
        padded to ``max_len`` (default: the length bucket of the
        longest)."""
        enforce(len(seqs) > 0, "empty sequence batch")
        seqs = [np.asarray(s) for s in seqs]
        lengths = np.array([len(s) for s in seqs], dtype=np.int32)
        tmax = max_len or bucket_length(int(lengths.max()))
        data = np.zeros((len(seqs), tmax) + seqs[0].shape[1:],
                        dtype=seqs[0].dtype)
        for i, s in enumerate(seqs):
            enforce(len(s) <= tmax, "sequence %d longer than max_len %d", i,
                    tmax)
            data[i, : len(s)] = s
        return SequenceBatch(torch.as_tensor(data, device=device),
                             torch.as_tensor(lengths, device=device))

    def map_data(self, fn):
        return SequenceBatch(fn(self.data), self.lengths)

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
