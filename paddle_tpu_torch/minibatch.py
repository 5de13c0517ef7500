"""Minibatch assembly (parity: python/paddle/v2/minibatch.py;
paddle_tpu/minibatch.py)."""


def batch(reader, batch_size, drop_last=True):
    """Group a sample reader into a minibatch reader. ``drop_last=True``
    keeps every batch the same size, as the JAX package does by default
    (the reference kept partial batches)."""

    def batch_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader
