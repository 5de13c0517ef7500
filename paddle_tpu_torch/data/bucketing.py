"""Length-bucketed batching (paddle_tpu/data/bucketing.py).

* **Bucket choice** (:func:`bucket_for` / :func:`bucket_index`): ONE
  smallest-bucket-at-least rule shared by training-side bucketing and
  the serving bundle's batch buckets (``serve/bundle.py``).
* **Length bucketing** (:func:`rebucket_batches`): regroup a minibatch
  stream so each emitted batch holds sequences from ONE length bucket
  (boundaries explicit or derived from the observed lengths,
  :func:`derive_buckets`). Each batch carries its bucket boundary
  (``BucketBatch.bucket``), which the feed conversion uses as the exact
  pad target: one feed shape, and so one captured CUDA graph of the
  fused loop, per bucket.
* **Sequence packing** (``pack_samples``, ``pack_feed``,
  ``packed_batches``) needs ``PackedSequenceBatch`` and the recurrent
  scans' segment resets, which come with a later part of the port; the
  three raise until then.

Module-level imports are stdlib + numpy only, as in the JAX package:
the serving bundle imports the bucket-choice helpers.
"""

import numpy as np

# Waste/fill bookkeeping of one assembled batch (the per-bucket
# fill/waste gauges and the exp_data_pipeline A/B rows both read it):
# fill_tokens + pad_tokens == rows * padded_len for sequence slots.


def bucket_index(value, sizes):
    """Index of the smallest bucket >= ``value`` in ascending ``sizes``.

    THE bucket-choice rule (training and serving both call this one
    function). Raises ValueError when ``value`` exceeds the largest
    bucket — callers decide whether that means re-export (serving) or
    re-derive (training)."""
    for i, size in enumerate(sizes):
        if size >= value:
            return i
    raise ValueError(
        "value %d exceeds the largest bucket (%d); buckets=%s"
        % (value, sizes[-1] if len(sizes) else 0, list(sizes)))


def bucket_for(value, sizes):
    """The smallest bucket size >= ``value`` (see :func:`bucket_index`)."""
    return sizes[bucket_index(value, sizes)]


def derive_buckets(lengths, max_buckets=8, multiple=8):
    """Derive ascending bucket boundaries from observed lengths.

    Evenly spaced quantiles of the length distribution, each rounded UP
    to a ``multiple`` (aligned shapes), deduplicated, with the
    last bucket always covering ``max(lengths)``. At most
    ``max_buckets`` boundaries — the bound on feed shapes (and on
    captured graphs)."""
    lengths = np.asarray(list(lengths), dtype=np.int64)
    if lengths.size == 0:
        raise ValueError("derive_buckets needs at least one length")
    if max_buckets < 1:
        raise ValueError("max_buckets must be >= 1")

    def round_up(v):
        return int(-(-int(v) // multiple) * multiple) if multiple else int(v)

    qs = np.linspace(0.0, 100.0, max_buckets + 1)[1:]
    bounds = sorted({round_up(np.percentile(lengths, q)) for q in qs})
    top = round_up(lengths.max())
    if bounds[-1] < top:
        bounds[-1] = top
    return bounds


def topology_length_of(topology, feeding=None):
    """A ``length_of`` keyed to a topology's ACTUAL sequence slots: only
    single-level sequence columns count toward the bucket length, so a
    mixed schema (dense feature vectors + sequences) buckets on the
    sequence lengths instead of the fixed feature width. Falls back to
    :func:`default_length_of` when the topology has no sequence slots.
    The trainer's ``buckets=`` wiring uses this automatically."""
    from paddle_tpu_torch.data_type import SEQ_SINGLE

    names = [name for name, _ in topology.data_types()]
    if feeding is None:
        feeding = {name: i for i, name in enumerate(names)}
    seq_cols = [feeding[name] for name, itype in topology.data_types()
                if itype.seq_type == SEQ_SINGLE]
    if not seq_cols:
        return default_length_of

    def length_of(sample):
        best = 0
        for idx in seq_cols:
            col = sample[idx]
            best = max(best, len(col) if isinstance(col, (list, tuple))
                       else int(np.asarray(col).shape[0]))
        return best or 1

    return length_of


def default_length_of(sample):
    """Length of a sample tuple: the longest sequence-valued column
    (lists/arrays with a leading time dimension). Scalar-only samples
    have length 1.

    Caveat: with no topology in hand this cannot tell a fixed-width
    dense feature vector from a sequence — in mixed schemas the feature
    width would dominate the bucket key. Use :func:`topology_length_of`
    (the trainer's ``buckets=`` path does) or pass an explicit
    ``length_of`` for such schemas."""
    best = 0
    cols = sample if isinstance(sample, (tuple, list)) else (sample,)
    for col in cols:
        if isinstance(col, np.ndarray):
            if col.ndim >= 1:
                best = max(best, int(col.shape[0]))
        elif isinstance(col, (list, tuple)):
            best = max(best, len(col))
    return best or 1


class BucketBatch(list):
    """A minibatch (list of sample tuples) that knows the length bucket
    it was assembled for. ``convert_feed(..., max_len=batch.bucket)``
    pads its sequence slots to exactly the boundary — one feed shape per
    bucket."""

    def __init__(self, samples, bucket):
        super().__init__(samples)
        self.bucket = int(bucket)


def rebucket_batches(batch_reader, buckets=None, length_of=None,
                     batch_size=None, sample_window=1024,
                     drop_remainder=False):
    """Regroup a minibatch reader into length-bucketed minibatches.

    Consumes ``batch_reader`` (yields lists of sample tuples — the
    trainer's reader contract), flattens to a sample stream, and
    re-emits :class:`BucketBatch` minibatches where every sample falls
    in one bucket. Batch size is taken from the first incoming batch
    unless given. ``buckets=None`` buffers the first ``sample_window``
    samples and derives boundaries from their length distribution
    (:func:`derive_buckets`). Bucket accumulators flush when full; at
    end of stream, partial batches flush in bucket order unless
    ``drop_remainder``.

    Samples are re-ordered relative to the incoming stream (that is the
    point) but never dropped (except by ``drop_remainder``) and never
    duplicated."""
    length_of = length_of or default_length_of

    def reader():
        bounds = list(buckets) if buckets is not None else None
        size = batch_size
        pending = {}  # bucket -> list of samples
        backlog = []  # samples buffered while deriving boundaries

        def emit(bucket):
            batch = BucketBatch(pending.pop(bucket), bucket)
            return batch

        def place(sample):
            n = length_of(sample)
            try:
                b = bucket_for(n, bounds)
            except ValueError:
                # longer than every derived/explicit bucket: widen with a
                # GEOMETRIC top bucket (16, 32, 64, ...) instead of
                # dropping data — exact-length buckets would mint a fresh
                # feed shape per new record length; doubling bounds the
                # total bucket count logarithmically in the max length
                grown = 16
                while grown < n:
                    grown *= 2
                bounds.append(grown)
                b = grown
            pending.setdefault(b, []).append(sample)
            if len(pending[b]) >= size:
                return emit(b)
            return None

        for incoming in batch_reader():
            if size is None:
                size = len(incoming) or 1
            for sample in incoming:
                if bounds is None:
                    backlog.append(sample)
                    if len(backlog) >= sample_window:
                        bounds = derive_buckets(
                            [length_of(s) for s in backlog])
                        for s in backlog:
                            out = place(s)
                            if out is not None:
                                yield out
                        backlog = []
                    continue
                out = place(sample)
                if out is not None:
                    yield out
        if bounds is None and backlog:
            bounds = derive_buckets([length_of(s) for s in backlog])
            for s in backlog:
                out = place(s)
                if out is not None:
                    yield out
        if not drop_remainder:
            for b in sorted(pending):
                if pending[b]:
                    yield BucketBatch(pending[b], b)

    return reader


def batch_waste(samples, padded_len, length_of=None):
    """(fill_tokens, pad_tokens) of one batch padded to ``padded_len``."""
    length_of = length_of or default_length_of
    fill = sum(length_of(s) for s in samples)
    return fill, len(samples) * int(padded_len) - fill


# -- sequence packing (not ported yet) -----------------------------------

def _packing_not_ported(what):
    raise NotImplementedError(
        "%s (sequence packing) is not ported yet: it needs "
        "PackedSequenceBatch and gru_scan(reset_bt=)" % what)


def pack_samples(samples, max_len, length_of=None):
    _packing_not_ported("pack_samples")


def pack_feed(topology, packed_rows, feeding=None, max_len=None):
    _packing_not_ported("pack_feed")


def packed_batches(reader, batch_size, max_len, length_of=None,
                   max_open_rows=64):
    _packing_not_ported("packed_batches")
