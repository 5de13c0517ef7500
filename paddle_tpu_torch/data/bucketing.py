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
* **Sequence packing** (:func:`pack_samples` / :func:`pack_feed` /
  :func:`packed_batches`): concatenate several short sequences into one
  padded row with segment ids (core/sequence.py PackedSequenceBatch).
  The recurrent layers reset their carry at segment starts and
  per-position costs mask on the packed lengths, so costs and gradients
  match the unpacked batch; layers that mix across positions refuse
  packed input.

Module-level imports are stdlib + numpy only, as in the JAX package:
the serving bundle imports the bucket-choice helpers (torch is imported
in the packing feed builder).
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


# -- sequence packing -------------------------------------------------------

def pack_samples(samples, max_len, length_of=None):
    """Greedy first-fit packing of samples into rows of total length
    <= ``max_len``: a list of rows, each a list of samples, in arrival
    order within and across rows. A sample longer than ``max_len`` gets a
    row of its own (it pads, never truncates)."""
    length_of = length_of or default_length_of
    rows = []     # [used_len, [samples]]
    for sample in samples:
        n = length_of(sample)
        for row in rows:
            if row[0] + n <= max_len:
                row[0] += n
                row[1].append(sample)
                break
        else:
            rows.append([n, [sample]])
    return [row[1] for row in rows]


def pack_feed(topology, packed_rows, feeding=None, max_len=None, *,
              device=None):
    """Packed rows (lists of sample tuples, :func:`pack_samples`) as a feed
    dict of PackedSequenceBatch values on ``device`` (the default device
    when None).

    Every data layer must be a single-level dense or index sequence slot:
    packing has no meaning for per-sample slots. ``max_len`` pads every
    row to one width (default: the length bucket of the longest packed
    row); a row longer than ``max_len`` (an overlong sample's own row)
    widens the whole batch to the bucket of its length: pad, never
    truncate."""
    import torch

    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.core.sequence import (PackedSequenceBatch,
                                                bucket_length)
    from paddle_tpu_torch.data_type import DENSE, INDEX, SEQ_SINGLE

    if not packed_rows:
        raise ValueError("pack_feed needs at least one packed row")
    device = resolve_device(device)
    if feeding is None:
        feeding = {name: i for i, (name, _) in
                   enumerate(topology.data_types())}
    row_lens = [sum(default_length_of(s) for s in row)
                for row in packed_rows]
    tmax = int(max_len) if max_len else bucket_length(max(row_lens))
    if max(row_lens) > tmax:
        tmax = bucket_length(max(row_lens))
    feed = {}
    for name, itype in topology.data_types():
        if itype.seq_type != SEQ_SINGLE or itype.value_type not in (
                DENSE, INDEX):
            raise TypeError(
                "pack_feed supports single-level dense/index sequence "
                "slots only; data layer %r has type %r" % (name, itype))
        np_dtype = np.float32 if itype.value_type == DENSE else np.int32
        idx = feeding[name]
        feat = np.asarray(packed_rows[0][0][idx], dtype=np_dtype).shape[1:]
        data = np.zeros((len(packed_rows), tmax) + feat, np_dtype)
        segments = np.full((len(packed_rows), tmax), -1, np.int32)
        lengths = np.zeros((len(packed_rows),), np.int32)
        for r, row in enumerate(packed_rows):
            at = 0
            for s, sample in enumerate(row):
                part = np.asarray(sample[idx], dtype=np_dtype)
                data[r, at:at + len(part)] = part
                segments[r, at:at + len(part)] = s
                at += len(part)
            lengths[r] = at
        feed[name] = PackedSequenceBatch(
            torch.as_tensor(data, device=device),
            torch.as_tensor(lengths, device=device),
            torch.as_tensor(segments, device=device))
    return feed


def packed_batches(reader, batch_size, max_len, length_of=None,
                   max_open_rows=64):
    """Group a SAMPLE reader into batches of packed rows: each item is a
    list of ``batch_size`` rows, each row a list of samples whose total
    length fits ``max_len`` (feed with :func:`pack_feed`); the last
    partial batch is yielded as it is.

    The first-fit open set holds at most ``max_open_rows`` rows: on
    overflow the fullest open row retires, so per-sample scans and
    buffered memory stay O(max_open_rows) on an endless stream. A sample
    of ``max_len`` or more retires at once, in a row of its own."""
    length_of = length_of or default_length_of

    def batch_reader():
        open_rows = []  # [used, [samples]]
        done_rows = []

        def pop_batch():
            batch = done_rows[:batch_size]
            del done_rows[:batch_size]
            return batch

        for sample in reader():
            n = length_of(sample)
            for row in open_rows:
                if row[0] + n <= max_len:
                    row[0] += n
                    row[1].append(sample)
                    if row[0] >= max_len:
                        open_rows.remove(row)
                        done_rows.append(row[1])
                    break
            else:
                if n >= max_len:
                    done_rows.append([sample])
                else:
                    open_rows.append([n, [sample]])
                    if len(open_rows) > max_open_rows:
                        fullest = max(open_rows, key=lambda r: r[0])
                        open_rows.remove(fullest)
                        done_rows.append(fullest[1])
            if len(done_rows) >= batch_size:
                yield pop_batch()
        done_rows.extend(row[1] for row in open_rows)
        while done_rows:
            yield pop_batch()

    return batch_reader
