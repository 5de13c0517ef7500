"""DeviceFeeder: pipelined batch assembly and prefetch to the card
(paddle_tpu/data/feeder.py).

The trainer's synchronous feed (``topology.convert_feed`` on the step
thread) builds every slot from pageable numpy and copies it to the card
in the step's own stream. The feeder moves that work off the step
thread:

* a background **producer** thread runs the reader and converts each
  minibatch on the host (``convert_feed`` onto the CPU, honoring a
  BucketBatch's exact pad target), copies every tensor into **pinned**
  memory and starts its copy to the card with ``non_blocking=True`` on a
  copy stream of its own, then records an event there;
* a bounded queue keeps up to ``depth`` batches ahead of the step;
* the consumer (``batches()``) makes the step's stream wait on a batch's
  event before it hands the batch out, and marks each device tensor as
  used by that stream (``record_stream``), so the allocator never gives
  its memory back to the copy stream while a step still reads it. The
  pinned host tensors stay referenced by the :class:`FeedBatch` (and the
  pinned-memory allocator itself holds a block until the copies that
  read it are done), so a host buffer is never reused under its copy.
  The time the step thread blocks on the queue is the **feed stall**.

On the CPU (``device="cpu"``) the producer converts and nothing is
copied. ``convert=`` replaces the conversion (e.g. ``bucketing.pack_feed``;
the JAX package's signature ``convert(topology, data_batch, feeding,
max_len)``, called on the host). With a ``parallelism``
(parallel/mesh.py ``DataParallel``) the producer converts the global batch
and keeps this rank's share of its rows, which alone is pinned and copied:
each FeedBatch's feed is then a :class:`ReplicaFeeds`, the share of each
of the rank's local replicas (one for a rank that drives one device),
each copied to its replica's device on a copy stream of that device, and
its ``share`` one ``(rows, global rows)`` a replica; a fused chunk never
mixes shares, so every rank groups the same chunks. Shutdown and cancellation work both ways, as in the JAX package:
a consumer that stops early (break, exception, garbage collection of the
generator) cancels the producer, which exits promptly even while it is
blocked on a full queue; an error of the producer (the reader or the
conversion raising) is re-raised on the consumer thread.

``FeedBatch`` carries ``convert_ms``, ``stall_ms`` and the bucket waste
(``bucket``, ``fill_tokens``, ``pad_tokens``). The consumer's wait is the
``feed`` span (observe/spans.py), and each batch lands in the metrics
registry under the JAX feeder's series: the
``paddle_tpu_data_feed_stall_ms`` and ``paddle_tpu_data_feed_convert_ms``
histograms, the ``paddle_tpu_data_batches_total`` counter, the
``paddle_tpu_data_queue_depth`` gauge and, for sequence feeds, the
cumulative per-bucket fill and waste ratios. The trainer writes each
batch's ``feed`` steplog record from these attributes.

``lock`` is held by the producer around its CUDA calls (pinning, the
copy, the event); the trainer holds it while it captures a CUDA graph,
so no feeder work runs on the card's API during a capture.
"""

import inspect
import queue
import threading
import time

import torch

from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.observe import metrics as observe_metrics
from paddle_tpu_torch.observe import spans as observe_spans
from paddle_tpu_torch.core.sequence import (NestedSequenceBatch,
                                            PackedSequenceBatch,
                                            SequenceBatch)
from paddle_tpu_torch.core.sparse import SparseRows
from paddle_tpu_torch.reader.decorator import _cancellable_put, _drain
from paddle_tpu_torch.utils.logger import logger


class _End:
    pass


class _Error:
    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class ReplicaFeeds(tuple):
    """The feeds of one step's local replicas (parallel/mesh.py
    ``DataParallel.shard_batch``): replica i's share of the batch, a feed
    dict, at position i."""

    def __repr__(self):
        return "ReplicaFeeds%s" % (tuple.__repr__(self),)


def map_feed(feed, fn):
    """``feed`` with ``fn`` applied to every tensor of every slot (plain
    tensors, SequenceBatch data and lengths, SparseRows ids and values),
    of every replica's feed of a :class:`ReplicaFeeds`."""
    if isinstance(feed, ReplicaFeeds):
        return ReplicaFeeds(map_feed(part, fn) for part in feed)
    out = {}
    for name, value in feed.items():
        if isinstance(value, SequenceBatch):
            out[name] = SequenceBatch(fn(value.data), fn(value.lengths))
        elif isinstance(value, SparseRows):
            out[name] = SparseRows(fn(value.ids), None if value.vals is None
                                   else fn(value.vals), value.dim)
        else:
            out[name] = fn(value)
    return out


def slot_to(value, device):
    """One feed slot with every tensor on ``device``: a tensor, a
    SequenceBatch (packed ones with their segments), a
    NestedSequenceBatch or SparseRows."""
    if isinstance(value, PackedSequenceBatch):
        return PackedSequenceBatch(value.data.to(device),
                                   value.lengths.to(device),
                                   value.segments.to(device))
    if isinstance(value, NestedSequenceBatch):
        return NestedSequenceBatch(value.data.to(device),
                                   value.outer_lengths.to(device),
                                   value.inner_lengths.to(device))
    return map_feed({"v": value}, lambda t: t.to(device))["v"]


def feed_tensors(feed):
    """Every tensor of a feed, in slot order."""
    seen = []
    map_feed(feed, lambda t: seen.append(t) or t)
    return seen


def feed_shape_key(feed):
    """Hashable (slot names and kinds, tensor shapes and dtypes) key:
    batches may only share a fused chunk (and its captured graph) when
    their feeds have the same shapes."""
    if isinstance(feed, ReplicaFeeds):
        return tuple(feed_shape_key(part) for part in feed)
    parts = []
    for name in sorted(feed):
        value = feed[name]
        kind = type(value).__name__
        dims = tuple((tuple(t.shape), str(t.dtype))
                     for t in feed_tensors({name: value}))
        extra = value.dim if isinstance(value, SparseRows) else None
        parts.append((name, kind, extra, dims))
    return tuple(parts)


class FeedBatch:
    """One pipelined batch: the ``feed`` dict on the device plus its
    accounting — ``examples`` (rows), ``convert_ms`` (host assembly,
    pinning and the copy's enqueue on the producer thread), ``stall_ms``
    (time the consumer blocked waiting for it), and for sequence feeds
    ``bucket`` (padded length), ``fill_tokens``/``pad_tokens``. ``host``
    is the pinned host copy the device tensors were copied from, ``event``
    the copy stream's event (None on the CPU), ``share`` this rank's
    ``((rows, global rows), ...)``, one a local replica, under data
    parallelism (else None)."""

    __slots__ = ("feed", "examples", "convert_ms", "stall_ms", "bucket",
                 "fill_tokens", "pad_tokens", "host", "event", "share")

    def __init__(self, feed, examples, convert_ms, bucket=None,
                 fill_tokens=None, pad_tokens=None, host=None, event=None,
                 share=None):
        self.feed = feed
        self.examples = examples
        self.convert_ms = convert_ms
        self.stall_ms = None  # set by the consumer
        self.bucket = bucket
        self.fill_tokens = fill_tokens
        self.pad_tokens = pad_tokens
        self.host = host
        self.event = event
        self.share = share  # ((rows, global rows), ...) a local replica


class ChunkBatch:
    """K consecutive pipelined batches grouped for one fused dispatch
    (``trainer.SGD.train steps_per_call=``). ``feed`` is, for ``steps >
    1``, a length-K TUPLE of the member feeds (``stacked=True``); a
    single-batch chunk keeps its member's feed as it is (``stacked=
    False``), and the trainer runs it through the per-step program.
    ``batches`` keeps the member :class:`FeedBatch` records;
    ``examples``/``stall_ms``/``convert_ms`` are the chunk totals."""

    __slots__ = ("feed", "steps", "batches", "examples", "stall_ms",
                 "convert_ms", "stacked", "key")

    def __init__(self, feed, batches, stacked, key=None):
        self.feed = feed
        self.batches = list(batches)
        self.steps = len(self.batches)
        self.stacked = stacked
        self.key = key
        self.examples = sum(fb.examples for fb in self.batches)
        self.stall_ms = sum(fb.stall_ms or 0.0 for fb in self.batches)
        self.convert_ms = sum(fb.convert_ms or 0.0 for fb in self.batches)


def _seq_stats(feed):
    """(padded_len, fill_tokens, pad_tokens) over the sequence slots of a
    host feed (None when the feed has no sequence slots)."""
    bucket = fill = slots = 0
    parts = feed if isinstance(feed, ReplicaFeeds) else (feed,)
    for value in (v for part in parts for v in part.values()):
        if isinstance(value, SequenceBatch):
            lens = value.lengths.numpy()
            bucket = max(bucket, int(value.max_len))
            fill += int(lens.sum())
            slots += int(lens.shape[0]) * int(value.max_len)
    if slots == 0:
        return None, None, None
    return bucket, fill, slots - fill


class DeviceFeeder:
    """Background-thread feed pipeline over a minibatch reader.

    ``DeviceFeeder(reader, topology, device=...).batches()`` yields
    FeedBatch items on ``device`` (the card unless ``device="cpu"``); each
    call to ``batches()`` starts a fresh producer thread (one per training
    pass). ``parallelism`` and ``convert`` are the JAX package's
    (module docstring)."""

    def __init__(self, reader, topology, feeding=None, depth=2,
                 parallelism=None, convert=None, device=None,
                 metrics_registry=None):
        if depth < 1:
            raise ValueError("DeviceFeeder depth must be >= 1")
        self.reader = reader
        self.topology = topology
        self.feeding = feeding
        self.depth = int(depth)
        self.parallelism = parallelism
        self._convert = convert
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._copy_streams = {}  # device -> its copy stream
        self.lock = threading.Lock()
        m = metrics_registry or observe_metrics.get_registry()
        self.metrics = m
        self._m_stall = m.histogram(
            "paddle_tpu_data_feed_stall_ms",
            help="time the step thread blocked waiting for a pipelined "
                 "batch")
        self._m_convert = m.histogram(
            "paddle_tpu_data_feed_convert_ms",
            help="producer-thread batch conversion + device dispatch time")
        self._m_batches = m.counter(
            "paddle_tpu_data_batches_total",
            help="batches assembled by the feed pipeline")
        self._m_depth = m.gauge(
            "paddle_tpu_data_queue_depth",
            help="device-resident batches waiting ahead of the step")
        self._per_bucket = {}

    # -- producer side ------------------------------------------------------
    def _host_feed(self, data_batch):
        """The batch converted on the host: ``convert`` or convert_feed."""
        from paddle_tpu_torch.topology import convert_feed

        # a BucketBatch (or any minibatch with a ``bucket``) pads its
        # sequences to exactly that length, as the per-step feed does
        max_len = getattr(data_batch, "bucket", None)
        if self._convert is None:
            return convert_feed(self.topology, data_batch, self.feeding,
                                max_len=max_len, device="cpu")
        params = inspect.signature(self._convert).parameters
        kw = ({"device": "cpu"} if "device" in params or any(
            p.kind is p.VAR_KEYWORD for p in params.values()) else {})
        feed = self._convert(self.topology, data_batch, self.feeding,
                             max_len, **kw)
        # a custom convert may place its feed elsewhere
        return {name: slot_to(v, "cpu") for name, v in feed.items()}

    def _convert_batch(self, data_batch):
        """-> (host feed, device feed, copy event, share); under data
        parallelism the feeds are ReplicaFeeds and the events one per
        replica."""
        host = self._host_feed(data_batch)
        share = None
        if self.parallelism is not None:
            host, share = self.parallelism.shard_batch(host)
        if not self._cuda:
            return host, host, None, share
        if share is None:
            return self._copy(host, self.device) + (share,)
        pinned, feeds, events = zip(*(
            self._copy(part, self.parallelism.device_of(i, self.device))
            for i, part in enumerate(host)))
        return ReplicaFeeds(pinned), ReplicaFeeds(feeds), events, share

    def _copy(self, host, device):
        """-> (pinned host feed, its copy on ``device``, the copy's
        event); the copy runs on ``device``'s copy stream."""
        with self.lock:
            stream = self._copy_streams.get(device)
            if stream is None:
                stream = self._copy_streams[device] = torch.cuda.Stream(
                    device)
            pinned = map_feed(host, lambda t: t.pin_memory())
            with torch.cuda.stream(stream):
                feed = map_feed(pinned, lambda t: t.to(device,
                                                       non_blocking=True))
                event = torch.cuda.Event()
                event.record(stream)
        return pinned, feed, event

    def _produce(self, q, cancel, skip=0):
        def put(item):
            return _cancellable_put(q, item, cancel)

        try:
            for data_batch in self.reader():
                if skip > 0:
                    # the resume cursor (trainer train(resume=)): the
                    # already-trained prefix is consumed from the reader
                    # but never converted or copied
                    if cancel.is_set():
                        return
                    skip -= 1
                    continue
                t0 = time.perf_counter()
                host, feed, event, share = self._convert_batch(data_batch)
                convert_ms = (time.perf_counter() - t0) * 1e3
                bucket, fill, pad = _seq_stats(host)
                fb = FeedBatch(feed, len(data_batch), convert_ms,
                               bucket=bucket, fill_tokens=fill,
                               pad_tokens=pad,
                               host=host if self._cuda else None,
                               event=event, share=share)
                if not put(fb):
                    return
                if cancel.is_set():
                    return
        except BaseException as exc:  # re-raised on the consumer thread
            put(_Error(exc))
            return
        put(_End)

    # -- consumer side ------------------------------------------------------
    def _land(self, fb):
        """Make the current stream wait for the batch's copy, and keep its
        device memory from the copy stream until that stream is done with
        it."""
        if fb.event is None:
            return
        for part, event in (((fb.feed, fb.event),) if fb.share is None
                            else zip(fb.feed, fb.event)):
            tensors = feed_tensors(part)
            stream = torch.cuda.current_stream(
                tensors[0].device if tensors else self.device)
            stream.wait_event(event)
            for t in tensors:
                t.record_stream(stream)

    def batches(self, skip=0):
        """Generator of FeedBatch items; owns the producer thread for its
        lifetime (closing the generator cancels and joins it). ``skip=N``
        drops the reader's first N batches unconverted — the resume cursor
        of a checkpointed run."""
        q = queue.Queue(maxsize=self.depth)
        cancel = threading.Event()
        thread = threading.Thread(
            target=self._produce, args=(q, cancel, int(skip)),
            name="data-feeder-producer", daemon=True)
        thread.start()
        try:
            while True:
                with observe_spans.span("feed",
                                        args={"pipelined": True}) as scope:
                    item = q.get()
                if item is _End:
                    return
                if isinstance(item, _Error):
                    raise item.exc
                item.stall_ms = scope.dur * 1e3
                self._m_stall.observe(item.stall_ms)
                self._m_convert.observe(item.convert_ms)
                self._m_batches.inc()
                self._m_depth.set(q.qsize())
                if item.bucket:
                    self._bucket_gauges(item)
                self._land(item)
                yield item
        finally:
            cancel.set()
            # wake a producer blocked on a full queue, then let it finish
            _drain(q)
            thread.join(timeout=5.0)

    def _bucket_gauges(self, fb):
        """Cumulative per-bucket fill/waste (the JAX feeder's
        ``paddle_tpu_data_*_ratio{bucket=}`` series)."""
        pb = self._per_bucket.setdefault(fb.bucket, [0, 0])
        pb[0] += fb.fill_tokens
        pb[1] += fb.pad_tokens
        fill, pad = pb
        slots = fill + pad
        label = {"bucket": str(fb.bucket)}
        self.metrics.gauge("paddle_tpu_data_bucket_fill_ratio",
                           help="sequence tokens / padded slots "
                                "(cumulative, per padded length)",
                           labels=label).set(fill / slots)
        self.metrics.gauge("paddle_tpu_data_padding_waste_ratio",
                           help="padding slots / padded slots "
                                "(cumulative, per padded length)",
                           labels=label).set(pad / slots)

    def chunks(self, k, skip=0):
        """Generator of :class:`ChunkBatch` groups of up to ``k``
        consecutive batches of one feed shape (the fused loop's feed).
        ``skip`` passes through to :meth:`batches`. A queue shallower than
        ``k`` is deepened to ``k`` up front, loudly; a shape boundary
        (bucket change, partial final batch) closes the open chunk early,
        and a warning says so when shape churn keeps chunks from
        fusing."""
        k = int(k)
        if k < 1:
            raise ValueError("chunk size must be >= 1, got %d" % k)
        if k > self.depth:
            logger.info(
                "DeviceFeeder queue depth %d is shallower than the fused "
                "chunk size %d: deepening to %d so a chunk never starves "
                "the dispatch", self.depth, k, k)
            self.depth = k
        group, key = [], None
        sizes, split = [], 0

        def close(group, was_split=False):
            nonlocal split
            split += bool(was_split)
            sizes.append(len(group))
            if k > 1 and len(sizes) == 8 and split >= 6:
                logger.warning(
                    "fused chunks are splitting on shape boundaries "
                    "(%d of the first %d chunks, avg %.1f of %d steps): "
                    "consecutive batches rarely share a feed shape — pass "
                    "buckets= (trainer.SGD.train) so same-length batches "
                    "group and chunks actually fuse",
                    split, len(sizes), sum(sizes) / len(sizes), k)
            return self._stack_chunk(group, key)

        for fb in self.batches(skip=skip):
            fb_key = (feed_shape_key(fb.feed), fb.share)
            if group and fb_key != key:
                yield close(group, was_split=True)
                group = []
            key = fb_key
            group.append(fb)
            if len(group) == k:
                yield close(group)
                group = []
        if group:
            yield close(group)

    @staticmethod
    def _stack_chunk(group, key):
        """Group K feeds into one ChunkBatch; a single-batch chunk passes
        its member feed through, so the trainer runs it through the
        per-step program."""
        if len(group) == 1:
            return ChunkBatch(group[0].feed, group, stacked=False, key=key)
        return ChunkBatch(tuple(fb.feed for fb in group), group,
                          stacked=True, key=key)


__all__ = ["ChunkBatch", "DeviceFeeder", "FeedBatch", "ReplicaFeeds",
           "feed_shape_key", "feed_tensors", "map_feed", "slot_to"]
