"""Reader transformers (paddle_tpu/reader/decorator.py; reference
python/paddle/v2/reader/decorator.py: map_readers :26, shuffle :64, chain
:90, compose :130, buffered :180, firstn :205; plus mix_readers, cache and
the xmap_readers thread pool). A reader is a zero-argument callable
returning an iterable of samples; these are host code, the same on every
device.

``_cancellable_put`` and ``_drain`` are the cancellation handshake of a
producer thread and its consumer: ``buffered``, ``xmap_readers`` and
``data.feeder.DeviceFeeder`` all use them, so the poll interval and the
shutdown order are the same everywhere. A consumer that stops early, or a
reader or mapper that raises, lets every thread exit (the error is raised
in the consumer).
"""

import itertools
import queue
import random as _random
import threading


def map_readers(func, *readers):
    """Element-wise map over zipped readers."""

    def reader():
        iters = [r() for r in readers]
        for items in zip(*iters):
            yield func(*items)

    return reader


def shuffle(reader, buf_size, seed=None):
    """Pool-based shuffle (same windowed semantics as the reference)."""

    def shuffled():
        rng = _random.Random(seed)
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                for s in buf:
                    yield s
                buf = []
        if buf:
            rng.shuffle(buf)
            for s in buf:
                yield s

    return shuffled


def chain(*readers):
    """Concatenate readers."""

    def reader():
        for r in readers:
            for sample in r():
                yield sample

    return reader


def compose(*readers, check_alignment=True):
    """Zip readers into combined tuples."""

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    _end = object()

    def reader():
        iters = [r() for r in readers]
        if check_alignment:
            # sentinel-based zip: any reader ending while another still has
            # items is a mismatch, even off-by-one (plain zip would consume
            # and drop the extra sample before noticing)
            while True:
                items = [next(it, _end) for it in iters]
                ended = [i is _end for i in items]
                if all(ended):
                    return
                if any(ended):
                    raise ValueError("readers of compose have different lengths")
                yield sum((make_tuple(i) for i in items), ())
        else:
            for items in itertools.zip_longest(*iters, fillvalue=_end):
                yield sum((make_tuple(i) for i in items if i is not _end), ())

    return reader


class _End:
    pass


def _cancellable_put(q, item, cancel, poll=0.1):
    """Bounded-queue put that gives up when ``cancel`` is set — the
    producer-side half of the abandoned-consumer fix: a worker blocked
    on a full queue must wake up and exit when nobody will ever drain
    it. Returns False when cancelled."""
    while not cancel.is_set():
        try:
            q.put(item, timeout=poll)
            return True
        except queue.Full:
            continue
    return False


def _drain(q):
    """Free producer slots so a blocked put wakes within one poll."""
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


def buffered(reader, size):
    """Background-thread prefetch buffer (reference: buffered :180 — the
    data-provider pool-thread overlap).

    The fill thread exits promptly even when the CONSUMER abandons the
    iterator early (break / exception / GC): closing the generator sets
    a cancel event and drains the queue, so a put blocked on a full
    queue wakes and the thread returns instead of leaking
    (tests/test_torch_data.py leak cases)."""

    def buffered_reader():
        q = queue.Queue(maxsize=size)
        cancel = threading.Event()
        err = []

        def fill():
            try:
                for sample in reader():
                    if not _cancellable_put(q, sample, cancel):
                        return
            except BaseException as e:  # surfaced in consumer
                err.append(e)
            finally:
                _cancellable_put(q, _End, cancel)

        t = threading.Thread(target=fill, daemon=True,
                             name="reader-buffered-fill")
        t.start()
        try:
            while True:
                sample = q.get()
                if sample is _End:
                    if err:
                        raise err[0]
                    return
                yield sample
        finally:
            cancel.set()
            _drain(q)

    return buffered_reader


def mix_readers(readers, ratios=None, seed=None):
    """Interleave several readers with given sampling ratios (reference:
    MultiDataProvider, gserver/dataproviders/MultiDataProvider.cpp — mixes
    sub-providers proportionally to their configured ratios). Draws from
    each reader with probability ratio_i / sum(ratios); a reader that runs
    dry is dropped and the remaining ratios renormalize. Ends when all
    readers are exhausted."""
    ratios = list(ratios) if ratios is not None else [1.0] * len(readers)
    if len(ratios) != len(readers):
        raise ValueError("need one ratio per reader")

    def reader():
        rng = _random.Random(seed)
        live = [[it, r] for it, r in zip([r() for r in readers], ratios)]
        while live:
            total = sum(r for _, r in live)
            pick = rng.uniform(0.0, total)
            acc = 0.0
            for entry in live:
                acc += entry[1]
                if pick <= acc:
                    break
            try:
                yield next(entry[0])
            except StopIteration:
                live.remove(entry)

    return reader


def firstn(reader, n):
    def firstn_reader():
        for i, sample in enumerate(reader()):
            if i >= n:
                return
            yield sample

    return firstn_reader


def cache(reader):
    """Materialize once, replay thereafter (reference: per-pass RAM cache,
    PyDataProvider2 CacheType.CACHE_PASS_IN_MEM)."""
    state = {"data": None}

    def cached_reader():
        if state["data"] is None:
            # fill into a local list and publish only on a *completed* pass,
            # so an abandoned first iteration can't duplicate samples
            fill = []
            for sample in reader():
                fill.append(sample)
                yield sample
            state["data"] = fill
        else:
            for sample in state["data"]:
                yield sample

    return cached_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map with worker threads (reference: xmap_readers).

    Feed and worker threads exit promptly when the consumer abandons the
    iterator early OR a mapper raises (the error is re-raised in the
    consumer): every blocking queue operation is cancellable, and
    closing the generator cancels + drains both queues — no thread
    leaks through either path (tests/test_torch_data.py leak cases).
    """

    def xreader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)
        cancel = threading.Event()
        err = []

        def _get(q):
            while not cancel.is_set():
                try:
                    return q.get(timeout=0.1)
                except queue.Empty:
                    continue
            return _End

        def feed():
            try:
                for i, sample in enumerate(reader()):
                    if not _cancellable_put(in_q, (i, sample), cancel):
                        return
            except BaseException as e:  # source reader raised: surface it
                err.append(e)
            # ALWAYS deliver the worker sentinels — a feed thread dying
            # without them would leave workers polling and the consumer
            # blocked forever
            for _ in range(process_num):
                if not _cancellable_put(in_q, _End, cancel):
                    return

        def work():
            while True:
                item = _get(in_q)
                if item is _End:
                    _cancellable_put(out_q, _End, cancel)
                    return
                i, sample = item
                try:
                    mapped = mapper(sample)
                except BaseException as e:
                    err.append(e)
                    _cancellable_put(out_q, _End, cancel)
                    return
                if not _cancellable_put(out_q, (i, mapped), cancel):
                    return

        threading.Thread(target=feed, daemon=True,
                         name="reader-xmap-feed").start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True,
                             name="reader-xmap-work").start()
        try:
            finished = 0
            pending = {}
            next_idx = 0
            while finished < process_num:
                item = out_q.get()
                if item is _End:
                    finished += 1
                    if err:
                        raise err[0]
                    continue
                if not order:
                    yield item[1]
                else:
                    pending[item[0]] = item[1]
                    while next_idx in pending:
                        yield pending.pop(next_idx)
                        next_idx += 1
            while order and next_idx in pending:
                yield pending.pop(next_idx)
                next_idx += 1
        finally:
            cancel.set()
            _drain(in_q)
            _drain(out_q)

    return xreader
