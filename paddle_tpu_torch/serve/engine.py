"""Dynamic-batching inference engine over a loaded bundle
(paddle_tpu/serve/engine.py).

Callers ``submit()`` row-batches and get a Future; one worker thread
drains the queue into device batches under a two-sided flush policy:

* **flush on size**: a batch launches as soon as ``max_batch_size`` rows
  are queued;
* **flush on deadline**: a smaller batch launches once the OLDEST queued
  request has waited ``max_latency_ms``.

Each flushed batch pads up to the nearest bucket (replicated rows, sliced
off after the forward). Metrics, tracing, the health/SLO machinery and
live knobs of the JAX engine come with a later part of the port.
"""

import collections
import threading
import time
from concurrent.futures import Future

import numpy as np

from paddle_tpu_torch.serve.bundle import flat_keys, pad_rows
from paddle_tpu_torch.utils.logger import logger


class Overloaded(RuntimeError):
    """Admission control rejected a request before it entered a queue
    (paddle_tpu/serve/engine.py): the fast 429 path of serve/server.py.
    Raised by the continuous scheduler's queue bound (``max_queue``)."""

    def __init__(self, message, model=None, priority=None, reason=None,
                 queued=None):
        super().__init__(message)
        self.model = model
        self.priority = priority
        self.reason = reason or "queue_full"
        self.queued = queued


class _Request:
    __slots__ = ("inputs", "rows", "future", "t_enqueue")

    def __init__(self, inputs, rows):
        self.inputs = inputs
        self.rows = rows
        self.future = Future()
        self.t_enqueue = time.perf_counter()


class InferenceEngine:
    """Thread-safe dynamic-batching front end of a :class:`Bundle`.

    ``submit(inputs)`` takes a dict of flat feed arrays (leading row
    dimension; ``bundle.dummy_inputs()`` shows the keys) and returns a
    Future of ``{output_name: np.ndarray}`` with the same row count.
    ``warmup``: True warms every bucket before returning, "async" warms on
    a background thread (``ready()`` turns true when done), False skips it.
    Call ``stop()``: pending requests are drained first.
    """

    def __init__(self, bundle, max_batch_size=None, max_latency_ms=5.0,
                 warmup=True):
        self.bundle = bundle
        self.max_batch_size = int(max_batch_size or bundle.max_batch())
        if self.max_batch_size > bundle.max_batch():
            raise ValueError(
                "max_batch_size %d exceeds the largest bucket %d"
                % (self.max_batch_size, bundle.max_batch()))
        self.max_latency_ms = float(max_latency_ms)
        self._expected_keys = set()
        for spec in bundle.inputs:
            self._expected_keys.update(flat_keys(spec))
        self._cv = threading.Condition()
        self._queue = collections.deque()
        self._queued_rows = 0
        self._in_flight = 0  # accepted requests not yet resolved
        self._stopped = False
        self._stats = collections.Counter()
        self._ready = threading.Event()
        self._warmer = None
        if warmup == "async":
            self._warmer = threading.Thread(target=self._warmup_quietly,
                                            name="serve-warmup", daemon=True)
            self._warmer.start()
        elif warmup:
            self._warmup()
        else:
            self._ready.set()
        self._worker = threading.Thread(target=self._loop,
                                        name="serve-batcher", daemon=True)
        self._worker.start()

    def _warmup(self):
        try:
            buckets = self.bundle.warmup()
        except Exception:
            # a failed warmup must leave the engine NOT ready: readiness
            # exists to keep traffic away from a model that cannot run
            logger.exception("bucket warmup failed; engine stays not-ready")
            raise
        with self._cv:
            self._stats["warmup_batches"] += buckets
        self._ready.set()

    def _warmup_quietly(self):
        try:
            self._warmup()
        except Exception:  # noqa: BLE001 — logged in _warmup; stays not-ready
            pass

    def ready(self):
        """True once bucket warmup has completed (the readiness probe)."""
        return self._ready.is_set()

    def live(self):
        with self._cv:
            stopped = self._stopped
        return self._worker.is_alive() and not stopped

    # -- client surface -----------------------------------------------------
    def submit(self, inputs):
        """Enqueue one request (arrays with a leading row dim); returns a
        Future of {output_name: array[rows, ...]}."""
        inputs = {k: np.asarray(v) for k, v in inputs.items()}
        if set(inputs) != self._expected_keys:
            raise KeyError(
                "request inputs %s do not match the bundle's feed keys %s"
                % (sorted(inputs), sorted(self._expected_keys)))
        rows = {int(v.shape[0]) for v in inputs.values()}
        if len(rows) != 1:
            raise ValueError("inconsistent row counts across inputs: %s"
                             % sorted(rows))
        rows = rows.pop()
        if not 1 <= rows <= self.max_batch_size:
            raise ValueError("request rows %d outside [1, max_batch_size=%d]"
                             % (rows, self.max_batch_size))
        self.bundle.validate_inputs(inputs)
        req = _Request(inputs, rows)
        with self._cv:
            if self._stopped:
                raise RuntimeError("engine is stopped")
            self._queue.append(req)
            self._queued_rows += rows
            self._in_flight += 1
            self._cv.notify_all()
        return req.future

    def infer(self, inputs, timeout=60.0):
        return self.submit(inputs).result(timeout=timeout)

    def stats(self):
        """Engine counters plus live load state, snapshotted under the lock:
        batches, requests, rows, pad_rows, flush_on_{size,deadline,drain},
        batches_failed, warmup_batches, queue_depth, in_flight."""
        with self._cv:
            out = dict(self._stats)
            for key in ("batches", "requests", "rows", "pad_rows",
                        "flush_on_size", "flush_on_deadline",
                        "flush_on_drain", "batches_failed",
                        "warmup_batches"):
                out.setdefault(key, 0)
            out["queue_depth"] = self._queued_rows
            out["in_flight"] = self._in_flight
            out["max_batch_size"] = self.max_batch_size
            out["max_latency_ms"] = self.max_latency_ms
        out["ready"] = self.ready()
        return out

    def stop(self, timeout=30.0):
        """Drain the queue and stop the worker (and an async warmup).
        Idempotent."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._worker.join(timeout=timeout)
        if self._warmer is not None:
            self._warmer.join(timeout=timeout)

    # -- worker -------------------------------------------------------------
    def _take_batch(self):
        """Block until the flush policy fires; pop whole requests up to
        max_batch_size rows. Returns (requests, rows, reason) or None at
        shutdown with an empty queue."""
        with self._cv:
            while not self._queue and not self._stopped:
                self._cv.wait()
            if not self._queue:
                return None  # stopped and drained
            deadline = self._queue[0].t_enqueue + self.max_latency_ms / 1e3
            while (self._queued_rows < self.max_batch_size
                   and not self._stopped):
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            reason = ("size" if self._queued_rows >= self.max_batch_size
                      else ("drain" if self._stopped else "deadline"))
            batch = [self._queue.popleft()]
            rows = batch[0].rows
            while self._queue and (rows + self._queue[0].rows
                                   <= self.max_batch_size):
                req = self._queue.popleft()
                batch.append(req)
                rows += req.rows
            self._queued_rows -= rows
            return batch, rows, reason

    def _loop(self):
        while True:
            taken = self._take_batch()
            if taken is None:
                return
            requests, rows, reason = taken
            try:
                self._run_batch(requests, rows, reason)
            except Exception as exc:  # noqa: BLE001 — fail the batch, not the engine
                logger.exception("batch of %d rows failed", rows)
                for req in requests:
                    if not req.future.done():
                        req.future.set_exception(exc)
                with self._cv:
                    self._stats["batches_failed"] += 1
                    self._in_flight -= len(requests)

    def _run_batch(self, requests, rows, reason):
        bucket = self.bundle.bucket_for(rows)["batch"]
        flat = {}
        for key in self._expected_keys:
            cat = (requests[0].inputs[key] if len(requests) == 1
                   else np.concatenate([r.inputs[key] for r in requests],
                                       axis=0))
            flat[key] = pad_rows(cat, bucket)
        out = self.bundle.run(flat, bucket)
        # counters first, futures after: a caller that wakes from infer()
        # sees its batch in stats()
        with self._cv:
            self._stats["batches"] += 1
            self._stats["requests"] += len(requests)
            self._stats["rows"] += rows
            self._stats["pad_rows"] += bucket - rows
            self._stats["flush_on_" + reason] += 1
            self._in_flight -= len(requests)
        offset = 0
        for req in requests:
            req.future.set_result({k: v[offset:offset + req.rows]
                                   for k, v in out.items()})
            offset += req.rows
