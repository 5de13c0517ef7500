"""Dynamic-batching inference engine over a loaded bundle
(paddle_tpu/serve/engine.py).

Clipper-style adaptive batching (Crankshaw et al., NSDI 2017 §4.3) in
front of the bundle's shape-bucketed programs: callers ``submit()``
row-batches and get a Future; a single worker thread drains the queue
into device batches under a two-sided flush policy —

* **flush on size**: a batch launches as soon as ``max_batch_size`` rows
  are queued;
* **flush on deadline**: a smaller batch launches once the OLDEST queued
  request has waited ``max_latency_ms`` (per-request latency is bounded
  by queue wait + one model forward, the TF-Serving batching contract).

Each flushed batch pads up to the nearest exported bucket (replicated
rows, sliced off after the forward) and runs the bucket's exported
program, deserialized at engine start (the warmup) so no request pays the
load. The forward's time (``infer_ms``, the ``serve_batch`` span and
the dispatch phase of a trace) ends at the bundle's readback of the
outputs to the host, which waits for the card: it is never the host's
enqueue time alone. On the card the bundle also times the program with
CUDA events (``Bundle.last_device_ms``, summed in ``stats()["device_ms"]``).

Observability: every batch runs inside a ``serve_batch`` span
(paddle_tpu_torch.observe) and — when telemetry is active or an explicit
StepLog is passed — emits ``serve_batch``/``serve_request`` steplog
records (schema v1, tests/golden/steplog_schema.json). Every hot-path
event also updates the process-wide metrics registry
(paddle_tpu_torch.observe.metrics, ``paddle_tpu_serve_*`` series): request/
row/batch/pad counters, flush-reason counters, queue-depth and
in-flight gauges, per-bucket batch-fill and padding-waste ratios, and
end-to-end latency histograms — scraped via ``GET /metrics`` on the
HTTP front end (docs/observability.md).
"""

import collections
import threading
import time
from concurrent.futures import Future

import numpy as np

from paddle_tpu_torch.observe import health as observe_health
from paddle_tpu_torch.observe import metrics as observe_metrics
from paddle_tpu_torch.observe import spans as observe_spans
from paddle_tpu_torch.observe import steplog as observe_steplog
from paddle_tpu_torch.observe import tracing as observe_tracing
from paddle_tpu_torch.serve.bundle import flat_keys, pad_rows
from paddle_tpu_torch.utils.logger import logger


class Overloaded(RuntimeError):
    """Admission control rejected a request BEFORE it entered a queue —
    the fast 429 path (serve/server.py): under overload a bounded queue
    plus immediate rejection keeps the latency of *accepted* requests
    honest, where an unbounded queue would melt every p99 instead.
    Raised by the engine/scheduler queue bounds and by the router's
    priority-class shed policy (serve/router.py)."""

    def __init__(self, message, model=None, priority=None, reason=None,
                 queued=None):
        super().__init__(message)
        self.model = model
        self.priority = priority
        self.reason = reason or "queue_full"
        self.queued = queued


class _Request:
    __slots__ = ("inputs", "rows", "future", "t_enqueue", "req_id",
                 "trace")

    def __init__(self, inputs, rows, req_id, trace=None):
        self.inputs = inputs
        self.rows = rows
        self.future = Future()
        self.t_enqueue = time.perf_counter()
        self.req_id = req_id
        # the request's TraceContext (None = unsampled): propagated BY
        # VALUE across the submit->worker thread hop — the worker emits
        # this request's phase spans and serve_trace record against it
        self.trace = trace


class InferenceEngine:
    """Thread-safe dynamic-batching front end of a :class:`Bundle`.

    ``submit(inputs)`` takes a dict of flat feed arrays (leading row
    dimension; ``bundle.dummy_inputs()`` shows the expected keys) and
    returns a ``concurrent.futures.Future`` resolving to
    ``{output_name: np.ndarray}`` with the same row count. ``infer()``
    is the blocking convenience. Use as a context manager or call
    ``stop()`` — pending requests are drained before shutdown.
    """

    def __init__(self, bundle, max_batch_size=None, max_latency_ms=5.0,
                 steplog=None, warmup=True, run_name="serve",
                 metrics_registry=None, model=None, max_queue_rows=None,
                 replica=None):
        self.bundle = bundle
        # multi-model serving (serve/router.py): ``model`` labels every
        # metric family of this engine with {model=...} so one registry
        # tells N hosted bundles apart; ``replica`` likewise adds a
        # {replica=...} label (and an additive ``replica`` field on
        # serve_batch steplog records) when this engine is one member of
        # a replica fleet (serve/fleet.py); ``max_queue_rows`` bounds
        # the queue — submit() raises Overloaded instead of letting the
        # backlog (and every accepted request's latency) grow unbounded
        self.model = model
        self.replica = None if replica is None else str(replica)
        self.max_queue_rows = (None if max_queue_rows is None
                               else int(max_queue_rows))
        self._labels = {"model": str(model)} if model else {}
        if self.replica is not None:
            self._labels["replica"] = self.replica
        self.max_batch_size = int(max_batch_size or bundle.max_batch())
        if self.max_batch_size > bundle.max_batch():
            raise ValueError(
                "max_batch_size %d exceeds the largest exported bucket %d"
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
        self._req_counter = 0
        self._batch_counter = 0
        self._stats = collections.Counter()
        self._per_bucket = {}  # bucket batch -> Counter(batches/rows/pad)
        self._owns_slog = steplog is None
        # serving records arrive at request rate: batch the flush
        # (crash loses <32 records, not the throughput — steplog.py)
        self._slog = (observe_steplog.from_env(run_name=run_name,
                                               meta={"phase": "serve"},
                                               flush_every=32)
                      if steplog is None else steplog)
        self.metrics = metrics_registry or observe_metrics.get_registry()
        self._build_metrics()
        # readiness (k8s-style): the engine is READY once every exported
        # bucket is warm — before that a request pays a program load and
        # the kernels' first build, which a load balancer must not route
        # traffic into. warmup=True warms
        # synchronously (ready on return), "async" warms on a background
        # thread (the HTTP front end can bind first and report
        # ready=false until the warmup completes), False skips warmup
        # (ready immediately — the operator opted into lazy loads).
        self._ready = threading.Event()
        self._warmer = None
        if warmup == "async":
            def _bg_warmup():
                try:
                    self._warmup()
                except Exception:  # noqa: BLE001 — logged in _warmup;
                    pass           # the engine simply stays not-ready

            self._warmer = threading.Thread(
                target=_bg_warmup, name=self._thread_name("serve-warmup"),
                daemon=True)
            self._warmer.start()
        elif warmup:
            self._warmup()
        else:
            self._ready.set()
            self._m_ready.set(1)
        self._worker = threading.Thread(
            target=self._loop, name=self._thread_name("serve-batcher"),
            daemon=True)
        self._worker.start()

    def _thread_name(self, base):
        """Thread names carry the replica index so a fleet's N workers
        are tellable apart in a stack dump."""
        return (base if self.replica is None
                else "%s-r%s" % (base, self.replica))

    def _warmup(self):
        try:
            with observe_spans.span("serve_warmup",
                                    args={"buckets":
                                          len(self.bundle.buckets)}):
                buckets = self.bundle.warmup()
        except Exception:
            # a failed warmup (corrupt artifact, a kernel that does not
            # build) must leave the probe NOT-ready: readiness exists to
            # keep traffic away from a model that cannot run. Sync callers
            # (warmup=True) see the raise; the async thread logs it and
            # the engine stays 503.
            logger.exception("bucket warmup failed; engine stays "
                             "not-ready")
            raise
        with self._cv:
            self._stats["warmup_batches"] += buckets
        self._ready.set()
        self._m_ready.set(1)

    def ready(self):
        """True once bucket warmup has completed (the readiness probe;
        liveness is the worker thread being alive)."""
        return self._ready.is_set()

    def live(self):
        with self._cv:
            stopped = self._stopped
        return self._worker.is_alive() and not stopped

    def _build_metrics(self):
        m, lab = self.metrics, self._labels
        observe_metrics.build_info(m)
        self._m_requests = m.counter(
            "paddle_tpu_serve_requests_total",
            help="requests completed by the serving engine", labels=lab)
        self._m_rows = m.counter(
            "paddle_tpu_serve_rows_total",
            help="real (unpadded) rows inferred", labels=lab)
        self._m_batches = m.counter(
            "paddle_tpu_serve_batches_total",
            help="batches flushed to the device", labels=lab)
        self._m_batches_failed = m.counter(
            "paddle_tpu_serve_batches_failed_total",
            help="batches whose forward raised", labels=lab)
        self._m_pad_rows = m.counter(
            "paddle_tpu_serve_pad_rows_total",
            help="padding rows added to reach a bucket size", labels=lab)
        self._m_flush = {
            reason: m.counter("paddle_tpu_serve_flush_total",
                              help="batch flushes by trigger",
                              labels=dict(lab, reason=reason))
            for reason in ("size", "deadline", "drain")}
        self._m_queue_depth = m.gauge(
            "paddle_tpu_serve_queue_depth",
            help="rows waiting for a batch flush", labels=lab)
        self._m_in_flight = m.gauge(
            "paddle_tpu_serve_in_flight",
            help="accepted requests not yet resolved", labels=lab)
        self._m_ready = m.gauge(
            "paddle_tpu_serve_ready",
            help="1 once every exported bucket is warm", labels=lab)
        self._m_shed = m.counter(
            "paddle_tpu_serve_shed_total",
            help="requests rejected by admission control",
            labels=dict(lab, reason="queue_full"))
        self._m_latency = m.histogram(
            "paddle_tpu_serve_request_latency_ms",
            help="end-to-end request latency (enqueue to result)",
            labels=lab)
        self._m_queue_ms = m.histogram(
            "paddle_tpu_serve_request_queue_ms",
            help="time a request waited for its batch flush", labels=lab)
        self._m_infer_ms = m.histogram(
            "paddle_tpu_serve_batch_infer_ms",
            help="device forward time per flushed batch", labels=lab)

    # -- client surface -----------------------------------------------------
    def submit(self, inputs, trace=None):
        """Enqueue one request (arrays with a leading row dim); returns a
        Future of {output_name: array[rows, ...]}. ``trace`` is an
        optional upstream :class:`~paddle_tpu_torch.observe.tracing
        .TraceContext` (the HTTP front end mints/adopts one per
        request); with none the engine itself rolls the
        ``PADDLE_TPU_TORCH_TRACE_SAMPLE`` dice, so direct submits trace
        too."""
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
            raise ValueError(
                "request rows %d outside [1, max_batch_size=%d]"
                % (rows, self.max_batch_size))
        self.bundle.validate_inputs(inputs)
        with self._cv:
            if self._stopped:
                raise RuntimeError("engine is stopped")
            if (self.max_queue_rows is not None
                    and self._queued_rows + rows > self.max_queue_rows):
                self._stats["shed"] += 1
                self._m_shed.inc()
                observe_health.get_history().record_shed("queue_full")
                raise Overloaded(
                    "queue full: %d rows queued + %d requested > "
                    "max_queue_rows=%d — shed, retry against a less "
                    "loaded replica" % (self._queued_rows, rows,
                                        self.max_queue_rows),
                    model=self.model, reason="queue_full",
                    queued=self._queued_rows)
            self._req_counter += 1
            # the dice rolls only for ADMITTED requests (after the
            # validation raises and the queue-full shed above), so the
            # sampled count can never exceed the requests that produce
            # a serve_trace record
            req = _Request(inputs, rows, self._req_counter,
                           trace=observe_tracing.resolve(trace))
            self._queue.append(req)
            self._queued_rows += rows
            self._in_flight += 1
            self._m_queue_depth.set(self._queued_rows)
            observe_health.get_history().record_queue_depth(
                self._queued_rows)
            self._m_in_flight.set(self._in_flight)
            self._cv.notify_all()
        return req.future

    def infer(self, inputs, timeout=60.0, trace=None):
        return self.submit(inputs, trace=trace).result(timeout=timeout)

    def queue_depth(self):
        """Rows currently waiting for a batch flush (the router's shed
        policy reads this across all hosted models)."""
        with self._cv:
            return self._queued_rows

    def stats(self):
        """Engine counters plus live load state, snapshotted atomically
        under the engine lock: ``queue_depth`` (rows waiting for a batch
        flush) and ``in_flight`` (accepted requests not yet resolved)
        distinguish a draining queue from a stuck one — the cumulative
        counters alone cannot."""
        with self._cv:
            out = dict(self._stats)
            for key in ("batches", "requests", "rows", "pad_rows",
                        "flush_on_size", "flush_on_deadline",
                        "flush_on_drain", "batches_failed",
                        "warmup_batches", "shed"):
                out.setdefault(key, 0)
            out.setdefault("device_ms", 0.0)
            if self.model:
                out["model"] = self.model
            if self.replica is not None:
                out["replica"] = self.replica
            out["queue_depth"] = self._queued_rows
            out["queued_rows"] = self._queued_rows  # back-compat alias
            out["in_flight"] = self._in_flight
            out["max_batch_size"] = self.max_batch_size
            out["max_latency_ms"] = self.max_latency_ms
        out["ready"] = self.ready()
        out["latency_ms"] = self._m_latency.percentiles()
        out["trace"] = observe_tracing.trace_state()
        return out

    def register_knobs(self, registry, prefix="engine"):
        """Adopt this engine's live-adjustable parameters into a
        :class:`~paddle_tpu_torch.control.knobs.KnobRegistry`. Each apply
        hook re-takes the engine cv — the same lock every hot-path reader
        of these fields already holds — and notifies it, so a deadline
        move wakes a worker currently sleeping on the OLD deadline.
        ``max_queue_rows`` registers only when a ceiling was configured:
        adopting an unbounded queue would let the controller silently
        impose one."""
        from paddle_tpu_torch.control.knobs import Knob

        with self._cv:
            deadline = self.max_latency_ms
            queue_rows = self.max_queue_rows

        def _set_deadline(v):
            with self._cv:
                self.max_latency_ms = float(v)
                self._cv.notify_all()

        registry.register(Knob(
            prefix + ".batch_deadline_ms", value=deadline,
            min=0.25, max=500.0, step=0.5, apply=_set_deadline))
        if queue_rows is not None:
            def _set_queue_rows(v):
                with self._cv:
                    self.max_queue_rows = int(v)
                    self._cv.notify_all()

            registry.register(Knob(
                prefix + ".max_queue_rows", value=queue_rows,
                min=self.max_batch_size, max=1 << 20,
                step=self.max_batch_size, integer=True,
                apply=_set_queue_rows))

    def stop(self, timeout=30.0):
        """Drain the queue, stop the worker, close an engine-owned
        steplog (a shared one is flushed — ``flush_every`` batching
        must not cost records on an engine stop). Idempotent."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._worker.join(timeout=timeout)
        if self._warmer is not None:
            self._warmer.join(timeout=timeout)
        if self._owns_slog and self._slog is not None:
            self._slog.close()
            self._slog = None
        elif self._slog is not None:
            self._slog.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

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
            self._m_queue_depth.set(self._queued_rows)
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
                    self._m_in_flight.set(self._in_flight)
                self._m_batches_failed.inc()

    def _run_batch(self, requests, rows, reason):
        t_start = time.perf_counter()
        queue_ms_max = (t_start - requests[0].t_enqueue) * 1e3
        bucket = self.bundle.bucket_for(rows)
        flat = {}
        for key in self._expected_keys:
            cat = (requests[0].inputs[key] if len(requests) == 1
                   else np.concatenate([r.inputs[key] for r in requests],
                                       axis=0))
            flat[key] = pad_rows(cat, bucket["batch"])
        # phase clock for the request-scoped trace (docs/observability
        # .md "Request tracing & tail attribution"): consecutive
        # perf_counter stamps so the per-request phases sum EXACTLY to
        # the enqueue->serialized wall time
        t_form = time.perf_counter()
        self._batch_counter += 1
        batch_id = self._batch_counter
        with observe_spans.span(
                "serve_batch",
                args={"rows": rows, "bucket": bucket["batch"],
                      "requests": len(requests)}) as scope:
            out = self.bundle.run(flat, bucket["batch"])
        infer_ms = scope.dur * 1e3
        device_ms = self.bundle.last_device_ms
        offset = 0
        t_done = time.perf_counter()
        dispatch_ms = (t_done - t_form) * 1e3
        form_ms = (t_form - t_start) * 1e3
        # slice + stamp first, then emit observability, then deliver:
        # the serialize phase ends at each request's slice (the
        # steplog/span/exemplar writes are the tracing machinery's own
        # cost and must not be billed to later batch-mates' serialize
        # phase), and futures resolve only after every record landed —
        # a client that wakes from infer() sees its telemetry written
        sliced = []
        for req in requests:
            result = {k: v[offset:offset + req.rows]
                      for k, v in out.items()}
            offset += req.rows
            sliced.append((req, result, time.perf_counter()))
        exemplars = observe_tracing.get_exemplars()
        for req, _result, t_ser in sliced:
            # fenced like the scheduler's retire loop: a raising sink
            # (steplog on a full disk) must lose telemetry, not turn a
            # computed batch into per-request failures
            try:
                queue_ms = (t_start - req.t_enqueue) * 1e3
                latency_ms = (t_done - req.t_enqueue) * 1e3
                if self._slog is not None:
                    self._slog.log_serve_request(
                        rows=req.rows, queue_ms=queue_ms,
                        latency_ms=latency_ms, req_id=req.req_id)
                self._m_queue_ms.observe(queue_ms)
                self._m_latency.observe(latency_ms)
                phases = {"queue_ms": queue_ms,
                          "batch_form_ms": form_ms,
                          "dispatch_ms": dispatch_ms,
                          "serialize_ms": (t_ser - t_done) * 1e3}
                trace_total_ms = (t_ser - req.t_enqueue) * 1e3
                exemplars.offer(trace_total_ms, phases,
                                model=self.model, replica=self.replica,
                                trace_id=(req.trace.trace_id
                                          if req.trace else None))
                observe_health.get_history().record_request(
                    latency_ms, phases)
                if req.trace is not None:
                    self._emit_trace(req, phases, trace_total_ms,
                                     t_start, t_form, t_done, t_ser)
            except Exception:  # noqa: BLE001 — lose telemetry, not results
                logger.exception("per-request telemetry emission "
                                 "failed; result still delivered")
        for req, result, _t_ser in sliced:
            req.future.set_result(result)
        if self._slog is not None:
            self._slog.log_serve_batch(
                rows=rows, bucket=bucket["batch"], infer_ms=infer_ms,
                batch_id=batch_id, pad_rows=bucket["batch"] - rows,
                requests=len(requests), queue_ms_max=queue_ms_max,
                flush=reason, replica=self.replica)
        pad = bucket["batch"] - rows
        with self._cv:
            self._stats["batches"] += 1
            self._stats["requests"] += len(requests)
            self._stats["rows"] += rows
            self._stats["pad_rows"] += pad
            self._stats["flush_on_" + reason] += 1
            if device_ms is not None:
                self._stats["device_ms"] += device_ms
            self._in_flight -= len(requests)
            self._m_in_flight.set(self._in_flight)
            pb = self._per_bucket.setdefault(
                bucket["batch"], collections.Counter())
            pb["batches"] += 1
            pb["rows"] += rows
            pb["pad"] += pad
            fill, waste = pb["rows"], pb["pad"]
        self._m_requests.inc(len(requests))
        self._m_rows.inc(rows)
        self._m_batches.inc()
        self._m_pad_rows.inc(pad)
        self._m_flush[reason].inc()
        self._m_infer_ms.observe(infer_ms)
        # cumulative per-bucket occupancy: fill + waste sum to 1.0 — the
        # capacity split between real rows and padding for this bucket
        slots = fill + waste
        blabel = dict(self._labels, bucket=str(bucket["batch"]))
        self.metrics.gauge("paddle_tpu_serve_batch_fill_ratio",
                           help="real rows / bucket slots (cumulative)",
                           labels=blabel).set(fill / slots)
        self.metrics.gauge("paddle_tpu_serve_padding_waste_ratio",
                           help="padding rows / bucket slots (cumulative)",
                           labels=blabel).set(waste / slots)

    def _emit_trace(self, req, phases, latency_ms, t_start, t_form,
                    t_done, t_ser):
        """Sampled-request trace emission: the request's phase spans are
        recorded retrospectively (one child context each, so the
        exporter flow-links them into the request's lane) plus the
        ``serve_trace`` steplog record the tail-attribution report
        aggregates."""
        ctx = req.trace
        tracer = observe_spans.get_tracer()
        args = {"id": req.req_id}
        tracer.add_event("serve_queue_wait", req.t_enqueue,
                         t_start - req.t_enqueue, args=args,
                         trace=ctx.child())
        tracer.add_event("serve_batch_form", t_start, t_form - t_start,
                         args=args, trace=ctx.child())
        tracer.add_event("serve_dispatch", t_form, t_done - t_form,
                         args=args, trace=ctx.child())
        tracer.add_event("serve_serialize", t_done, t_ser - t_done,
                         args=args, trace=ctx.child())
        if self._slog is not None:
            self._slog.log_serve_trace(
                latency_ms=latency_ms, phases=phases,
                trace_id=ctx.trace_id, span_id=ctx.span_id,
                model=self.model, replica=self.replica,
                req_id=req.req_id, rows=req.rows)
