"""Continuous-batching decode scheduler with the host-side session tier
(paddle_tpu/serve/scheduler.py).

The whole-request engine (serve/engine.py) pads every sequence to the
bundle's ``seq_len`` and runs every step of it. This scheduler runs the
bundle's decode step (``export_bundle(decode_slots=...)``) over a fixed
``[slots, window]`` matrix and admits and retires sequences between
dispatches:

* every iteration runs ``window`` timesteps for every occupied slot (idle
  slots ride the length mask, their carry untouched);
* a sequence that finishes frees its slot that iteration; the next queued
  request is admitted into it with ``reset=1``, which zeroes the slot's
  carry BEFORE the cells run, so a reused slot never sees the retired
  occupant's state;
* the slot capacity and the window are the only shapes: admission and
  retirement change tensor values, never shapes, so after the warmup no
  kernel library builds or loads and the recurrent kernel runs one layout.

**Sessions** (``submit(..., session_id=...)``): a session's recurrent
carry survives between requests. When a session's request retires, the
session parks in its slot until the slot is needed or the idle-spill
threshold passes; then the scheduler spills the carry to the host-side
:class:`~paddle_tpu_torch.serve.sessions.SessionStore`. The worker slices
the slot's rows (fresh device copies on the current stream), then enqueues
a non-blocking copy into pinned host memory on a side stream that first
waits on an event recorded after the slice, and records a second event;
the ``serve-session-spill`` writer thread waits on that event and files
the rows in the store, while the worker goes on to the next window. The
session's next request restores the carry into whatever slot is free
(``Bundle.carry_insert``, the reset=0 path). Store eviction is
priority-ordered LRU with SLO grace; an evicted session answers
:class:`~paddle_tpu_torch.serve.sessions.SessionGone` (410 Gone).

Observability: per-iteration ``serve_decode``, per-request
``serve_request`` and per-swap ``serve_swap`` step-log records, and the
``paddle_tpu_serve_*`` metric families with the JAX package's names and
labels. The one readback a window (the outputs to the host) happens inside
the ``serve_decode`` span.

Request tracing as in the engine: ``submit(trace=...)`` carries a
``TraceContext`` by value to the worker (and, for a session's spill, to
the writer thread); every retired request offers its phase breakdown
(``queue_ms``, ``spill_restore_ms``, ``decode_ms``, ``serialize_ms``) to
the exemplar reservoir and the health history, and a sampled one also
writes its ``serve_trace`` record. ``register_knobs`` adopts the live
knobs (``max_queue``, ``idle_spill_ms``, ``admit_budget``,
``park_budget``). ``replica=`` marks the scheduler as one member of a
replica fleet (serve/fleet.py, serve/workers.py): ``{replica=}`` on every
metric family and a ``replica`` field on its step-log records.
"""

import collections
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from paddle_tpu_torch.observe import health as observe_health
from paddle_tpu_torch.observe import metrics as observe_metrics
from paddle_tpu_torch.observe import spans as observe_spans
from paddle_tpu_torch.observe import steplog as observe_steplog
from paddle_tpu_torch.observe import tracing as observe_tracing
from paddle_tpu_torch.serve.bundle import SEQ_KINDS
from paddle_tpu_torch.serve.engine import Overloaded
from paddle_tpu_torch.serve.sessions import (SessionGone, SessionState,
                                             SessionStore, host_leaf)
from paddle_tpu_torch.utils.logger import logger


class _DecodeRequest:
    __slots__ = ("data", "length", "future", "t_enqueue", "t_admit",
                 "req_id", "collected", "session", "priority",
                 "end_session", "trace", "t_defer", "spill_wait_ms",
                 "restore_ms", "iters")

    def __init__(self, data, length, req_id, session=None,
                 priority=None, end_session=False, trace=None):
        self.data = data          # {input_name: [T, ...] array}
        self.length = length
        self.future = Future()
        self.t_enqueue = time.perf_counter()
        self.t_admit = None
        self.req_id = req_id
        self.collected = []       # [{out_name: [k, ...]}] per window
        self.session = None if session is None else str(session)
        self.priority = priority
        self.end_session = bool(end_session)
        # request tracing: the TraceContext crosses the submit->worker hop
        # on the request; the phase accumulators feed the serve_trace
        # breakdown and the exemplar reservoir
        self.trace = trace
        self.t_defer = None       # waiting on its session's spill
        self.spill_wait_ms = 0.0
        self.restore_ms = 0.0
        self.iters = 0            # decode window dispatches spanned


class _ResidentSession:
    """A session whose carry lives in the slot matrix (active while its
    request decodes, *parked* between requests)."""

    __slots__ = ("sid", "pos", "priority", "last_active", "trace")

    def __init__(self, sid, priority=None, pos=0):
        self.sid = sid
        self.pos = int(pos)
        self.priority = priority or "normal"
        self.last_active = time.monotonic()
        # the last request's TraceContext: a later spill of this session
        # records its writer-thread span in that request's lane
        self.trace = None


class _Slot:
    __slots__ = ("req", "pos", "session")

    def __init__(self):
        self.req = None
        self.pos = 0
        self.session = None  # _ResidentSession while resident


class _Plan:
    """One iteration's admission and paging decisions, taken under the
    scheduler lock; the device work (slice, insert, decode) runs after
    release, so submitters never block on a dispatch."""

    __slots__ = ("admitted", "restores", "spills", "failures")

    def __init__(self):
        self.admitted = []   # fresh slot indices (reset=1)
        self.restores = []   # (slot index, SessionState)
        self.spills = []     # (slot index, _ResidentSession)
        self.failures = []   # (request, exception), resolved outside cv


class ContinuousScheduler:
    """Iteration-level ("continuous") batching front end of a decode-capable
    :class:`~paddle_tpu_torch.serve.bundle.Bundle`, with host-side session
    paging.

    ``submit(inputs)`` takes ONE sequence per request, the engine's flat
    wire format with a single row (``{name: [1, T] ids, name + ":lens":
    [1]}``; the lens key may be omitted when the data array is exactly the
    sequence), and returns a Future of ``{output_name: np.ndarray[T,
    ...]}``, one output row per timestep. ``submit(inputs,
    session_id="u123")`` continues that session's carry (restoring it from
    the host store when it was paged out); ``end_session=True`` closes the
    session with the request. Duck-typed like
    :class:`~paddle_tpu_torch.serve.engine.InferenceEngine`
    (submit/infer/stats/ready/live/queue_depth/stop), so the HTTP front end
    hosts either.

    Session knobs: ``session_capacity`` bounds the host store,
    ``idle_spill_ms`` spills a parked session after that much idle time
    (None: spill only under slot pressure), ``session_slo_grace_ms`` and
    ``session_ttl_ms`` shape eviction (serve/sessions.py), and
    ``paging=False`` pins a live session's slot for life (the hard-cap
    baseline).
    """

    # serve/server.py routes session requests only to engines that say so
    supports_sessions = True

    def __init__(self, bundle, slots=None, steplog=None, warmup=True,
                 run_name="serve", metrics_registry=None, model=None,
                 max_queue=256, replica=None, session_capacity=4096,
                 idle_spill_ms=None, session_slo_grace_ms=None,
                 session_ttl_ms=None, paging=True, session_store=None):
        if not bundle.has_decoder():
            raise ValueError(
                "bundle %r has no decode artifacts; re-export with "
                "decode_slots= for continuous batching" % bundle.name)
        self.bundle = bundle
        self.slots = int(bundle._decode_bucket(slots)["slots"])
        self.window = int(bundle.decode_window)
        self.model = model
        self.max_queue = None if max_queue is None else int(max_queue)
        self.paging = bool(paging)
        self.idle_spill_ms = (None if idle_spill_ms is None
                              else float(idle_spill_ms))
        # knob-set admission and paging budgets (cv guarded):
        # ``admit_budget`` caps the fresh admissions of one planning
        # iteration (parked continues never count), ``park_budget`` caps
        # the sessions parked in slots before the LRU ones spill without
        # queue pressure. None leaves both unbounded.
        self.admit_budget = None
        self.park_budget = None
        self.replica = None if replica is None else str(replica)
        self._labels = {"model": str(model)} if model else {}
        if self.replica is not None:
            self._labels["replica"] = self.replica
        self._seq_specs = [s for s in bundle.inputs
                           if s["kind"] in SEQ_KINDS]
        self._out_names = [o["name"] for o in bundle.outputs]
        self._cv = threading.Condition()
        self._queue = collections.deque()
        self._in_flight = 0
        self._stopped = False
        self._req_counter = 0
        self._iter_counter = 0
        self._stats = collections.Counter()
        self._slots = [_Slot() for _ in range(self.slots)]
        self._carry = None  # device-resident between iterations
        # -- session tier state (all guarded by self._cv) ------------------
        self._session_slots = {}    # sid -> slot index (resident)
        self._pending_spills = {}   # sid -> True while the writer commits
        self._spill_asap = set()    # sids with a forced spill requested
        self._closing = set()       # closed while their spill is in flight
        # identity check, not truthiness: a store defines __len__, so an
        # empty injected store is falsy
        self._store = (session_store if session_store is not None
                       else SessionStore(capacity=session_capacity,
                                         slo_grace_ms=session_slo_grace_ms,
                                         ttl_ms=session_ttl_ms))
        # the side stream of the spills' device-to-host copies (made by the
        # worker, on the bundle's card)
        self._spill_stream = None
        # -- spill writer (guarded by self._swap_cv) -----------------------
        self._swap_cv = threading.Condition()
        self._swap_q = collections.deque()
        self._swap_stop = False
        self._owns_slog = steplog is None
        # serving records arrive at request rate: batch the flush
        self._slog = (observe_steplog.from_env(run_name=run_name,
                                               meta={"phase": "serve"},
                                               flush_every=32)
                      if steplog is None else steplog)
        self.metrics = metrics_registry or observe_metrics.get_registry()
        self._build_metrics()
        self._ready = threading.Event()
        self._warmer = None
        if warmup == "async":
            self._warmer = threading.Thread(
                target=self._warmup_quietly,
                name=self._thread_name("serve-decode-warmup"),
                daemon=True)
            self._warmer.start()
        elif warmup:
            self._warmup()
        else:
            self._ready.set()
            self._m_ready.set(1)
        # the spill writer owns the blocking waits on the device-to-host
        # copies, so the decode worker never waits on a transfer
        self._swap_writer = threading.Thread(
            target=self._swap_writer_loop,
            name=self._thread_name("serve-session-spill"),
            daemon=True)
        self._swap_writer.start()
        self._worker = threading.Thread(
            target=self._loop, name=self._thread_name("serve-decode-worker"),
            daemon=True)
        self._worker.start()

    def _thread_name(self, base):
        """Thread names carry the replica index, so a fleet's schedulers
        are told apart in a stack dump."""
        return (base if self.replica is None
                else "%s-r%s" % (base, self.replica))

    def _warmup(self):
        try:
            with observe_spans.span("serve_decode_warmup",
                                    args={"slots": self.slots,
                                          "window": self.window}):
                self.bundle.warmup_decoder(self.slots)
        except Exception:
            # a failed warmup stays NOT ready, like the engine
            logger.exception("decode warmup failed; scheduler stays "
                             "not-ready")
            raise
        self._ready.set()
        self._m_ready.set(1)

    def _warmup_quietly(self):
        try:
            self._warmup()
        except Exception:  # noqa: BLE001 — logged in _warmup; stays not-ready
            pass

    def ready(self):
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
        self._m_iters = m.counter(
            "paddle_tpu_serve_decode_iterations_total",
            help="continuous-batching decode dispatches", labels=lab)
        self._m_slot_steps = m.counter(
            "paddle_tpu_serve_decode_slot_steps_total",
            help="real (masked-in) slot-timesteps decoded", labels=lab)
        self._m_admitted = m.counter(
            "paddle_tpu_serve_decode_admitted_total",
            help="sequences admitted into a decode slot", labels=lab)
        self._m_retired = m.counter(
            "paddle_tpu_serve_decode_retired_total",
            help="sequences retired from a decode slot", labels=lab)
        self._m_shed = m.counter(
            "paddle_tpu_serve_shed_total",
            help="requests rejected by admission control",
            labels=dict(lab, reason="queue_full"))
        self._m_queue_depth = m.gauge(
            "paddle_tpu_serve_queue_depth",
            help="rows waiting for a batch flush", labels=lab)
        self._m_in_flight = m.gauge(
            "paddle_tpu_serve_in_flight",
            help="accepted requests not yet resolved", labels=lab)
        self._m_occupancy = m.gauge(
            "paddle_tpu_serve_slot_occupancy",
            help="occupied decode slots / capacity (last iteration)",
            labels=lab)
        self._m_ready = m.gauge(
            "paddle_tpu_serve_ready",
            help="1 once every exported bucket is warm", labels=lab)
        self._m_latency = m.histogram(
            "paddle_tpu_serve_request_latency_ms",
            help="end-to-end request latency (enqueue to result)",
            labels=lab)
        self._m_queue_ms = m.histogram(
            "paddle_tpu_serve_request_queue_ms",
            help="time a request waited for its batch flush", labels=lab)
        self._m_iter_ms = m.histogram(
            "paddle_tpu_serve_decode_iter_ms",
            help="device time per decode window dispatch", labels=lab)
        self._m_spills = m.counter(
            "paddle_tpu_serve_session_spills_total",
            help="session carries paged out to the host store",
            labels=lab)
        self._m_restores = m.counter(
            "paddle_tpu_serve_session_restores_total",
            help="session carries paged back into a decode slot",
            labels=lab)
        self._m_evicted = {}
        for reason in ("capacity", "ttl", "error"):
            self._m_evicted[reason] = m.counter(
                "paddle_tpu_serve_session_evictions_total",
                help="sessions evicted from the host store",
                labels=dict(lab, reason=reason))
        self._m_resident = m.gauge(
            "paddle_tpu_serve_session_resident",
            help="sessions whose carry is in a decode slot", labels=lab)
        self._m_suspended = m.gauge(
            "paddle_tpu_serve_session_suspended",
            help="sessions paged out to the host store", labels=lab)
        self._m_swap_ms = m.histogram(
            "paddle_tpu_serve_session_swap_ms",
            help="device<->host carry copy latency per swap", labels=lab)

    # -- client surface -----------------------------------------------------
    def submit(self, inputs, session_id=None, priority=None,
               end_session=False, trace=None):
        """Enqueue ONE sequence; returns a Future of {output_name:
        array[T, ...]} (one output row per timestep). With ``session_id``
        the decode continues that session's carry (a new id starts fresh;
        an evicted id raises :class:`SessionGone`, the 410 path).
        ``trace`` is an optional upstream
        :class:`~paddle_tpu_torch.observe.tracing.TraceContext`; without
        one the scheduler samples at ``PADDLE_TPU_TORCH_TRACE_SAMPLE``."""
        data, length = self._normalize(inputs)
        sid = None if session_id is None else str(session_id)
        if sid is not None:
            # an evicted session fails fast instead of camping in the queue
            reason = self._store.gone_reason(sid)
            if reason is not None:
                raise SessionGone(
                    "session %r was evicted (reason=%s); start a new "
                    "session" % (sid, reason), session_id=sid,
                    reason=reason)
        with self._cv:
            if self._stopped:
                raise RuntimeError("scheduler is stopped")
            if (self.max_queue is not None
                    and len(self._queue) >= self.max_queue):
                self._stats["shed"] += 1
                self._m_shed.inc()
                observe_health.get_history().record_shed("queue_full")
                raise Overloaded(
                    "decode queue full: %d requests queued >= "
                    "max_queue=%d" % (len(self._queue), self.max_queue),
                    model=self.model, reason="queue_full",
                    queued=len(self._queue))
            self._req_counter += 1
            # the dice rolls only for admitted requests, so the sampled
            # count never exceeds the requests that write a serve_trace
            req = _DecodeRequest(data, length, self._req_counter,
                                 session=sid, priority=priority,
                                 end_session=end_session,
                                 trace=observe_tracing.resolve(trace))
            self._queue.append(req)
            self._in_flight += 1
            self._m_queue_depth.set(len(self._queue))
            observe_health.get_history().record_queue_depth(
                len(self._queue))
            self._m_in_flight.set(self._in_flight)
            self._cv.notify_all()
        return req.future

    def infer(self, inputs, timeout=60.0, session_id=None, priority=None,
              end_session=False, trace=None):
        return self.submit(inputs, session_id=session_id,
                           priority=priority, end_session=end_session,
                           trace=trace).result(timeout=timeout)

    def queue_depth(self):
        with self._cv:
            return len(self._queue)

    def _normalize(self, inputs):
        """Wire format -> per-request {name: [T, ...]} + shared length.
        Accepts [T] / [1, T] data arrays; an optional name + ":lens" [1]
        marks the valid prefix. All sequence inputs of one request advance
        together, so their lengths must agree."""
        data, length = {}, None
        for spec in self._seq_specs:
            name = spec["name"]
            if name not in inputs:
                raise KeyError(
                    "request is missing sequence input %r (expected %s)"
                    % (name, sorted(s["name"] for s in self._seq_specs)))
            arr = np.asarray(inputs[name], dtype=np.dtype(spec["dtype"]))
            want_ndim = 1 if spec["kind"] == "seq_index" else 2
            if arr.ndim == want_ndim + 1:
                if arr.shape[0] != 1:
                    raise ValueError(
                        "continuous decode takes ONE sequence per "
                        "request; input %r has %d rows — submit them "
                        "separately" % (name, arr.shape[0]))
                arr = arr[0]
            if arr.ndim != want_ndim:
                raise ValueError(
                    "input %r: expected a [T%s] sequence, got shape %s"
                    % (name, "" if want_ndim == 1 else ", dim",
                       arr.shape))
            n = int(arr.shape[0])
            lens_key = name + ":lens"
            if lens_key in inputs:
                lens = np.asarray(inputs[lens_key]).reshape(-1)
                if lens.size != 1:
                    raise ValueError(
                        "input %r: one request, one length (got %d)"
                        % (lens_key, lens.size))
                n = int(lens[0])
                if not 1 <= n <= arr.shape[0]:
                    raise ValueError(
                        "input %r: length %d outside [1, %d]"
                        % (lens_key, n, arr.shape[0]))
                arr = arr[:n]
            if n < 1:
                raise ValueError("input %r: empty sequence" % name)
            if length is None:
                length = n
            elif length != n:
                raise ValueError(
                    "sequence inputs advance together through the "
                    "decode slots: lengths differ (%d vs %d for %r)"
                    % (length, n, name))
            data[name] = arr
        extra = (set(inputs) - {s["name"] for s in self._seq_specs}
                 - {s["name"] + ":lens" for s in self._seq_specs})
        if extra:
            raise KeyError("unknown request inputs %s" % sorted(extra))
        return data, length

    def stats(self):
        store_stats = self._store.stats()
        with self._cv:
            out = dict(self._stats)
            for key in ("requests", "rows", "iterations", "slot_steps",
                        "admitted", "retired", "shed", "spills",
                        "restores", "evictions", "sessions_closed"):
                out.setdefault(key, 0)
            out["queue_depth"] = len(self._queue)
            out["in_flight"] = self._in_flight
            out["slots"] = self.slots
            out["window"] = self.window
            out["resident_sessions"] = len(self._session_slots)
        out["suspended_sessions"] = store_stats["suspended"]
        out["session_capacity"] = store_stats["capacity"]
        out["session_bytes"] = store_stats["bytes"]
        if self.model:
            out["model"] = self.model
        if self.replica is not None:
            out["replica"] = self.replica
        out["ready"] = self.ready()
        out["latency_ms"] = self._m_latency.percentiles()
        out["trace"] = observe_tracing.trace_state()
        return out

    def register_knobs(self, registry, prefix="sched"):
        """Adopt the scheduler's live-adjustable parameters into a
        :class:`~paddle_tpu_torch.control.knobs.KnobRegistry`
        (paddle_tpu/serve/scheduler.py). Never the program shapes:
        ``slots`` and ``window`` are the decode program's, and moving
        them would need another program. Apply hooks re-take the cv and
        notify it, so a lowered park budget spills at once.
        ``idle_spill_ms`` registers only when idle spilling was
        configured; ``admit_budget``/``park_budget`` start at ``slots``,
        where they change nothing until the controller moves them."""
        from paddle_tpu_torch.control.knobs import Knob

        with self._cv:
            max_queue = self.max_queue
            idle_spill_ms = self.idle_spill_ms
            admit_budget = self.admit_budget
            park_budget = self.park_budget

        def _setter(attr, cast):
            def _apply(v):
                with self._cv:
                    setattr(self, attr, cast(v))
                    self._cv.notify_all()
            return _apply

        if max_queue is not None:
            registry.register(Knob(
                prefix + ".max_queue", value=max_queue,
                min=self.slots, max=1 << 16, step=self.slots,
                integer=True, apply=_setter("max_queue", int)))
        if self.paging and idle_spill_ms is not None:
            registry.register(Knob(
                prefix + ".idle_spill_ms", value=idle_spill_ms,
                min=1.0, max=600000.0, step=25.0,
                apply=_setter("idle_spill_ms", float)))
        registry.register(Knob(
            prefix + ".admit_budget",
            value=self.slots if admit_budget is None else admit_budget,
            min=1, max=self.slots, step=1, integer=True,
            apply=_setter("admit_budget", int)))
        if self.paging:
            registry.register(Knob(
                prefix + ".park_budget",
                value=self.slots if park_budget is None else park_budget,
                min=0, max=self.slots, step=1, integer=True,
                cost_hint="heavy", apply=_setter("park_budget", int)))

    def stop(self, timeout=30.0):
        """Drain queued and in-slot sequences, stop the worker and the
        spill writer, close an owned step log. Idempotent. Parked and
        suspended session carries survive in host/process memory for
        :meth:`export_session`."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._worker.join(timeout=timeout)
        if self._warmer is not None:
            self._warmer.join(timeout=timeout)
        # the writer drains its queue before exiting, so every spill the
        # worker enqueued while draining still commits
        with self._swap_cv:
            self._swap_stop = True
            self._swap_cv.notify_all()
        self._swap_writer.join(timeout=timeout)
        if self._owns_slog and self._slog is not None:
            self._slog.close()
            self._slog = None
        elif self._slog is not None:
            self._slog.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- session control surface --------------------------------------------
    def spill_session(self, session_id, timeout=30.0):
        """Force one parked session's carry out to the host store and
        return once it committed: the ops drain hook, and what the spill ->
        restore tests use to make paging deterministic. No-op when the
        session is already suspended; raises KeyError for an unknown
        session and :class:`SessionGone` for an evicted one."""
        sid = str(session_id)
        self._suspend(sid, timeout)
        if sid not in self._store:
            reason = self._store.gone_reason(sid)
            if reason is not None:
                raise SessionGone(
                    "session %r was evicted (reason=%s)" % (sid, reason),
                    session_id=sid, reason=reason)
            raise KeyError(sid)

    def has_session(self, session_id):
        """True when this scheduler holds state for the session: resident
        in a slot, mid-spill, or suspended in the store."""
        sid = str(session_id)
        with self._cv:
            if sid in self._session_slots or sid in self._pending_spills:
                return True
        return sid in self._store

    def close_session(self, session_id):
        """Abort a session wherever it sits: frees its slot when parked,
        closes at retire when a request is in flight, drops it from the
        store when suspended (closed, not evicted: no tombstone, the id may
        start fresh). Idempotent; unknown ids are a no-op."""
        sid = str(session_id)
        with self._cv:
            idx = self._session_slots.get(sid)
            if idx is not None:
                slot = self._slots[idx]
                if slot.req is not None:
                    slot.req.end_session = True  # closes at retire
                else:
                    self._detach_locked(idx)
                    self._stats["sessions_closed"] += 1
                    self._cv.notify_all()
            elif sid in self._pending_spills:
                # mid-spill: the writer must discard the carry instead of
                # committing it, or a new conversation reusing the id
                # would resume the dead one's state
                self._closing.add(sid)
                self._stats["sessions_closed"] += 1
            self._spill_asap.discard(sid)
        try:
            self._store.pop(sid)
            with self._cv:
                self._stats["sessions_closed"] += 1
        except (SessionGone, KeyError):
            pass
        self._update_session_gauges()

    def export_session(self, session_id, timeout=30.0):
        """Remove one session's state from this scheduler (forcing a spill
        when it is resident) and return its
        :class:`~paddle_tpu_torch.serve.sessions.SessionState`, numpy rows
        that import into either package's scheduler. Works on a stopped
        scheduler too."""
        sid = str(session_id)
        self._suspend(sid, timeout)
        state = self._store.pop(sid)  # SessionGone / KeyError propagate
        self._update_session_gauges()
        self._log_swap("export", sid, state.nbytes, pos=state.pos)
        return state

    def import_session(self, session_id, state, priority=None):
        """Adopt a migrated session: its next request restores from this
        scheduler's store like any suspended session."""
        sid = str(session_id)
        adopted = SessionState(sid, state.carry, state.pos,
                               priority or state.priority)
        evicted = self._store.put(adopted)
        self._account_evictions(evicted)
        with self._cv:
            self._stats["imports"] += 1
        self._update_session_gauges()
        self._log_swap("import", sid, adopted.nbytes, pos=adopted.pos)

    def _suspend(self, sid, timeout):
        """Ensure ``sid`` is not resident: request a forced spill and wait
        for the writer's commit. On a dead or stopped worker the spill runs
        synchronously here (no dispatch can race the carry read once the
        worker exited)."""
        deadline = time.monotonic() + timeout
        while True:
            salvage = None
            with self._cv:
                if sid in self._pending_spills:
                    pass  # the writer is committing it; wait below
                elif sid not in self._session_slots:
                    return  # suspended (or never here): the store decides
                else:
                    idx = self._session_slots[sid]
                    slot = self._slots[idx]
                    if slot.req is None and not self._worker.is_alive():
                        ses = slot.session
                        rows = self.bundle.carry_slice(self._carry, idx)
                        host = {layer: [host_leaf(leaf)
                                        for leaf in leaves]
                                for layer, leaves in rows.items()}
                        slot.session = None
                        del self._session_slots[sid]
                        self._stats["spills"] += 1
                        salvage = SessionState(sid, host, ses.pos,
                                               ses.priority)
                    else:
                        self._spill_asap.add(sid)
                        self._cv.notify_all()
                if salvage is None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            "session %r did not spill within %.1fs "
                            "(worker alive=%s)"
                            % (sid, timeout, self._worker.is_alive()))
                    self._cv.wait(remaining)
            if salvage is not None:
                # the store commit and the accounting outside the lock
                evicted = self._store.put(salvage)
                self._account_evictions(evicted)
                self._m_spills.inc()
                self._log_swap("spill", sid, salvage.nbytes,
                               pos=salvage.pos)
                return

    def _log_swap(self, op, sid, nbytes=None, overlap_ms=None,
                  reason=None, pos=None):
        if self._slog is not None:
            self._slog.log_serve_swap(
                op=op, session=sid, nbytes=nbytes, overlap_ms=overlap_ms,
                reason=reason, pos=pos, model=self.model,
                replica=self.replica)

    def _account_evictions(self, evicted, reason="capacity"):
        for state in evicted:
            with self._cv:
                self._stats["evictions"] += 1
            self._m_evicted.get(reason, self._m_evicted["capacity"]).inc()
            self._log_swap("evict", state.session_id, state.nbytes,
                           reason=reason, pos=state.pos)

    def _update_session_gauges(self):
        with self._cv:
            resident = len(self._session_slots)
        self._m_resident.set(resident)
        self._m_suspended.set(self._store.suspended_count())

    # -- worker -------------------------------------------------------------
    def _spills_due_locked(self, now):
        """Forced, idle-threshold or park-budget spills waiting to run (cv
        held). Forced spills run even with ``paging=False``; the idle
        threshold and the park budget are paging features."""
        parked = 0
        for slot in self._slots:
            ses = slot.session
            if ses is None or slot.req is not None:
                continue
            parked += 1
            if ses.sid in self._spill_asap:
                return True
            if (self.paging and self.idle_spill_ms is not None
                    and (now - ses.last_active) * 1e3
                    >= self.idle_spill_ms):
                return True
        # a park budget below the parked population is due work too
        return (self.paging and self.park_budget is not None
                and parked > self.park_budget)

    def _free_slot_possible_locked(self):
        """A request with no resident slot can be admitted iff some slot is
        empty or (paging on) parked and spillable. cv HELD by every caller
        (the ``_locked`` convention — reached two helper levels below the
        cv, past the linter's one-level resolution)."""
        for slot in self._slots:
            if slot.req is not None:
                continue
            if slot.session is None:
                return True
            if (self.paging and slot.session.sid
                    not in self._spill_asap):  # paddle-lint: disable=PTA005
                return True
        return False

    def _admissible_any_locked(self):
        free = self._free_slot_possible_locked()
        for req in self._queue:
            sid = req.session
            if sid is None:
                if free:
                    return True
                continue
            if sid in self._pending_spills:
                continue
            idx = self._session_slots.get(sid)
            if idx is not None:
                if self._slots[idx].req is None:
                    return True
                continue
            if free:
                return True
        return False

    def _next_deadline_locked(self, now):
        """Seconds until the earliest idle-spill deadline, or None."""
        if not self.paging or self.idle_spill_ms is None:
            return None
        soonest = None
        for slot in self._slots:
            ses = slot.session
            if ses is None or slot.req is not None:
                continue
            due = ses.last_active + self.idle_spill_ms / 1e3 - now
            soonest = due if soonest is None else min(soonest, due)
        return None if soonest is None else max(soonest, 0.0)

    def _wait_for_work(self):
        """Block until there is actionable work (an occupied slot, an
        admissible queued request, a due spill); False once stopped AND
        drained."""
        with self._cv:
            while True:
                now = time.monotonic()
                if any(s.req is not None for s in self._slots):
                    return True
                if self._spills_due_locked(now):
                    return True
                if self._queue and self._admissible_any_locked():
                    return True
                if self._stopped:
                    if not self._queue:
                        return False
                    if not self._pending_spills:
                        # requests that can never admit (paging off, every
                        # slot parked): fail them instead of hanging
                        failed = list(self._queue)
                        self._queue.clear()
                        self._m_queue_depth.set(0)
                        self._in_flight -= len(failed)
                        self._m_in_flight.set(self._in_flight)
                        for req in failed:
                            if not req.future.done():
                                req.future.set_exception(
                                    RuntimeError("scheduler stopped "
                                                 "before admission"))
                        return False
                self._cv.wait(self._next_deadline_locked(now))

    def _plan(self):
        """Admission and paging decisions for one iteration: fill slots
        from the queue in arrival order (a session parked in a slot
        continues there, reset=0; a suspended session claims a free slot
        and restores, reset=0; everything else starts fresh, reset=1) and
        pick the spill victims (forced, idle-threshold, and pressure LRU
        when the queue needs slots that parked sessions hold)."""
        plan = _Plan()
        now = time.monotonic()
        # the store has its own lock: never nest it inside admission's
        store = self._store
        with self._cv:
            # 1. forced and idle-threshold spills
            for i, slot in enumerate(self._slots):
                ses = slot.session
                if ses is None or slot.req is not None:
                    continue
                forced = ses.sid in self._spill_asap
                idle = (self.paging and self.idle_spill_ms is not None
                        and (now - ses.last_active) * 1e3
                        >= self.idle_spill_ms)
                if forced or idle:
                    plan.spills.append((i, ses))
                    # pending before the queue scan below: the spilled
                    # session's own queued request waits for the commit
                    self._pending_spills[ses.sid] = True
                    self._detach_locked(i, spilling=True)
            # 1b. park-budget pressure: the LRU parked sessions beyond
            # the budget spill even without queue pressure
            if self.paging and self.park_budget is not None:
                parked = [(i, s.session) for i, s in enumerate(self._slots)
                          if s.session is not None and s.req is None]
                excess = len(parked) - int(self.park_budget)
                if excess > 0:
                    parked.sort(key=lambda t: t[1].last_active)
                    for i, ses in parked[:excess]:
                        plan.spills.append((i, ses))
                        self._pending_spills[ses.sid] = True
                        self._detach_locked(i, spilling=True)
            # 2. the queue in arrival order; ``admit_budget`` caps the
            # fresh admissions (sessionless, brand-new, restores)
            leftovers = collections.deque()
            admit_budget = self.admit_budget
            fresh = 0
            while self._queue:
                req = self._queue.popleft()
                sid = req.session
                if sid is None:
                    if admit_budget is not None and fresh >= admit_budget:
                        leftovers.append(req)
                        continue
                    idx = self._claim_slot_locked(plan)
                    if idx is None:
                        leftovers.append(req)
                        continue
                    self._attach_locked(idx, req, now)
                    plan.admitted.append(idx)
                    fresh += 1
                    continue
                if sid in self._pending_spills:
                    if req.t_defer is None:
                        # waiting on its own session's spill: charged to
                        # the spill_restore phase, not to queue wait
                        req.t_defer = time.perf_counter()
                    leftovers.append(req)  # the writer is mid-commit
                    continue
                if req.t_defer is not None:
                    # the spill committed: the wait on it ends at the
                    # first scan that sees it
                    req.spill_wait_ms += (time.perf_counter()
                                          - req.t_defer) * 1e3
                    req.t_defer = None
                res_idx = self._session_slots.get(sid)
                if res_idx is not None:
                    if self._slots[res_idx].req is not None:
                        leftovers.append(req)  # one request at a time
                        continue
                    self._attach_locked(res_idx, req, now)
                    continue  # parked continue: reset=0, no restore
                # suspended / brand-new / evicted
                if admit_budget is not None and fresh >= admit_budget:
                    leftovers.append(req)
                    continue
                try:
                    state = store.pop(sid)
                except SessionGone as exc:
                    plan.failures.append((req, exc))
                    continue
                except KeyError:
                    state = None  # brand-new session: fresh carry
                idx = self._claim_slot_locked(plan)
                if idx is None:
                    if state is not None:
                        store.put(state)  # no room yet: back it goes
                    leftovers.append(req)
                    continue
                self._attach_locked(idx, req, now,
                                    pos=0 if state is None else state.pos)
                if state is None:
                    plan.admitted.append(idx)
                else:
                    plan.restores.append((idx, state))
                fresh += 1
            self._queue = leftovers
            self._m_queue_depth.set(len(self._queue))
            self._in_flight -= len(plan.failures)
            if plan.failures:
                self._m_in_flight.set(self._in_flight)
        return plan

    def _claim_slot_locked(self, plan):
        """An empty slot, else (paging on) the LRU parked slot, whose
        session joins the plan's spills and is detached so the new
        occupant takes the slot this iteration (the spill's slice is
        enqueued before the insert and the step)."""
        victim_i, victim = None, None
        for i, slot in enumerate(self._slots):
            if slot.req is not None:
                continue
            if slot.session is None:
                return i
            if not self.paging:
                continue
            ses = slot.session
            if victim is None or ses.last_active < victim.last_active:
                victim_i, victim = i, ses
        if victim is None:
            return None
        plan.spills.append((victim_i, victim))
        # pending at once: the victim's own queued request later in this
        # scan must wait for the commit, not start a fresh zero carry
        self._pending_spills[victim.sid] = True
        self._detach_locked(victim_i, spilling=True)
        return victim_i

    def _attach_locked(self, idx, req, now, pos=0):
        slot = self._slots[idx]
        slot.req = req
        slot.pos = 0
        req.t_admit = time.perf_counter()
        if req.t_defer is not None:
            req.spill_wait_ms += (req.t_admit - req.t_defer) * 1e3
            req.t_defer = None
        if req.session is not None:
            ses = slot.session
            if ses is None or ses.sid != req.session:
                ses = _ResidentSession(req.session, req.priority, pos)
                slot.session = ses
                self._session_slots[req.session] = idx
            ses.last_active = now
            ses.trace = req.trace
            if req.priority:
                ses.priority = req.priority
        else:
            # a sessionless request parks nothing: its carry is
            # reset-zeroed at admission and discarded at retire
            slot.session = None

    def _detach_locked(self, idx, spilling=False):
        # cv HELD by every caller (the ``_locked`` convention — some
        # call chains run two helper levels below the cv acquisition,
        # past the linter's one-level resolution)
        slot = self._slots[idx]
        ses = slot.session
        if ses is not None:
            self._session_slots.pop(ses.sid, None)  # paddle-lint: disable=PTA005
            if spilling:
                self._spill_asap.discard(ses.sid)  # paddle-lint: disable=PTA005
        slot.session = None

    def _loop(self):
        if self.bundle.device.type == "cuda":
            # this thread's kernels and carries go to the card that holds
            # the bundle's parameters, whatever the creating thread's was
            torch.cuda.set_device(
                next(iter(self.bundle.payload.values())).device)
        while self._wait_for_work():
            try:
                self._run_iteration()
            except Exception as exc:  # noqa: BLE001 — fail the occupants, not the scheduler
                logger.exception("decode iteration failed")
                failed = []
                lost_sessions = []
                with self._cv:
                    for i, slot in enumerate(self._slots):
                        if slot.req is not None:
                            failed.append(slot.req)
                            slot.req = None
                        if slot.session is not None:
                            # the carry matrix is poisoned below: every
                            # resident session's state goes with it
                            lost_sessions.append(slot.session.sid)
                            self._detach_locked(i)
                    self._in_flight -= len(failed)
                    self._m_in_flight.set(self._in_flight)
                    self._stats["iterations_failed"] += 1
                    self._cv.notify_all()
                self._carry = None
                for sid in lost_sessions:
                    # tombstone: the next request answers 410 instead of
                    # silently starting the conversation over
                    self._store.tombstone(sid, "error")
                    self._account_evictions(
                        [SessionState(sid, {}, 0)], reason="error")
                self._update_session_gauges()
                for req in failed:
                    if not req.future.done():
                        req.future.set_exception(exc)

    def _spill_copy(self, rows):
        """Start the device-to-host copy of one spilled slot's rows.
        Returns ``(host rows, event)``: on the card, pinned host tensors
        filled by a non-blocking copy on the side stream, which first waits
        on an event recorded after the slice, and the event recorded after
        the copy (the writer waits on it); on the CPU, the rows and None."""
        if self.bundle.device.type != "cuda":
            return rows, None
        if self._spill_stream is None:
            self._spill_stream = torch.cuda.Stream(device=self.bundle.device)
        sliced = torch.cuda.Event()
        sliced.record()
        host = {}
        with torch.cuda.stream(self._spill_stream):
            self._spill_stream.wait_event(sliced)
            for layer, leaves in rows.items():
                host[layer] = [
                    torch.empty(leaf.shape, dtype=leaf.dtype,
                                pin_memory=True).copy_(leaf, non_blocking=True)
                    for leaf in leaves]
            copied = torch.cuda.Event()
            copied.record()
        return host, copied

    def _run_iteration(self):
        # expire idle suspended sessions BEFORE admission (no-op without a
        # TTL), so a long-expired session answers 410, not a restore
        expired = self._store.expire()
        if expired:
            self._account_evictions(expired, reason="ttl")
        plan = self._plan()
        for req, exc in plan.failures:
            if not req.future.done():
                req.future.set_exception(exc)
        if self._carry is None:
            self._carry = self.bundle.zero_carry(self.slots)
        # paging: slice the spilled carries BEFORE the insert and the step,
        # so the stream-ordered reads see the rows before any overwrite;
        # the writer waits on the copies, overlapped with this dispatch
        enqueued = 0
        try:
            for idx, ses in plan.spills:
                rows = self.bundle.carry_slice(self._carry, idx)
                host, copied = self._spill_copy(rows)
                with self._swap_cv:
                    # the device rows ride along until the copy landed;
                    # the trace context crosses to the writer by value
                    self._swap_q.append((ses.sid, rows, host, copied,
                                         ses.pos, ses.priority, ses.trace))
                    self._swap_cv.notify_all()
                enqueued += 1
        except Exception:
            # a failed slice strands the un-enqueued pending spills:
            # tombstone them and release their waiters
            stranded = [ses for _, ses in plan.spills[enqueued:]]
            with self._cv:
                for ses in stranded:
                    self._pending_spills.pop(ses.sid, None)
                self._cv.notify_all()
            for ses in stranded:
                self._store.tombstone(ses.sid, "error")
                self._account_evictions(
                    [SessionState(ses.sid, {}, ses.pos)], reason="error")
            raise
        for idx, state in plan.restores:
            # the restoring request is attached already: the restore's
            # time and span go to its trace lane and spill_restore phase
            restored_req = self._slots[idx].req
            ctx = restored_req.trace if restored_req is not None else None
            with observe_spans.span(
                    "serve_swap_restore",
                    args={"session": state.session_id, "slot": idx},
                    trace=None if ctx is None else ctx.child()) as scope:
                self._carry = self.bundle.carry_insert(self._carry,
                                                       state.carry, idx)
            restore_ms = scope.dur * 1e3
            if restored_req is not None:
                restored_req.restore_ms += restore_ms
            with self._cv:
                self._stats["restores"] += 1
            self._m_restores.inc()
            self._m_swap_ms.observe(restore_ms)
            self._log_swap("restore", state.session_id, state.nbytes,
                           overlap_ms=restore_ms, pos=state.pos)
        if plan.spills or plan.restores:
            self._update_session_gauges()
        active = sum(1 for s in self._slots if s.req is not None)
        if active == 0:
            return  # spill-only service: nothing to decode
        flat = self.bundle.dummy_decode_flat(self.slots, self.window)
        reset = np.zeros((self.slots,), np.float32)
        lens = np.zeros((self.slots,), np.int32)
        for i in plan.admitted:
            reset[i] = 1.0
        for i, slot in enumerate(self._slots):
            if slot.req is None:
                continue
            k = min(slot.req.length - slot.pos, self.window)
            lens[i] = k
            for spec in self._seq_specs:
                name = spec["name"]
                flat[name][i, :k] = slot.req.data[name][
                    slot.pos:slot.pos + k]
        flat["lens"] = lens
        flat["reset"] = reset
        self._iter_counter += 1
        # the step and the window's one readback of the outputs
        with observe_spans.span(
                "serve_decode",
                args={"active": active, "slots": self.slots,
                      "window": self.window}) as scope:
            self._carry, outs = self.bundle.decode_step(
                self._carry, flat, self.slots)
            outs = {k: v.float().cpu().numpy() for k, v in outs.items()}
        infer_ms = scope.dur * 1e3
        retired, deliveries = self._distribute(outs, lens)
        steps = int(lens.sum())
        try:
            with self._cv:
                self._stats["iterations"] += 1
                self._stats["slot_steps"] += steps
                self._stats["admitted"] += len(plan.admitted)
                self._stats["retired"] += len(retired)
                self._stats["iter_ms_sum"] += infer_ms
                resident = len(self._session_slots)
            self._m_iters.inc()
            if steps:
                self._m_slot_steps.inc(steps)
            if plan.admitted:
                self._m_admitted.inc(len(plan.admitted))
            if retired:
                self._m_retired.inc(len(retired))
            self._m_iter_ms.observe(infer_ms)
            self._m_occupancy.set(active / self.slots)
            observe_health.get_history().record_occupancy(
                active / self.slots)
            if self._slog is not None:
                self._slog.log_serve_decode(
                    iteration=self._iter_counter, active=active,
                    window=self.window, slots=self.slots, steps=steps,
                    admitted=len(plan.admitted), retired=len(retired),
                    infer_ms=infer_ms, model=self.model,
                    replica=self.replica, resident=resident,
                    suspended=self._store.suspended_count())
        finally:
            # deliver last, and no matter what: a client waking from
            # infer() finds stats() and the step log already reflecting
            # its request, and a raising sink never strands a result
            for req, result, _t_ser in deliveries:
                if not req.future.done():
                    req.future.set_result(result)

    def _swap_writer_loop(self):
        """The named spill writer: waits on the device-to-host copies (so
        the worker's next dispatch overlaps them), then commits to the
        store and releases the session for restore."""
        while True:
            with self._swap_cv:
                while not self._swap_q and not self._swap_stop:
                    self._swap_cv.wait()
                if not self._swap_q:
                    return  # stopped and drained
                (sid, rows, host, copied, pos, priority,
                 trace) = self._swap_q.popleft()
            try:
                with observe_spans.span(
                        "serve_swap_spill", args={"session": sid},
                        trace=None if trace is None
                        else trace.child()) as scope:
                    if copied is not None:
                        copied.synchronize()
                    carry = {layer: [host_leaf(leaf) for leaf in leaves]
                             for layer, leaves in host.items()}
                del rows, host  # the copy landed: the buffers may go
                overlap_ms = scope.dur * 1e3
                state = SessionState(sid, carry, pos, priority)
                with self._cv:
                    discard = sid in self._closing
                    if discard:
                        # closed while the spill was in flight: drop the
                        # carry instead of committing a dead conversation
                        self._closing.discard(sid)
                        self._pending_spills.pop(sid, None)
                        self._cv.notify_all()
                if discard:
                    self._update_session_gauges()
                    continue
                evicted = self._store.put(state)
                with self._cv:
                    self._stats["spills"] += 1
                    self._stats["spill_get_ms_sum"] += overlap_ms
                    self._pending_spills.pop(sid, None)
                    # a close raced in between the check above and the
                    # commit: honor it by removing what was committed
                    late_close = sid in self._closing
                    self._closing.discard(sid)
                    self._cv.notify_all()
                if late_close:
                    try:
                        self._store.pop(sid)
                    except (SessionGone, KeyError):
                        pass
                self._m_spills.inc()
                self._m_swap_ms.observe(overlap_ms)
                self._log_swap("spill", sid, state.nbytes,
                               overlap_ms=overlap_ms, pos=pos)
                self._account_evictions(evicted)
                self._update_session_gauges()
            except Exception:  # noqa: BLE001 — one lost carry must not kill the writer
                logger.exception("session spill of %r failed; session "
                                 "tombstoned", sid)
                self._store.tombstone(sid, "error")
                with self._cv:
                    self._pending_spills.pop(sid, None)
                    self._closing.discard(sid)
                    self._cv.notify_all()
                self._account_evictions(
                    [SessionState(sid, {}, pos)], reason="error")
                self._update_session_gauges()

    def _distribute(self, outs, lens):
        """Hand each occupied slot its window of outputs; retire sequences
        that finished (a session's slot parks, carry kept, unless the
        request closed it) and emit their per-request telemetry. Returns
        ``(retired requests, [(request, result, t_serialize)])``; the
        caller resolves the futures once the iteration's accounting
        landed."""
        retired = []
        closed = 0
        t_done = time.perf_counter()
        now = time.monotonic()
        for i, slot in enumerate(self._slots):
            req, k = slot.req, int(lens[i])
            if req is None or k == 0:
                continue
            req.iters += 1  # decode dispatches this request spanned
            # copies, not views: a view would pin the whole [slots,
            # window, ...] array until retirement
            req.collected.append({name: outs[name][i, :k].copy()
                                  for name in self._out_names})
            slot.pos += k
            if slot.pos >= req.length:
                slot.req = None
                retired.append(req)
                with self._cv:
                    ses = slot.session
                    if ses is not None:
                        ses.pos += req.length
                        ses.last_active = now
                        if req.end_session:
                            self._detach_locked(i)
                            closed += 1
        if closed:
            with self._cv:
                self._stats["sessions_closed"] += closed
            self._update_session_gauges()
        if not retired:
            return retired, []
        with self._cv:
            self._in_flight -= len(retired)
            self._m_in_flight.set(self._in_flight)
            self._stats["requests"] += len(retired)
            self._stats["rows"] += len(retired)
        self._m_requests.inc(len(retired))
        self._m_rows.inc(len(retired))
        # results and stamps first, telemetry after: the tracing's own
        # cost is not billed to later retirees' serialize phase
        deliveries = []
        for req in retired:
            result = {name: np.concatenate([c[name] for c in req.collected],
                                           axis=0)
                      for name in self._out_names}
            deliveries.append((req, result, time.perf_counter()))
        exemplars = observe_tracing.get_exemplars()
        for req, _result, t_ser in deliveries:
            # a telemetry failure loses telemetry, never results: these
            # requests are already detached from their slots
            try:
                queue_ms = (req.t_admit - req.t_enqueue) * 1e3
                latency_ms = (t_done - req.t_enqueue) * 1e3
                self._m_queue_ms.observe(queue_ms)
                self._m_latency.observe(latency_ms)
                if self._slog is not None:
                    self._slog.log_serve_request(
                        rows=1, queue_ms=queue_ms, latency_ms=latency_ms,
                        req_id=req.req_id)
                # consecutive intervals of enqueue -> serialized result,
                # the session tier's spill wait and restore pulled out of
                # queue and decode
                phases = {
                    "queue_ms": max(queue_ms - req.spill_wait_ms, 0.0),
                    "spill_restore_ms": (req.spill_wait_ms
                                         + req.restore_ms),
                    "decode_ms": max((t_done - req.t_admit) * 1e3
                                     - req.restore_ms, 0.0),
                    "serialize_ms": (t_ser - t_done) * 1e3,
                }
                trace_total_ms = (t_ser - req.t_enqueue) * 1e3
                exemplars.offer(trace_total_ms, phases, model=self.model,
                                replica=self.replica, session=req.session,
                                trace_id=(req.trace.trace_id
                                          if req.trace else None))
                observe_health.get_history().record_request(
                    latency_ms, phases)
                if req.trace is not None:
                    self._emit_trace(req, phases, trace_total_ms, t_done,
                                     t_ser)
            except Exception:  # noqa: BLE001 — lose telemetry, not results
                logger.exception("per-request telemetry emission failed; "
                                 "result still delivered")
        return retired, deliveries

    def _emit_trace(self, req, phases, latency_ms, t_done, t_ser):
        """A sampled request's trace at retirement: its phase spans,
        recorded after the fact (each a child context, so the exporter
        links them into the request's lane), and the ``serve_trace``
        record the tail attribution reads."""
        ctx = req.trace
        tracer = observe_spans.get_tracer()
        args = {"id": req.req_id}
        if req.session is not None:
            args["session"] = req.session
        tracer.add_event("serve_queue_wait", req.t_enqueue,
                         req.t_admit - req.t_enqueue, args=args,
                         trace=ctx.child())
        tracer.add_event("serve_decode_seq", req.t_admit,
                         t_done - req.t_admit,
                         args=dict(args, iterations=req.iters),
                         trace=ctx.child())
        tracer.add_event("serve_serialize", t_done, t_ser - t_done,
                         args=args, trace=ctx.child())
        if self._slog is not None:
            self._slog.log_serve_trace(
                latency_ms=latency_ms, phases=phases,
                trace_id=ctx.trace_id, span_id=ctx.span_id,
                model=self.model, replica=self.replica, req_id=req.req_id,
                rows=1, iterations=req.iters, session=req.session)
