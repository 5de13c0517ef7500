"""Per-step JSONL telemetry sink (paddle_tpu/observe/steplog.py).

``PADDLE_TPU_TORCH_TELEMETRY=<dir>`` makes the trainer write one JSON record
per training step to ``<dir>/<run>.steps.jsonl`` plus a Chrome-trace
export of the host spans to ``<dir>/<run>.trace.json`` (open in
Perfetto). A repeated run of the same name in the same directory gets a
``-N`` filename suffix instead of clobbering the earlier telemetry.
The schema is the JAX package's, field for field, guarded by the same
golden file (tests/golden/steplog_schema.json): a directory written by
either package summarizes the same in the other.

Record types (field ``type``):

* ``meta``  — first line: ``schema`` version, ``run`` name, ``backend``
  (``cuda``/``cpu``) and ``device_count``, caller metadata (the trainer
  passes ``phase``, ``num_passes``, the torch and CUDA versions and the
  card's name).
* ``step``  — one per finalized training step: ``step`` (global step
  number), ``pass``/``batch``, ``wall_ms`` (interval between successive
  step finalizations — steady-state per-step wall time; the first record
  of a run includes compile), ``feed_ms`` (host data conversion),
  ``cost``, ``examples``, ``examples_per_sec``, optional ``device_ms``
  (when a device trace was taken), optional ``tflops``/``mfu_pct`` (when
  step FLOPs were registered), optional ``metrics`` (evaluator results),
  ``t`` (seconds since the meta record).
* ``pass``  — end of a pass: ``pass``, ``metrics``.
* ``event`` — a duration event: ``event``, ``secs``. The JAX package
  mirrors ``jax.monitoring`` (compile times) here; the port has no such
  bus and writes one for each kernel library built or loaded at first
  use (``/paddle_tpu_torch/kernel_build/<lib>``,
  ``/paddle_tpu_torch/kernel_load/<lib>``, ops/_build.py), for each
  program a bundle deserializes
  (``/paddle_tpu_torch/program_load/<artifact>``, serve/bundle.py) and
  for each CUDA graph the fused loop captures
  (``/paddle_tpu_torch/cuda_graph_capture``, trainer.py).
* ``bench_row`` — a benchmark record mirrored by benchmark/run.py, so
  BENCH rows and telemetry can never disagree.
* ``feed``  — one pipelined input batch (data/feeder.py, only
  written when the trainer runs with ``feed_pipeline=``): ``step`` it
  fed, ``stall_ms`` (time the step thread blocked waiting for it — the
  input-bound signal), optional ``convert_ms`` (producer-thread
  conversion + device dispatch), ``examples``, ``depth`` (pipeline
  depth), and for sequence feeds ``bucket`` (padded length),
  ``fill_tokens``/``pad_tokens`` (padding-waste accounting).
* ``train_chunk`` — one fused multi-step dispatch (trainer
  ``steps_per_call=K``): ``step`` (global step of the chunk's FIRST
  step), ``steps`` (real steps in the chunk — K, or less for a partial
  final/bucket-boundary chunk), ``wall_ms`` (interval between
  successive chunk finalizations — the only honest wall time inside a
  fused region; the chunk's per-step ``step`` records carry none),
  ``feed_ms`` (summed feed stall), ``cost_first``/``cost_last``,
  ``examples`` (chunk total), ``examples_per_sec``, ``pass``/``batch``
  (first batch id of the chunk).
* ``serve_request`` — one completed inference request through the
  serving engine (paddle_tpu.serve): ``rows``, ``queue_ms`` (time spent
  waiting for a batch flush), ``latency_ms`` (enqueue -> result),
  optional ``id``.
* ``serve_batch`` — one batch the serving engine flushed to the device:
  ``rows`` (real rows), ``bucket`` (padded batch size), ``infer_ms``,
  optional ``batch``/``pad_rows``/``requests``/``queue_ms_max``, the
  ``flush`` reason (``size``/``deadline``/``drain``) and ``replica``
  (the fleet member that ran it, serve/fleet.py).
* ``serve_decode`` — one continuous-batching decode dispatch
  (paddle_tpu.serve.scheduler): ``iteration``, ``active`` (occupied
  slots), ``window`` (timesteps per dispatch), ``infer_ms``, optional
  ``slots`` (capacity), ``steps`` (real masked-in slot-timesteps),
  ``admitted``/``retired`` (sequences entering/leaving slots this
  iteration), ``model`` and ``replica`` (fleet member), and the
  session tier's ``resident``/``suspended`` counts at dispatch time.
* ``serve_swap`` — one session-tier paging event
  (paddle_tpu.serve.scheduler): ``op``
  (``spill``/``restore``/``evict``/``export``/``import``),
  ``session``, optional ``bytes`` (carry payload), ``overlap_ms``
  (the device<->host copy time the next window dispatch absorbed),
  ``reason`` (evictions: ``capacity``/``ttl``/``error``), ``pos``
  (absolute decode position), ``model`` and ``replica``.
* ``serve_trace`` — one SAMPLED request's end-to-end phase breakdown
  (request-scoped tracing, docs/observability.md "Request tracing &
  tail attribution"): ``latency_ms`` (enqueue -> serialized result) and
  ``phases`` (a dict of per-phase milliseconds — ``queue_ms`` always;
  engine path adds ``batch_form_ms``/``dispatch_ms``, the continuous
  scheduler adds ``spill_restore_ms``/``decode_ms``; ``serialize_ms``
  always — summing to ``latency_ms``), optional ``trace``/``span``
  (W3C-shaped ids), ``iterations`` (decode window dispatches the
  request spanned), ``rows``, ``session``, ``model``, ``replica``,
  ``id`` (request id). Written at ``PADDLE_TPU_TRACE_SAMPLE`` rate;
  ``cli observe`` aggregates these into the tail-attribution report.
* ``serve_shed`` — one request rejected by serving admission control
  (engine queue bound, scheduler queue bound, or the router's
  priority-class shed policy): ``model``, ``reason``
  (``queue_full``/``pressure``), optional ``priority`` and ``queued``
  (queue state that triggered the shed).
* ``slo_status`` — a burn-rate SLO state transition
  (observe/health.py SloMonitor): ``state``
  (``ok``/``burning``/``breached``), optional ``prev_state``,
  ``objective_p99_ms``, ``availability`` (declared objectives),
  ``current_p99_ms`` (fleet-merged fast-window p99), ``fast_burn``/
  ``slow_burn`` (error-budget burn rates), ``budget_remaining``,
  ``breaching_phase`` (tail-attribution's dominant phase),
  ``worker`` (the worker owning most tail exemplars), ``model``.
* ``checkpoint`` — one committed training checkpoint
  (distributed/checkpoint.py): ``step`` (global step the snapshot
  captured), ``duration_ms`` (serialize + fsync + atomic rename, on the
  writer thread for overlapped saves), optional ``bytes`` (directory
  payload), ``overlapped`` (True = async writer thread, False =
  blocking save on the step thread), ``step_thread_ms`` (what the save
  actually cost the step thread: the jitted snapshot clone + handoff),
  ``pass`` and ``path`` (checkpoint directory basename).
* ``anomaly`` — a sentinel trip (observe/sentinel.py): ``step``,
  ``kind`` (``nan_inf_loss``/``loss_divergence``), optional ``cost``
  (repr string when non-finite), ``threshold``, ``mode``, ``pass``,
  ``worker`` (the training-fleet worker id — a multi-worker NaN names
  its process).
* ``crash_report`` — the flight-recorder black box, written on a
  sentinel trip or an exception escaping the training loop: ``reason``
  and ``steps`` (the ring of the last N step records, oldest first),
  optional ``captured`` (lifetime records), ``capacity``, ``mode``,
  ``anomaly``, ``artifact`` (the standalone JSON path),
  ``suppressed_trips`` (repeat trips of an already-reported kind),
  ``worker`` (the training-fleet worker id).
* ``elastic_event`` — one elastic-fleet transition
  (distributed/elastic.py, distributed/checkpoint.py commits):
  ``kind`` in ``register``/``lease_renew_fail``/``self_lease_lost``/
  ``worker_lost``/``rewind``/``re_deal``/``checkpoint_commit``/
  ``resume``, optional ``worker`` (the emitting worker id),
  ``members`` (the membership snapshot AT the event), ``lost``
  (the lapsed workers, ``worker_lost`` only), ``checkpoint``
  (directory basename, ``rewind``/``checkpoint_commit``), ``step``,
  ``detail``. ``cli observe`` merges these across a fleet's files into
  one absolute-time-ordered timeline (observe/trainview.py).
* ``end``   — last line: total ``steps`` written.

Unknown analysis code must ignore record types it does not know; within
a record type, fields are only ever added, never renamed (bump
``SCHEMA_VERSION`` if that ever has to break).
"""

import atexit
import collections
import contextlib
import json
import math
import os
import threading
import time
import weakref

SCHEMA_VERSION = 1

# every live StepLog; the atexit durability guard flushes these so
# flush_every=N batching cannot drop its last <N buffered records when the
# interpreter exits with a log still open
_registry_lock = threading.Lock()
_live_logs = weakref.WeakSet()
# the StepLogs that take duration events (emit_event); weak so a log that
# was never closed does not stay pinned
_open_logs = weakref.WeakSet()
_atexit_registered = False


def _flush_live_logs():
    """Flush (not close) every still-open StepLog at interpreter exit."""
    with _registry_lock:
        logs = list(_live_logs)
    for log in logs:
        try:
            log.flush()
        except Exception:
            pass


def _ensure_atexit():
    global _atexit_registered
    with _registry_lock:
        if _atexit_registered:
            return
        _atexit_registered = True
    atexit.register(_flush_live_logs)


def emit_event(event, secs):
    """Write one duration ``event`` record into every open StepLog that
    takes events, and show it to every :func:`watch_compiles` block — the
    port's stand-in for the ``jax.monitoring`` duration listener: the
    kernel build/load at first use (ops/_build.py), each program a bundle
    deserializes (serve/bundle.py) and each CUDA graph capture
    (trainer.py) report their seconds here."""
    with _registry_lock:
        logs = list(_open_logs)
        watchers = list(_compile_watchers)
    for log in logs:
        log._on_monitoring_event(event, secs)
    for watcher in watchers:
        watcher._on_monitoring_event(event, secs)


# the events that make a program ready to run: a torch.export program
# deserialized (the JAX bundle's compile) and a CUDA graph captured (the
# JAX fused loop's compile); a kernel library's build or load is not one
COMPILE_EVENT_MARKERS = ("/paddle_tpu_torch/program_load",
                         "/paddle_tpu_torch/cuda_graph_capture")
_compile_watchers = set()


class CompileWatcher:
    """Counts the programs made ready while it watches
    (``COMPILE_EVENT_MARKERS`` events, process-wide): the backing object
    of :func:`watch_compiles`."""

    def __init__(self):
        self._lock = threading.Lock()
        self.compiles = 0
        self.events = []

    def _on_monitoring_event(self, event, secs):
        name = str(event)
        if any(marker in name for marker in COMPILE_EVENT_MARKERS):
            with self._lock:
                self.compiles += 1
                self.events.append(name)


@contextlib.contextmanager
def watch_compiles():
    """Context manager counting the programs made ready inside the block
    (paddle_tpu/observe/steplog.py ``watch_compiles``): every
    ``torch.export`` program deserialized and every CUDA graph captured,
    on any thread; a cached program counts nothing. Yields the
    :class:`CompileWatcher`; read ``.compiles`` after (or during) the
    block. ``cli serve --join`` answers ``GET /debug/compiles`` from
    one."""
    watcher = CompileWatcher()
    with _registry_lock:
        _compile_watchers.add(watcher)
    try:
        yield watcher
    finally:
        with _registry_lock:
            _compile_watchers.discard(watcher)


def _env_or_flag(env, flag):
    """(raw environment value or None, the flag's value or None)."""
    raw = os.environ.get(env)
    try:
        from paddle_tpu_torch.utils import flags

        return raw, flags.get_flag(flag)
    except KeyError:
        return raw, None


def telemetry_dir():
    """The active telemetry directory or None: the live environment
    variable ``PADDLE_TPU_TORCH_TELEMETRY`` wins (so it can be set after
    import), falling back to the ``telemetry`` flag."""
    env, flag = _env_or_flag("PADDLE_TPU_TORCH_TELEMETRY", "telemetry")
    return env or flag or None


def stats_enabled():
    """True when the per-pass StatSet dump is requested
    (``PADDLE_TPU_TORCH_STATS=1``, live env first, then the ``stats``
    flag)."""
    env, flag = _env_or_flag("PADDLE_TPU_TORCH_STATS", "stats")
    if env is not None:
        return env.lower() in ("1", "true", "yes", "on")
    return bool(flag)


def from_env(run_name="train", meta=None, flush_every=1):
    """A StepLog when telemetry is enabled, else None (the no-op path)."""
    directory = telemetry_dir()
    if not directory:
        return None
    try:
        return StepLog(directory, run_name=run_name, meta=meta,
                       flush_every=flush_every)
    except OSError as exc:
        from paddle_tpu_torch.utils.logger import logger

        logger.warning("telemetry disabled: cannot open %s (%s)",
                       directory, exc)
        return None


class StepLog:
    """JSONL writer of per-step records. Thread-safe; by default every
    record is flushed so a crashed run keeps its telemetry.

    ``flush_every=N`` batches the flush: at most N-1 records are lost
    on a crash, and the per-record flush syscall leaves the hot path —
    the serving tier uses this (records arrive at request rate there,
    and the per-record flush measured ~20% of a saturated continuous-
    batching fleet's throughput; training steps are orders of magnitude
    rarer, so the trainer keeps the flush-every-record default)."""

    def __init__(self, directory, run_name="train", meta=None,
                 compile_events=True, flush_every=1):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        # never clobber an earlier run in the same telemetry dir: a second
        # run of the same name gets a -N suffix (train-2.steps.jsonl, with
        # its span export at train-2.trace.json). Mode "x" makes the pick
        # atomic, so concurrent processes sharing the dir (multi-host)
        # land on distinct files instead of truncating each other.
        base = os.path.join(directory, run_name)
        n = 0
        while True:
            n += 1
            self.path = (base + ".steps.jsonl" if n == 1
                         else "%s-%d.steps.jsonl" % (base, n))
            try:
                self._fh = open(self.path, "x")
                break
            except FileExistsError:
                continue
        self.trace_path = self.path[:-len(".steps.jsonl")] + ".trace.json"
        self._lock = threading.Lock()
        self._flops = None
        self._steps = 0
        self._closed = False
        self.flush_every = max(int(flush_every), 1)
        self._unflushed = 0
        self._t0 = time.perf_counter()
        header = {"type": "meta", "schema": SCHEMA_VERSION, "run": run_name,
                  "unix_time": round(time.time(), 3)}
        import torch

        cuda = torch.cuda.is_available()
        header["backend"] = "cuda" if cuda else "cpu"
        header["device_count"] = torch.cuda.device_count() if cuda else 1
        if meta:
            header.update(meta)
        self.write(header)
        _ensure_atexit()
        with _registry_lock:
            _live_logs.add(self)
        if compile_events:
            self._subscribe_compile_events()

    def _subscribe_compile_events(self):
        """Take the duration events of :func:`emit_event` (weakly held,
        dropped on close)."""
        with _registry_lock:
            _open_logs.add(self)

    def _on_monitoring_event(self, event, secs):
        # no closed-check here: write() takes the lock and no-ops on a
        # closed log, and an unlocked read of _closed would race close()
        try:
            self.write({"type": "event", "event": str(event),
                        "secs": round(float(secs), 6)})
        except Exception:
            pass

    def register_flops(self, flops_per_step):
        """Static FLOPs of one step; enables tflops/mfu_pct on step
        records."""
        self._flops = flops_per_step

    def write(self, record):
        """Append one raw record (a JSON-able dict with a ``type``)."""
        with self._lock:
            if self._closed:
                return
            self._fh.write(json.dumps(record) + "\n")
            self._unflushed += 1
            if self._unflushed >= self.flush_every:
                self._fh.flush()
                self._unflushed = 0

    def flush(self):
        """Force buffered records to disk NOW (``flush_every=N``
        batching holds up to N-1). The serving stop paths (engine/
        scheduler/router/fleet) call this for shared logs they do not
        own, and the atexit guard calls it for every still-open log —
        an engine stop or interpreter exit never costs records."""
        with self._lock:
            if self._closed:
                return
            self._fh.flush()
            self._unflushed = 0

    def log_step(self, step, wall_ms=None, cost=None, examples=None,
                 pass_id=None, batch_id=None, feed_ms=None, device_ms=None,
                 metrics=None):
        rec = {"type": "step", "step": int(step),
               "t": round(time.perf_counter() - self._t0, 4)}
        if pass_id is not None:
            rec["pass"] = int(pass_id)
        if batch_id is not None:
            rec["batch"] = int(batch_id)
        if wall_ms is not None:
            rec["wall_ms"] = round(float(wall_ms), 4)
        if feed_ms is not None:
            rec["feed_ms"] = round(float(feed_ms), 4)
        if cost is not None:
            rec["cost"] = round(float(cost), 6)
        if device_ms is not None:
            rec["device_ms"] = round(float(device_ms), 4)
        if examples is not None:
            rec["examples"] = int(examples)
            if wall_ms:
                rec["examples_per_sec"] = round(
                    examples / wall_ms * 1000.0, 2)
        lead_ms = device_ms if device_ms else wall_ms
        if self._flops and lead_ms:
            from paddle_tpu_torch.observe.attribution import achieved

            tflops, mfu = achieved(self._flops, lead_ms)
            if tflops is not None:
                rec["tflops"] = round(tflops, 2)
                rec["mfu_pct"] = round(mfu, 2)
        if metrics:
            rec["metrics"] = {k: float(v) for k, v in metrics.items()
                              if isinstance(v, (int, float))}
        self.write(rec)
        self._steps += 1

    def log_feed(self, step, stall_ms, convert_ms=None, examples=None,
                 depth=None, bucket=None, fill_tokens=None,
                 pad_tokens=None):
        """One pipelined input batch (data/feeder.py)."""
        rec = {"type": "feed", "step": int(step),
               "stall_ms": round(float(stall_ms), 4),
               "t": round(time.perf_counter() - self._t0, 4)}
        if convert_ms is not None:
            rec["convert_ms"] = round(float(convert_ms), 4)
        if examples is not None:
            rec["examples"] = int(examples)
        if depth is not None:
            rec["depth"] = int(depth)
        if bucket:
            rec["bucket"] = int(bucket)
        if fill_tokens is not None:
            rec["fill_tokens"] = int(fill_tokens)
        if pad_tokens is not None:
            rec["pad_tokens"] = int(pad_tokens)
        self.write(rec)

    def log_train_chunk(self, step, steps, pass_id=None, batch_id=None,
                        wall_ms=None, feed_ms=None, cost_first=None,
                        cost_last=None, examples=None):
        """One fused multi-step dispatch (trainer ``steps_per_call=K``);
        ``step`` is the chunk's FIRST global step, ``steps`` the number
        of real steps it fused."""
        rec = {"type": "train_chunk", "step": int(step),
               "steps": int(steps),
               "t": round(time.perf_counter() - self._t0, 4)}
        if pass_id is not None:
            rec["pass"] = int(pass_id)
        if batch_id is not None:
            rec["batch"] = int(batch_id)
        if wall_ms is not None:
            rec["wall_ms"] = round(float(wall_ms), 4)
        if feed_ms is not None:
            rec["feed_ms"] = round(float(feed_ms), 4)
        if cost_first is not None and math.isfinite(float(cost_first)):
            rec["cost_first"] = round(float(cost_first), 6)
        if cost_last is not None and math.isfinite(float(cost_last)):
            rec["cost_last"] = round(float(cost_last), 6)
        if examples is not None:
            rec["examples"] = int(examples)
            if wall_ms:
                rec["examples_per_sec"] = round(
                    examples / wall_ms * 1000.0, 2)
        self.write(rec)

    def log_serve_request(self, rows, queue_ms, latency_ms=None,
                          req_id=None):
        """One completed serving request (the serving engine)."""
        rec = {"type": "serve_request", "rows": int(rows),
               "queue_ms": round(float(queue_ms), 4),
               "t": round(time.perf_counter() - self._t0, 4)}
        if latency_ms is not None:
            rec["latency_ms"] = round(float(latency_ms), 4)
        if req_id is not None:
            rec["id"] = int(req_id)
        self.write(rec)

    def log_serve_batch(self, rows, bucket, infer_ms, batch_id=None,
                        pad_rows=None, requests=None, queue_ms_max=None,
                        flush=None, replica=None):
        """One batch the serving engine flushed to the device.
        ``replica`` identifies the fleet member that ran it (only
        written for replica-fleet engines, serve/fleet.py)."""
        rec = {"type": "serve_batch", "rows": int(rows),
               "bucket": int(bucket),
               "infer_ms": round(float(infer_ms), 4),
               "t": round(time.perf_counter() - self._t0, 4)}
        if batch_id is not None:
            rec["batch"] = int(batch_id)
        if pad_rows is not None:
            rec["pad_rows"] = int(pad_rows)
        if requests is not None:
            rec["requests"] = int(requests)
        if queue_ms_max is not None:
            rec["queue_ms_max"] = round(float(queue_ms_max), 4)
        if flush is not None:
            rec["flush"] = str(flush)
        if replica is not None:
            rec["replica"] = str(replica)
        self.write(rec)

    def log_serve_decode(self, iteration, active, window, infer_ms,
                         slots=None, steps=None, admitted=None,
                         retired=None, model=None, replica=None,
                         resident=None, suspended=None):
        """One continuous-batching decode dispatch
        (paddle_tpu.serve.scheduler). ``replica`` identifies the fleet
        member that ran it (serve/fleet.py); ``resident``/``suspended``
        are the session tier's in-slot vs paged-out session counts at
        dispatch time (docs/serving.md "Session tier & paging")."""
        rec = {"type": "serve_decode", "iteration": int(iteration),
               "active": int(active), "window": int(window),
               "infer_ms": round(float(infer_ms), 4),
               "t": round(time.perf_counter() - self._t0, 4)}
        if slots is not None:
            rec["slots"] = int(slots)
        if steps is not None:
            rec["steps"] = int(steps)
        if admitted is not None:
            rec["admitted"] = int(admitted)
        if retired is not None:
            rec["retired"] = int(retired)
        if model is not None:
            rec["model"] = str(model)
        if replica is not None:
            rec["replica"] = str(replica)
        if resident is not None:
            rec["resident"] = int(resident)
        if suspended is not None:
            rec["suspended"] = int(suspended)
        self.write(rec)

    def log_serve_swap(self, op, session, nbytes=None, overlap_ms=None,
                       reason=None, pos=None, model=None, replica=None):
        """One session-tier paging event (paddle_tpu.serve.scheduler /
        serve/sessions.py): ``op`` is ``spill`` (carry paged out to the
        host store; ``overlap_ms`` is the device->host copy time the
        next window dispatch absorbed), ``restore`` (carry paged back
        into a slot), ``evict`` (pushed out of the store —
        ``reason`` in capacity/ttl/error), or ``export``/``import``
        (cross-replica carry migration, serve/fleet.py)."""
        rec = {"type": "serve_swap", "op": str(op),
               "session": str(session),
               "t": round(time.perf_counter() - self._t0, 4)}
        if nbytes is not None:
            rec["bytes"] = int(nbytes)
        if overlap_ms is not None:
            rec["overlap_ms"] = round(float(overlap_ms), 4)
        if reason is not None:
            rec["reason"] = str(reason)
        if pos is not None:
            rec["pos"] = int(pos)
        if model is not None:
            rec["model"] = str(model)
        if replica is not None:
            rec["replica"] = str(replica)
        self.write(rec)

    def log_serve_trace(self, latency_ms, phases, trace_id=None,
                        span_id=None, model=None, replica=None,
                        req_id=None, rows=None, iterations=None,
                        session=None):
        """One SAMPLED request's end-to-end phase breakdown (request-
        scoped tracing): ``phases`` is {phase_name: ms} summing to
        ``latency_ms`` — the record ``cli observe`` aggregates into the
        tail-attribution report (docs/observability.md)."""
        rec = {"type": "serve_trace",
               "latency_ms": round(float(latency_ms), 4),
               "phases": {str(k): round(float(v), 4)
                          for k, v in phases.items()},
               "t": round(time.perf_counter() - self._t0, 4)}
        if trace_id is not None:
            rec["trace"] = str(trace_id)
        if span_id is not None:
            rec["span"] = str(span_id)
        if model is not None:
            rec["model"] = str(model)
        if replica is not None:
            rec["replica"] = str(replica)
        if req_id is not None:
            rec["id"] = int(req_id)
        if rows is not None:
            rec["rows"] = int(rows)
        if iterations is not None:
            rec["iterations"] = int(iterations)
        if session is not None:
            rec["session"] = str(session)
        self.write(rec)

    def log_serve_shed(self, model, reason, priority=None, queued=None):
        """One request rejected by serving admission control
        (paddle_tpu.serve.router / engine queue bounds)."""
        rec = {"type": "serve_shed", "model": str(model),
               "reason": str(reason),
               "t": round(time.perf_counter() - self._t0, 4)}
        if priority is not None:
            rec["priority"] = str(priority)
        if queued is not None:
            rec["queued"] = int(queued)
        self.write(rec)

    def log_slo_status(self, state, prev_state=None,
                       objective_p99_ms=None, availability=None,
                       current_p99_ms=None, fast_burn=None,
                       slow_burn=None, budget_remaining=None,
                       breaching_phase=None, worker=None, model=None):
        """One SLO state transition (observe/health.py SloMonitor) —
        written only when the burn-rate verdict CHANGES state, so the
        stream stays sparse under steady load."""
        rec = {"type": "slo_status", "state": str(state),
               "t": round(time.perf_counter() - self._t0, 4)}
        if prev_state is not None:
            rec["prev_state"] = str(prev_state)
        if objective_p99_ms is not None:
            rec["objective_p99_ms"] = round(float(objective_p99_ms), 4)
        if availability is not None:
            rec["availability"] = round(float(availability), 4)
        if current_p99_ms is not None:
            rec["current_p99_ms"] = round(float(current_p99_ms), 4)
        if fast_burn is not None:
            rec["fast_burn"] = round(float(fast_burn), 4)
        if slow_burn is not None:
            rec["slow_burn"] = round(float(slow_burn), 4)
        if budget_remaining is not None:
            rec["budget_remaining"] = round(float(budget_remaining), 4)
        if breaching_phase is not None:
            rec["breaching_phase"] = str(breaching_phase)
        if worker is not None:
            rec["worker"] = str(worker)
        if model is not None:
            rec["model"] = str(model)
        self.write(rec)

    def log_control_action(self, knob, old, new, reason,
                           breaching_phase=None, burn_rate_before=None,
                           rollback=None, model=None):
        """One knob move applied by the SLO controller
        (control/controller.py) — including reverts, which carry
        ``rollback: true``. ``reason`` is the play that fired
        (``shed_earlier``, ``spill_later``, ``tighten_deadline``,
        ``rollback``, ...); ``burn_rate_before`` is the fast burn the
        move was reacting to, so ``cli observe`` can print the
        knob-move timeline against the burn it was fighting."""
        rec = {"type": "control_action", "knob": str(knob),
               "old": float(old), "new": float(new),
               "reason": str(reason),
               "t": round(time.perf_counter() - self._t0, 4)}
        if breaching_phase is not None:
            rec["breaching_phase"] = str(breaching_phase)
        if burn_rate_before is not None:
            rec["burn_rate_before"] = round(float(burn_rate_before), 4)
        if rollback is not None:
            rec["rollback"] = bool(rollback)
        if model is not None:
            rec["model"] = str(model)
        self.write(rec)

    def log_checkpoint(self, step, duration_ms, nbytes=None,
                       overlapped=None, step_thread_ms=None, pass_id=None,
                       path=None):
        """One committed training checkpoint (distributed/checkpoint.py
        AsyncCheckpointer, or a blocking trainer save). ``duration_ms``
        is the full serialize+fsync+rename cost; ``step_thread_ms`` is
        the slice of it the STEP THREAD paid — the overlap evidence."""
        rec = {"type": "checkpoint", "step": int(step),
               "duration_ms": round(float(duration_ms), 4),
               "t": round(time.perf_counter() - self._t0, 4)}
        if nbytes is not None:
            rec["bytes"] = int(nbytes)
        if overlapped is not None:
            rec["overlapped"] = bool(overlapped)
        if step_thread_ms is not None:
            rec["step_thread_ms"] = round(float(step_thread_ms), 4)
        if pass_id is not None:
            rec["pass"] = int(pass_id)
        if path is not None:
            rec["path"] = str(path)
        self.write(rec)

    def log_anomaly(self, step, kind, cost=None, threshold=None,
                    mode=None, pass_id=None, chunk_index=None,
                    worker=None):
        """One sentinel trip (observe/sentinel.py). ``chunk_index`` is
        the offending step's position inside a fused chunk (trainer
        ``steps_per_call=``), when the trip came from a chunk scan;
        ``worker`` is the training-fleet worker id, so a multi-worker
        NaN names its process."""
        rec = {"type": "anomaly", "step": int(step), "kind": str(kind),
               "t": round(time.perf_counter() - self._t0, 4)}
        if cost is not None:
            rec["cost"] = cost if isinstance(cost, str) else float(cost)
        if threshold is not None:
            rec["threshold"] = round(float(threshold), 6)
        if mode is not None:
            rec["mode"] = str(mode)
        if pass_id is not None:
            rec["pass"] = int(pass_id)
        if chunk_index is not None:
            rec["chunk_index"] = int(chunk_index)
        if worker is not None:
            rec["worker"] = str(worker)
        self.write(rec)

    def log_crash_report(self, reason, steps, captured=None,
                         capacity=None, mode=None, anomaly=None,
                         artifact=None, suppressed_trips=None,
                         worker=None):
        """The flight-recorder black box: ``steps`` is the ring of the
        last N step records, oldest first (observe/sentinel.py)."""
        rec = {"type": "crash_report", "reason": str(reason),
               "steps": list(steps),
               "t": round(time.perf_counter() - self._t0, 4)}
        if captured is not None:
            rec["captured"] = int(captured)
        if capacity is not None:
            rec["capacity"] = int(capacity)
        if mode is not None:
            rec["mode"] = str(mode)
        if anomaly is not None:
            rec["anomaly"] = dict(anomaly)
        if artifact is not None:
            rec["artifact"] = str(artifact)
        if suppressed_trips:
            rec["suppressed_trips"] = int(suppressed_trips)
        if worker is not None:
            rec["worker"] = str(worker)
        self.write(rec)

    def log_elastic_event(self, kind, worker=None, members=None,
                          lost=None, checkpoint=None, step=None,
                          detail=None):
        """One elastic-fleet transition (distributed/elastic.py run
        loop / heartbeat, distributed/checkpoint.py commits):
        registration, lease trouble, membership loss, the rewind /
        re-deal recovery path, checkpoint commits, resume. ``members``
        is the membership snapshot AT the event, so the merged fleet
        timeline shows the fleet reshaping around a loss."""
        rec = {"type": "elastic_event", "kind": str(kind),
               "t": round(time.perf_counter() - self._t0, 4)}
        if worker is not None:
            rec["worker"] = str(worker)
        if members is not None:
            rec["members"] = [str(m) for m in members]
        if lost is not None:
            rec["lost"] = [str(m) for m in lost]
        if checkpoint is not None:
            rec["checkpoint"] = str(checkpoint)
        if step is not None:
            rec["step"] = int(step)
        if detail is not None:
            rec["detail"] = str(detail)
        self.write(rec)

    def log_serve_host_event(self, kind, host=None, hosts=None,
                             session=None, target=None, detail=None):
        """One serving-host membership transition seen by the
        fleet-of-fleets front (serve/cluster.py): ``join`` /
        ``lease_lost`` / ``excluded`` / ``session_rehome`` /
        ``rejoin`` — the serving twin of :meth:`log_elastic_event`.
        ``hosts`` is the membership snapshot AT the event; a
        ``session_rehome`` names the migrated session and its new
        home in ``session`` / ``target``."""
        rec = {"type": "serve_host_event", "kind": str(kind),
               "t": round(time.perf_counter() - self._t0, 4)}
        if host is not None:
            rec["host"] = str(host)
        if hosts is not None:
            rec["hosts"] = [str(h) for h in hosts]
        if session is not None:
            rec["session"] = str(session)
        if target is not None:
            rec["target"] = str(target)
        if detail is not None:
            rec["detail"] = str(detail)
        self.write(rec)

    def log_pass(self, pass_id, metrics=None):
        rec = {"type": "pass", "pass": int(pass_id),
               "t": round(time.perf_counter() - self._t0, 4)}
        if metrics:
            rec["metrics"] = {k: float(v) for k, v in metrics.items()
                              if isinstance(v, (int, float))}
        self.write(rec)

    def close(self):
        with _registry_lock:
            _open_logs.discard(self)
            _live_logs.discard(self)
        with self._lock:
            if self._closed:
                return
            self._fh.write(json.dumps({"type": "end",
                                       "steps": self._steps}) + "\n")
            self._closed = True
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(path):
    """Parse a steplog JSONL file into a list of record dicts.
    Undecodable lines are skipped, not fatal: a kill -9 can tear the
    final line of a dead worker's log mid-write, and the fleet report
    over a shared telemetry dir must still merge the survivors."""
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                continue
    return records


def _serve_replica_summary(records):
    """Per-replica serving view over one run's ``serve_batch``/
    ``serve_decode`` records: dispatches, completed requests, sustained
    qps over the replica's active span, and (decode) mean slot
    occupancy. Engines outside a fleet summarize under replica ``"-"``,
    so single-replica telemetry keeps the same shape."""
    per = {}
    for rec in records:
        rtype = rec.get("type")
        if rtype not in ("serve_batch", "serve_decode", "serve_swap"):
            continue
        d = per.setdefault(str(rec.get("replica", "-")),
                           {"dispatches": 0, "completed": 0, "occ": [],
                            "swaps": collections.Counter(),
                            "resident": None, "suspended": None,
                            "t0": None, "t1": None})
        if rtype == "serve_swap":
            # session-tier paging activity: spill/restore/evict counts
            # feed the swap rate `cli observe` prints. Swap records do
            # NOT extend t0/t1 — an idle-threshold spill minutes after
            # the last dispatch (or an export at shutdown) would
            # stretch the active span and deflate the reported qps
            d["swaps"][rec.get("op", "?")] += 1
            continue
        d["dispatches"] += 1
        if rtype == "serve_batch":
            d["completed"] += rec.get("requests", 0)
        elif rtype == "serve_decode":
            d["completed"] += rec.get("retired", 0)
            if rec.get("slots"):
                d["occ"].append(rec["active"] / rec["slots"])
            if "resident" in rec:
                d["resident"] = rec["resident"]
            if "suspended" in rec:
                d["suspended"] = rec["suspended"]
        t = rec.get("t")
        if t is not None:
            d["t0"] = t if d["t0"] is None else min(d["t0"], t)
            d["t1"] = t if d["t1"] is None else max(d["t1"], t)
    out = {}
    for key, d in sorted(per.items()):
        entry = {"dispatches": d["dispatches"],
                 "completed": d["completed"]}
        span = ((d["t1"] - d["t0"])
                if d["t0"] is not None and d["t1"] is not None else 0.0)
        if span > 0 and d["completed"]:
            entry["qps"] = round(d["completed"] / span, 2)
        if d["occ"]:
            entry["occupancy_mean"] = round(sum(d["occ"]) / len(d["occ"]),
                                            3)
        if d["swaps"]:
            entry["spills"] = d["swaps"].get("spill", 0)
            entry["restores"] = d["swaps"].get("restore", 0)
            entry["evictions"] = d["swaps"].get("evict", 0)
            swaps = entry["spills"] + entry["restores"]
            if span > 0 and swaps:
                entry["swap_per_s"] = round(swaps / span, 2)
        # resident-vs-suspended session counts (last dispatch's view)
        if d["resident"] is not None:
            entry["resident_sessions"] = d["resident"]
        if d["suspended"] is not None:
            entry["suspended_sessions"] = d["suspended"]
        out[key] = entry
    return out


def summarize_dir(directory):
    """Summary dict over every ``*.steps.jsonl`` in a telemetry directory
    (the ``cli observe`` command)."""
    import glob

    runs = []
    fleet_traced = {}  # base run name -> {worker index: [serve_trace]}
    host_traced = {}  # base run name -> {host id: [serve_trace]}
    train_workers = {}  # worker id -> pooled steady walls/steps/files
    elastic_events = []  # (meta unix_time, elastic_event record) pairs
    host_events = []  # (meta unix_time, serve_host_event record) pairs
    for path in sorted(glob.glob(os.path.join(directory, "*.steps.jsonl"))):
        records = read_jsonl(path)
        steps = [r for r in records if r.get("type") == "step"]
        meta = next((r for r in records if r.get("type") == "meta"), {})
        events = [r for r in records if r.get("type") == "event"]
        walls = [r["wall_ms"] for r in steps if "wall_ms" in r]
        chunks = [r for r in records if r.get("type") == "train_chunk"]
        if not walls and chunks:
            # fused runs (steps_per_call=K): per-step wall time is
            # unmeasurable, so amortize each chunk's interval over its
            # real steps — `cli observe` keeps its one-command step-time
            # view for exactly the dispatch-bound runs the fused loop
            # targets. The first chunk (compile) contributes ONE entry
            # so the steady tail (walls[1:]) excludes it, matching the
            # per-step path's first-record convention.
            walls = []
            for j, c in enumerate(chunks):
                if "wall_ms" not in c:
                    continue
                per = c["wall_ms"] / max(c["steps"], 1)
                walls.extend([per] if j == 0
                             else [per] * max(c["steps"], 1))
        run = {"file": os.path.basename(path),
               "run": meta.get("run"), "schema": meta.get("schema"),
               "backend": meta.get("backend"), "steps": len(steps),
               "compile_events": len(events),
               "event_secs_total": round(sum(r.get("secs", 0.0)
                                             for r in events), 3)}
        if walls:
            from paddle_tpu_torch.observe.metrics import percentile

            run["wall_ms_mean"] = round(sum(walls) / len(walls), 3)
            run["wall_ms_min"] = round(min(walls), 3)
            # steady state excludes the first record (includes compile)
            tail = walls[1:] or walls
            run["wall_ms_steady_mean"] = round(sum(tail) / len(tail), 3)
            # exact steady-state percentiles (same estimator as the
            # metrics-registry histograms): a mean hides the stragglers
            # a fleet pages on
            for q, key in ((50, "wall_ms_p50"), (95, "wall_ms_p95"),
                           (99, "wall_ms_p99")):
                run[key] = round(percentile(tail, q), 3)
        feeds = [r for r in records if r.get("type") == "feed"]
        stalls = [r["stall_ms"] for r in feeds if "stall_ms" in r]
        if stalls:
            from paddle_tpu_torch.observe.metrics import percentile

            # feed-bound visibility: stall percentiles print next to the
            # step time in `cli observe` so one command answers "is this
            # run input-bound?"
            run["feed_batches"] = len(stalls)
            run["feed_stall_ms_p50"] = round(percentile(stalls, 50), 3)
            run["feed_stall_ms_p95"] = round(percentile(stalls, 95), 3)
            pad = sum(r.get("pad_tokens", 0) for r in feeds)
            fill = sum(r.get("fill_tokens", 0) for r in feeds)
            if fill + pad:
                run["feed_padding_waste_pct"] = round(
                    100.0 * pad / (fill + pad), 2)
        if chunks:
            run["fused_chunks"] = len(chunks)
            spc = meta.get("steps_per_call")
            if spc is not None:
                run["steps_per_call"] = spc
        ckpts = [r for r in records if r.get("type") == "checkpoint"]
        if ckpts:
            from paddle_tpu_torch.observe.metrics import percentile

            durations = [r["duration_ms"] for r in ckpts]
            run["checkpoints"] = len(ckpts)
            run["checkpoint_ms_p95"] = round(percentile(durations, 95), 3)
            run["checkpoint_bytes_total"] = sum(r.get("bytes", 0)
                                                for r in ckpts)
            thread_ms = [r["step_thread_ms"] for r in ckpts
                         if "step_thread_ms" in r]
            if thread_ms:
                run["checkpoint_step_thread_ms_p95"] = round(
                    percentile(thread_ms, 95), 3)
        serve = _serve_replica_summary(records)
        if serve:
            run["serve_replicas"] = serve
        if (meta.get("worker") is not None
                and meta.get("phase") not in ("train", "elastic")):
            # per-worker steplog file of a multi-process WorkerSet
            # (<run>-w<i>.steps.jsonl): surface the worker index so
            # `cli observe` prints per-worker qps/occupancy next to the
            # per-replica lines
            run["serve_worker"] = meta.get("worker")
        if meta.get("phase") == "train" and meta.get("worker") is not None:
            # per-worker TRAINING steplog (<run>-t<i>.steps.jsonl,
            # observe/trainview.py): pool this file's steady-state
            # per-step walls under the fleet worker id — one worker can
            # own several files (a rewound run reopens with a -N
            # suffix), and the skew detector wants them all
            run["train_worker"] = meta.get("worker")
            d = train_workers.setdefault(
                str(meta.get("worker")),
                {"walls": [], "steps": 0, "examples": 0, "files": []})
            d["walls"].extend(walls[1:] or walls)
            d["steps"] += len(steps)
            # fused runs carry examples on the chunk, not the step
            d["examples"] += (sum(r.get("examples", 0) for r in steps)
                              or sum(c.get("examples", 0)
                                     for c in chunks))
            d["files"].append(os.path.basename(path))
        elastic = [r for r in records
                   if r.get("type") == "elastic_event"]
        if elastic:
            run["elastic_events"] = len(elastic)
            # stamp with this FILE's wall-clock epoch: each record's t
            # is relative to its own meta line, so cross-file ordering
            # needs the absolute base (observe/trainview.py)
            base_t = meta.get("unix_time") or 0.0
            elastic_events.extend((base_t, r) for r in elastic)
        hostev = [r for r in records
                  if r.get("type") == "serve_host_event"]
        if hostev:
            # serving-host membership timeline (serve/cluster.py): the
            # elastic-timeline treatment one level up — same
            # absolute-axis stamping, since each front/host file's t is
            # relative to its own meta line
            run["serve_host_events"] = len(hostev)
            base_t = meta.get("unix_time") or 0.0
            host_events.extend((base_t, r) for r in hostev)
        controls = [r for r in records
                    if r.get("type") == "control_action"]
        if controls:
            # the knob-move timeline: what the SLO controller did to
            # this run, in order — printed by `cli observe` next to the
            # tail-attribution report so "why did the tail recover"
            # has its answer on the same screen
            run["control_actions"] = [
                {k: r[k] for k in ("knob", "old", "new", "reason",
                                   "breaching_phase", "burn_rate_before",
                                   "rollback", "t") if k in r}
                for r in controls]
            run["control_rollbacks"] = sum(
                1 for r in controls if r.get("rollback"))
        traced = [r for r in records if r.get("type") == "serve_trace"]
        if traced:
            # tail attribution over the run's sampled request traces:
            # the phase histogram of the p99 — "where the p99's
            # milliseconds went" (docs/observability.md)
            from paddle_tpu_torch.observe.tracing import tail_attribution

            tail = tail_attribution(traced)
            if tail:
                run["serve_traces"] = len(traced)
                run["serve_tail"] = tail
        if meta.get("worker") is not None and traced:
            # stash this worker file's traces under the fleet's base
            # run name (<run>-w<i>): a per-file p99 is blind to the
            # fleet's true tail, so the report merges across workers
            # below before attributing
            import re

            base = str(meta.get("run") or os.path.basename(path))
            m = re.match(r"^(.*)-w(\d+)$", base)
            if m:
                base = m.group(1)
            fleet_traced.setdefault(base, {})[
                str(meta.get("worker"))] = traced
        if meta.get("host") is not None:
            run["serve_host"] = meta.get("host")
        if meta.get("host") is not None and traced:
            # per-HOST steplog of a multi-host serving cluster
            # (<run>@<host>.steps.jsonl, cli serve --join): the
            # per-worker merge pattern one level up — pool across
            # hosts before attributing the cluster's true tail
            import re

            base = str(meta.get("run") or os.path.basename(path))
            m = re.match(r"^(.*)@(.+)$", base)
            if m:
                base = m.group(1)
            host_traced.setdefault(base, {})[
                str(meta.get("host"))] = traced
        ex = [r["examples_per_sec"] for r in steps
              if "examples_per_sec" in r]
        if not ex:
            ex = [c["examples_per_sec"] for c in chunks
                  if "examples_per_sec" in c]
        if ex:
            run["examples_per_sec_best"] = round(max(ex), 2)
        costs = [r["cost"] for r in steps if "cost" in r]
        if costs:
            run["cost_first"] = costs[0]
            run["cost_last"] = costs[-1]
        runs.append(run)
    fleets = []
    for base in sorted(fleet_traced):
        # fleet-merged tail attribution: pool every worker file's
        # serve_trace records for one WorkerSet run, THEN take the p99
        # — each file in isolation reports its own (wrong) fleet p99
        from paddle_tpu_torch.observe.metrics import percentile

        by_worker = fleet_traced[base]
        merged = [r for recs in by_worker.values() for r in recs]
        from paddle_tpu_torch.observe.tracing import tail_attribution

        tail = tail_attribution(merged)
        if not tail:
            continue
        entry = {"run": base, "serve_traces": len(merged),
                 "serve_tail": tail, "workers": {}}
        for widx in sorted(by_worker, key=int):
            recs = by_worker[widx]
            lats = [r["latency_ms"] for r in recs if "latency_ms" in r]
            w = {"traces": len(recs)}
            if lats:
                w["p99_ms"] = round(percentile(lats, 99), 3)
            entry["workers"][widx] = w
        fleets.append(entry)
    clusters = []
    for base in sorted(host_traced):
        # cluster-merged tail attribution: every HOST file's
        # serve_trace records pooled before the p99 — the same
        # reasoning as the worker merge above, one level up (each
        # host's own p99 is blind to the cluster's true tail)
        from paddle_tpu_torch.observe.metrics import percentile

        by_host = host_traced[base]
        merged = [r for recs in by_host.values() for r in recs]
        from paddle_tpu_torch.observe.tracing import tail_attribution

        tail = tail_attribution(merged)
        if not tail:
            continue
        entry = {"run": base, "serve_traces": len(merged),
                 "serve_tail": tail, "hosts": {}}
        for hid in sorted(by_host):
            recs = by_host[hid]
            lats = [r["latency_ms"] for r in recs if "latency_ms" in r]
            h = {"traces": len(recs)}
            if lats:
                h["p99_ms"] = round(percentile(lats, 99), 3)
            entry["hosts"][hid] = h
        clusters.append(entry)
    traces = sorted(
        os.path.basename(p)
        for pat in ("*.json", "*.json.gz")
        for p in glob.glob(os.path.join(directory, pat))
        if not p.endswith(".steps.jsonl"))
    out = {"directory": directory, "runs": runs, "trace_files": traces}
    if fleets:
        out["fleets"] = fleets
    if clusters:
        out["serve_clusters"] = clusters
    if host_events:
        # the host membership timeline: join/lease_lost/excluded/
        # session_rehome/rejoin across every front/host file, on one
        # absolute axis (printed by `cli observe` next to the elastic
        # timeline)
        events = []
        for base_t, r in host_events:
            ev = {"t_abs": round(base_t + r.get("t", 0.0), 3),
                  "kind": r.get("kind")}
            for key in ("host", "hosts", "session", "target", "detail"):
                if key in r:
                    ev[key] = r[key]
            events.append(ev)
        events.sort(key=lambda e: e["t_abs"])
        rehomes = sum(1 for e in events if e["kind"] == "session_rehome")
        out["serve_hosts"] = {"events": events, "rehomes": rehomes}
    if train_workers or elastic_events:
        # the training-fleet block: per-worker step-time skew + the
        # straggler verdict + the merged elastic timeline
        from paddle_tpu_torch.observe import trainview

        fleet = trainview.fleet_summary(train_workers, elastic_events)
        if fleet:
            out["train_fleet"] = fleet
    return out
