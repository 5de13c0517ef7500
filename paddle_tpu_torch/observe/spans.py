"""Nested named spans with Chrome-trace export (paddle_tpu/observe/spans.py).

Host-side wall-time spans (reference: REGISTER_TIMER scopes,
paddle/utils/Stat.h:230-233), kept deliberately cheap: a span is one
``perf_counter`` pair plus an appended tuple, so the trainer can wrap
every batch phase without measurable overhead. Each closed span also
feeds the :data:`paddle_tpu_torch.utils.stat.global_stats` StatSet under
the span name, so ``PADDLE_TPU_TORCH_STATS=1`` per-pass dumps and the
exported trace can never disagree about what was measured.

Export is the Chrome trace-event JSON format ("X" complete events, µs
timestamps) — the file loads directly in Perfetto (ui.perfetto.dev) or
chrome://tracing. Spans opened on different threads land on different
trace rows; nesting within a thread is expressed by containment, which
holds by construction (a nested span closes before its parent).

An optional ``sync`` tensor (or nested dict/list of tensors) is
synchronized on (``torch.cuda.synchronize`` on its card) before the span
closes, so spans timing device work record real wall time, not the
enqueue's. A span wrapping a captured graph's replay passes no ``sync``:
the trainer adds no synchronize to a step.

A span may carry a request context (``trace=``, any object with
``sampled``, ``trace_id``, ``span_id`` and ``parent_id``): its ids land
in the span's args and the exporter links every span of one trace into
one flow-arrowed lane ("s"/"t"/"f" events) across threads, as the JAX
package's serving tier uses it. :meth:`SpanTracer.add_event` records a
span retrospectively from stamped timestamps.
"""

import json
import os
import threading
import time
from contextlib import contextmanager

from paddle_tpu_torch.utils.stat import global_stats, sync_tensors


class _Scope:
    """Handle yielded by :meth:`SpanTracer.span`; ``dur`` (seconds) is set
    when the span closes, so callers timing a window can reuse the span's
    own measurement instead of keeping a second clock."""

    __slots__ = ("name", "dur")

    def __init__(self, name):
        self.name = name
        self.dur = None


class SpanTracer:
    """Thread-safe span recorder. One process-global instance
    (:func:`get_tracer`) is shared by the trainer, the benchmark harness,
    and user code; sub-tracers are only needed for isolated tests."""

    MAX_EVENTS = 200_000  # hard cap; excess spans still feed stats

    def __init__(self, name="paddle_tpu_torch", stats=global_stats,
                 record_events=True):
        self.name = name
        self.enabled = True
        # record_events: True/False, or None = auto — record only while
        # PADDLE_TPU_TORCH_TELEMETRY is set (the process-global tracer uses
        # auto so a run with no possible trace consumer doesn't retain up
        # to MAX_EVENTS tuples in memory; consumers that WILL export —
        # the trainer/run.py telemetry paths — flip it to True)
        self.record_events = record_events
        self._lock = threading.Lock()
        # (name, t_start_s, dur_s, thread_ident, args, trace) — trace is
        # (trace_id, span_id, parent_id) or None
        self._events = []
        self._dropped = 0
        self._stats = stats
        self._t0 = time.perf_counter()

    def _recording(self):
        if self.record_events is None:
            return bool(os.environ.get("PADDLE_TPU_TORCH_TELEMETRY"))
        return self.record_events

    @contextmanager
    def span(self, name, sync=None, args=None, trace=None):
        """Time a scope. ``sync`` is an optional tensor (tree) whose card
        is synchronized before the span closes; ``args`` is a small
        JSON-able dict shown in the trace viewer; ``trace`` is an
        optional sampled request context linking this span into its
        request's cross-thread flow lane."""
        scope = _Scope(name)
        start = time.perf_counter()
        try:
            yield scope
        finally:
            if sync is not None:
                sync_tensors(sync)
            end = time.perf_counter()
            # a disabled tracer still stamps dur (callers like the trainer
            # and harness consume scope.dur arithmetically) — it only stops
            # recording events and feeding stats
            scope.dur = end - start
            if self.enabled:
                if self._stats is not None:
                    self._stats.get(name).add(scope.dur)
                if self._recording():
                    self._record(name, start, scope.dur,
                                 threading.get_ident(), args, trace)

    def _record(self, name, t_start, dur, ident, args, trace):
        """Append one event; ``t_start`` is absolute perf_counter time
        (made clock-relative under the lock, next to the ``_t0`` that
        reset() rewrites)."""
        tup = (None if trace is None or not trace.sampled
               else (trace.trace_id, trace.span_id, trace.parent_id))
        with self._lock:
            if len(self._events) < self.MAX_EVENTS:
                self._events.append((name, t_start - self._t0, dur,
                                     ident, args, tup))
            else:
                self._dropped += 1

    def add_event(self, name, t_start, dur, args=None, trace=None,
                  ident=None):
        """Record a span retrospectively from stamped timestamps
        (``t_start`` is an absolute ``time.perf_counter()`` value,
        ``dur`` seconds). The serving workers time request phases as
        plain perf_counter pairs on the hot path and emit the spans
        once, at completion — same stats feed, same export, no
        contextmanager overhead per phase."""
        dur = max(float(dur), 0.0)
        if not self.enabled:
            return
        if self._stats is not None:
            self._stats.get(name).add(dur)
        if self._recording():
            self._record(name, t_start, dur,
                         ident if ident is not None
                         else threading.get_ident(), args, trace)

    def instant(self, name, args=None):
        """Record a zero-duration marker (rendered as a thin slice)."""
        with self.span(name, args=args):
            pass

    def events(self):
        with self._lock:
            return list(self._events)

    def reset(self):
        """Drop recorded spans and restart the trace clock (the StatSet
        aggregates are owned by the StatSet and are NOT reset here)."""
        with self._lock:
            self._events = []
            self._dropped = 0
            self._t0 = time.perf_counter()

    def to_chrome_trace(self):
        """Chrome trace-event dict: ``{"traceEvents": [...]}`` with "X"
        complete events (ts/dur in µs) plus process/thread metadata.
        Trace-tagged spans additionally carry their trace/span/parent
        ids in args and are chained per trace_id with flow events
        ("s" start / "t" step / "f" finish, one flow id per trace) —
        Perfetto renders each request as one arrow-connected lane no
        matter how many threads it crossed."""
        pid = os.getpid()
        with self._lock:
            snapshot = list(self._events)
            dropped = self._dropped
        out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": self.name}}]
        tids = {}
        flows = {}  # trace_id -> [(ts_s, tid)]
        for name, ts, dur, ident, args, trace in snapshot:
            tid = tids.setdefault(ident, len(tids))
            ev = {"ph": "X", "name": name, "pid": pid, "tid": tid,
                  "ts": round(ts * 1e6, 3), "dur": round(dur * 1e6, 3)}
            if args or trace:
                ev["args"] = dict(args or {})
            if trace:
                trace_id, span_id, parent_id = trace
                ev["args"]["trace_id"] = trace_id
                ev["args"]["span_id"] = span_id
                if parent_id:
                    ev["args"]["parent_id"] = parent_id
                flows.setdefault(trace_id, []).append((ts, tid))
            out.append(ev)
        for trace_id, points in flows.items():
            if len(points) < 2:
                continue  # a single span needs no arrow
            points.sort()
            flow_id = int(trace_id[:15], 16)
            last = len(points) - 1
            for i, (ts, tid) in enumerate(points):
                ev = {"ph": "s" if i == 0 else ("f" if i == last
                                                else "t"),
                      "name": "serve_trace", "cat": "serve_trace",
                      "id": flow_id, "pid": pid, "tid": tid,
                      "ts": round(ts * 1e6, 3)}
                if ev["ph"] == "f":
                    ev["bp"] = "e"  # bind to the enclosing slice
                out.append(ev)
        for ident, tid in tids.items():
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid,
                        "args": {"name": "host thread %d" % tid}})
        trace = {"traceEvents": out, "displayTimeUnit": "ms"}
        if dropped:
            trace["metadata"] = {"dropped_spans": dropped}
        return trace

    def export(self, path):
        """Write the Chrome-trace JSON (gzipped when ``path`` ends in
        .gz); returns ``path``. Open the file in Perfetto or
        chrome://tracing."""
        data = self.to_chrome_trace()
        if path.endswith(".gz"):
            import gzip

            with gzip.open(path, "wt") as fh:
                json.dump(data, fh)
        else:
            with open(path, "w") as fh:
                json.dump(data, fh)
        return path


_global_tracer = SpanTracer(record_events=None)


def get_tracer():
    """The process-global tracer every subsystem shares."""
    return _global_tracer


def span(name, sync=None, args=None, trace=None):
    """Module-level shortcut: ``with observe.span("feed"): ...``."""
    return _global_tracer.span(name, sync=sync, args=args, trace=trace)


def export(path):
    return _global_tracer.export(path)
