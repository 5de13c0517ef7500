"""Request-scoped distributed tracing for the serving tier
(docs/observability.md "Request tracing & tail attribution").

The serving path is a chain of thread hops — HTTP handler thread →
router → fleet dispatch → engine/scheduler worker → spill writer — and
no thread-local or ambient context survives a queue handoff. So the
trace context here travels **by value**: a :class:`TraceContext` is
minted (or adopted from an inbound W3C ``traceparent`` header) at the
front door, threaded through every ``submit(..., trace=...)`` and
queue tuple explicitly, and stamped onto the spans each hop records
(``observe_spans.span(..., trace=ctx)`` / ``add_event``). The span
exporter then links every span of one trace into a single flow-arrowed
lane across threads in Perfetto (observe/spans.py).

Three pieces:

* **TraceContext** — ``trace_id`` (32 hex) + ``span_id`` (16 hex) +
  ``parent_id``, W3C-traceparent-shaped (``00-<trace>-<span>-<flags>``).
  ``child()`` mints a sub-span context; each serving layer records its
  own child so the parent chain reconstructs the request tree.
* **Sampling** — ``PADDLE_TPU_TORCH_TRACE_SAMPLE=<rate>`` (0..1, default 0)
  decides per request whether the full trace machinery runs (spans,
  ``serve_trace`` steplog record). An inbound ``traceparent`` with the
  sampled flag forces tracing for that request regardless of the rate —
  the "trace THIS request" debugging hook. The decision is made ONCE
  at the outermost entry (HTTP front end, or the engine itself on
  direct submits) and propagates; :data:`NOT_SAMPLED` marks "decided:
  no" so inner layers never re-roll the dice.
* **Exemplars** — phase timings are collected for EVERY request (a few
  perf_counter stamps — cheap enough to keep always-on) and offered to
  a bounded slowest-N reservoir, surfaced at ``GET /debug/traces``: the
  worst requests of the last while keep their phase breakdown even at
  sample rate 0.

:func:`tail_attribution` is the offline half: over a telemetry dir's
sampled ``serve_trace`` records it answers "where did the p99's
milliseconds go" — the phase histogram of the slowest requests
(``cli observe`` prints it).
"""

import heapq
import os
import random
import threading
import time
import uuid

_rng_lock = threading.Lock()
_rng = random.Random()
_sampled_count = 0


class TraceContext:
    """One request's identity in the distributed trace: W3C-shaped
    ``trace_id``/``span_id`` plus the parent span id. Immutable;
    crossing a thread means passing the object (or a :meth:`child`)
    by value — never via closure capture (the PTA009 rule)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "sampled")

    def __init__(self, trace_id, span_id, parent_id=None, sampled=True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled

    @classmethod
    def mint(cls):
        """A fresh sampled root context."""
        return cls(uuid.uuid4().hex, uuid.uuid4().hex[:16])

    @classmethod
    def from_traceparent(cls, header):
        """Parse a W3C ``traceparent`` header (``00-<32 hex>-<16 hex>-
        <2 hex flags>``); returns None when absent/malformed. The
        caller's span id becomes our ``parent_id``; the sampled flag
        (bit 0) is honored — an explicitly unsampled header stays
        unsampled here too. Per the spec, a FUTURE version (non-00,
        non-ff) may append extra fields — the leading four parse,
        the rest is ignored; version 00 must have exactly four."""
        if not header:
            return None
        parts = str(header).strip().split("-")
        if len(parts) < 4:
            return None
        version, trace_id, parent, flags = parts[:4]
        if version == "00" and len(parts) != 4:
            return None
        if (len(trace_id) != 32 or len(parent) != 16
                or len(version) != 2 or len(flags) != 2):
            return None
        joined = version + trace_id + parent + flags
        # W3C: lowercase hex only, and version ff is explicitly invalid
        if joined != joined.lower():
            return None
        try:
            int(joined, 16)
        except ValueError:
            return None
        if version == "ff":
            return None
        if set(trace_id) == {"0"} or set(parent) == {"0"}:
            return None  # all-zero ids are invalid per the spec
        return cls(trace_id, uuid.uuid4().hex[:16], parent_id=parent,
                   sampled=bool(int(flags, 16) & 1))

    def traceparent(self):
        """The outbound/echoed ``traceparent`` value for THIS span."""
        return "00-%s-%s-%02x" % (self.trace_id, self.span_id,
                                  1 if self.sampled else 0)

    def child(self):
        """A sub-span context: same trace, fresh span id, this span as
        parent — each serving layer records its own child."""
        return TraceContext(self.trace_id, uuid.uuid4().hex[:16],
                            parent_id=self.span_id, sampled=self.sampled)

    def __repr__(self):
        return "TraceContext(%s/%s)" % (self.trace_id, self.span_id)


# the "decided: do not trace" sentinel — a front door that rolled the
# dice and lost passes this down so inner layers don't re-roll
NOT_SAMPLED = TraceContext(None, None, sampled=False)


def sample_rate():
    """The live ``PADDLE_TPU_TORCH_TRACE_SAMPLE`` rate in [0, 1] (0 when
    unset/unparseable — tracing costs nothing by default)."""
    raw = os.environ.get("PADDLE_TPU_TORCH_TRACE_SAMPLE")
    if not raw:
        return 0.0
    try:
        return min(max(float(raw), 0.0), 1.0)
    except ValueError:
        return 0.0


def sample():
    """Roll the per-request dice: a fresh root context with probability
    ``sample_rate()``, else None."""
    rate = sample_rate()
    if rate <= 0.0:
        return None
    global _sampled_count
    with _rng_lock:
        if _rng.random() >= rate:
            return None
        _sampled_count += 1
    return TraceContext.mint()


def sampled_count():
    """Traces started by :func:`sample` process-wide (bench gate:
    tracing-on must actually trace)."""
    with _rng_lock:
        return _sampled_count


def resolve(trace):
    """The ONE sampling-decision point every engine entry shares:
    ``None`` = no upstream decision (sample here), :data:`NOT_SAMPLED`
    or an unsampled context = decided no, a sampled context = use it.
    Returns a TraceContext or None."""
    if trace is None:
        return sample()
    if not getattr(trace, "sampled", False):
        return None
    return trace


class TraceExemplars:
    """Bounded slowest-N reservoir of per-request phase breakdowns —
    the always-on half of tail attribution: even at sample rate 0 the
    worst requests keep their phase story (``GET /debug/traces``)."""

    def __init__(self, capacity=16):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._heap = []  # (latency_ms, seq, entry) min-heap
        self._seq = 0
        self._offered = 0

    def offer(self, latency_ms, phases, model=None, replica=None,
              trace_id=None, session=None):
        """O(log N) on admission, O(1) rejection for the common
        fast-request case."""
        latency_ms = float(latency_ms)
        with self._lock:
            self._offered += 1
            if len(self._heap) >= self.capacity \
                    and latency_ms <= self._heap[0][0]:
                return
            entry = {"latency_ms": round(latency_ms, 4),
                     "phases": {k: round(float(v), 4)
                                for k, v in phases.items()},
                     "t": round(time.time(), 3)}
            if model is not None:
                entry["model"] = str(model)
            if replica is not None:
                entry["replica"] = str(replica)
            if trace_id is not None:
                entry["trace"] = str(trace_id)
            if session is not None:
                entry["session"] = str(session)
            self._seq += 1
            item = (latency_ms, self._seq, entry)
            if len(self._heap) >= self.capacity:
                heapq.heapreplace(self._heap, item)
            else:
                heapq.heappush(self._heap, item)

    def slowest(self):
        """Entries, slowest first."""
        with self._lock:
            items = sorted(self._heap, reverse=True)
        return [entry for _, _, entry in items]

    def stats(self):
        with self._lock:
            return {"offered": self._offered, "kept": len(self._heap)}

    def reset(self):
        with self._lock:
            self._heap = []
            self._offered = 0


_global_exemplars = TraceExemplars()


def get_exemplars():
    """The process-global reservoir every serving engine feeds."""
    return _global_exemplars


def trace_state():
    """The sampling/exemplar state ``/stats`` reports."""
    ex = _global_exemplars.stats()
    return {"sample_rate": sample_rate(), "sampled": sampled_count(),
            "exemplars_offered": ex["offered"],
            "exemplars_kept": ex["kept"]}


def debug_traces():
    """The ``GET /debug/traces`` body: sampling state + the slowest-N
    exemplar entries (phase breakdowns), slowest first."""
    state = trace_state()
    state["slowest"] = _global_exemplars.slowest()
    return state


def tail_attribution(records, q=99.0):
    """Where the tail's milliseconds went: over ``serve_trace`` records
    (or exemplar entries — anything with ``latency_ms`` + ``phases``),
    take the requests at/above the ``q``-th latency percentile and
    average their per-phase share. Returns None without records, else
    ``{"q", "threshold_ms", "requests", "tail_requests",
    "phases": {phase: mean_pct}}`` — the "p99 is 80% queue-wait" vs
    "80% spill-restore" answer ``cli observe`` prints."""
    from paddle_tpu_torch.observe.metrics import percentile

    rows = [r for r in records
            if "latency_ms" in r and isinstance(r.get("phases"), dict)]
    if not rows:
        return None
    lats = [float(r["latency_ms"]) for r in rows]
    threshold = percentile(lats, q)
    tail = [r for r in rows if float(r["latency_ms"]) >= threshold]
    shares = {}
    for r in tail:
        total = sum(float(v) for v in r["phases"].values())
        if total <= 0:
            continue
        for k, v in r["phases"].items():
            shares.setdefault(k, []).append(float(v) / total)
    phases = {k: round(100.0 * sum(v) / len(v), 1)
              for k, v in sorted(shares.items()) if v}
    return {"q": q, "threshold_ms": round(threshold, 3),
            "requests": len(rows), "tail_requests": len(tail),
            "phases": phases}
