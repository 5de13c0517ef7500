"""Process-wide metrics registry: counters, gauges, latency histograms
(paddle_tpu/observe/metrics.py).

A thread-safe registry of named instruments that the trainer (steps,
examples/s, loss), the feed pipeline (stall and convert histograms) and
the checkpoint writer update in place, rendered in two formats:

* :meth:`MetricsRegistry.to_prometheus` — Prometheus text exposition
  (version 0.0.4: ``# HELP``/``# TYPE`` headers, ``_bucket``/``_sum``/
  ``_count`` histogram series with cumulative ``le`` buckets) for
  scrapers;
* :meth:`MetricsRegistry.snapshot` — a JSON-able dict for tests and
  ``/stats``-style introspection.

The series names are the JAX package's (``paddle_tpu_train_steps_total``,
``paddle_tpu_data_feed_stall_ms``, ...), so a dashboard built for one
package reads the other, and the exposition of the same operations is
byte-identical (tests/golden/metrics_exposition.txt).

Histograms are fixed-bucket for the exposition AND keep a bounded
reservoir of raw observations for an exact in-process p50/p95/p99
readout.

This module is stdlib-only.
"""


import threading

# Default latency buckets in MILLISECONDS (the unit every latency metric
# in this codebase uses). Upper bounds; +Inf is implicit.
DEFAULT_LATENCY_BUCKETS_MS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)

# raw observations kept per histogram for the exact percentile readout;
# bounded so a long-lived server cannot grow without limit (the bucket
# counters remain exact forever — only the percentile window slides)
RESERVOIR_SIZE = 8192


def percentile(values, q):
    """Exact percentile of a sequence (linear interpolation between
    order statistics, numpy's default). ``q`` in [0, 100]. Returns None
    on an empty sequence. Shared by the histogram readout and the
    steplog step-time summary so the two can never disagree."""
    vals = sorted(values)
    if not vals:
        return None
    if len(vals) == 1:
        return float(vals[0])
    rank = (len(vals) - 1) * (q / 100.0)
    lo = int(rank)
    hi = min(lo + 1, len(vals) - 1)
    frac = rank - lo
    return float(vals[lo] * (1.0 - frac) + vals[hi] * frac)


def _fmt(value):
    """Prometheus sample value: integral floats render as integers so
    the exposition is stable across int/float call sites; non-finite
    values use the exposition spellings (NaN/+Inf/-Inf)."""
    if isinstance(value, float):
        if value != value:
            return "NaN"
        if value == float("inf"):
            return "+Inf"
        if value == float("-inf"):
            return "-Inf"
        if not value.is_integer():
            return repr(value)
    return str(int(value))


def _escape_label(value):
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels_suffix(labels, extra=None):
    items = list((labels or {}).items())
    if extra:
        items += list(extra.items())
    if not items:
        return ""
    inner = ",".join('%s="%s"' % (k, _escape_label(v))
                     for k, v in sorted(items))
    return "{%s}" % inner


class Counter:
    """Monotonically increasing count. ``inc()`` only goes up."""

    kind = "counter"

    def __init__(self, name, labels=None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counter %s cannot decrease (inc %r)"
                             % (self.name, amount))
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """A value that goes up and down (queue depth, in-flight, loss)."""

    kind = "gauge"

    def __init__(self, name, labels=None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        with self._lock:
            self._value -= amount

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with an exact-percentile reservoir.

    ``observe(v)`` is O(len(buckets)); the exposition renders cumulative
    ``le`` buckets plus ``_sum``/``_count``; :meth:`percentile` reads an
    exact quantile over the last :data:`RESERVOIR_SIZE` observations."""

    kind = "histogram"

    def __init__(self, name, buckets=DEFAULT_LATENCY_BUCKETS_MS,
                 labels=None):
        import collections

        self.name = name
        self.labels = dict(labels or {})
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram %s needs at least one bucket"
                             % name)
        self._lock = threading.Lock()
        self._bucket_counts = [0] * len(self.buckets)  # non-cumulative
        self._count = 0
        self._sum = 0.0
        self._recent = collections.deque(maxlen=RESERVOIR_SIZE)

    def observe(self, value):
        value = float(value)
        with self._lock:
            self._count += 1
            self._sum += value
            self._recent.append(value)
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self._bucket_counts[i] += 1
                    break

    def percentile(self, q):
        """Exact percentile over the recent-observation window (None
        when nothing has been observed)."""
        with self._lock:
            recent = list(self._recent)
        return percentile(recent, q)

    def percentiles(self):
        """{"p50": ..., "p95": ..., "p99": ...} — the readout the serve
        ``/stats`` endpoint and the regression gate consume."""
        with self._lock:
            recent = list(self._recent)
        return {"p50": percentile(recent, 50),
                "p95": percentile(recent, 95),
                "p99": percentile(recent, 99)}

    def state(self):
        """(count, sum, cumulative bucket counts) under one lock."""
        with self._lock:
            cumulative = []
            running = 0
            for c in self._bucket_counts:
                running += c
                cumulative.append(running)
            return self._count, self._sum, cumulative

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum


class MetricsRegistry:
    """Thread-safe get-or-create registry of instruments.

    One instrument per (name, labels) pair; re-requesting returns the
    SAME object, so independent call sites (two engines, the trainer and
    a test) share process-wide series. A name is bound to one kind —
    re-registering ``foo`` as a gauge after it was a counter is a bug
    and raises."""

    def __init__(self, name="paddle_tpu_torch"):
        self.name = name
        self._lock = threading.Lock()
        self._metrics = {}  # (name, labels_key) -> instrument
        self._kinds = {}    # name -> kind
        self._helps = {}    # name -> help string
        self._order = []    # family names in first-registration order

    def _get(self, cls, name, help, labels, **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            existing_kind = self._kinds.get(name)
            if existing_kind is not None and existing_kind != cls.kind:
                raise ValueError(
                    "metric %r already registered as a %s, cannot "
                    "re-register as a %s" % (name, existing_kind, cls.kind))
            inst = self._metrics.get(key)
            if inst is None:
                inst = cls(name, labels=labels, **kw)
                self._metrics[key] = inst
                if name not in self._kinds:
                    self._kinds[name] = cls.kind
                    self._order.append(name)
                if help and name not in self._helps:
                    self._helps[name] = help
            return inst

    def counter(self, name, help="", labels=None):
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help="", labels=None):
        return self._get(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=None,
                  buckets=DEFAULT_LATENCY_BUCKETS_MS):
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def _families(self):
        """[(name, kind, help, [instruments])] in registration order,
        instruments sorted by label set for a stable exposition."""
        with self._lock:
            metrics = dict(self._metrics)
            order = list(self._order)
            kinds = dict(self._kinds)
            helps = dict(self._helps)
        by_name = {}
        for (name, labels_key), inst in sorted(metrics.items()):
            by_name.setdefault(name, []).append(inst)
        return [(n, kinds[n], helps.get(n, ""), by_name.get(n, []))
                for n in order]

    def to_prometheus(self):
        """Prometheus text exposition (format version 0.0.4). Golden-
        guarded by tests/golden/metrics_exposition.txt — the format is a
        scrape contract, changed only with the golden."""
        lines = []
        for name, kind, help, instruments in self._families():
            if help:
                lines.append("# HELP %s %s"
                             % (name, help.replace("\n", " ")))
            lines.append("# TYPE %s %s" % (name, kind))
            for inst in instruments:
                if kind == "histogram":
                    count, total, cumulative = inst.state()
                    for bound, c in zip(inst.buckets, cumulative):
                        lines.append("%s_bucket%s %s" % (
                            name,
                            _labels_suffix(inst.labels, {"le": _fmt(bound)}),
                            c))
                    lines.append("%s_bucket%s %s" % (
                        name, _labels_suffix(inst.labels, {"le": "+Inf"}),
                        count))
                    lines.append("%s_sum%s %s" % (
                        name, _labels_suffix(inst.labels), _fmt(total)))
                    lines.append("%s_count%s %s" % (
                        name, _labels_suffix(inst.labels), count))
                else:
                    lines.append("%s%s %s" % (
                        name, _labels_suffix(inst.labels),
                        _fmt(inst.value)))
        return "\n".join(lines) + "\n"

    def snapshot(self):
        """JSON-able dict view: every series keyed by its full name
        (labels rendered Prometheus-style), histograms with count/sum
        and the exact percentile readout."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, kind, help, instruments in self._families():
            for inst in instruments:
                key = name + _labels_suffix(inst.labels)
                if kind == "counter":
                    out["counters"][key] = inst.value
                elif kind == "gauge":
                    out["gauges"][key] = inst.value
                else:
                    count, total, cumulative = inst.state()
                    entry = {"count": count, "sum": round(total, 6),
                             "buckets": {_fmt(b): c for b, c in
                                         zip(inst.buckets, cumulative)}}
                    entry.update({k: (round(v, 6) if v is not None
                                      else None)
                                  for k, v in inst.percentiles().items()})
                    out["histograms"][key] = entry
        return out

    def dump_series(self):
        """JSON-able dump of every family — the cross-process transfer
        format: a serving worker process ships this over the control
        RPC and the router re-renders it (with an injected ``worker``
        label) through :func:`merged_exposition`, so one ``/metrics``
        scrape covers the whole multi-process fleet. Histograms travel
        as (count, sum, cumulative buckets); values stay exact."""
        out = []
        for name, kind, help, instruments in self._families():
            series = []
            for inst in instruments:
                if kind == "histogram":
                    count, total, cumulative = inst.state()
                    series.append({
                        "labels": dict(inst.labels),
                        "count": count, "sum": total,
                        "buckets": [[b, c] for b, c in
                                    zip(inst.buckets, cumulative)]})
                else:
                    series.append({"labels": dict(inst.labels),
                                   "value": inst.value})
            out.append({"name": name, "kind": kind, "help": help,
                        "series": series})
        return out

    def reset(self):
        """Drop every instrument (tests only — live instruments held by
        callers keep working but detach from the exposition)."""
        with self._lock:
            self._metrics.clear()
            self._kinds.clear()
            self._helps.clear()
            self._order = []


def merged_exposition(registry, extras=()):
    """Prometheus text exposition of ``registry`` merged with remote
    :meth:`MetricsRegistry.dump_series` snapshots.

    ``extras`` is ``[(families_dump, extra_labels), ...]`` — each dump
    typically one worker process's registry, each ``extra_labels``
    typically ``{"worker": "<i>"}``. Families merge by name (local
    registration order first, dump-only families appended in arrival
    order); series within a family sort by label set, the same stable
    order :meth:`MetricsRegistry.to_prometheus` renders, and with no
    extras the output is byte-identical to ``to_prometheus()`` (pinned
    by the exposition golden's merged variant)."""
    import collections

    families = collections.OrderedDict()

    def _add(dump, extra_labels=None):
        for fam in dump:
            entry = families.setdefault(
                fam["name"], {"kind": fam["kind"],
                              "help": fam.get("help", ""),
                              "series": []})
            if entry["kind"] != fam["kind"]:
                continue  # cross-process kind clash: first wins
            if not entry["help"] and fam.get("help"):
                entry["help"] = fam["help"]
            for series in fam.get("series", ()):
                labels = dict(series.get("labels") or {})
                if extra_labels:
                    labels.update(extra_labels)
                entry["series"].append(dict(series, labels=labels))

    _add(registry.dump_series())
    for dump, extra_labels in extras:
        _add(dump, extra_labels)
    lines = []
    for name, entry in families.items():
        if entry["help"]:
            lines.append("# HELP %s %s"
                         % (name, entry["help"].replace("\n", " ")))
        lines.append("# TYPE %s %s" % (name, entry["kind"]))
        ordered = sorted(entry["series"],
                         key=lambda s: tuple(sorted(s["labels"].items())))
        for series in ordered:
            labels = series["labels"]
            if entry["kind"] == "histogram":
                for bound, c in series["buckets"]:
                    lines.append("%s_bucket%s %s" % (
                        name,
                        _labels_suffix(labels, {"le": _fmt(float(bound))}),
                        int(c)))
                lines.append("%s_bucket%s %s" % (
                    name, _labels_suffix(labels, {"le": "+Inf"}),
                    int(series["count"])))
                lines.append("%s_sum%s %s" % (
                    name, _labels_suffix(labels),
                    _fmt(float(series["sum"]))))
                lines.append("%s_count%s %s" % (
                    name, _labels_suffix(labels), int(series["count"])))
            else:
                lines.append("%s%s %s" % (
                    name, _labels_suffix(labels),
                    _fmt(float(series["value"]))))
    return "\n".join(lines) + "\n"


def slo_gauges(registry=None):
    """Register (idempotently) the ``paddle_tpu_slo_*`` gauge family the
    SLO monitor publishes into: declared p99 objective, current merged
    p99, fast/slow burn rates, error-budget remaining, and the state
    enum (-1 no objective declared, 0 ok, 1 burning, 2 breached).
    Returns the instruments keyed by short name so the monitor sets
    them without re-registering per verdict."""
    reg = registry if registry is not None else _global_registry
    return {
        "objective_p99_ms": reg.gauge(
            "paddle_tpu_slo_objective_p99_ms",
            help="declared p99 latency objective (ms)"),
        "current_p99_ms": reg.gauge(
            "paddle_tpu_slo_current_p99_ms",
            help="fleet-merged p99 latency over the fast window (ms)"),
        "burn_fast": reg.gauge(
            "paddle_tpu_slo_burn_rate",
            help="error-budget burn rate per evaluation window",
            labels={"window": "fast"}),
        "burn_slow": reg.gauge(
            "paddle_tpu_slo_burn_rate",
            help="error-budget burn rate per evaluation window",
            labels={"window": "slow"}),
        "budget_remaining": reg.gauge(
            "paddle_tpu_slo_budget_remaining",
            help="fraction of the slow-window error budget left"),
        "state": reg.gauge(
            "paddle_tpu_slo_state",
            help="SLO state (-1 no objective, 0 ok, 1 burning, "
                 "2 breached)"),
    }


def control_instruments(registry=None, knob=""):
    """Register (idempotently) the ``paddle_tpu_control_*`` families the
    SLO controller (control/controller.py) mirrors its knob moves onto:
    a per-knob action counter, a per-knob gauge holding the value the
    last move installed, and a rollback counter — the thrash alarm (a
    rising rollback rate means the controller is fighting its own
    moves). Returns the instruments keyed by short name, bound to the
    given ``knob`` label."""
    reg = registry if registry is not None else _global_registry
    labels = {"knob": str(knob)} if knob else None
    return {
        "actions": reg.counter(
            "paddle_tpu_control_actions_total",
            help="knob moves applied by the SLO controller",
            labels=labels),
        "knob_value": reg.gauge(
            "paddle_tpu_control_knob",
            help="knob value installed by the last controller move",
            labels=labels),
        "rollbacks": reg.counter(
            "paddle_tpu_control_rollbacks_total",
            help="controller moves reverted by the rollback guard",
            labels=labels),
    }


def build_info(registry=None):
    """Register (idempotently) the ``paddle_tpu_build_info`` info-gauge:
    value is always 1, the payload is the label set — ``version``
    (package), ``torch_version`` (where the JAX package writes
    ``jax_version``) and ``schema`` (steplog schema version), so one
    scrape answers "what exactly is this process running"."""
    reg = registry if registry is not None else _global_registry
    import paddle_tpu_torch
    import torch

    from paddle_tpu_torch.observe.steplog import SCHEMA_VERSION

    g = reg.gauge("paddle_tpu_build_info",
                  help="build/version info (value is always 1)",
                  labels={"version": str(paddle_tpu_torch.__version__),
                          "torch_version": str(torch.__version__),
                          "schema": str(SCHEMA_VERSION)})
    g.set(1)
    return g


_global_registry = MetricsRegistry()


def get_registry():
    """The process-global registry every subsystem shares (the serving
    engine and trainer default to it; pass an explicit registry for
    isolation in tests)."""
    return _global_registry
