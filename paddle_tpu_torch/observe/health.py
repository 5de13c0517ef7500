"""Fleet-wide SLO observability plane: windowed health history,
burn-rate SLO monitor, cross-process trace/history aggregation
(paddle_tpu/observe/health.py, kept as the port's own copy: pure Python).
The cross-process half (``_worker_replies``) fans a verb out to each live
worker of a worker fleet (serve/workers.py) over its RPC.

Three layers, landed as the sensing half of the ROADMAP's "self-tuning
serving" direction — the controller that will someday move knobs needs
a trustworthy, fleet-wide answer to "how healthy is serving RIGHT NOW
and how fast is the error budget burning":

* **HealthHistory** — a ring of fixed-size time windows (default 1 s
  buckets x 5 min horizon, O(1) memory forever) over the serving tier's
  always-on per-request host stamps: per-window request count, latency
  sum/max + a bounded latency sample reservoir (exact until
  ``samples_per_window`` requests land in one window, stride-sampled
  after), shed counts by reason, queue depth (window max), slot
  occupancy (window mean) and per-phase latency sums. Every engine
  front (InferenceEngine, ContinuousScheduler, ReplicaSet members,
  WorkerSet router/worker halves) records into ONE process-global
  history (:func:`get_history`, the :func:`~paddle_tpu_torch.observe.tracing
  .get_exemplars` pattern); a single mutex makes snapshots torn-read
  free and cumulative totals monotone. Recording is pure host floats —
  no device value is ever touched on this path (the PTA001 contract;
  ``observe/health.py`` is lint-hot).

* **SloMonitor** — declared objectives (``cli serve --slo-p99-ms N
  [--slo-availability PCT]``) evaluated as multi-window burn rates a la
  SRE error budgets: a request is BAD when it was shed or finished over
  the latency objective; ``burn = bad_fraction / (1 - availability)``
  over a fast (default 1 m) and a slow (default 15 m, clamped to the
  history horizon) window. ``burn > 1`` means the budget is being spent
  faster than it accrues (``burning``); ``fast burn >= breach_burn``
  (default 14.4, the SRE page-now threshold) means ``breached``.
  Verdicts surface at ``GET /debug/slo``, as ``paddle_tpu_slo_*``
  gauges in ``/metrics``, and as an additive schema-v1 ``slo_status``
  steplog record on every state transition.

* **Cross-process aggregation** — :func:`collect_traces` /
  :func:`collect_history` are the ONE merge path all three serving
  fronts share: the process-local exemplar reservoir + history always
  contribute (single engine and ReplicaSet live entirely here), and a
  front that exposes ``workers()`` handles (WorkerSet) additionally
  fans the ``traces`` / ``history`` control-RPC verbs out to its live
  worker processes, stamping ``{worker=}`` provenance onto every
  merged exemplar. A dead or silent worker degrades the merge to a
  partial result (``"partial": true``) instead of erroring the scrape.
"""

import os
import threading
import time

# -- the windowed time-series layer ------------------------------------------

_WINDOW_FIELDS = ("requests", "lat_sum", "lat_max", "shed", "samples",
                  "phases", "queue_depth", "occ_sum", "occ_n")


def _env_float(name, default):
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class HealthHistory:
    """Ring-buffered per-window serving health, O(1) memory.

    ``window_s`` buckets x ``horizon_s`` of look-back; windows older
    than the horizon are overwritten in place (the ring never grows).
    All mutation and snapshotting runs under one mutex: a snapshot can
    never observe a half-written window, and the cumulative totals it
    carries are monotone across successive snapshots."""

    def __init__(self, window_s=1.0, horizon_s=300.0,
                 samples_per_window=64, enabled=True):
        self.window_s = float(window_s)
        self.horizon_s = float(horizon_s)
        self.samples_per_window = int(samples_per_window)
        if self.window_s <= 0 or self.horizon_s < self.window_s:
            raise ValueError(
                "want 0 < window_s <= horizon_s, got %r / %r"
                % (window_s, horizon_s))
        self._n = max(int(round(self.horizon_s / self.window_s)), 1)
        self._lock = threading.Lock()
        self._ring = [self._fresh(-1) for _ in range(self._n)]
        self._enabled = bool(enabled)
        self._total_requests = 0
        self._total_shed = 0
        self._total_latency_ms = 0.0

    @staticmethod
    def _fresh(epoch):
        return {"epoch": epoch, "requests": 0, "lat_sum": 0.0,
                "lat_max": 0.0, "shed": {}, "samples": [], "phases": {},
                "queue_depth": 0, "occ_sum": 0.0, "occ_n": 0}

    def ring_len(self):
        """Fixed ring capacity (the bounded-memory pin)."""
        return self._n

    @property
    def enabled(self):
        return self._enabled

    def set_enabled(self, flag):
        """Cheap global on/off (the health-overhead A/B's off side)."""
        self._enabled = bool(flag)

    def _win(self, t):
        # caller holds the lock
        epoch = int(t / self.window_s)
        w = self._ring[epoch % self._n]
        if w["epoch"] != epoch:
            # horizon wraparound: reclaim the slot in place
            w.update(self._fresh(epoch))
        return w

    def record_request(self, latency_ms, phases=None, t=None):
        """One completed request: host-float latency + optional
        per-phase breakdown (the engine fences pass the same dict they
        offer to the exemplar reservoir)."""
        if not self._enabled:
            return
        latency_ms = float(latency_ms)
        if t is None:
            t = time.time()
        with self._lock:
            w = self._win(t)
            w["requests"] += 1
            w["lat_sum"] += latency_ms
            if latency_ms > w["lat_max"]:
                w["lat_max"] = latency_ms
            samples = w["samples"]
            if len(samples) < self.samples_per_window:
                samples.append(latency_ms)
            else:
                # deterministic stride replacement keeps the reservoir
                # bounded without an RNG on the hot path; quantiles
                # stay exact until a window overflows the cap
                samples[w["requests"] % self.samples_per_window] = \
                    latency_ms
            if phases:
                sums = w["phases"]
                for k, v in phases.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
            self._total_requests += 1
            self._total_latency_ms += latency_ms

    def record_shed(self, reason, t=None):
        """One request rejected by admission control, keyed by reason
        (``queue_full`` / ``pressure`` / ``no_replica``)."""
        if not self._enabled:
            return
        if t is None:
            t = time.time()
        reason = str(reason)
        with self._lock:
            w = self._win(t)
            w["shed"][reason] = w["shed"].get(reason, 0) + 1
            self._total_shed += 1

    def record_queue_depth(self, depth, t=None):
        """Queue depth at a submit/flush point (window max)."""
        if not self._enabled:
            return
        if t is None:
            t = time.time()
        depth = int(depth)
        with self._lock:
            w = self._win(t)
            if depth > w["queue_depth"]:
                w["queue_depth"] = depth

    def record_occupancy(self, fraction, t=None):
        """Decode slot occupancy at a dispatch (window mean)."""
        if not self._enabled:
            return
        if t is None:
            t = time.time()
        with self._lock:
            w = self._win(t)
            w["occ_sum"] += float(fraction)
            w["occ_n"] += 1

    def snapshot(self, now=None):
        """Torn-read-free copy of the live horizon, JSON-able (it
        crosses the worker control RPC): non-empty windows sorted by
        epoch plus the monotone cumulative totals."""
        if now is None:
            now = time.time()
        floor = int(now / self.window_s) - self._n
        with self._lock:
            windows = []
            for w in self._ring:
                if w["epoch"] <= floor or (
                        not w["requests"] and not w["shed"]
                        and not w["occ_n"] and not w["queue_depth"]):
                    continue
                c = dict(w)
                c["shed"] = dict(w["shed"])
                c["samples"] = list(w["samples"])
                c["phases"] = dict(w["phases"])
                windows.append(c)
            totals = {"requests": self._total_requests,
                      "shed": self._total_shed,
                      "latency_ms_sum": round(self._total_latency_ms, 4)}
        windows.sort(key=lambda w: w["epoch"])
        return {"window_s": self.window_s, "horizon_s": self.horizon_s,
                "windows": windows, "totals": totals}

    def reset(self):
        with self._lock:
            self._ring = [self._fresh(-1) for _ in range(self._n)]
            self._total_requests = 0
            self._total_shed = 0
            self._total_latency_ms = 0.0


_global_history = None
_history_lock = threading.Lock()


def get_history():
    """The process-global history every serving engine records into
    (the :func:`~paddle_tpu_torch.observe.tracing.get_exemplars` pattern).
    Knobs: ``PADDLE_TPU_TORCH_HEALTH_WINDOW_S`` / ``PADDLE_TPU_TORCH_HEALTH_
    HORIZON_S`` size the ring at first use; ``PADDLE_TPU_TORCH_HEALTH=0``
    starts it disabled (recording becomes a no-op flag check)."""
    global _global_history
    if _global_history is None:
        with _history_lock:
            if _global_history is None:
                _global_history = HealthHistory(
                    window_s=_env_float("PADDLE_TPU_TORCH_HEALTH_WINDOW_S",
                                        1.0),
                    horizon_s=_env_float("PADDLE_TPU_TORCH_HEALTH_HORIZON_S",
                                         300.0),
                    enabled=os.environ.get("PADDLE_TPU_TORCH_HEALTH", "1")
                    != "0")
    return _global_history


def set_enabled(flag):
    """Toggle the process-global history (the bench A/B switch)."""
    get_history().set_enabled(flag)


# -- merge + windowed aggregation --------------------------------------------

def merge_history(snapshots):
    """Fold per-process :meth:`HealthHistory.snapshot` dicts into one
    fleet view: same-epoch windows sum (wall-clock epochs align across
    processes because every recorder buckets ``time.time()`` by the
    same ``window_s``)."""
    snapshots = [s for s in snapshots if s]
    if not snapshots:
        return {"window_s": 1.0, "horizon_s": 0.0, "windows": [],
                "totals": {"requests": 0, "shed": 0,
                           "latency_ms_sum": 0.0}}
    by_epoch = {}
    totals = {"requests": 0, "shed": 0, "latency_ms_sum": 0.0}
    for snap in snapshots:
        t = snap.get("totals", {})
        totals["requests"] += int(t.get("requests", 0))
        totals["shed"] += int(t.get("shed", 0))
        totals["latency_ms_sum"] += float(t.get("latency_ms_sum", 0.0))
        for w in snap.get("windows", ()):
            m = by_epoch.get(w["epoch"])
            if m is None:
                m = HealthHistory._fresh(w["epoch"])
                by_epoch[w["epoch"]] = m
            m["requests"] += int(w.get("requests", 0))
            m["lat_sum"] += float(w.get("lat_sum", 0.0))
            m["lat_max"] = max(m["lat_max"],
                               float(w.get("lat_max", 0.0)))
            for reason, n in (w.get("shed") or {}).items():
                m["shed"][reason] = m["shed"].get(reason, 0) + int(n)
            m["samples"].extend(w.get("samples") or ())
            for k, v in (w.get("phases") or {}).items():
                m["phases"][k] = m["phases"].get(k, 0.0) + float(v)
            m["queue_depth"] = max(m["queue_depth"],
                                   int(w.get("queue_depth", 0)))
            m["occ_sum"] += float(w.get("occ_sum", 0.0))
            m["occ_n"] += int(w.get("occ_n", 0))
    first = snapshots[0]
    return {"window_s": first.get("window_s", 1.0),
            "horizon_s": max(float(s.get("horizon_s", 0.0))
                             for s in snapshots),
            "windows": sorted(by_epoch.values(),
                              key=lambda w: w["epoch"]),
            "totals": totals}


def window_stats(snapshot, seconds, now=None, objective_ms=None):
    """Aggregate a (possibly merged) snapshot over its trailing
    ``seconds``: request/shed counts, qps, p50/p99 from the window
    sample reservoirs, phase means, queue-depth max, occupancy mean,
    and — when ``objective_ms`` is given — the BAD fraction (shed +
    over-objective) burn-rate evaluation feeds on."""
    from paddle_tpu_torch.observe.metrics import percentile

    if now is None:
        now = time.time()
    window_s = float(snapshot.get("window_s", 1.0)) or 1.0
    floor = int(now / window_s) - max(int(round(seconds / window_s)), 1)
    requests = shed = depth = 0
    lat_sum = occ_sum = 0.0
    occ_n = 0
    samples = []
    shed_by = {}
    phases = {}
    for w in snapshot.get("windows", ()):
        if w["epoch"] <= floor:
            continue
        requests += w["requests"]
        lat_sum += w["lat_sum"]
        samples.extend(w["samples"])
        for reason, n in w["shed"].items():
            shed_by[reason] = shed_by.get(reason, 0) + n
            shed += n
        for k, v in w["phases"].items():
            phases[k] = phases.get(k, 0.0) + v
        depth = max(depth, w["queue_depth"])
        occ_sum += w["occ_sum"]
        occ_n += w["occ_n"]
    out = {"seconds": float(seconds), "requests": requests,
           "shed": shed, "shed_by_reason": shed_by,
           "qps": round(requests / float(seconds), 3),
           "queue_depth_max": depth}
    if requests:
        out["latency_ms_mean"] = round(lat_sum / requests, 3)
    if samples:
        out["p50_ms"] = round(percentile(samples, 50), 3)
        out["p99_ms"] = round(percentile(samples, 99), 3)
    if occ_n:
        out["occupancy_mean"] = round(occ_sum / occ_n, 4)
    if phases and requests:
        out["phase_ms_mean"] = {k: round(v / requests, 3)
                                for k, v in sorted(phases.items())}
    if objective_ms is not None:
        over = sum(1 for s in samples if s > float(objective_ms))
        # the reservoir is exact until a window overflows its cap;
        # past that, scale the sampled over-objective share up to the
        # window's true request count
        over_est = (over if len(samples) >= requests
                    else over * (requests / float(len(samples) or 1)))
        total = requests + shed
        out["bad"] = round(min(over_est + shed, total), 3)
        out["bad_fraction"] = round(out["bad"] / total, 6) if total \
            else 0.0
    return out


# -- cross-process aggregation (the ONE merge path) --------------------------

def _worker_replies(fronts, op, key, timeout=2.0):
    """Fan a control-RPC verb out to every front that has worker
    processes (a WorkerSet's ``workers()``); fronts without them add
    nothing here, their telemetry lives in this process's globals. Best
    effort: a dead or silent worker sets ``partial`` instead of
    raising."""
    replies, partial = [], False
    for front in fronts:
        workers_fn = getattr(front, "workers", None)
        if workers_fn is None:
            continue
        try:
            handles = workers_fn()
        except Exception:  # noqa: BLE001 — a stopping fleet stays scrapeable
            partial = True
            continue
        for handle in handles:
            if handle.dead():
                partial = True
                continue
            reply = handle.try_rpc({"op": op}, timeout=timeout)
            if not reply or reply.get(key) is None:
                partial = True
                continue
            replies.append((str(handle.index), reply[key]))
    return replies, partial


def collect_traces(fronts):
    """Fleet-merged ``GET /debug/traces``: the process-local exemplar
    reservoir plus every live worker's (``traces`` RPC verb), each
    worker entry stamped ``{worker=}``, re-sorted slowest-first.
    The same function serves all three fronts — single engine and
    ReplicaSet are purely local (their engines share this process's
    reservoir and stamp ``replica=`` themselves), WorkerSet adds the
    RPC fan-out."""
    from paddle_tpu_torch.observe import tracing

    state = tracing.trace_state()
    slowest = [dict(e) for e in tracing.get_exemplars().slowest()]
    replies, partial = _worker_replies(fronts, "traces", "traces")
    workers = []
    for widx, dump in replies:
        workers.append(widx)
        state["sampled"] += int(dump.get("sampled", 0))
        state["exemplars_offered"] += int(
            dump.get("exemplars_offered", 0))
        state["exemplars_kept"] += int(dump.get("exemplars_kept", 0))
        for entry in dump.get("slowest", ()):
            slowest.append(dict(entry, worker=widx))
    slowest.sort(key=lambda e: -float(e.get("latency_ms", 0.0)))
    state["slowest"] = slowest
    state["workers"] = sorted(workers, key=int)
    state["partial"] = partial
    return state


def collect_history(fronts, history=None):
    """Fleet-merged health history: the process-local snapshot plus
    every live worker's (``history`` RPC verb), folded by
    :func:`merge_history`. ``history`` overrides the process global
    (tests inject synthetic rings)."""
    local = (history if history is not None else get_history())
    snaps = [local.snapshot()]
    replies, partial = _worker_replies(fronts, "history", "history")
    workers = []
    for widx, snap in replies:
        workers.append(widx)
        snaps.append(snap)
    merged = merge_history(snaps)
    merged["workers"] = sorted(workers, key=int)
    merged["partial"] = partial
    return merged


# -- the burn-rate SLO monitor -----------------------------------------------

_STATE_VALUES = {"no_objective": -1, "ok": 0, "burning": 1, "breached": 2}


class SloMonitor:
    """Multi-window burn-rate evaluation of declared serving
    objectives over the merged fleet history.

    ``fronts`` is the list of serving fronts to aggregate across (the
    HTTP server's engines); ``p99_ms`` / ``availability`` are the
    declared objectives (no objective -> every verdict reports state
    ``no_objective`` but the current-health numbers still flow).
    ``evaluate()`` is cheap and safe to call per scrape; ``start()``
    runs it on a daemon-thread cadence so state transitions (and their
    ``slo_status`` steplog records + ``paddle_tpu_slo_*`` gauges)
    happen even when nobody is scraping."""

    def __init__(self, fronts=(), p99_ms=None, availability=None,
                 fast_s=60.0, slow_s=900.0, breach_burn=14.4,
                 registry=None, slog=None, model=None,
                 interval_s=5.0, history=None):
        self._fronts = list(fronts)
        self.p99_ms = None if p99_ms is None else float(p99_ms)
        self._availability_set = availability is not None
        self.availability = (99.0 if availability is None
                             else float(availability))
        if not 0.0 < self.availability < 100.0:
            raise ValueError("availability must be in (0, 100), got %r"
                             % availability)
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.breach_burn = float(breach_burn)
        self.model = model
        self._history = history
        self._slog = slog
        self._gauges = None
        if registry is not None:
            from paddle_tpu_torch.observe.metrics import slo_gauges

            self._gauges = slo_gauges(registry)
        self._interval_s = float(interval_s)
        self._lock = threading.Lock()
        self._last_state = None
        self.evaluations = 0
        self._stop_evt = threading.Event()
        self._thread = None

    @property
    def active(self):
        """True when an objective was actually declared."""
        return self.p99_ms is not None or self._availability_set

    def evaluate(self, now=None):
        """One verdict over the merged fleet history + exemplars:
        objective, current health, fast/slow burn rates, budget
        remaining, breaching phase/worker from tail attribution —
        the ``GET /debug/slo`` body."""
        from paddle_tpu_torch.observe.tracing import tail_attribution

        if now is None:
            now = time.time()
        history = collect_history(self._fronts, history=self._history)
        traces = collect_traces(self._fronts)
        objective_ms = self.p99_ms
        fast = window_stats(history, self.fast_s, now=now,
                            objective_ms=objective_ms)
        slow_s = min(self.slow_s, history.get("horizon_s") or self.slow_s)
        slow = window_stats(history, slow_s, now=now,
                            objective_ms=objective_ms)
        budget = 1.0 - self.availability / 100.0
        verdict = {
            "objective": {"p99_ms": objective_ms,
                          "availability_pct": self.availability,
                          "declared": self.active},
            "windows": {"fast_s": self.fast_s, "slow_s": slow_s},
            "current": fast,
            "slow": slow,
            "totals": history["totals"],
            "workers": history.get("workers", []),
            "partial": bool(history.get("partial")
                            or traces.get("partial")),
        }
        if not self.active:
            state = "no_objective"
            verdict["burn_rates"] = {"fast": 0.0, "slow": 0.0}
            verdict["budget_remaining"] = 1.0
        else:
            fast_burn = (fast.get("bad_fraction", 0.0) / budget
                         if fast["requests"] + fast["shed"] else 0.0)
            slow_burn = (slow.get("bad_fraction", 0.0) / budget
                         if slow["requests"] + slow["shed"] else 0.0)
            verdict["burn_rates"] = {"fast": round(fast_burn, 3),
                                     "slow": round(slow_burn, 3)}
            # the slow window IS the budget period here: remaining =
            # the share of its error budget not yet spent
            verdict["budget_remaining"] = round(
                max(0.0, 1.0 - slow_burn), 4)
            if fast_burn >= self.breach_burn:
                state = "breached"
            elif fast_burn > 1.0 or slow_burn > 1.0:
                state = "burning"
            else:
                state = "ok"
        verdict["state"] = state
        # tail attribution over the MERGED exemplars: which phase (and,
        # cross-process, which worker) owns the tail milliseconds
        tail = tail_attribution(traces.get("slowest") or ())
        if tail and tail["phases"]:
            phase = max(tail["phases"].items(), key=lambda kv: kv[1])
            verdict["breaching_phase"] = phase[0]
            verdict["tail"] = tail
            owners = {}
            threshold = tail["threshold_ms"]
            for entry in traces["slowest"]:
                if float(entry.get("latency_ms", 0.0)) < threshold:
                    continue
                who = entry.get("worker")
                if who is not None:
                    owners[who] = owners.get(who, 0) + 1
            if owners:
                verdict["breaching_worker"] = max(
                    owners.items(), key=lambda kv: (kv[1], kv[0]))[0]
        with self._lock:
            self.evaluations += 1
            prev = self._last_state
            self._last_state = state
        self._publish(verdict, state, prev)
        return verdict

    def _publish(self, verdict, state, prev):
        try:
            if self._gauges is not None:
                g = self._gauges
                if self.p99_ms is not None:
                    g["objective_p99_ms"].set(self.p99_ms)
                current = verdict["current"].get("p99_ms")
                if current is not None:
                    g["current_p99_ms"].set(current)
                g["burn_fast"].set(verdict["burn_rates"]["fast"])
                g["burn_slow"].set(verdict["burn_rates"]["slow"])
                g["budget_remaining"].set(verdict["budget_remaining"])
                g["state"].set(_STATE_VALUES.get(state, -1))
            # transitions only; the first verdict emits unless it is a
            # boring initial "ok" (a monitor that comes up already
            # burning/breached must say so)
            emit = (self._slog is not None
                    and state != "no_objective" and state != prev
                    and not (prev is None and state == "ok"))
            if emit:
                self._slog.log_slo_status(
                    state=state, prev_state=prev,
                    objective_p99_ms=self.p99_ms,
                    availability=self.availability,
                    current_p99_ms=verdict["current"].get("p99_ms"),
                    fast_burn=verdict["burn_rates"]["fast"],
                    slow_burn=verdict["burn_rates"]["slow"],
                    budget_remaining=verdict["budget_remaining"],
                    breaching_phase=verdict.get("breaching_phase"),
                    worker=verdict.get("breaching_worker"),
                    model=self.model)
        except Exception:  # noqa: BLE001 — lose telemetry, not the scrape
            from paddle_tpu_torch.utils.logger import logger

            logger.exception("slo verdict publication failed")

    def start(self):
        """Evaluate on a daemon-thread cadence (``interval_s``)."""
        if self._thread is not None:
            return self
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="slo-monitor", daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop_evt.wait(self._interval_s):
            try:
                self.evaluate()
            except Exception:  # noqa: BLE001 — the monitor must outlive a bad scrape
                from paddle_tpu_torch.utils.logger import logger

                logger.exception("periodic slo evaluation failed")

    def stop(self, close_slog=False):
        self._stop_evt.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
        if close_slog and self._slog is not None:
            try:
                self._slog.close()
            except Exception:  # noqa: BLE001 — shutdown best-effort
                pass
