"""Training-fleet observability plane (paddle_tpu/observe/trainview.py):
per-worker health history, cross-worker step-time skew / straggler
detection, and the elastic event timeline.

* **TrainHealthHistory** — fixed 1 s windows over a bounded horizon,
  O(1) memory, ONE mutex over mutate+snapshot, over the trainer's
  per-step finalize stream: step count, step-time sum/max + a bounded
  step-time sample reservoir, examples, feed-stall and
  checkpoint-overhead milliseconds, fused chunk counts. One
  process-global instance (:func:`get_train_history`) sized by
  ``PADDLE_TPU_TORCH_HEALTH_WINDOW_S`` / ``PADDLE_TPU_TORCH_HEALTH_HORIZON_S``
  and disabled by ``PADDLE_TPU_TORCH_HEALTH=0``.

* **Worker identity** — one env channel, ``PADDLE_TPU_TORCH_TRAIN_WORKER``
  (``trainer-<i>``): the trainer threads it into the steplog run name
  (``train-t<i>``, :func:`worker_run_name`), the steplog meta
  (``worker``), the sentinel's records and the training metric labels.

* **Fleet aggregation** — :func:`fleet_summary` is the merge path
  ``cli observe`` uses over a shared telemetry directory: per-worker
  step-time skew (worker p95 / fleet-pooled median,
  :func:`step_time_skew`), the straggler (:func:`find_straggler`), and
  the ``elastic_event`` records of every file as one absolute-time
  ordered timeline (:func:`assemble_timeline`). Per-worker skew mirrors
  to the ``paddle_tpu_train_step_skew`` gauge.
"""

import os
import re
import threading
import time

WORKER_ENV = "PADDLE_TPU_TORCH_TRAIN_WORKER"

# a worker whose p95 step time exceeds the fleet-pooled median by this
# factor is named the straggler (SRE rule of thumb: meaningfully past
# the cluster-boundary noise of a 2-worker pooled median)
DEFAULT_SKEW_THRESHOLD = 1.25

ELASTIC_EVENT_KINDS = ("register", "lease_renew_fail", "self_lease_lost",
                       "worker_lost", "rewind", "re_deal",
                       "checkpoint_commit", "resume")


def worker_id():
    """This process's training-fleet worker id (the coordinator lease
    id, e.g. ``trainer-0``) or None outside a fleet. One env channel —
    ``PADDLE_TPU_TORCH_TRAIN_WORKER`` — so the trainer, sentinel and
    checkpoint writer all agree without signature changes."""
    wid = os.environ.get(WORKER_ENV)
    wid = wid.strip() if wid else ""
    return wid or None


def worker_index(wid=None):
    """The numeric index inside a worker id's trailing digits
    (``trainer-3`` -> 3), or None when the id carries none."""
    if wid is None:
        wid = worker_id()
    if wid is None:
        return None
    m = re.search(r"(\d+)$", str(wid))
    return int(m.group(1)) if m else None


def worker_run_name(base, wid=None):
    """Per-worker steplog run name: ``<base>-t<i>`` (the serve tier's
    ``-w<i>`` convention, trainer-flavored) so each fleet member lands
    on its own ``<dir>/<base>-t<i>.steps.jsonl``. Falls back to the
    sanitized id when the id carries no trailing index."""
    if wid is None:
        wid = worker_id()
    if wid is None:
        return base
    idx = worker_index(wid)
    tag = str(idx) if idx is not None else re.sub(r"[^A-Za-z0-9_.-]",
                                                  "_", str(wid))
    return "%s-t%s" % (base, tag)


def _env_float(name, default):
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class TrainHealthHistory:
    """Ring-buffered per-window training health, O(1) memory — the
    JAX package's observe/health.py ``HealthHistory``
    pattern with train-shaped windows (steps instead of requests).

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
        self._total_steps = 0
        self._total_examples = 0
        self._total_step_ms = 0.0

    @staticmethod
    def _fresh(epoch):
        return {"epoch": epoch, "steps": 0, "step_ms_sum": 0.0,
                "step_ms_max": 0.0, "samples": [], "examples": 0,
                "feed_stall_ms": 0.0, "ckpt_ms": 0.0, "ckpts": 0,
                "chunks": 0, "chunk_steps": 0}

    def ring_len(self):
        """Fixed ring capacity (the bounded-memory pin)."""
        return self._n

    @property
    def enabled(self):
        return self._enabled

    def set_enabled(self, flag):
        """Cheap global on/off (the recorder-overhead A/B's off side)."""
        self._enabled = bool(flag)

    def _win(self, t):
        # caller holds the lock
        epoch = int(t / self.window_s)
        w = self._ring[epoch % self._n]
        if w["epoch"] != epoch:
            # horizon wraparound: reclaim the slot in place
            w.update(self._fresh(epoch))
        return w

    def _record_locked(self, w, step_ms, steps, examples, feed_stall_ms):
        # caller holds the lock; shared by the per-step and chunked
        # recorders so the two loop shapes can never diverge
        w["steps"] += steps
        w["step_ms_sum"] += step_ms
        per = step_ms / steps
        if per > w["step_ms_max"]:
            w["step_ms_max"] = per
        samples = w["samples"]
        if len(samples) < self.samples_per_window:
            samples.append(per)
        else:
            # deterministic stride replacement keeps the reservoir
            # bounded without an RNG on the hot path (health.py idiom)
            samples[w["steps"] % self.samples_per_window] = per
        if examples is not None:
            w["examples"] += int(examples)
            self._total_examples += int(examples)
        if feed_stall_ms is not None:
            w["feed_stall_ms"] += float(feed_stall_ms)
        self._total_steps += steps
        self._total_step_ms += step_ms

    def record_step(self, step_ms, examples=None, feed_stall_ms=None,
                    t=None):
        """One finalized training step: host-float wall interval plus
        the optional examples / feed-stall milliseconds the finalize
        path already holds."""
        if not self._enabled:
            return
        step_ms = float(step_ms)
        if t is None:
            t = time.time()
        with self._lock:
            self._record_locked(self._win(t), step_ms, 1, examples,
                                feed_stall_ms)

    def record_chunk(self, steps, wall_ms, examples=None,
                     feed_stall_ms=None, t=None):
        """One fused multi-step dispatch (trainer ``steps_per_call=K``):
        the chunk's wall interval amortized over its real steps — the
        same convention the steplog summary uses, so fused and per-step
        fleets compare on one scale."""
        if not self._enabled:
            return
        steps = max(int(steps), 1)
        wall_ms = float(wall_ms)
        if t is None:
            t = time.time()
        with self._lock:
            w = self._win(t)
            self._record_locked(w, wall_ms, steps, examples,
                                feed_stall_ms)
            w["chunks"] += 1
            w["chunk_steps"] += steps

    def record_checkpoint(self, ms, t=None):
        """Checkpoint overhead the STEP THREAD paid at one cadence hit
        (the jitted snapshot clone + handoff for overlapped saves, the
        whole save for blocking ones)."""
        if not self._enabled:
            return
        if t is None:
            t = time.time()
        with self._lock:
            w = self._win(t)
            w["ckpt_ms"] += float(ms)
            w["ckpts"] += 1

    def snapshot(self, now=None):
        """Torn-read-free copy of the live horizon, JSON-able (it can
        cross a control RPC): non-empty windows sorted by epoch plus
        the monotone cumulative totals."""
        if now is None:
            now = time.time()
        floor = int(now / self.window_s) - self._n
        with self._lock:
            windows = []
            for w in self._ring:
                if w["epoch"] <= floor or (
                        not w["steps"] and not w["ckpts"]):
                    continue
                c = dict(w)
                c["samples"] = list(w["samples"])
                windows.append(c)
            totals = {"steps": self._total_steps,
                      "examples": self._total_examples,
                      "step_ms_sum": round(self._total_step_ms, 4)}
        windows.sort(key=lambda w: w["epoch"])
        return {"window_s": self.window_s, "horizon_s": self.horizon_s,
                "worker": worker_id(), "windows": windows,
                "totals": totals}

    def reset(self):
        with self._lock:
            self._ring = [self._fresh(-1) for _ in range(self._n)]
            self._total_steps = 0
            self._total_examples = 0
            self._total_step_ms = 0.0


_global_history = None
_history_lock = threading.Lock()


def get_train_history():
    """The process-global history the trainer records into (the
    JAX package's health.py ``get_history`` pattern,
    same knobs: ``PADDLE_TPU_TORCH_HEALTH_WINDOW_S`` /
    ``PADDLE_TPU_TORCH_HEALTH_HORIZON_S`` size the ring at first use;
    ``PADDLE_TPU_TORCH_HEALTH=0`` starts it disabled)."""
    global _global_history
    if _global_history is None:
        with _history_lock:
            if _global_history is None:
                _global_history = TrainHealthHistory(
                    window_s=_env_float("PADDLE_TPU_TORCH_HEALTH_WINDOW_S",
                                        1.0),
                    horizon_s=_env_float("PADDLE_TPU_TORCH_HEALTH_HORIZON_S",
                                         300.0),
                    enabled=os.environ.get("PADDLE_TPU_TORCH_HEALTH", "1")
                    != "0")
    return _global_history


def set_enabled(flag):
    """Toggle the process-global history (the bench A/B switch)."""
    get_train_history().set_enabled(flag)


def merge_train_history(snapshots):
    """Fold per-process :meth:`TrainHealthHistory.snapshot` dicts into
    one fleet view: same-epoch windows sum (wall-clock epochs align
    across processes because every recorder buckets ``time.time()`` by
    the same ``window_s``)."""
    snapshots = [s for s in snapshots if s]
    if not snapshots:
        return {"window_s": 1.0, "horizon_s": 0.0, "windows": [],
                "totals": {"steps": 0, "examples": 0,
                           "step_ms_sum": 0.0}}
    by_epoch = {}
    totals = {"steps": 0, "examples": 0, "step_ms_sum": 0.0}
    for snap in snapshots:
        t = snap.get("totals", {})
        totals["steps"] += int(t.get("steps", 0))
        totals["examples"] += int(t.get("examples", 0))
        totals["step_ms_sum"] += float(t.get("step_ms_sum", 0.0))
    for snap in snapshots:
        for w in snap.get("windows", ()):
            m = by_epoch.get(w["epoch"])
            if m is None:
                m = TrainHealthHistory._fresh(w["epoch"])
                by_epoch[w["epoch"]] = m
            m["steps"] += int(w.get("steps", 0))
            m["step_ms_sum"] += float(w.get("step_ms_sum", 0.0))
            m["step_ms_max"] = max(m["step_ms_max"],
                                   float(w.get("step_ms_max", 0.0)))
            m["samples"].extend(w.get("samples") or ())
            m["examples"] += int(w.get("examples", 0))
            m["feed_stall_ms"] += float(w.get("feed_stall_ms", 0.0))
            m["ckpt_ms"] += float(w.get("ckpt_ms", 0.0))
            m["ckpts"] += int(w.get("ckpts", 0))
            m["chunks"] += int(w.get("chunks", 0))
            m["chunk_steps"] += int(w.get("chunk_steps", 0))
    first = snapshots[0]
    return {"window_s": first.get("window_s", 1.0),
            "horizon_s": max(float(s.get("horizon_s", 0.0))
                             for s in snapshots),
            "windows": sorted(by_epoch.values(),
                              key=lambda w: w["epoch"]),
            "totals": totals}


# -- cross-worker skew + straggler detection ---------------------------------

def step_time_skew(walls_by_worker):
    """Per-worker step-time skew over a fleet's pooled per-step wall
    times: ``skew = worker p95 / fleet median``, where the median is
    taken over EVERY worker's steady-state samples pooled together —
    the fleet's own notion of normal, not any one worker's. Returns
    ``{"fleet_median_ms", "workers": {id: {"steps", "p50_ms", "p95_ms",
    "skew"}}}`` or None when nothing is measurable."""
    from paddle_tpu_torch.observe.metrics import percentile

    pooled = [w for walls in walls_by_worker.values() for w in walls]
    median = percentile(pooled, 50)
    if not median:
        return None
    out = {}
    for wid, walls in sorted(walls_by_worker.items()):
        if not walls:
            continue
        p95 = percentile(walls, 95)
        out[str(wid)] = {"steps": len(walls),
                         "p50_ms": round(percentile(walls, 50), 3),
                         "p95_ms": round(p95, 3),
                         "skew": round(p95 / median, 3)}
    if not out:
        return None
    return {"fleet_median_ms": round(median, 3), "workers": out}


def find_straggler(skew, threshold=DEFAULT_SKEW_THRESHOLD):
    """Name the straggler: the max-skew worker of a >=2-worker fleet,
    when its skew clears ``threshold``. Returns ``(worker_id, skew)``
    or None — a single-worker run has no one to straggle behind."""
    workers = (skew or {}).get("workers") or {}
    if len(workers) < 2:
        return None
    wid = max(workers, key=lambda w: workers[w]["skew"])
    value = workers[wid]["skew"]
    return (wid, value) if value >= float(threshold) else None


# -- elastic event timeline --------------------------------------------------

def assemble_timeline(events):
    """One absolute-time-ordered elastic timeline out of per-file
    ``elastic_event`` records: ``events`` is an iterable of
    ``(unix_base, record)`` pairs, where ``unix_base`` is the owning
    steplog's ``meta.unix_time`` (each record's ``t`` is relative to
    its own file's meta, so filenames alone cannot order a fleet).
    Returns records copied with an absolute ``at`` stamp, sorted."""
    timeline = []
    for base, rec in events:
        entry = dict(rec)
        entry["at"] = round(float(base or 0.0) + float(rec.get("t", 0.0)),
                            3)
        timeline.append(entry)
    timeline.sort(key=lambda e: (e["at"], str(e.get("worker") or "")))
    return timeline


def fleet_summary(workers, events, skew_threshold=DEFAULT_SKEW_THRESHOLD):
    """The training-fleet block of ``steplog.summarize_dir`` /
    ``cli observe``: ``workers`` maps worker id -> ``{"walls": [...],
    "steps": int, "examples": int, "files": [...]}`` pooled across that
    worker's steplog files (a reform opens a fresh ``-N``-suffixed
    file, so one worker can own several); ``events`` feeds
    :func:`assemble_timeline`. Returns None when the directory holds
    neither fleet walls nor elastic events."""
    out = {}
    walls_by = {wid: d.get("walls") or [] for wid, d in workers.items()}
    skew = step_time_skew(walls_by) if workers else None
    if skew:
        for wid, entry in skew["workers"].items():
            d = workers.get(wid) or {}
            if d.get("steps"):
                entry["steps"] = int(d["steps"])
            if d.get("examples"):
                entry["examples"] = int(d["examples"])
            if d.get("files"):
                entry["files"] = list(d["files"])
        out["skew"] = skew
        found = find_straggler(skew, threshold=skew_threshold)
        if found is not None:
            out["straggler"] = {"worker": found[0], "skew": found[1]}
        # live mirror: per-worker skew as a labeled gauge, so a metrics
        # scrape of whatever process ran the aggregation sees the same
        # number the report printed
        try:
            from paddle_tpu_torch.observe import metrics as observe_metrics

            m = observe_metrics.get_registry()
            for wid, entry in skew["workers"].items():
                m.gauge("paddle_tpu_train_step_skew",
                        help="per-worker step-time skew "
                             "(worker p95 / fleet median)",
                        labels={"worker": wid}).set(entry["skew"])
        except Exception:
            pass
    timeline = assemble_timeline(events)
    if timeline:
        out["timeline"] = timeline
        out["rewinds"] = sum(1 for e in timeline
                             if e.get("kind") == "rewind")
    return out or None
