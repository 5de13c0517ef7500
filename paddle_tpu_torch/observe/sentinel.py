"""Training flight recorder + in-flight loss sentinel
(paddle_tpu/observe/sentinel.py).

Two cooperating pieces over the per-step stream the trainer already
produces (observe/steplog.py):

* :class:`FlightRecorder` — a bounded ring of the last N finalized step
  records. On an anomaly trip or an uncaught training exception the
  ring is dumped as a ``crash_report`` steplog record (schema v1) AND a
  standalone JSON artifact (``<run>.crash.json``, ``-N``-suffixed like
  the steplog itself), so the post-mortem has the exact step trajectory
  that led into the failure even when the process dies.
* :class:`Sentinel` — cheap host-side checks on the already-read-back
  loss (the trainer fetches the scalar every step anyway, so the checks
  add zero device work): a NaN/Inf trip and a loss-divergence trip
  (loss exploding past ``divergence_factor`` × the running loss scale
  after a warmup window).

Mode comes from ``PADDLE_TPU_TORCH_SENTINEL``:

* unset / ``warn`` — anomalies log a warning, emit an ``anomaly``
  steplog record, and dump the flight recorder; training continues.
* ``halt``         — same, then :class:`TrainingAnomaly` is raised so
  the run stops instead of burning a pod on a diverged model.
* ``off``/``0``    — checks disabled entirely.

The reference had nothing in-flight — ``--trap_fpe`` (feenableexcept,
TrainerMain.cpp:49) crashed the process on the first FPE with no
context; this is that idea with a mode switch and a black box attached.
The crash artifact's format is the JAX package's, so either package's
tools read the other's.
"""

import collections
import json
import math
import os
import time

SENTINEL_ENV = "PADDLE_TPU_TORCH_SENTINEL"

# steps of finite loss observed before the divergence check arms (the
# first steps of a fresh model legitimately move the loss a lot)
DEFAULT_WARMUP_STEPS = 8
DEFAULT_DIVERGENCE_FACTOR = 50.0
DEFAULT_CAPACITY = 64

ARTIFACT_FORMAT = "paddle_tpu-crash-report-v1"


class TrainingAnomaly(RuntimeError):
    """Raised by the sentinel in ``halt`` mode; carries the anomaly
    record under ``.anomaly``."""

    def __init__(self, message, anomaly=None):
        super().__init__(message)
        self.anomaly = anomaly or {}


def sentinel_mode():
    """The active mode: ``warn`` (default — the checks are host-side
    float comparisons on a scalar the trainer reads back anyway),
    ``halt``, or ``off``."""
    raw = os.environ.get(SENTINEL_ENV, "").strip().lower()
    if raw in ("off", "0", "false", "no", "none"):
        return "off"
    if raw == "halt":
        return "halt"
    return "warn"


class FlightRecorder:
    """Bounded ring of step records (plain dicts). Thread-compatible
    with the trainer's single finalize thread; not locked."""

    def __init__(self, capacity=DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._ring = collections.deque(maxlen=self.capacity)
        self._total = 0

    def record(self, rec):
        self._ring.append(dict(rec))
        self._total += 1

    def records(self):
        return [dict(r) for r in self._ring]

    def __len__(self):
        return len(self._ring)

    def crash_report(self, reason, extra=None):
        """The ``crash_report`` record body (steplog schema v1):
        ``steps`` is the ring oldest-first, ``captured`` the lifetime
        record count (so a reader knows how much history fell off)."""
        rec = {"type": "crash_report", "reason": str(reason),
               "steps": self.records(), "captured": self._total,
               "capacity": self.capacity}
        if extra:
            rec.update(extra)
        return rec

    def dump(self, directory, run_name="train", reason="exception",
             steplog=None, extra=None):
        """Write the standalone JSON artifact (``<run>.crash.json``,
        ``-N``-suffixed so repeats never clobber) and mirror the same
        body as a ``crash_report`` steplog record. Returns the artifact
        path (None when no directory was available)."""
        body = self.crash_report(reason, extra=extra)
        path = None
        if directory:
            os.makedirs(directory, exist_ok=True)
            base = os.path.join(directory, run_name)
            n = 0
            while True:
                n += 1
                path = (base + ".crash.json" if n == 1
                        else "%s.crash-%d.json" % (base, n))
                try:
                    with open(path, "x") as fh:
                        json.dump(dict(body, format=ARTIFACT_FORMAT,
                                       run=run_name,
                                       unix_time=round(time.time(), 3)),
                                  fh, indent=2)
                    break
                except FileExistsError:
                    continue
        if steplog is not None:
            steplog.log_crash_report(
                body["reason"], body["steps"], captured=body["captured"],
                capacity=body["capacity"], mode=body.get("mode"),
                anomaly=body.get("anomaly"), artifact=path,
                suppressed_trips=body.get("suppressed_trips"),
                worker=body.get("worker"))
        return path


class Sentinel:
    """Per-run loss watchdog. Feed it every finalized step via
    :meth:`step`; call :meth:`on_exception` from the trainer's error
    path so any crash dumps the black box too."""

    def __init__(self, mode=None, recorder=None, steplog=None,
                 artifact_dir=None, run_name="train",
                 divergence_factor=DEFAULT_DIVERGENCE_FACTOR,
                 warmup_steps=DEFAULT_WARMUP_STEPS,
                 capacity=DEFAULT_CAPACITY, worker=None):
        self.mode = mode or sentinel_mode()
        self.recorder = recorder or FlightRecorder(capacity=capacity)
        self.steplog = steplog
        self.artifact_dir = artifact_dir
        self.run_name = run_name
        # training-fleet worker id (observe/trainview.py): stamped into
        # every anomaly/crash_report this sentinel emits, so a
        # multi-worker NaN names its process
        self.worker = worker
        self.divergence_factor = float(divergence_factor)
        self.warmup_steps = int(warmup_steps)
        self._finite_seen = 0
        self._loss_scale = None  # EMA of |finite loss|
        self.anomalies = []      # first anomaly record per kind
        self.artifacts = []      # crash-artifact paths written
        self._tripped_kinds = set()
        self._suppressed = 0     # repeat trips after the first per kind

    @property
    def enabled(self):
        return self.mode != "off"

    # -- checks --------------------------------------------------------------
    def _check(self, cost):
        """Returns (kind, threshold) for an anomalous cost, else None."""
        if cost is None:
            return None
        cost = float(cost)
        if not math.isfinite(cost):
            return "nan_inf_loss", None
        scale = self._loss_scale
        armed = self._finite_seen >= self.warmup_steps
        if armed and scale is not None:
            threshold = self.divergence_factor * max(scale, 1e-6)
            if abs(cost) > threshold:
                return "loss_divergence", threshold
        # only finite, non-anomalous losses update the running scale —
        # a diverging loss must not drag the baseline up after itself
        self._finite_seen += 1
        self._loss_scale = (abs(cost) if scale is None
                            else 0.9 * scale + 0.1 * abs(cost))
        return None

    def step(self, step, cost=None, pass_id=None, batch_id=None, **extra):
        """Record one finalized step into the ring and run the checks.
        Returns the anomaly record (or None). In ``halt`` mode a trip
        raises :class:`TrainingAnomaly` after dumping the black box."""
        rec = {"step": int(step)}
        if pass_id is not None:
            rec["pass"] = int(pass_id)
        if batch_id is not None:
            rec["batch"] = int(batch_id)
        if cost is not None:
            # json.dump chokes on inf/nan with allow_nan=False and emits
            # non-standard tokens otherwise; store the repr for those
            c = float(cost)
            rec["cost"] = c if math.isfinite(c) else repr(c)
        rec.update({k: v for k, v in extra.items() if v is not None})
        self.recorder.record(rec)
        if not self.enabled:
            return None
        found = self._check(cost)
        if found is None:
            return None
        return self._trip(step, cost, found, pass_id=pass_id)

    def record_chunk(self, first_step, costs, pass_id=None, batch_id=None,
                     **extra):
        """Chunked readback (trainer ``steps_per_call=K``): ONE ring
        record for the whole chunk — the fused twin of the per-step ring
        write :meth:`step` does. Runs no checks; the trainer calls
        :meth:`check` per in-chunk loss at the same point of its per-step
        finalize sequence as the legacy path, so halt-mode trips never
        swallow the records/events of the chunk's pre-anomaly steps."""
        costs = [None if c is None else float(c) for c in costs]
        rec = {"step": int(first_step) + max(len(costs) - 1, 0),
               "chunk_first_step": int(first_step),
               "chunk_steps": len(costs)}
        if pass_id is not None:
            rec["pass"] = int(pass_id)
        if batch_id is not None:
            rec["batch"] = int(batch_id)
        if costs and costs[0] is not None:
            rec["cost_first"] = (costs[0] if math.isfinite(costs[0])
                                 else repr(costs[0]))
        if costs and costs[-1] is not None:
            rec["cost_last"] = (costs[-1] if math.isfinite(costs[-1])
                                else repr(costs[-1]))
        rec.update({k: v for k, v in extra.items() if v is not None})
        self.recorder.record(rec)

    def check(self, step, cost, pass_id=None, chunk_index=None):
        """Run the checks on one loss WITHOUT a ring write (the chunk
        already recorded via :meth:`record_chunk`) — the anomaly names
        the real offending global step and its ``chunk_index`` inside
        the chunk, not the chunk boundary. Returns the anomaly record
        (or None); halt mode raises exactly like :meth:`step`."""
        if not self.enabled:
            return None
        found = self._check(cost)
        if found is None:
            return None
        return self._trip(step, cost, found, pass_id=pass_id,
                          chunk_index=chunk_index)

    def _trip(self, step, cost, found, pass_id=None, chunk_index=None):
        """One anomalous loss: dedup per kind, emit + dump the black box,
        raise in halt mode. Shared by the per-step and chunked paths."""
        kind, threshold = found
        if kind in self._tripped_kinds:
            # warn mode keeps training through a persistently-bad loss
            # (NaN never updates the baseline, so every later step trips
            # too): emit + dump ONCE per kind, count the rest — a 100k-
            # step NaN run must not write 100k crash artifacts
            self._suppressed += 1
            return None
        self._tripped_kinds.add(kind)
        anomaly = {"type": "anomaly", "step": int(step), "kind": kind,
                   "mode": self.mode}
        if self.worker is not None:
            anomaly["worker"] = str(self.worker)
        if pass_id is not None:
            anomaly["pass"] = int(pass_id)
        if cost is not None:
            c = float(cost)
            anomaly["cost"] = c if math.isfinite(c) else repr(c)
        if threshold is not None:
            anomaly["threshold"] = round(threshold, 6)
        if chunk_index is not None:
            anomaly["chunk_index"] = int(chunk_index)
        self.anomalies.append(anomaly)
        self._emit(anomaly)
        self._dump("anomaly:" + kind, anomaly)
        if self.mode == "halt":
            exc = TrainingAnomaly(
                "sentinel tripped at step %d: %s (cost=%r)%s — set "
                "%s=warn to continue through anomalies"
                % (step, kind, anomaly.get("cost"),
                   "" if threshold is None
                   else " exceeded threshold %.4g" % threshold,
                   SENTINEL_ENV),
                anomaly=anomaly)
            exc._black_box_dumped = True
            raise exc
        return anomaly

    def on_exception(self, exc):
        """Dump the black box for an exception escaping the training
        loop (skipping a TrainingAnomaly that already dumped)."""
        if getattr(exc, "_black_box_dumped", False):
            return None
        return self._dump("exception: %r" % exc, None)

    # -- emission ------------------------------------------------------------
    def _emit(self, anomaly):
        from paddle_tpu_torch.utils.logger import logger

        logger.warning(
            "sentinel anomaly at step %d: %s (cost=%r, mode=%s)",
            anomaly["step"], anomaly["kind"], anomaly.get("cost"),
            self.mode)
        if self.steplog is not None:
            self.steplog.log_anomaly(
                anomaly["step"], anomaly["kind"],
                cost=anomaly.get("cost"),
                threshold=anomaly.get("threshold"), mode=self.mode,
                pass_id=anomaly.get("pass"),
                chunk_index=anomaly.get("chunk_index"),
                worker=anomaly.get("worker"))

    def _dump(self, reason, anomaly):
        extra = {"mode": self.mode}
        if self.worker is not None:
            extra["worker"] = str(self.worker)
        if anomaly is not None:
            extra["anomaly"] = dict(anomaly)
        if self._suppressed:
            extra["suppressed_trips"] = self._suppressed
        from paddle_tpu_torch.utils.logger import logger

        try:
            path = self.recorder.dump(self.artifact_dir,
                                      run_name=self.run_name,
                                      reason=reason,
                                      steplog=self.steplog, extra=extra)
        except Exception as exc:  # noqa: BLE001 — the black box must
            # never replace the failure it documents (full disk,
            # unwritable telemetry dir)
            logger.warning("flight recorder dump failed: %r", exc)
            return None
        if path:
            self.artifacts.append(path)
            logger.warning("flight recorder dumped to %s", path)
        return path


def from_env(steplog=None, artifact_dir=None, run_name="train", **kw):
    """A Sentinel per the env mode, or None when disabled — mirrors
    steplog.from_env so the trainer wires both the same way."""
    mode = sentinel_mode()
    if mode == "off":
        return None
    if artifact_dir is None and steplog is not None:
        artifact_dir = getattr(steplog, "directory", None)
    return Sentinel(mode=mode, steplog=steplog, artifact_dir=artifact_dir,
                    run_name=run_name, **kw)
