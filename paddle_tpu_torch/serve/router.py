"""Multi-model routing with priority classes and load shedding
(paddle_tpu/serve/router.py).

One server process hosts N bundles, each behind its own engine: the
dynamic-batching engine (serve/engine.py), the continuous scheduler
(serve/scheduler.py) or a fleet of either (serve/fleet.py,
serve/workers.py). The router is duck-typed over submit/infer/ready/live/
queue_depth/stats/stop. Admission control runs before a request touches
any queue:

* **per-model bound** — each hosted engine caps its own queue
  (``max_queue_rows`` / ``max_queue``); a full queue sheds with reason
  ``queue_full`` whatever the priority;
* **priority pressure** — every model has a priority class (``high`` >
  ``normal`` > ``low``) and each class a ceiling on the total rows queued
  across all hosted models (``shed_capacity``); a request sheds with
  reason ``pressure`` once the backlog reached its class's ceiling. Low's
  ceiling is the smallest, so under joint overload low sheds first and
  the backlog high sees stays bounded.

Every shed adds one to ``paddle_tpu_serve_shed_total{model,priority,
reason}`` and writes a ``serve_shed`` step-log record, then raises
:class:`~paddle_tpu_torch.serve.engine.Overloaded`, which the HTTP front
end (serve/server.py) answers 429.
"""

import threading

from paddle_tpu_torch.observe import metrics as observe_metrics
from paddle_tpu_torch.observe import steplog as observe_steplog
from paddle_tpu_torch.observe import tracing as observe_tracing
from paddle_tpu_torch.serve.engine import Overloaded

# priority classes, strongest first; ``shed_capacity`` maps each to the
# queued-rows ceiling past which new submissions of that class shed (None:
# never pressure-shed; the per-model bounds still apply)
PRIORITIES = ("high", "normal", "low")
DEFAULT_SHED_CAPACITY = {"high": None, "normal": 1024, "low": 256}


class HostedModel:
    __slots__ = ("name", "bundle", "engine", "priority")

    def __init__(self, name, bundle, engine, priority):
        self.name = name
        self.bundle = bundle
        self.engine = engine
        self.priority = priority


class Router:
    """Front door over N hosted models: per-model queues, priority
    admission control and shed accounting. Use as a context manager or
    call ``stop()`` (which stops every hosted engine)."""

    def __init__(self, metrics_registry=None, steplog=None,
                 shed_capacity=None, run_name="serve"):
        self.metrics = metrics_registry or observe_metrics.get_registry()
        self.shed_capacity = dict(DEFAULT_SHED_CAPACITY)
        if shed_capacity:
            self.shed_capacity.update(shed_capacity)
        self._lock = threading.Lock()
        self._models = {}
        self._owns_slog = steplog is None
        # shed records can arrive at flood rate: batch the flush
        self._slog = (observe_steplog.from_env(run_name=run_name,
                                               meta={"phase": "serve"},
                                               flush_every=32)
                      if steplog is None else steplog)

    def add_model(self, name, bundle, engine, priority="normal"):
        """Host ``engine`` (an engine, scheduler or fleet over ``bundle``)
        under ``name`` with a priority class."""
        if priority not in PRIORITIES:
            raise ValueError("unknown priority %r (choose from %s)"
                             % (priority, list(PRIORITIES)))
        hosted = HostedModel(name, bundle, engine, priority)
        with self._lock:
            if name in self._models:
                raise ValueError("model %r is already hosted" % name)
            self._models[name] = hosted
        return hosted

    def _hosted(self):
        """A snapshot of the hosted-model table, taken under the lock, so
        a concurrent ``add_model`` never races an iteration."""
        with self._lock:
            return dict(self._models)

    def model(self, name):
        models = self._hosted()
        try:
            return models[name]
        except KeyError:
            raise KeyError("unknown model %r (hosted: %s)"
                           % (name, sorted(models))) from None

    def models(self):
        return self._hosted()

    def default_model(self):
        """The single hosted model (``POST /infer`` without a name);
        ambiguous with several."""
        with self._lock:
            if len(self._models) != 1:
                raise KeyError(
                    "%d models hosted — name one (POST /infer/<model>)"
                    % len(self._models))
            return next(iter(self._models.values()))

    # -- admission ----------------------------------------------------------
    def total_queued(self):
        """Queued rows across every hosted model: the pressure signal."""
        return sum(m.engine.queue_depth()
                   for m in self._hosted().values())

    def _shed(self, hosted, reason, queued, count=True):
        """Shed accounting. ``count=False`` when the hosted engine's own
        queue bound already counted the rejection (the family counts each
        once; the step-log record is always the router's)."""
        if count:
            self.metrics.counter(
                "paddle_tpu_serve_shed_total",
                help="requests rejected by admission control",
                labels={"model": hosted.name,
                        "priority": hosted.priority,
                        "reason": reason}).inc()
        if self._slog is not None:
            self._slog.log_serve_shed(model=hosted.name, reason=reason,
                                      priority=hosted.priority,
                                      queued=queued)

    def submit(self, name, inputs, session_id=None, end_session=False,
               trace=None):
        """Route one request to model ``name``; returns the engine's
        Future. Raises :class:`Overloaded` before any queue when admission
        control sheds it. ``session_id`` goes to session-capable engines
        with the model's priority class (the session store evicts in the
        router's shed order); ``trace`` passes through by value."""
        hosted = self.model(name)
        # the ceiling is read under the lock: the knob registry may move it
        with self._lock:
            ceiling = self.shed_capacity.get(hosted.priority)
        if ceiling is not None:
            queued = self.total_queued()
            if queued >= ceiling:
                self._shed(hosted, "pressure", queued)
                raise Overloaded(
                    "global backlog %d >= %s-priority ceiling %d — "
                    "shed" % (queued, hosted.priority, ceiling),
                    model=hosted.name, priority=hosted.priority,
                    reason="pressure", queued=queued)
        try:
            if session_id is not None:
                if not getattr(hosted.engine, "supports_sessions", False):
                    raise ValueError(
                        "model %r does not hold sessions (re-export "
                        "with decode_slots= and serve --continuous)"
                        % hosted.name)
                return hosted.engine.submit(inputs,
                                            session_id=session_id,
                                            priority=hosted.priority,
                                            end_session=end_session,
                                            trace=trace)
            return hosted.engine.submit(inputs, trace=trace)
        except Overloaded as exc:
            exc.priority = hosted.priority
            self._shed(hosted, exc.reason, exc.queued, count=False)
            raise

    def infer(self, name, inputs, timeout=60.0, session_id=None,
              end_session=False, trace=None):
        return self.submit(name, inputs, session_id=session_id,
                           end_session=end_session,
                           trace=trace).result(timeout=timeout)

    # -- health -------------------------------------------------------------
    def ready(self):
        """True once every hosted model's warmup completed (the aggregate
        ``/readyz``)."""
        models = self._hosted()
        return bool(models) and all(m.engine.ready()
                                    for m in models.values())

    def ready_detail(self):
        return {name: m.engine.ready()
                for name, m in self._hosted().items()}

    def live(self):
        models = self._hosted()
        return bool(models) and all(m.engine.live()
                                    for m in models.values())

    def live_detail(self):
        return {name: m.engine.live()
                for name, m in self._hosted().items()}

    def stats(self):
        models = self._hosted()
        with self._lock:
            shed_capacity = dict(self.shed_capacity)
        return {
            "models": {name: m.engine.stats()
                       for name, m in models.items()},
            "priorities": {name: m.priority
                           for name, m in models.items()},
            "total_queued": self.total_queued(),
            "shed_capacity": shed_capacity,
            "ready": self.ready(),
            "trace": observe_tracing.trace_state(),
        }

    def register_knobs(self, registry, prefix="router"):
        """Adopt the ``normal`` and ``low`` pressure ceilings as knobs
        (``high`` has none: never shed); the apply hook writes under the
        lock that ``submit`` reads under."""
        from paddle_tpu_torch.control.knobs import Knob

        with self._lock:
            ceilings = dict(self.shed_capacity)
        for priority in ("normal", "low"):
            ceiling = ceilings.get(priority)
            if ceiling is None:
                continue

            def _apply(v, priority=priority):
                with self._lock:
                    self.shed_capacity[priority] = int(v)

            registry.register(Knob(
                "%s.shed_%s" % (prefix, priority), value=ceiling,
                min=16, max=1 << 20, step=16, integer=True,
                apply=_apply))

    def stop(self, timeout=30.0):
        for m in self._hosted().values():
            m.engine.stop(timeout=timeout)
        if self._owns_slog and self._slog is not None:
            self._slog.close()
            self._slog = None
        elif self._slog is not None:
            # a shared log: flush, so flush_every batching cannot drop the
            # last shed records
            self._slog.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
