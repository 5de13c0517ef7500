"""Replica-scaled serving: shared-nothing engines over one bundle behind
one front door (paddle_tpu/serve/fleet.py).

* ONE :class:`~paddle_tpu_torch.serve.bundle.Bundle` loads once (manifest,
  host payload, deserialized programs); each replica gets a
  :class:`~paddle_tpu_torch.serve.bundle.BundleReplica` on its device,
  whose parameters and programs move there once per device. Replicas
  cycle over ``devices``: by default every card
  (``torch.cuda.device_count()``) when the bundle is on a card, the
  bundle's device otherwise; on one H100 ``replicas=2`` is two engines
  on ``cuda:0``, sharing the card's placement and its default stream.
* each replica runs its own engine (the dynamic-batching engine or, with
  ``continuous=True``, the continuous scheduler) with its own queue,
  worker thread, ``{replica=}``-labelled metric families and step log
  ``<run>-r<i>``. Nothing is shared between replicas but the read-only
  bundle.
* ``submit()`` dispatches to the **least-queued** eligible replica
  (round-robin among ties). A replica is eligible once its warmup
  completed and its worker lives; ``ready()`` is False until every
  replica is warm. Session requests follow the consistent-hash ring
  (``ConsistentHashRing``); when a session's carry sits on another
  replica it migrates (``export_session`` → ``import_session``) before
  the request lands.

The fleet is duck-typed like an engine (submit/infer/ready/live/
queue_depth/stats/stop), so the router and the HTTP front end host it
unchanged; ``cli serve --replicas N|auto`` builds it.

Capacity: the replicas of one process share one placement per device, so
a fleet holds one parameter copy per distinct device it uses. The
manifest's ``hbm_estimate_bytes`` times those copies is checked against
``PADDLE_TPU_TORCH_HBM_BUDGET`` at construction, before any copy. For the
same reason ``--replicas auto`` places at most one replica per device:
a second engine thread on one H100 lost half the first one's qps (the
programs are host-paced).
"""

import collections
import threading

import torch

from paddle_tpu_torch.observe import health as observe_health
from paddle_tpu_torch.observe import metrics as observe_metrics
from paddle_tpu_torch.serve.engine import InferenceEngine, Overloaded
from paddle_tpu_torch.serve.scheduler import ContinuousScheduler
from paddle_tpu_torch.serve.sessions import ConsistentHashRing
from paddle_tpu_torch.utils.logger import logger

# the session -> replica table is a routing hint, not session state (the
# carries live in each replica's scheduler): bounded, so a million
# one-shot sessions cannot grow the front door
_SESSION_HOME_CAP = 1 << 20

# ``--replicas auto`` never builds more engines than this, however small
# the bundle: past a few engines per core the interpreter is the wall
_AUTO_REPLICA_CAP = 64


def fleet_devices(bundle):
    """The devices a fleet cycles over by default: every card when the
    bundle is on a card, else the bundle's own device. A fleet never moves
    to the CPU on its own."""
    if bundle.device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [bundle.device]


class Replica:
    """One fleet member: index, device, the bundle's view on that device
    and the engine that serves it."""

    __slots__ = ("index", "device", "bundle", "engine")

    def __init__(self, index, device, bundle, engine):
        self.index = index
        self.device = device
        self.bundle = bundle
        self.engine = engine

    def __repr__(self):
        return "Replica(%d, device=%s)" % (self.index, self.device)


def replicas_that_fit(bundle, budget=None):
    """How many parameter copies of this bundle the budget holds:
    ``budget // hbm_estimate_bytes``. None without a budget or an
    estimate; 0 when not even one copy fits."""
    est = bundle.manifest.get("hbm_estimate_bytes")
    if budget is None:
        from paddle_tpu_torch.analyze.topology_check import hbm_budget_bytes

        budget = hbm_budget_bytes()
    if not est or budget is None:
        return None
    return int(budget // int(est))


def auto_replicas(bundle, devices=None, budget=None, stack=False):
    """The ``cli serve --replicas auto`` width: one replica per device
    (:func:`fleet_devices` by default), or under a budget as many as
    :func:`replicas_that_fit` admits, at most one per device, and at least
    1. ``stack=True`` (worker processes, each holding its own copy) lets
    the count exceed the devices as JAX's does, capped at
    ``_AUTO_REPLICA_CAP``. ``budget`` overrides the environment's: a
    multi-model host gives each model its share."""
    if devices is None:
        devices = fleet_devices(bundle)
    n_dev = max(len(list(devices)), 1)
    fit = replicas_that_fit(bundle, budget)
    if fit is None:
        return n_dev
    return max(1, min(fit, _AUTO_REPLICA_CAP if stack else n_dev))


def fleet_hbm_check(bundle, replicas, devices=None):
    """The static memory gate of an N-replica load: the manifest's
    ``hbm_estimate_bytes`` times the parameter copies the load holds,
    against the budget. With ``devices`` (those the replicas of one
    process cycle over, which share one placement per device) that is one
    copy per distinct device used; without, one per replica (worker
    processes). Returns ``(total_bytes, note)``; ``note`` is None when the
    load fits (or no budget or estimate exists), else the warning, which
    is logged."""
    est = bundle.manifest.get("hbm_estimate_bytes")
    if not est:
        return None, None
    replicas = int(replicas)
    copies = (len({str(torch.device(devices[i % len(devices)]))
                   for i in range(replicas)}) if devices else replicas)
    total = int(est) * copies
    from paddle_tpu_torch.analyze.topology_check import (BUDGET_ENV,
                                                         _fmt_bytes,
                                                         hbm_budget_bytes)

    budget = hbm_budget_bytes()
    if budget is None or total <= budget:
        return total, None
    note = ("%d-replica fleet needs ~%s of device memory (%d parameter "
            "copies of %s params+workspace, manifest hbm_estimate_bytes), "
            "over %s=%s — the copies will not fit; serve fewer replicas, "
            "fewer devices or a smaller bundle"
            % (replicas, _fmt_bytes(total), copies, _fmt_bytes(int(est)),
               BUDGET_ENV, _fmt_bytes(budget)))
    logger.warning("ReplicaSet: %s", note)
    return total, note


class ReplicaSet:
    """N shared-nothing engine replicas over one bundle behind a
    least-queued dispatch front; duck-typed like
    :class:`~paddle_tpu_torch.serve.engine.InferenceEngine`.

    ``replicas`` defaults to one per device; ``devices`` pins the
    placement (cycled when ``replicas`` exceeds it). ``continuous=True``
    fronts a decode bundle with continuous schedulers; ``engine_kwargs``
    passes through to every member engine."""

    def __init__(self, bundle, replicas=None, devices=None,
                 continuous=False, engine_kwargs=None,
                 metrics_registry=None, steplog=None, model=None,
                 warmup=True, run_name="serve"):
        devices = list(fleet_devices(bundle) if devices is None
                       else devices)
        if not devices:
            raise ValueError("no devices to place replicas on")
        n = len(devices) if replicas is None else int(replicas)
        if n < 1:
            raise ValueError("replicas must be >= 1, got %r" % replicas)
        self.bundle = bundle
        self.model = model
        self.continuous = bool(continuous)
        self.metrics = metrics_registry or observe_metrics.get_registry()
        # each replica opens its own run file (<run>-r<i>) by default: one
        # shared log would serialize every replica's records on one lock;
        # an explicitly passed ``steplog`` is shared
        self._slog = steplog
        self.hbm_estimate_bytes, self.hbm_note = fleet_hbm_check(
            bundle, n, devices)
        shed_labels = {"reason": "no_replica"}
        if model:
            shed_labels["model"] = str(model)
        self._m_shed = self.metrics.counter(
            "paddle_tpu_serve_shed_total",
            help="requests rejected by admission control",
            labels=shed_labels)
        kwargs = dict(engine_kwargs or {})
        engine_cls = ContinuousScheduler if continuous else InferenceEngine
        members = []
        for i in range(n):
            device = devices[i % len(devices)]
            view = bundle.view(device)
            engine = engine_cls(view, steplog=self._slog, warmup=warmup,
                                metrics_registry=self.metrics,
                                model=model, replica=i,
                                run_name="%s-r%d" % (run_name, i),
                                **kwargs)
            members.append(Replica(i, view.device, view, engine))
        # immutable after construction: dispatch reads it lock-free; the
        # round-robin cursor and the width knob take the lock
        self._members = tuple(members)
        self._lock = threading.Lock()
        self._rr = 0
        self._active = len(members)
        self._ring = (ConsistentHashRing([m.index for m in members])
                      if continuous else None)
        self._session_home = collections.OrderedDict()
        # migrations serialize here: two requests of one session must not
        # race the export -> import window
        self._migrate_lock = threading.Lock()

    def replicas(self):
        """The fleet members, in index order."""
        return self._members

    # -- dispatch -----------------------------------------------------------
    def _eligible(self):
        """Members that may take traffic: warm and alive."""
        return [m for m in self._members
                if m.engine.ready() and m.engine.live()]

    @property
    def supports_sessions(self):
        return self.continuous

    def submit(self, inputs, session_id=None, priority=None,
               end_session=False, trace=None):
        """Dispatch one request to the least-queued eligible replica
        (round-robin among ties), or with ``session_id`` to the session's
        ring home (migrating its carry there first when it sits
        elsewhere); returns that engine's Future. Raises
        :class:`Overloaded` (reason ``no_replica``) when no replica is
        eligible."""
        eligible = self._eligible()
        if not eligible:
            self._m_shed.inc()
            observe_health.get_history().record_shed("no_replica")
            raise Overloaded(
                "no warm live replica (fleet of %d still warming or "
                "failed) — retry after /readyz goes green"
                % len(self._members),
                model=self.model, reason="no_replica")
        if session_id is not None:
            if self._ring is None:
                raise ValueError(
                    "this fleet does not hold sessions (whole-request "
                    "engines); construct with continuous=True over a "
                    "decode-capable bundle")
            member = self._route_session(str(session_id), eligible)
            return member.engine.submit(inputs,
                                        session_id=str(session_id),
                                        priority=priority,
                                        end_session=end_session,
                                        trace=trace)
        with self._lock:
            active = self._active
        if active < len(self._members):
            # the width knob narrows fresh stateless dispatch; when every
            # member inside the width is down the whole fleet serves
            narrowed = [m for m in eligible if m.index < active]
            if narrowed:
                eligible = narrowed
        n = len(eligible)
        with self._lock:
            offset = self._rr
            self._rr = (self._rr + 1) % n
        order = [eligible[(offset + j) % n] for j in range(n)]
        depths = [m.engine.queue_depth() for m in order]
        best = min(range(n), key=lambda j: (depths[j], j))
        return order[best].engine.submit(inputs, trace=trace)

    def _route_session(self, sid, eligible):
        """The session's target: the first eligible member in ring order.
        When the carry sits elsewhere it is pulled over first; a dead
        replica's store and parked carries stay readable, so its sessions
        survive it."""
        eligible_idx = {m.index for m in eligible}
        target = next((self._members[idx] for idx in self._ring.order(sid)
                       if idx in eligible_idx), eligible[0])
        with self._lock:
            home = self._session_home.get(sid)
        if home is None:
            # the bounded table forgot this session: probe before taking it
            # for new (a wrong guess restarts it from a zero carry)
            for member in self._members:
                if (member.index != target.index
                        and member.engine.has_session(sid)):
                    home = member.index
                    break
        if home is not None and home != target.index:
            with self._migrate_lock:
                probed = home
                with self._lock:
                    home = self._session_home.get(sid)
                if home is None:
                    home = probed
                if home != target.index:
                    old = self._members[home]
                    try:
                        state = old.engine.export_session(sid)
                    except KeyError:
                        state = None  # the home never held this id
                    # SessionGone propagates: evicted at home is gone
                    # fleet-wide
                    if state is not None:
                        target.engine.import_session(sid, state)
                    self._set_home(sid, target.index)
            return target
        self._set_home(sid, target.index)
        return target

    def _set_home(self, sid, index):
        with self._lock:
            self._session_home[sid] = index
            self._session_home.move_to_end(sid)
            while len(self._session_home) > _SESSION_HOME_CAP:
                self._session_home.popitem(last=False)

    def close_session(self, session_id):
        """Abort a session fleet-wide (idempotent)."""
        if self._ring is None:
            return
        sid = str(session_id)
        with self._lock:
            home = self._session_home.pop(sid, None)
        members = ([self._members[home]] if home is not None
                   else self._members)
        for member in members:
            member.engine.close_session(sid)

    def infer(self, inputs, timeout=60.0, session_id=None, priority=None,
              end_session=False, trace=None):
        return self.submit(inputs, session_id=session_id,
                           priority=priority, end_session=end_session,
                           trace=trace).result(timeout=timeout)

    def queue_depth(self):
        """Queued rows across every replica (the router's pressure
        signal)."""
        return sum(m.engine.queue_depth() for m in self._members)

    # -- health -------------------------------------------------------------
    def ready(self):
        """True once every replica's warmup completed."""
        return all(m.engine.ready() for m in self._members)

    def ready_detail(self):
        return {str(m.index): m.engine.ready() for m in self._members}

    def live(self):
        """True while any replica can serve."""
        return any(m.engine.live() for m in self._members)

    def live_detail(self):
        return {str(m.index): m.engine.live() for m in self._members}

    def register_knobs(self, registry, prefix="fleet"):
        """Adopt the dispatch width (``<prefix>.active_replicas``) and the
        member engines' shared knobs as fleet-wide broadcasts: each member
        registers into a private registry, and each name they all share
        becomes one knob whose apply moves every member."""
        from paddle_tpu_torch.control.knobs import Knob, KnobRegistry

        def _set_active(v):
            with self._lock:
                self._active = int(v)

        registry.register(Knob(
            prefix + ".active_replicas", value=len(self._members),
            min=1, max=len(self._members), step=1, integer=True,
            cost_hint="heavy", apply=_set_active))
        member_regs = []
        for m in self._members:
            reg = KnobRegistry()
            m.engine.register_knobs(reg)
            member_regs.append(reg)
        shared = set(member_regs[0].names())
        for reg in member_regs[1:]:
            shared &= set(reg.names())
        for name in sorted(shared):
            proto = member_regs[0].get(name)

            def _broadcast(v, name=name):
                for reg in member_regs:
                    reg.set(name, v)

            registry.register(Knob(
                name, value=proto.value, min=proto.min, max=proto.max,
                step=proto.step, cost_hint=proto.cost_hint,
                integer=proto.integer, apply=_broadcast))

    def stats(self):
        """Aggregate counters plus each member's own stats."""
        per = {str(m.index): m.engine.stats() for m in self._members}
        with self._lock:
            active = self._active
        out = {
            "replicas": len(self._members),
            "active_replicas": active,
            "dispatch": "least_queued_rr",
            "devices": [str(m.device) for m in self._members],
            "per_replica": per,
        }
        for key in ("requests", "rows", "batches", "shed",
                    "queue_depth", "in_flight", "spills", "restores",
                    "evictions", "resident_sessions",
                    "suspended_sessions"):
            out[key] = sum(s.get(key, 0) for s in per.values())
        if self._ring is not None:
            with self._lock:
                out["session_routes"] = len(self._session_home)
        if self.model:
            out["model"] = self.model
        if self.hbm_estimate_bytes is not None:
            out["hbm_estimate_bytes"] = self.hbm_estimate_bytes
        out["ready"] = self.ready()
        return out

    def stop(self, timeout=30.0):
        """Stop every replica engine (each drains its queue and closes its
        own step log; a shared log is flushed). Idempotent."""
        for m in self._members:
            m.engine.stop(timeout=timeout)
        if self._slog is not None:
            self._slog.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def __repr__(self):
        return "ReplicaSet(%r, replicas=%d, continuous=%s)" % (
            self.bundle.name, len(self._members), self.continuous)
