"""Elastic membership and lost-worker recovery over the coordinator
(paddle_tpu/distributed/elastic.py).

The reference's second generation existed to survive preemption: an
etcd-coordinated Go master handed out recoverable task leases and workers
held TTL'd membership keys that a keep-alive goroutine renewed. Here the
C++ coordinator's lease table (its register/heartbeat ops) plays that
part:

* every training process REGISTERS under a TTL lease and renews it from a
  named background thread (:class:`HeartbeatThread`, one renewal per
  ttl/3);
* the step thread watches the membership at step boundaries
  (:class:`MembershipWatch`, one ``workers`` RPC at most every
  ``poll_secs``); a peer whose lease lapsed raises :class:`WorkerLost` at
  the NEXT boundary, never mid-step;
* recovery (:func:`run_elastic`) is deterministic and needs no
  coordination: every survivor rewinds to the last committed checkpoint
  (``trainer.train(resume="pass")``) and re-deals ALL data shards over the
  survivors with :func:`deal_shards`, a pure function of the sorted shard
  and worker-id lists, so the dead worker's shards land on the survivors
  identically everywhere.

Within one torch.distributed process group, recovery re-deals data and
rewinds state; a smaller process group itself needs a restart (the
launcher relaunches the survivors with ``--resume``, which the checkpoint
makes cheap).
"""

import os
import threading
import time

from paddle_tpu_torch.utils.error import enforce
from paddle_tpu_torch.utils.logger import logger


class WorkerLost(RuntimeError):
    """A peer's membership lease lapsed; raised at a step boundary."""

    def __init__(self, lost, remaining):
        self.lost = sorted(lost)
        self.remaining = sorted(remaining)
        super().__init__("lost worker(s) %s; %d survive"
                         % (self.lost, len(self.remaining)))


class SelfLeaseLost(RuntimeError):
    """This worker's OWN lease lapsed (partitioned from the coordinator
    longer than ttl): the peers have already declared it dead and
    re-dealt its shards, so going on with the old deal would train those
    shards TWICE. Deliberately not a :class:`WorkerLost`: run_elastic does
    not absorb it into a local reform. The launcher restarts the process
    with ``--resume``, as after any other death."""


class HeartbeatThread:
    """Named daemon thread ("coord-heartbeat") renewing this worker's
    coordinator lease every ttl/3. It owns a PRIVATE CoordinatorClient
    (the client is single-threaded); transient RPC failures are absorbed
    by the client's capped-backoff retry, and anything escaping it is
    counted, logged and survived: a missed beat only matters once ttl
    lapses, which is the coordinator's call."""

    def __init__(self, endpoint, worker_id, ttl=10.0, steplog=None,
                 meta=None):
        from paddle_tpu_torch.distributed.client import CoordinatorClient

        self.ttl = float(ttl)
        # optional flat metadata string (client.encode_host_meta),
        # re-announced on every renewal
        self.meta = meta
        enforce(self.ttl > 0, "heartbeat ttl must be positive, got %r", ttl)
        # a renewal that cannot land within ttl is lost anyway: bound the
        # client's retries by it, so stop() never waits out the default
        # retry window behind a dead coordinator
        self._client = CoordinatorClient(endpoint, worker_id=worker_id,
                                         retry_timeout=self.ttl)
        self._steplog = steplog  # lease_renew_fail records
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._beats = 0
        self._errors = 0
        self._last_ok = None
        self._thread = threading.Thread(target=self._loop,
                                        name="coord-heartbeat", daemon=True)

    def start(self):
        """Register the lease, then start renewing it."""
        self._client.register(ttl=self.ttl, meta=self.meta)
        with self._lock:
            self._last_ok = time.monotonic()
        self._thread.start()
        return self

    def lease_lapsed(self):
        """True when no renewal has SUCCEEDED within ttl: the coordinator
        has (or is about to have) expired this worker's lease. Heartbeats
        re-register on reconnect, so without this check a partitioned
        worker would rejoin silently after its peers re-dealt its
        shards."""
        with self._lock:
            last = self._last_ok
        return last is not None and time.monotonic() - last > self.ttl

    def stop(self):
        """Stop renewing and join; the lease lapses after ttl (a crashed
        worker and a stopped one look the same upstream). The client is
        closed only once its thread is confirmed dead."""
        self._stop.set()
        self._thread.join(timeout=max(self.ttl, 5.0))
        if not self._thread.is_alive():
            self._client.close()

    def stats(self):
        with self._lock:
            return {"beats": self._beats, "errors": self._errors}

    def _loop(self):
        interval = max(self.ttl / 3.0, 0.05)
        while not self._stop.wait(interval):
            try:
                self._client.heartbeat(ttl=self.ttl, meta=self.meta)
                with self._lock:
                    self._beats += 1
                    self._last_ok = time.monotonic()
            except Exception as exc:
                with self._lock:
                    self._errors += 1
                logger.warning("coordinator heartbeat failed: %s", exc)
                if self._steplog is not None:
                    # timeline-worthy (the prelude to a worker_lost seen
                    # elsewhere), never fatal here
                    try:
                        self._steplog.log_elastic_event(
                            "lease_renew_fail",
                            worker=self._client.worker_id,
                            detail=str(exc))
                    except Exception:
                        pass


def settled_members(client, poll_secs=0.1, expected=None, timeout=30.0):
    """A membership snapshot stable enough to deal over: two consecutive
    polls must agree (and, with ``expected``, at least that many workers
    be present), so workers dealing at slightly different instants compute
    the SAME deal. Falls back to the current view, with a warning, if
    membership does not settle within ``timeout``."""
    deadline = time.monotonic() + float(timeout)
    prev = None
    while True:
        cur = set(client.workers())
        cur.add(client.worker_id)  # the own lease may be mid-renewal
        if cur == prev and (expected is None or len(cur) >= expected):
            return cur
        if time.monotonic() >= deadline:
            logger.warning(
                "membership did not settle within %.0fs (have %d%s); "
                "dealing over the current view", timeout, len(cur),
                "" if expected is None else " of %d expected" % expected)
            return cur
        prev = cur
        time.sleep(max(float(poll_secs) / 2, 0.05))


def settled_checkpoint(directory, poll_secs=0.5, timeout=30.0):
    """The newest committed checkpoint once the shared directory is STABLE
    (two consecutive polls agree). After a reform abort a slower
    survivor's unwind may still be finishing an in-flight commit; a
    survivor that restored before it landed would rewind to an older step
    than its peers. Pending snapshots are discarded on the unwind
    (``AsyncCheckpointer.discard_pending``), so the directory settles once
    every in-flight write is done. Falls back to the current newest, with
    a warning, after ``timeout``."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt_mod

    deadline = time.monotonic() + float(timeout)
    prev = False  # distinct from None: latest may legitimately be None
    while True:
        cur = ckpt_mod.latest_checkpoint(directory)
        if prev is not False and cur == prev:
            return cur
        if time.monotonic() >= deadline:
            logger.warning(
                "checkpoint dir %s did not settle within %.0fs; "
                "rewinding to the current newest (%s)", directory,
                timeout, cur)
            return cur
        prev = cur
        time.sleep(max(float(poll_secs), 0.05))


def deal_shards(chunks, workers, worker_id):
    """This worker's share of ``chunks``: the sorted chunks dealt
    round-robin over the sorted worker ids. A pure function of its inputs,
    so every survivor computes the same re-deal after a death, and
    together the survivors cover every chunk exactly once."""
    order = sorted(set(workers))
    enforce(worker_id in order, "worker %r not in membership %s",
            worker_id, order)
    idx = order.index(worker_id)
    return [c for i, c in enumerate(sorted(chunks))
            if i % len(order) == idx]


class MembershipWatch:
    """Step-boundary lost-worker detection. ``check()`` is cheap enough to
    call every step: it polls the lease table at most every ``poll_secs``
    and raises :class:`WorkerLost` when a watched member's lease lapsed.
    Workers that JOIN are adopted at the next (re)deal, never mid-pass."""

    def __init__(self, client, members, poll_secs=1.0):
        self._client = client
        self.members = set(members)
        self.poll_secs = float(poll_secs)
        self._last_poll = float("-inf")

    def check(self):
        now = time.monotonic()
        if now - self._last_poll < self.poll_secs:
            return
        self._last_poll = now
        current = set(self._client.workers())
        lost = self.members - current
        if not lost:
            return
        if self._client.worker_id in lost:
            # the COORDINATOR already expired this worker's lease: the
            # peers re-dealt its shards, so a WorkerLost reform here would
            # deal it back IN while they dealt it OUT
            raise SelfLeaseLost(
                "worker %s: own lease expired at the coordinator — peers "
                "have re-dealt this worker's shards; restart with "
                "--resume" % self._client.worker_id)
        raise WorkerLost(lost, self.members & current)


def run_elastic(trainer, endpoint, chunks, reader_of, checkpoint_dir,
                num_passes=1, checkpoint_every=1, checkpoint_keep=3,
                checkpoint_sync=False, worker_id=None, heartbeat_ttl=10.0,
                poll_secs=1.0, event_handler=None, max_reforms=8,
                expected_workers=None, **train_kw):
    """Preemption-tolerant training driver for one process of an elastic
    group. ``reader_of(my_shards) -> reader`` builds the minibatch reader
    over this worker's deal.

    Runs ``trainer.train`` over this worker's deterministic share of
    ``chunks``; when a peer's lease lapses the loop stops at the next step
    boundary, rewinds to the last committed checkpoint in
    ``checkpoint_dir`` (``resume="pass"``: the shard set changed, so the
    interrupted pass restarts from its first batch under the NEW deal) and
    goes on over the re-dealt shards. If this worker's OWN lease lapses,
    :class:`SelfLeaseLost` propagates out. ``expected_workers=N`` makes
    the FIRST deal wait (bounded) until the whole launch has registered.
    Returns a stats dict: ``reforms``, ``lost`` (worker ids) and ``deals``
    (this worker's shard list per epoch)."""
    from paddle_tpu_torch import event as v2_event
    from paddle_tpu_torch.distributed import checkpoint as ckpt_mod
    from paddle_tpu_torch.distributed.client import CoordinatorClient
    from paddle_tpu_torch.observe import metrics as observe_metrics
    from paddle_tpu_torch.observe import steplog as observe_steplog
    from paddle_tpu_torch.observe import trainview as observe_trainview

    client = CoordinatorClient(endpoint, worker_id=worker_id)
    # the driver's own per-worker steplog ("elastic-t<i>"): it outlives
    # every train() call it makes, and its events are on its clock
    slog = observe_steplog.from_env(
        run_name=observe_trainview.worker_run_name("elastic",
                                                   client.worker_id),
        meta={"phase": "elastic", "worker": client.worker_id})

    def emit(kind, **kw):
        if slog is not None:
            slog.log_elastic_event(kind, worker=client.worker_id, **kw)

    m = observe_metrics.get_registry()
    g_workers = m.gauge("paddle_tpu_train_workers",
                        help="live elastic membership at the last deal")
    c_rewinds = m.counter("paddle_tpu_train_rewinds_total",
                          help="checkpoint rewinds after a lost worker")
    hb = HeartbeatThread(endpoint, client.worker_id,
                         ttl=heartbeat_ttl, steplog=slog).start()
    emit("register",
         members=sorted(set(client.workers()) | {client.worker_id}))
    stats = {"reforms": 0, "lost": [], "deals": []}
    resume = False
    try:
        # a reform must ALWAYS have a rewind target: commit a step-0
        # baseline before the first step (every worker starts from the
        # same seeded init, so concurrent baseline writers commit
        # equivalent snapshots; save_checkpoint resolves the rename race)
        if ckpt_mod.latest_checkpoint(checkpoint_dir) is None:
            trainer.save_checkpoint(checkpoint_dir, pass_id=0,
                                    keep=checkpoint_keep,
                                    resume_at=(0, 0))
        while True:
            members = settled_members(
                client, poll_secs=poll_secs,
                expected=(expected_workers if not stats["deals"]
                          else None))
            mine = deal_shards(chunks, members, client.worker_id)
            stats["deals"].append(list(mine))
            g_workers.set(len(members))
            emit("re_deal", members=sorted(members),
                 detail="%d of %d shards" % (len(mine), len(chunks)))
            if resume:
                emit("resume", members=sorted(members))
            watch = MembershipWatch(client, members, poll_secs=poll_secs)

            def handler(evt, _watch=watch):
                if event_handler is not None:
                    event_handler(evt)
                if isinstance(evt, v2_event.EndIteration):
                    if hb.lease_lapsed():
                        raise SelfLeaseLost(
                            "worker %s: own lease lapsed (no successful "
                            "renewal within ttl=%.1fs) — peers have "
                            "re-dealt this worker's shards; restart with "
                            "--resume" % (client.worker_id, hb.ttl))
                    _watch.check()

            try:
                trainer.train(reader_of(mine), num_passes=num_passes,
                              event_handler=handler,
                              checkpoint_dir=checkpoint_dir,
                              checkpoint_every=checkpoint_every,
                              checkpoint_keep=checkpoint_keep,
                              checkpoint_sync=checkpoint_sync,
                              resume=("pass" if resume else False),
                              **train_kw)
                return stats
            except SelfLeaseLost:
                emit("self_lease_lost")
                raise
            except WorkerLost as exc:
                stats["reforms"] += 1
                stats["lost"].extend(exc.lost)
                emit("worker_lost", members=sorted(exc.remaining),
                     lost=exc.lost)
                c_rewinds.inc()
                enforce(stats["reforms"] <= max_reforms,
                        "gave up after %d re-formations (last: %s)",
                        stats["reforms"], exc)
                logger.warning(
                    "reform %d (%s): rewinding to the last committed "
                    "checkpoint and re-dealing the dead worker's shards",
                    stats["reforms"], exc)
                # survivors abort at different boundaries: wait for the
                # shared directory to stop changing before the restore,
                # so every survivor rewinds to the SAME checkpoint
                target = settled_checkpoint(checkpoint_dir,
                                            poll_secs=poll_secs)
                emit("rewind", members=sorted(exc.remaining),
                     checkpoint=(None if target is None
                                 else os.path.basename(target)))
                resume = True
    finally:
        hb.stop()
        client.close()
        if slog is not None:
            slog.close()
