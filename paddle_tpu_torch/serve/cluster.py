"""Fleet-of-fleets serving front — the multi-host control plane
(paddle_tpu/serve/cluster.py; ``cli serve --front`` / ``--join``).

One level up from serve/fleet.py: where a ReplicaSet routes over N
replicas in ONE process, :class:`ClusterFront` routes over N *hosts*,
each running its own engine or fleet behind ``cli serve --join
COORD:PORT``. The front holds only sockets, the hash ring and routing
state: no bundle, no tensor, no device (it imports nothing of
``torch.cuda``), so it restarts in milliseconds and can be replicated
itself.

The pieces, each an existing part of the port:

* **Membership** is distributed/elastic.py's TTL heartbeat leases over
  the coordinator (distributed/coordinator): each serving host renews a
  lease whose metadata carries its dial address (``kind=serve,addr=...``,
  ``client.encode_host_meta``), and the front polls the coordinator's
  ``serve_hosts`` verb on the named ``serve-host-watch`` thread. A
  lapsed lease is the serving twin of WorkerLost: the host leaves the
  ring, its arcs re-deal to the survivors, and its sessions re-home.
* **Affinity** is :class:`~paddle_tpu_torch.serve.sessions
  .ConsistentHashRing` over host ids: a session's requests land on the
  same host while it lives, and only the dead host's sessions move when
  it dies.
* **Durability** is the remote session store (serve/remote_store.py):
  every host's scheduler pages against one shared store process, and
  the front COMMITS each acked session chunk by driving ``POST
  /admin/session/spill`` on the host before answering the client. A
  committed chunk's carry is therefore off-host when a SIGKILL lands,
  and the survivor's scheduler restores it bit for bit. A chunk in
  flight at the kill is NOT committed: that request fails, the client
  retries, and the retry replays from the last committed position,
  never from a zero carry.

Shedding keeps the fleet.py contract one level up: no live host = 429
with reason ``no_host`` (metric, health history, Overloaded); readiness
aggregates each host's ``/readyz``, liveness is any host's. Membership
transitions land in the step log as ``serve_host_event`` records and in
``paddle_tpu_serve_hosts{host=}`` /
``paddle_tpu_serve_host_rehomes_total{host=}``.
"""

import collections
import http.client
import json
import threading

import numpy as np

from paddle_tpu_torch.observe import health as observe_health
from paddle_tpu_torch.observe import metrics as observe_metrics
from paddle_tpu_torch.serve.engine import Overloaded
from paddle_tpu_torch.serve.sessions import ConsistentHashRing
from paddle_tpu_torch.utils.logger import logger

# the front remembers where each session last landed so it can tell a
# re-home (emit the event, bump the counter) from steady affinity;
# bounded like fleet.py's hint table — forgetting only costs one
# uncounted rehome event, never correctness (the store owns the carry)
_SESSION_LAST_CAP = 1 << 20


class ServingHost:
    """One host's dial surface: thin HTTP verbs over the host's
    single-model server (serve/server.py). A fresh connection per
    request keeps this object trivially thread-safe — the front's
    dispatch threads and watcher share it freely."""

    def __init__(self, host_id, address, timeout=30.0):
        host, _, port = str(address).rpartition(":")
        if not host or not port.isdigit():
            raise ValueError("serving host address must be HOST:PORT, "
                             "got %r" % (address,))
        self.host_id = str(host_id)
        self.address = "%s:%s" % (host, port)
        self._netloc = (host, int(port))
        self.timeout = float(timeout)

    def request(self, method, path, body=None, content_type=None,
                timeout=None):
        """One HTTP round: ``(status, body bytes)``. Transport
        failures raise ``ConnectionError``/``OSError`` — the front's
        cue to exclude this host immediately instead of waiting out
        the lease."""
        conn = http.client.HTTPConnection(
            *self._netloc, timeout=self.timeout if timeout is None
            else float(timeout))
        try:
            headers = {}
            if body is not None:
                headers["Content-Type"] = (content_type
                                           or "application/json")
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def get_json(self, path, timeout=None):
        status, body = self.request("GET", path, timeout=timeout)
        return status, json.loads(body or b"{}")

    def post_json(self, path, payload, timeout=None):
        status, body = self.request(
            "POST", path, body=json.dumps(payload).encode(),
            timeout=timeout)
        return status, json.loads(body or b"{}")

    def readyz(self):
        try:
            status, _ = self.request("GET", "/readyz", timeout=5.0)
            return status == 200
        except (ConnectionError, OSError):
            return False

    def livez(self):
        try:
            status, _ = self.request("GET", "/livez", timeout=5.0)
            return status == 200
        except (ConnectionError, OSError):
            return False

    def stats(self):
        try:
            status, obj = self.get_json("/stats", timeout=5.0)
            return obj if status == 200 else None
        except (ConnectionError, OSError, ValueError):
            return None

    def compiles(self):
        """The host's process-wide compile count (``/debug/compiles``),
        or None when the host has no watcher (a host started without
        ``--join``); the front's drill diffs it across a host's death."""
        try:
            status, obj = self.get_json("/debug/compiles", timeout=5.0)
            return int(obj["compiles"]) if status == 200 else None
        except (ConnectionError, OSError, ValueError, KeyError):
            return None

    def manifest(self):
        status, obj = self.get_json("/manifest", timeout=5.0)
        if status != 200:
            raise RuntimeError("host %s /manifest answered %d"
                               % (self.host_id, status))
        return obj

    def spill(self, session_id, timeout=None):
        """Drive the host's commit verb; raises on any non-200 — an
        uncommitted chunk must surface as a request failure, never a
        silent ack."""
        status, obj = self.post_json(
            "/admin/session/spill", {"session_id": str(session_id)},
            timeout=timeout)
        if status != 200:
            raise RuntimeError(
                "session %r failed to commit on host %s: %s"
                % (session_id, self.host_id, obj.get("error", status)))


class _HostEntry:
    __slots__ = ("host", "live", "lease_remaining")

    def __init__(self, host):
        self.host = host
        self.live = True
        self.lease_remaining = None


class ClusterFront:
    """Routes requests over serving hosts discovered through the
    coordinator (or pinned via ``static_hosts`` for coordinator-free
    tests). Duck-types the engine read surface the HTTP front end
    hosts (``ready``/``live``/``stats``/``stop``), plus the JSON-body
    dispatch the proxy handler drives.

    ``endpoint`` is the coordinator ``HOST:PORT``; membership refreshes
    every ``poll_interval`` seconds on the named ``serve-host-watch``
    thread. ``rehome_retries`` bounds how many ring successors one
    request may try after transport failures before it sheds
    (``no_host``). ``commit_sessions`` drives the per-chunk spill
    commit described in the module docstring (on by default; the
    hosts must share one remote session store for it to buy
    durability)."""

    def __init__(self, endpoint=None, static_hosts=None,
                 metrics_registry=None, steplog=None, model=None,
                 poll_interval=1.0, rehome_retries=2,
                 request_timeout=60.0, host_timeout=30.0,
                 commit_sessions=True):
        if endpoint is None and static_hosts is None:
            raise ValueError("ClusterFront needs a coordinator "
                             "endpoint or static_hosts")
        self.endpoint = endpoint
        self.model = model
        self.metrics = metrics_registry or observe_metrics.get_registry()
        self._slog = steplog
        self.poll_interval = float(poll_interval)
        self.rehome_retries = int(rehome_retries)
        self.request_timeout = float(request_timeout)
        self.host_timeout = float(host_timeout)
        self.commit_sessions = bool(commit_sessions)
        shed_labels = {"reason": "no_host"}
        if model:
            shed_labels["model"] = str(model)
        self._m_shed = self.metrics.counter(
            "paddle_tpu_serve_shed_total",
            help="requests rejected by admission control",
            labels=shed_labels)
        self._m_hosts = {}  # host id -> membership gauge (1 live / 0 not)
        self._m_rehomes = {}  # host id -> rehome counter
        # membership + ring share one lock; EVERY reader goes through
        # _snapshot() (locked copy) — dispatch then works on the
        # snapshot, so a watcher update mid-request cannot tear the
        # ring out from under the ring walk
        self._lock = threading.Lock()
        self._hosts = {}  # host id -> _HostEntry
        self._ring = None
        self._rr = 0
        self._seen = set()  # host ids ever admitted (join vs rejoin)
        self._session_last = collections.OrderedDict()  # sid -> host id
        self._out_dtypes = None  # lazy, from the first host's manifest
        self._stats = collections.Counter()
        self._stop = threading.Event()
        self._watch = None
        if static_hosts is not None:
            pairs = (static_hosts.items()
                     if isinstance(static_hosts, dict) else static_hosts)
            for host_id, address in pairs:
                self._admit(str(host_id), str(address))
        if endpoint is not None:
            self._refresh_membership()  # synchronous first poll
            self._watch = threading.Thread(target=self._watch_loop,
                                           name="serve-host-watch",
                                           daemon=True)
            self._watch.start()

    # -- membership ---------------------------------------------------------
    def _snapshot(self):
        """Locked point-in-time copy of (hosts-by-id, ring): the ONLY
        way dispatch and probes read membership (the watcher
        mutates both under the same lock)."""
        with self._lock:
            return dict(self._hosts), self._ring

    def _rebuild_ring_locked(self):
        live = sorted(h for h, e in self._hosts.items() if e.live)
        self._ring = ConsistentHashRing(live) if live else None

    def _gauge(self, host_id):
        gauge = self._m_hosts.get(host_id)
        if gauge is None:
            gauge = self.metrics.gauge(
                "paddle_tpu_serve_hosts",
                help="serving-host membership (1 live in the ring, "
                     "0 excluded)",
                labels={"host": host_id})
            self._m_hosts[host_id] = gauge
        return gauge

    def _event(self, kind, host=None, **kw):
        if self._slog is not None:
            with self._lock:
                hosts = sorted(h for h, e in self._hosts.items()
                               if e.live)
            self._slog.log_serve_host_event(kind, host=host,
                                            hosts=hosts, **kw)

    def _admit(self, host_id, address, lease_remaining=None):
        with self._lock:
            kind = "rejoin" if host_id in self._seen else "join"
            entry = self._hosts.get(host_id)
            if entry is not None and entry.live:
                entry.lease_remaining = lease_remaining
                return
            entry = _HostEntry(ServingHost(host_id, address,
                                           timeout=self.host_timeout))
            entry.lease_remaining = lease_remaining
            self._hosts[host_id] = entry
            self._seen.add(host_id)
            self._rebuild_ring_locked()
        self._gauge(host_id).set(1)
        self._event(kind, host=host_id, detail=address)
        logger.info("serving host %s %sed the cluster at %s",
                    host_id, kind, address)

    def _exclude(self, host_id, kind, detail=None):
        """Drop a host from dispatch NOW (dead transport or lapsed
        lease); its sessions re-home to ring successors on their next
        request — the carries live in the shared store, not here."""
        with self._lock:
            entry = self._hosts.get(host_id)
            if entry is None or not entry.live:
                return
            entry.live = False
            self._rebuild_ring_locked()
        self._gauge(host_id).set(0)
        if kind == "lease_lost":
            self._event("lease_lost", host=host_id, detail=detail)
        self._event("excluded", host=host_id, detail=detail)
        with self._lock:
            self._stats["hosts_excluded"] += 1
        logger.warning("serving host %s excluded (%s)", host_id,
                       detail or kind)

    def _refresh_membership(self):
        from paddle_tpu_torch.distributed.client import (
            CoordinatorClient, decode_host_meta)

        # a private client per call keeps the (single-threaded)
        # CoordinatorClient off the dispatch path entirely
        client = CoordinatorClient(self.endpoint, worker_id="serve-front",
                                   retry_timeout=5.0)
        try:
            reply = client.serve_hosts()
        finally:
            client.close()
        current = {}
        for entry in reply.get("hosts", []):
            meta = decode_host_meta(entry.get("meta"))
            addr = meta.get("addr")
            if not addr:
                continue
            current[str(entry["id"])] = (addr,
                                         entry.get("lease_remaining"))
        with self._lock:
            known_live = {h for h, e in self._hosts.items() if e.live}
        for host_id, (addr, lease) in current.items():
            self._admit(host_id, addr, lease_remaining=lease)
        for host_id in known_live - set(current):
            self._exclude(host_id, "lease_lost", detail="lease lapsed")

    def _watch_loop(self):
        while not self._stop.wait(self.poll_interval):
            try:
                self._refresh_membership()
            except Exception as exc:
                # a flapping coordinator must not take the data plane
                # with it: keep routing over the last good membership
                logger.warning("serve-host watch poll failed: %s", exc)

    # -- dispatch -----------------------------------------------------------
    def _shed(self, detail):
        self._m_shed.inc()
        observe_health.get_history().record_shed("no_host")
        with self._lock:
            self._stats["shed_no_host"] += 1
        raise Overloaded(
            "no live serving host (%s) — retry after /readyz goes green"
            % detail, model=self.model, reason="no_host")

    def _candidates(self, session_id):
        """Hosts to try, in order: the session's ring walk (home
        first), or round-robin over the live set for stateless
        traffic."""
        hosts, ring = self._snapshot()
        live = [h for h, e in sorted(hosts.items()) if e.live]
        if not live:
            self._shed("fleet of %d all cold or dead" % len(hosts))
        if session_id is not None and ring is not None:
            order = [h for h in ring.order(session_id) if h in set(live)]
            if order:
                return [hosts[h] for h in order]
            self._shed("no ring member live")
        with self._lock:
            self._rr += 1
            start = self._rr
        rotated = [live[(start + i) % len(live)]
                   for i in range(len(live))]
        return [hosts[h] for h in rotated]

    def _note_landing(self, session_id, host_id):
        """Remember where the session landed; a CHANGE of home is a
        re-home — the observable event the chaos drill counts."""
        if session_id is None:
            return
        with self._lock:
            last = self._session_last.get(session_id)
            self._session_last[session_id] = host_id
            self._session_last.move_to_end(session_id)
            while len(self._session_last) > _SESSION_LAST_CAP:
                self._session_last.popitem(last=False)
            if last is not None and last != host_id:
                self._stats["session_rehomes"] += 1
        if last is not None and last != host_id:
            counter = self._m_rehomes.get(host_id)
            if counter is None:
                counter = self.metrics.counter(
                    "paddle_tpu_serve_host_rehomes_total",
                    help="sessions re-homed onto this host after "
                         "their previous host left the ring",
                    labels={"host": host_id})
                self._m_rehomes[host_id] = counter
            counter.inc()
            self._event("session_rehome", host=last,
                        session=session_id, target=host_id)

    def _forget_session(self, session_id):
        if session_id is None:
            return
        with self._lock:
            self._session_last.pop(session_id, None)

    def dispatch_payload(self, payload):
        """Route one already-parsed ``/infer`` JSON payload; returns
        ``(status, body bytes)`` from the host that answered — the
        proxy handler relays both verbatim. Transport failures
        exclude the host immediately (don't wait out the lease) and
        retry the next ring successor, at most ``rehome_retries``
        extra hosts; a committed-session chunk spills (commits) on
        the host BEFORE the 200 comes back here."""
        session_id = payload.get("session_id")
        if session_id is not None:
            session_id = str(session_id)
        end_session = bool(payload.get("end_session"))
        body = json.dumps(payload).encode()
        entries = self._candidates(session_id)
        budget = min(len(entries), self.rehome_retries + 1)
        last_error = None
        for entry in entries[:budget]:
            host = entry.host
            try:
                status, rbody = host.request(
                    "POST", "/infer", body=body,
                    timeout=self.request_timeout)
                if (status == 200 and session_id is not None
                        and self.commit_sessions and not end_session):
                    host.spill(session_id, timeout=self.request_timeout)
            except (ConnectionError, OSError) as exc:
                last_error = exc
                self._exclude(host.host_id, "transport",
                              detail="transport: %s" % exc)
                continue
            with self._lock:
                self._stats["requests"] += 1
            self._note_landing(session_id, host.host_id)
            if session_id is not None and end_session and status == 200:
                self._forget_session(session_id)
            return status, rbody
        self._shed("transport failed on %d host(s): %s"
                   % (budget, last_error))

    def infer(self, arrays, timeout=None, session_id=None,
              end_session=False, trace=None):
        """The Python surface (mirrors an engine's ``infer``): builds
        the JSON request, dispatches with affinity/rehome, and types
        the outputs back against the hosts' manifest dtypes — float32
        survives the JSON round trip bitwise (every float32 is
        exactly representable as a double), which is what lets the
        chaos drill assert bitwise resume through this path."""
        payload = {"inputs": {k: np.asarray(v).tolist()
                              for k, v in arrays.items()},
                   "timeout_s": (self.request_timeout if timeout is None
                                 else float(timeout))}
        if session_id is not None:
            payload["session_id"] = str(session_id)
            if end_session:
                payload["end_session"] = True
        status, body = self.dispatch_payload(payload)
        obj = json.loads(body or b"{}")
        if status != 200:
            from paddle_tpu_torch.serve.sessions import SessionGone

            if status == 410:
                raise SessionGone(obj.get("error", "session gone"),
                                  session_id=obj.get("session_id"),
                                  reason=obj.get("reason"))
            if status == 429:
                raise Overloaded(obj.get("error", "overloaded"),
                                 model=obj.get("model"),
                                 priority=obj.get("priority"),
                                 reason=obj.get("reason"))
            raise RuntimeError("cluster infer answered %d: %s"
                               % (status, obj.get("error")))
        dtypes = self._output_dtypes()
        return {k: np.asarray(v, dtype=dtypes.get(k))
                for k, v in obj.get("outputs", {}).items()}

    def _output_dtypes(self):
        if self._out_dtypes is None:
            hosts, _ = self._snapshot()
            for _, entry in sorted(hosts.items()):
                if not entry.live:
                    continue
                try:
                    manifest = entry.host.manifest()
                except (ConnectionError, OSError, RuntimeError):
                    continue
                self._out_dtypes = {
                    spec["name"]: np.dtype(spec["dtype"])
                    for spec in manifest.get("outputs", [])}
                break
            else:
                return {}
        return self._out_dtypes

    def close_session(self, session_id):
        """Best-effort close across every live host (the carry may sit
        on any of them or in the shared store behind them; the verb is
        idempotent host-side, so the sweep is safe)."""
        sid = str(session_id)
        hosts, _ = self._snapshot()
        for _, entry in sorted(hosts.items()):
            if not entry.live:
                continue
            try:
                entry.host.post_json("/admin/session/close",
                                     {"session_id": sid}, timeout=5.0)
            except (ConnectionError, OSError):
                continue
        self._forget_session(sid)

    # -- probes / stats -----------------------------------------------------
    @property
    def supports_sessions(self):
        return True

    def hosts(self):
        """Membership snapshot for the ops surface: ``{host id:
        {"address", "live", "lease_remaining"}}``."""
        hosts, _ = self._snapshot()
        return {h: {"address": e.host.address, "live": e.live,
                    "lease_remaining": e.lease_remaining}
                for h, e in sorted(hosts.items())}

    def ready(self):
        """Aggregate readiness: at least one host, and EVERY live
        host's ``/readyz`` green (a cold host keeps the cluster
        not-ready, the fleet.py warmup contract one level up)."""
        detail = self.ready_detail()
        return bool(detail) and all(detail.values())

    def ready_detail(self):
        hosts, _ = self._snapshot()
        return {h: e.host.readyz()
                for h, e in sorted(hosts.items()) if e.live}

    def live(self):
        """Any host answering ``/livez`` keeps the cluster live."""
        hosts, _ = self._snapshot()
        return any(e.host.livez()
                   for e in hosts.values() if e.live)

    def live_detail(self):
        hosts, _ = self._snapshot()
        return {h: e.host.livez()
                for h, e in sorted(hosts.items()) if e.live}

    def queue_depth(self):
        total = 0
        hosts, _ = self._snapshot()
        for entry in hosts.values():
            if not entry.live:
                continue
            stats = entry.host.stats()
            if stats:
                total += int(stats.get("queue_depth", 0) or 0)
        return total

    def stats(self):
        hosts, _ = self._snapshot()
        with self._lock:
            counters = dict(self._stats)
            tracked = len(self._session_last)
        return {
            "hosts": {h: {"address": e.host.address, "live": e.live}
                      for h, e in sorted(hosts.items())},
            "hosts_live": sum(1 for e in hosts.values() if e.live),
            "requests": counters.get("requests", 0),
            "session_rehomes": counters.get("session_rehomes", 0),
            "hosts_excluded": counters.get("hosts_excluded", 0),
            "shed_no_host": counters.get("shed_no_host", 0),
            "sessions_tracked": tracked,
        }

    def stop(self):
        self._stop.set()
        if self._watch is not None:
            self._watch.join(timeout=max(self.poll_interval * 2, 2.0))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def make_front_server(front, host="127.0.0.1", port=0):
    """HTTP front door over a :class:`ClusterFront` (``cli serve
    --front``): ``POST /infer`` parses just enough of the body to
    route (session affinity needs the id), then relays the chosen
    host's status and body verbatim; ``GET /readyz`` is the
    aggregated per-host readiness, ``/hosts`` the membership
    snapshot. ``port=0`` picks a free port."""
    from http.server import ThreadingHTTPServer

    from paddle_tpu_torch.serve.server import _BaseHandler

    class _FrontHandler(_BaseHandler):
        def do_GET(self):
            if self.path == "/healthz":
                live, ready = front.live(), front.ready()
                self._send(200 if (live and ready) else 503,
                           {"ok": live and ready, "live": live,
                            "ready": ready, "hosts": front.hosts()})
            elif self.path == "/livez":
                live = front.live()
                self._send(200 if live else 503,
                           {"live": live,
                            "hosts": front.live_detail()})
            elif self.path == "/readyz":
                detail = front.ready_detail()
                ready = bool(detail) and all(detail.values())
                self._send(200 if ready else 503,
                           {"ready": ready, "hosts": detail})
            elif self.path == "/hosts":
                self._send(200, front.hosts())
            elif self.path == "/stats":
                self._send(200, front.stats())
            elif self.path == "/metrics":
                self._send_metrics(front.metrics)
            else:
                self._send(404, {"error": "unknown path %s" % self.path})

        def do_POST(self):
            if self.path != "/infer":
                self._send(404, {"error": "unknown path %s" % self.path})
                return

            def run():
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                status, body = front.dispatch_payload(payload)
                self._send_bytes(status, body, "application/json")

            self._infer_errors(run)

    return ThreadingHTTPServer((host, port), _FrontHandler)


def serve_front_in_thread(front, host="127.0.0.1", port=0):
    """Start the front-door server on a named daemon thread; returns
    (server, thread)."""
    server = make_front_server(front, host, port)
    thread = threading.Thread(target=server.serve_forever,
                              name="serve-front-http", daemon=True)
    thread.start()
    return server, thread
