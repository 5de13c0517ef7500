"""Remote session store: the session tier's backend shared by several
serving processes (paddle_tpu/serve/remote_store.py).

A :class:`~paddle_tpu_torch.serve.sessions.SessionStore` is process
memory: a committed conversation dies with its process, and an eviction
tombstone raised in one process is unknown to another. This module puts
one store behind a socket:

* :class:`StoreServer` — a standalone store process (or an in-process
  thread for tests): one ``SessionStore`` behind a TCP accept loop,
  speaking the frame codec of serve/workers.py (``encode_frames`` /
  ``decode_buffer``: a length-prefixed JSON header and raw array bytes,
  nothing pickled) — the JAX package's wire format, so either package's
  client talks to either package's server. ``python -m
  paddle_tpu_torch.serve.remote_store`` runs it and prints ``listening
  HOST:PORT``.
* :class:`RemoteSessionStore` — the client: the whole ``SessionStore``
  surface (``put``/``pop``/``tombstone``/``gone_reason``/``touch``/
  ``expire``/``stats``/...), so it slots into
  ``ContinuousScheduler(session_store=...)`` unchanged. Every process
  pointing at one store gets two properties: a carry spilled by process A
  restores bitwise in process B after A died, and an eviction answers 410
  Gone everywhere.

Eviction stays the store's job (``SessionStore``'s priority-ordered LRU
with the SLO grace); clients get back :class:`EvictedStub`s with the
fields the scheduler's accounting reads, not the evicted carries.
"""

import json
import socket
import threading
import time

import numpy as np

from paddle_tpu_torch.serve.sessions import SessionGone, SessionStore
from paddle_tpu_torch.serve.workers import (_U32, decode_buffer, decode_state,
                                            encode_frames, encode_state)
from paddle_tpu_torch.utils.logger import logger

# client-side retry bounds: a store restart mid-conversation heals, a dead
# store fails fast enough that the serving host answers an error, not a
# hang
_RETRY_TIMEOUT_S = 10.0
_RETRY_MAX_DELAY_S = 0.5


class EvictedStub:
    """What a remote ``put``/``expire`` returns for each victim: the
    accounting fields (``_account_evictions`` reads id/bytes/pos and
    the metrics label the priority), WITHOUT the carry — shipping
    evicted carries back over the wire would make eviction cost scale
    with the data the store just freed."""

    __slots__ = ("session_id", "nbytes", "pos", "priority")

    def __init__(self, session_id, nbytes, pos, priority):
        self.session_id = str(session_id)
        self.nbytes = int(nbytes)
        self.pos = int(pos)
        self.priority = priority


def _stub_header(state):
    return {"session_id": state.session_id, "nbytes": int(state.nbytes),
            "pos": int(state.pos), "priority": state.priority}


def _send_frames(sock, header, arrays=()):
    frames, _total = encode_frames(header, arrays)
    for frame in frames:
        sock.sendall(frame)


def _recv_exact(sock, n):
    chunks = []
    while n > 0:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("session-store peer closed mid-message")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv_message(sock):
    """One codec message off a stream socket: the u32 prefix sizes the
    header, the header's array specs size the payload — the exact
    ShmRing framing, reassembled into one buffer for decode_buffer."""
    prefix = sock.recv(_U32.size, socket.MSG_WAITALL)
    if not prefix:
        return None, None  # clean EOF between messages
    if len(prefix) < _U32.size:
        raise ConnectionError("session-store peer closed mid-prefix")
    hlen = _U32.unpack(prefix)[0]
    blob = _recv_exact(sock, hlen)
    body = sum(int(np.prod([int(d) for d in spec["shape"]] or [1],
                           dtype=np.int64))
               * (2 if spec["dtype"] == "bfloat16"
                  else np.dtype(spec["dtype"]).itemsize)
               for spec in json.loads(blob.decode("utf-8"))
               .get("arrays", []))
    payload = _recv_exact(sock, int(body)) if body else b""
    return decode_buffer(prefix + blob + payload)


class StoreServer:
    """The store process: one :class:`SessionStore` behind a TCP
    accept loop. Connections are persistent (one request/response
    message pair per round, many rounds per connection); every thread
    is named, and all shared state lives inside the inner
    store's own lock."""

    def __init__(self, host="127.0.0.1", port=0, capacity=4096,
                 slo_grace_ms=None, ttl_ms=None):
        self.store = SessionStore(capacity=capacity,
                                  slo_grace_ms=slo_grace_ms,
                                  ttl_ms=ttl_ms)
        self._sock = socket.create_server((host, port))
        self.address = "%s:%d" % self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._accept_thread = None
        self._conn_seq = 0
        # live connections, guarded by _conn_lock: stop() must close
        # them or their handler threads stay parked in recv forever
        self._conn_lock = threading.Lock()
        self._conns = {}  # socket -> handler thread

    def serve_in_thread(self):
        self._accept_thread = threading.Thread(
            target=self.serve_forever, name="session-store-accept",
            daemon=True)
        self._accept_thread.start()
        return self

    def serve_forever(self):
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            self._conn_seq += 1
            thread = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="session-store-conn-%d" % self._conn_seq,
                daemon=True)
            with self._conn_lock:
                self._conns[conn] = thread
            thread.start()

    def _serve_conn(self, conn):
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._stop.is_set():
                header, arrays = _recv_message(conn)
                if header is None:
                    return
                try:
                    reply, out = self._dispatch(header, arrays)
                except SessionGone as exc:
                    reply, out = {"error": "gone",
                                  "reason": exc.reason,
                                  "session_id": exc.session_id}, ()
                except KeyError as exc:
                    reply, out = {"error": "missing",
                                  "session_id": str(exc.args[0])}, ()
                except Exception as exc:  # noqa: BLE001 — answer, don't die
                    reply, out = {"error": "server",
                                  "detail": str(exc)}, ()
                _send_frames(conn, reply, out)
        except (ConnectionError, OSError):
            pass  # client went away; its sessions stay committed
        finally:
            conn.close()
            with self._conn_lock:
                self._conns.pop(conn, None)

    def _dispatch(self, header, arrays):
        """One verb -> (reply header, reply arrays). The hot pair is
        put/pop (every spill and restore crosses here); everything
        else is control plane."""
        op = header.get("op")
        store = self.store
        if op == "put":
            state = decode_state(header["session_id"], header["state"],
                                 arrays)
            evicted = store.put(state)
            return {"ok": True,
                    "evicted": [_stub_header(s) for s in evicted]}, ()
        if op == "pop":
            state = store.pop(header["session_id"])
            shead, sarrays = encode_state(state)
            return {"ok": True, "state": shead,
                    "session_id": state.session_id}, sarrays
        if op == "tombstone":
            store.tombstone(header["session_id"],
                            header.get("reason") or "evicted")
            return {"ok": True}, ()
        if op == "gone_reason":
            return {"ok": True,
                    "reason": store.gone_reason(header["session_id"])}, ()
        if op == "touch":
            store.touch(header["session_id"])
            return {"ok": True}, ()
        if op == "contains":
            return {"ok": True,
                    "value": header["session_id"] in store}, ()
        if op == "len":
            return {"ok": True, "value": len(store)}, ()
        if op == "expire":
            expired = store.expire()
            return {"ok": True,
                    "expired": [_stub_header(s) for s in expired]}, ()
        if op == "stats":
            return {"ok": True, "stats": store.stats()}, ()
        if op == "ping":
            return {"ok": True}, ()
        raise KeyError(op)

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        # unpark handler threads blocked in recv: close their sockets
        # out from under them, then join — the store's sessions stay
        # committed (only the transport dies)
        with self._conn_lock:
            live = list(self._conns.items())
        for conn, _thread in live:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        for _conn, thread in live:
            thread.join(timeout=2.0)


class RemoteSessionStore:
    """Client half: the full ``SessionStore`` duck-type over one
    persistent connection to a :class:`StoreServer`. Thread-safe (the
    scheduler's spill writer, admission path, and TTL sweeper all call
    in): one lock serializes the request/response rounds on the single
    socket, and a transport error reconnects with capped backoff
    (bounded by ``retry_timeout`` — a dead store must surface as an
    error on the serving host, not a hang)."""

    def __init__(self, address, timeout=10.0,
                 retry_timeout=_RETRY_TIMEOUT_S):
        host, _, port = str(address).rpartition(":")
        if not host or not port.isdigit():
            raise ValueError("session store address must be HOST:PORT, "
                             "got %r" % (address,))
        self._addr = (host, int(port))
        self.address = "%s:%d" % self._addr
        self._timeout = float(timeout)
        self._retry_timeout = float(retry_timeout)
        self._lock = threading.Lock()
        self._sock = None
        self._connect_locked()
        remote = self._call({"op": "stats"})[0]["stats"]
        # the scheduler treats capacity as the page-file bound it
        # reports in /stats; the REMOTE bound is authoritative here
        self.capacity = int(remote["capacity"])

    # -- transport ----------------------------------------------------------
    def _connect_locked(self):
        sock = socket.create_connection(self._addr, timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock

    def _call(self, header, arrays=()):
        """One RPC round; retries with capped backoff on transport
        errors (every verb is idempotent: put replaces, pop of a
        consumed id reports missing — by then the round that consumed
        it got its answer)."""
        deadline = time.monotonic() + self._retry_timeout
        delay = 0.05
        with self._lock:
            while True:
                try:
                    if self._sock is None:
                        self._connect_locked()
                    _send_frames(self._sock, header, arrays)
                    reply, out = _recv_message(self._sock)
                    if reply is None:
                        raise ConnectionError(
                            "session store closed the connection")
                    break
                except (ConnectionError, OSError, socket.timeout) as exc:
                    if self._sock is not None:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        self._sock = None
                    if time.monotonic() >= deadline:
                        raise ConnectionError(
                            "session store %s unreachable: %s"
                            % (self.address, exc)) from exc
                    time.sleep(delay)
                    delay = min(delay * 2, _RETRY_MAX_DELAY_S)
        error = reply.get("error")
        if error == "gone":
            sid = reply.get("session_id")
            raise SessionGone(
                "session %r was evicted from the session store "
                "(reason=%s); start a new session"
                % (sid, reply.get("reason")),
                session_id=sid, reason=reply.get("reason"))
        if error == "missing":
            raise KeyError(reply.get("session_id"))
        if error:
            raise RuntimeError("session store %s: %s"
                               % (self.address, reply.get("detail", error)))
        return reply, out

    # -- SessionStore surface ------------------------------------------------
    def put(self, state):
        shead, sarrays = encode_state(state)
        reply, _ = self._call({"op": "put",
                               "session_id": state.session_id,
                               "state": shead}, sarrays)
        return [EvictedStub(s["session_id"], s["nbytes"], s["pos"],
                            s["priority"]) for s in reply["evicted"]]

    def pop(self, session_id):
        reply, arrays = self._call({"op": "pop",
                                    "session_id": str(session_id)})
        return decode_state(reply["session_id"], reply["state"], arrays)

    def tombstone(self, session_id, reason):
        self._call({"op": "tombstone", "session_id": str(session_id),
                    "reason": reason})

    def gone_reason(self, session_id):
        reply, _ = self._call({"op": "gone_reason",
                               "session_id": str(session_id)})
        return reply["reason"]

    def touch(self, session_id):
        self._call({"op": "touch", "session_id": str(session_id)})

    def expire(self, now=None):
        # TTL policy runs on the store's clock; `now` is the local
        # overload's signature, meaningless across hosts
        reply, _ = self._call({"op": "expire"})
        return [EvictedStub(s["session_id"], s["nbytes"], s["pos"],
                            s["priority"]) for s in reply["expired"]]

    def suspended_count(self):
        reply, _ = self._call({"op": "len"})
        return reply["value"]

    def stats(self):
        reply, _ = self._call({"op": "stats"})
        stats = dict(reply["stats"])
        stats["remote"] = self.address
        return stats

    def ping(self):
        self._call({"op": "ping"})
        return True

    def __len__(self):
        return self.suspended_count()

    def __contains__(self, session_id):
        reply, _ = self._call({"op": "contains",
                               "session_id": str(session_id)})
        return reply["value"]

    def close(self):
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


def spawn_store_in_thread(capacity=4096, slo_grace_ms=None, ttl_ms=None,
                          host="127.0.0.1", port=0):
    """In-process store for tests/benches: returns a started
    :class:`StoreServer` (``.address`` is the dial string)."""
    return StoreServer(host=host, port=port, capacity=capacity,
                       slo_grace_ms=slo_grace_ms,
                       ttl_ms=ttl_ms).serve_in_thread()


def main(argv=None):
    """``python -m paddle_tpu_torch.serve.remote_store [--port P]
    [--capacity N] [--slo-grace-ms MS] [--ttl-ms MS]`` — the
    standalone store process (prints ``listening HOST:PORT`` on
    stdout so a launcher can scrape the bound port)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="paddle_tpu_torch.serve.remote_store",
        description="standalone remote session-store process")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--capacity", type=int, default=4096)
    parser.add_argument("--slo-grace-ms", type=float, default=None)
    parser.add_argument("--ttl-ms", type=float, default=None)
    args = parser.parse_args(argv)
    server = StoreServer(host=args.host, port=args.port,
                         capacity=args.capacity,
                         slo_grace_ms=args.slo_grace_ms,
                         ttl_ms=args.ttl_ms)
    print("listening %s" % server.address, flush=True)
    logger.info("session store listening on %s (capacity=%d)",
                server.address, args.capacity)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
