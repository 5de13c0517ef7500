"""Minimal HTTP front end over a bundle and its engine (stdlib only;
paddle_tpu/serve/server.py): ``POST /infer`` with the same JSON body
(``{"inputs": {flat key: nested list}}`` -> ``{"outputs": {name: list}}``),
``GET /healthz`` (live and ready; 503 while warming) and ``GET /readyz``.

Behind a continuous scheduler (``serve --continuous``) the ``/infer`` body
may carry ``session_id`` (continue that session's recurrent carry; echoed
in the answer) and ``end_session: true`` (close it with the request). An
evicted session answers 410 Gone with ``session_id`` and ``reason``; a
full decode queue answers 429. ``POST /admin/session/spill`` and
``/admin/session/close`` (body ``{"session_id": ...}``) are the session
tier's admin verbs; ``export`` and ``import`` carry the fleets' binary
frame codec, which is not ported yet, and answer 501.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from paddle_tpu_torch.serve.bundle import SEQ_KINDS, flat_keys
from paddle_tpu_torch.serve.engine import Overloaded
from paddle_tpu_torch.serve.sessions import SessionGone
from paddle_tpu_torch.utils.logger import logger


def _request_arrays(bundle, payload):
    """JSON request inputs -> typed flat feed arrays."""
    inputs = payload.get("inputs")
    if not isinstance(inputs, dict):
        raise ValueError('request body must be {"inputs": {...}}')
    dtypes = {}
    for spec in bundle.inputs:
        keys = flat_keys(spec)
        dtypes[keys[0]] = np.dtype(spec["dtype"])
        if spec["kind"] in SEQ_KINDS:
            dtypes[keys[1]] = np.int32
    out = {}
    for key, value in inputs.items():
        if key not in dtypes:
            raise ValueError("unknown input %r (expected %s)"
                             % (key, sorted(dtypes)))
        out[key] = np.asarray(value, dtype=dtypes[key])
    return out


class _Handler(BaseHTTPRequestHandler):
    engine = None
    bundle = None

    def _send(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # route through our logger, quietly
        logger.debug("serve http: " + fmt, *args)

    def do_GET(self):
        if self.path == "/healthz":
            live, ready = self.engine.live(), self.engine.ready()
            self._send(200 if (live and ready) else 503,
                       {"ok": live and ready, "live": live, "ready": ready,
                        "bundle": self.bundle.name})
        elif self.path == "/readyz":
            ready = self.engine.ready()
            self._send(200 if ready else 503, {"ready": ready})
        else:
            self._send(404, {"error": "unknown path %s" % self.path})

    def _infer(self, payload):
        arrays = _request_arrays(self.bundle, payload)
        timeout = float(payload.get("timeout_s", 60.0))
        session_id = payload.get("session_id")
        if session_id is None:
            result = self.engine.infer(arrays, timeout=timeout)
        else:
            session_id = str(session_id)
            if not getattr(self.engine, "supports_sessions", False):
                raise ValueError(
                    "this bundle does not hold sessions (re-export "
                    "with decode_slots= and serve --continuous)")
            result = self.engine.infer(
                arrays, timeout=timeout, session_id=session_id,
                end_session=bool(payload.get("end_session")))
        body = {"outputs": {k: np.asarray(v).tolist()
                            for k, v in result.items()}}
        if session_id is not None:
            body["session_id"] = session_id
        self._send(200, body)

    def _session_admin(self, verb, payload):
        """``spill`` commits a parked session's carry to the store and
        returns once it is there; ``close`` aborts a session wherever it
        sits (idempotent)."""
        engine = self.engine
        if not hasattr(engine, "spill_session"):
            raise ValueError(
                "this engine has no session admin surface (serve "
                "--continuous holds sessions; batch engines do not)")
        sid = payload.get("session_id")
        if sid is None:
            raise ValueError('body must be {"session_id": ...}')
        sid = str(sid)
        if verb == "close":
            engine.close_session(sid)
        else:
            engine.spill_session(
                sid, timeout=float(payload.get("timeout_s", 30.0)))
        self._send(200, {"ok": True, "session_id": sid})

    def do_POST(self):
        if self.path.startswith("/admin/session/"):
            verb = self.path[len("/admin/session/"):]
            if verb not in ("spill", "export", "import", "close"):
                self._send(404, {"error": "unknown path %s" % self.path})
                return
            if verb in ("export", "import"):
                self._send(501, {"error": "POST /admin/session/%s is not "
                                          "ported yet: it needs the fleets' "
                                          "binary frame codec "
                                          "(serve/workers.py)" % verb})
                return
        elif self.path != "/infer":
            self._send(404, {"error": "unknown path %s" % self.path})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(length) or b"{}")
            if self.path == "/infer":
                self._infer(payload)
            else:
                self._session_admin(verb, payload)
        except SessionGone as exc:
            # the carry was paged out of existence: start a new session
            self._send(410, {"error": str(exc),
                             "session_id": exc.session_id,
                             "reason": exc.reason})
        except Overloaded as exc:
            self._send(429, {"error": str(exc), "model": exc.model,
                             "priority": exc.priority,
                             "reason": exc.reason})
        except (ValueError, KeyError) as exc:
            self._send(400, {"error": str(exc)})
        except Exception as exc:  # noqa: BLE001 — surface, don't kill the server
            logger.exception("POST %s failed", self.path)
            self._send(500, {"error": str(exc)})


def make_server(bundle, engine, host="127.0.0.1", port=0):
    """Server bound to (host, port); ``port=0`` picks a free port
    (``server.server_address[1]`` is the actual one)."""
    handler = type("BundleHandler", (_Handler,),
                   {"engine": engine, "bundle": bundle})
    return ThreadingHTTPServer((host, port), handler)


def serve_in_thread(bundle, engine, host="127.0.0.1", port=0):
    """Start a server on a daemon thread; returns (server, thread). Stop it
    with ``server.shutdown(); server.server_close(); thread.join()``."""
    server = make_server(bundle, engine, host, port)
    thread = threading.Thread(target=server.serve_forever,
                              name="serve-http", daemon=True)
    thread.start()
    return server, thread
