"""Minimal HTTP front end over a bundle and its engine, or over a router
of several (stdlib only; paddle_tpu/serve/server.py).

``POST /infer`` takes ``{"inputs": {flat key: nested list}}`` and answers
``{"outputs": {name: list}}``. ``GET /healthz`` (live and ready; 503
while warming), ``/livez``, ``/readyz``, ``/metrics`` (Prometheus text of
the engine's registry: the ``paddle_tpu_serve_*`` families, and the
``paddle_tpu_slo_*`` / ``paddle_tpu_control_*`` ones with an objective or a
controller), ``/stats`` (the engine's ``stats()``), ``/debug/traces``
(sampling state and the slowest requests' phase breakdowns),
``/debug/slo`` (the burn-rate verdict), ``/debug/control`` (the
controller's knobs and action tape; 404 without one), ``/debug/compiles``
and ``/manifest``. A W3C ``traceparent`` header is adopted and echoed
(on error answers too); without one the server samples at
``PADDLE_TPU_TORCH_TRACE_SAMPLE``.

Behind a continuous scheduler (``serve --continuous``) the ``/infer`` body
may carry ``session_id`` (continue that session's recurrent carry; echoed
in the answer) and ``end_session: true`` (close it with the request). An
evicted session answers 410 Gone with ``session_id`` and ``reason``; a
full queue answers 429. ``POST /admin/session/spill`` and
``/admin/session/close`` (body ``{"session_id": ...}``) are the session
tier's admin verbs; ``export`` answers the session's state in the frame
codec of serve/workers.py (``application/x-paddle-frames``: header
``{"session_id", "state"}`` and the carry's raw arrays) and ``import``
takes such a body.

``make_router_server`` fronts a :class:`~paddle_tpu_torch.serve.router.
Router`: ``POST /infer/<model>`` (``/infer`` with one model), per-model
``/healthz`` / ``/livez`` / ``/readyz``, ``/manifest/<model>``, 429
shedding, and one ``/metrics`` over the router's registry and every
worker fleet's workers (``{worker=}``).
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from paddle_tpu_torch.observe import health as observe_health
from paddle_tpu_torch.observe import metrics as observe_metrics
from paddle_tpu_torch.observe import spans as observe_spans
from paddle_tpu_torch.observe import tracing as observe_tracing
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


class _BaseHandler(BaseHTTPRequestHandler):
    _FRAMES_TYPE = "application/x-paddle-frames"

    def _send(self, code, obj, headers=None):
        self._send_text(code, json.dumps(obj), "application/json",
                        headers=headers)

    def _send_text(self, code, text, content_type, headers=None):
        self._send_bytes(code, text.encode(), content_type,
                         headers=headers)

    def _send_bytes(self, code, body, content_type, headers=None):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(body)

    def _send_metrics(self, registry):
        # Prometheus text exposition, format version 0.0.4
        self._send_text(200, registry.to_prometheus(),
                        "text/plain; version=0.0.4; charset=utf-8")

    def log_message(self, fmt, *args):  # route through our logger, quietly
        logger.debug("serve http: " + fmt, *args)

    def _run_infer(self, bundle, infer_fn):
        """Shared request body handling: parse, type the arrays against
        ``bundle``'s manifest, run ``infer_fn(arrays, timeout_s,
        session_id, end_session, trace)``, answer JSON — the
        single-model and routed handlers differ only in the callable.
        ``session_id`` in the body continues that session's recurrent
        carry across requests; ``end_session: true`` closes it with the
        request.

        Request-scoped tracing: an inbound W3C
        ``traceparent`` header is honored (its sampled flag decides),
        else the front door rolls the ``PADDLE_TPU_TORCH_TRACE_SAMPLE`` dice
        ONCE here — :data:`~paddle_tpu_torch.observe.tracing.NOT_SAMPLED`
        propagates a negative decision so inner layers never re-roll.
        A sampled request runs inside a ``serve_http`` span and the
        response echoes ``traceparent`` with the server's span id, so
        the caller can link its own trace to ours."""
        # trace context FIRST, before anything that can raise (body
        # parse included): a sampled request that fails (400/410/429/
        # 500) must still echo traceparent — the failing requests are
        # exactly the ones a caller's tracer wants to link;
        # _infer_errors reads _trace_headers for that
        ctx = observe_tracing.TraceContext.from_traceparent(
            self.headers.get("traceparent"))
        if ctx is None:
            ctx = observe_tracing.sample() or observe_tracing.NOT_SAMPLED
        headers = None
        if ctx.sampled:
            headers = {"traceparent": ctx.traceparent()}
            self._trace_headers = headers
        length = int(self.headers.get("Content-Length", "0"))
        payload = json.loads(self.rfile.read(length) or b"{}")
        arrays = _request_arrays(bundle, payload)
        session_id = payload.get("session_id")
        if session_id is not None:
            session_id = str(session_id)
        timeout_s = float(payload.get("timeout_s", 60.0))
        end_session = bool(payload.get("end_session"))
        if ctx.sampled:
            # ctx IS the server's own span: from_traceparent minted a
            # fresh span id parented on the caller's, and mint() a
            # fresh root — childing again here would parent serve_http
            # (and the whole lane) on a span nothing ever records
            with observe_spans.span("serve_http",
                                    args={"path": self.path},
                                    trace=ctx):
                result = infer_fn(arrays, timeout_s, session_id,
                                  end_session, ctx)
        else:
            result = infer_fn(arrays, timeout_s, session_id,
                              end_session, observe_tracing.NOT_SAMPLED)
        body = {"outputs": {k: np.asarray(v).tolist()
                            for k, v in result.items()}}
        if session_id is not None:
            body["session_id"] = session_id
        self._send(200, body, headers=headers)

    def _infer_errors(self, fn):
        # per-request reset: keep-alive connections reuse this handler
        # object, and a previous request's trace must never leak onto
        # the next one's error response
        self._trace_headers = None
        try:
            fn()
        except SessionGone as exc:
            # explicit gone-semantics for evicted sessions: the carry
            # was paged out of existence, so the conversation cannot
            # continue — 410 Gone tells the client to START A NEW
            # SESSION rather than retry (a retry can never succeed)
            self._send(410, {"error": str(exc),
                             "session_id": exc.session_id,
                             "reason": exc.reason},
                       headers=self._trace_headers)
        except Overloaded as exc:
            # the fast shed path: tell the client to back off / retry
            # elsewhere BEFORE any queueing happened (429 Too Many
            # Requests, the load-shed status)
            self._send(429, {"error": str(exc), "model": exc.model,
                             "priority": exc.priority,
                             "reason": exc.reason},
                       headers=self._trace_headers)
        except (ValueError, KeyError) as exc:
            self._send(400, {"error": str(exc)},
                       headers=self._trace_headers)
        except Exception as exc:  # noqa: BLE001 — surface, don't kill the server
            logger.exception("%s %s failed", self.command, self.path)
            self._send(500, {"error": str(exc)},
                       headers=self._trace_headers)


class _Handler(_BaseHandler):
    """Single-model handler."""

    engine = None
    bundle = None
    slo = None
    controller = None
    compiles_fn = None
    launches_fn = None

    def do_GET(self):
        if self.path == "/healthz":
            live, ready = self.engine.live(), self.engine.ready()
            self._send(200 if (live and ready) else 503,
                       {"ok": live and ready, "live": live,
                        "ready": ready, "bundle": self.bundle.name})
        elif self.path == "/livez":
            live = self.engine.live()
            self._send(200 if live else 503, {"live": live})
        elif self.path == "/readyz":
            ready = self.engine.ready()
            self._send(200 if ready else 503, {"ready": ready})
        elif self.path == "/metrics":
            self._send_metrics(self.engine.metrics)
        elif self.path == "/stats":
            stats = self.engine.stats()
            if self.launches_fn is not None:
                stats["kernel_launches"] = self.launches_fn()
            self._send(200, stats)
        elif self.path == "/debug/traces":
            # sampling state + the slowest-N per-request phase
            # breakdowns (exemplars are kept for every request, so this
            # answers at sample rate 0 too)
            self._send(200, observe_health.collect_traces([self.engine]))
        elif self.path == "/debug/slo":
            self._send(200, self.slo.evaluate())
        elif self.path == "/debug/control":
            # 404 (not an empty body) without --autotune, so a probe can
            # tell "controller off" from "controller idle"
            if self.controller is None:
                self._send(404, {"error": "no controller on this "
                                          "server (serve --autotune)"})
            else:
                self._send(200, self.controller.snapshot())
        elif self.path == "/debug/compiles":
            # the programs made ready since serve started: the cluster
            # front diffs this across a host's death to show that a
            # re-homed session loaded nothing new on the survivor
            if self.compiles_fn is None:
                self._send(404, {"error": "no compile watcher on this "
                                          "server (serve --join)"})
            else:
                self._send(200, {"compiles": int(self.compiles_fn())})
        elif self.path == "/manifest":
            self._send(200, self.bundle.manifest)
        else:
            self._send(404, {"error": "unknown path %s" % self.path})

    def _session_admin(self, verb):
        """``spill`` commits a parked session's carry to the store and
        returns once it is there; ``close`` aborts a session wherever it
        sits (idempotent); ``export`` removes the session's state and
        answers it as frames; ``import`` adopts frames a peer exported."""
        engine = self.engine
        if not hasattr(engine, "spill_session"):
            raise ValueError(
                "this engine has no session admin surface (serve "
                "--continuous holds sessions; batch engines do not)")
        from paddle_tpu_torch.serve import workers as serve_workers

        length = int(self.headers.get("Content-Length", "0"))
        if verb == "import":
            header, arrays = serve_workers.decode_buffer(
                self.rfile.read(length))
            sid = str(header["session_id"])
            state = serve_workers.decode_state(sid, header["state"], arrays)
            engine.import_session(sid, state)
            self._send(200, {"ok": True, "session_id": sid,
                             "nbytes": int(state.nbytes)})
            return
        payload = json.loads(self.rfile.read(length) or b"{}")
        sid = payload.get("session_id")
        if sid is None:
            raise ValueError('body must be {"session_id": ...}')
        sid = str(sid)
        timeout = float(payload.get("timeout_s", 30.0))
        if verb == "close":
            engine.close_session(sid)
        elif verb == "spill":
            engine.spill_session(sid, timeout=timeout)
        else:  # export
            shead, sarrays = serve_workers.encode_state(
                engine.export_session(sid, timeout=timeout))
            frames, _total = serve_workers.encode_frames(
                {"session_id": sid, "state": shead}, sarrays)
            self._send_bytes(200, b"".join(bytes(f) for f in frames),
                             self._FRAMES_TYPE)
            return
        self._send(200, {"ok": True, "session_id": sid})

    def do_POST(self):
        if self.path.startswith("/admin/session/"):
            verb = self.path[len("/admin/session/"):]
            if verb not in ("spill", "export", "import", "close"):
                self._send(404, {"error": "unknown path %s" % self.path})
            else:
                self._infer_errors(lambda: self._session_admin(verb))
            return
        if self.path != "/infer":
            self._send(404, {"error": "unknown path %s" % self.path})
            return

        def infer(arrays, timeout, session_id, end_session, trace):
            if session_id is None:
                return self.engine.infer(arrays, timeout=timeout,
                                         trace=trace)
            if not getattr(self.engine, "supports_sessions", False):
                raise ValueError(
                    "this bundle does not hold sessions (re-export "
                    "with decode_slots= and serve --continuous)")
            return self.engine.infer(arrays, timeout=timeout,
                                     session_id=session_id,
                                     end_session=end_session,
                                     trace=trace)

        self._infer_errors(
            lambda: self._run_infer(self.bundle, infer))


class _RouterHandler(_BaseHandler):
    """Multi-model handler over a Router."""

    router = None
    slo = None
    controller = None

    def do_GET(self):
        router = self.router
        if self.path == "/healthz":
            live, ready = router.live(), router.ready()
            live_d, ready_d = router.live_detail(), router.ready_detail()
            self._send(200 if (live and ready) else 503,
                       {"ok": live and ready, "live": live,
                        "ready": ready,
                        "models": {name: {"live": live_d[name],
                                          "ready": ready_d[name]}
                                   for name in sorted(live_d)}})
        elif self.path == "/livez":
            live = router.live()
            self._send(200 if live else 503,
                       {"live": live, "models": router.live_detail()})
        elif self.path == "/readyz":
            # 503 until every hosted model is warm
            ready = router.ready()
            self._send(200 if ready else 503,
                       {"ready": ready, "models": router.ready_detail()})
        elif self.path == "/metrics":
            # the router's registry, and each worker fleet's workers under
            # {worker=} (their series carry {model=} too)
            extras = [dump for front in self._fronts()
                      if hasattr(front, "metric_dumps")
                      for dump in front.metric_dumps()]
            self._send_text(200, observe_metrics.merged_exposition(
                router.metrics, extras),
                "text/plain; version=0.0.4; charset=utf-8")
        elif self.path == "/stats":
            self._send(200, router.stats())
        elif self.path == "/debug/traces":
            self._send(200, observe_health.collect_traces(self._fronts()))
        elif self.path == "/debug/slo":
            self._send(200, self.slo.evaluate())
        elif self.path == "/debug/control":
            if self.controller is None:
                self._send(404, {"error": "no controller on this "
                                          "server (serve --autotune)"})
            else:
                self._send(200, self.controller.snapshot())
        elif self.path == "/manifest":
            try:
                self._send(200, router.default_model().bundle.manifest)
            except KeyError as exc:
                self._send(400, {"error": str(exc)})
        elif self.path.startswith("/manifest/"):
            try:
                name = self.path[len("/manifest/"):]
                self._send(200, router.model(name).bundle.manifest)
            except KeyError as exc:
                self._send(404, {"error": str(exc)})
        else:
            self._send(404, {"error": "unknown path %s" % self.path})

    def do_POST(self):
        router = self.router
        if self.path == "/infer":
            def run():
                self._route(router.default_model())
        elif self.path.startswith("/infer/"):
            name = self.path[len("/infer/"):]

            def run():
                try:
                    hosted = router.model(name)
                except KeyError as exc:
                    self._send(404, {"error": str(exc)})
                    return
                self._route(hosted)
        else:
            self._send(404, {"error": "unknown path %s" % self.path})
            return
        self._infer_errors(run)

    def _route(self, hosted):
        self._run_infer(
            hosted.bundle,
            lambda arrays, timeout, session_id, end_session, trace:
                self.router.infer(hosted.name, arrays, timeout=timeout,
                                  session_id=session_id,
                                  end_session=end_session, trace=trace))

    def _fronts(self):
        return [m.engine for m in self.router.models().values()]


class _Server(ThreadingHTTPServer):
    """The stdlib threading server with a listen backlog for bursts: the
    default of 5 pending connections resets a burst's clients before the
    engine's queue bound can answer them 429."""

    request_queue_size = 128


def make_server(bundle, engine, host="127.0.0.1", port=0, slo=None,
                controller=None, compiles_fn=None, launches_fn=None):
    """Server bound to (host, port); ``port=0`` picks a free port
    (``server.server_address[1]`` is the actual one). ``slo=`` is a
    :class:`~paddle_tpu_torch.observe.health.SloMonitor`; when omitted a
    no-objective monitor is built so ``GET /debug/slo`` always answers.
    ``controller=`` (a :class:`~paddle_tpu_torch.control.Controller`)
    enables ``GET /debug/control``. ``compiles_fn=`` (``cli serve
    --join`` passes a :func:`~paddle_tpu_torch.observe.steplog.
    watch_compiles` counter) enables ``GET /debug/compiles``; without it
    the route answers 404, as the JAX server's does. ``launches_fn=``
    (``cli serve --join`` passes the process's kernel launch counters)
    adds ``kernel_launches`` to ``GET /stats``, as a worker fleet's
    ``/stats`` carries each worker's."""
    if slo is None:
        slo = observe_health.SloMonitor([engine])
    handler = type("BundleHandler", (_Handler,),
                   {"engine": engine, "bundle": bundle, "slo": slo,
                    "controller": controller,
                    "compiles_fn": staticmethod(compiles_fn),
                    "launches_fn": staticmethod(launches_fn)})
    return _Server((host, port), handler)


def serve_in_thread(bundle, engine, host="127.0.0.1", port=0, slo=None,
                    controller=None, compiles_fn=None):
    """Start a server on a daemon thread; returns (server, thread). Stop it
    with ``server.shutdown(); server.server_close(); thread.join()``."""
    server = make_server(bundle, engine, host, port, slo=slo,
                         controller=controller, compiles_fn=compiles_fn)
    thread = threading.Thread(target=server.serve_forever,
                              name="serve-http", daemon=True)
    thread.start()
    return server, thread


def make_router_server(router, host="127.0.0.1", port=0, slo=None,
                       controller=None):
    """Multi-model server over a :class:`~paddle_tpu_torch.serve.router.
    Router` (``POST /infer/<model>``, per-model ``/readyz``, 429
    shedding)."""
    if slo is None:
        slo = observe_health.SloMonitor(
            [m.engine for m in router.models().values()])
    handler = type("RouterHandler", (_RouterHandler,),
                   {"router": router, "slo": slo,
                    "controller": controller})
    return _Server((host, port), handler)


def serve_router_in_thread(router, host="127.0.0.1", port=0, slo=None,
                           controller=None):
    """Start a router server on a daemon thread; returns (server,
    thread)."""
    server = make_router_server(router, host, port, slo=slo,
                                controller=controller)
    thread = threading.Thread(target=server.serve_forever,
                              name="serve-http", daemon=True)
    thread.start()
    return server, thread
