"""Request tracing in the port's serving tier, against the JAX package
(tests/test_tracing.py, ported): ``observe/tracing.py`` is the port's own
copy of the JAX module, and the engine, the scheduler and the HTTP front
end take ``trace=`` as the JAX ones do.

* the W3C ``traceparent`` round trip, sampling decisions, the exemplar
  reservoir and the tail attribution, each also held against the JAX
  package's functions on the same inputs;
* phase honesty: a sampled request's ``serve_trace`` phases sum to within
  5% of its measured wall time, on the engine path (queue / batch-form /
  dispatch / serialize) and the scheduler path (queue / spill-restore /
  decode / serialize);
* one flow-linked lane: a session request through HTTP -> continuous
  scheduler -> spill/restore carries one trace id across the server
  thread, the decode worker and the spill writer;
* ``/debug/traces`` and ``/stats`` at sample rate 0, the traceparent echo
  on error answers, the step log's flush durability, a raising telemetry
  sink that loses telemetry and never results, and ``cli observe``'s tail
  report.

Left out with the part it needs: the trace-overhead bench smoke
(``benchmark/exp_serve.py``, which gates against TPU rows). The worker
fleet's merged ``/debug/traces`` is held in tests/test_torch_workers.py.
"""

import glob
import json
import os
import urllib.request

import numpy as np
import pytest

from paddle_tpu.observe import tracing as jax_tracing

from paddle_tpu_torch.observe import spans, steplog, tracing


# -- fixtures ----------------------------------------------------------------

@pytest.fixture(scope="module")
def mlp_bundle(tmp_path_factory):
    from paddle_tpu_torch.graph import reset_name_counters
    from paddle_tpu_torch.models.vision import mlp
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.serve import load_bundle
    from paddle_tpu_torch.serve.export import export_bundle

    tmp = tmp_path_factory.mktemp("tracing_mlp")
    reset_name_counters()
    out = mlp(hidden=(16, 8))
    params = Parameters.create(out, device="cpu")
    export_bundle(out, params, str(tmp / "b"), batch_sizes=(1, 4),
                  name="mnist_mlp")
    return load_bundle(str(tmp / "b"), device="cpu")


@pytest.fixture(scope="module")
def decode_bundle(tmp_path_factory):
    from paddle_tpu_torch.graph import reset_name_counters
    from paddle_tpu_torch.models.text import sequence_tagging_gru
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.serve import load_bundle
    from paddle_tpu_torch.serve.export import export_bundle

    tmp = tmp_path_factory.mktemp("tracing_tagger")
    reset_name_counters()
    out = sequence_tagging_gru(dict_size=50, label_size=5, emb_size=8,
                               hidden=12)
    params = Parameters.create(out, device="cpu")
    export_bundle(out, params, str(tmp / "b"), batch_sizes=(1,),
                  seq_len=32, name="tagger", decode_slots=(2,),
                  decode_window=4)
    return load_bundle(str(tmp / "b"), device="cpu")


@pytest.fixture()
def recording_tracer(tmp_path, monkeypatch):
    """Fresh global-tracer recording window: telemetry env on (the
    trace consumer), tracer cleared before AND after so span assertions
    never see another test's events."""
    monkeypatch.setenv("PADDLE_TPU_TORCH_TELEMETRY", str(tmp_path / "telem"))
    monkeypatch.delenv("PADDLE_TPU_TORCH_TRACE_SAMPLE", raising=False)
    tracer = spans.get_tracer()
    tracer.reset()
    tracing.get_exemplars().reset()
    yield tracer
    tracer.reset()


def _pixel(rows=1, seed=0):
    return np.random.RandomState(seed).randn(rows, 784).astype(np.float32)


# -- TraceContext / sampling -------------------------------------------------

def test_traceparent_roundtrip():
    ctx = tracing.TraceContext.mint()
    assert len(ctx.trace_id) == 32 and len(ctx.span_id) == 16
    header = ctx.traceparent()
    back = tracing.TraceContext.from_traceparent(header)
    assert back.trace_id == ctx.trace_id
    assert back.parent_id == ctx.span_id  # caller's span becomes parent
    assert back.sampled
    child = ctx.child()
    assert child.trace_id == ctx.trace_id
    assert child.parent_id == ctx.span_id
    assert child.span_id != ctx.span_id


def test_traceparent_rejects_malformed():
    bad = ["", None, "junk", "00-zz-aa-01", "00-" + "0" * 32 + "-" +
           "1" * 16 + "-01", "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
           "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
           # W3C-invalid: version ff, uppercase hex, version-00 extras
           "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
           "00-" + "A" * 32 + "-" + "b" * 16 + "-01",
           "00-" + "a" * 32 + "-" + "b" * 16 + "-01-extra"]
    for header in bad:
        assert tracing.TraceContext.from_traceparent(header) is None
    # a FUTURE version may append extra fields: leading four parse
    fut = tracing.TraceContext.from_traceparent(
        "01-" + "a" * 32 + "-" + "b" * 16 + "-01-extrafield")
    assert fut is not None and fut.sampled
    assert fut.trace_id == "a" * 32 and fut.parent_id == "b" * 16
    # an explicitly UNSAMPLED inbound header parses but stays unsampled
    off = tracing.TraceContext.from_traceparent(
        "00-" + "a" * 32 + "-" + "b" * 16 + "-00")
    assert off is not None and not off.sampled


def test_resolve_sampling_decisions(monkeypatch):
    # rate 0 (default): direct submits stay untraced
    monkeypatch.delenv("PADDLE_TPU_TORCH_TRACE_SAMPLE", raising=False)
    assert tracing.resolve(None) is None
    # rate 1: every undecided submit traces
    monkeypatch.setenv("PADDLE_TPU_TORCH_TRACE_SAMPLE", "1.0")
    assert tracing.resolve(None) is not None
    # an upstream NO decision is final — no re-roll at rate 1
    assert tracing.resolve(tracing.NOT_SAMPLED) is None
    # an upstream sampled context passes through untouched
    ctx = tracing.TraceContext.mint()
    assert tracing.resolve(ctx) is ctx


def test_exemplar_reservoir_keeps_slowest():
    ex = tracing.TraceExemplars(capacity=3)
    for ms in (5.0, 50.0, 1.0, 30.0, 2.0, 40.0):
        ex.offer(ms, {"queue_ms": ms / 2, "dispatch_ms": ms / 2},
                 model="m")
    slowest = ex.slowest()
    assert [e["latency_ms"] for e in slowest] == [50.0, 40.0, 30.0]
    assert ex.stats() == {"offered": 6, "kept": 3}
    assert slowest[0]["model"] == "m"


def test_tail_attribution_names_the_dominant_phase():
    # 99 fast dispatch-bound requests + 1 queue-drowned straggler: the
    # tail report must say the p99 is queue-wait
    records = [{"latency_ms": 2.0,
                "phases": {"queue_ms": 0.2, "dispatch_ms": 1.8}}
               for _ in range(99)]
    records.append({"latency_ms": 100.0,
                    "phases": {"queue_ms": 90.0, "dispatch_ms": 10.0}})
    tail = tracing.tail_attribution(records, q=99)
    assert tail["requests"] == 100 and tail["tail_requests"] >= 1
    assert tail["phases"]["queue_ms"] > tail["phases"]["dispatch_ms"]
    assert sum(tail["phases"].values()) == pytest.approx(100.0, abs=0.5)
    assert tracing.tail_attribution([]) is None


# -- engine path -------------------------------------------------------------

def test_engine_phase_sum_and_serve_trace(mlp_bundle, tmp_path,
                                          recording_tracer):
    """Acceptance (engine half): a sampled request's serve_trace phase
    breakdown sums to within 5% of its measured wall time, and the
    spans carry the trace id."""
    from paddle_tpu_torch.observe.metrics import MetricsRegistry
    from paddle_tpu_torch.serve import InferenceEngine

    log = steplog.StepLog(str(tmp_path / "slog"), run_name="serve",
                          flush_every=1)
    ctx = tracing.TraceContext.mint()
    with InferenceEngine(mlp_bundle, metrics_registry=MetricsRegistry(),
                         steplog=log, model="mlp") as eng:
        eng.infer({"pixel": _pixel()}, trace=ctx)
        eng.infer({"pixel": _pixel(seed=1)})  # undecided -> rate 0 -> no
    log.close()
    recs = steplog.read_jsonl(log.path)
    traces = [r for r in recs if r["type"] == "serve_trace"]
    assert len(traces) == 1  # only the explicitly traced request
    rec = traces[0]
    assert rec["trace"] == ctx.trace_id and rec["model"] == "mlp"
    assert set(rec["phases"]) == {"queue_ms", "batch_form_ms",
                                 "dispatch_ms", "serialize_ms"}
    total = sum(rec["phases"].values())
    assert total == pytest.approx(rec["latency_ms"],
                                  rel=0.05, abs=0.05)
    tagged = [e for e in recording_tracer.events()
              if e[5] and e[5][0] == ctx.trace_id]
    assert {e[0] for e in tagged} == {"serve_queue_wait",
                                      "serve_batch_form",
                                      "serve_dispatch",
                                      "serve_serialize"}
    # both requests fed the always-on exemplar reservoir
    assert tracing.get_exemplars().stats()["offered"] == 2


# -- THE acceptance: one flow-linked lane across the serving tier ------------

def test_session_request_renders_one_flow_linked_lane(decode_bundle,
                                                      tmp_path,
                                                      recording_tracer):
    """One request traced through HTTP -> continuous scheduler -> session
    spill/restore (the router and the replica fleet are not ported): a
    single trace id spans the HTTP server thread, the decode worker and
    the spill-writer thread,
    the exported Chrome trace chains them with flow events, the
    response echoes traceparent, and the serve_trace breakdown sums to
    within 5% of the measured wall — with the spill/restore wait
    visible as its own phase."""
    from paddle_tpu_torch.observe.metrics import MetricsRegistry
    from paddle_tpu_torch.serve import ContinuousScheduler
    from paddle_tpu_torch.serve.server import serve_in_thread

    sched = ContinuousScheduler(decode_bundle, max_queue=None,
                                metrics_registry=MetricsRegistry(),
                                model="tagger")
    server, _ = serve_in_thread(decode_bundle, sched)
    base = "http://%s:%d" % server.server_address
    seq = (np.random.RandomState(7)
           .randint(0, 50, size=(12,)).astype(np.int32))
    trace_id = "ab" * 16

    def post(body, parent):
        req = urllib.request.Request(
            base + "/infer", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json",
                     "traceparent": "00-%s-%s-01" % (trace_id, parent)})
        resp = urllib.request.urlopen(req, timeout=60)
        return json.load(resp), resp.headers.get("traceparent")

    try:
        _, echo1 = post({"inputs": {"word": seq[:6].tolist()},
                         "session_id": "lane"}, "cd" * 8)
        # the response echoes OUR trace id with the server's span id
        assert echo1.startswith("00-%s-" % trace_id)
        echo_span = echo1.split("-")[2]
        assert echo_span != "cd" * 8
        # park -> forced spill (writer thread) -> restore on chunk 2
        sched.spill_session("lane")
        _, _ = post({"inputs": {"word": seq[6:].tolist()},
                     "session_id": "lane", "end_session": True},
                    "ef" * 8)
    finally:
        server.shutdown()
        server.server_close()
        sched.stop()

    # ONE trace id across >= 3 threads: HTTP handler, decode worker,
    # spill writer — with the spill and restore spans in the lane
    tagged = [e for e in recording_tracer.events()
              if e[5] and e[5][0] == trace_id]
    names = {e[0] for e in tagged}
    assert {"serve_http", "serve_queue_wait", "serve_decode_seq",
            "serve_serialize", "serve_swap_spill",
            "serve_swap_restore"} <= names
    assert len({e[3] for e in tagged}) >= 3  # distinct thread idents
    # the echoed span id IS a recorded span (the serve_http slice) —
    # no phantom parent between the caller's span and the lane
    http_span_ids = {e[5][1] for e in tagged if e[0] == "serve_http"}
    assert echo_span in http_span_ids
    # the exported Chrome trace chains the lane with flow arrows
    chrome = recording_tracer.to_chrome_trace()["traceEvents"]
    lane = [e for e in chrome
            if e.get("args", {}).get("trace_id") == trace_id]
    assert len({e["tid"] for e in lane}) >= 3
    flow = [e for e in chrome if e.get("cat") == "serve_trace"]
    assert {"s", "t", "f"} <= {e["ph"] for e in flow}
    flow_ids = {e["id"] for e in flow}
    assert len(flow_ids) == 1  # one chain per trace
    # serve_trace records: phases sum to the measured wall; the
    # restored chunk shows spill/restore as its own phase
    logs = glob.glob(os.path.join(os.environ["PADDLE_TPU_TORCH_TELEMETRY"],
                                  "*.steps.jsonl"))
    traces = [r for p in logs for r in steplog.read_jsonl(p)
              if r.get("type") == "serve_trace"
              and r.get("trace") == trace_id]
    assert len(traces) == 2
    for rec in traces:
        assert set(rec["phases"]) == {"queue_ms", "spill_restore_ms",
                                      "decode_ms", "serialize_ms"}
        total = sum(rec["phases"].values())
        assert total == pytest.approx(rec["latency_ms"],
                                      rel=0.05, abs=0.05)
        assert rec["session"] == "lane" and rec["iterations"] >= 1
    restored = traces[-1]
    assert restored["phases"]["spill_restore_ms"] > 0.0


# -- /debug/traces, /stats, sampling off -------------------------------------

def test_debug_traces_and_stats_at_rate_zero(mlp_bundle, monkeypatch):
    """Exemplars are always-on: at sample rate 0 nothing is traced, but
    /debug/traces still serves the slowest-N phase breakdowns and
    /stats reports the sampling state."""
    from paddle_tpu_torch.observe.metrics import MetricsRegistry
    from paddle_tpu_torch.serve import InferenceEngine
    from paddle_tpu_torch.serve.server import serve_in_thread

    monkeypatch.delenv("PADDLE_TPU_TORCH_TRACE_SAMPLE", raising=False)
    tracing.get_exemplars().reset()
    with InferenceEngine(mlp_bundle,
                         metrics_registry=MetricsRegistry()) as eng:
        server, _ = serve_in_thread(mlp_bundle, eng)
        base = "http://%s:%d" % server.server_address
        try:
            for i in range(3):
                body = json.dumps(
                    {"inputs": {"pixel": _pixel(seed=i).tolist()}})
                req = urllib.request.Request(
                    base + "/infer", data=body.encode(),
                    headers={"Content-Type": "application/json"})
                resp = urllib.request.urlopen(req, timeout=60)
                # unsampled: no traceparent echo
                assert resp.headers.get("traceparent") is None
                json.load(resp)
            debug = json.load(urllib.request.urlopen(
                base + "/debug/traces", timeout=30))
            assert debug["sample_rate"] == 0.0
            assert len(debug["slowest"]) == 3
            assert all("phases" in e and "latency_ms" in e
                       for e in debug["slowest"])
            lats = [e["latency_ms"] for e in debug["slowest"]]
            assert lats == sorted(lats, reverse=True)
            stats = json.load(urllib.request.urlopen(base + "/stats",
                                                     timeout=30))
            assert stats["trace"]["sample_rate"] == 0.0
        finally:
            server.shutdown()
            server.server_close()


# -- steplog durability (satellite) ------------------------------------------

def test_flush_every_records_survive_engine_stop(mlp_bundle, tmp_path):
    """The durability fix: a burst through an engine on a shared
    flush_every=32 steplog, engine stopped mid-life — every completed
    request's record is on disk after stop(), none buffered away."""
    from paddle_tpu_torch.observe.metrics import MetricsRegistry
    from paddle_tpu_torch.serve import InferenceEngine

    log = steplog.StepLog(str(tmp_path), run_name="burst",
                          flush_every=32, compile_events=False)
    eng = InferenceEngine(mlp_bundle, metrics_registry=MetricsRegistry(),
                          steplog=log)
    futures = [eng.submit({"pixel": _pixel(seed=i)}) for i in range(6)]
    eng.stop()  # drains the queue, then flushes the shared log
    done = sum(1 for f in futures if f.done() and not f.exception())
    assert done == 6
    recs = steplog.read_jsonl(log.path)
    assert sum(1 for r in recs if r["type"] == "serve_request") == done
    log.close()


def test_atexit_guard_flushes_open_logs(tmp_path):
    """Interpreter-exit half: the atexit guard flushes every still-open
    log, so a crash/exit with <flush_every buffered records keeps
    them."""
    log = steplog.StepLog(str(tmp_path), run_name="exitcase",
                          flush_every=100, compile_events=False)
    for i in range(3):
        log.log_serve_request(rows=1, queue_ms=0.1, latency_ms=1.0,
                              req_id=i)
    # buffered, not yet on disk (meta flushed by the first write)
    assert steplog._atexit_registered
    steplog._flush_live_logs()
    recs = steplog.read_jsonl(log.path)
    assert sum(1 for r in recs if r["type"] == "serve_request") == 3
    log.close()


def test_error_responses_echo_traceparent(mlp_bundle, monkeypatch):
    """The failing requests are exactly the ones a caller's tracer
    wants to link: a sampled request answered 400 still carries the
    traceparent echo."""
    import urllib.error

    from paddle_tpu_torch.observe.metrics import MetricsRegistry
    from paddle_tpu_torch.serve import InferenceEngine
    from paddle_tpu_torch.serve.server import serve_in_thread

    monkeypatch.delenv("PADDLE_TPU_TORCH_TRACE_SAMPLE", raising=False)
    trace_id = "be" * 16
    with InferenceEngine(mlp_bundle,
                         metrics_registry=MetricsRegistry()) as eng:
        server, _ = serve_in_thread(mlp_bundle, eng)
        base = "http://%s:%d" % server.server_address
        try:
            req = urllib.request.Request(
                base + "/infer",
                data=json.dumps({"inputs": {"nope": [1]}}).encode(),
                headers={"Content-Type": "application/json",
                         "traceparent": "00-%s-%s-01"
                                        % (trace_id, "11" * 8)})
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                urllib.request.urlopen(req, timeout=60)
            assert exc_info.value.code == 400
            echo = exc_info.value.headers.get("traceparent")
            assert echo and echo.split("-")[1] == trace_id
        finally:
            server.shutdown()
            server.server_close()


class _ExplodingLog:
    """Duck-typed steplog whose per-request sink raises (the
    disk-full case): telemetry must be lost, results must not."""

    def log_serve_request(self, **kw):
        raise OSError("disk full")

    log_serve_trace = log_serve_request

    def log_serve_decode(self, **kw):
        pass

    log_serve_swap = log_serve_batch = log_serve_shed = log_serve_decode

    def write(self, record):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def test_failing_telemetry_sink_never_strands_results(decode_bundle,
                                                      mlp_bundle):
    """A raising steplog on the retire/serialize path loses telemetry
    only: the computed results still resolve — on the scheduler (whose
    retirees are already slot-detached when the sink runs) AND the
    engine."""
    from paddle_tpu_torch.observe.metrics import MetricsRegistry
    from paddle_tpu_torch.serve import ContinuousScheduler, InferenceEngine

    seq = (np.random.RandomState(1)
           .randint(0, 50, size=(5,)).astype(np.int32))
    with ContinuousScheduler(decode_bundle, steplog=_ExplodingLog(),
                             metrics_registry=MetricsRegistry()) as s:
        out = s.infer({"word": seq}, timeout=60.0)
        assert next(iter(out.values())).shape[0] == 5
        assert s.live()
    with InferenceEngine(mlp_bundle, steplog=_ExplodingLog(),
                         metrics_registry=MetricsRegistry()) as eng:
        out = eng.infer({"pixel": _pixel()}, timeout=60.0)
        assert next(iter(out.values())).shape[0] == 1
        assert eng.live()


# -- cli observe tail report -------------------------------------------------

def test_summarize_dir_tail_attribution(tmp_path):
    with steplog.StepLog(str(tmp_path), run_name="serve",
                         compile_events=False) as log:
        for _ in range(20):
            log.log_serve_trace(latency_ms=2.0,
                                phases={"queue_ms": 0.2,
                                        "decode_ms": 1.7,
                                        "serialize_ms": 0.1})
        log.log_serve_trace(latency_ms=60.0,
                            phases={"queue_ms": 55.0, "decode_ms": 4.0,
                                    "serialize_ms": 1.0},
                            trace_id="t" * 32, session="s1")
    summary = steplog.summarize_dir(str(tmp_path))
    run = summary["runs"][0]
    assert run["serve_traces"] == 21
    tail = run["serve_tail"]
    assert tail["threshold_ms"] > 2.0
    assert max(tail["phases"], key=tail["phases"].get) == "queue_ms"


def test_cli_observe_prints_tail_attribution(tmp_path, capsys):
    from paddle_tpu_torch import cli

    with steplog.StepLog(str(tmp_path), run_name="serve",
                         compile_events=False) as log:
        for ms in (1.0, 1.0, 1.0, 50.0):
            log.log_serve_trace(
                latency_ms=ms,
                phases={"queue_ms": ms * 0.8, "decode_ms": ms * 0.2})
    rc = cli.main(["observe", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "serve tail attribution" in out
    assert "queue" in out


# -- the port's copy against the JAX module ---------------------------------

def test_traceparent_parsing_matches_jax():
    headers = ["", None, "junk", "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
               "00-" + "a" * 32 + "-" + "b" * 16 + "-00",
               "01-" + "a" * 32 + "-" + "b" * 16 + "-01-extra",
               "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
               "00-" + "A" * 32 + "-" + "b" * 16 + "-01"]
    for header in headers:
        got = tracing.TraceContext.from_traceparent(header)
        want = jax_tracing.TraceContext.from_traceparent(header)
        assert (got is None) == (want is None), header
        if got is not None:
            assert (got.trace_id, got.parent_id, got.sampled) == (
                want.trace_id, want.parent_id, want.sampled)
    ctx = tracing.TraceContext("c" * 32, "d" * 16)
    jctx = jax_tracing.TraceContext("c" * 32, "d" * 16)
    assert ctx.traceparent() == jctx.traceparent()


@pytest.mark.parametrize("q", [50.0, 90.0, 99.0])
def test_exemplars_and_tail_attribution_match_jax(q):
    rng = np.random.RandomState(int(q))
    records = []
    ex, jex = tracing.TraceExemplars(capacity=5), \
        jax_tracing.TraceExemplars(capacity=5)
    for i in range(40):
        phases = {"queue_ms": float(rng.exponential(2.0)),
                  "dispatch_ms": float(rng.exponential(1.0)),
                  "serialize_ms": float(rng.exponential(0.1))}
        total = sum(phases.values())
        records.append({"latency_ms": total, "phases": phases})
        ex.offer(total, phases, model="m", trace_id=str(i))
        jex.offer(total, phases, model="m", trace_id=str(i))
    # each entry's wall-clock stamp "t" is the moment of its offer
    assert [{k: v for k, v in e.items() if k != "t"} for e in ex.slowest()] \
        == [{k: v for k, v in e.items() if k != "t"} for e in jex.slowest()]
    assert ex.stats() == jex.stats()
    assert tracing.tail_attribution(records, q=q) == \
        jax_tracing.tail_attribution(records, q=q)


def test_scheduler_phase_sum_and_serve_trace(decode_bundle, tmp_path,
                                             recording_tracer):
    """The scheduler half of phase honesty: a traced sequence's
    serve_trace phases sum to within 5% of its measured wall, and an
    untraced one writes no serve_trace record."""
    from paddle_tpu_torch.observe.metrics import MetricsRegistry
    from paddle_tpu_torch.serve import ContinuousScheduler

    log = steplog.StepLog(str(tmp_path / "slog"), run_name="serve",
                          flush_every=1)
    ctx = tracing.TraceContext.mint()
    seq = (np.random.RandomState(3)
           .randint(0, 50, size=(9,)).astype(np.int32))
    with ContinuousScheduler(decode_bundle, steplog=log, model="tagger",
                             metrics_registry=MetricsRegistry()) as s:
        s.infer({"word": seq}, trace=ctx, timeout=60.0)
        s.infer({"word": seq[:4]}, timeout=60.0)
    log.close()
    traces = [r for r in steplog.read_jsonl(log.path)
              if r["type"] == "serve_trace"]
    assert len(traces) == 1 and traces[0]["trace"] == ctx.trace_id
    rec = traces[0]
    assert set(rec["phases"]) == {"queue_ms", "spill_restore_ms",
                                  "decode_ms", "serialize_ms"}
    assert sum(rec["phases"].values()) == pytest.approx(
        rec["latency_ms"], rel=0.05, abs=0.05)
    assert rec["iterations"] == 3  # 9 steps in windows of 4
    assert tracing.get_exemplars().stats()["offered"] == 2
