"""The port's training telemetry against the JAX package's, on the CPU.

- ``utils/stat.py`` and ``observe/spans.py``: StatSet aggregates, span
  nesting, the Chrome-trace export (plain and gzipped), the event cap, the
  feed into the global StatSet, and the telemetry-gated recording.
- ``observe/steplog.py``: every writer gives the JAX writer's record for
  the same call (all fields, both valid against
  tests/golden/steplog_schema.json), the ``-N`` suffix of a second run,
  and ``summarize_dir`` and ``cli observe --json`` read either package's
  directory alike (training, fused, checkpoint, serving-trace and
  training-fleet records).
- The trainer's step log: 3 per-step steps and 8 fused steps
  (``steps_per_call=4``) of the same dense network from the same
  parameters and feed give the JAX trainer's records (types, steps, pass
  and batch ids, examples, evaluator metrics; costs within 1e-5), span
  names, and training metrics; a checkpointing run writes the
  ``checkpoint`` records.
- ``observe/metrics.py``: the exposition of the golden's operation
  sequence is tests/golden/metrics_exposition.txt in both packages, with
  the same snapshot, series dump and merged exposition.
- ``observe/sentinel.py``: on the same cost sequences, warn, halt and off
  trip at the same step with the same kind, and the flight-recorder rings
  and crash artifacts match.
- ``observe/trainview.py``: the history, skew, straggler, timeline and
  fleet summary equal JAX's on the same inputs.
- ``observe/attribution.py``: busy time as a union, both idle shares, the
  top kernels and the gaps, over a synthetic kernel list; ``capture`` is
  None without a card.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import cli as jcli
from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.observe import metrics as jmetrics
from paddle_tpu.observe import sentinel as jsentinel
from paddle_tpu.observe import steplog as jsteplog
from paddle_tpu.observe import trainview as jtrainview

import paddle_tpu_torch as paddle
from paddle_tpu_torch import cli
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.observe import attribution, metrics, sentinel, spans
from paddle_tpu_torch.observe import steplog, trainview
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.topology import Topology
from paddle_tpu_torch.utils.stat import StatSet, global_stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
SCHEMA = json.load(open(os.path.join(GOLDEN, "steplog_schema.json")))
TOL = 1e-5


def _schema_valid(records):
    """Every record of a known type with its required fields and no field
    the golden does not declare (the meta line's caller extras and mirrored
    bench rows are outside the contract)."""
    for rec in records:
        spec = SCHEMA["record_types"][rec["type"]]
        keys = set(rec)
        assert not set(spec["required"]) - keys, rec
        if rec["type"] not in ("meta", "bench_row"):
            assert not keys - set(spec["required"]) - set(spec["optional"]), \
                rec


# -- stat and spans ----------------------------------------------------------

def test_statset_timer_and_dump():
    stats = StatSet("unit")
    with stats.timer("a"):
        pass
    with stats.timer("a", sync=torch.ones(3)):  # a CPU tensor: no sync
        pass
    stats.get("b").add(0.5)
    agg = stats.as_dict()
    assert agg["a"]["count"] == 2 and agg["b"]["total"] == 0.5
    lines = []
    stats.print_all(log=lambda fmt, *a: lines.append(fmt % a))
    assert lines[0] == "======= StatSet: [unit] ======="
    assert lines[1].startswith("  Stat(b: total=0.5000s count=1")
    stats.reset()
    assert stats.as_dict() == {}


def test_span_nesting_durations_and_stats():
    stats = StatSet("test")
    tracer = spans.SpanTracer("t", stats=stats)
    with tracer.span("outer") as outer:
        with tracer.span("inner", sync={"x": [torch.zeros(2)]}) as inner:
            pass
    assert outer.dur >= inner.dur >= 0
    assert [ev[0] for ev in tracer.events()] == ["inner", "outer"]
    agg = stats.as_dict()
    assert agg["outer"]["count"] == 1 and agg["inner"]["count"] == 1
    tracer.enabled = False
    with tracer.span("off") as scope:
        pass
    assert scope.dur >= 0 and "off" not in stats.as_dict()


@pytest.mark.parametrize("suffix", [".json", ".json.gz"])
def test_chrome_trace_export_parses(tmp_path, suffix):
    tracer = spans.SpanTracer("unit", stats=None)
    with tracer.span("step", args={"batch": 3}):
        with tracer.span("feed"):
            pass
    tracer.instant("marker")
    path = tracer.export(str(tmp_path / ("trace" + suffix)))
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(path, "rt") as fh:
        evs = json.load(fh)["traceEvents"]
    xs = {e["name"]: e for e in evs if e["ph"] == "X"}
    assert set(xs) == {"step", "feed", "marker"}
    assert xs["step"]["dur"] >= xs["feed"]["dur"] >= 0
    assert xs["step"]["args"] == {"batch": 3}
    named = {e["tid"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {e["tid"] for e in xs.values()} <= named


def test_span_cap_and_global_recording(monkeypatch):
    stats = StatSet("test")
    tracer = spans.SpanTracer("t", stats=stats)
    tracer.MAX_EVENTS = 2
    for _ in range(5):
        with tracer.span("s"):
            pass
    assert len(tracer.events()) == 2
    assert tracer.to_chrome_trace()["metadata"]["dropped_spans"] == 3
    assert stats.as_dict()["s"]["count"] == 5
    # the global tracer records only while telemetry can consume it
    glob = spans.get_tracer()
    glob.reset()
    monkeypatch.delenv("PADDLE_TPU_TORCH_TELEMETRY", raising=False)
    before = global_stats.as_dict().get("unit_span", {}).get("count", 0)
    with spans.span("unit_span"):
        pass
    assert glob.events() == []
    assert global_stats.as_dict()["unit_span"]["count"] == before + 1
    monkeypatch.setenv("PADDLE_TPU_TORCH_TELEMETRY", "/nonexistent")
    with spans.span("unit_span"):
        pass
    assert [e[0] for e in glob.events()] == ["unit_span"]
    glob.reset()


# -- the step log ------------------------------------------------------------

def _write_all(mod, directory, run="unit"):
    """One call of every StepLog writer (the JAX test's full log, with the
    serving trace and the anomaly added); returns the records."""
    with mod.StepLog(directory, run_name=run, compile_events=False) as slog:
        slog.register_flops(2e9)
        slog.log_step(step=1, pass_id=0, batch_id=0, wall_ms=5.0,
                      feed_ms=0.4, cost=1.25, examples=64, device_ms=4.0,
                      metrics={"err": 0.5, "skipme": "str"})
        slog.log_step(step=2, wall_ms=3.0)
        slog.write({"type": "event", "event": "compile", "secs": 0.01})
        slog.write({"type": "bench_row", "metric": "x", "value": 1.0})
        slog.log_feed(step=2, stall_ms=0.8, convert_ms=1.1, examples=64,
                      depth=2, bucket=32, fill_tokens=100, pad_tokens=28)
        slog.log_train_chunk(step=3, steps=4, pass_id=0, batch_id=2,
                             wall_ms=8.0, feed_ms=0.5, cost_first=1.0,
                             cost_last=float("nan"), examples=256)
        slog.log_checkpoint(step=2, duration_ms=3.25, nbytes=4096,
                            overlapped=True, step_thread_ms=0.12,
                            pass_id=0, path="pass-00000-step-00000002")
        slog.log_serve_request(rows=1, queue_ms=0.5, latency_ms=2.5,
                               req_id=1)
        slog.log_serve_batch(rows=3, bucket=4, infer_ms=1.2, batch_id=1,
                             pad_rows=1, requests=2, queue_ms_max=0.7,
                             flush="deadline", replica="r0")
        slog.log_serve_decode(iteration=1, active=2, window=4, infer_ms=2.0,
                              slots=4, steps=8, admitted=1, retired=1,
                              model="m", replica="r0", resident=2,
                              suspended=1)
        slog.log_serve_swap("spill", "u1", nbytes=128, overlap_ms=0.2,
                            reason="capacity", pos=3, model="m",
                            replica="r0")
        for lat in (2.0, 3.0, 10.0):
            slog.log_serve_trace(lat, {"queue_ms": lat / 2,
                                       "dispatch_ms": lat / 2},
                                 trace_id="t", span_id="s", model="m",
                                 replica="r0", req_id=1, rows=1,
                                 iterations=1, session="u1")
        slog.log_serve_shed("m", "queue_full", priority="low", queued=9)
        slog.log_slo_status(state="burning", prev_state="ok",
                            objective_p99_ms=50.0, availability=99.0,
                            current_p99_ms=61.2, fast_burn=1.4,
                            slow_burn=0.7, budget_remaining=0.3,
                            breaching_phase="queue_ms", worker="1",
                            model="mnist_mlp")
        slog.log_control_action("max_latency_ms", 5.0, 2.5, "shed_earlier",
                                breaching_phase="queue_ms",
                                burn_rate_before=1.4, rollback=False,
                                model="m")
        slog.log_anomaly(step=2, kind="nan_inf_loss", cost="nan",
                         threshold=3.0, mode="warn", pass_id=0,
                         chunk_index=1, worker="trainer-0")
        slog.log_crash_report(reason="anomaly:cost_spike",
                              steps=[{"step": 2, "wall_ms": 3.0}],
                              captured=1, capacity=64, mode="warn",
                              anomaly={"kind": "x"}, artifact="a.json",
                              suppressed_trips=2, worker="trainer-0")
        slog.log_elastic_event("worker_lost", worker="trainer-0",
                               members=["trainer-0"], lost=["trainer-1"],
                               detail="lease expired")
        slog.log_elastic_event("checkpoint_commit", worker="trainer-0",
                               step=2, checkpoint="pass-00000-step-00000002")
        slog.log_serve_host_event("session_rehome", host="hostB",
                                  hosts=["hostA", "hostB"], session="u1",
                                  target="hostA", detail="d")
        slog.log_pass(0, metrics={"err": 0.25})
    return mod.read_jsonl(os.path.join(directory, run + ".steps.jsonl"))


# fields that name the moment, the writer's package or its peak rate
_VOLATILE = {"t", "unix_time", "jax_version", "backend", "device_count",
             "mfu_pct"}


def test_every_writer_gives_the_jax_record(tmp_path):
    got = _write_all(steplog, str(tmp_path / "port"))
    want = _write_all(jsteplog, str(tmp_path / "jax"))
    _schema_valid(got)
    _schema_valid(want)
    assert len(got) == len(want) > 20
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k not in _VOLATILE} == \
            {k: v for k, v in w.items() if k not in _VOLATILE}
    assert got[0]["backend"] == "cpu" and got[0]["device_count"] == 1
    assert got[-1] == {"type": "end", "steps": 2}
    assert steplog.SCHEMA_VERSION == jsteplog.SCHEMA_VERSION == \
        SCHEMA["schema_version"]


def test_second_run_gets_a_suffix(tmp_path):
    with steplog.StepLog(str(tmp_path), compile_events=False) as first:
        first.log_step(step=1, wall_ms=1.0)
    second = steplog.StepLog(str(tmp_path), compile_events=False)
    assert os.path.basename(second.path) == "train-2.steps.jsonl"
    assert os.path.basename(second.trace_path) == "train-2.trace.json"
    second.close()
    assert [r["type"] for r in steplog.read_jsonl(first.path)] == \
        ["meta", "step", "end"]


def test_events_reach_the_open_logs(tmp_path):
    """emit_event (the kernel build/load and graph capture hook) writes an
    ``event`` record into each open log that takes events."""
    taking = steplog.StepLog(str(tmp_path), run_name="a")
    quiet = steplog.StepLog(str(tmp_path), run_name="b",
                            compile_events=False)
    steplog.emit_event("/paddle_tpu_torch/kernel_load/lstm_seq_fwd", 0.25)
    taking.close()
    quiet.close()
    steplog.emit_event("/after/close", 1.0)
    a = steplog.read_jsonl(taking.path)
    assert [r for r in a if r["type"] == "event"] == [
        {"type": "event", "event": "/paddle_tpu_torch/kernel_load/"
         "lstm_seq_fwd", "secs": 0.25}]
    assert not [r for r in steplog.read_jsonl(quiet.path)
                if r["type"] == "event"]
    assert steplog.summarize_dir(str(tmp_path))["runs"][0][
        "compile_events"] == 1


def _fleet_dir(mod, directory):
    """A training-fleet directory: two worker files with their steps (one
    fused), an elastic timeline and a serving worker's traces."""
    _write_all(mod, directory)
    for wid, walls in (("trainer-0", [9.0, 2.0, 2.1, 2.2]),
                       ("trainer-1", [9.0, 4.0, 4.4, 4.8])):
        run = "train-t%s" % wid[-1]
        with mod.StepLog(directory, run_name=run, compile_events=False,
                         meta={"phase": "train", "worker": wid,
                               "steps_per_call": 2}) as slog:
            for i, w in enumerate(walls):
                slog.log_step(step=i + 1, wall_ms=w, cost=1.0 / (i + 1),
                              examples=8, pass_id=0, batch_id=i)
            slog.log_elastic_event("rewind", worker=wid,
                                   members=["trainer-0", "trainer-1"],
                                   checkpoint="c", step=2)
    with mod.StepLog(directory, run_name="fused", compile_events=False,
                     meta={"steps_per_call": 4}) as slog:
        for c in range(3):
            slog.log_train_chunk(step=4 * c + 1, steps=4, wall_ms=8.0 + c,
                                 examples=32, cost_first=1.0, cost_last=0.5)
            for i in range(4):
                slog.log_step(step=4 * c + i + 1, cost=0.5, examples=8)
    for w in ("0", "1"):
        with mod.StepLog(directory, run_name="serve-w" + w,
                         compile_events=False, meta={"worker": int(w)}) as s:
            for lat in (1.0, 2.0, 30.0 + int(w)):
                s.log_serve_trace(lat, {"queue_ms": lat * 0.8,
                                        "dispatch_ms": lat * 0.2})
    spans.SpanTracer("unit", stats=None).export(
        os.path.join(directory, "trace.json"))


def _comparable(summary):
    summary = json.loads(json.dumps(summary))
    summary.pop("directory")
    return summary


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_summarize_dir_reads_either_package(tmp_path, writer, capsys):
    """``summarize_dir`` and ``cli observe`` (text and --json) give the
    same summary of one directory in both packages, whichever wrote it."""
    d = str(tmp_path)
    _fleet_dir(jsteplog if writer == "jax" else steplog, d)
    want = jsteplog.summarize_dir(d)
    got = steplog.summarize_dir(d)
    assert _comparable(got) == _comparable(want)
    assert got["train_fleet"]["skew"]["workers"]["trainer-1"]["skew"] > 1
    assert {r["run"] for r in got["runs"]} >= {"unit", "train-t0",
                                               "fused", "serve-w1"}
    assert got["fleets"][0]["workers"].keys() == {"0", "1"}
    assert jcli.main(["observe", d, "--json"]) == 0
    jout = capsys.readouterr().out
    assert cli.main(["observe", d, "--json"]) == 0
    assert _comparable(json.loads(capsys.readouterr().out)) == \
        _comparable(json.loads(jout))
    assert jcli.main(["observe", d]) == 0
    jtext = capsys.readouterr().out
    assert cli.main(["observe", d]) == 0
    assert capsys.readouterr().out == jtext


# -- the trainer's step log against the JAX trainer's ------------------------

def _dense(pkg, n_batches, batch=8, dim=6, classes=3):
    """The JAX observe tests' dense network and feed, built by ``pkg``."""
    A, L = pkg.activation, pkg.layer
    x = L.data(name="x", type=pkg.data_type.dense_vector(dim))
    lab = L.data(name="y", type=pkg.data_type.integer_value(classes))
    out = L.fc(input=L.fc(input=x, size=12, act=A.Tanh()), size=classes)
    cost = L.classification_cost(input=out, label=lab)
    err = pkg.evaluator.classification_error(input=out, label=lab)

    def reader():
        rng = np.random.RandomState(7)
        w = rng.randn(dim, classes)
        for _ in range(n_batches * batch):
            xv = rng.randn(dim).astype(np.float32)
            yield xv, int(np.argmax(xv @ w))

    return cost, err, pkg.batch(reader, batch)


def _train_with_telemetry(tmp_path, n_batches, monkeypatch, **options):
    """The dense network trained by both packages with telemetry on, from
    the same parameters; returns the (port, JAX) records and trace span
    names, and the port's metric deltas."""
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY", str(tmp_path / "jax"))
    monkeypatch.setenv("PADDLE_TPU_TORCH_TELEMETRY", str(tmp_path / "port"))
    monkeypatch.setenv("PADDLE_TPU_SENTINEL", "warn")
    monkeypatch.setenv("PADDLE_TPU_TORCH_SENTINEL", "warn")
    jax_reset_names()
    jcost, jerr, jreader = _dense(jpaddle, n_batches)
    jparams = jpaddle.parameters.create(jcost)
    start = {n: np.array(jparams.get(n)) for n in jparams.names()}
    jtr = jpaddle.trainer.SGD(jcost, jparams, jpaddle.optimizer.Momentum(
        momentum=0.9, learning_rate=0.1), extra_layers=[jerr])
    jtr.train(jreader, num_passes=1, **options)
    reset_name_counters()
    cost, err, reader = _dense(paddle, n_batches)
    topo = Topology(cost)
    params = Parameters({n: torch.from_numpy(v) for n, v in start.items()},
                        topo.param_specs())
    tr = paddle.trainer.SGD(cost, params, paddle.optimizer.Momentum(
        momentum=0.9, learning_rate=0.1), extra_layers=[err], device="cpu")
    reg = metrics.get_registry()
    before = (reg.counter("paddle_tpu_train_steps_total").value,
              reg.counter("paddle_tpu_train_examples_total").value)
    tr.train(reader, num_passes=1, **options)
    deltas = (reg.counter("paddle_tpu_train_steps_total").value - before[0],
              reg.counter("paddle_tpu_train_examples_total").value
              - before[1], reg.gauge("paddle_tpu_train_loss").value)
    out = []
    for side in ("port", "jax"):
        recs = steplog.read_jsonl(str(tmp_path / side / "train.steps.jsonl"))
        trace = json.load(open(tmp_path / side / "train.trace.json"))
        names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
        out.append((recs, names))
    return out[0], out[1], deltas, err.name


def _same_records(got, want, err_name):
    # jax.monitoring compile events have no counterpart on the CPU here
    got = [r for r in got if r["type"] != "event"]
    want = [r for r in want if r["type"] != "event"]
    assert [r["type"] for r in got] == [r["type"] for r in want]
    for g, w in zip(got, want):
        assert set(g) - {"device_name", "torch_version", "cuda_version"} \
            == set(w) - {"jax_version"}, (g, w)
        for key in ("step", "pass", "batch", "examples", "steps", "phase",
                    "num_passes", "steps_per_call", "depth"):
            assert g.get(key) == w.get(key), (key, g, w)
        for key in ("cost", "cost_first", "cost_last"):
            if key in w:
                assert abs(g[key] - w[key]) < TOL, (key, g, w)
        if "metrics" in w:
            assert g["metrics"].keys() == w["metrics"].keys() == {err_name}
            assert abs(g["metrics"][err_name] - w["metrics"][err_name]) \
                < TOL


def test_trainer_step_log_matches_jax(tmp_path, monkeypatch):
    (got, names), (want, jnames), deltas, err = _train_with_telemetry(
        tmp_path, 3, monkeypatch)
    _schema_valid(got)
    _same_records(got, want, err)
    steps = [r for r in got if r["type"] == "step"]
    assert [s["step"] for s in steps] == [1, 2, 3]
    assert all(s["wall_ms"] > 0 and "feed_ms" in s for s in steps)
    assert got[0]["backend"] == "cpu" and got[-1] == {"type": "end",
                                                      "steps": 3}
    assert names == jnames and {"feed", "train_step",
                                "eval_readback"} <= names
    assert deltas[:2] == (3, 24)
    assert deltas[2] == pytest.approx(steps[-1]["cost"], abs=1e-6)


def test_fused_step_log_matches_jax(tmp_path, monkeypatch):
    """steps_per_call=4 over 8 batches: two train_chunk records with their
    per-step records (no wall time of their own) and the feed records."""
    (got, names), (want, jnames), _, err = _train_with_telemetry(
        tmp_path, 8, monkeypatch, steps_per_call=4)
    _schema_valid(got)
    _same_records(got, want, err)
    chunks = [r for r in got if r["type"] == "train_chunk"]
    assert [(c["step"], c["steps"]) for c in chunks] == [(1, 4), (5, 4)]
    assert all("wall_ms" not in r for r in got if r["type"] == "step")
    assert got[0]["steps_per_call"] == 4
    assert names == jnames and {"feed", "train_chunk",
                                "eval_readback"} <= names


def test_checkpoint_records(tmp_path, monkeypatch):
    """A fused run checkpointing every 4 steps, overlapped and blocking:
    ``checkpoint`` records with the JAX fields and their commit events."""
    monkeypatch.setenv("PADDLE_TPU_TORCH_TELEMETRY", str(tmp_path / "t"))
    for sync in (False, True):
        reset_name_counters()
        cost, err, reader = _dense(paddle, 8)
        tr = paddle.trainer.SGD(
            cost, paddle.parameters.create(cost, device="cpu"),
            paddle.optimizer.Momentum(momentum=0.9, learning_rate=0.1),
            extra_layers=[err], device="cpu")
        tr.train(reader, num_passes=1, steps_per_call=4,
                 checkpoint_dir=str(tmp_path / ("c%d" % sync)),
                 checkpoint_every=4, checkpoint_sync=sync)
    for name, overlapped in (("train", True), ("train-2", False)):
        recs = steplog.read_jsonl(str(tmp_path / "t" /
                                      (name + ".steps.jsonl")))
        _schema_valid(recs)
        steps = [r["step"] for r in recs if r["type"] == "checkpoint"]
        # an overlapped snapshot still pending when the next one comes is
        # superseded (newest wins); the last one always commits
        assert steps == [4, 8] if not overlapped else steps in ([8],
                                                                [4, 8])
        assert all(r["overlapped"] is overlapped and r["bytes"] > 0
                   and r["path"].startswith("pass-00000-step-")
                   for r in recs if r["type"] == "checkpoint")
        assert [r["step"] for r in recs
                if r["type"] == "elastic_event"] == steps
        runs = steplog.summarize_dir(str(tmp_path / "t"))["runs"]
        assert [r["checkpoints"] for r in runs
                if r["file"] == name + ".steps.jsonl"] == [len(steps)]


def test_sentinel_halts_the_trainer_and_dumps_the_black_box(tmp_path,
                                                            monkeypatch):
    """PADDLE_TPU_TORCH_SENTINEL=halt: the first NaN cost raises
    TrainingAnomaly, and the crash report holds the steps before it."""
    monkeypatch.setenv("PADDLE_TPU_TORCH_TELEMETRY", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_TORCH_SENTINEL", "halt")
    reset_name_counters()
    cost, err, _ = _dense(paddle, 1)
    rows = [(np.full(6, np.nan if i >= 24 else 0.5, np.float32), 1)
            for i in range(40)]
    tr = paddle.trainer.SGD(
        cost, paddle.parameters.create(cost, device="cpu"),
        paddle.optimizer.Momentum(learning_rate=0.1), extra_layers=[err],
        device="cpu")
    with pytest.raises(sentinel.TrainingAnomaly) as exc:
        tr.train(paddle.batch(lambda: iter(rows), 8), num_passes=1,
                 steps_per_call=2)
    assert exc.value.anomaly["step"] == 4
    assert exc.value.anomaly["kind"] == "nan_inf_loss"
    recs = steplog.read_jsonl(str(tmp_path / "train.steps.jsonl"))
    crash = [r for r in recs if r["type"] == "crash_report"]
    assert len(crash) == 1 and crash[0]["steps"][-1]["step"] == 4
    assert os.path.exists(crash[0]["artifact"])


# -- metrics -----------------------------------------------------------------

def _golden_registry(mod, include_workers=True):
    """The operation sequence of tests/test_metrics.py's golden registry,
    run through the metrics module ``mod``."""
    reg = mod.MetricsRegistry()
    help_req = "requests completed by the serving engine"
    reg.counter("paddle_tpu_serve_requests_total", help=help_req).inc(42)
    for model, n in (("mnist_mlp", 30), ("tagger", 12)):
        reg.counter("paddle_tpu_serve_requests_total", help=help_req,
                    labels={"model": model}).inc(n)
    if include_workers:
        for worker, n in (("0", 5), ("1", 4)):
            reg.counter("paddle_tpu_serve_requests_total", help=help_req,
                        labels={"model": "tagger",
                                "worker": worker}).inc(n)
    reg.counter("paddle_tpu_serve_shed_total",
                help="requests rejected by admission control",
                labels={"model": "tagger", "priority": "low",
                        "reason": "pressure"}).inc(7)
    help_q = "rows waiting for a batch flush"
    reg.gauge("paddle_tpu_serve_queue_depth", help=help_q).set(3)
    if include_workers:
        reg.gauge("paddle_tpu_serve_queue_depth", help=help_q,
                  labels={"worker": "1"}).set(2)
    for bucket, fill in (("4", 0.75), ("8", 0.5)):
        reg.gauge("paddle_tpu_serve_batch_fill_ratio",
                  help="real rows / bucket slots (cumulative)",
                  labels={"bucket": bucket}).set(fill)
    h = reg.histogram("paddle_tpu_serve_request_latency_ms",
                      help="end-to-end request latency (enqueue to result)",
                      buckets=(1.0, 5.0, 25.0, 100.0))
    for v in (0.4, 3.0, 3.5, 17.0, 250.0):
        h.observe(v)
    reg.counter("paddle_tpu_serve_session_spills_total",
                help="session carries paged out to the host store",
                labels={"model": "tagger"}).inc(9)
    reg.counter("paddle_tpu_serve_session_restores_total",
                help="session carries paged back into a decode slot",
                labels={"model": "tagger"}).inc(6)
    for reason, n in (("capacity", 2), ("ttl", 1)):
        reg.counter("paddle_tpu_serve_session_evictions_total",
                    help="sessions evicted from the host store",
                    labels={"model": "tagger", "reason": reason}).inc(n)
    reg.gauge("paddle_tpu_serve_session_resident",
              help="sessions whose carry is in a decode slot",
              labels={"model": "tagger"}).set(2)
    reg.gauge("paddle_tpu_serve_session_suspended",
              help="sessions paged out to the host store",
              labels={"model": "tagger"}).set(5)
    sw = reg.histogram("paddle_tpu_serve_session_swap_ms",
                       help="device<->host carry copy latency per swap",
                       labels={"model": "tagger"}, buckets=(0.5, 2.0, 10.0))
    for v in (0.2, 1.1, 6.0):
        sw.observe(v)
    for host, live in (("hostA", 1), ("hostB", 0)):
        reg.gauge("paddle_tpu_serve_hosts",
                  help="serving-host membership (1 live in the ring, "
                       "0 excluded)", labels={"host": host}).set(live)
    reg.counter("paddle_tpu_serve_host_rehomes_total",
                help="sessions re-homed onto this host after their "
                     "previous host left the ring",
                labels={"host": "hostA"}).inc(3)
    slo = mod.slo_gauges(reg)
    for key, value in (("objective_p99_ms", 50), ("current_p99_ms", 42.5),
                       ("burn_fast", 0.62), ("burn_slow", 0.4),
                       ("budget_remaining", 0.6), ("state", 0)):
        slo[key].set(value)
    reg.gauge("paddle_tpu_build_info",
              help="build/version info (value is always 1)",
              labels={"version": "0.1.0", "jax_version": "0.9",
                      "schema": "1"}).set(1)
    return reg


def test_exposition_equals_the_golden_and_jax():
    want = open(os.path.join(GOLDEN, "metrics_exposition.txt")).read()
    reg, jreg = _golden_registry(metrics), _golden_registry(jmetrics)
    assert reg.to_prometheus() == jreg.to_prometheus() == want
    assert reg.snapshot() == jreg.snapshot()
    assert reg.dump_series() == jreg.dump_series()
    base = _golden_registry(metrics, include_workers=False)
    jbase = _golden_registry(jmetrics, include_workers=False)
    extras = [([{"name": "paddle_tpu_serve_requests_total",
                 "kind": "counter", "help": "",
                 "series": [{"labels": {"model": "tagger"}, "value": 5}]}],
               {"worker": "0"})]
    assert metrics.merged_exposition(base, extras) == \
        jmetrics.merged_exposition(jbase, extras)
    assert metrics.merged_exposition(reg) == reg.to_prometheus()


def test_metric_instruments_and_percentiles():
    for mod in (metrics, jmetrics):
        reg = mod.MetricsRegistry()
        with pytest.raises(ValueError):
            reg.counter("c").inc(-1)
        reg.gauge("g")
        with pytest.raises(ValueError):
            reg.counter("g")
    vals = list(np.random.RandomState(0).rand(101) * 100)
    for q in (0, 50, 95, 99, 100):
        assert metrics.percentile(vals, q) == jmetrics.percentile(vals, q)
        np.testing.assert_allclose(metrics.percentile(vals, q),
                                   np.percentile(vals, q))
    g = metrics.build_info(metrics.MetricsRegistry())
    assert g.value == 1 and g.labels["torch_version"] == torch.__version__


# -- sentinel ----------------------------------------------------------------

COSTS = {
    "nan": [1.0, 0.9, float("nan"), 0.8, float("nan")],
    "divergence": [1.0] * 10 + [500.0, 1.0, 700.0],
    "inf_chunk": [2.0, float("inf"), 1.0, 1.0],
    "clean": [1.0, 0.5, 0.25],
}


@pytest.mark.parametrize("mode", ["warn", "halt", "off"])
@pytest.mark.parametrize("case", sorted(COSTS))
def test_sentinel_equals_jax(tmp_path, mode, case, monkeypatch):
    """The same cost sequence through both sentinels (per step, and the
    fused shape: one ring record per chunk of 2, a check per loss)."""
    monkeypatch.setenv("PADDLE_TPU_SENTINEL", mode)
    monkeypatch.setenv("PADDLE_TPU_TORCH_SENTINEL", mode)
    results = []
    for mod, name in ((jsentinel, "jax"), (sentinel, "port")):
        s = mod.from_env(artifact_dir=str(tmp_path / name), capacity=3,
                         run_name="r", worker="trainer-0")
        if s is None:
            results.append(None)
            continue
        tripped, checked = None, []
        try:
            costs = COSTS[case]
            for i, c in enumerate(costs):
                s.step(i + 1, cost=c, pass_id=0, batch_id=i, wall_ms=1.0)
            for first in range(0, len(costs), 2):
                chunk = costs[first:first + 2]
                s.record_chunk(first + 1, chunk, pass_id=1, batch_id=first)
                for j, c in enumerate(chunk):
                    checked.append(s.check(first + j + 1, c, pass_id=1,
                                           chunk_index=j))
        except mod.TrainingAnomaly as exc:
            tripped = exc.anomaly
        arts = [json.load(open(p)) for p in s.artifacts]
        for a in arts:
            a.pop("unix_time")
        results.append((tripped, s.anomalies, s.recorder.records(), arts,
                        checked, s.mode))
    assert json.dumps(results[0]) == json.dumps(results[1])
    if mode == "off":
        assert results == [None, None]


def test_sentinel_on_exception_and_modes(tmp_path, monkeypatch):
    for raw, want in (("", "warn"), ("HALT", "halt"), ("0", "off"),
                      ("none", "off"), ("warn", "warn")):
        monkeypatch.setenv("PADDLE_TPU_TORCH_SENTINEL", raw)
        assert sentinel.sentinel_mode() == want
    s = sentinel.Sentinel(mode="warn", artifact_dir=str(tmp_path))
    s.step(1, cost=1.0)
    path = s.on_exception(RuntimeError("boom"))
    body = json.load(open(path))
    assert body["format"] == jsentinel.ARTIFACT_FORMAT
    assert body["reason"].startswith("exception: RuntimeError")
    exc = sentinel.TrainingAnomaly("x")
    exc._black_box_dumped = True
    assert s.on_exception(exc) is None


# -- trainview ---------------------------------------------------------------

def _history(mod):
    h = mod.TrainHealthHistory(window_s=1.0, horizon_s=4.0,
                               samples_per_window=3)
    for i in range(12):
        h.record_step(2.0 + i, examples=8, feed_stall_ms=0.5, t=100.0 + i / 4)
    h.record_chunk(4, 10.0, examples=32, feed_stall_ms=1.0, t=103.5)
    h.record_checkpoint(5.0, t=103.6)
    return h


def test_trainview_equals_jax(monkeypatch):
    h, jh = _history(trainview), _history(jtrainview)
    assert h.ring_len() == jh.ring_len() == 4
    monkeypatch.setenv("PADDLE_TPU_TRAIN_WORKER", "trainer-3")
    monkeypatch.setenv("PADDLE_TPU_TORCH_TRAIN_WORKER", "trainer-3")
    assert h.snapshot(now=104.0) == jh.snapshot(now=104.0)
    assert trainview.merge_train_history(
        [h.snapshot(now=104.0), None, h.snapshot(now=104.0)]) == \
        jtrainview.merge_train_history(
            [jh.snapshot(now=104.0), None, jh.snapshot(now=104.0)])
    assert trainview.merge_train_history([]) == \
        jtrainview.merge_train_history([])
    assert trainview.worker_id() == jtrainview.worker_id() == "trainer-3"
    for wid in ("trainer-3", "odd id!", None):
        assert trainview.worker_run_name("train", wid) == \
            jtrainview.worker_run_name("train", wid)
    walls = {"trainer-0": [2.0, 2.1, 2.2, 2.0],
             "trainer-1": [2.0, 5.0, 5.5, 6.0], "trainer-2": []}
    skew = trainview.step_time_skew(walls)
    assert skew == jtrainview.step_time_skew(walls)
    assert trainview.find_straggler(skew) == \
        jtrainview.find_straggler(skew) == ("trainer-1", skew["workers"][
            "trainer-1"]["skew"])
    events = [(1000.0, {"type": "elastic_event", "kind": "rewind",
                        "t": 2.5, "worker": "trainer-1"}),
              (999.0, {"type": "elastic_event", "kind": "worker_lost",
                       "t": 1.0, "worker": "trainer-0"})]
    assert trainview.assemble_timeline(events) == \
        jtrainview.assemble_timeline(events)
    workers = {w: {"walls": v, "steps": len(v), "examples": 8 * len(v),
                   "files": ["f"]} for w, v in walls.items()}
    assert trainview.fleet_summary(workers, events) == \
        jtrainview.fleet_summary(workers, events)
    assert trainview.fleet_summary({}, []) is None


def test_global_history_knobs(monkeypatch):
    monkeypatch.setattr(trainview, "_global_history", None)
    monkeypatch.setenv("PADDLE_TPU_TORCH_HEALTH_WINDOW_S", "2")
    monkeypatch.setenv("PADDLE_TPU_TORCH_HEALTH_HORIZON_S", "10")
    monkeypatch.setenv("PADDLE_TPU_TORCH_HEALTH", "0")
    h = trainview.get_train_history()
    assert h.ring_len() == 5 and not h.enabled
    h.record_step(1.0)
    assert h.snapshot()["totals"]["steps"] == 0
    monkeypatch.setattr(trainview, "_global_history", None)


# -- attribution -------------------------------------------------------------

KERNELS = [  # (name, start_us, end_us): two streams overlap at 20-30
    ("lstm_seq_fwd", 0.0, 30.0), ("gemm", 20.0, 40.0),
    ("lstm_seq_bwd", 100.0, 160.0), ("gemm", 200.0, 210.0),
    ("elementwise", 400.0, 401.0)]


def test_attribution_math():
    trace = attribution.DeviceTrace(KERNELS, wall_ms=1.0)
    assert trace.busy_us == 40.0 + 60.0 + 10.0 + 1.0
    assert trace.window_us == 401.0
    prof = attribution.step_profile(trace, steps=2, kernels=("lstm_seq",))
    assert prof["busy_ms_per_step"] == pytest.approx(111.0 / 1e3 / 2)
    assert prof["idle_share"] == pytest.approx(1 - 0.111)
    assert prof["device_window_idle_share"] == pytest.approx(1 - 111 / 401)
    assert prof["kernels_per_step"] == 2.5 and prof["device_events"] == 5
    assert prof["kernels"]["lstm_seq"]["ms_per_step"] == pytest.approx(
        0.045)
    assert prof["kernels"]["lstm_seq"]["share_of_busy"] == pytest.approx(
        90 / 111)
    assert [t["kernel"] for t in prof["top"]] == ["lstm_seq_bwd",
                                                  "lstm_seq_fwd", "gemm",
                                                  "elementwise"]
    assert prof["top"][2]["calls_per_step"] == 1.0
    rows = attribution.op_report(trace, steps=1, top=2)
    assert [r["name"] for r in rows] == ["lstm_seq_bwd", "lstm_seq_fwd"]
    assert rows[0]["pct"] == pytest.approx(100 * 60 / 121)
    gap = attribution.dispatch_gap(trace, steps=1, min_execs_per_step=4)
    assert gap["gap_pct"] == pytest.approx(100 * (401 - 111) / 401)
    assert gap["host_bound"] and gap["diagnosis"].startswith("host-bound")
    assert [(g["after"], g["before"], round(g["ms"], 6)) for g in
            gap["largest_gaps"]] == [("gemm", "elementwise", 0.19),
                                     ("gemm", "lstm_seq_bwd", 0.06),
                                     ("lstm_seq_bwd", "gemm", 0.04)]
    assert gap["wall_idle_pct"] == pytest.approx(100 * (1 - 0.111))
    dense = attribution.DeviceTrace([("k", i * 10.0, i * 10.0 + 9.5)
                                     for i in range(8)])
    assert not attribution.dispatch_gap(dense, steps=1)["host_bound"]
    assert attribution.dispatch_gap(attribution.DeviceTrace([])) is None
    assert attribution.union_us([(0, 5), (1, 2), (4, 9), (10, 11)]) == 10


def test_attribution_capture_and_unported(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert attribution.capture(lambda: None, lambda: None) is None
    for fn in (attribution.load_hlo_defs, attribution.fusion_groups,
               attribution.conv_detail):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            fn("x")
    tflops, pct = attribution.achieved(989e12, 1000.0)
    assert tflops == pytest.approx(989.0) and pct == pytest.approx(100.0)
    assert attribution.achieved(None, 1.0) == (None, None)
