"""The serving health history and SLO monitor of the port, against the
JAX package (tests/test_health.py, ported): ``observe/health.py`` is the
port's own copy of the JAX module.

* ``HealthHistory``: windows aggregate, the reservoir stays bounded, the
  ring stays pinned, concurrent writers never tear a window;
* the SLO monitor walks ok -> burning -> breached -> ok with its
  ``slo_status`` records and ``paddle_tpu_slo_*`` gauges;
* the trace/history merge over a local front, and over a front with
  worker processes (a live and a dead worker: partial);
* ``/debug/slo`` and ``/debug/traces`` over HTTP from the port's engine;
* ``cli observe``'s per-worker merge of ``serve_trace`` streams;
* the same history, merge, window statistics and monitor verdicts from
  the port's copy and the JAX module on the same inputs.

The bench gate's burn-rate direction (observe/regress.py) is held in
tests/test_torch_regress.py. The 2-worker fleet is in
tests/test_torch_workers.py.
"""

import json
import os
import signal
import threading
import time
import urllib.request

import numpy as np
import pytest

from paddle_tpu.observe import health as jax_health

from paddle_tpu_torch.observe import health
from paddle_tpu_torch.observe import steplog
from paddle_tpu_torch.observe import tracing


@pytest.fixture(autouse=True)
def _fresh_globals():
    """Process-global telemetry isolation: every test starts with an
    empty exemplar reservoir and an empty, enabled global history."""
    tracing.get_exemplars().reset()
    health.get_history().reset()
    health.get_history().set_enabled(True)
    yield
    tracing.get_exemplars().reset()
    health.get_history().reset()


# -- HealthHistory: windows, reservoir, wraparound ---------------------------

def test_history_windows_and_stats():
    h = health.HealthHistory(window_s=1.0, horizon_s=10.0)
    t = 100.5
    for lat in (10.0, 20.0, 30.0):
        h.record_request(lat, {"queue_ms": lat / 2, "dispatch_ms": 1.0},
                         t=t)
    h.record_shed("queue_full", t=t)
    h.record_queue_depth(5, t=t)
    h.record_queue_depth(3, t=t)
    h.record_occupancy(0.5, t=t)
    h.record_occupancy(1.0, t=t)
    snap = h.snapshot(now=101.0)
    assert snap["totals"] == {"requests": 3, "shed": 1,
                              "latency_ms_sum": 60.0}
    (w,) = snap["windows"]
    assert w["epoch"] == 100
    assert w["requests"] == 3 and w["lat_max"] == 30.0
    assert w["shed"] == {"queue_full": 1}
    assert w["queue_depth"] == 5  # window MAX, not last
    stats = health.window_stats(snap, 5.0, now=101.0)
    assert stats["requests"] == 3 and stats["shed"] == 1
    assert stats["qps"] == pytest.approx(3 / 5.0)
    assert stats["latency_ms_mean"] == pytest.approx(20.0)
    assert stats["p50_ms"] == pytest.approx(20.0)
    assert stats["queue_depth_max"] == 5
    assert stats["occupancy_mean"] == pytest.approx(0.75)
    assert stats["phase_ms_mean"]["queue_ms"] == pytest.approx(10.0)
    # outside the asked-for trailing window: nothing aggregates
    assert health.window_stats(snap, 5.0, now=200.0)["requests"] == 0


def test_history_reservoir_bounded_and_ring_pinned():
    h = health.HealthHistory(window_s=1.0, horizon_s=4.0,
                             samples_per_window=8)
    assert h.ring_len() == 4  # the O(1)-memory pin
    for i in range(100):
        h.record_request(float(i), t=0.5)
    snap = h.snapshot(now=0.9)
    (w,) = snap["windows"]
    assert w["requests"] == 100
    assert len(w["samples"]) == 8  # reservoir capped, stride-replaced
    assert w["lat_max"] == 99.0
    # wraparound: one request per second for 3 horizons never grows
    # the ring, and the cumulative totals stay exact
    for i in range(12):
        h.record_request(1.0, t=float(i) + 0.5)
    snap = h.snapshot(now=12.0)
    assert len(snap["windows"]) <= h.ring_len()
    assert snap["totals"]["requests"] == 112
    for w in snap["windows"]:
        assert len(w["samples"]) <= 8


def test_history_disabled_records_nothing():
    h = health.HealthHistory(window_s=1.0, horizon_s=5.0, enabled=False)
    h.record_request(5.0, t=0.5)
    h.record_shed("queue_full", t=0.5)
    assert h.snapshot(now=1.0)["windows"] == []
    assert h.snapshot(now=1.0)["totals"]["requests"] == 0
    h.set_enabled(True)
    h.record_request(5.0, t=0.5)
    assert h.snapshot(now=1.0)["totals"]["requests"] == 1


def test_history_concurrency_no_torn_windows():
    """Writer threads hammer the recorder while scraper threads
    snapshot: every observed window must be internally consistent
    (sum/count/phases recorded under one lock) and the cumulative
    totals monotone — a torn window would break the exact lat_sum ==
    requests invariant below."""
    h = health.HealthHistory(window_s=0.05, horizon_s=2.0,
                             samples_per_window=32)
    stop = threading.Event()
    errors = []

    def writer():
        while not stop.is_set():
            h.record_request(1.0, {"a": 2.0})
            h.record_shed("queue_full")
            h.record_queue_depth(3)

    def scraper():
        last_total = 0
        while not stop.is_set():
            snap = h.snapshot()
            try:
                total = snap["totals"]["requests"]
                assert total >= last_total, "non-monotone totals"
                last_total = total
                for w in snap["windows"]:
                    assert w["lat_sum"] == pytest.approx(
                        w["requests"] * 1.0), "torn lat_sum"
                    assert all(s == 1.0 for s in w["samples"])
                    if w["requests"]:
                        assert w["phases"]["a"] == pytest.approx(
                            w["requests"] * 2.0), "torn phases"
                    assert len(w["samples"]) <= 32
            except AssertionError as exc:
                errors.append(exc)
                stop.set()

    threads = ([threading.Thread(target=writer) for _ in range(3)]
               + [threading.Thread(target=scraper) for _ in range(2)])
    for t in threads:
        t.start()
    time.sleep(0.8)
    stop.set()
    for t in threads:
        t.join(timeout=10.0)
    assert not errors, errors[0]
    assert h.snapshot()["totals"]["requests"] > 0


def test_merge_history_folds_by_epoch():
    a = health.HealthHistory(window_s=1.0, horizon_s=10.0)
    b = health.HealthHistory(window_s=1.0, horizon_s=10.0)
    a.record_request(10.0, {"queue_ms": 4.0}, t=100.5)
    b.record_request(30.0, {"queue_ms": 6.0}, t=100.5)  # same epoch
    b.record_request(20.0, t=101.5)                     # a second epoch
    a.record_shed("queue_full", t=100.5)
    b.record_queue_depth(7, t=100.5)
    merged = health.merge_history([a.snapshot(now=102.0),
                                   b.snapshot(now=102.0)])
    assert merged["totals"] == {"requests": 3, "shed": 1,
                                "latency_ms_sum": 60.0}
    w100 = [w for w in merged["windows"] if w["epoch"] == 100]
    (w,) = w100
    assert w["requests"] == 2 and w["lat_max"] == 30.0
    assert sorted(w["samples"]) == [10.0, 30.0]
    assert w["phases"]["queue_ms"] == pytest.approx(10.0)
    assert w["queue_depth"] == 7
    assert len(merged["windows"]) == 2
    assert health.merge_history([])["totals"]["requests"] == 0


def test_window_stats_bad_fraction():
    h = health.HealthHistory(window_s=1.0, horizon_s=10.0)
    for lat in (1.0, 2.0, 3.0, 50.0):  # one over a 10ms objective
        h.record_request(lat, t=100.5)
    h.record_shed("queue_full", t=100.5)
    stats = health.window_stats(h.snapshot(now=101.0), 5.0, now=101.0,
                                objective_ms=10.0)
    # bad = 1 over-objective + 1 shed of 5 total outcomes
    assert stats["bad"] == pytest.approx(2.0)
    assert stats["bad_fraction"] == pytest.approx(2.0 / 5.0)


# -- SLO monitor -------------------------------------------------------------

def _fill(history, n, latency_ms, t, phases=None):
    for _ in range(n):
        history.record_request(latency_ms, phases, t=t)


def test_slo_monitor_transitions_emit_steplog(tmp_path):
    hist = health.HealthHistory(window_s=1.0, horizon_s=300.0)
    slog = steplog.StepLog(str(tmp_path), run_name="slo",
                           compile_events=False)
    mon = health.SloMonitor([], p99_ms=10.0, availability=99.0,
                            history=hist, slog=slog, model="mnist_mlp")
    assert mon.active
    # synthetic records must sit inside the snapshot horizon, which is
    # anchored at the real wall clock
    now = time.time()
    # exemplars feed the breaching-phase attribution
    tracing.get_exemplars().offer(100.0, {"queue_ms": 90.0,
                                          "dispatch_ms": 10.0})
    # all under objective -> ok (first verdict, no record)
    _fill(hist, 20, 1.0, t=now - 0.5)
    v = mon.evaluate(now=now)
    assert v["state"] == "ok"
    assert v["burn_rates"]["fast"] == 0.0
    assert v["budget_remaining"] == 1.0
    # 2 of 22 over objective -> bad_frac ~0.09 -> burn ~9 -> burning
    _fill(hist, 2, 100.0, t=now - 0.5)
    v = mon.evaluate(now=now)
    assert v["state"] == "burning"
    assert 1.0 < v["burn_rates"]["fast"] < mon.breach_burn
    assert v["breaching_phase"] == "queue_ms"
    # flood of over-objective requests -> burn past 14.4 -> breached
    _fill(hist, 40, 100.0, t=now - 0.5)
    v = mon.evaluate(now=now)
    assert v["state"] == "breached"
    assert v["burn_rates"]["fast"] >= mon.breach_burn
    assert v["budget_remaining"] < 1.0
    # the bad windows age out of both burn windows -> back to ok
    v = mon.evaluate(now=now + 1000.0)
    assert v["state"] == "ok"
    assert mon.evaluations == 4
    slog.close()
    records = steplog.read_jsonl(
        os.path.join(str(tmp_path), "slo.steps.jsonl"))
    status = [r for r in records if r["type"] == "slo_status"]
    assert [r["state"] for r in status] == ["burning", "breached", "ok"]
    assert status[0]["prev_state"] == "ok"
    assert status[0]["objective_p99_ms"] == 10.0
    assert status[0]["breaching_phase"] == "queue_ms"
    assert status[0]["model"] == "mnist_mlp"
    assert status[1]["fast_burn"] >= 14.4


def test_slo_monitor_no_objective():
    mon = health.SloMonitor([])
    assert not mon.active
    v = mon.evaluate()
    assert v["state"] == "no_objective"
    assert not v["objective"]["declared"]
    assert v["burn_rates"] == {"fast": 0.0, "slow": 0.0}
    assert v["partial"] is False


def test_slo_monitor_publishes_gauges():
    from paddle_tpu_torch.observe.metrics import MetricsRegistry

    hist = health.HealthHistory(window_s=1.0, horizon_s=300.0)
    reg = MetricsRegistry()
    mon = health.SloMonitor([], p99_ms=10.0, history=hist, registry=reg)
    now = time.time()
    _fill(hist, 10, 100.0, t=now - 0.5)
    mon.evaluate(now=now)
    text = reg.to_prometheus()
    assert "paddle_tpu_slo_objective_p99_ms 10" in text
    assert 'paddle_tpu_slo_burn_rate{window="fast"}' in text
    assert "paddle_tpu_slo_state 2" in text  # breached
    assert "paddle_tpu_slo_budget_remaining 0" in text


def test_slo_monitor_periodic_thread():
    hist = health.HealthHistory(window_s=1.0, horizon_s=300.0)
    mon = health.SloMonitor([], p99_ms=10.0, history=hist,
                            interval_s=0.05)
    mon.start()
    deadline = time.time() + 10.0
    while mon.evaluations == 0 and time.time() < deadline:
        time.sleep(0.02)
    mon.stop()
    assert mon.evaluations > 0


def test_slo_monitor_rejects_bad_availability():
    with pytest.raises(ValueError):
        health.SloMonitor([], availability=100.0)


# -- aggregation: the local (no-workers) front -------------------------------

class _PlainFront:
    """A front with no ``workers()`` — the single-engine/ReplicaSet
    shape: all telemetry already lives in this process's globals."""


def test_collect_traces_local_front():
    ex = tracing.get_exemplars()
    ex.offer(5.0, {"queue_ms": 5.0})
    ex.offer(9.0, {"queue_ms": 9.0})
    out = health.collect_traces([_PlainFront()])
    assert out["partial"] is False and out["workers"] == []
    lats = [e["latency_ms"] for e in out["slowest"]]
    assert lats == sorted(lats, reverse=True)
    assert all("worker" not in e for e in out["slowest"])


def test_collect_history_local_front():
    hist = health.HealthHistory(window_s=1.0, horizon_s=10.0)
    hist.record_request(3.0, t=100.5)
    out = health.collect_history([_PlainFront()], history=hist)
    assert out["partial"] is False and out["workers"] == []
    assert out["totals"]["requests"] == 1


# -- HTTP surface: single in-process engine ----------------------------------

def _mlp_bundle(tmp, name="mnist_mlp"):
    from paddle_tpu_torch.graph import reset_name_counters
    from paddle_tpu_torch.models.vision import mlp
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.serve import load_bundle
    from paddle_tpu_torch.serve.export import export_bundle

    reset_name_counters()
    out = mlp(hidden=(16, 8))
    params = Parameters.create(out, device="cpu")
    bundle_dir = str(tmp / (name + "_bundle"))
    export_bundle(out, params, bundle_dir, batch_sizes=(1, 4), name=name)
    return load_bundle(bundle_dir, device="cpu")


def _pixels(seed=0, rows=1):
    return (np.random.default_rng(seed)
            .normal(size=(rows, 784)).astype(np.float32))


def test_debug_slo_and_traces_over_http(tmp_path):
    """Tier-1 end of the acceptance matrix: the single-engine server
    answers ``/debug/slo`` (burn-rate verdict, gauges wired) and
    ``/debug/traces`` (merged = local here) through the SAME
    aggregation path the WorkerSet uses."""
    from paddle_tpu_torch.serve import InferenceEngine
    from paddle_tpu_torch.serve.server import serve_in_thread

    bundle = _mlp_bundle(tmp_path)
    with InferenceEngine(bundle, warmup=True) as eng:
        mon = health.SloMonitor([eng], p99_ms=10_000.0)
        server, _ = serve_in_thread(bundle, eng, slo=mon)
        base = "http://%s:%d" % server.server_address
        try:
            for i in range(4):
                eng.infer({"pixel": _pixels(i)}, timeout=120.0)
            slo = json.load(urllib.request.urlopen(base + "/debug/slo",
                                                   timeout=30))
            assert slo["state"] == "ok"  # 10s objective: nothing bad
            assert slo["objective"]["p99_ms"] == 10_000.0
            assert slo["current"]["requests"] >= 4
            assert slo["partial"] is False
            assert "breaching_phase" in slo  # exemplars attributed
            traces = json.load(urllib.request.urlopen(
                base + "/debug/traces", timeout=30))
            assert traces["partial"] is False
            assert len(traces["slowest"]) >= 4
            lats = [e["latency_ms"] for e in traces["slowest"]]
            assert lats == sorted(lats, reverse=True)
        finally:
            server.shutdown()
            server.server_close()


def test_make_server_defaults_no_objective_slo(tmp_path):
    """Without --slo-p99-ms the endpoint still answers: state
    no_objective, current health numbers flowing."""
    from paddle_tpu_torch.serve import InferenceEngine
    from paddle_tpu_torch.serve.server import serve_in_thread

    bundle = _mlp_bundle(tmp_path, name="noslo")
    with InferenceEngine(bundle, warmup=True) as eng:
        server, _ = serve_in_thread(bundle, eng)
        base = "http://%s:%d" % server.server_address
        try:
            slo = json.load(urllib.request.urlopen(base + "/debug/slo",
                                                   timeout=30))
            assert slo["state"] == "no_objective"
        finally:
            server.shutdown()
            server.server_close()


# -- cli observe: fleet-merged tail attribution ------------------------------

def _write_worker_log(directory, base, worker, latencies, phase_key):
    path = os.path.join(directory,
                        "%s-w%d.steps.jsonl" % (base, worker))
    with open(path, "w") as f:
        f.write(json.dumps({"type": "meta", "run":
                            "%s-w%d" % (base, worker), "schema": 1,
                            "backend": "cpu", "worker": worker}) + "\n")
        for i, lat in enumerate(latencies):
            f.write(json.dumps({
                "type": "serve_trace", "latency_ms": lat,
                "phases": {phase_key: lat * 0.9,
                           "serialize_ms": lat * 0.1},
                "t": float(i)}) + "\n")
        f.write(json.dumps({"type": "end", "steps": 0}) + "\n")
    return path


def test_summarize_dir_merges_worker_traces(tmp_path):
    """Two worker files whose MERGED p99
    differs from either file's own — the fleet summary must pool the
    serve_trace streams before attributing, and carry the per-worker
    breakdown."""
    from paddle_tpu_torch.observe.metrics import percentile

    d = str(tmp_path)
    w0_lats = [float(i) for i in range(1, 11)]    # 1..10 ms
    w1_lats = [float(i) for i in range(11, 21)]   # 11..20 ms
    _write_worker_log(d, "burst", 0, w0_lats, "dispatch_ms")
    _write_worker_log(d, "burst", 1, w1_lats, "queue_ms")
    summary = steplog.summarize_dir(d)
    (fleet,) = summary["fleets"]
    assert fleet["run"] == "burst"
    assert fleet["serve_traces"] == 20
    merged_thresh = fleet["serve_tail"]["threshold_ms"]
    own = {run["file"]: run["serve_tail"]["threshold_ms"]
           for run in summary["runs"]}
    # the merged p99 is the FLEET's, not either worker's own
    assert merged_thresh == pytest.approx(
        percentile(w0_lats + w1_lats, 99))
    assert merged_thresh != own["burst-w0.steps.jsonl"]
    assert merged_thresh != own["burst-w1.steps.jsonl"]
    # the fleet tail is dominated by w1's queue_ms phase
    phases = fleet["serve_tail"]["phases"]
    assert phases["queue_ms"] > phases.get("dispatch_ms", 0.0)
    # per-worker breakdown rides along
    assert fleet["workers"]["0"]["traces"] == 10
    assert fleet["workers"]["1"]["p99_ms"] == pytest.approx(
        percentile(w1_lats, 99), abs=0.01)


def test_cli_observe_prints_fleet_breakdown(tmp_path, capsys):
    from paddle_tpu_torch import cli

    d = str(tmp_path)
    _write_worker_log(d, "burst", 0, [1.0, 2.0], "dispatch_ms")
    _write_worker_log(d, "burst", 1, [30.0, 40.0], "queue_ms")
    rc = cli.main(["observe", d])
    assert rc == 0
    out = capsys.readouterr().out
    assert "fleet burst merged tail attribution" in out
    assert "per-worker:" in out
    assert "w0 p99" in out and "w1 p99" in out


# -- the worker fan-out (serve/workers.py) ---------------------------------

class _Handle:
    """A worker handle as the fan-out sees it: an index, liveness, and a
    control RPC answering the ``traces`` / ``history`` verbs (``history``
    with the snapshot it was given)."""

    def __init__(self, index, dead=False, history=None):
        self.index = index
        self._dead = dead
        self._history = history

    def dead(self):
        return self._dead

    def try_rpc(self, header, timeout=2.0):
        if header["op"] == "traces":
            return {"ok": True, "traces": {
                "sampled": 1, "exemplars_offered": 2, "exemplars_kept": 1,
                "slowest": [{"latency_ms": 1e6 + self.index,
                             "phases": {"queue_ms": 1.0}}]}}
        return {"ok": True, "history": self._history}


class _WorkerFront:
    """A front with worker handles (the WorkerSet shape): worker 0
    answers, worker 1 is dead."""

    def __init__(self, history=None):
        self._history = history

    def workers(self):
        return [_Handle(0, history=self._history), _Handle(1, dead=True)]


@pytest.mark.parametrize("collect", ["collect_traces", "collect_history"])
def test_worker_fronts_raise_by_name(collect):
    """The fan-out over a front with workers (the name is kept from when
    it raised): each live worker's reply merges in, exemplars stamped
    ``worker``, a dead worker makes the answer partial, and the port's
    merge equals the JAX module's over the same replies."""
    from paddle_tpu.observe import tracing as jax_tracing

    if collect == "collect_traces":
        jax_tracing.get_exemplars().reset()  # the fixture empties the port's
        base = tracing.trace_state(), jax_tracing.trace_state()
        out = health.collect_traces([_WorkerFront()])
        jout = jax_health.collect_traces([_WorkerFront()])
        assert out["slowest"] == jout["slowest"]
        assert out["slowest"][0]["worker"] == "0"
        assert out["slowest"][0]["latency_ms"] == 1e6
        for key, added in (("sampled", 1), ("exemplars_offered", 2),
                           ("exemplars_kept", 1)):
            assert out[key] - base[0][key] == \
                jout[key] - base[1][key] == added
    else:
        (hist, jhist), now = _twin_histories(0)
        (worker, _), _ = _twin_histories(10)
        front = _WorkerFront(worker.snapshot(now=now))
        out = health.collect_history([front], history=hist)
        jout = jax_health.collect_history([front], history=jhist)
        assert _without_clock(out) == _without_clock(jout)
        assert out["totals"] == health.merge_history(
            [hist.snapshot(now=now), worker.snapshot(now=now)])["totals"]
    assert out["workers"] == jout["workers"] == ["0"]
    assert out["partial"] is True and jout["partial"] is True


# -- the port's copy against the JAX module ---------------------------------

def _twin_histories(seed):
    """The same synthetic requests, sheds, queue depths and occupancy
    recorded into a port and a JAX history."""
    rng = np.random.RandomState(seed)
    now = time.time()
    pair = (health.HealthHistory(window_s=1.0, horizon_s=60.0),
            jax_health.HealthHistory(window_s=1.0, horizon_s=60.0))
    for i in range(200):
        t = now - 30.0 + i * 0.15
        lat = float(rng.exponential(5.0))
        phases = {"queue_ms": lat * 0.3, "dispatch_ms": lat * 0.7}
        for hist in pair:
            hist.record_request(lat, phases, t=t)
            if i % 17 == 0:
                hist.record_shed("queue_full", t=t)
            if i % 5 == 0:
                hist.record_queue_depth(i % 9, t=t)
                hist.record_occupancy((i % 4) / 4.0, t=t)
    return pair, now


def _without_clock(snap):
    return {k: v for k, v in snap.items() if k != "now"}


@pytest.mark.parametrize("seed", [0, 1])
def test_history_merge_and_window_stats_match_jax(seed):
    (hist, jhist), now = _twin_histories(seed)
    snap, jsnap = hist.snapshot(now=now), jhist.snapshot(now=now)
    assert _without_clock(snap) == _without_clock(jsnap)
    merged = health.merge_history([snap, snap])
    jmerged = jax_health.merge_history([jsnap, jsnap])
    assert _without_clock(merged) == _without_clock(jmerged)
    for span in (5.0, 60.0):
        assert health.window_stats(merged, span, now=now,
                                   objective_ms=8.0) == \
            jax_health.window_stats(jmerged, span, now=now,
                                    objective_ms=8.0)


@pytest.mark.parametrize("p99_ms,availability", [(8.0, 99.0),
                                                 (50.0, 99.9)])
def test_slo_verdicts_match_jax(p99_ms, availability):
    from paddle_tpu.observe import tracing as jax_tracing

    # the verdict attributes the tail over each package's process-global
    # exemplar reservoir: both start empty (the fixture empties the port's)
    jax_tracing.get_exemplars().reset()
    (hist, jhist), now = _twin_histories(7)
    verdicts = [mod.SloMonitor([], p99_ms=p99_ms,
                               availability=availability,
                               history=h).evaluate(now=now)
                for mod, h in ((health, hist), (jax_health, jhist))]
    got, want = ({k: v for k, v in verdict.items() if k != "t"}
                 for verdict in verdicts)
    assert got == want
