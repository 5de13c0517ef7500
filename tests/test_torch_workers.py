"""The worker-process data plane of the port on the CPU (serve/workers.py):
spawned workers (``OMP_NUM_THREADS=1`` in their environment) serving the
small flagship and the continuous tagger over shared-memory rings.

* a cold fleet sheds ``no_replica``; answers through each worker equal
  the in-process engine's bit for bit and the JAX bundle's within
  ``rtol=1e-5, atol=1e-6``;
* the merged ``/metrics`` holds ``worker="0"`` and ``worker="1"`` series
  (the contract of paddle_tpu/serve/workers.py's ``_MergedMetrics``; the
  JAX package's own smoke test finds them missing), and
  ``/debug/traces`` fans out to both workers;
* a session migrates across processes bit for bit; kill -9 of its home
  worker re-homes it from the committed backup bit for bit; a burst in
  flight at a kill is re-routed; ``respawn`` revives the worker;
* SIGTERM on ``cli serve --workers 2`` exits 0 and leaves no child
  process and no shared-memory segment.

Spawns: two fleets of two workers, two respawns and the CLI's two
workers, each fleet built once per module and stopped in ``finally``.
Every wait has its own timeout.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from paddle_tpu.serve import load_bundle as jax_load

from paddle_tpu_torch.control.knobs import KnobRegistry
from paddle_tpu_torch.observe import health
from paddle_tpu_torch.observe.metrics import MetricsRegistry
from paddle_tpu_torch.serve import (ConsistentHashRing, ContinuousScheduler,
                                    InferenceEngine, Overloaded, WorkerSet,
                                    load_bundle, serve_in_thread)
from paddle_tpu_torch.serve.workers import SHM_PREFIX
from tests.torch_decode import GRU_BUILDER
from tests.torch_fleet import (FLAGSHIP, FLAGSHIP_BUILDER, FLAGSHIP_OUT,
                               TAGGER, TAGGER_OUT, assert_close,
                               assert_equal, export_both, flagship_request,
                               tagger_sequence)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READY_S = 300.0


def _segments(pid=None):
    prefix = "%s-%d-" % (SHM_PREFIX, os.getpid() if pid is None else pid)
    return [p for p in os.listdir("/dev/shm") if p.startswith(prefix)]


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


@pytest.fixture(scope="module")
def one_thread():
    """The workers inherit the environment at spawn: one thread each, so
    they do not crowd the suite's other test processes."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture(scope="module")
def flagship_dirs(tmp_path_factory):
    return export_both(tmp_path_factory.mktemp("workers_flagship"),
                       FLAGSHIP_BUILDER, FLAGSHIP)


@pytest.fixture(scope="module")
def tagger_dir(tmp_path_factory):
    return export_both(tmp_path_factory.mktemp("workers_tagger"),
                       GRU_BUILDER, TAGGER, decode=True)[0]


@pytest.fixture(scope="module")
def fp_fleet(one_thread, flagship_dirs):
    """Two workers serving the flagship; ``cold`` is the shed of a request
    sent before any worker was warm."""
    bundle = load_bundle(flagship_dirs[0], device="cpu")
    ws = WorkerSet(bundle, workers=2, model="flag",
                   metrics_registry=MetricsRegistry())
    try:
        try:
            ws.submit(flagship_request(1))
            cold = None
        except Overloaded as exc:
            cold = exc
        ws.wait_ready(timeout=READY_S)
        yield ws, bundle, cold
    finally:
        ws.stop()
    # the module's first fleet stops last: no segment of either is left
    assert not _segments()


@pytest.fixture(scope="module")
def tagger_fleet(one_thread, tagger_dir):
    bundle = load_bundle(tagger_dir, device="cpu")
    ws = WorkerSet(bundle, workers=2, continuous=True, respawn=True,
                   model="tagger", metrics_registry=MetricsRegistry())
    try:
        ws.wait_ready(timeout=READY_S)
        yield ws, bundle
    finally:
        ws.stop()


# -- the flagship fleet ------------------------------------------------------

def test_cold_fleet_sheds_no_replica(fp_fleet):
    ws, _, cold = fp_fleet
    assert isinstance(cold, Overloaded)
    assert (cold.reason, cold.model) == ("no_replica", "flag")
    assert ws.ready() and ws.ready_detail() == {"0": True, "1": True}
    assert ws.live_detail() == {"0": True, "1": True}


def test_answers_through_each_worker_equal_the_engine(fp_fleet,
                                                      flagship_dirs):
    ws, bundle, _ = fp_fleet
    ref = jax_load(flagship_dirs[1])
    reqs = [flagship_request(rows, seed=40 + rows) for rows in (1, 3, 4)]
    with InferenceEngine(bundle, metrics_registry=MetricsRegistry(),
                         max_latency_ms=1.0) as one:
        want = [one.infer(r) for r in reqs]
    for index in (0, 1):
        for req, w in zip(reqs, want):
            got = ws.submit_to(index, req).result(timeout=120)
            assert_equal(got, w)
            assert_close(got, {k: np.asarray(v)
                               for k, v in ref.infer(req).items()})
    assert_equal(ws.infer(reqs[0], timeout=120), want[0])
    per = ws.stats()["per_worker"]
    assert all(per[i]["requests"] >= 3 for i in ("0", "1"))
    assert len({per["0"]["pid"], per["1"]["pid"]}) == 2
    assert set(per["0"]["kernel_launches"]) == {
        "lstm_seq_fwd", "gru_seq_fwd", "int8_matmul", "conv2d_same_fwd"}


def test_merged_metrics_hold_worker_series(fp_fleet):
    ws, bundle, _ = fp_fleet
    ws.infer(flagship_request(2), timeout=120)
    text = ws.metrics.to_prometheus()
    for index in ("0", "1"):
        assert ('paddle_tpu_serve_requests_total{model="flag",replica="%s",'
                'worker="%s"}' % (index, index)) in text
    assert 'paddle_tpu_serve_shed_total{model="flag",reason="no_replica"} 1' \
        in text
    snap = ws.metrics.snapshot()
    assert sorted(snap["workers"]) == ["0", "1"]
    server, thread = serve_in_thread(bundle, ws)
    base = "http://%s:%d" % server.server_address
    try:
        scraped = urllib.request.urlopen(base + "/metrics",
                                         timeout=60).read().decode()
        assert 'worker="0"' in scraped and 'worker="1"' in scraped
        traces = json.load(urllib.request.urlopen(base + "/debug/traces",
                                                  timeout=60))
        assert traces["workers"] == ["0", "1"]
        assert traces["partial"] is False
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    history = health.collect_history([ws])
    assert history["workers"] == ["0", "1"]


def test_worker_knobs_are_fleet_wide(fp_fleet):
    ws, _, _ = fp_fleet
    knobs = KnobRegistry()
    ws.register_knobs(knobs)
    assert "engine.batch_deadline_ms" in knobs.names()
    knobs.set("engine.batch_deadline_ms", 3.0)
    for handle in ws.workers():
        reply = handle.try_rpc({"op": "knobs"}, timeout=10.0)
        assert reply["knobs"]["engine.batch_deadline_ms"]["value"] == 3.0
    assert sorted(ws.compile_counts()) == [0, 1]


# -- the tagger fleet: sessions across processes -----------------------------

def _uninterrupted(bundle, seq, cuts):
    with ContinuousScheduler(bundle,
                             metrics_registry=MetricsRegistry()) as one:
        return [one.infer({"word": seq[a:b]}, session_id="u")[TAGGER_OUT]
                for a, b in cuts]


def test_session_migrates_across_processes_bitwise(tagger_fleet):
    """The session's home worker leaves dispatch after chunk 1 (its handle
    reads not-ready in the parent): chunk 2 runs on the other worker, the
    carry exported from the home's process and imported into the other's;
    the home comes back for chunk 3 and the carry migrates home."""
    ws, bundle = tagger_fleet
    seq = tagger_sequence(18, seed=50)
    cuts = [(0, 6), (6, 12), (12, 18)]
    want = _uninterrupted(bundle, seq, cuts)
    sid = "mig"
    home = ConsistentHashRing([0, 1]).lookup(sid)
    handle = ws.workers()[home]
    got = [ws.infer({"word": seq[0:6]}, session_id=sid,
                    timeout=120)[TAGGER_OUT]]
    handle.ready = lambda: False
    try:
        got.append(ws.infer({"word": seq[6:12]}, session_id=sid,
                            timeout=120)[TAGGER_OUT])
    finally:
        del handle.ready
    got.append(ws.infer({"word": seq[12:18]}, session_id=sid,
                        timeout=120)[TAGGER_OUT])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert ws.stats()["router"]["migrations"] == 2
    ws.close_session(sid)


def test_kill_home_worker_rehomes_session_from_backup(tagger_fleet):
    """Chunks 1-2 on the home worker, kill -9 of that worker, chunks 3-4:
    the session re-homes from the backup committed after chunk 2 and
    equals the uninterrupted run bit for bit; the worker respawns."""
    ws, bundle = tagger_fleet
    seq = tagger_sequence(20, seed=51)
    cuts = [(0, 5), (5, 10), (10, 15), (15, 20)]
    want = _uninterrupted(bundle, seq, cuts)
    sid = "kill"
    home = ConsistentHashRing([0, 1]).lookup(sid)
    got = [ws.infer({"word": seq[a:b]}, session_id=sid,
                    timeout=120)[TAGGER_OUT] for a, b in cuts[:2]]
    deaths = ws.stats()["router"].get("worker_deaths", 0)
    pid = ws.workers()[home].pid()
    os.kill(pid, signal.SIGKILL)
    _wait(lambda: ws.stats()["router"].get("worker_deaths", 0) > deaths,
          60, "the kill was not noticed")
    got += [ws.infer({"word": seq[a:b]}, session_id=sid,
                     timeout=120)[TAGGER_OUT] for a, b in cuts[2:]]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert ws.stats()["router"]["backup_restores"] >= 1
    ws.wait_ready(timeout=READY_S)
    assert ws.workers()[home].pid() != pid


def test_burst_in_flight_at_a_kill_is_rerouted(tagger_fleet):
    """Eight requests pinned to a stopped worker, which is then killed:
    every one is re-routed and answers as one scheduler does; the worker
    respawns and serves again."""
    ws, bundle = tagger_fleet
    seqs = [tagger_sequence(n, seed=60 + n) for n in range(3, 11)]
    with ContinuousScheduler(bundle,
                             metrics_registry=MetricsRegistry()) as one:
        want = [one.infer({"word": s})[TAGGER_OUT] for s in seqs]
    ws.wait_ready(timeout=READY_S)
    before = ws.stats()["router"]
    reroutes = before.get("reroutes", 0)
    respawns = before.get("respawns", 0)
    pid = ws.workers()[1].pid()
    os.kill(pid, signal.SIGSTOP)
    try:
        futures = [ws.submit_to(1, {"word": s}) for s in seqs]
    finally:
        os.kill(pid, signal.SIGKILL)
    got = [f.result(timeout=120)[TAGGER_OUT] for f in futures]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    router = ws.stats()["router"]
    assert router["reroutes"] - reroutes == len(seqs)
    ws.wait_ready(timeout=READY_S)
    assert ws.workers()[1].pid() != pid
    # the respawn follows the re-routes on the heartbeat thread: read its
    # count once the fleet is ready again
    assert ws.stats()["router"]["respawns"] > respawns
    assert ws.submit_to(1, {"word": seqs[0]}).result(
        timeout=120)[TAGGER_OUT].shape == want[0].shape


# -- the CLI -----------------------------------------------------------------

def _children(pid):
    """Every child of ``pid``, whichever of its threads started it."""
    out = []
    for task in os.listdir("/proc/%d/task" % pid):
        with open("/proc/%d/task/%s/children" % (pid, task)) as fh:
            out += [int(p) for p in fh.read().split()]
    return out


def _alive(pid):
    try:
        with open("/proc/%d/stat" % pid) as fh:
            return fh.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def test_cli_serve_workers_sigterm_leaves_nothing(one_thread, flagship_dirs):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.cli", "serve",
         flagship_dirs[0], "--workers", "2", "--device", "cpu",
         "--port", "0"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=ROOT)
    try:
        lines = []
        while not lines or "http://" not in lines[-1]:
            line = proc.stdout.readline()
            assert line, "".join(lines)  # the server exited
            lines.append(line)
        banner = lines[-1]
        base = "http://" + banner.split("http://", 1)[1].split(" ", 1)[0]

        def ready():
            try:
                return urllib.request.urlopen(base + "/readyz",
                                              timeout=10).status == 200
            except OSError:
                return False

        _wait(ready, READY_S, "the workers never became ready")
        req = flagship_request(2, seed=70)
        body = json.dumps({"inputs": {k: v.tolist()
                                      for k, v in req.items()}}).encode()
        resp = json.load(urllib.request.urlopen(urllib.request.Request(
            base + "/infer", data=body,
            headers={"Content-Type": "application/json"}), timeout=60))
        want = load_bundle(flagship_dirs[0], device="cpu").infer(req)
        np.testing.assert_array_equal(
            np.asarray(resp["outputs"][FLAGSHIP_OUT], np.float32),
            want[FLAGSHIP_OUT])
        metrics = urllib.request.urlopen(base + "/metrics",
                                         timeout=60).read().decode()
        assert 'worker="0"' in metrics and 'worker="1"' in metrics
        children = _children(proc.pid)
        assert len(children) >= 2  # the workers (and the resource tracker)
        assert len(_segments(proc.pid)) == 4
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    _wait(lambda: not any(_alive(c) for c in children), 30,
          "a child process outlived the server")
    assert not _segments(proc.pid)
