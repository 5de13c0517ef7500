"""Replica fleets of the port on the CPU (serve/fleet.py, the bundle's
views), against the JAX package's bundles of the same numpy parameters
where an answer is compared, and bit for bit against one engine within
the port:

* a bundle's views: the parameter payload cached per device, the programs
  loaded once and shared, two engine threads calling views of one bundle
  at once answer as one thread does, ``last_device_ms`` per thread;
* a bfloat16 decode bundle through the continuous scheduler, its session
  spilled and restored (its carry is bfloat16, which numpy cannot hold);
* ``ReplicaSet`` on ``devices=["cpu", "cpu"]``: least-queued dispatch, a
  replica whose warmup failed is excluded and keeps the fleet not-ready,
  an unwarmed fleet sheds ``no_replica``, ``{replica=}`` metrics and
  step-log records, a continuous fleet's session migrating between
  replicas matches the uninterrupted run bit for bit, the fleet behind the
  router and over HTTP against the JAX bundles.
"""

import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.serve import load_bundle as jax_load

from paddle_tpu_torch.observe import steplog
from paddle_tpu_torch.observe.metrics import MetricsRegistry
from paddle_tpu_torch.serve import (BundleReplica, ContinuousScheduler,
                                    InferenceEngine, Overloaded,
                                    ReplicaSet, Router, load_bundle)
from paddle_tpu_torch.serve.server import serve_router_in_thread
from tests.torch_decode import (GRU_BUILDER, per_request, port_parameters,
                                port_topology, numpy_params, read_records,
                                schema_valid)
from tests.torch_fleet import (FLAGSHIP, FLAGSHIP_BUILDER, FLAGSHIP_OUT,
                               MLP, MLP_BUILDER, TAGGER, TAGGER_OUT,
                               assert_close, assert_equal, export_both,
                               flagship_request, mlp_request,
                               tagger_sequence)

CPUS = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def mlp_dirs(tmp_path_factory):
    return export_both(tmp_path_factory.mktemp("fleet_mlp"), MLP_BUILDER,
                       MLP)


@pytest.fixture(scope="module")
def flagship_dirs(tmp_path_factory):
    return export_both(tmp_path_factory.mktemp("fleet_flagship"),
                       FLAGSHIP_BUILDER, FLAGSHIP)


@pytest.fixture(scope="module")
def tagger_dirs(tmp_path_factory):
    return export_both(tmp_path_factory.mktemp("fleet_tagger"), GRU_BUILDER,
                       TAGGER, decode=True)


def _fleet(bundle, **kw):
    kw.setdefault("metrics_registry", MetricsRegistry())
    kw.setdefault("replicas", 2)
    return ReplicaSet(bundle, devices=CPUS, **kw)


# -- the bundle's views ------------------------------------------------------

def test_params_cache_keyed_by_device_and_views_share_programs(flagship_dirs):
    bundle = load_bundle(flagship_dirs[0], device="cpu")
    assert type(bundle.payload) is dict  # a program's argument
    req = flagship_request(4, seed=2)
    out = bundle.program(4)(bundle.payload, bundle.device_inputs(req))
    np.testing.assert_array_equal(out["lstm_out"].numpy(),
                                  bundle.run(req, 4)["lstm_out"])
    # the bundle's own device: the same payload, one copy, as
    # tests/test_fleet.py reads it (params() and params(device=))
    assert bundle.params() is bundle.payload
    assert bundle.params(device="cpu") is bundle.payload
    np.testing.assert_array_equal(
        bundle.run(req, 4, device="cpu")["lstm_out"],
        bundle.run(req, 4)["lstm_out"])
    view = bundle.view("cpu")
    assert isinstance(view, BundleReplica) and view.device.type == "cpu"
    assert view.name == bundle.name
    assert view.batch_sizes() == bundle.batch_sizes()
    assert view.params() is bundle.params()
    assert view.payload is bundle.payload
    req = flagship_request(3, seed=1)
    assert_equal(view.infer(req), bundle.infer(req))
    # the program the view ran is the bundle's: loaded once
    assert list(bundle.load_seconds) == ["fwd_b4.pt2"]
    assert bundle.view("cpu").view("cpu")._base is bundle
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bundle.view("cuda")


def test_two_engine_threads_on_one_bundle_answer_as_one(flagship_dirs):
    """Two views of one bundle called from two threads at once, each
    cold bucket loaded under the shared lock: every answer equals the
    serial one and every program loads once."""
    serial = load_bundle(flagship_dirs[0], device="cpu")
    reqs = [flagship_request(rows, seed=10 + i)
            for i, rows in enumerate([1, 3, 4, 2] * 4)]
    want = [serial.infer(r) for r in reqs]
    bundle = load_bundle(flagship_dirs[0], device="cpu")
    views = [bundle.view("cpu"), bundle.view("cpu")]
    got = [None] * len(reqs)
    ms = []
    gate = threading.Barrier(2)

    def run(k):
        gate.wait()
        for i in range(k, len(reqs), 2):
            got[i] = views[k].infer(reqs[i])
        ms.append(views[k].last_device_ms)

    threads = [threading.Thread(target=run, args=(k,)) for k in (0, 1)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        assert_equal(g, w)
    assert sorted(bundle.load_seconds) == ["fwd_b1.pt2", "fwd_b4.pt2"]
    assert ms == [None, None]  # CUDA events only on the card


def test_two_bundles_load_their_programs_on_two_threads(flagship_dirs,
                                                       tagger_dirs):
    """Two bundles warming at once (two hosted models): ``torch.export.
    load`` keeps its deserializer in a process-wide global, so the loads
    must not overlap; every program loads and answers."""
    for attempt in range(6):
        bundles = [load_bundle(flagship_dirs[0], device="cpu"),
                   load_bundle(tagger_dirs[0], device="cpu")]
        gate = threading.Barrier(2)
        errors = []

        def warm(bundle):
            gate.wait()
            try:
                bundle.warmup()
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(exc)

        threads = [threading.Thread(target=warm, args=(b,))
                   for b in bundles]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, (attempt, errors)
        assert [len(b.load_seconds) for b in bundles] == [2, 1]


def test_bf16_decode_bundle_spills_and_restores(tmp_path):
    """A decode bundle exported under the bfloat16 policy carries a
    bfloat16 carry: the scheduler warms up, spills it (a CPU tensor on the
    host, numpy has no bfloat16), restores it, and answers as the pinned
    run does, bit for bit."""
    from paddle_tpu_torch.core import dtype as dtype_mod
    from paddle_tpu_torch.serve.export import export_bundle

    topology = port_topology(GRU_BUILDER, **TAGGER)
    params = port_parameters(topology, numpy_params(
        topology.param_specs(), 7))
    dtype_mod.set_mixed_precision("bfloat16")
    try:
        manifest = export_bundle(topology.outputs, params, str(tmp_path),
                                 batch_sizes=(1,), seq_len=32,
                                 decode_slots=(2,), decode_window=4)
    finally:
        dtype_mod.set_mixed_precision(None)
    assert {leaf["dtype"] for leaves in manifest["decode"]["carry"].values()
            for leaf in leaves} == {"bfloat16"}
    bundle = load_bundle(str(tmp_path), device="cpu")
    seq = tagger_sequence(10, seed=4)
    with ContinuousScheduler(bundle, metrics_registry=MetricsRegistry(),
                             paging=False) as pinned:
        want = [pinned.infer({"word": seq[:5]}, session_id="s")[TAGGER_OUT],
                pinned.infer({"word": seq[5:]}, session_id="s")[TAGGER_OUT]]
    with ContinuousScheduler(bundle,
                             metrics_registry=MetricsRegistry()) as paged:
        head = paged.infer({"word": seq[:5]}, session_id="s")[TAGGER_OUT]
        paged.spill_session("s")
        state = paged.export_session("s")
        leaf = next(iter(state.carry.values()))[0]
        assert torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16
        paged.import_session("s", state)
        tail = paged.infer({"word": seq[5:]}, session_id="s")[TAGGER_OUT]
        assert paged.stats()["restores"] == 1
    np.testing.assert_array_equal(head, want[0])
    np.testing.assert_array_equal(tail, want[1])


# -- dispatch ----------------------------------------------------------------

def test_fleet_least_queued_dispatch_prefers_short_queue(mlp_dirs):
    """Once the held replica has a queued row, every new request lands on
    the other one (round-robin only breaks ties)."""
    bundle = load_bundle(mlp_dirs[0], device="cpu")
    fleet = _fleet(bundle, engine_kwargs={"max_latency_ms": 1.0,
                                          "max_batch_size": 1})
    r0, r1 = fleet.replicas()
    assert [str(r.device) for r in (r0, r1)] == CPUS
    gate = threading.Event()
    real_run = r0.bundle.run

    def gated_run(flat, batch):
        gate.wait(timeout=120)
        return real_run(flat, batch)

    r0.bundle.run = gated_run  # on the r0 view only
    try:
        x = mlp_request(1)
        f_a = fleet.submit(dict(x))
        f_b = fleet.submit(dict(x))
        f_b.result(timeout=60)
        deadline = time.time() + 30
        while (r0.engine.queue_depth() != 0
               or r0.engine.stats()["in_flight"] != 1):
            assert time.time() < deadline
            time.sleep(0.01)
        f_c = fleet.submit(dict(x))
        deadline = time.time() + 30
        while r0.engine.queue_depth() != 1:
            assert time.time() < deadline
            time.sleep(0.01)
        for _ in range(3):
            fleet.submit(dict(x)).result(timeout=60)  # only r1 can answer
        assert r1.engine.stats()["requests"] == 4
        assert not f_a.done() and not f_c.done()
        gate.set()
        f_a.result(timeout=60)
        f_c.result(timeout=60)
        assert r0.engine.stats()["requests"] == 2
        assert fleet.stats()["requests"] == 6
    finally:
        gate.set()
        fleet.stop()


def test_fleet_failed_warmup_replica_excluded(mlp_dirs):
    bundle = load_bundle(mlp_dirs[0], device="cpu")
    calls, lock = [], threading.Lock()
    real_warmup = bundle.warmup

    def flaky_warmup():
        with lock:
            calls.append(1)
            turn = len(calls)
        if turn == 2:
            raise RuntimeError("corrupt artifact")
        return real_warmup()

    bundle.warmup = flaky_warmup  # the views copy it
    fleet = _fleet(bundle, warmup="async")
    try:
        deadline = time.time() + 60
        while len(calls) < 2 or sum(fleet.ready_detail().values()) < 1:
            assert time.time() < deadline
            time.sleep(0.02)
        time.sleep(0.1)
        assert sorted(fleet.ready_detail().values()) == [False, True]
        assert fleet.ready() is False and fleet.live() is True
        for _ in range(3):
            fleet.infer(mlp_request(1), timeout=60)
        cold = next(m for m in fleet.replicas() if not m.engine.ready())
        warm = next(m for m in fleet.replicas() if m.engine.ready())
        assert cold.engine.stats()["requests"] == 0
        assert warm.engine.stats()["requests"] == 3
    finally:
        fleet.stop()


def test_fleet_no_warm_replica_sheds(mlp_dirs):
    bundle = load_bundle(mlp_dirs[0], device="cpu")
    gate = threading.Event()
    real_warmup = bundle.warmup

    def gated_warmup():
        gate.wait(timeout=60)
        return real_warmup()

    bundle.warmup = gated_warmup
    reg = MetricsRegistry()
    fleet = _fleet(bundle, metrics_registry=reg, model="m", warmup="async")
    try:
        with pytest.raises(Overloaded) as exc_info:
            fleet.submit(mlp_request(1))
        assert exc_info.value.reason == "no_replica"
        assert exc_info.value.model == "m"
    finally:
        gate.set()
        fleet.stop()
    assert reg.snapshot()["counters"][
        'paddle_tpu_serve_shed_total{model="m",reason="no_replica"}'] == 1


def test_fleet_replica_metrics_and_steplog(mlp_dirs, tmp_path):
    bundle = load_bundle(mlp_dirs[0], device="cpu")
    reg = MetricsRegistry()
    slog = steplog.StepLog(str(tmp_path), run_name="fleet",
                           compile_events=False)
    fleet = _fleet(bundle, metrics_registry=reg, model="mlp", steplog=slog,
                   engine_kwargs={"max_latency_ms": 1.0})
    for _ in range(6):
        fleet.infer(mlp_request(1), timeout=60)
    deadline = time.time() + 30
    while fleet.stats()["requests"] != 6 and time.time() < deadline:
        time.sleep(0.01)
    stats = fleet.stats()
    fleet.stop()
    slog.close()
    assert stats["requests"] == 6 and stats["devices"] == CPUS
    assert set(stats["per_replica"]) == {"0", "1"}
    assert all(s["requests"] > 0 for s in stats["per_replica"].values())
    text = reg.to_prometheus()
    assert 'model="mlp",replica="0"' in text
    assert 'model="mlp",replica="1"' in text
    records = read_records(slog.path)
    schema_valid(records)
    batches = [r for r in records if r["type"] == "serve_batch"]
    assert batches and {r["replica"] for r in batches} == {"0", "1"}


# -- sessions ----------------------------------------------------------------

def _hold(replica):
    """Take a replica out of dispatch (its engine reads not-ready) until
    the returned callable puts it back."""
    replica.engine.ready = lambda: False

    def release():
        del replica.engine.ready

    return release


def test_continuous_fleet_session_migrates_bitwise(tagger_dirs, tmp_path):
    """A session's home replica leaves dispatch after chunk 1: chunk 2
    runs on the other replica, its carry migrated there (export ->
    import); the home comes back for chunk 3 and the carry migrates home.
    The chunks equal the uninterrupted run bit for bit, and the fleet's
    decode records carry the replica field."""
    bundle = load_bundle(tagger_dirs[0], device="cpu")
    seq = tagger_sequence(18, seed=9)
    with ContinuousScheduler(bundle,
                             metrics_registry=MetricsRegistry()) as one:
        want = [one.infer({"word": seq[i:i + 6]}, session_id="u")[TAGGER_OUT]
                for i in (0, 6, 12)]
    slog = steplog.StepLog(str(tmp_path), run_name="cfleet",
                           compile_events=False)
    fleet = _fleet(bundle, continuous=True, model="tagger", steplog=slog)
    try:
        home = fleet._ring.lookup("u")
        members = fleet.replicas()
        got = [fleet.infer({"word": seq[:6]}, session_id="u")[TAGGER_OUT]]
        assert members[home].engine.has_session("u")
        release = _hold(members[home])
        got.append(fleet.infer({"word": seq[6:12]},
                               session_id="u")[TAGGER_OUT])
        assert members[1 - home].engine.has_session("u")
        assert not members[home].engine.has_session("u")
        release()
        got.append(fleet.infer({"word": seq[12:]},
                               session_id="u")[TAGGER_OUT])
        assert members[home].engine.has_session("u")
        stats = fleet.stats()
        fleet.close_session("u")
        assert not any(m.engine.has_session("u") for m in members)
    finally:
        fleet.stop()
        slog.close()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert stats["session_routes"] == 1
    assert sum(s.get("imports", 0)
               for s in stats["per_replica"].values()) == 2
    decodes = [r for r in read_records(slog.path)
               if r["type"] == "serve_decode"]
    assert {r["replica"] for r in decodes} == {"0", "1"}
    with _fleet(bundle) as batch_fleet:
        with pytest.raises(ValueError, match="does not hold sessions"):
            batch_fleet.submit({"word": seq[:2]}, session_id="x")


def test_continuous_fleet_answers_equal_jax(tagger_dirs):
    port, ref = (load_bundle(tagger_dirs[0], device="cpu"),
                 jax_load(tagger_dirs[1]))
    seqs = [tagger_sequence(n, seed=20 + n) for n in (5, 2, 7, 3)]
    with _fleet(port, continuous=True) as fleet:
        futures = [fleet.submit({"word": s}) for s in seqs]
        got = [f.result(timeout=120)[TAGGER_OUT] for f in futures]
        per = fleet.stats()["per_replica"]
    for seq, answer in zip(seqs, got):
        np.testing.assert_allclose(answer, per_request(ref, seq, TAGGER_OUT),
                                   rtol=1e-5, atol=1e-6)
    assert all(s["requests"] > 0 for s in per.values())


# -- the front door ----------------------------------------------------------

def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return json.load(urllib.request.urlopen(req, timeout=60))


def test_fleet_behind_router_and_http(flagship_dirs, mlp_dirs):
    """Two fleets behind the router and HTTP: answers within 1e-5 of the
    JAX bundles, all-replicas-warm ``/readyz``, ``{replica=}`` in
    ``/metrics``, per-model stats."""
    flag = load_bundle(flagship_dirs[0], device="cpu")
    mlp = load_bundle(mlp_dirs[0], device="cpu")
    reg = MetricsRegistry()
    router = Router(metrics_registry=reg)
    for name, bundle in (("flag", flag), ("mlp", mlp)):
        router.add_model(name, bundle, _fleet(
            bundle, metrics_registry=reg, model=name,
            engine_kwargs={"max_latency_ms": 1.0}))
    with router:
        server, thread = serve_router_in_thread(router)
        base = "http://%s:%d" % server.server_address
        try:
            assert json.load(urllib.request.urlopen(
                base + "/readyz", timeout=30)) == {
                "ready": True, "models": {"flag": True, "mlp": True}}
            for name, req, ref_dir in (
                    ("flag", flagship_request(3, seed=5), flagship_dirs[1]),
                    ("mlp", mlp_request(2, seed=6), mlp_dirs[1])):
                resp = _post(base + "/infer/" + name, {"inputs": {
                    k: v.tolist() for k, v in req.items()}})
                want = jax_load(ref_dir).infer(req)
                assert_close({k: np.asarray(v, np.float32)
                              for k, v in resp["outputs"].items()},
                             {k: np.asarray(v) for k, v in want.items()})
            metrics = urllib.request.urlopen(base + "/metrics",
                                             timeout=30).read().decode()
            assert 'model="flag",replica="1"' in metrics
            stats = json.load(urllib.request.urlopen(base + "/stats",
                                                     timeout=30))
            assert stats["models"]["mlp"]["replicas"] == 2
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                _post(base + "/infer/nope", {"inputs": {}})
            assert exc_info.value.code == 404
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                _post(base + "/infer", {"inputs": {}})
            assert exc_info.value.code == 400  # two models: name one
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)


def test_fleet_answers_equal_one_engine_bitwise(flagship_dirs):
    bundle = load_bundle(flagship_dirs[0], device="cpu")
    reqs = [flagship_request(rows, seed=30 + rows) for rows in (1, 2, 4, 3)]
    with InferenceEngine(bundle, metrics_registry=MetricsRegistry(),
                         max_latency_ms=1.0) as one:
        want = [one.infer(r) for r in reqs]
    with _fleet(bundle, engine_kwargs={"max_latency_ms": 1.0}) as fleet:
        got = [fleet.infer(r) for r in reqs]
    for g, w in zip(got, want):
        assert_equal(g, w)
    assert FLAGSHIP_OUT in got[0]


def test_fleet_knobs_are_fleet_wide(mlp_dirs):
    """The dispatch width narrows fresh requests to the first replicas;
    each knob the member engines share moves every member."""
    from paddle_tpu_torch.control.knobs import KnobRegistry

    bundle = load_bundle(mlp_dirs[0], device="cpu")
    with _fleet(bundle, engine_kwargs={"max_latency_ms": 1.0}) as fleet:
        knobs = KnobRegistry()
        fleet.register_knobs(knobs)
        assert "fleet.active_replicas" in knobs.names()
        assert "engine.batch_deadline_ms" in knobs.names()
        knobs.set("engine.batch_deadline_ms", 3.0)
        assert [m.engine.max_latency_ms for m in fleet.replicas()] == [
            3.0, 3.0]
        knobs.set("fleet.active_replicas", 1)
        for _ in range(4):
            fleet.infer(mlp_request(1), timeout=60)
        deadline = time.time() + 30
        while fleet.stats()["requests"] < 4 and time.time() < deadline:
            time.sleep(0.01)
        per = fleet.stats()["per_replica"]
        assert (per["0"]["requests"], per["1"]["requests"]) == (4, 0)
        assert fleet.stats()["active_replicas"] == 1
