"""The serving tier's shared pieces against the JAX package, on the CPU:

* ``ConsistentHashRing.order`` equals JAX's for 200 session ids over 1, 2,
  3 and 5 members, and after a member leaves;
* the frame codec (``encode_frames`` / ``encode_state``) writes the JAX
  codec's bytes for the same header and arrays, and each package decodes
  the other's, and JAX decodes the port's bfloat16 carries (a CPU tensor
  in the port, ml_dtypes' bfloat16 in JAX); the ring slot size of the same
  bundle; the shared-memory ring;
* ``estimate_hbm_bytes`` component by component for the mlp, the flagship
  and the tagger (exact payload and shape-derived, serving and training
  with an optimizer), the manifests' ``hbm_estimate_bytes``, the budget
  parser, and ``replicas_that_fit`` / ``auto_replicas`` /
  ``fleet_hbm_check`` under a budget (JAX's
  ``test_fleet_hbm_budget_gate`` and
  ``test_replicas_that_fit_and_budget_aware_auto`` as the oracle);
* the router: two models at priorities high and low over engines held
  still give JAX's sequence of admissions and shed reasons (the scenario
  of JAX's ``test_priority_shed_order_two_models``), with the same
  ``paddle_tpu_serve_shed_total`` series and ``serve_shed`` records; an
  unknown model and an unknown priority are refused as in JAX; the knobs.
"""

import threading

import numpy as np
import pytest
import torch

from paddle_tpu.observe import steplog as jax_steplog
from paddle_tpu.observe.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu.serve import load_bundle as jax_load
from paddle_tpu.serve import workers as jax_workers
from paddle_tpu.serve.sessions import ConsistentHashRing as JaxRing
from paddle_tpu.serve.sessions import SessionState as JaxState

from paddle_tpu_torch.analyze import topology_check as port_tc
from paddle_tpu_torch.observe import steplog
from paddle_tpu_torch.observe.metrics import MetricsRegistry
from paddle_tpu_torch.serve import (ConsistentHashRing, InferenceEngine,
                                    Overloaded, Router, load_bundle)
from paddle_tpu_torch.serve import fleet as port_fleet
from paddle_tpu_torch.serve import workers as port_workers
from paddle_tpu_torch.serve.sessions import SessionState
from tests.torch_decode import (GRU_BUILDER, jax_model, jax_parameters,
                                numpy_params, port_parameters, port_topology)
from tests.torch_fleet import (FLAGSHIP, FLAGSHIP_BUILDER, MLP,
                               MLP_BUILDER, SEQ_LEN, TAGGER, export_both,
                               mlp_request)

SIDS = ["session-%d" % i for i in range(200)]


# -- the hash ring -----------------------------------------------------------

@pytest.mark.parametrize("members", [[0], [0, 1], [0, 1, 2],
                                     [0, 1, 2, 3, 4], [0, 2, 3, 4]])
def test_ring_order_equals_jax(members):
    """The last case is the five-member ring after member 1 left."""
    port, ref = ConsistentHashRing(members), JaxRing(members)
    for sid in SIDS:
        assert port.order(sid) == ref.order(sid), sid
        assert port.lookup(sid) == ref.lookup(sid)


def test_ring_moves_only_the_leavers_sessions():
    full, left = ConsistentHashRing(range(5)), ConsistentHashRing(
        [0, 2, 3, 4])
    for sid in SIDS:
        home = full.lookup(sid)
        if home != 1:
            assert left.lookup(sid) == home
        else:
            assert left.lookup(sid) == full.order(sid)[1]
    with pytest.raises(ValueError, match="at least one member"):
        ConsistentHashRing([])


# -- the frame codec ---------------------------------------------------------

def _arrays(case):
    rng = np.random.RandomState(5)
    if case == "mixed":
        return [np.arange(12, dtype=np.int32).reshape(3, 4),
                rng.randn(2, 5).astype(np.float32),
                np.array([3.5], dtype=np.float64)]
    if case == "strided":
        return [np.arange(48, dtype=np.float32).reshape(6, 8)[::2, 1::3]]
    if case == "scalar_and_bool":
        return [np.float32(2.5), np.arange(3, dtype=np.int64)[None],
                np.array([True, False])]
    return []


def _join(frames):
    return b"".join(bytes(f) for f in frames)


@pytest.mark.parametrize("case", ["mixed", "strided", "scalar_and_bool",
                                  "none"])
def test_frames_are_the_jax_codecs_bytes(case):
    header = {"id": 7, "inputs": ["a", "b", "c"], "session": "s1"}
    arrays = _arrays(case)
    frames, nbytes = port_workers.encode_frames(header, arrays)
    jframes, jnbytes = jax_workers.encode_frames(header, arrays)
    buf = _join(frames)
    assert buf == _join(jframes) and nbytes == jnbytes == len(buf)
    for decode in (port_workers.decode_buffer, jax_workers.decode_buffer):
        got_header, got = decode(buf)
        assert got_header == header
        assert len(got) == len(arrays)
        for want, arr in zip(arrays, got):
            want = np.ascontiguousarray(want)
            assert arr.dtype == want.dtype and arr.shape == want.shape
            np.testing.assert_array_equal(arr, want)


def test_state_frames_cross_the_packages():
    rng = np.random.RandomState(6)
    carry = {"l1": [rng.randn(32).astype(np.float32),
                    rng.randn(32).astype(np.float32)],
             "l0": [rng.randn(12).astype(np.float32)]}
    port = SessionState("s", carry, pos=9, priority="low")
    ref = JaxState("s", carry, pos=9, priority="low")
    head, arrs = port_workers.encode_state(port)
    jhead, jarrs = jax_workers.encode_state(ref)
    assert head == jhead
    buf = _join(port_workers.encode_frames(head, arrs)[0])
    assert buf == _join(jax_workers.encode_frames(jhead, jarrs)[0])
    for decode, decode_state in (
            (port_workers.decode_buffer, port_workers.decode_state),
            (jax_workers.decode_buffer, jax_workers.decode_state)):
        h, a = decode(buf)
        state = decode_state("s", h, a)
        assert (state.pos, state.priority, state.nbytes) == (9, "low",
                                                             76 * 4)
        for layer in carry:
            for want, got in zip(carry[layer], state.carry[layer]):
                np.testing.assert_array_equal(np.asarray(got), want)


def test_bfloat16_carry_frames_cross_the_packages():
    """A bfloat16 leaf: a CPU tensor on the port's side (numpy has no
    bfloat16); JAX decodes the port's frames into ml_dtypes' bfloat16 with
    the same bits."""
    import ml_dtypes

    words = torch.randn(2, 16).to(torch.bfloat16)
    port = SessionState("b", {"gru": [words[0].clone()]}, pos=3)
    head, arrs = port_workers.encode_state(port)
    buf = _join(port_workers.encode_frames(head, arrs)[0])
    jh, ja = jax_workers.decode_buffer(buf)
    ref = jax_workers.decode_state("b", jh, ja)
    leaf = ref.carry["gru"][0]
    assert leaf.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(leaf.view(np.int16),
                                  words[0].view(torch.int16).numpy())
    # JAX's encoder takes a numpy buffer, which ml_dtypes' bfloat16 does
    # not give; the port decodes its own frames to the same bits
    h, a = port_workers.decode_buffer(buf)
    back = port_workers.decode_state("b", h, a).carry["gru"][0]
    assert back.dtype == torch.bfloat16 and torch.equal(back, words[0])


@pytest.fixture(scope="module")
def flagship_dirs(tmp_path_factory):
    return export_both(tmp_path_factory.mktemp("router_flagship"),
                       FLAGSHIP_BUILDER, FLAGSHIP)


def test_ring_slot_bytes_equal_jax(flagship_dirs):
    port_dir, jax_dir = flagship_dirs
    port, ref = load_bundle(port_dir, device="cpu"), jax_load(jax_dir)
    assert port_workers.ring_slot_bytes(port) == \
        jax_workers.ring_slot_bytes(ref)
    assert port_workers.ring_slot_bytes(port) % 4096 == 0


def test_shm_ring_round_trip_and_full_ring():
    ctx = __import__("multiprocessing").get_context("spawn")
    ring = port_workers.ShmRing("%s-test-%d" % (port_workers.SHM_PREFIX,
                                                np.random.randint(1 << 30)),
                                2, 4096, ctx.Semaphore(0), ctx.Semaphore(0),
                                create=True)
    try:
        assert ring.get(timeout=0.01) is None
        frames, nbytes = port_workers.encode_frames(
            {"id": 1}, [np.arange(4, dtype=np.int32)])
        ring.put_frames(frames, nbytes)
        ring.put_frames(frames, nbytes)
        with pytest.raises(TimeoutError, match="ring full"):
            ring.put_frames(frames, nbytes, timeout=0.2)
        header, arrays = port_workers.decode_buffer(ring.get())
        assert header == {"id": 1}
        np.testing.assert_array_equal(arrays[0], np.arange(4))
        with pytest.raises(ValueError, match="exceeds the ring slot"):
            ring.put_frames(*port_workers.encode_frames(
                {}, [np.zeros(4096, np.uint8)]))
    finally:
        ring.close()
        ring.unlink()


# -- the HBM estimate --------------------------------------------------------

MODELS = {"mlp": (MLP_BUILDER, MLP, None),
          "flagship": (FLAGSHIP_BUILDER, FLAGSHIP, SEQ_LEN),
          "tagger": (GRU_BUILDER, TAGGER, 32)}


@pytest.mark.parametrize("exact", [True, False], ids=["payload", "specs"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_estimate_hbm_bytes_equals_jax(model, exact):
    from paddle_tpu.analyze import topology_check as jax_tc
    from paddle_tpu.optimizer import Momentum as JaxMomentum
    from paddle_tpu.topology import Topology as JaxTopology

    from paddle_tpu_torch.optimizer import Momentum

    builder, kwargs, seq = MODELS[model]
    topology = port_topology(builder, **kwargs)
    arrays = numpy_params(topology.param_specs(), 3)
    jtopology = JaxTopology(jax_model(builder, **kwargs))
    pads = {} if seq is None else {"word": seq}
    params = port_parameters(topology, arrays) if exact else None
    jparams = jax_parameters(jax_model(builder, **kwargs), arrays) \
        if exact else None
    for kw, jkw in (
            (dict(rows=4, seq_pad=pads, mode="infer"),
             dict(rows=4, seq_pad=pads, mode="infer")),
            (dict(rows=4, seq_pad=pads, optimizer=Momentum(momentum=0.9),
                  steps=3),
             dict(rows=4, seq_pad=pads, optimizer=JaxMomentum(momentum=0.9),
                  steps=3)),
            ({}, {})):
        got = port_tc.estimate_hbm_bytes(topology, parameters=params, **kw)
        want = jax_tc.estimate_hbm_bytes(jtopology, parameters=jparams,
                                         **jkw)
        assert got == want, (kw, got, want)


def test_manifest_hbm_estimate_and_budget(flagship_dirs, monkeypatch):
    from paddle_tpu.analyze import topology_check as jax_tc

    port_dir, jax_dir = flagship_dirs
    port, ref = load_bundle(port_dir, device="cpu"), jax_load(jax_dir)
    est = port.manifest["hbm_estimate_bytes"]
    assert est == ref.manifest["hbm_estimate_bytes"] > 0
    for raw in ("", "12345", "16G", "2.5MB", "7k", "junk"):
        assert port_tc.hbm_budget_bytes(raw) == jax_tc.hbm_budget_bytes(raw)
    for n in (0, 1023, 4096, 5 << 20, 3 << 30):
        assert port_tc._fmt_bytes(n) == jax_tc._fmt_bytes(n)
    monkeypatch.setenv(port_tc.BUDGET_ENV, "4K")
    assert port_tc.hbm_budget_bytes() == 4096


def test_replicas_that_fit_and_auto_match_jax(flagship_dirs, monkeypatch):
    from paddle_tpu.serve import fleet as jax_fleet

    port_dir, jax_dir = flagship_dirs
    port, ref = load_bundle(port_dir, device="cpu"), jax_load(jax_dir)
    est = port.manifest["hbm_estimate_bytes"]
    env = (port_tc.BUDGET_ENV, "PADDLE_TPU_HBM_BUDGET")

    def both(value):
        for name in env:
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, str(value))

    both(None)
    assert port_fleet.replicas_that_fit(port) is None
    assert port_fleet.auto_replicas(port) == 1  # the bundle's own device
    assert port_fleet.auto_replicas(port, devices=["cpu"] * 2) == \
        jax_fleet.auto_replicas(ref, devices=[None, None]) == 2
    # worker processes (stack=True) size as JAX's fleets; engine threads
    # place at most one replica per device
    for budget in (est * 5, est - 1, est * 3):
        assert port_fleet.replicas_that_fit(port, budget) == \
            jax_fleet.replicas_that_fit(ref, budget)
        jax_auto = jax_fleet.auto_replicas(ref, devices=[None],
                                           budget=budget)
        assert port_fleet.auto_replicas(port, devices=["cpu"],
                                        budget=budget, stack=True) == \
            jax_auto
        for n_dev in (1, 2, 8):
            assert port_fleet.auto_replicas(
                port, devices=["cpu"] * n_dev, budget=budget) == \
                min(jax_auto, n_dev)
    for budget in (est * 5, est - 1, est * 10 ** 6):
        both(budget)
        assert port_fleet.replicas_that_fit(port) == \
            jax_fleet.replicas_that_fit(ref)
        assert port_fleet.auto_replicas(port, devices=["cpu"],
                                        stack=True) == \
            jax_fleet.auto_replicas(ref, devices=[None])
    assert port_fleet.auto_replicas(port, devices=["cpu"], stack=True) == \
        port_fleet._AUTO_REPLICA_CAP == jax_fleet._AUTO_REPLICA_CAP
    assert port_fleet.auto_replicas(port, devices=["cpu"]) == 1
    both(est * 2)
    # without devices: one copy per replica (worker processes), as JAX's
    assert port_fleet.fleet_hbm_check(port, 2) == (est * 2, None)
    total, note = port_fleet.fleet_hbm_check(port, 3)
    jtotal, jnote = jax_fleet.fleet_hbm_check(ref, 3)
    assert total == jtotal == est * 3
    assert port_tc.BUDGET_ENV in note and jnote is not None

    class _Legacy:
        manifest = {}

    assert port_fleet.replicas_that_fit(_Legacy(), est) is None
    assert port_fleet.fleet_hbm_check(_Legacy(), 2) == (None, None)


def test_fleet_hbm_check_counts_one_copy_per_device(flagship_dirs,
                                                   monkeypatch):
    """Engine threads of one process share one placement per device: the
    gate counts the distinct devices the replicas land on, not the
    replicas, and a fleet under a budget of one copy warns of nothing."""
    port_dir, _ = flagship_dirs
    port = load_bundle(port_dir, device="cpu")
    est = port.manifest["hbm_estimate_bytes"]
    monkeypatch.setenv(port_tc.BUDGET_ENV, str(est * 2))
    check = port_fleet.fleet_hbm_check
    assert check(port, 4, devices=["cpu"]) == (est, None)
    assert check(port, 4, devices=["cuda:0", "cuda:1"]) == (est * 2, None)
    assert check(port, 1, devices=["cuda:0", "cuda:1", "cuda:2"]) == \
        (est, None)
    total, note = check(port, 3, devices=["cuda:0", "cuda:1", "cuda:2"])
    assert total == est * 3 and "3 parameter copies" in note
    fleet = port_fleet.ReplicaSet(port, replicas=3, devices=["cpu"],
                                  warmup=False)
    try:
        assert (fleet.hbm_estimate_bytes, fleet.hbm_note) == (est, None)
    finally:
        fleet.stop()


# -- the router --------------------------------------------------------------

@pytest.fixture(scope="module")
def mlp_dirs(tmp_path_factory):
    return export_both(tmp_path_factory.mktemp("router_mlp"), MLP_BUILDER,
                       MLP)


def _shed_sequence(pkg_router, engine_cls, overloaded, bundles, reg, slog,
                   gate):
    """JAX's two-model scenario on one package: high floods while its
    engine is held still, then low submits. Returns the admissions and
    shed reasons in order, and the high futures."""
    high, low = bundles
    router = pkg_router(metrics_registry=reg, steplog=slog,
                        shed_capacity={"high": None, "low": 8})
    router.add_model("high", high, engine_cls(
        high, max_batch_size=4, max_latency_ms=1.0, warmup=False,
        metrics_registry=reg, model="high"), priority="high")
    router.add_model("low", low, engine_cls(
        low, max_batch_size=4, max_latency_ms=1.0, warmup=False,
        metrics_registry=reg, model="low"), priority="low")
    x = mlp_request(1)
    events, futures = [], []
    for _ in range(24):
        futures.append(router.submit("high", dict(x)))
        events.append(("high", "admitted"))
    queued = router.total_queued()
    for _ in range(6):
        try:
            futures.append(router.submit("low", dict(x)))
            events.append(("low", "admitted"))
        except overloaded as exc:
            events.append(("low", exc.reason, exc.priority))
    gate.set()
    for f in futures:
        f.result(timeout=120)
    router.stop()
    return events, queued


def _gated(bundle, gate):
    real = bundle.run

    def run(flat, batch):
        gate.wait(timeout=120)
        return real(flat, batch)

    bundle.run = run


def test_priority_shed_order_two_models_equals_jax(mlp_dirs, tmp_path):
    from paddle_tpu.serve import InferenceEngine as JaxEngine
    from paddle_tpu.serve import Overloaded as JaxOverloaded
    from paddle_tpu.serve import Router as JaxRouter

    port_dir, jax_dir = mlp_dirs
    runs = {}
    for name, router_cls, engine_cls, overloaded, loader, slog_mod, reg in (
            ("port", Router, InferenceEngine, Overloaded,
             lambda d: load_bundle(d, device="cpu"), steplog,
             MetricsRegistry()),
            ("jax", JaxRouter, JaxEngine, JaxOverloaded, jax_load,
             jax_steplog, JaxRegistry())):
        directory = port_dir if name == "port" else jax_dir
        high, low = loader(directory), loader(directory)
        gate = threading.Event()
        _gated(high, gate)
        slog = slog_mod.StepLog(str(tmp_path / name), run_name="shed",
                                compile_events=False)
        try:
            events, queued = _shed_sequence(
                router_cls, engine_cls, overloaded, (high, low), reg, slog,
                gate)
        finally:
            gate.set()
            slog.close()
        sheds = [(r["model"], r["priority"], r["reason"])
                 for r in slog_mod.read_jsonl(slog.path)
                 if r["type"] == "serve_shed"]
        runs[name] = (events, queued > 8, sheds, {
            k: v for k, v in reg.snapshot()["counters"].items()
            if k.startswith("paddle_tpu_serve_shed_total")})
    assert runs["port"] == runs["jax"]
    events, over, sheds, counters = runs["port"]
    assert over and events[-6:] == [("low", "pressure", "low")] * 6
    assert sheds == [("low", "low", "pressure")] * 6
    assert {k: v for k, v in counters.items() if v} == {
        'paddle_tpu_serve_shed_total{model="low",priority="low",'
        'reason="pressure"}': 6}


def test_unknown_model_and_priority_are_refused_as_in_jax(mlp_dirs):
    from paddle_tpu.serve import Router as JaxRouter

    port_dir, _ = mlp_dirs
    bundle = load_bundle(port_dir, device="cpu")
    reg = MetricsRegistry()
    errors = {}
    for name, router in (("port", Router(metrics_registry=reg)),
                         ("jax", JaxRouter(metrics_registry=JaxRegistry()))):
        engine = InferenceEngine(bundle, warmup=False, metrics_registry=reg)
        router.add_model("m", bundle, engine)
        got = []
        for call in (lambda: router.submit("nope", mlp_request(1)),
                     lambda: router.add_model("x", bundle, engine,
                                              priority="urgent"),
                     lambda: router.add_model("m", bundle, engine)):
            with pytest.raises((KeyError, ValueError)) as exc_info:
                call()
            got.append((type(exc_info.value).__name__,
                        str(exc_info.value)))
        assert router.default_model().name == "m"
        router.stop()
        errors[name] = got
    assert errors["port"] == errors["jax"]
    assert "unknown model 'nope'" in errors["port"][0][1]


def test_router_knobs_stats_and_default_model(mlp_dirs):
    from paddle_tpu_torch.control.knobs import KnobRegistry

    port_dir, _ = mlp_dirs
    bundle = load_bundle(port_dir, device="cpu")
    reg = MetricsRegistry()
    with Router(metrics_registry=reg) as router:
        for name, prio in (("a", "high"), ("b", "low")):
            router.add_model(name, bundle, InferenceEngine(
                bundle, warmup=True, metrics_registry=reg, model=name),
                priority=prio)
        with pytest.raises(KeyError, match="2 models hosted"):
            router.default_model()
        knobs = KnobRegistry()
        router.register_knobs(knobs)
        assert knobs.names() == ["router.shed_low", "router.shed_normal"]
        knobs.set("router.shed_low", 64)
        stats = router.stats()
        assert stats["shed_capacity"] == {"high": None, "normal": 1024,
                                          "low": 64}
        assert stats["priorities"] == {"a": "high", "b": "low"}
        assert router.ready() and router.live()
        np.testing.assert_array_equal(
            router.infer("a", mlp_request(2))["mlp_out"],
            bundle.infer(mlp_request(2))["mlp_out"])
