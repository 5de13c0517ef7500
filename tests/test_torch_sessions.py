"""The session tier of the port against the JAX package, on the CPU:
``SessionStore`` (the same victims, tombstones and stats as JAX's under one
seeded sequence of operations on a shared fake clock), and the
scheduler's parking, spill -> restore, pressure paging, close, eviction,
TTL, ``export_session`` / ``import_session`` across the packages, the
``serve_swap`` records with ``cli observe`` over them, and the HTTP flow
(the admin verbs: spill, close, and export / import as frames).

Sizes are tests/test_scheduler.py's (tagger hidden 12, 2 slots, window 4);
both packages export the same numpy parameters (tests/torch_decode.py).
Spills are forced with ``spill_session`` or an idle-spill threshold of 0,
and the waits poll with generous timeouts: nothing here asserts on
latency, overlap or rates. Spill -> restore is bitwise equal to a pinned
slot; answers against the JAX package agree within 1e-5 (float32 sums in
another order).
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu_torch import cli
from paddle_tpu_torch.observe.metrics import MetricsRegistry
from paddle_tpu_torch.serve import (ContinuousScheduler, SessionGone,
                                    SessionStore, serve_in_thread)
from paddle_tpu_torch.serve import sessions as port_sessions
from paddle_tpu_torch.serve import workers as port_workers
from tests.torch_decode import (load_pair, per_request, read_records,
                                schema_valid, sequences)

OUT = "gru_tag_out"
TOL = 1e-5


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return load_pair(tmp_path_factory.mktemp("session_pair"), "gru")


def _sched(bundle, **kw):
    kw.setdefault("metrics_registry", MetricsRegistry())
    return ContinuousScheduler(bundle, **kw)


def _seq(n, seed=0):
    return sequences([n], seed=seed)[0]


def _decode(sched, chunk, sid=None, **kw):
    return sched.submit({"word": chunk}, session_id=sid,
                        **kw).result(timeout=120)[OUT]


def _until(predicate, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.01)


# -- the store -----------------------------------------------------------------

class _Clock:
    """A monotonic clock the test moves by hand."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


def test_store_matches_jax_under_one_seeded_sequence(monkeypatch):
    from paddle_tpu.serve import sessions as jax_sessions

    clock = _Clock()
    monkeypatch.setattr(port_sessions, "time", clock)
    monkeypatch.setattr(jax_sessions, "time", clock)
    stores = [SessionStore(capacity=5, slo_grace_ms=400.0, ttl_ms=3000.0),
              jax_sessions.SessionStore(capacity=5, slo_grace_ms=400.0,
                                        ttl_ms=3000.0)]
    states = [port_sessions.SessionState, jax_sessions.SessionState]
    rng = np.random.RandomState(0)
    trace = [[], []]
    for _ in range(300):
        op = rng.choice(["put", "put", "pop", "touch", "expire"])
        sid = "s%d" % rng.randint(12)
        priority = rng.choice(["low", "normal", "high", "bogus"])
        clock.now += float(rng.exponential(0.2))
        for i, store in enumerate(stores):
            if op == "put":
                carry = {"gru": [np.full((4,), i, np.float32)]}
                got = [s.session_id for s in store.put(
                    states[i](sid, carry, 3, priority))]
            elif op == "pop":
                try:
                    got = store.pop(sid).session_id
                except (SessionGone, jax_sessions.SessionGone) as exc:
                    got = ("gone", exc.reason)
                except KeyError:
                    got = "unknown"
            elif op == "touch":
                store.touch(sid)
                got = None
            else:
                got = [s.session_id for s in store.expire()]
            trace[i].append((op, sid, got, store.stats(),
                             store.gone_reason(sid)))
    assert trace[0] == trace[1]
    assert any(t[0] == "put" and t[2] for t in trace[0])      # evictions
    assert any(t[0] == "expire" and t[2] for t in trace[0])   # TTL
    assert any(t[2] == ("gone", "capacity") for t in trace[0])


def test_session_state_matches_jax():
    from paddle_tpu.serve import sessions as jax_sessions

    carry = {"a": [np.zeros((12,), np.float32)],
             "b": [np.zeros((3,), np.float32), np.zeros((3,), np.float32)]}
    for priority in ("low", "high", "weird", None):
        got = port_sessions.SessionState("x", carry, 7, priority)
        want = jax_sessions.SessionState("x", carry, 7, priority)
        assert (got.nbytes, got.priority, got.pos) == (
            want.nbytes, want.priority, want.pos)
        assert got.nbytes == 72 and got.pos == 7
    with pytest.raises(ValueError, match="capacity must be >= 1"):
        SessionStore(capacity=0)


# -- paging through the scheduler ----------------------------------------------

def test_session_continuation_matches_whole_sequence(pair):
    port, ref = pair
    seq = _seq(15, seed=3)
    with _sched(port) as s:
        whole = _decode(s, seq)
        parts = [_decode(s, seq[:4], sid="u"),
                 _decode(s, seq[4:9], sid="u"),
                 _decode(s, seq[9:], sid="u", end_session=True)]
        stats = s.stats()
    got = np.concatenate(parts, axis=0)
    assert np.array_equal(got, whole)
    np.testing.assert_allclose(got, per_request(ref, seq, OUT), rtol=TOL,
                               atol=TOL)
    assert stats["sessions_closed"] == 1 and stats["spills"] == 0


def test_spill_restore_bitwise_equal_pinned(pair):
    port, _ = pair
    seq = _seq(18, seed=7)
    with _sched(port) as s:
        whole = _decode(s, seq)
        pinned = [_decode(s, seq[:9], sid="pin"),
                  _decode(s, seq[9:], sid="pin")]
        a = _decode(s, seq[:9], sid="swap")
        s.spill_session("swap")
        assert s.stats()["suspended_sessions"] >= 1
        assert s.has_session("swap")
        b = _decode(s, seq[9:], sid="swap")
        stats = s.stats()
    assert np.array_equal(np.concatenate(pinned), whole)
    assert np.array_equal(np.concatenate([a, b]), whole)
    assert stats["spills"] >= 1 and stats["restores"] >= 1


def test_pressure_paging_sessions_exceed_slots(pair):
    port, _ = pair
    seqs = {"s%d" % i: _seq(10, seed=20 + i) for i in range(6)}
    with _sched(port) as s:
        outs = {k: [] for k in seqs}
        for lo, hi in ((0, 5), (5, 10)):
            futs = {k: s.submit({"word": q[lo:hi]}, session_id=k)
                    for k, q in seqs.items()}
            for k, f in futs.items():
                outs[k].append(f.result(timeout=120)[OUT])
        stats = s.stats()
        assert stats["spills"] > 0 and stats["restores"] > 0
        assert stats["resident_sessions"] + stats["suspended_sessions"] == 6
        for k, q in seqs.items():
            assert np.array_equal(np.concatenate(outs[k]), _decode(s, q)), k


def test_idle_spill_threshold_zero_pages_every_parked_session(pair):
    port, _ = pair
    seq = _seq(12, seed=5)
    with _sched(port, idle_spill_ms=0.0) as s:
        whole = _decode(s, seq)
        a = _decode(s, seq[:6], sid="idle")
        _until(lambda: s.stats()["suspended_sessions"] == 1)
        b = _decode(s, seq[6:], sid="idle")
        stats = s.stats()
    assert np.array_equal(np.concatenate([a, b]), whole)
    assert stats["spills"] >= 1 and stats["restores"] == 1


def test_victim_session_own_request_restores(pair):
    port, _ = pair
    seq = _seq(16, seed=31)
    with _sched(port) as s:
        whole = _decode(s, seq)
        a = _decode(s, seq[:8], sid="x")
        long_fut = s.submit({"word": _seq(30, seed=32)})
        t_fut = s.submit({"word": _seq(1, seed=33)})  # claims X's slot
        x_fut = s.submit({"word": seq[8:]}, session_id="x")
        b = x_fut.result(timeout=120)[OUT]
        t_fut.result(timeout=120)
        long_fut.result(timeout=120)
        stats = s.stats()
    assert np.array_equal(np.concatenate([a, b]), whole)
    assert stats["restores"] >= 1


def test_close_session_frees_parked_slot_and_store_entry(pair):
    port, _ = pair
    with _sched(port, paging=False) as s:
        _decode(s, _seq(4, seed=1), sid="a")
        _decode(s, _seq(4, seed=2), sid="b")
        assert s.stats()["resident_sessions"] == 2
        s.close_session("a")
        assert s.stats()["resident_sessions"] == 1
        _decode(s, _seq(4, seed=3), sid="c")
    with _sched(port) as s:
        first = _decode(s, _seq(4, seed=4), sid="d")
        s.spill_session("d")
        assert s.stats()["suspended_sessions"] == 1
        s.close_session("d")
        assert s.stats()["suspended_sessions"] == 0
        assert not s.has_session("d")
        # closed is not evicted: the id starts a fresh session
        assert np.array_equal(_decode(s, _seq(4, seed=4), sid="d"), first)


def test_close_session_discards_inflight_spill(pair):
    port, _ = pair
    with _sched(port) as s:
        first = _decode(s, _seq(6, seed=41), sid="reuse")
        with s._cv:
            s._spill_asap.add("reuse")
            s._cv.notify_all()
        s.close_session("reuse")

        def settled():
            with s._cv:
                pending = "reuse" in s._pending_spills
            return not pending and "reuse" not in s._store

        _until(settled)
        again = _decode(s, _seq(6, seed=41), sid="reuse")
    np.testing.assert_array_equal(first, again)


def test_session_gone_after_capacity_eviction(pair):
    port, _ = pair
    with _sched(port, session_capacity=1) as s:
        _decode(s, _seq(4, seed=1), sid="a")
        _decode(s, _seq(4, seed=2), sid="b")
        s.spill_session("a")
        s.spill_session("b")  # capacity 1: evicts a (tombstoned)
        assert s.stats()["evictions"] == 1
        with pytest.raises(SessionGone) as exc_info:
            s.submit({"word": _seq(4, seed=3)}, session_id="a")
        assert (exc_info.value.session_id, exc_info.value.reason) == (
            "a", "capacity")
        with pytest.raises(SessionGone):
            s.spill_session("a")
        with pytest.raises(KeyError):
            s.spill_session("never-seen")
        _decode(s, _seq(4, seed=4), sid="brand-new")


def test_session_ttl_enforced_on_wake(pair):
    port, _ = pair
    with _sched(port, session_ttl_ms=50.0) as s:
        _decode(s, _seq(4, seed=1), sid="old")
        s.spill_session("old")
        time.sleep(0.3)  # idle past the TTL (a lower bound, never a cap)
        with pytest.raises(SessionGone) as exc_info:
            s.infer({"word": _seq(4, seed=2)}, session_id="old", timeout=60)
        assert exc_info.value.reason == "ttl"
        assert s.stats()["evictions"] == 1


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_exported_session_imports_into_the_other_package(pair, direction):
    from paddle_tpu.observe.metrics import MetricsRegistry as JaxRegistry
    from paddle_tpu.serve import ContinuousScheduler as JaxScheduler

    port, ref = pair
    seq = _seq(14, seed=61)
    jax_sched = JaxScheduler(ref, metrics_registry=JaxRegistry())
    port_sched = _sched(port)
    src, dst = ((jax_sched, port_sched) if direction == "jax_to_port"
                else (port_sched, jax_sched))
    try:
        head = np.asarray(src.infer({"word": seq[:6]}, session_id="m",
                                    timeout=120)[OUT])
        state = src.export_session("m")
        assert not src.has_session("m")
        assert state.pos == 6 and state.nbytes == 12 * 4
        dst.import_session("m", state)
        tail = np.asarray(dst.infer({"word": seq[6:]}, session_id="m",
                                    timeout=120)[OUT])
    finally:
        jax_sched.stop()
        port_sched.stop()
    np.testing.assert_allclose(np.concatenate([head, tail]),
                               per_request(ref, seq, OUT), rtol=TOL,
                               atol=TOL)


def test_serve_swap_records_and_cli_observe(pair, tmp_path, capsys):
    from paddle_tpu_torch.observe import steplog

    port, _ = pair
    slog = steplog.StepLog(str(tmp_path), run_name="swap")
    with _sched(port, steplog=slog, model="tagger",
                session_capacity=1) as s:
        _decode(s, _seq(5, seed=1), sid="a")
        s.spill_session("a")
        _decode(s, _seq(5, seed=2), sid="b")
        s.spill_session("b")  # evicts a
        _decode(s, _seq(5, seed=3), sid="b")  # restores b
        s.import_session("c", s.export_session("b"))
        stats = s.stats()
    slog.close()
    records = read_records(slog.path)
    schema_valid(records)
    swaps = [r for r in records if r["type"] == "serve_swap"]
    ops = [r["op"] for r in swaps]
    assert ops.count("spill") == stats["spills"] == 3
    assert ops.count("restore") == stats["restores"] == 1
    assert ops.count("evict") == stats["evictions"] == 1
    assert ops.count("export") == ops.count("import") == 1
    evict = next(r for r in swaps if r["op"] == "evict")
    assert evict["session"] == "a" and evict["reason"] == "capacity"
    spill = next(r for r in swaps if r["op"] == "spill")
    assert spill["bytes"] == 48 and "overlap_ms" in spill
    assert all(r["model"] == "tagger" for r in swaps)
    assert all("resident" in r and "suspended" in r for r in records
               if r["type"] == "serve_decode")
    # cli observe summarizes the directory the port's scheduler wrote
    assert cli.main(["observe", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    assert "session swaps: spills 3 restores 1 evictions 1" in text


def test_session_metric_families(pair):
    port, _ = pair
    reg = MetricsRegistry()
    with _sched(port, metrics_registry=reg, model="tagger") as s:
        _decode(s, _seq(5, seed=1), sid="a")
        s.spill_session("a")
        _decode(s, _seq(5, seed=2), sid="a")
    text = reg.to_prometheus()
    assert 'paddle_tpu_serve_session_spills_total{model="tagger"} 1' in text
    assert ('paddle_tpu_serve_session_restores_total{model="tagger"} 1'
            in text)
    assert 'paddle_tpu_serve_session_swap_ms_count{model="tagger"}' in text
    assert 'paddle_tpu_serve_session_resident{model="tagger"}' in text


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return json.load(urllib.request.urlopen(req, timeout=60))


def test_http_session_flow_close_and_410(pair):
    port, _ = pair
    seq = _seq(12, seed=17)
    with _sched(port, session_capacity=1) as engine:
        server, thread = serve_in_thread(port, engine)
        base = "http://%s:%d" % server.server_address
        try:
            whole = _post(base, "/infer", {"inputs": {"word": seq.tolist()}})
            chunks = []
            for lo, hi in ((0, 4), (4, 8), (8, 12)):
                r = _post(base, "/infer", {"inputs": {
                    "word": seq[lo:hi].tolist()}, "session_id": "web"})
                assert r["session_id"] == "web"
                chunks += r["outputs"][OUT]
            np.testing.assert_array_equal(np.asarray(chunks),
                                          np.asarray(whole["outputs"][OUT]))
            closed = _post(base, "/admin/session/close",
                           {"session_id": "web"})
            assert closed == {"ok": True, "session_id": "web"}
            assert not engine.has_session("web")
            # evict "web2": page it out, then page "web3" in (capacity 1)
            _post(base, "/infer", {"inputs": {"word": seq[:3].tolist()},
                                   "session_id": "web2"})
            assert _post(base, "/admin/session/spill",
                         {"session_id": "web2"})["ok"]
            _post(base, "/infer", {"inputs": {"word": seq[:3].tolist()},
                                   "session_id": "web3"})
            _post(base, "/admin/session/spill", {"session_id": "web3"})
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                _post(base, "/infer", {"inputs": {"word": seq[:3].tolist()},
                                       "session_id": "web2"})
            assert exc_info.value.code == 410
            payload = json.load(exc_info.value)
            assert (payload["session_id"], payload["reason"]) == (
                "web2", "capacity")
            # export answers the state as frames (serve/workers.py's
            # codec) and removes it; import adopts the frames, and the
            # session continues where it stopped
            req = urllib.request.Request(
                base + "/admin/session/export",
                data=json.dumps({"session_id": "web3"}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as fh:
                assert (fh.headers["Content-Type"]
                        == "application/x-paddle-frames")
                frames = fh.read()
            assert not engine.has_session("web3")
            header, _arrays = port_workers.decode_buffer(frames)
            assert header["session_id"] == "web3"
            assert header["state"]["pos"] == 3
            req = urllib.request.Request(
                base + "/admin/session/import", data=frames,
                headers={"Content-Type": "application/x-paddle-frames"})
            assert json.load(urllib.request.urlopen(req, timeout=60)) == {
                "ok": True, "session_id": "web3", "nbytes": 48}
            tail = _post(base, "/infer", {"inputs": {
                "word": seq[3:6].tolist()}, "session_id": "web3"})
            whole6 = _post(base, "/infer", {"inputs": {
                "word": seq[:6].tolist()}})
            np.testing.assert_array_equal(
                np.asarray(tail["outputs"][OUT]),
                np.asarray(whole6["outputs"][OUT])[3:])
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)


def test_http_session_request_to_a_batch_engine_is_refused(pair):
    from paddle_tpu_torch.serve import InferenceEngine

    port, _ = pair
    engine = InferenceEngine(port, warmup=False)
    server, thread = serve_in_thread(port, engine)
    base = "http://%s:%d" % server.server_address
    ids = np.zeros((1, port.seq_len), np.int32)
    try:
        for path, body, match in (
                ("/infer", {"inputs": {"word": ids.tolist(),
                                       "word:lens": [3]},
                            "session_id": "s"}, "does not hold sessions"),
                ("/admin/session/close", {"session_id": "s"},
                 "no session admin surface")):
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                _post(base, path, body)
            assert exc_info.value.code == 400
            assert match in json.load(exc_info.value)["error"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        engine.stop()
