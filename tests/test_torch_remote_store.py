"""The remote session store of the port on the CPU (serve/remote_store.py):

* two ``ContinuousScheduler``s paging to one ``StoreServer`` thread: a
  session spilled on A resumes on B bit for bit against the uninterrupted
  run; a tombstone raised on A answers ``SessionGone`` on B;
* the port's ``RemoteSessionStore`` against the JAX package's
  ``StoreServer`` (and JAX's client against the port's server): put, pop,
  tombstone and ``gone_reason`` round-trip, carries bit for bit;
* a bfloat16 carry through the store;
* ``python -m paddle_tpu_torch.serve.remote_store`` as its own process,
  and two ``cli serve --continuous --session-store-addr`` processes: the
  session spilled by the first, which is then killed, resumes on the
  second bit for bit.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.serve import remote_store as jax_remote
from paddle_tpu.serve.sessions import SessionGone as JaxGone
from paddle_tpu.serve.sessions import SessionState as JaxState

from paddle_tpu_torch.observe.metrics import MetricsRegistry
from paddle_tpu_torch.serve import ContinuousScheduler, load_bundle
from paddle_tpu_torch.serve.remote_store import (EvictedStub,
                                                 RemoteSessionStore,
                                                 spawn_store_in_thread)
from paddle_tpu_torch.serve.sessions import SessionGone, SessionState
from tests.torch_decode import GRU_BUILDER
from tests.torch_fleet import TAGGER, TAGGER_OUT, export_both, tagger_sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tagger_dir(tmp_path_factory):
    return export_both(tmp_path_factory.mktemp("store_tagger"), GRU_BUILDER,
                       TAGGER, decode=True)[0]


@pytest.fixture
def store():
    server = spawn_store_in_thread(capacity=8)
    try:
        yield server
    finally:
        server.stop()


def _sched(bundle, address):
    return ContinuousScheduler(bundle, metrics_registry=MetricsRegistry(),
                               session_store=RemoteSessionStore(address))


def test_session_spilled_on_a_resumes_on_b(tagger_dir, store):
    bundle = load_bundle(tagger_dir, device="cpu")
    seq = tagger_sequence(16, seed=3)
    with ContinuousScheduler(bundle,
                             metrics_registry=MetricsRegistry()) as one:
        want = [one.infer({"word": seq[a:b]}, session_id="u")[TAGGER_OUT]
                for a, b in ((0, 5), (5, 10), (10, 16))]
    a, b = _sched(bundle, store.address), _sched(bundle, store.address)
    try:
        got = [a.infer({"word": seq[0:5]}, session_id="u")[TAGGER_OUT],
               a.infer({"word": seq[5:10]}, session_id="u")[TAGGER_OUT]]
        a.spill_session("u")
        assert "u" in store.store and b.has_session("u")  # the shared store
        got.append(b.infer({"word": seq[10:16]},
                           session_id="u")[TAGGER_OUT])
        assert b.stats()["restores"] == 1
        assert "u" not in store.store
    finally:
        a.stop()
        b.stop()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_tombstone_on_a_answers_gone_on_b(tagger_dir, store):
    bundle = load_bundle(tagger_dir, device="cpu")
    a, b = _sched(bundle, store.address), _sched(bundle, store.address)
    try:
        a.infer({"word": tagger_sequence(4, seed=1)}, session_id="t")
        a.spill_session("t")
        admin = RemoteSessionStore(store.address)
        admin.tombstone("t", "capacity")
        admin.close()
        with pytest.raises(SessionGone) as exc_info:
            b.infer({"word": tagger_sequence(3, seed=2)}, session_id="t")
        assert (exc_info.value.session_id, exc_info.value.reason) == (
            "t", "capacity")
        assert store.store.stats()["tombstones"] == 1
    finally:
        a.stop()
        b.stop()


def _carry(rng):
    return {"l0": [rng.randn(12).astype(np.float32)],
            "l1": [rng.randn(32).astype(np.float32),
                   rng.randn(32).astype(np.float32)]}


@pytest.mark.parametrize("pair", ["port_client_jax_server",
                                  "jax_client_port_server"])
def test_client_and_server_cross_the_packages(pair):
    rng = np.random.RandomState(8)
    if pair == "port_client_jax_server":
        server = jax_remote.spawn_store_in_thread(capacity=2)
        client, state_cls, gone = (RemoteSessionStore(server.address),
                                   SessionState, SessionGone)
    else:
        server = spawn_store_in_thread(capacity=2)
        client, state_cls, gone = (jax_remote.RemoteSessionStore(
            server.address), JaxState, JaxGone)
    try:
        carries = {sid: _carry(rng) for sid in ("a", "b", "c")}
        for i, sid in enumerate(("a", "b")):
            assert client.put(state_cls(sid, carries[sid], pos=3 + i,
                                        priority="low")) == []
        assert len(client) == 2 and "a" in client and "z" not in client
        evicted = client.put(state_cls("c", carries["c"], pos=9))
        assert [(e.session_id, e.nbytes, e.pos, e.priority)
                for e in evicted] == [("a", 76 * 4, 3, "low")]
        assert client.gone_reason("a") == "capacity"
        with pytest.raises(gone) as exc_info:
            client.pop("a")
        assert exc_info.value.reason == "capacity"
        state = client.pop("b")
        assert (state.session_id, state.pos, state.priority) == ("b", 4,
                                                                 "low")
        for layer, leaves in carries["b"].items():
            for want, got in zip(leaves, state.carry[layer]):
                np.testing.assert_array_equal(np.asarray(got), want)
        with pytest.raises(KeyError):
            client.pop("b")
        client.tombstone("c", "ttl")
        assert client.gone_reason("c") == "ttl"
        assert client.gone_reason("never") is None
        client.touch("nobody")
        assert client.expire() == [] and client.ping()
        assert client.stats()["capacity"] == 2
    finally:
        client.close()
        server.stop()


def test_bfloat16_carry_through_the_store(store):
    client = RemoteSessionStore(store.address)
    leaf = torch.randn(16).to(torch.bfloat16)
    try:
        client.put(SessionState("h", {"gru": [leaf]}, pos=2))
        back = client.pop("h").carry["gru"][0]
        assert back.dtype == torch.bfloat16 and torch.equal(back, leaf)
        stub = EvictedStub("x", 8, 1, "high")
        assert (stub.session_id, stub.nbytes) == ("x", 8)
        with pytest.raises(ValueError, match="HOST:PORT"):
            RemoteSessionStore("nohostport")
    finally:
        client.close()


def _read_until(proc, marker):
    lines = []
    while not lines or marker not in lines[-1]:
        line = proc.stdout.readline()
        assert line, "".join(lines)  # the process exited
        lines.append(line)
    return lines[-1]


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return json.load(urllib.request.urlopen(req, timeout=120))


def test_cli_processes_share_the_store_process(tagger_dir):
    """The store as its own process; host A serves chunks 1-2, spills,
    and is killed; host B serves chunks 3-4: every chunk equals the
    uninterrupted run bit for bit."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    bundle = load_bundle(tagger_dir, device="cpu")
    seq = tagger_sequence(20, seed=5)
    cuts = [(0, 5), (5, 10), (10, 15), (15, 20)]
    with ContinuousScheduler(bundle,
                             metrics_registry=MetricsRegistry()) as one:
        want = [one.infer({"word": seq[a:b]}, session_id="u")[TAGGER_OUT]
                for a, b in cuts]
    procs = []

    def start(argv):
        proc = subprocess.Popen([sys.executable, "-m", *argv],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                env=env, cwd=ROOT)
        procs.append(proc)
        return proc

    try:
        store = start(["paddle_tpu_torch.serve.remote_store",
                       "--capacity", "16"])
        address = _read_until(store, "listening").split()[-1]
        hosts = []
        for _ in range(2):
            host = start(["paddle_tpu_torch.cli", "serve", tagger_dir,
                          "--continuous", "--device", "cpu", "--port", "0",
                          "--session-store-addr", address])
            banner = _read_until(host, "http://")
            hosts.append("http://" + banner.split("http://", 1)[1]
                         .split(" ", 1)[0])
        got = []
        for i, (a, b) in enumerate(cuts):
            base = hosts[0] if i < 2 else hosts[1]
            resp = _post(base + "/infer", {"inputs": {
                "word": seq[a:b].tolist()}, "session_id": "u"})
            got.append(np.asarray(resp["outputs"][TAGGER_OUT], np.float32))
            if i == 1:
                assert _post(hosts[0] + "/admin/session/spill",
                             {"session_id": "u"})["ok"]
                procs[1].send_signal(signal.SIGKILL)
                procs[1].wait(timeout=60)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            proc.stdout.close()
    assert procs[2].returncode == 0  # host B drained on SIGTERM
