"""The serving cluster front of the port on the CPU (serve/cluster.py, ``cli
serve --front / --join``), against the JAX package's tests/test_cluster.py:

* the GRU tagger's small decode bundle (dict 50, labels 5, emb 8, hidden
  12, seq 32, 2 slots, window 4) exported by both packages from the same
  numpy parameters (tests/torch_decode.py ``export_pair``);
* a front over two in-thread hosts sharing one store: three chunks of a
  session, the home host killed after chunk 2, the third chunk re-homed
  onto the survivor; every answer equals the port's whole-sequence decode
  bit for bit and the JAX package's within 1e-5;
* an empty ring sheds ``no_host``; a host joined through the port's
  coordinator is found and routed to, and leaves once its lease lapses;
* the wire: the JAX package's front routes to the port's hosts and the
  port's front to the JAX package's, with the same answers;
* two ``cli serve --join`` processes behind ``cli serve --front``, the
  home killed -9 (``slow``, as the JAX package's twin is).
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

from paddle_tpu_torch.observe.metrics import MetricsRegistry
from paddle_tpu_torch.serve import ContinuousScheduler, Overloaded, load_bundle
from paddle_tpu_torch.serve.cluster import ClusterFront
from paddle_tpu_torch.serve.remote_store import spawn_store_in_thread
from tests.torch_decode import GRU_BUILDER, SMALL, export_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = "gru_tag_out"
TOL = 1e-5


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """(port bundle dir, JAX bundle dir) of the small tagger."""
    _, port_dir, _, jax_dir = export_pair(
        tmp_path_factory.mktemp("cluster_tagger"), GRU_BUILDER, SMALL)
    return port_dir, jax_dir


@pytest.fixture(scope="module")
def bundle(dirs):
    return load_bundle(dirs[0], device="cpu")


def _seq(n, seed=0, vocab=50):
    return (np.random.RandomState(seed)
            .randint(0, vocab, size=(n,)).astype(np.int32))


def _whole(bundle, seq):
    with ContinuousScheduler(bundle,
                             metrics_registry=MetricsRegistry()) as one:
        return one.submit({"word": seq}).result(timeout=120)[OUT]


def _jax_whole(jax_dir, seq):
    from paddle_tpu.observe.metrics import MetricsRegistry as JaxRegistry
    from paddle_tpu.serve import ContinuousScheduler as JaxScheduler
    from paddle_tpu.serve import load_bundle as jax_load

    ref = JaxScheduler(jax_load(jax_dir), warmup=True,
                       metrics_registry=JaxRegistry())
    try:
        return np.asarray(ref.submit({"word": seq}).result(
            timeout=120)[OUT])
    finally:
        ref.stop()


def _spawn_host(bundle, store_addr):
    """One in-thread host of the port paging to the shared store:
    (scheduler, http server, dial address)."""
    from paddle_tpu_torch.serve import server as serve_server
    from paddle_tpu_torch.serve.remote_store import RemoteSessionStore

    sched = ContinuousScheduler(
        bundle, metrics_registry=MetricsRegistry(),
        session_store=RemoteSessionStore(store_addr))
    srv, _ = serve_server.serve_in_thread(bundle, sched)
    return sched, srv, "127.0.0.1:%d" % srv.server_address[1]


def _spawn_jax_host(jax_dir, store_addr):
    from paddle_tpu.observe.metrics import MetricsRegistry as JaxRegistry
    from paddle_tpu.serve import ContinuousScheduler as JaxScheduler
    from paddle_tpu.serve import load_bundle as jax_load
    from paddle_tpu.serve import server as jax_server
    from paddle_tpu.serve.remote_store import RemoteSessionStore as JaxStore

    bundle = jax_load(jax_dir)
    sched = JaxScheduler(bundle, warmup=True,
                         metrics_registry=JaxRegistry(),
                         session_store=JaxStore(store_addr))
    srv, _ = jax_server.serve_in_thread(bundle, sched)
    return sched, srv, "127.0.0.1:%d" % srv.server_address[1]


def _kill_host(sched, srv):
    """The in-thread stand-in for SIGKILL: stop answering and close the
    listening socket, so the next dial is refused at once."""
    srv.shutdown()
    srv.server_close()
    sched.stop()


def test_front_session_rehomes_bitwise_on_host_death(bundle, dirs):
    seq = _seq(12, seed=7)
    whole = _whole(bundle, seq)
    np.testing.assert_allclose(whole, _jax_whole(dirs[1], seq), rtol=TOL,
                               atol=TOL)
    store = spawn_store_in_thread(capacity=16)
    hosts = {}
    try:
        for hid in ("h0", "h1"):
            hosts[hid] = _spawn_host(bundle, store.address)
        front = ClusterFront(
            static_hosts={h: addr for h, (_, _, addr) in hosts.items()},
            metrics_registry=MetricsRegistry(), host_timeout=10.0,
            request_timeout=30.0)
        try:
            assert front.ready() and front.live()
            assert sorted(front.ready_detail()) == ["h0", "h1"]
            pieces = [front.infer({"word": seq[0:4]}, session_id="conv",
                                  timeout=120.0)[OUT],
                      front.infer({"word": seq[4:8]}, session_id="conv",
                                  timeout=120.0)[OUT]]
            home = front._session_last["conv"]
            # committed after every acked chunk: the carry sits in the
            # shared store between chunks, not on the home host
            assert len(store.store) == 1
            _kill_host(*hosts.pop(home)[:2])
            pieces.append(front.infer({"word": seq[8:12]},
                                      session_id="conv",
                                      timeout=120.0)[OUT])
            assert front._session_last["conv"] != home
            got = np.concatenate(pieces)
            assert got.dtype == np.float32
            assert np.array_equal(got, whole)
            stats = front.stats()
            assert stats["session_rehomes"] == 1
            assert stats["hosts_excluded"] == 1
            assert stats["hosts_live"] == 1
            text = front.metrics.to_prometheus()
            survivor = sorted(hosts)[0]
            assert ('paddle_tpu_serve_hosts{host="%s"} 0' % home) in text
            assert ('paddle_tpu_serve_host_rehomes_total{host="%s"} 1'
                    % survivor) in text
        finally:
            front.stop()
    finally:
        for sched, srv, _ in hosts.values():
            _kill_host(sched, srv)
        store.stop()


def test_front_sheds_no_host():
    front = ClusterFront(static_hosts={}, metrics_registry=MetricsRegistry())
    try:
        assert not front.ready()
        with pytest.raises(Overloaded) as exc_info:
            front.infer({"word": _seq(4)})
        assert exc_info.value.reason == "no_host"
        assert front.stats()["shed_no_host"] == 1
        assert 'paddle_tpu_serve_shed_total{reason="no_host"} 1' in \
            front.metrics.to_prometheus()
    finally:
        front.stop()


def test_front_join_and_lease_lapse(bundle, tmp_path):
    """The coordinator-backed membership loop: a host publishing its dial
    address through its lease meta is found and routed to; once its
    heartbeat stops and the lease lapses it is excluded (``lease_lost``
    and ``excluded`` step-log records) and the front sheds ``no_host``."""
    from paddle_tpu_torch.distributed.client import (
        encode_host_meta, spawn_coordinator_on_free_port)
    from paddle_tpu_torch.distributed.elastic import HeartbeatThread
    from paddle_tpu_torch.observe.steplog import StepLog, read_jsonl

    port, coord = spawn_coordinator_on_free_port()
    endpoint = "127.0.0.1:%d" % port
    store = spawn_store_in_thread(capacity=8)
    slog = StepLog(str(tmp_path), run_name="serve-front")
    sched = srv = hb = front = None
    try:
        sched, srv, addr = _spawn_host(bundle, store.address)
        hb = HeartbeatThread(endpoint, worker_id="solo", ttl=1.5,
                             meta=encode_host_meta(kind="serve", addr=addr))
        hb.start()
        front = ClusterFront(endpoint=endpoint, poll_interval=0.2,
                             metrics_registry=MetricsRegistry(),
                             steplog=slog, host_timeout=10.0,
                             request_timeout=30.0)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not front.hosts():
            time.sleep(0.1)
        hosts = front.hosts()
        assert list(hosts) == ["solo"]
        assert hosts["solo"]["address"] == addr and hosts["solo"]["live"]
        out = front.infer({"word": _seq(6, seed=2)}, session_id="s1",
                          timeout=120.0)
        assert out[OUT].shape[0] == 6
        hb.stop()  # a silent host: the lease must lapse, not linger
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and front.stats()["hosts_live"]:
            time.sleep(0.2)
        assert front.stats()["hosts_live"] == 0
        with pytest.raises(Overloaded):
            front.infer({"word": _seq(2, seed=3)})
    finally:
        if front is not None:
            front.stop()
        if hb is not None:
            hb.stop()
        if srv is not None:
            _kill_host(sched, srv)
        store.stop()
        coord.terminate()
        coord.wait(timeout=10)
        slog.close()
    kinds = [r["kind"] for r in read_jsonl(slog.path)
             if r.get("type") == "serve_host_event"]
    assert kinds[0] == "join" and kinds[-2:] == ["lease_lost", "excluded"]


def _drive(front, seq, cuts):
    return np.concatenate([front.infer({"word": seq[a:b]}, session_id="w",
                                       timeout=120.0)[OUT]
                           for a, b in cuts])


def test_fronts_route_across_the_packages(bundle, dirs):
    """The JAX package's ClusterFront over the port's hosts answers as the
    port's front does, bit for bit; the port's front over the JAX
    package's hosts answers as the JAX front does, bit for bit, and both
    agree within 1e-5."""
    from paddle_tpu.observe.metrics import MetricsRegistry as JaxRegistry
    from paddle_tpu.serve.cluster import ClusterFront as JaxFront
    from paddle_tpu.serve.remote_store import (
        spawn_store_in_thread as jax_store)

    seq, cuts = _seq(10, seed=9), [(0, 3), (3, 7), (7, 10)]
    answers = {}
    for kind in ("port", "jax"):
        store = (spawn_store_in_thread if kind == "port"
                 else jax_store)(capacity=8)
        hosts = [(_spawn_host(bundle, store.address) if kind == "port"
                  else _spawn_jax_host(dirs[1], store.address))
                 for _ in range(2)]
        static = {"h%d" % i: addr for i, (_, _, addr) in enumerate(hosts)}
        try:
            for front_kind, cls, reg in (("port", ClusterFront,
                                          MetricsRegistry),
                                         ("jax", JaxFront, JaxRegistry)):
                front = cls(static_hosts=static, metrics_registry=reg(),
                            request_timeout=30.0)
                try:
                    answers[(front_kind, kind)] = _drive(front, seq, cuts)
                    front.close_session("w")
                finally:
                    front.stop()
        finally:
            for sched, srv, _ in hosts:
                _kill_host(sched, srv)
            store.stop()
    assert np.array_equal(answers[("jax", "port")], answers[("port", "port")])
    assert np.array_equal(answers[("port", "jax")], answers[("jax", "jax")])
    np.testing.assert_allclose(answers[("port", "port")],
                               answers[("jax", "jax")], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(answers[("port", "port")],
                                  _whole(bundle, seq))


# -- slow: two cli hosts behind the cli front, SIGKILL ------------------------

def _start(argv):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               PYTHONUNBUFFERED="1")
    return subprocess.Popen([sys.executable, "-m", *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env, cwd=ROOT)


def _read_until(proc, marker, timeout=300):
    deadline = time.monotonic() + timeout
    seen = []
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line and proc.poll() is not None:
            break
        seen.append(line)
        if marker in line:
            return line.strip()
    raise AssertionError("no %r in: %s" % (marker, "".join(seen)[-3000:]))


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=120) as fh:
        return json.loads(fh.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as fh:
        return json.loads(fh.read())


@pytest.mark.slow
def test_two_cli_hosts_sigkill_zero_committed_loss(bundle, dirs):
    """Two ``cli serve --join`` processes and ``cli serve --front``: the
    session's home is killed -9 between committed chunks; the front
    re-homes it and the conversation stays equal to the whole-sequence
    decode bit for bit; the survivor's /debug/compiles does not move."""
    from paddle_tpu_torch.distributed.client import (
        spawn_coordinator_on_free_port)

    seq = _seq(12, seed=11)
    whole = _whole(bundle, seq)
    port, coord = spawn_coordinator_on_free_port()
    endpoint = "127.0.0.1:%d" % port
    procs = {}
    try:
        procs["store"] = _start(["paddle_tpu_torch.serve.remote_store",
                                 "--capacity", "64"])
        store_addr = _read_until(procs["store"], "listening").split()[-1]
        urls = {}
        for hid in ("h0", "h1"):
            procs[hid] = _start(["paddle_tpu_torch.cli", "serve", dirs[0],
                                 "--continuous", "--device", "cpu",
                                 "--port", "0", "--join", endpoint,
                                 "--host-id", hid, "--lease-ttl", "5",
                                 "--session-store-addr", store_addr])
            banner = _read_until(procs[hid], "http://")
            urls[hid] = ("http://" + banner.split("http://", 1)[1]
                         .split(" ", 1)[0])
        procs["front"] = _start(["paddle_tpu_torch.cli", "serve", "--front",
                                 "--join", endpoint, "--port", "0"])
        banner = _read_until(procs["front"], "http://")
        front = "http://" + banner.split("http://", 1)[1].split(" ", 1)[0]
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            hosts = _get(front + "/hosts")
            if len(hosts) == 2:
                try:
                    with urllib.request.urlopen(front + "/readyz",
                                                timeout=30):
                        break
                except urllib.error.HTTPError:
                    pass
            time.sleep(0.5)
        pieces = [np.asarray(_post(front + "/infer", {
            "inputs": {"word": seq[a:b].tolist()},
            "session_id": "conv"})["outputs"][OUT], np.float32)
            for a, b in ((0, 4), (4, 8))]
        stats = _get(front + "/stats")
        assert stats["requests"] == 2
        compiles = {h: _get(u + "/debug/compiles")["compiles"]
                    for h, u in urls.items()}
        # the home is the host whose store round trips saw the session
        home = [h for h, u in urls.items()
                if _get(u + "/stats").get("spills")][0]
        procs[home].send_signal(signal.SIGKILL)
        procs[home].wait(timeout=30)
        pieces.append(np.asarray(_post(front + "/infer", {
            "inputs": {"word": seq[8:12].tolist()},
            "session_id": "conv"})["outputs"][OUT], np.float32))
        assert np.array_equal(np.concatenate(pieces), whole)
        assert _get(front + "/stats")["session_rehomes"] == 1
        survivor = [h for h in urls if h != home][0]
        assert _get(urls[survivor] + "/debug/compiles")["compiles"] == \
            compiles[survivor]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in procs.values():
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            proc.stdout.close()
        coord.terminate()
        coord.wait(timeout=10)
