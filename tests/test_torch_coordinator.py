"""The port's coordinator and its client (paddle_tpu_torch/distributed/
client.py, coordinator/coordinator.cc) against the JAX package's.

- The JAX package's coordinator tests (tests/test_distributed.py), run on
  the port's binary, built at first use under paddle_tpu_torch/build/:
  the task lifecycle, timeout requeue, the failure cap, the save
  election, membership leases, snapshot recovery (hostile task names
  too), the task reader, the client's backoff across a restart, the
  heartbeat thread keeping and losing its lease, and settled_members.
- Each package's client against the other package's coordinator: one
  script of every op gives the same replies (the coordinator's clock and
  the leases' time to expiry aside).
- The trainer's save election (``SGD.save_checkpoint(coordinator=)``):
  of two clients exactly one writes, as in the JAX package.
- ``cli observe --fleet-stats`` lists the live leases, as the JAX CLI.
"""

import json
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed import client as jclient

from paddle_tpu_torch.distributed import elastic
from paddle_tpu_torch.distributed.client import (CoordinatorClient,
                                                 decode_host_meta,
                                                 encode_host_meta,
                                                 spawn_coordinator,
                                                 spawn_coordinator_on_free_port)


@pytest.fixture(scope="module")
def jax_binary(tmp_path_factory):
    from tests.torch_dp import jax_coordinator_binary

    return jax_coordinator_binary(tmp_path_factory.mktemp("jaxcoord"))


@pytest.fixture
def coordinator(tmp_path):
    snap = str(tmp_path / "snapshot.json")
    port, proc = spawn_coordinator_on_free_port(
        snapshot_path=snap, task_timeout=1.0, failure_max=2)
    yield "127.0.0.1:%d" % port, snap, proc
    proc.kill()
    proc.wait()


def _drain(client, pass_id):
    seen = []
    while True:
        task = client.get_task(pass_id=pass_id)
        if task in (None, "retry", "pass_done"):
            return task, seen
        seen.extend(task[1])
        client.task_finished(task[0])


def test_task_lifecycle(coordinator):
    endpoint, _, _ = coordinator
    client = CoordinatorClient(endpoint, worker_id="w0")
    resp = client.set_dataset(["c%d" % i for i in range(8)], chunks_per_task=2)
    assert resp["num_tasks"] == 4
    task, seen = _drain(client, 0)
    assert task == "pass_done"
    assert sorted(seen) == ["c%d" % i for i in range(8)]
    # the pass rolled over: pass 1 serves the same tasks again
    assert client.get_task(pass_id=1) not in (None, "retry", "pass_done")
    assert client.status()["pass"] == 1


def test_task_timeout_requeues(coordinator):
    endpoint, _, _ = coordinator
    w0 = CoordinatorClient(endpoint, worker_id="w0")
    w1 = CoordinatorClient(endpoint, worker_id="w1")
    w0.set_dataset(["only-chunk"], chunks_per_task=1)
    w0.get_task()
    # w0 "dies": never reports. After the 1 s timeout the task requeues
    deadline = time.time() + 5
    got = None
    while time.time() < deadline:
        task = w1.get_task()
        if task not in (None, "retry"):
            got = task
            break
        time.sleep(0.2)
    assert got is not None and got[1] == ["only-chunk"]


def test_failure_cap_discards_poison_task(coordinator):
    endpoint, _, _ = coordinator
    client = CoordinatorClient(endpoint, worker_id="w0")
    client.set_dataset(["poison"], chunks_per_task=1)
    for _ in range(2):  # failure_max=2
        task = client.get_task()
        assert task not in (None, "retry")
        client.task_failed(task[0])
    status = client.status()
    assert status["failed"] == 1 and status["todo"] == 0
    assert client.get_task() is None


def test_save_model_election(coordinator):
    endpoint, _, _ = coordinator
    workers = [CoordinatorClient(endpoint, worker_id="w%d" % i)
               for i in range(4)]
    elected = [w.request_save_model(ttl=30) for w in workers]
    assert sum(elected) == 1
    # the winner can re-win (lease renewal); the others still lose
    winner = workers[elected.index(True)]
    assert winner.request_save_model(ttl=30)
    assert sum(w.request_save_model(ttl=30) for w in workers) == 1


def test_membership_leases(coordinator):
    endpoint, _, _ = coordinator
    w0 = CoordinatorClient(endpoint, worker_id="alive")
    w1 = CoordinatorClient(endpoint, worker_id="dying")
    w0.register(ttl=30)
    w1.register(ttl=0.3)
    assert sorted(w0.workers()) == ["alive", "dying"]
    time.sleep(1.0)
    assert w0.workers() == ["alive"]


def test_snapshot_recovery(coordinator):
    """Kill the coordinator mid-pass; a restarted one resumes the queues
    (go/master snapshot/recover parity)."""
    endpoint, snap, proc = coordinator
    client = CoordinatorClient(endpoint, worker_id="w0")
    client.set_dataset(["a", "b", "c", "d"], chunks_per_task=1)
    t0 = client.get_task()
    client.task_finished(t0[0])
    client.get_task()  # left pending: requeues as todo on recovery
    time.sleep(0.5)  # let the dirty snapshot flush
    proc.kill()
    proc.wait()
    port2, proc2 = spawn_coordinator_on_free_port(snapshot_path=snap)
    try:
        c2 = CoordinatorClient("127.0.0.1:%d" % port2, worker_id="w0")
        status = c2.status()
        # 4 tasks: 1 done, 3 to do (the abandoned pending one too)
        assert status["done"] == 1 and status["todo"] == 3
        _, remaining = _drain(c2, status["pass"])
        assert len(set(remaining)) == 3
        assert set(remaining) < {"a", "b", "c", "d"}
        assert set(t0[1]).isdisjoint(remaining)
    finally:
        proc2.kill()
        proc2.wait()


def test_snapshot_recovery_hostile_task_names(coordinator):
    """Chunk names with quotes, backslashes, JSON structure characters,
    control characters and unicode survive the snapshot/recover round
    trip byte for byte."""
    hostile = ['plain.rec', 'quo"te.rec', 'back\\slash.rec',
               'brace{curly}.rec', 'brack[et].rec', 'comma,colon:.rec',
               'tab\there.rec', 'newline\nname.rec', 'unicode-é中文.rec',
               'done', '{"id": 9}']
    endpoint, snap, proc = coordinator
    client = CoordinatorClient(endpoint, worker_id="w0")
    assert client.set_dataset(hostile, chunks_per_task=3)["num_tasks"] == 4
    t0 = client.get_task()
    client.task_finished(t0[0])
    time.sleep(0.5)  # flush the dirty snapshot
    proc.kill()
    proc.wait()
    port2, proc2 = spawn_coordinator_on_free_port(snapshot_path=snap)
    try:
        c2 = CoordinatorClient("127.0.0.1:%d" % port2, worker_id="w0")
        status = c2.status()
        assert status["done"] == 1 and status["todo"] == 3
        _, rest = _drain(c2, status["pass"])
        assert sorted(list(t0[1]) + rest) == sorted(hostile)
    finally:
        proc2.kill()
        proc2.wait()


def test_task_reader_drives_training_data(coordinator):
    endpoint, _, _ = coordinator
    client = CoordinatorClient(endpoint, worker_id="w0")
    client.set_dataset(["shard-%d" % i for i in range(4)], chunks_per_task=2)

    def chunk_to_samples(chunk):
        idx = int(chunk.split("-")[1])
        return [(idx, i) for i in range(3)]

    samples = list(client.task_reader(chunk_to_samples)())
    assert sorted(samples) == sorted((i, j) for i in range(4)
                                     for j in range(3))


def test_client_backoff_survives_coordinator_restart(tmp_path):
    """A call issued while the coordinator is down rides the capped
    backoff across its restart instead of raising."""
    snap = str(tmp_path / "snap.json")
    port, proc = spawn_coordinator_on_free_port(snapshot_path=snap)
    respawned = []
    try:
        client = CoordinatorClient("127.0.0.1:%d" % port, worker_id="w0",
                                   retry_timeout=60.0)
        client.set_dataset(["a", "b"], chunks_per_task=1)
        time.sleep(0.5)  # let the dirty snapshot flush
        proc.kill()
        proc.wait()
        t = threading.Timer(1.0, lambda: respawned.append(
            spawn_coordinator(port, snapshot_path=snap)))
        t.start()
        try:
            status = client.status()
        finally:
            t.join()
        assert status["todo"] == 2
    finally:
        for p in [proc] + respawned:
            p.kill()
            p.wait()


def test_heartbeat_thread_keeps_lease(coordinator):
    endpoint, _, _ = coordinator
    probe = CoordinatorClient(endpoint, worker_id="probe")
    hb = elastic.HeartbeatThread(endpoint, "hb-w", ttl=0.6).start()
    try:
        time.sleep(1.5)  # well past ttl: only renewals keep the lease
        assert "hb-w" in probe.workers()
        assert hb.stats()["beats"] >= 1
    finally:
        hb.stop()
    time.sleep(1.0)  # stopped: the lease lapses like a crashed worker's
    assert "hb-w" not in probe.workers()


def test_heartbeat_self_lapse_detected(coordinator):
    """A worker cut off from the coordinator longer than ttl knows its own
    lease lapsed."""
    endpoint, _, proc = coordinator
    hb = elastic.HeartbeatThread(endpoint, "w-self", ttl=0.6).start()
    try:
        time.sleep(0.3)
        assert not hb.lease_lapsed()
        proc.kill()  # the "partition"
        proc.wait()
        time.sleep(1.2)
        assert hb.lease_lapsed()
    finally:
        hb.stop()


def test_settled_members_waits_for_expected(coordinator):
    endpoint, _, _ = coordinator
    c0 = CoordinatorClient(endpoint, worker_id="w0")
    c0.register(ttl=30.0)

    def late_join():
        time.sleep(0.4)
        c1 = CoordinatorClient(endpoint, worker_id="w1")
        c1.register(ttl=30.0)
        c1.close()

    t = threading.Thread(target=late_join, name="late-join")
    t.start()
    try:
        members = elastic.settled_members(c0, poll_secs=0.1, expected=2,
                                          timeout=5.0)
        assert members == {"w0", "w1"}
    finally:
        t.join()
        c0.close()


# -- across the packages -------------------------------------------------------

def _script(make_client, endpoint):
    """Every op of the wire protocol in one fixed order; the replies, with
    the clock and the leases' time to expiry left out."""
    w0, w1 = make_client(endpoint, "w0"), make_client(endpoint, "w1")
    out = [w0.set_dataset(["s%d" % i for i in range(5)], chunks_per_task=2),
           w0.status(), w0.register(ttl=30.0),
           w1.register(ttl=30.0, meta=encode_host_meta(kind="serve",
                                                        addr="h:1")),
           sorted(w0.workers())]
    t0 = w0.get_task(pass_id=0)
    t1 = w1.get_task(pass_id=0)
    out += [list(t0), list(t1), w0.task_finished(t0[0]),
            w1.task_failed(t1[0]), w0.status(),
            w0.request_save_model(ttl=30.0), w1.request_save_model(ttl=30.0),
            w0.heartbeat(ttl=30.0)]
    stats = w0.fleet_stats()
    out.append(sorted(w["id"] for w in stats["workers"]))
    hosts = w0.serve_hosts()["hosts"]
    out.append([(h["id"], decode_host_meta(h["meta"])) for h in hosts])
    task, seen = _drain(w0, 0)
    out += [task, sorted(seen), w0.status()]
    w0.close()
    w1.close()
    return json.loads(json.dumps(out))


def _port_client(endpoint, wid):
    return CoordinatorClient(endpoint, worker_id=wid)


def _jax_client(endpoint, wid):
    return jclient.CoordinatorClient(endpoint, worker_id=wid)


def test_each_client_against_the_other_coordinator(tmp_path, jax_binary,
                                                   monkeypatch):
    """The JAX client on the port's coordinator and the port's client on
    the JAX package's coordinator give the replies of each package's own
    pair."""
    monkeypatch.setattr(jclient, "COORDINATOR_BIN", jax_binary)
    jport, jproc = jclient.spawn_coordinator_on_free_port(
        snapshot_path=str(tmp_path / "j.json"))
    port, proc = spawn_coordinator_on_free_port(
        snapshot_path=str(tmp_path / "p.json"))
    try:
        got = {}
        for name, (make, where) in {
                "jax_on_port": (_jax_client, port),
                "port_on_jax": (_port_client, jport)}.items():
            got[name] = _script(make, "127.0.0.1:%d" % where)
        # fresh coordinators for each package's own pair
        for p in (jproc, proc):
            p.kill()
            p.wait()
        jport, jproc = jclient.spawn_coordinator_on_free_port()
        port, proc = spawn_coordinator_on_free_port()
        want = _script(_jax_client, "127.0.0.1:%d" % jport)
        assert _script(_port_client, "127.0.0.1:%d" % port) == want
        assert got["jax_on_port"] == want
        assert got["port_on_jax"] == want
    finally:
        for p in (jproc, proc):
            p.kill()
            p.wait()


def test_host_meta_matches_jax():
    fields = {"kind": "serve", "addr": "10.0.0.1:8866", "host": "h-1"}
    assert encode_host_meta(**fields) == jclient.encode_host_meta(**fields)
    assert decode_host_meta("a=1,junk,b = 2") == \
        jclient.decode_host_meta("a=1,junk,b = 2")
    with pytest.raises(ValueError):
        encode_host_meta(addr="a,b")


# -- the trainer's save election and cli observe --fleet-stats ---------------

def _trainer():
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import data_type, layer
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.graph import reset_name_counters
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.topology import Topology

    reset_name_counters()
    x = layer.data(name="x", type=data_type.dense_vector(4))
    y = layer.data(name="y", type=data_type.integer_value(2))
    cost = layer.classification_cost(input=layer.fc(input=x, size=2),
                                     label=y)
    return paddle.trainer.SGD(cost,
                              Parameters.create(Topology(cost), rng=3,
                                                device="cpu"),
                              opt.Momentum(learning_rate=0.1),
                              device="cpu")


def test_save_checkpoint_election_writes_once(coordinator, tmp_path):
    from paddle_tpu_torch.distributed import checkpoint as ckpt

    endpoint, _, _ = coordinator
    d = str(tmp_path / "ck")
    paths = [_trainer().save_checkpoint(
        d, coordinator=CoordinatorClient(endpoint, worker_id="t%d" % i))
        for i in range(2)]
    assert sum(p is not None for p in paths) == 1
    written = [p for p in paths if p is not None][0]
    assert ckpt.latest_checkpoint(d) == written
    ok, reason = ckpt.verify_checkpoint(written)
    assert ok, reason


def test_observe_fleet_stats_lists_live_leases(coordinator, tmp_path,
                                               capsys):
    from paddle_tpu_torch import cli

    endpoint, _, _ = coordinator
    hb = elastic.HeartbeatThread(endpoint, "trainer-0", ttl=30.0).start()
    try:
        assert cli.main(["observe", str(tmp_path), "--fleet-stats",
                         endpoint, "--json"]) == 0
        summary = json.loads(capsys.readouterr().out)
        assert [w["id"] for w in summary["fleet_stats"]["workers"]] == \
            ["trainer-0"]
        assert 0 < summary["fleet_stats"]["workers"][0]["lease_remaining"] \
            <= 30.0
        assert summary["serve_hosts_live"]["hosts"] == []
        assert cli.main(["observe", str(tmp_path), "--fleet-stats",
                         endpoint]) == 0
        text = capsys.readouterr().out
        assert "live fleet (%s): 1 worker(s)" % endpoint in text
        assert "trainer-0" in text
    finally:
        hb.stop()
    assert np.isfinite(summary["fleet_stats"]["now"])
