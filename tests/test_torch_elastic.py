"""Elastic training (paddle_tpu_torch/distributed/elastic.py) and the
reform abort of the port's trainer against the JAX package.

- The reform-abort repair (JAX tests/test_distributed.py:357): a
  WorkerLost or SelfLeaseLost raised out of ``train`` discards the
  pending snapshot of the overlapped writer
  (``AsyncCheckpointer.discard_pending``), so only the write already in
  flight commits.
- ``deal_shards`` equal to JAX's over shuffled inputs; the membership
  watch's routing of the own loss to SelfLeaseLost; settled_checkpoint.
- The lost-worker scenario (JAX tests/test_distributed.py:558): a peer's
  lease lapses at shard ``s2``; the survivor rewinds to the last
  committed checkpoint and re-deals every shard. Run through both
  packages' ``run_elastic`` (each on its own package's coordinator) from
  the same numpy parameters: the same stats and consumed shards, and
  parameters within 1e-6 (float32 in two orders of summation). And the
  reform before any cadence commit rewinds to the step-0 baseline.
"""

import os
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed import client as jclient
from paddle_tpu.distributed import elastic as jelastic

import paddle_tpu_torch as paddle
from paddle_tpu_torch import minibatch
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed import elastic
from paddle_tpu_torch.distributed.client import spawn_coordinator_on_free_port

TOL = 1e-6


def _cost(pkg):
    from importlib import import_module

    import_module(pkg.__name__ + ".graph").reset_name_counters()
    x = pkg.layer.data(name="x", type=pkg.data_type.dense_vector(4))
    y = pkg.layer.data(name="y", type=pkg.data_type.integer_value(2))
    return pkg.layer.classification_cost(
        input=pkg.layer.fc(input=x, size=2, name="fc"), label=y)


def _arrays(topology, seed=3):
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*spec.shape) * 0.3).astype(np.float32)
            for n, spec in sorted(topology.param_specs().items())}


def _port_trainer():
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.topology import Topology

    cost = _cost(paddle)
    topology = Topology(cost)
    params = Parameters(params_from_numpy(_arrays(topology), topology,
                                          device="cpu"),
                        topology.param_specs())
    return paddle.trainer.SGD(cost, params,
                              opt.Momentum(momentum=0.9, learning_rate=0.1),
                              device="cpu")


def _jax_trainer():
    import jax.numpy as jnp

    import paddle_tpu as jpaddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.parameters import Parameters as JaxParameters
    from paddle_tpu.topology import Topology as JaxTopology

    cost = _cost(jpaddle)
    params = JaxParameters()
    params._specs = JaxTopology(cost).param_specs()
    params._values = {k: jnp.asarray(v)
                      for k, v in _arrays(JaxTopology(cost)).items()}
    return jpaddle.trainer.SGD(cost, params,
                               jopt.Momentum(momentum=0.9,
                                             learning_rate=0.1))


# -- the reform abort ----------------------------------------------------------

@pytest.mark.parametrize("lost_kind", ["peer", "self"])
def test_reform_abort_discards_pending_snapshot(tmp_path, monkeypatch,
                                                lost_kind):
    """A reform abort (a peer's WorkerLost or the own SelfLeaseLost) does
    NOT commit the pending snapshot during train()'s unwind: each worker
    stops at its own step boundary, so an unwind commit would move the
    shared rewind target differently per worker. The write already in
    flight still completes."""
    gate = threading.Event()
    started = threading.Event()
    orig_write = ckpt.AsyncCheckpointer._write

    def slow_write(self, job):
        started.set()
        orig_write(self, job)
        # hold the writer, so later snapshots stay pending until well past
        # the abort; the bounded wait expires under close()'s join, after
        # the discard already ran
        gate.wait(3.0)

    monkeypatch.setattr(ckpt.AsyncCheckpointer, "_write", slow_write)
    trainer = _port_trainer()

    def samples():
        rng = np.random.RandomState(3)
        for _ in range(48):
            x = rng.randn(4).astype(np.float32)
            yield x, int(x.sum() > 0)

    seen = []

    def handler(e):
        if isinstance(e, paddle.event.EndIteration):
            seen.append(e.batch_id)
            if len(seen) == 1:
                # wait until the writer STARTED a write, so the pending
                # snapshot at the abort is a later one
                assert started.wait(10.0), "writer never started"
            if len(seen) == 4:
                if lost_kind == "peer":
                    raise elastic.WorkerLost(["w-dead"], ["w-me"])
                raise elastic.SelfLeaseLost("w-me: own lease lapsed")

    d = str(tmp_path / "ck")
    with pytest.raises((elastic.WorkerLost, elastic.SelfLeaseLost)):
        trainer.train(minibatch.batch(samples, 8), num_passes=1,
                      event_handler=handler, checkpoint_dir=d,
                      checkpoint_every=1)
    # the snapshot the held writer had started is the only commit; the
    # pending one at the abort boundary was discarded (without
    # discard_pending, close() would drain and commit it)
    names = sorted(n for n in os.listdir(d) if n.startswith("pass-"))
    abort_step = len(seen) + 1  # the cadence submit runs one step ahead
    assert len(names) == 1, names
    assert names[0] != "pass-00000-step-%08d" % abort_step, names


def test_discard_pending_drops_only_the_unstarted_snapshot(tmp_path):
    writer = ckpt.AsyncCheckpointer(str(tmp_path / "ck"))
    try:
        assert writer.discard_pending() is False
        with writer._cv:  # a snapshot queued but not started
            writer._pending = object()
        assert writer.discard_pending() is True
        assert writer.superseded == 1 and writer._pending is None
    finally:
        writer.close()
    assert writer.saves == 0


# -- the pure parts --------------------------------------------------------------

def test_deal_shards_matches_jax():
    rng = np.random.RandomState(0)
    chunks = ["s%d" % i for i in range(11)]
    workers = ["w3", "w0", "w1", "w7"]
    for _ in range(5):
        shuffled = list(rng.permutation(chunks))
        wshuf = list(rng.permutation(workers))
        deals = [elastic.deal_shards(shuffled, wshuf, w) for w in workers]
        assert deals == [jelastic.deal_shards(shuffled, wshuf, w)
                         for w in workers]
        assert sorted(c for d in deals for c in d) == sorted(chunks)
    with pytest.raises(Exception, match="not in membership"):
        elastic.deal_shards(chunks, workers, "w9")


def test_membership_watch_routes_self_loss_to_self_lease_lost():
    class Stub:
        worker_id = "w0"

        def __init__(self, view):
            self._view = view

        def workers(self):
            return list(self._view)

    watch = elastic.MembershipWatch(Stub(["w0"]), ["w0", "w1"],
                                    poll_secs=0.0)
    with pytest.raises(elastic.WorkerLost) as ei:
        watch.check()
    assert ei.value.lost == ["w1"] and ei.value.remaining == ["w0"]
    watch = elastic.MembershipWatch(Stub(["w1"]), ["w0", "w1"],
                                    poll_secs=0.0)
    with pytest.raises(elastic.SelfLeaseLost):
        watch.check()
    elastic.MembershipWatch(Stub(["w0", "w1", "w2"]), ["w0", "w1"],
                            poll_secs=0.0).check()  # a join is no loss


def test_settled_checkpoint_waits_for_inflight_commit(monkeypatch):
    views = iter(["step-1", "step-2", "step-2"])
    polls = []

    def scripted_latest(directory):
        polls.append(directory)
        return next(views)

    monkeypatch.setattr(ckpt, "latest_checkpoint", scripted_latest)
    assert elastic.settled_checkpoint("dir", poll_secs=0.05,
                                      timeout=10.0) == "step-2"
    assert len(polls) == 3


# -- the lost-worker scenario through both packages ---------------------------

def _scenario(pkg_elastic, spawn, trainer, batch, tmp, ttl=1.2,
              every=1, lapse_at="s2"):
    """The lost-worker run of one package: (stats, consumed (epoch, shard)
    pairs, the checkpoint directory)."""
    port, proc = spawn(snapshot_path="")
    endpoint = "127.0.0.1:%d" % port
    try:
        # w1 heartbeats until the chaos point, so the first deal holds two
        doomed = pkg_elastic.HeartbeatThread(endpoint, "w1", ttl=ttl).start()
        chunks = ["s%d" % i for i in range(4)]
        consumed, epoch, slept = [], [0], []

        def reader_of(shards):
            epoch[0] += 1

            def samples():
                rng = np.random.RandomState(7)
                W = rng.randn(4, 2)
                for shard in shards:
                    consumed.append((epoch[0], shard))
                    if shard == lapse_at and not slept:
                        # w1 "dies" here; shard IO slow enough for its
                        # lease to lapse mid-pass
                        slept.append(True)
                        doomed.stop()
                        time.sleep(ttl + 0.4)
                    for _ in range(16):
                        x = rng.randn(4).astype(np.float32)
                        yield x, int(np.argmax(x @ W))

            return batch(samples, 8)

        ck_dir = str(tmp / "ck")
        stats = pkg_elastic.run_elastic(
            trainer, endpoint, chunks, reader_of, ck_dir, num_passes=1,
            checkpoint_every=every, checkpoint_sync=True, worker_id="w0",
            heartbeat_ttl=30.0, poll_secs=0.05)
        return stats, consumed, ck_dir
    finally:
        proc.kill()
        proc.wait()


def test_elastic_lost_worker_matches_jax(tmp_path, monkeypatch):
    from paddle_tpu import minibatch as jminibatch
    from tests.torch_dp import jax_coordinator_binary

    monkeypatch.setattr(jclient, "COORDINATOR_BIN",
                        jax_coordinator_binary(tmp_path))

    jtrainer = _jax_trainer()
    jstats, jconsumed, _ = _scenario(
        jelastic, jclient.spawn_coordinator_on_free_port, jtrainer,
        jminibatch.batch, tmp_path / "jax")
    trainer = _port_trainer()
    stats, consumed, ck_dir = _scenario(
        elastic, spawn_coordinator_on_free_port, trainer, minibatch.batch,
        tmp_path / "port")
    chunks = ["s%d" % i for i in range(4)]
    assert stats == jstats
    assert stats["reforms"] == 1 and stats["lost"] == ["w1"]
    assert stats["deals"] == [["s0", "s2"], chunks]
    assert consumed == jconsumed
    assert [s for e, s in consumed if e == 2] == chunks
    assert ckpt.latest_checkpoint(ck_dir) is not None
    for name in jtrainer.parameters.names():
        np.testing.assert_allclose(
            trainer.parameters.get(name),
            np.asarray(jtrainer.parameters.get(name)), rtol=TOL, atol=TOL,
            err_msg=name)


def test_elastic_reform_before_first_commit_has_rewind_target(tmp_path):
    """A peer lost before any cadence save committed still rewinds to the
    step-0 baseline run_elastic commits before the first step."""
    stats, _, ck_dir = _scenario(
        elastic, spawn_coordinator_on_free_port, _port_trainer(),
        minibatch.batch, tmp_path, every=1000, lapse_at="s0")
    assert stats["reforms"] == 1 and stats["lost"] == ["w1"]
    latest = ckpt.latest_checkpoint(ck_dir)
    assert latest is not None and latest.endswith("step-00000000")
    assert stats["deals"][1] == ["s%d" % i for i in range(4)]
