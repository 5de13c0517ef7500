"""Data parallelism of the port (paddle_tpu_torch/parallel/mesh.py, the
DataParallel step of trainer.py, distributed/multihost.py, the launcher
and its worker) against the single process and the JAX package's single
device, on the CPU.

- Two gloo ranks (tests/torch_dp.py, spawned once with
  ``OMP_NUM_THREADS=1``) train each case of the rig: the flagship, a conv
  + train-mode batch_norm net, an uneven split (7 rows over 2 ranks, then
  1, so one rank holds none) and the fused loop with the pipelined feed.
  The ranks' costs and parameters are bitwise equal; both are within 1e-6
  of max(1, max |.|) of the port's single process and of the JAX
  package's single-device trainer (float32 sums in another order); the
  classification errors are equal (they are ratios of the same counts),
  and the label probe, gathered from the ranks at finalize, gives the
  pass's labels in the single process's row order.
- In one process: DataParallel over a world of one is the plain trainer
  bit for bit; the mesh's checks; a rank's share of a batch; the
  DeviceFeeder's ``parallelism=`` and ``convert=`` (the JAX package's
  arguments); steps_per_call refused where a capture cannot hold the
  exchange; ``init(trainer_count=)`` and ``--trainer-count`` as in the JAX
  package.
- ``launch_local_cluster`` and ``cli cluster_train`` with two CPU workers
  (JAX tests/test_multihost.py:131), also of two local replicas each, and
  a failing worker ending the launch with an error.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.utils import flags as jflags

import paddle_tpu_torch as paddle
from paddle_tpu_torch.parallel import DataParallel, build_mesh
from paddle_tpu_torch.parallel import mesh as mesh_mod
from paddle_tpu_torch.utils import flags
from paddle_tpu_torch.utils.error import EnforceError
from tests import torch_dp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6
SPAWN_TIMEOUT = 120


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case of the rig trained by two gloo ranks: {case: [rank 0's
    npz, rank 1's]}."""
    out = str(tmp_path_factory.mktemp("dp"))
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dp", str(r), "2", port, out],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=SPAWN_TIMEOUT)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, (r, err[-3000:])
    return {case: [np.load(os.path.join(out, "%s-%d.npz" % (case, r)))
                   for r in range(2)] for case in torch_dp.CASES}


def _params(npz):
    return {k[len("param:"):]: npz[k] for k in npz.files
            if k.startswith("param:")}


def _rel(a, b):
    scale = max(1.0, max(float(np.abs(v).max()) for v in a.values()))
    return max(float(np.abs(a[n] - b[n]).max()) for n in a) / scale


@pytest.mark.parametrize("case", torch_dp.CASES)
def test_two_ranks_match_single_process_and_jax(ranks, case):
    r0, r1 = ranks[case]
    assert str(r0["backend"]) == "gloo"
    p0, p1 = _params(r0), _params(r1)
    assert sorted(p0) == sorted(p1)
    # the ranks: bit for bit
    assert np.array_equal(r0["costs"], r1["costs"])
    for name in p0:
        assert np.array_equal(p0[name], p1[name]), name
    costs, errors, single, labels = torch_dp.port_run(case)
    jcosts, jerrors, jparams = torch_dp.jax_run(case)
    assert len(r0["costs"]) == len(costs) == len(jcosts)
    for want_costs, want_params in ((costs, single), (jcosts, jparams)):
        assert sorted(want_params) == sorted(p0)
        assert np.abs(r0["costs"] - want_costs).max() \
            / max(1.0, float(np.abs(want_costs).max())) <= TOL
        assert _rel(p0, want_params) <= TOL
    # the classification error: the same counts over the global batch
    np.testing.assert_array_equal(r0["errors"], errors)
    np.testing.assert_array_equal(r0["errors"], jerrors)
    # the gathered evaluator: every live rank's rows, in rank order
    assert len(labels) == sum(len(b) for b in torch_dp.batches(case))
    np.testing.assert_array_equal(r0["labels"], labels)
    np.testing.assert_array_equal(r1["labels"], labels)


# -- one process -----------------------------------------------------------------

def test_world_of_one_is_the_plain_trainer_bitwise():
    plain = torch_dp.port_run("conv_bn")
    dp = torch_dp.port_run("conv_bn", parallelism=DataParallel())
    assert np.array_equal(plain[0], dp[0])
    assert np.array_equal(plain[1], dp[1])
    assert np.array_equal(plain[3], dp[3])
    for name, value in plain[2].items():
        assert np.array_equal(value, dp[2][name]), name


def test_mesh_is_the_process_group():
    mesh = build_mesh()
    assert mesh.shape == {"data": 1} and mesh.devices == [0]
    assert build_mesh({"data": -1}).shape == {"data": 1}
    with pytest.raises(EnforceError, match=r"needs 2 devices, have 1"):
        build_mesh({"data": 2})
    with pytest.raises(EnforceError, match="no axis"):
        DataParallel(mesh, axis="model")
    assert paddle.parallel.local_device_count() >= 1
    with mesh_mod.use_mesh(mesh) as active:
        assert mesh_mod.current_mesh() is active is mesh
    assert mesh_mod.current_mesh() is None
    dp = DataParallel(mesh, shard_optimizer_state=False)
    assert dp.backend is None and dp.world == 1 and dp.rank == 0
    assert "DataParallel" in repr(dp)


def _rank_view(rank, world):
    """A DataParallel that answers as rank ``rank`` of ``world`` (its
    batch split only; nothing is exchanged)."""
    dp = DataParallel()
    dp.rank, dp.world = rank, world
    return dp


def test_shares_are_contiguous_and_near_equal():
    for rows in (1, 2, 7, 8, 64, 65):
        for world in (2, 3, 4):
            shares = [_rank_view(r, world).share(rows)
                      for r in range(world)]
            assert shares[0][0] == 0 and shares[-1][1] == rows
            assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
            sizes = [hi - lo for lo, hi in shares]
            assert max(sizes) - min(sizes) <= 1
            assert sizes == sorted(sizes, reverse=True)


def test_shard_batch_slices_every_slot_kind():
    from paddle_tpu_torch.core.sequence import (NestedSequenceBatch,
                                                SequenceBatch)
    from paddle_tpu_torch.core.sparse import SparseRows

    feed = {"dense": torch.arange(14.0).reshape(7, 2),
            "ids": torch.arange(7, dtype=torch.int32),
            "seq": SequenceBatch(torch.arange(21).reshape(7, 3),
                                 torch.tensor([3, 1, 2, 0, 3, 2, 1])),
            "nest": NestedSequenceBatch(torch.zeros(7, 2, 3),
                                        torch.ones(7, dtype=torch.int32),
                                        torch.ones(7, 2, dtype=torch.int32)),
            "sparse": SparseRows(torch.zeros(7, 8, dtype=torch.int32),
                                 None, 100)}
    (local,), (share,) = _rank_view(1, 2).shard_batch(feed)
    assert share == (3, 7)
    assert torch.equal(local["dense"], feed["dense"][4:])
    assert torch.equal(local["seq"].lengths, feed["seq"].lengths[4:])
    assert local["nest"].data.shape[0] == local["sparse"].ids.shape[0] == 3
    # an empty share borrows the first row, weighted 0 by the trainer
    (local,), (share,) = _rank_view(1, 2).shard_batch(
        {"dense": feed["dense"][:1]})
    assert share == (0, 1) and local["dense"].shape[0] == 1


def test_device_feeder_takes_parallelism_and_convert():
    """DeviceFeeder(parallelism=, convert=): ``convert`` is called as the
    JAX package calls it (topology, batch, feeding, max_len) on the host,
    and each FeedBatch holds the rank's share of what it returned."""
    from paddle_tpu.data.feeder import DeviceFeeder as JaxFeeder
    from paddle_tpu.topology import Topology as JaxTopology
    from paddle_tpu_torch.data.feeder import DeviceFeeder
    from paddle_tpu_torch.topology import convert_feed

    data = torch_dp.batches("uneven")
    calls = {}

    def recorder(pkg, fn):
        def convert(topology, data_batch, feeding, max_len, **kw):
            # the port's feeder passes device="cpu" to a convert that
            # takes it: the conversion runs on the host
            calls.setdefault(pkg, []).append((len(data_batch), feeding,
                                               max_len))
            return fn(topology, data_batch, feeding, max_len, **kw)
        return convert

    from paddle_tpu.topology import convert_feed as jconvert

    cost, _, topology, _ = torch_dp.build("uneven", paddle)
    jcost, _, _, _ = torch_dp.build("uneven", jpaddle)
    fbs = list(DeviceFeeder(lambda: iter(data), topology,
                            parallelism=_rank_view(1, 2),
                            convert=recorder("port", convert_feed),
                            device="cpu").batches())
    list(JaxFeeder(lambda: iter(data), JaxTopology(jcost),
                   convert=recorder("jax", jconvert)).batches())
    assert calls["port"] == calls["jax"]
    # one feed and one share for the rank's one device
    assert [fb.share for fb in fbs] == [((3, 7),), ((3, 7),), ((0, 1),)]
    assert all(len(fb.feed) == 1 for fb in fbs)
    assert [fb.examples for fb in fbs] == [7, 7, 1]
    full = convert_feed(topology, data[0], device="cpu")
    for name, value in fbs[0].feed[0].items():
        want = full[name]
        got = value.data if hasattr(value, "data") else value
        ref = want.data if hasattr(want, "data") else want
        assert torch.equal(got, ref[4:]), name


def test_steps_per_call_refused_where_the_exchange_cannot_be_captured(
        monkeypatch):
    dp = DataParallel()
    assert dp.capturable(torch.device("cpu"))
    monkeypatch.setattr(DataParallel, "backend", property(lambda s: "gloo"))
    assert not dp.capturable(torch.device("cuda"))
    assert dp.capturable(torch.device("cpu"))
    monkeypatch.setattr(DataParallel, "backend", property(lambda s: "nccl"))
    assert dp.capturable(torch.device("cuda"))
    with pytest.raises(EnforceError, match="NCCL needs the trainer on the "
                       "card"):
        dp.check_device(torch.device("cpu"))
    monkeypatch.setattr(DataParallel, "backend", property(lambda s: "gloo"))
    cost, _, topology, _ = torch_dp.build("flagship", paddle)
    from paddle_tpu_torch.parameters import Parameters

    trainer = paddle.trainer.SGD(
        cost, Parameters.create(topology, device="cpu"),
        paddle.optimizer.Momentum(learning_rate=0.1),
        parallelism=DataParallel(), device="cpu")
    trainer.device = torch.device("cuda")  # as a trainer on the card
    with pytest.raises(EnforceError, match="cannot capture"):
        trainer.train(lambda: iter(torch_dp.batches("flagship")),
                      steps_per_call=2)


def test_init_and_trainer_count_act_as_in_jax(tmp_path, monkeypatch):
    """init(trainer_count=) sets the flag as the JAX package's init does;
    ``--trainer-count`` above the visible devices exits with the JAX
    CLI's message (the CPU is one device unless
    PADDLE_TPU_TORCH_VIRTUAL_DEVICES names more; the replicas' training
    is tests/test_torch_local_dp.py's)."""
    monkeypatch.delenv(mesh_mod.VIRTUAL_DEVICES_ENV, raising=False)
    from paddle_tpu_torch import cli
    from paddle_tpu_torch.core import place

    before, jbefore = flags.get_flag("trainer_count"), \
        jflags.get_flag("trainer_count")
    device = place.default_device()
    try:
        paddle.init(use_tpu=False, trainer_count=2)
        jpaddle.init(use_tpu=False, trainer_count=2)
        assert flags.get_flag("trainer_count") == \
            jflags.get_flag("trainer_count") == 2
        conf = tmp_path / "conf.py"
        conf.write_text(CONFIG)
        with pytest.raises(SystemExit, match="--trainer-count 2 exceeds "
                           "the 1 visible devices"):
            cli.main(["train", "--config", str(conf), "--device", "cpu",
                      "--trainer-count", "2"])
        with pytest.raises(SystemExit, match="does not apply to "
                           "cluster_train"):
            cli.main(["cluster_train", "--config", str(conf),
                      "--num-processes", "2", "--trainer-count", "2"])
    finally:
        flags.set_flag("trainer_count", before)
        jflags.set_flag("trainer_count", jbefore)
        paddle.init(use_tpu=False)
        # init made the CPU the default device: give the next test of
        # this process the default it had
        place.set_default_device(device)


def test_parallelism_must_be_a_data_parallel():
    cost, _, topology, _ = torch_dp.build("flagship", paddle)
    from paddle_tpu_torch.parameters import Parameters

    with pytest.raises(EnforceError, match="takes a paddle_tpu_torch"
                       ".parallel.DataParallel"):
        paddle.trainer.SGD(cost, Parameters.create(topology, device="cpu"),
                           paddle.optimizer.Momentum(), device="cpu",
                           parallelism=object())


# -- the launcher and cli cluster_train ----------------------------------------

CONFIG = (
    "import numpy as np\n"
    "import paddle_tpu_torch as paddle\n"
    "from paddle_tpu_torch import layer as L, data_type as dt\n"
    "from paddle_tpu_torch import activation as A, optimizer as opt\n"
    "batch_size = 16\n"
    "def cost():\n"
    "    x = L.data(name='x', type=dt.dense_vector(6))\n"
    "    y = L.data(name='y', type=dt.integer_value(3))\n"
    "    h = L.fc(input=x, size=12, act=A.Tanh())\n"
    "    out = L.fc(input=h, size=3)\n"
    "    return L.classification_cost(input=out, label=y)\n"
    "def optimizer():\n"
    "    return opt.Momentum(learning_rate=0.1, momentum=0.9)\n"
    "def train_reader():\n"
    "    def reader():\n"
    "        rng = np.random.RandomState(0)\n"
    "        W = rng.randn(6, 3)\n"
    "        for _ in range(96):\n"
    "            x = rng.randn(6).astype(np.float32)\n"
    "            yield x, int(np.argmax(x @ W))\n"
    "    return reader\n")


def _check_results(results):
    assert len(results) == 2
    assert [r["process_id"] for r in results] == [0, 1]
    for r in results:
        assert r["processes"] == r["global_devices"] == 2
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["final_cost"] < r["first_cost"]
    assert results[0]["final_cost"] == results[1]["final_cost"]


def test_cluster_launcher_two_workers(tmp_path):
    from paddle_tpu_torch.distributed.launcher import launch_local_cluster

    config = tmp_path / "cfg.py"
    config.write_text(CONFIG)
    _check_results(launch_local_cluster(
        str(config), num_processes=2, num_passes=2, env=_env(),
        timeout=SPAWN_TIMEOUT, use_tpu=False))
    # two local replicas a worker: four global devices
    results = launch_local_cluster(str(config), 2, devices_per_process=2,
                                   env=_env(), timeout=SPAWN_TIMEOUT,
                                   use_tpu=False)
    assert [r["global_devices"] for r in results] == [4, 4]
    assert results[0]["final_cost"] == results[1]["final_cost"]
    assert results[0]["final_cost"] < results[0]["first_cost"]


def test_cli_cluster_train_two_workers(tmp_path, capsys, monkeypatch):
    import functools

    from paddle_tpu_torch import cli
    from paddle_tpu_torch.distributed import launcher

    # the launch under the spawns' own bound, not the CLI's 900 s default
    monkeypatch.setattr(launcher, "launch_local_cluster", functools.partial(
        launcher.launch_local_cluster, timeout=SPAWN_TIMEOUT))
    config = tmp_path / "cfg.py"
    config.write_text(CONFIG)
    for key, value in _env().items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    assert cli.main(["cluster_train", "--config", str(config),
                     "--num-processes", "2", "--num-passes", "2",
                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    _check_results([json.loads(line) for line in lines[-2:]])


def test_a_failing_worker_ends_the_launch(tmp_path):
    from paddle_tpu_torch.distributed.launcher import launch_local_cluster

    config = tmp_path / "bad.py"
    config.write_text(CONFIG.replace("    return opt.Momentum",
                                     "    raise ValueError('no optimizer')"
                                     "\n    return opt.Momentum"))
    with pytest.raises(RuntimeError, match="(?s)cluster launch failed.*no "
                       "optimizer"):
        launch_local_cluster(str(config), num_processes=2, env=_env(),
                             timeout=SPAWN_TIMEOUT, use_tpu=False)
