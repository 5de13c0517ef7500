"""One process driving several devices (the reference's
MultiGradientMachine; ``build_mesh(devices=[...])``, ``cli train
--trainer-count N``, ``launch_local_cluster(devices_per_process=k)``)
against the port's one process and the JAX package on its virtual CPU
devices (tests/conftest.py sets up 8), on the CPU.

- Four local replicas of each case of the data-parallel rig
  (tests/torch_dp.py: the flagship at hidden 32, a conv + train-mode
  batch norm net, an uneven split of 7, 7 and 1 rows over 4 replicas so
  that replicas hold none, the fused loop with the pipelined feed): costs
  and parameters (the moving statistics included) within 1e-6 of max(1,
  max |.|) of the port's one process, within 1e-5 of JAX's trainer over
  ``build_mesh({"data": 4}, devices=jax.devices()[:4])`` from the same
  numpy parameters; the classification error (additive, summed in the
  step) equal, the label probe (non-additive, kept per replica) the
  single process's rows in order, and the replicas bit for bit equal.
- The mesh over local devices: its layout, the axis refusal, the
  ``PADDLE_TPU_TORCH_VIRTUAL_DEVICES`` count and devices, the refusals of
  train-mode batch norm over replicas sharing a card and of
  ``steps_per_call`` with local replicas on the card.
- ``launch_local_cluster(..., devices_per_process=2)`` in both packages
  on one config (its weights from numpy seeds, so both start alike):
  ``global_devices == 4`` and the final costs within 1e-5.
- ``cli train --trainer-count 4`` of both CLIs (JAX's
  tests/test_cli.py:154 run, on 4 of the 8 virtual devices; the port's
  with ``PADDLE_TPU_TORCH_VIRTUAL_DEVICES=4``) from one JAX checkpoint:
  every step's cost within 1e-5, and the same costs as one process.
"""

import os

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jpaddle
from paddle_tpu import cli as jcli
from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.parallel.mesh import DataParallel as JaxDataParallel
from paddle_tpu.parallel.mesh import build_mesh as jax_mesh
from paddle_tpu.utils import flags as jflags

import paddle_tpu_torch as paddle
from paddle_tpu_torch import cli
from paddle_tpu_torch.parallel import DataParallel, build_mesh
from paddle_tpu_torch.parallel import mesh as mesh_mod
from paddle_tpu_torch.utils import flags
from paddle_tpu_torch.utils.error import EnforceError
from tests import torch_dp
from tests.test_torch_cli import _jax_checkpoint, _write_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPLICAS = 4
TOL_ONE = 1e-6
TOL_JAX = 1e-5


def _rel(got, want):
    scale = max(1.0, max(float(np.abs(v).max()) for v in want.values()))
    return max(float(np.abs(np.asarray(got[n]) - np.asarray(want[n])).max())
               for n in want) / scale


def _replicas_mesh(n=REPLICAS):
    return build_mesh({"data": n}, devices=["cpu"] * n)


@pytest.mark.parametrize("case", torch_dp.CASES)
def test_local_replicas_match_one_process_and_jax(case):
    kept = []
    costs, errors, params, labels = torch_dp.port_run(
        case, parallelism=DataParallel(_replicas_mesh()), keep=kept)
    one_costs, one_errors, one_params, one_labels = torch_dp.port_run(case)
    jcosts, jerrors, jparams = torch_dp.jax_run(
        case, parallelism=JaxDataParallel(jax_mesh(
            {"data": REPLICAS}, devices=jax.devices()[:REPLICAS])))
    assert sorted(params) == sorted(one_params) == sorted(jparams)
    for want_costs, want, tol in ((one_costs, one_params, TOL_ONE),
                                  (jcosts, jparams, TOL_JAX)):
        assert np.abs(costs - want_costs).max() \
            / max(1.0, float(np.abs(want_costs).max())) <= tol
        assert _rel(params, want) <= tol
    # the additive evaluator: the same counts over the global batch
    np.testing.assert_array_equal(errors, one_errors)
    np.testing.assert_array_equal(errors, jerrors)
    # the non-additive one: every live replica's rows, in replica order
    np.testing.assert_array_equal(labels, one_labels)
    trainer = kept[0]
    held = [trainer._mutable_tensors(rep) for rep in trainer._replicas]
    assert len(held) == REPLICAS
    for other in held[1:]:
        assert all(torch.equal(a, b) for a, b in zip(held[0], other))


def test_uneven_shares_are_those_of_the_jax_batch_sharding():
    dp = DataParallel(_replicas_mesh())
    assert dp.replicas == REPLICAS and dp.world == REPLICAS
    assert [dp.share(7, i) for i in range(REPLICAS)] == \
        [(0, 2), (2, 4), (4, 6), (6, 7)]
    feed = {"x": torch.arange(7.0).reshape(7, 1)}
    parts, shares = dp.shard_batch(feed, device="cpu")
    assert shares == tuple((n, 7) for n in (2, 2, 2, 1))
    assert [p["x"].shape[0] for p in parts] == [2, 2, 2, 1]
    # a replica with no row borrows the first, weighted 0
    parts, shares = dp.shard_batch({"x": feed["x"][:1]})
    assert shares == ((1, 1), (0, 1), (0, 1), (0, 1))
    assert all(p["x"].shape[0] == 1 for p in parts)


def test_mesh_over_local_devices():
    mesh = _replicas_mesh()
    assert mesh.shape == {"data": 4} and mesh.devices == [0, 1, 2, 3]
    assert mesh.replicas == 4 and mesh.local_devices == \
        [torch.device("cpu")] * 4
    ax = mesh.axis("data", replicas=True)
    assert (ax.size, ax.index, ax.replicas, ax.group) == (4, 0, 4, None)
    with pytest.raises(EnforceError, match="spans this process's 4 local "
                       "replicas"):
        mesh.axis("data")
    two = build_mesh({"model": 1, "data": 2}, devices=["cpu", "cpu"])
    assert two.axis("model").size == 1 and two.replicas == 2
    with pytest.raises(EnforceError, match="lie on its last axis"):
        DataParallel(two, axis="model")
    with pytest.raises(EnforceError, match="must divide"):
        build_mesh({"model": 2, "data": 1}, devices=["cpu"] * 2)
    with pytest.raises(EnforceError, match="needs 4 devices, have 2"):
        build_mesh({"data": 4}, devices=["cpu"] * 2)


def test_virtual_devices_name_replicas_round_robin(monkeypatch):
    monkeypatch.delenv(mesh_mod.VIRTUAL_DEVICES_ENV, raising=False)
    assert mesh_mod.local_device_count() == 1  # no card here
    assert mesh_mod.device_count() == 1
    monkeypatch.setenv(mesh_mod.VIRTUAL_DEVICES_ENV, "3")
    assert mesh_mod.local_device_count() == mesh_mod.device_count() == 3
    assert mesh_mod.local_devices(device="cpu") == [torch.device("cpu")] * 3
    # the card's devices: round-robin over the visible cards
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh_mod.local_devices(5, device=torch.device("cuda"),
                                  first=2) == [
        torch.device("cuda", i) for i in (0, 1, 0, 1, 0)]
    monkeypatch.setenv(mesh_mod.VIRTUAL_DEVICES_ENV, "zero")
    with pytest.raises(EnforceError, match="a device count"):
        mesh_mod.local_device_count()


def test_refusals_on_the_card(monkeypatch):
    """Train-mode batch norm over replicas that share a card (their
    backward passes would wait on each other on one autograd thread), and
    steps_per_call with local replicas on the card, are refused by
    name."""
    cost, _, topology, _ = torch_dp.build("flagship", paddle)
    from paddle_tpu_torch.parameters import Parameters

    dp = DataParallel(_replicas_mesh(2))
    assert not dp.shares_card() and dp.capturable(torch.device("cpu"))
    assert not dp.capturable(torch.device("cuda"))
    trainer = paddle.trainer.SGD(
        cost, Parameters.create(topology, device="cpu"),
        paddle.optimizer.Momentum(learning_rate=0.1), parallelism=dp,
        device="cpu")
    trainer.device = torch.device("cuda")  # as a trainer on the card
    with pytest.raises(EnforceError, match="with 2 local replicas on the "
                       "card"):
        trainer.train(lambda: iter(torch_dp.batches("flagship")),
                      steps_per_call=2)
    card = DataParallel(_replicas_mesh(2))
    card.devices = [torch.device("cuda", 0)] * 2
    assert card.shares_card()
    with card.batch_scope(True):
        with pytest.raises(EnforceError, match="share a card"):
            mesh_mod.batch_reducer()(torch.ones(3))


# -- the launcher and the CLI against JAX's ----------------------------------

SEEDED_CONFIG = '''
import numpy as np
import %(pkg)s as paddle
from %(pkg)s import layer as L, data_type as dt, activation as A
from %(pkg)s import optimizer as opt
from %(pkg)s.attr import ParamAttr

batch_size = 16


class Seeded:
    """Weights from a numpy seed, in either package's initializer form."""

    def __init__(self, seed):
        self.seed = seed

    def __call__(self, *args):
        value = (np.random.RandomState(self.seed).standard_normal(
            tuple(args[1])) * 0.3).astype(np.float32)
        if len(args) == 4:  # the port's (generator, shape, dtype, device)
            import torch
            return torch.from_numpy(value).to(args[3])
        import jax.numpy as jnp
        return jnp.asarray(value)


def cost():
    x = L.data(name='x', type=dt.dense_vector(6))
    y = L.data(name='y', type=dt.integer_value(3))
    h = L.fc(input=x, size=12, act=A.Tanh(),
             param_attr=ParamAttr(initializer=Seeded(1)),
             bias_attr=ParamAttr(initializer=Seeded(2)))
    out = L.fc(input=h, size=3, param_attr=ParamAttr(initializer=Seeded(3)),
               bias_attr=ParamAttr(initializer=Seeded(4)))
    return L.classification_cost(input=out, label=y)


def optimizer():
    return opt.Momentum(learning_rate=0.1, momentum=0.9)


def train_reader():
    def reader():
        rng = np.random.RandomState(0)
        W = rng.randn(6, 3)
        for _ in range(96):
            x = rng.randn(6).astype(np.float32)
            yield x, int(np.argmax(x @ W))
    return reader
'''


def test_launch_local_cluster_devices_per_process_matches_jax(tmp_path):
    """tests/test_multihost.py:150's launch with two devices a process:
    four global devices on both sides, the same final cost."""
    from paddle_tpu.distributed.launcher import \
        launch_local_cluster as jax_launch
    from paddle_tpu_torch.distributed.launcher import launch_local_cluster

    results = {}
    for pkg, launch, extra in (
            ("paddle_tpu", jax_launch, {"JAX_PLATFORMS": "cpu"}),
            ("paddle_tpu_torch", launch_local_cluster, {})):
        conf = tmp_path / ("%s_conf.py" % pkg)
        conf.write_text(SEEDED_CONFIG % {"pkg": pkg})
        kw = {"use_tpu": False} if pkg == "paddle_tpu_torch" else {}
        results[pkg] = launch(
            str(conf), num_processes=2, num_passes=2, timeout=240,
            devices_per_process=2,
            env=dict(extra, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                     PADDLE_TPU_LOG_LEVEL="WARNING"), **kw)
    for pkg, got in results.items():
        assert [r["process_id"] for r in got] == [0, 1], pkg
        for r in got:
            assert r["processes"] == 2 and r["global_devices"] == 4, pkg
            assert r["final_cost"] < r["first_cost"], pkg
    port, jax_ = results["paddle_tpu_torch"], results["paddle_tpu"]
    assert port[0]["backend"] == "gloo" and port[0]["device"] == "cpu"
    assert port[0]["final_cost"] == port[1]["final_cost"]
    assert abs(port[0]["first_cost"] - jax_[0]["first_cost"]) <= TOL_JAX
    assert abs(port[0]["final_cost"] - jax_[0]["final_cost"]) <= TOL_JAX


RANK_BUILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import paddle_tpu_torch as paddle
paddle.init(use_tpu=False)
from paddle_tpu_torch import cli
from paddle_tpu_torch.distributed.multihost import initialize_multihost
from paddle_tpu_torch.utils import flags
initialize_multihost(coordinator_address=sys.argv[2], num_processes=2,
                     process_id=int(sys.argv[3]))
cfg = cli._load_config(sys.argv[4])
flags.set_flag("trainer_count", 4)
dp = cli._build(cfg, device="cpu")[2].parallelism
out = {"mesh": [dp.mesh.size, dp.replicas, dp.world, dp.rank]}
flags.set_flag("trainer_count", 8)
try:
    cli._build(cfg, device="cpu")
except SystemExit as exc:
    out["exit"] = str(exc)
print(json.dumps(out))
"""


def test_trainer_count_in_a_group_of_replica_ranks(tmp_path):
    """``--trainer-count N`` inside a process group of two ranks with two
    replicas each (``PADDLE_TPU_TORCH_VIRTUAL_DEVICES=2``, as a worker of
    ``--devices-per-process 2`` runs): the check and the mesh agree on
    four devices, 4 builds the mesh over every rank's replicas, 8 exits
    with the message."""
    import json
    import socket
    import subprocess
    import sys

    conf = tmp_path / "conf.py"
    conf.write_text(SEEDED_CONFIG % {"pkg": "paddle_tpu_torch"})
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PADDLE_TPU_LOG_LEVEL="WARNING")
    env[mesh_mod.VIRTUAL_DEVICES_ENV] = "2"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_BUILD, ROOT, "127.0.0.1:%d" % port,
         str(r), str(conf)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert [g["mesh"] for g in got] == [[4, 2, 4, 0], [4, 2, 4, 2]]
    for g in got:
        assert g["exit"] == ("--trainer-count 8 exceeds the 4 devices of "
                             "the process group's ranks")


def _recording(monkeypatch, sgd, event_mod, sink):
    """Record every EndIteration cost of ``sgd.train`` into the list
    ``sink[0]``."""
    real = sgd.train

    def train(self, reader, num_passes=1, event_handler=None, **kw):
        def handler(evt):
            if isinstance(evt, event_mod.EndIteration):
                sink[0].append(float(evt.cost))
            if event_handler is not None:
                event_handler(evt)

        return real(self, reader, num_passes=num_passes,
                    event_handler=handler, **kw)

    monkeypatch.setattr(sgd, "train", train)


def test_cli_train_trainer_count_matches_jax_cli(tmp_path, monkeypatch,
                                                 capsys):
    """Both CLIs train the v1 flagship-form config (2 x simple_lstm) for a
    pass from one JAX checkpoint with --trainer-count 4: JAX over 4
    virtual CPU devices, the port over 4 local replicas named by
    PADDLE_TPU_TORCH_VIRTUAL_DEVICES; every step's cost within 1e-5, and
    within 1e-6 of the port's one process. Without the variable the count
    exceeds the visible devices."""
    conf, _ = _write_config(tmp_path, "cfg_tc")
    init = _jax_checkpoint(conf, str(tmp_path / "init"))
    common = ["--config", conf, "--config-args", "hidden_size=16",
              "--init-model", init, "--num-passes", "1"]
    runs = {"jax": [], "port": [], "one": []}
    before, jbefore = flags.get_flag("trainer_count"), \
        jflags.get_flag("trainer_count")
    sink = [runs["jax"]]
    try:
        _recording(monkeypatch, jpaddle.trainer.SGD, jpaddle.event, sink)
        _recording(monkeypatch, paddle.trainer.SGD, paddle.event, sink)
        jax_reset_names()
        assert jcli.main(["train", *common, "--trainer-count",
                          str(REPLICAS)]) == 0
        built = []
        build = cli._build
        monkeypatch.setattr(cli, "_build", lambda *a, **k: built.append(
            build(*a, **k)) or built[-1])
        monkeypatch.delenv(mesh_mod.VIRTUAL_DEVICES_ENV, raising=False)
        with pytest.raises(SystemExit, match="--trainer-count 4 exceeds "
                           "the 1 visible devices"):
            cli.main(["train", *common, "--device", "cpu",
                      "--trainer-count", str(REPLICAS)])
        monkeypatch.setenv(mesh_mod.VIRTUAL_DEVICES_ENV, str(REPLICAS))
        for name, extra in (("port", ["--trainer-count", str(REPLICAS)]),
                            ("one", ["--trainer-count", "1"])):
            sink[0] = runs[name]
            assert cli.main(["train", *common, "--device", "cpu",
                             *extra]) == 0
    finally:
        flags.set_flag("trainer_count", before)
        jflags.set_flag("trainer_count", jbefore)
    capsys.readouterr()
    dp = built[-2][2].parallelism
    assert dp.replicas == REPLICAS and built[-1][2].parallelism is None
    assert len(runs["port"]) == len(runs["jax"]) == len(runs["one"]) == 3
    np.testing.assert_allclose(runs["port"], runs["jax"], rtol=0,
                               atol=TOL_JAX)
    np.testing.assert_allclose(runs["port"], runs["one"], rtol=0,
                               atol=TOL_ONE)
