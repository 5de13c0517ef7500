"""Durable checkpoints across the two packages, on the CPU.

The small 2-layer LSTM classifier (its biases and output layer pooled by
ParamPool in both packages) trained with Adam:

- JAX trains 2 steps and checkpoints; the port resumes from that
  directory and trains 2 more; the result is within 1e-5 of JAX's 4
  uninterrupted steps (float32 in different summation orders; the JAX
  threefry key does not carry across, and this network draws none).
- A port checkpoint verifies and loads with the JAX package's
  ``load_checkpoint``, with the same optimizer-state keys as a JAX
  checkpoint of the same model, and the JAX trainer restores it and
  trains on to the port's own result (1e-5).
- A torn checkpoint is skipped for the previous good one, a half-written
  one is ignored, and ``keep`` prunes, as in the JAX package.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.models.text import text_classification_lstm as jax_model
from paddle_tpu.parameters import Parameters as JaxParameters

import paddle_tpu_torch as paddle
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.models.text import text_classification_lstm
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.topology import Topology

SMALL = dict(dict_size=30, emb_size=8, hidden=16, num_classes=2,
             num_layers=2)
TOL = 1e-5


def _batches(seed=0, n=4, rows=4):
    rng = np.random.RandomState(seed)
    return [[(rng.randint(0, 30, int(k)).tolist(), int(rng.randint(0, 2)))
             for k in rng.randint(1, 14, rows)] for _ in range(n)]


def _cost(pkg, jax_side):
    (jax_reset_names if jax_side else reset_name_counters)()
    out = (jax_model if jax_side else text_classification_lstm)(**SMALL)
    label = pkg.layer.data(name="label", type=pkg.data_type.integer_value(2))
    return pkg.layer.classification_cost(input=out, label=label)


def _init():
    topo = Topology(_cost(paddle, False))
    rng = np.random.RandomState(1)
    return {n: (rng.standard_normal(s.shape) * 0.3).astype(np.float32)
            for n, s in sorted(topo.param_specs().items())}


def _trainer(pkg, jax_side, init):
    cost = _cost(pkg, jax_side)
    if jax_side:
        params = JaxParameters.create(cost)
        for k, v in init.items():
            params.set(k, v)
        return pkg.trainer.SGD(cost, params,
                               pkg.optimizer.Adam(learning_rate=1e-2))
    params = Parameters({k: torch.from_numpy(v.copy())
                         for k, v in init.items()},
                        Topology(cost).param_specs())
    return pkg.trainer.SGD(cost, params, pkg.optimizer.Adam(
        learning_rate=1e-2), device="cpu")


def _reader(batches):
    return lambda: iter(batches)


def _values(trainer):
    trainer._sync_back()
    return {n: np.asarray(trainer.parameters.get(n))
            for n in trainer.parameters.names()}


def _close(a, b, tol=TOL):
    assert sorted(a) == sorted(b)
    for n in a:
        np.testing.assert_allclose(a[n], b[n], rtol=tol, atol=tol,
                                   err_msg=n)


def _keep_only(directory, name):
    for d in os.listdir(directory):
        if d != name:
            shutil.rmtree(os.path.join(directory, d))


def test_port_resumes_a_jax_checkpoint(tmp_path):
    init, batches = _init(), _batches()
    full = _trainer(jpaddle, True, init)
    full.train(_reader(batches))
    jdir = str(tmp_path / "jax")
    first = _trainer(jpaddle, True, init)
    first.train(_reader(batches), checkpoint_dir=jdir, checkpoint_every=2,
                checkpoint_sync=True)
    _keep_only(jdir, "pass-00000-step-00000002")
    port = _trainer(paddle, False, init)
    assert port._pool is not None and full._pool is not None
    costs = []
    port.train(_reader(batches), checkpoint_dir=jdir, resume=True,
               event_handler=lambda e: costs.append(e.batch_id)
               if isinstance(e, paddle.event.EndIteration) else None)
    assert costs == [2, 3] and port._step_count == 4
    _close(_values(port), _values(full))
    assert int(port._opt_state["step"]) == 4


def test_jax_loads_and_continues_a_port_checkpoint(tmp_path):
    init, batches = _init(), _batches(2)
    full = _trainer(paddle, False, init)
    full.train(_reader(batches))
    pdir = str(tmp_path / "port")
    port = _trainer(paddle, False, init)
    port.train(_reader(batches[:2]))
    path = port.save_checkpoint(pdir, resume_at=(0, 2))
    assert os.path.basename(path) == "pass-00000-step-00000002"
    ok, reason = jckpt.verify_checkpoint(path)
    assert ok, reason
    params, opt_flat, meta = jckpt.load_checkpoint(path)
    assert meta["format"] == "paddle_tpu-checkpoint-v1"
    assert meta["extra"]["trainer_state"]["pass_cursor"] == 2
    assert meta["extra"]["trainer_state"]["rng_kind"] == ckpt.RNG_KIND
    port._sync_back()
    for n in params.names():
        np.testing.assert_array_equal(params.get(n), port.parameters.get(n))
    # the same keys as the JAX package's own checkpoint of this model
    jtr = _trainer(jpaddle, True, init)
    jtr.train(_reader(batches[:2]))
    jpath = jtr.save_checkpoint(str(tmp_path / "jax"))
    _, jflat, _ = jckpt.load_checkpoint(jpath)
    assert sorted(opt_flat) == sorted(jflat)
    for k in jflat:
        assert opt_flat[k].shape == jflat[k].shape, k
        assert opt_flat[k].dtype == jflat[k].dtype, k
        np.testing.assert_allclose(opt_flat[k], jflat[k], rtol=TOL,
                                   atol=TOL, err_msg=k)
    # the JAX trainer restores it and trains the remaining 2 batches
    cont = _trainer(jpaddle, True, init)
    cont.restore_checkpoint(pdir)
    cont.train(_reader(batches[2:]))
    _close(_values(cont), _values(full))


def test_port_checkpoint_round_trip_keeps_the_trainer_state(tmp_path):
    """restore_checkpoint writes into the live tensors: the pooled masters,
    the Adam slots (per-name on disk, pooled in the trainer) and the step
    count come back exactly."""
    init, batches = _init(), _batches(3)
    a = _trainer(paddle, False, init)
    a.train(_reader(batches))
    path = a.save_checkpoint(str(tmp_path / "c"), resume_at=(1, 0))
    b = _trainer(paddle, False, _init())
    flat_before = b._pool_flat
    meta = b.restore_checkpoint(path)
    assert meta["step"] == 4 and b._step_count == 4
    assert b._pool_flat is flat_before
    assert torch.equal(b._pool_flat, a._pool_flat)
    for x, y in zip(b._mutable_tensors(), a._mutable_tensors()):
        assert torch.equal(x, y)


def test_torn_and_half_written_checkpoints_fall_back(tmp_path):
    init = _init()
    tr = _trainer(paddle, False, init)
    tr.train(_reader(_batches(4)))
    d = str(tmp_path / "c")
    first = tr.save_checkpoint(d, pass_id=0)
    tr._step_count += 1
    second = tr.save_checkpoint(d, pass_id=0)
    assert ckpt.latest_checkpoint(d) == second == jckpt.latest_checkpoint(d)
    with open(os.path.join(second, "parameters.tar"), "r+b") as f:
        f.truncate(100)  # torn payload
    ok, reason = ckpt.verify_checkpoint(second)
    assert not ok and "parameters.tar" in reason
    assert ckpt.latest_checkpoint(d) == first == jckpt.latest_checkpoint(d)
    half = os.path.join(d, "pass-00000-step-99999999")
    os.makedirs(half)  # no meta.json
    assert ckpt.verify_checkpoint(half)[0] is False
    assert ckpt.latest_checkpoint(d) == first == jckpt.latest_checkpoint(d)
    with pytest.raises(Exception, match="integrity"):
        ckpt.load_checkpoint(second)


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_keep_prunes_as_jax_does(tmp_path, keep):
    init = _init()
    names = {}
    for pkg, jax_side in ((jpaddle, True), (paddle, False)):
        tr = _trainer(pkg, jax_side, init)
        d = str(tmp_path / pkg.__name__)
        tr.train(_reader(_batches(5, n=6)), checkpoint_dir=d,
                 checkpoint_every=1, checkpoint_keep=keep,
                 checkpoint_sync=True)
        names[jax_side] = sorted(os.listdir(d))
    assert names[True] == names[False]
    assert len(names[False]) == keep
    assert names[False][-1] == "pass-00000-step-00000006"


def test_overlapped_save_reports_its_share_and_commits(tmp_path):
    """The overlapped save hands a snapshot to the ckpt-writer thread; the
    committed checkpoint equals a blocking save of the same step."""
    init, batches = _init(), _batches(6, n=3)
    tr = _trainer(paddle, False, init)
    d = str(tmp_path / "async")
    tr.train(_reader(batches), checkpoint_dir=d, checkpoint_every=3)
    assert [r["overlapped"] for r in tr.checkpoint_log] == [True]
    assert tr.checkpoint_log[-1]["bytes"] > 0
    async_path = os.path.join(d, "pass-00000-step-00000003")
    sync_path = tr.save_checkpoint(str(tmp_path / "sync"))
    pa, oa, _ = ckpt.load_checkpoint(async_path)
    ps, osync, _ = ckpt.load_checkpoint(sync_path)
    for n in ps.names():
        np.testing.assert_array_equal(pa.get(n), ps.get(n))
    assert sorted(oa) == sorted(osync)
    for k in osync:
        np.testing.assert_array_equal(oa[k], osync[k])
