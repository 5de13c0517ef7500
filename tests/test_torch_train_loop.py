"""The port's training loop against the JAX package's, on the CPU.

- Bucketing (``data/bucketing.py``): ``rebucket_batches`` (explicit and
  derived boundaries, ``batch_size``, ``sample_window``,
  ``drop_remainder``, the geometric top bucket), ``derive_buckets``,
  ``bucket_for``, ``batch_waste`` and ``topology_length_of`` give exactly
  the JAX package's output for the same reader; packing raises.
- The feeder (``data/feeder.py``): ``DeviceFeeder.batches`` equals the
  synchronous ``convert_feed``; ``chunks`` makes the JAX feeder's chunk
  sizes and splits on the same stream; an abandoned consumer cancels the
  producer; a producer error is re-raised on the consumer; ``skip``
  drops the resume prefix.
- The trainer with ``feed_pipeline``, ``buckets`` and ``steps_per_call=4``
  (a partial final chunk and one-batch chunks included) on the small
  2-layer LSTM classifier with an evaluator: the same event stream as the
  JAX trainer's (types, pass and batch ids), costs within 1e-5 (float32
  in different summation orders, compounded over 10 Adam steps),
  evaluator metrics, and K=4 equal to K=1 exactly.
- Checkpoints under the fused loop: a resumed run equals the
  uninterrupted one exactly.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.data import bucketing as jbucketing
from paddle_tpu.data.feeder import DeviceFeeder as JaxDeviceFeeder
from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.models.text import text_classification_lstm as jax_model
from paddle_tpu.parameters import Parameters as JaxParameters

import paddle_tpu_torch as paddle
from paddle_tpu_torch.data import bucketing
from paddle_tpu_torch.data.feeder import DeviceFeeder, feed_tensors
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.models.text import text_classification_lstm
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.topology import Topology, convert_feed

SMALL = dict(dict_size=40, emb_size=8, hidden=16, num_classes=3,
             num_layers=2)
TOL = 1e-5


def _samples(seed=0, n=40, lo=1, hi=40):
    """(ids, label) samples with lengths uniform in [lo, hi]."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, SMALL["dict_size"], int(k)).tolist(),
             int(rng.randint(0, SMALL["num_classes"])))
            for k in rng.randint(lo, hi + 1, n)]


def _batched(pkg, samples, size):
    return pkg.batch(lambda: iter(samples), size)


def _rows(batches):
    return [(list(b), getattr(b, "bucket", None)) for b in batches]


# -- bucketing ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"buckets": [8, 16, 40]},
    {"buckets": [8, 16, 40], "drop_remainder": True},
    {"buckets": [8, 16], "batch_size": 3},
    {"buckets": None},
    {"buckets": None, "sample_window": 7},
], ids=["explicit", "drop_remainder", "grow_top", "derived", "window7"])
def test_rebucket_batches_equals_jax(kw):
    samples = _samples(1, n=45)
    want = _rows(jbucketing.rebucket_batches(
        _batched(jpaddle, samples, 4), **kw)())
    got = _rows(bucketing.rebucket_batches(
        _batched(paddle, samples, 4), **kw)())
    assert got == want and len(got) > 3


def test_bucket_helpers_equal_jax():
    rng = np.random.RandomState(3)
    lengths = rng.randint(1, 300, 200)
    for mb, mult in ((8, 8), (3, 16), (1, 0)):
        assert bucketing.derive_buckets(lengths, mb, mult) == \
            jbucketing.derive_buckets(lengths, mb, mult)
    sizes = [8, 16, 64]
    for v in (1, 8, 9, 64):
        assert bucketing.bucket_for(v, sizes) == \
            jbucketing.bucket_for(v, sizes)
    with pytest.raises(ValueError):
        bucketing.bucket_for(65, sizes)
    batch = _samples(4, n=6)
    assert bucketing.batch_waste(batch, 40) == \
        jbucketing.batch_waste(batch, 40)
    jax_reset_names()
    jx = jpaddle.layer.data(name="f", type=jpaddle.data_type.dense_vector(9))
    jw = jpaddle.layer.data(
        name="w", type=jpaddle.data_type.integer_value_sequence(5))
    reset_name_counters()
    x = paddle.layer.data(name="f", type=paddle.data_type.dense_vector(9))
    w = paddle.layer.data(name="w",
                          type=paddle.data_type.integer_value_sequence(5))
    sample = (np.zeros(9, np.float32), [1, 2, 3])
    jlen = jbucketing.topology_length_of(
        jpaddle.topology.Topology([jx, jw]))(sample)
    assert bucketing.topology_length_of(Topology([x, w]))(sample) == jlen \
        == 3
    # the packing helpers are ported (tests/test_torch_packing.py holds
    # them); first-fit packing as in the JAX package
    lens = rng.randint(1, 40, 50)
    samples = [(list(range(int(n))),) for n in lens]
    assert bucketing.pack_samples(samples, 64) == \
        jbucketing.pack_samples(samples, 64)


# -- the feeder --------------------------------------------------------------

def _topologies():
    jax_reset_names()
    jout = jax_model(**SMALL)
    reset_name_counters()
    out = text_classification_lstm(**SMALL)
    return jpaddle.topology.Topology(jout), Topology(out)


def test_feeder_matches_sync_conversion():
    _, topo = _topologies()
    batches = list(bucketing.rebucket_batches(
        _batched(paddle, _samples(2), 4), buckets=[16, 40])())
    feeder = DeviceFeeder(lambda: iter(batches), topo, depth=2,
                          device="cpu")
    got = list(feeder.batches())
    assert len(got) == len(batches)
    for fb, batch in zip(got, batches):
        want = convert_feed(topo, batch, device="cpu", max_len=batch.bucket)
        for a, b in zip(feed_tensors(fb.feed), feed_tensors(want)):
            assert torch.equal(a, b)
        assert fb.examples == len(batch) and fb.bucket == batch.bucket
        fill, pad = bucketing.batch_waste(batch, batch.bucket)
        assert (fb.fill_tokens, fb.pad_tokens) == (fill, pad)
        assert fb.convert_ms >= 0 and fb.stall_ms >= 0
    skipped = list(feeder.batches(skip=2))
    assert len(skipped) == len(batches) - 2
    assert torch.equal(skipped[0].feed["word"].data,
                       got[2].feed["word"].data)


@pytest.mark.parametrize("k,bucketed", [(4, False), (4, True), (3, True),
                                        (1, True)])
def test_chunks_split_as_jax_does(k, bucketed):
    """The same stream chunks the same way: a chunk closes at K, at a
    feed-shape boundary (the padded length changes without buckets) and
    at the end; a one-batch chunk is not stacked."""
    jtopo, topo = _topologies()
    samples = _samples(5, n=60)

    def stream(pkg, bmod):
        reader = _batched(pkg, samples, 4)
        if bucketed:
            reader = bmod.rebucket_batches(reader, buckets=[16, 32, 40])
        return reader

    jchunks = JaxDeviceFeeder(stream(jpaddle, jbucketing), jtopo,
                              depth=2).chunks(k)
    want = [(c.steps, c.stacked) for c in jchunks]
    chunks = list(DeviceFeeder(stream(paddle, bucketing), topo, depth=2,
                               device="cpu").chunks(k))
    assert [(c.steps, c.stacked) for c in chunks] == want
    assert len(want) > 3
    for c in chunks:
        if c.stacked:
            assert len(c.feed) == c.steps


def test_feeder_propagates_reader_error():
    _, topo = _topologies()

    def bad_reader():
        yield [s for s in _samples(6, n=4)]
        raise ValueError("reader broke")

    feeder = DeviceFeeder(bad_reader, topo, device="cpu")
    it = feeder.batches()
    next(it)
    with pytest.raises(ValueError, match="reader broke"):
        next(it)


def test_abandoned_consumer_cancels_producer():
    _, topo = _topologies()
    samples = _samples(7, n=200)
    before = threading.active_count()
    feeder = DeviceFeeder(_batched(paddle, samples, 4), topo, depth=1,
                          device="cpu")
    gen = feeder.batches()
    next(gen)
    gen.close()  # producer blocked on the full queue must exit
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


# -- the trainer ---------------------------------------------------------------

def _numpy_params(topo, seed=0):
    rng = np.random.RandomState(seed)
    return {name: (rng.standard_normal(spec.shape) * 0.3).astype(np.float32)
            for name, spec in sorted(topo.param_specs().items())}


def _train(pkg, jax_side, samples, options, num_passes=1, np_params=None):
    """The small classifier with classification_error, trained with Adam;
    returns the event keys, costs, metrics and the Parameters."""
    (jax_reset_names if jax_side else reset_name_counters)()
    model = jax_model if jax_side else text_classification_lstm
    out = model(**SMALL)
    label = pkg.layer.data(name="label",
                           type=pkg.data_type.integer_value(3))
    cost = pkg.layer.classification_cost(input=out, label=label)
    err = pkg.evaluator.classification_error(input=out, label=label)
    if np_params is None:
        reset_name_counters()
        np_params = _numpy_params(Topology(paddle.layer.classification_cost(
            input=text_classification_lstm(**SMALL),
            label=paddle.layer.data(
                name="label", type=paddle.data_type.integer_value(3)))))
    if jax_side:
        params = JaxParameters.create(cost)
        for k, v in np_params.items():
            params.set(k, v)
        tr = pkg.trainer.SGD(cost, params, pkg.optimizer.Adam(
            learning_rate=1e-2), extra_layers=[err])
    else:
        params = Parameters({k: torch.from_numpy(v.copy())
                             for k, v in np_params.items()},
                            Topology(cost).param_specs())
        tr = pkg.trainer.SGD(cost, params, pkg.optimizer.Adam(
            learning_rate=1e-2), extra_layers=[err], device="cpu")
    events = []
    tr.train(_batched(pkg, samples, 4), num_passes=num_passes,
             event_handler=events.append, **options)
    keys = [(type(e).__name__, getattr(e, "pass_id", None),
             getattr(e, "batch_id", None)) for e in events]
    costs = [e.cost for e in events if type(e).__name__ == "EndIteration"]
    metrics = [sorted((e.metrics or {}).values()) for e in events
               if hasattr(e, "metrics")]
    return keys, costs, metrics, params


LOOP_OPTIONS = {
    "pipeline": {"feed_pipeline": True},
    "pipeline_depth3": {"feed_pipeline": 3},
    "buckets": {"buckets": [16, 40]},
    "buckets_auto": {"buckets": True},
    "fused4": {"steps_per_call": 4},
    "fused4_buckets": {"steps_per_call": 4, "buckets": [16, 40],
                       "feed_pipeline": 2},
}


@pytest.mark.parametrize("name", sorted(LOOP_OPTIONS))
def test_event_stream_matches_jax(name):
    """Event types and ids, costs (1e-5) and evaluator metrics equal the
    JAX trainer's: 10 batches a pass, 2 passes; under steps_per_call=4 a
    pass makes chunks of 4, 4 and 2, and bucketing adds shape boundaries
    and one-batch chunks."""
    samples = _samples(8, n=40, hi=30)
    options = LOOP_OPTIONS[name]
    jkeys, jcosts, jmetrics, jparams = _train(jpaddle, True, samples,
                                              options, num_passes=2)
    keys, costs, metrics, params = _train(paddle, False, samples, options,
                                          num_passes=2)
    assert keys == jkeys
    np.testing.assert_allclose(costs, jcosts, rtol=TOL, atol=TOL)
    assert len(metrics) == len(jmetrics)
    for got, want in zip(metrics, jmetrics):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for n in jparams.names():
        np.testing.assert_allclose(params.get(n), jparams.get(n), rtol=TOL,
                                   atol=TOL, err_msg=n)


def test_fused_k4_equals_k1_exactly():
    """On the CPU the fused loop runs the same step function, so K=4 (with
    buckets: stacked chunks, a partial final chunk and one-batch chunks)
    gives the per-step run's costs and parameters bit for bit."""
    samples = _samples(9, n=44, hi=30)
    runs = [_train(paddle, False, samples, dict(opts, buckets=[16, 40]))
            for opts in ({}, {"steps_per_call": 1}, {"steps_per_call": 4})]
    (keys0, costs0, metrics0, p0) = runs[0]
    assert runs[1][0] == keys0  # K=1 keeps the per-step event order
    for keys, costs, metrics, p in runs[1:]:
        # a chunk announces its K steps before its dispatch: the same
        # events, BeginIterations earlier
        assert sorted(keys) == sorted(keys0)
        assert costs == costs0 and metrics == metrics0
        for n in p0.names():
            assert np.array_equal(p.get(n), p0.get(n)), n


@pytest.mark.parametrize("sync", [False, True], ids=["overlapped", "sync"])
def test_fused_resume_equals_uninterrupted(tmp_path, sync):
    """steps_per_call=4 with checkpoint_every=4: a fresh trainer resumed
    from the checkpoint at step 8 (pass 0, cursor 8) trains the rest of
    pass 0 and pass 1 to the uninterrupted run's parameters exactly, and
    emits that run's events for the steps it trains."""
    samples = _samples(10, n=40, hi=30)
    opts = {"steps_per_call": 4, "checkpoint_dir": str(tmp_path / "c"),
            "checkpoint_every": 4, "checkpoint_sync": sync,
            "checkpoint_keep": 5}
    keys, costs, _, full = _train(paddle, False, samples, opts,
                                  num_passes=2)
    # keep only the step-8 checkpoint and resume from it
    import os
    import shutil

    for d in os.listdir(tmp_path / "c"):
        if d != "pass-00000-step-00000008":
            shutil.rmtree(tmp_path / "c" / d)
    rkeys, rcosts, _, resumed = _train(
        paddle, False, samples, dict(opts, resume=True), num_passes=2)
    assert rcosts == costs[8:]
    assert rkeys[0] == ("BeginPass", 0, None)
    assert [k for k in rkeys if k[0] == "EndIteration"] == \
        [k for k in keys if k[0] == "EndIteration"][8:]
    for n in full.names():
        assert np.array_equal(resumed.get(n), full.get(n)), n


CLI_CONFIG = """
import numpy as np
from paddle.trainer_config_helpers import *
from paddle_tpu_torch import data_type, layer

rng = np.random.RandomState(0)
rows = [([int(x) for x in rng.randint(0, 40, int(n))], int(rng.randint(3)))
        for n in rng.randint(1, 12, 24)]
define_py_data_sources2(train_reader=lambda: iter(rows),
                        test_reader=lambda: iter(rows[:8]))
settings(batch_size=8, learning_rate=1e-2, learning_method=AdamOptimizer())
# direct readers declare no slot types: the data layers give them
word = layer.data(name="word", type=data_type.integer_value_sequence(40))
lab = layer.data(name="label", type=data_type.integer_value(3))
net = simple_lstm(input=embedding_layer(input=word, size=8), size=16)
net = pooling_layer(input=net, pooling_type=MaxPooling())
net = fc_layer(input=net, size=3, act=SoftmaxActivation())
outputs(classification_cost(input=net, label=lab))
"""


@pytest.mark.parametrize("command", ["train", "test", "time"])
def test_cli_training_commands_are_not_ported_yet(command, tmp_path,
                                                  capsys):
    """The name is kept from when the port refused these commands: each
    now runs a v1 config (direct readers) on the CPU and prints its
    result (tests/test_torch_cli.py holds them against the JAX CLI)."""
    from paddle_tpu_torch import cli

    conf = tmp_path / "conf.py"
    conf.write_text(CLI_CONFIG)
    argv = [command, "--config", str(conf), "--device", "cpu"]
    if command == "time":
        argv += ["--iters", "2"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    if command == "time":
        assert json.loads(out.strip().splitlines()[-1])["ms_per_batch"] > 0
    else:
        cost = float(out.split("test cost=")[1].split()[0])
        assert np.isfinite(cost) and cost > 0
