"""MultiNetwork and MultiNetworkTrainer in the port against the JAX
package on the CPU (paddle_tpu/multi_network.py; tests/test_multi_network.py
mirrored): two classification heads sharing one backbone by parameter
name.

- Alternating phases from the same numpy parameters and batches: each
  phase's loss within 1e-5 (relative) of JAX's and the whole parameter
  store within 1e-5 of max(1, max |JAX|) after every step, for Momentum
  and Adam (one optimizer state per phase); each phase moves exactly its
  trainable subset.
- The joint path: ``trainer.SGD(cost=MultiNetwork)`` minimizes the
  weighted sum of the mean costs, as JAX's (a weight of 0 freezes the
  exclusive head), and ``Parameters.create(MultiNetwork)``.
- A failed step leaves the store and the optimizer state as they were.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpaddle
from paddle_tpu.multi_network import MultiNetwork as JaxMultiNetwork
from paddle_tpu.multi_network import MultiNetworkTrainer as JaxTrainer

import paddle_tpu_torch as paddle
from paddle_tpu_torch.multi_network import MultiNetwork, MultiNetworkTrainer

from tests.torch_parity import both, rel

FEED_A = {"xa": 0, "ya": 1}
FEED_B = {"xb": 2, "yb": 3}


def _two_task(pkg):
    """Two classification heads sharing one backbone fc (by param name)."""
    L, dt = pkg.layer, pkg.data_type
    shared = pkg.attr.ParamAttr(name="shared_w")
    costs = []
    for side, classes in (("a", 2), ("b", 3)):
        x = L.data(name="x" + side, type=dt.dense_vector(8))
        h = L.fc(input=x, size=6, param_attr=shared, bias_attr=False,
                 name="enc_" + side)
        out = L.fc(input=h, size=classes, act=pkg.activation.Softmax(),
                   name="head_" + side)
        y = L.data(name="y" + side, type=dt.integer_value(classes))
        costs.append(L.classification_cost(input=out, label=y,
                                           name="cost_" + side))
    return costs


def _batches(n=4, bs=8, seed=0):
    rng = np.random.RandomState(seed)
    return [[(rng.randn(8).astype(np.float32), int(rng.randint(2)),
              rng.randn(8).astype(np.float32), int(rng.randint(3)))
             for _ in range(bs)] for _ in range(n)]


def _start(seed=5):
    """The same numpy values for every parameter of the two tasks."""
    rng = np.random.RandomState(seed)
    return {"shared_w": rng.randn(8, 6).astype(np.float32) / 3,
            "head_a.w0": rng.randn(6, 2).astype(np.float32) / 2,
            "head_a.wbias": rng.randn(2).astype(np.float32) / 10,
            "head_b.w0": rng.randn(6, 3).astype(np.float32) / 2,
            "head_b.wbias": rng.randn(3).astype(np.float32) / 10}


def _trainers(opt_name, phase_trainable=None):
    (jca, jcb), (ca, cb) = both(_two_task)
    factory = {"momentum": lambda pkg: pkg.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9),
        "adam": lambda pkg: pkg.optimizer.Adam(learning_rate=0.05)}[opt_name]
    jtr = JaxTrainer(JaxMultiNetwork({"a": jca, "b": jcb}),
                     update_equations=lambda: factory(jpaddle),
                     phase_trainable=phase_trainable)
    tr = MultiNetworkTrainer(MultiNetwork({"a": ca, "b": cb}),
                             update_equations=lambda: factory(paddle),
                             phase_trainable=phase_trainable,
                             device="cpu")
    start = _start()
    assert sorted(tr._params) == sorted(jtr._params) == sorted(start)
    for name, value in start.items():
        jtr._params[name] = jnp.asarray(value)
        tr._params[name].copy_(torch.from_numpy(value))
    return jtr, tr


def _check_store(tr, jtr):
    got, want = tr.get_params(), jtr.get_params()
    for name in want:
        assert rel(got[name], want[name]) <= 1e-5, name


@pytest.mark.parametrize("opt_name", ["momentum", "adam"])
def test_alternating_phases_match_jax(opt_name):
    trainable = {"a": lambda p: p.startswith(("enc_a", "head_a", "shared")),
                 "b": lambda p: p.startswith("head_b")}
    jtr, tr = _trainers(opt_name, trainable)
    for i, batch in enumerate(_batches()):
        for phase, feeding in (("a", FEED_A), ("b", FEED_B)):
            before = tr.get_params()
            loss = tr.train_batch(phase, batch, feeding=feeding)
            jloss = jtr.train_batch(phase, batch, feeding=feeding)
            assert abs(loss - jloss) <= 1e-5 * max(1.0, abs(jloss)), (
                i, phase)
            _check_store(tr, jtr)
            after = tr.get_params()
            moved = {n for n in after
                     if not np.array_equal(before[n], after[n])}
            assert moved and all(trainable[phase](n) for n in moved), moved
    want = jtr.infer("a", _batches(1, seed=9)[0], feeding=FEED_A)
    got = tr.infer("a", _batches(1, seed=9)[0], feeding=FEED_A)
    assert sorted(got) == sorted(want) == ["cost_a"]
    assert rel(got["cost_a"], want["cost_a"]) <= 1e-6


def test_extra_outputs_and_default_subsets_match_jax():
    (jca, jcb), (ca, cb) = both(_two_task)
    jtr = JaxTrainer(JaxMultiNetwork([("a", jca, 1.0)]),
                     update_equations=jpaddle.optimizer.Momentum(
                         learning_rate=0.1),
                     extra_outputs={"a": [jca]})
    tr = MultiNetworkTrainer(MultiNetwork([("a", ca, 1.0)]),
                             update_equations=paddle.optimizer.Momentum(
                                 learning_rate=0.1),
                             extra_outputs={"a": [ca]}, device="cpu")
    assert tr._phases["a"]["train_names"] == \
        jtr._phases["a"]["train_names"]
    start = _start()
    for name in tr._params:
        jtr._params[name] = jnp.asarray(start[name])
        tr._params[name].copy_(torch.from_numpy(start[name]))
    batch = _batches(1)[0]
    assert rel(tr.infer("a", batch, FEED_A)["cost_a"],
               jtr.infer("a", batch, FEED_A)["cost_a"]) <= 1e-6


def test_joint_training_matches_jax_and_a_zero_weight_freezes_its_head():
    (jca, jcb), (ca, cb) = both(_two_task)
    jmn = JaxMultiNetwork([("a", jca, 1.0), ("b", jcb, 0.0)])
    mn = MultiNetwork([("a", ca, 1.0), ("b", cb, 0.0)])
    jparams = jpaddle.parameters.create(jmn)
    params = paddle.parameters.create(mn, device="cpu")
    assert sorted(params.names()) == sorted(jparams.names())
    for name, value in _start().items():
        jparams.set(name, value)
        params.set(name, value)
    jtr = jpaddle.trainer.SGD(cost=jmn, parameters=jparams,
                              update_equation=jpaddle.optimizer.Momentum(
                                  learning_rate=0.1, momentum=0.9))
    tr = paddle.trainer.SGD(cost=mn, parameters=params,
                            update_equation=paddle.optimizer.Momentum(
                                learning_rate=0.1, momentum=0.9),
                            device="cpu")
    costs, jcosts = [], []

    def handler(sink):
        def on(event):
            if isinstance(event, (paddle.event.EndIteration,
                                  jpaddle.event.EndIteration)):
                sink.append(event.cost)
        return on

    tr.train(lambda: iter(_batches()), num_passes=1,
             event_handler=handler(costs))
    jtr.train(lambda: iter(_batches()), num_passes=1,
              event_handler=handler(jcosts))
    tr._sync_back()
    jtr._sync_back()
    np.testing.assert_allclose(costs, jcosts, rtol=1e-5)
    for name in params.names():
        assert rel(params.get(name), jparams.get(name)) <= 1e-5, name
    np.testing.assert_array_equal(params.get("head_b.w0"),
                                  _start()["head_b.w0"])
    assert not np.array_equal(params.get("shared_w"), _start()["shared_w"])


def test_multi_network_validates_as_jax():
    _, (ca, cb) = both(_two_task)
    with pytest.raises(Exception, match="duplicate"):
        MultiNetwork([("x", ca, 1.0), ("x", cb, 1.0)])
    with pytest.raises(Exception, match="slot state"):
        MultiNetworkTrainer(MultiNetwork({"a": ca, "b": cb}),
                            update_equations=paddle.optimizer.Momentum(
                                learning_rate=0.1), device="cpu")
    with pytest.raises(Exception, match="no trainable parameters"):
        MultiNetworkTrainer(MultiNetwork({"a": ca}),
                            update_equations=lambda: paddle.optimizer
                            .Momentum(learning_rate=0.1),
                            phase_trainable={"a": ()}, device="cpu")
    with pytest.raises(Exception, match="LayerNode"):
        MultiNetwork({"a": "cost"})


def test_failed_step_leaves_trainer_recoverable():
    """A malformed batch (wrong feature width) fails before anything is
    written: the store and the optimizer state are as they were, and the
    next good batch trains exactly as it would have."""
    jtr, tr = _trainers("adam")
    _, clean = _trainers("adam")
    batches = _batches()
    bad = [(np.zeros(3, np.float32), 0, np.zeros(3, np.float32), 0)]
    for trainer in (tr, clean):
        trainer.train_batch("a", batches[0], feeding=FEED_A)
    before = tr.get_params()
    with pytest.raises(Exception):
        tr.train_batch("a", bad, feeding=FEED_A)
    after = tr.get_params()
    assert all(np.array_equal(before[n], after[n]) for n in before)
    loss = tr.train_batch("a", batches[1], feeding=FEED_A)
    assert loss == clean.train_batch("a", batches[1], feeding=FEED_A)
    got, want = tr.get_params(), clean.get_params()
    assert all(np.array_equal(got[n], want[n]) for n in got)
