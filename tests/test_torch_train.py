"""The port's training path against the JAX package, on the CPU.

- The small flagship (``text_classification_lstm(dict_size=50,
  emb_size=16, hidden=32, num_layers=2)``, as tests/test_torch_model.py)
  plus a label and ``classification_cost``, trained 5 steps by both
  packages' ``trainer.SGD`` with ``Momentum(learning_rate=0.1,
  momentum=0.9)`` from the same numpy parameters on the same ragged
  minibatches: per-step costs and every parameter after step 5 agree.
  float32 throughout; the JAX side runs its lax.scan path, the port its
  kernel branch (the plain versions of both LSTM kernels on the CPU).
  Tolerance 1e-6 relative and absolute: the two packages sum in different
  orders and the differences compound over 5 momentum steps at lr 0.1;
  these inputs show at most 3e-8 on the costs and 9e-8 on the parameters
  (which move by up to 0.1).
- Unit parity: classification_cost, Momentum.step, model averaging and
  update hooks, every train() option against the JAX trainer, the event
  stream, the parameter tar in both directions; and the contracts:
  unported arguments raise, entry points without a device raise on a
  machine with no card, every parameter gets a finite nonzero gradient,
  bf16 tracks f32.
"""

import io
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as jpaddle
from paddle_tpu import minibatch as jminibatch
from paddle_tpu import optimizer as jopt
from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.models.text import text_classification_lstm as jax_model
from paddle_tpu.parameters import Parameters as JaxParameters

import paddle_tpu_torch as paddle
from paddle_tpu_torch import data_type, layer
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.models.text import text_classification_lstm
from paddle_tpu_torch.ops import lstm_kernels as lk
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.topology import Topology
from paddle_tpu_torch.utils.error import EnforceError

SMALL = dict(dict_size=50, emb_size=16, hidden=32, num_classes=2,
             num_layers=2)
TOL = 1e-6


def _flagship_cost(pkg_layer, pkg_dt, model):
    out = model(**SMALL)
    label = pkg_layer.data(name="label", type=pkg_dt.integer_value(2))
    return out, pkg_layer.classification_cost(input=out, label=label)


def _both_costs():
    jax_reset_names()
    jout, jcost = _flagship_cost(jpaddle.layer, jpaddle.data_type, jax_model)
    reset_name_counters()
    out, cost = _flagship_cost(layer, data_type, text_classification_lstm)
    return (jout, jcost), (out, cost)


def _numpy_params(topology, seed=0):
    rng = np.random.RandomState(seed)
    return {name: (rng.standard_normal(spec.shape) * 0.3).astype(np.float32)
            for name, spec in sorted(topology.param_specs().items())}


def _batches(seed=0, n=5, rows=4):
    """Ragged minibatches of (ids, label); lengths include 0, 1 and 12."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        lens = rng.randint(1, 13, rows)
        lens[:2] = (0, 12) if i % 2 == 0 else (1, 7)
        out.append([(rng.randint(0, 50, int(k)).tolist(),
                     int(rng.randint(0, 2))) for k in lens])
    return out


def _reader(batches):
    return lambda: iter(batches)


def _jax_params(jcost, np_params):
    params = JaxParameters.create(jcost)
    for name, value in np_params.items():
        params.set(name, value)
    return params


def test_flagship_training_trajectory_matches_jax(monkeypatch):
    (_, jcost), (_, cost) = _both_costs()
    topo = Topology(cost)
    np_params = _numpy_params(topo)
    batches = _batches()

    jparams = _jax_params(jcost, np_params)
    jtrainer = jpaddle.trainer.SGD(
        jcost, jparams, jopt.Momentum(learning_rate=0.1, momentum=0.9))
    jcosts = []
    jtrainer.train(_reader(batches), num_passes=1, event_handler=lambda e:
                   jcosts.append(e.cost)
                   if isinstance(e, jpaddle.event.EndIteration) else None)

    calls = []
    plain = lk.lstm_seq_bwd_reference
    monkeypatch.setattr(lk, "lstm_seq_bwd_reference",
                        lambda *a: calls.append(1) or plain(*a))
    params = Parameters({k: torch.from_numpy(v.copy())
                         for k, v in np_params.items()},
                        topo.param_specs())
    trainer = paddle.trainer.SGD(
        cost, params, opt.Momentum(learning_rate=0.1, momentum=0.9),
        device="cpu")
    costs = []
    trainer.train(_reader(batches), num_passes=1, event_handler=lambda e:
                  costs.append(e.cost)
                  if isinstance(e, paddle.event.EndIteration) else None)

    assert len(costs) == len(jcosts) == 5
    # both LSTM layers went through the plain backward at every step
    assert len(calls) == 2 * 5
    np.testing.assert_allclose(costs, jcosts, rtol=TOL, atol=TOL)
    assert costs[-1] != costs[0]
    for name in sorted(np_params):
        np.testing.assert_allclose(params.get(name), jparams.get(name),
                                   rtol=TOL, atol=TOL, err_msg=name)
        assert not np.array_equal(params.get(name), np_params[name]), name


def test_one_step_gives_every_parameter_a_gradient():
    _, (_, cost) = _both_costs()
    topo = Topology(cost)
    params = Parameters.create(topo, seed=3, device="cpu")
    trainer = paddle.trainer.SGD(cost, params, opt.Momentum(
        learning_rate=0.01, momentum=0.9), device="cpu")
    trainer.train(_reader(_batches(n=1)), num_passes=1)
    assert sorted(trainer._trainable) == sorted(topo.param_specs())
    for name, p in trainer._trainable.items():
        g = p.grad
        assert g is not None and g.dtype == torch.float32, name
        assert torch.isfinite(g).all() and g.abs().max() > 0, name


def test_bf16_training_tracks_f32():
    """Under set_mixed_precision("bfloat16") the forward and both LSTM
    kernels' plain versions run in bfloat16 on float32 masters; the
    per-step costs stay within bfloat16 rounding (2e-2) of the float32
    run, and the masters stay float32."""
    _, (_, cost) = _both_costs()
    topo = Topology(cost)
    np_params = _numpy_params(topo, seed=1)

    def run():
        params = Parameters({k: torch.from_numpy(v.copy())
                             for k, v in np_params.items()})
        trainer = paddle.trainer.SGD(cost, params, opt.Momentum(
            learning_rate=0.1, momentum=0.9), device="cpu")
        costs = []
        trainer.train(_reader(_batches(seed=2)), event_handler=lambda e:
                      costs.append(e.cost)
                      if isinstance(e, paddle.event.EndIteration) else None)
        assert all(p.dtype == torch.float32
                   for p in trainer._trainable.values())
        return costs

    f32 = run()
    dtype_mod.set_mixed_precision("bfloat16")
    try:
        bf16 = run()
    finally:
        dtype_mod.set_mixed_precision(None)
    np.testing.assert_allclose(bf16, f32, atol=2e-2)


def test_trained_bundle_answers_as_inference_infer(tmp_path):
    """trainer.export_inference_bundle writes the trained parameters; the
    bundle served on the CPU answers as inference.infer does with them."""
    from paddle_tpu_torch.inference import infer
    from paddle_tpu_torch.serve import load_bundle

    _, (out, cost) = _both_costs()
    params = Parameters.create(Topology(cost), seed=4, device="cpu")
    trainer = paddle.trainer.SGD(cost, params, opt.Momentum(
        learning_rate=0.1, momentum=0.9), device="cpu")
    before = params.get("lstm0.w0").copy()
    trainer.train(_reader(_batches(n=2)))
    assert not np.array_equal(params.get("lstm0.w0"), before)
    trainer.export_inference_bundle(out, str(tmp_path), batch_sizes=(4,),
                                    seq_len=16)
    bundle = load_bundle(str(tmp_path), device="cpu")
    ids = np.random.RandomState(5).randint(0, 50, (3, 16)).astype(np.int32)
    lens = np.array([16, 1, 5], np.int32)
    got = bundle.infer({"word": ids, "word:lens": lens})["lstm_out"]
    want = infer(out, params, [(ids[i, :lens[i]].tolist(),)
                               for i in range(3)], device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- units ------------------------------------------------------------------

def _cost_net(pkg, kind):
    """dense x -> fc(3) [softmax unless "logits"] -> the cost ``kind``."""
    x = pkg.layer.data(name="x", type=pkg.data_type.dense_vector(5))
    y = pkg.layer.data(name="y", type=pkg.data_type.integer_value(3))
    act = None if kind == "logits" else pkg.activation.Softmax()
    out = pkg.layer.fc(input=x, size=3, act=act, name="out")
    weight = (pkg.layer.data(name="w", type=pkg.data_type.dense_vector(1))
              if kind == "weighted" else None)
    fn = (pkg.layer.cross_entropy if kind == "cross_entropy"
          else pkg.layer.classification_cost)
    return out, fn(input=out, label=y, weight=weight)


@pytest.mark.parametrize("kind", ["probs", "logits", "weighted",
                                  "cross_entropy"])
def test_cost_layers_match_jax(kind):
    """classification_cost on probabilities (the softmax-marked fc), on
    logits and with a per-sample weight, and cross_entropy, against the JAX
    layers on the same parameters and feed: 1e-6 (float32, a log and a
    gather)."""
    jax_reset_names()
    _, jcost = _cost_net(jpaddle, kind)
    reset_name_counters()
    out, cost = _cost_net(paddle, kind)
    assert out.output_activation == ("linear" if kind == "logits"
                                     else "softmax")
    rng = np.random.RandomState(0)
    np_params = {"out.w0": rng.randn(5, 3).astype(np.float32),
                 "out.wbias": rng.randn(3).astype(np.float32)}
    feed = {"x": rng.randn(4, 5).astype(np.float32),
            "y": np.array([0, 2, 1, 2], np.int32),
            "w": rng.rand(4, 1).astype(np.float32)}
    if kind != "weighted":
        del feed["w"]
    want = jpaddle.topology.Topology(jcost).apply(
        {k: jnp.asarray(v) for k, v in np_params.items()},
        {k: jnp.asarray(v) for k, v in feed.items()}, mode="test")[0][
            jcost.name]
    got = Topology(cost).apply(
        {k: torch.from_numpy(v) for k, v in np_params.items()},
        {k: torch.from_numpy(v) for k, v in feed.items()},
        mode="test")[0][cost.name]
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kw", [
    {},
    {"nesterov": True},
    {"slot_dtype": "bfloat16"},
    {"regularization": "l2", "gradient_clipping_threshold": 0.5},
    {"regularization": "l1", "learning_rate_schedule": "poly",
     "learning_rate_decay_a": 0.5, "learning_rate_decay_b": 0.75},
], ids=["plain", "nesterov", "bf16_slots", "l2_clip", "l1_poly"])
def test_momentum_step_matches_jax(kw):
    """Three Momentum steps on the same parameters and gradients, with a
    per-parameter learning-rate multiplier on one of them. float32 update
    arithmetic on both sides: 1e-6."""
    from paddle_tpu.attr import ParamAttr as JaxParamAttr
    from paddle_tpu_torch.attr import ParamAttr

    kw = dict(kw)
    reg = kw.pop("regularization", None)
    jkw, tkw = dict(kw), dict(kw)
    if reg == "l2":
        jkw["regularization"] = jopt.L2Regularization(1e-2)
        tkw["regularization"] = opt.L2Regularization(1e-2)
    elif reg == "l1":
        jkw["regularization"] = jopt.L1Regularization(1e-3)
        tkw["regularization"] = opt.L1Regularization(1e-3)
    rng = np.random.RandomState(1)
    params = {"a": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jo = jopt.Momentum(learning_rate=0.1, momentum=0.9, **jkw)
    to = opt.Momentum(learning_rate=0.1, momentum=0.9, **tkw)
    jmeta = {"b": JaxParamAttr(learning_rate=0.5)}
    tmeta = {"b": ParamAttr(learning_rate=0.5)}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jo.init_state(jp, jmeta)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = to.init_state(tp, tmeta)
    for g in grads:
        jp, jstate = jo.step(jp, {k: jnp.asarray(v) for k, v in g.items()},
                             jstate, jmeta)
        to.step(tp, {k: torch.from_numpy(v) for k, v in g.items()}, tstate,
                tmeta)
    assert tstate["step"] == 3
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        slot = tstate["slots"][k][0]
        assert slot.dtype == (torch.bfloat16 if "slot_dtype" in kw
                              else torch.float32)
        np.testing.assert_allclose(
            slot.float().numpy(),
            np.asarray(jstate["slots"][k][0]).astype(np.float32),
            rtol=1e-6, atol=1e-6)


def test_optimizer_refuses_what_is_not_ported():
    """Model averaging and update hooks, refused until they were ported,
    now run and give the JAX package's result over 3 steps (1e-6)."""
    from paddle_tpu.attr import ParamAttr as JaxParamAttr
    from paddle_tpu_torch.attr import ParamAttr

    # sparse-row updates are ported: Momentum(sparse=True) makes every
    # matrix row-sparse and leaves vectors dense
    state = opt.Momentum(sparse=True).init_state(
        {"w": torch.zeros(3, 2), "b": torch.zeros(2)})
    assert sorted(state["row_step"]) == ["w"]
    rng = np.random.RandomState(2)
    params = {"w": rng.randn(5, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jo = jopt.Momentum(learning_rate=0.1, momentum=0.9, model_average=0.99)
    to = opt.Momentum(learning_rate=0.1, momentum=0.9, model_average=0.99)
    jmeta = {"w": JaxParamAttr(update_hooks=[jopt.StaticPruningHook(0.5)])}
    tmeta = {"w": ParamAttr(update_hooks=[opt.StaticPruningHook(0.5)])}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jo.init_state(jp, jmeta)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = to.init_state(tp, tmeta)
    for g in grads:
        jp, jstate = jo.step(jp, {k: jnp.asarray(v) for k, v in g.items()},
                             jstate, jmeta)
        to.step(tp, {k: torch.from_numpy(v) for k, v in g.items()}, tstate,
                tmeta)
    assert int(tstate["step"]) == 3
    assert int((tp["w"] == 0).sum()) == 10  # half of w pruned, every step
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(tstate["average"][k].numpy(),
                                   np.asarray(jstate["average"][k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def _toy(pkg):
    x = pkg.layer.data(name="x", type=pkg.data_type.dense_vector(4))
    y = pkg.layer.data(name="y", type=pkg.data_type.integer_value(2))
    h = pkg.layer.fc(input=x, size=8, act=pkg.activation.Tanh(), name="h")
    out = pkg.layer.fc(input=h, size=2, name="o")
    return pkg.layer.classification_cost(input=out, label=y)


def _toy_batches(n=12, size=4):
    rng = np.random.RandomState(0)
    samples = [(rng.randn(4).astype(np.float32), int(rng.randint(0, 2)))
               for _ in range(n)]
    return lambda: iter(samples)


def _event_key(e):
    return (type(e).__name__, getattr(e, "pass_id", None),
            getattr(e, "batch_id", None))


def test_event_stream_matches_jax_order():
    """The port's events equal the JAX trainer's, one step deep: BeginPass
    → BeginIteration(b) … EndForwardBackward(b) → EndIteration(b) … →
    EndPass (tests/test_trainer_e2e.py:309 pins the JAX order)."""
    jax_reset_names()
    jcost = _toy(jpaddle)
    jevents = []
    jpaddle.trainer.SGD(jcost, JaxParameters.create(jcost),
                        jopt.Momentum(learning_rate=0.1)).train(
        jminibatch.batch(_toy_batches(), 4), num_passes=2,
        event_handler=jevents.append)
    reset_name_counters()
    cost = _toy(paddle)
    events = []
    paddle.trainer.SGD(cost, Parameters.create(Topology(cost), device="cpu"),
                       opt.Momentum(learning_rate=0.1), device="cpu").train(
        paddle.batch(_toy_batches(), 4), num_passes=2,
        event_handler=events.append)
    assert [_event_key(e) for e in events] == [_event_key(e)
                                               for e in jevents]
    keys = [_event_key(e) for e in events]
    for p in range(2):
        begin = keys.index(("BeginPass", p, None))
        end = keys.index(("EndPass", p, None))
        for b in range(3):
            bi = keys.index(("BeginIteration", p, b))
            fb = keys.index(("EndForwardBackward", p, b))
            ei = keys.index(("EndIteration", p, b))
            assert begin < bi < fb < ei < end
    assert all(isinstance(e.cost, float) for e in events
               if isinstance(e, paddle.event.EndIteration))


def test_test_pass_reports_the_mean_cost():
    cost = _toy(paddle)
    trainer = paddle.trainer.SGD(
        cost, Parameters.create(Topology(cost), device="cpu"),
        opt.Momentum(learning_rate=0.1), device="cpu")
    results = []
    trainer.train(paddle.batch(_toy_batches(), 4), num_passes=2,
                  test_reader=paddle.batch(_toy_batches(8), 4),
                  event_handler=lambda e: results.append(e)
                  if isinstance(e, paddle.event.TestResult) else None)
    assert [r.pass_id for r in results] == [0, 1]
    again = trainer.test(paddle.batch(_toy_batches(8), 4))
    assert again.cost == pytest.approx(results[-1].cost, rel=1e-6)


def _toy_train(pkg, jax_side, options, num_passes=1, params=None):
    """Train the toy classifier 1 pass (3 batches of 4) from the seeded
    numpy parameters with ``options``; returns (EndIteration costs,
    Parameters, trainer)."""
    if jax_side:
        jax_reset_names()
    else:
        reset_name_counters()
    cost = _toy(pkg)
    if params is None:
        np_params = _numpy_params(Topology(cost) if not jax_side
                                  else _port_topology_of_toy(), seed=5)
        if jax_side:
            params = _jax_params(cost, np_params)
        else:
            params = Parameters({k: torch.from_numpy(v.copy())
                                 for k, v in np_params.items()},
                                Topology(cost).param_specs())
    kw = {} if jax_side else {"device": "cpu"}
    trainer = pkg.trainer.SGD(cost, params, pkg.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9), **kw)
    costs = []
    trainer.train(pkg.batch(_toy_batches(), 4), num_passes=num_passes,
                  event_handler=lambda e: costs.append(e.cost)
                  if isinstance(e, pkg.event.EndIteration) else None,
                  **options)
    return costs, params, trainer


def _port_topology_of_toy():
    reset_name_counters()
    return Topology(_toy(paddle))


@pytest.mark.parametrize("key,value", [
    ("feed_pipeline", True), ("buckets", True), ("buckets", [8, 16]),
    ("steps_per_call", 4), ("checkpoint_dir", "ckpt"),
    ("checkpoint_every", 10), ("checkpoint_keep", 5), ("resume", True),
    ("checkpoint_sync", True)])
def test_unported_train_options_raise(key, value, tmp_path):
    """Each train() option, refused until this slice ported it, now trains
    and gives the JAX trainer's costs and parameters (1e-6). The
    checkpoint options run with a checkpoint directory and a cadence of 2
    steps (one option alone changes nothing); ``resume`` continues a
    2-pass run from the checkpoint each package wrote in its first pass."""
    options = {key: value}
    if key.startswith("checkpoint") or key == "resume":
        options = {"checkpoint_dir": None, "checkpoint_every": 2, key: value}
    passes = 2 if key == "resume" else 1
    results = []
    for pkg, jax_side in ((jpaddle, True), (paddle, False)):
        opts = dict(options)
        if "checkpoint_dir" in opts:
            opts["checkpoint_dir"] = str(tmp_path / (pkg.__name__ + "_ckpt"))
        if key == "resume":
            # a first run checkpoints at step 2 and stops after pass 0; a
            # fresh trainer resumes at pass 0's third batch and trains on
            # through pass 1
            first = dict(opts, resume=False)
            _toy_train(pkg, jax_side, first, num_passes=1)
        costs, params, _ = _toy_train(pkg, jax_side, opts,
                                      num_passes=passes)
        listing = None
        if "checkpoint_dir" in opts and os.path.isdir(opts["checkpoint_dir"]):
            listing = sorted(os.listdir(opts["checkpoint_dir"]))
        results.append((costs, params, listing))
    (jcosts, jparams, jlisting), (costs, params, listing) = results
    if options.get("checkpoint_every") == 2:
        # an overlapped save still pending when the next one is submitted
        # is superseded (newest wins), so step 4's may or may not land
        want = ["pass-00000-step-00000002"] + (
            ["pass-00001-step-00000004", "pass-00001-step-00000006"]
            if key == "resume" else [])
        for got in (listing, jlisting):
            assert got[-1] == want[-1] and set(got) <= set(want), got
    else:
        assert listing == jlisting is None
    assert len(costs) == len(jcosts) == (4 if key == "resume" else 3)
    np.testing.assert_allclose(costs, jcosts, rtol=TOL, atol=TOL)
    for name in jparams.names():
        np.testing.assert_allclose(params.get(name), jparams.get(name),
                                   rtol=TOL, atol=TOL, err_msg=name)
    cost = _toy(paddle)
    trainer = paddle.trainer.SGD(
        cost, Parameters.create(Topology(cost), device="cpu"),
        opt.Momentum(learning_rate=0.1), device="cpu")
    with pytest.raises(TypeError, match="unexpected keyword"):
        trainer.train(paddle.batch(_toy_batches(), 4), no_such_option=1)


@pytest.mark.parametrize("kw,match", [
    ({"extra_layers": ["an evaluator"]}, "evaluators"),
    ({"parallelism": object()}, "data parallelism")])
def test_unported_trainer_arguments_raise(kw, match):
    cost = _toy(paddle)
    params = Parameters.create(Topology(cost), device="cpu")
    with pytest.raises(EnforceError, match=match):
        paddle.trainer.SGD(cost, params, opt.Momentum(), device="cpu", **kw)


def test_trainer_and_create_without_device_raise_when_no_card(monkeypatch):
    cost = _toy(paddle)
    topo = Topology(cost)
    params = Parameters.create(topo, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Parameters.create(topo)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paddle.trainer.SGD(cost, params, opt.Momentum())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Parameters.from_tar(io.BytesIO())


def test_parameter_tar_crosses_between_packages_both_ways():
    from paddle_tpu.attr import ParamAttr as JaxParamAttr
    from paddle_tpu_torch.attr import ParamAttr

    def net(pkg, attr_cls):
        x = pkg.layer.data(name="x", type=pkg.data_type.dense_vector(3))
        h = pkg.layer.fc(input=x, size=4, name="h",
                         param_attr=attr_cls(is_static=True))
        return pkg.layer.fc(input=h, size=2, name="o")

    jax_reset_names()
    jparams = JaxParameters.create(net(jpaddle, JaxParamAttr))
    reset_name_counters()
    params = Parameters.create(Topology(net(paddle, ParamAttr)), seed=2,
                               device="cpu")
    assert params.partition() == jparams.partition() == (
        ["h.wbias", "o.w0", "o.wbias"], ["h.w0"], [])

    buf = io.BytesIO()
    jparams.to_tar(buf)
    buf.seek(0)
    loaded = Parameters.from_tar(buf, device="cpu")
    assert loaded.names() == jparams.names()
    assert loaded.partition() == jparams.partition()
    for name in loaded.names():
        np.testing.assert_array_equal(loaded.get(name), jparams.get(name))

    buf = io.BytesIO()
    params.to_tar(buf)
    buf.seek(0)
    jloaded = JaxParameters.from_tar(buf)
    assert jloaded.partition() == params.partition()
    for name in params.names():
        np.testing.assert_array_equal(jloaded.get(name), params.get(name))

    buf.seek(0)
    fresh = Parameters.create(Topology(net(paddle, ParamAttr)), seed=9,
                              device="cpu")
    fresh.init_from_tar(buf)
    for name in params.names():
        np.testing.assert_array_equal(fresh.get(name), params.get(name))


def test_save_parameter_to_tar_holds_the_trained_values():
    cost = _toy(paddle)
    params = Parameters.create(Topology(cost), device="cpu")
    trainer = paddle.trainer.SGD(cost, params, opt.Momentum(
        learning_rate=0.1, momentum=0.9), device="cpu")
    trainer.train(paddle.batch(_toy_batches(), 4))
    buf = io.BytesIO()
    trainer.save_parameter_to_tar(buf)
    buf.seek(0)
    loaded = JaxParameters.from_tar(buf)
    for name, p in trainer._trainable.items():
        np.testing.assert_array_equal(loaded.get(name),
                                      p.detach().numpy())


def test_batch_bucket_sets_the_padded_length(monkeypatch):
    """A minibatch with a ``bucket`` attribute pads its sequences to that
    length (the JAX trainer's convert_feed max_len); without one, to the
    length bucket of its longest sequence."""
    from paddle_tpu_torch.topology import convert_feed

    class Bucketed(list):
        bucket = 12

    _, (_, cost) = _both_costs()
    topo = Topology(cost)
    rows = [([1, 2, 3], 0), ([4], 1)]
    assert convert_feed(topo, rows, device="cpu")["word"].max_len == 16
    feed = convert_feed(topo, Bucketed(rows), device="cpu",
                        max_len=Bucketed.bucket)
    assert feed["word"].max_len == 12
    assert feed["word"].lengths.tolist() == [3, 1]
    with pytest.raises(EnforceError, match="longer than max_len"):
        convert_feed(topo, rows, device="cpu", max_len=2)
    trainer = paddle.trainer.SGD(
        cost, Parameters.create(topo, device="cpu"),
        opt.Momentum(learning_rate=0.1), device="cpu")
    seen = []
    plain = lk.lstm_seq_fwd_reference

    def spy(*args):
        seen.append(args[0].shape[0])
        return plain(*args)

    monkeypatch.setattr(lk, "lstm_seq_fwd_reference", spy)
    trainer.train(lambda: iter([Bucketed(rows)]))
    assert seen == [12, 12]
