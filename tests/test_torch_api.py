"""The v2 entry points of the port against the JAX package, on the CPU:
``init`` and ``infer`` at the package's top, ``parameters.create`` on a
cost layer, ``infer(field=)``, ``layer.data(height=, width=)``, the
keywords ``lstmemory(gate_bias_attr=)`` and ``batch_norm(img3D=)``, and
``pooling(bias_attr=None)``; then the README's quick tour run unchanged on
``import paddle_tpu_torch as paddle`` after ``paddle.init(use_tpu=False)``
and on ``import paddle_tpu as paddle``, from the same parameters on the
same seeded minibatches; and the process flags of ``init``: the
``test_period`` flag gives the same event stream in both packages
(a TestResult every 2 steps, none at the end of the pass), ``log_period``
logs every N-th batch, ``telemetry``, ``stats``, ``trap_fpe``,
``show_layer_stat`` and ``show_parameter_stats_period`` act as in the JAX
package, and ``matmul_precision``, which the port does not act on yet, is
refused at any value but its default.

Tolerance 1e-5 (absolute, float32): the two packages sum the same float32
products in different orders; the quick tour's three costs and its final
parameters differ by about 1e-7 on these inputs.
"""

import os

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jpaddle
from paddle_tpu.core import place as jplace
from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.utils import flags as jflags

import paddle_tpu_torch as paddle
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.core import place
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.topology import Topology
from paddle_tpu_torch.utils import flags
from paddle_tpu_torch.utils.error import EnforceError

TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_defaults():
    """init() is process-wide in both packages: put back what it sets."""
    device, seed = place.default_device(), flags.get_flag("seed")
    jdefault = jplace.default_place()
    jvalues = {k: jflags.get_flag(k) for k in ("use_tpu", "trainer_count")}
    yield
    place.set_default_device(device)
    flags.set_flag("seed", seed)
    jplace.set_default_place(jdefault)
    for key, value in jvalues.items():
        jflags.set_flag(key, value)


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _mlp(pkg, hidden=12, classes=4, dim=20):
    """The quick tour's network at a small width, built by ``pkg``."""
    x = pkg.layer.data(name="x", type=pkg.data_type.dense_vector(dim))
    h = pkg.layer.fc(input=x, size=hidden, act=pkg.activation.Relu())
    y = pkg.layer.fc(input=h, size=classes, act=pkg.activation.Softmax())
    label = pkg.layer.data(name="label",
                           type=pkg.data_type.integer_value(classes))
    return y, pkg.layer.classification_cost(input=y, label=label)


def _both(build):
    jax_reset_names()
    jout = build(jpaddle)
    reset_name_counters()
    return jout, build(paddle)


def _carry(jparams, outputs):
    """The JAX package's parameter values, carried to the port through
    numpy (convert.params_from_numpy), as a port Parameters object."""
    topo = Topology(outputs)
    values = params_from_numpy({n: np.asarray(jparams.get(n))
                                for n in jparams.names()}, topo,
                               device="cpu")
    return Parameters(values, topo.param_specs())


def _rows(seed, n, dim=20, classes=4):
    rng = np.random.RandomState(seed)
    return [(rng.randn(dim).astype(np.float32), int(rng.randint(classes)))
            for _ in range(n)]


# -- A.1: init and infer ----------------------------------------------------

def test_init_use_tpu_false_makes_the_cpu_the_default():
    assert jpaddle.init(use_tpu=False) is None
    assert paddle.init(use_tpu=False) is None
    assert place.resolve_device(None) == torch.device("cpu")
    assert isinstance(jplace.default_place(), jplace.CPUPlace)
    _, (_, cost) = _both(_mlp)
    params = paddle.parameters.create(cost)  # no device= needed any more
    assert all(params.as_dict()[n].device.type == "cpu"
               for n in params.names())
    paddle.init(use_tpu=False, seed=7)
    a = paddle.parameters.create(cost)
    b = paddle.parameters.create(cost)
    assert all(np.array_equal(a.get(n), b.get(n)) for n in a.names())
    assert flags.get_flag("seed") == 7


@pytest.mark.parametrize("use_tpu", [None, True])
def test_init_without_a_card_raises_and_keeps_the_default(monkeypatch,
                                                          use_tpu):
    """The card stays the default, and choosing it on a machine without one
    raises: the port never moves to the CPU on its own."""
    paddle.init(use_tpu=False)
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paddle.init(use_tpu=use_tpu)
    assert place.resolve_device(None) == torch.device("cpu")
    place.set_default_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        place.resolve_device(None)


def test_init_refuses_what_is_not_ported():
    with pytest.raises(EnforceError, match="not ported yet"):
        paddle.init(use_tpu=False, trainer_count=2)
    paddle.init(use_tpu=False, log_level="WARNING", my_flag=3)
    assert flags.get_flag("my_flag") == 3


def test_top_level_infer_matches_jax():
    (jy, jcost), (y, cost) = _both(_mlp)
    jparams = jpaddle.parameters.create(jcost)
    rows = [(r[0],) for r in _rows(3, 5)]
    want = np.asarray(jpaddle.infer(jy, jparams, rows))
    paddle.init(use_tpu=False)
    got = paddle.infer(y, _carry(jparams, [cost]), rows)
    assert got.shape == (5, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


# -- A.2: parameters.create on a cost layer or a list ----------------------

def test_parameters_create_takes_a_cost_or_a_list():
    (jy, jcost), (y, cost) = _both(_mlp)
    jparams = jpaddle.parameters.create(jcost)
    for arg in (cost, [cost], [y, cost], Topology(cost)):
        params = Parameters.create(arg, device="cpu")
        assert params.names() == jparams.names()
        assert all(params.get(n).shape == np.shape(jparams.get(n))
                   for n in params.names())


def test_parameters_create_rng_is_an_int_seed():
    _, (_, cost) = _both(_mlp)
    a = paddle.parameters.create(cost, rng=5, device="cpu")
    b = paddle.parameters.create(cost, seed=5, device="cpu")
    assert all(np.array_equal(a.get(n), b.get(n)) for n in a.names())
    with pytest.raises(EnforceError, match="int seed"):
        paddle.parameters.create(cost, rng=jax.random.PRNGKey(0),
                                 device="cpu")
    with pytest.raises(EnforceError, match="disagree"):
        paddle.parameters.create(cost, rng=1, seed=2, device="cpu")
    with pytest.raises(EnforceError, match="Topology, a layer"):
        paddle.parameters.create("cost", device="cpu")


# -- A.3: infer(field=) -------------------------------------------------------

def test_infer_field_value_matches_jax():
    (jy, jcost), (y, cost) = _both(_mlp)
    jparams = jpaddle.parameters.create(jcost)
    params = _carry(jparams, [cost])
    rows = [(r[0],) for r in _rows(4, 6)]
    want = np.asarray(jpaddle.inference.infer(jy, jparams, rows,
                                              field="value"))
    got = paddle.inference.infer(y, params, rows, field="value",
                                 device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    engine = paddle.inference.Inference(y, params, device="cpu")
    np.testing.assert_allclose(engine.infer(rows, field="value"), want,
                               rtol=0, atol=TOL)
    with pytest.raises(EnforceError, match="not ported yet"):
        engine.infer(rows, field="id")


# -- A.4: layer.data(height=, width=) and the unported keywords -------------

def _image_net(pkg):
    img = pkg.layer.data(name="pixel",
                         type=pkg.data_type.dense_vector(2 * 6 * 5),
                         height=6, width=5)
    conv = pkg.layer.img_conv(input=img, filter_size=3, num_filters=8,
                              padding=1, act=pkg.activation.Relu())
    pool = pkg.layer.img_pool(input=conv, pool_size=2, stride=2)
    return img, pkg.layer.fc(input=pool, size=3,
                             act=pkg.activation.Softmax())


def test_data_height_width_sets_the_image_geometry():
    (jimg, jout), (img, out) = _both(_image_net)
    assert img.out_img_shape == tuple(jimg.out_img_shape) == (2, 6, 5)
    jparams = jpaddle.parameters.create(jout)
    params = _carry(jparams, [out])
    rng = np.random.RandomState(6)
    rows = [(rng.randn(60).astype(np.float32),) for _ in range(4)]
    want = np.asarray(jpaddle.infer(jout, jparams, rows))
    got = paddle.infer(out, params, rows, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("height,width", [(6, None), (7, 5), (0, 5)])
def test_data_height_width_refused_like_jax(height, width):
    for pkg in (jpaddle, paddle):
        with pytest.raises(pkg.EnforceError):
            pkg.layer.data(name="pixel",
                           type=pkg.data_type.dense_vector(60),
                           height=height, width=width)


def test_lstmemory_gate_bias_and_batch_norm_img3d_are_refused():
    """Both keywords exist in the JAX package. ``lstmemory(gate_bias_attr=)``
    is ported: its default and "merged" give the merged 7*size bias, any
    other value the split parameterization, with JAX's parameter names
    and shapes (tests/test_torch_text_layers.py holds values and
    gradients); ``batch_norm(img3D=True)`` is still refused as not ported
    (not TypeError)."""
    def build(pkg, **kw):
        seq = pkg.layer.data(
            name="w", type=pkg.data_type.integer_value_sequence(10))
        emb = pkg.layer.embedding(input=seq, size=8)
        proj = pkg.layer.fc(input=emb, size=16)
        return pkg.layer.lstmemory(input=proj, name="lstm", **kw)

    for kw in ({}, {"gate_bias_attr": "merged"}, {"gate_bias_attr": None},
               {"gate_bias_attr": False}, {"gate_bias_attr": "attr"}):
        def built(pkg, kw=kw):
            if kw.get("gate_bias_attr") == "attr":
                kw = {"gate_bias_attr": pkg.attr.ParamAttr(name="gates")}
            return build(pkg, **kw)

        jout, out = _both(built)
        assert out.size == 4
        assert {k: s.shape for k, s in Topology(out).param_specs().items()} \
            == {k: s.shape for k, s in jpaddle.topology.Topology(
                jout).param_specs().items()}, kw
    reset_name_counters()
    img = paddle.layer.data(name="im", type=paddle.data_type.dense_vector(
        3 * 4 * 4), height=4, width=4)
    assert paddle.layer.batch_norm(input=img, img3D=False).size == 48
    with pytest.raises(EnforceError, match="not ported yet"):
        paddle.layer.batch_norm(input=img, img3D=True)


# -- A.5: pooling(bias_attr=None) ------------------------------------------

def _pooled(pkg, bias_attr):
    seq = pkg.layer.data(name="w",
                         type=pkg.data_type.integer_value_sequence(10))
    emb = pkg.layer.embedding(input=seq, size=6)
    pooled = pkg.layer.pooling(input=emb, bias_attr=bias_attr,
                               pooling_type=pkg.pooling.MaxPooling())
    return pkg.layer.fc(input=pooled, size=2, act=pkg.activation.Softmax())


@pytest.mark.parametrize("bias_attr", [None, False])
def test_pooling_without_bias_matches_jax(bias_attr):
    jout, out = _both(lambda pkg: _pooled(pkg, bias_attr))
    jparams = jpaddle.parameters.create(jout)
    params = _carry(jparams, [out])
    rows = [([1, 4, 2],), ([7],), ([3, 3, 9, 0, 5],)]
    want = np.asarray(jpaddle.infer(jout, jparams, rows))
    got = paddle.infer(out, params, rows, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_pooling_with_a_bias_is_refused():
    reset_name_counters()
    with pytest.raises(EnforceError, match="bias is not ported yet"):
        _pooled(paddle, paddle.attr.ParamAttr())


# -- the README quick tour --------------------------------------------------

def _quick_tour(pkg, reader, costs, start):
    """README.md's quick tour, line for line, at batch 16 for one pass (the
    README trains 5 passes at 128). An empty ``start`` receives the
    initial parameter values as numpy arrays; a filled one replaces them
    (convert.params_from_numpy), so both packages start alike."""
    pkg.init(use_tpu=False)
    x = pkg.layer.data(name='x', type=pkg.data_type.dense_vector(784))
    h = pkg.layer.fc(input=x, size=128, act=pkg.activation.Relu())
    y = pkg.layer.fc(input=h, size=10, act=pkg.activation.Softmax())
    cost = pkg.layer.classification_cost(input=y, label=pkg.layer.data(
        name='label', type=pkg.data_type.integer_value(10)))
    params = pkg.parameters.create(cost)
    if start:
        topo = Topology(cost)
        params = Parameters(params_from_numpy(start, topo),
                            topo.param_specs())
    else:
        start.update({n: np.array(params.get(n)) for n in params.names()})
    trainer = pkg.trainer.SGD(cost, params,
                              pkg.optimizer.Momentum(learning_rate=0.01))
    trainer.train(pkg.batch(reader, 16), num_passes=1,
                  event_handler=lambda e: costs.append(float(e.cost))
                  if isinstance(e, pkg.event.EndIteration) else None)
    return params


def test_readme_quick_tour_matches_jax():
    samples = _rows(11, 48, dim=784, classes=10)

    def reader():
        return iter(samples)

    start, jcosts, costs = {}, [], []
    jax_reset_names()
    jparams = _quick_tour(jpaddle, reader, jcosts, start)
    reset_name_counters()
    params = _quick_tour(paddle, reader, costs, start)
    assert place.resolve_device(None) == torch.device("cpu")
    assert len(costs) == len(jcosts) == 3
    np.testing.assert_allclose(costs, jcosts, rtol=0, atol=TOL)
    assert params.names() == jparams.names() == sorted(start)
    for name in params.names():
        assert not np.array_equal(params.get(name), start[name]), name
        np.testing.assert_allclose(params.get(name),
                                   np.asarray(jparams.get(name)), rtol=0,
                                   atol=TOL, err_msg=name)


# -- the process flags --------------------------------------------------------

def _events_with_test_period(pkg, samples, start):
    """The quick tour's mlp trained 6 batches of 4 with a test reader
    under ``init(test_period=2)``: the stream of (event type, pass,
    batch) and the TestResult costs."""
    pkg.init(use_tpu=False, test_period=2)
    try:
        y, cost = _mlp(pkg)
        params = pkg.parameters.create(cost)
        if start:
            topo = Topology(cost)
            params = Parameters(params_from_numpy(start, topo),
                                topo.param_specs())
        else:
            start.update({n: np.array(params.get(n))
                          for n in params.names()})
        trainer = pkg.trainer.SGD(cost, params, pkg.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9))
        stream, test_costs = [], []

        def handler(evt):
            stream.append((type(evt).__name__,
                           getattr(evt, "pass_id", None),
                           getattr(evt, "batch_id", None)))
            if isinstance(evt, pkg.event.TestResult):
                test_costs.append(float(evt.cost))

        trainer.train(pkg.batch(lambda: iter(samples), 4), num_passes=1,
                      event_handler=handler,
                      test_reader=pkg.batch(lambda: iter(samples[:8]), 4))
    finally:
        pkg.init(use_tpu=False, test_period=0)
    return stream, test_costs


def test_test_period_event_stream_matches_jax():
    samples = _rows(5, 24)
    start = {}
    jax_reset_names()
    jstream, jtests = _events_with_test_period(jpaddle, samples, start)
    reset_name_counters()
    stream, tests = _events_with_test_period(paddle, samples, start)
    assert stream == jstream
    names = [s[0] for s in stream]
    assert names.count("TestResult") == 3 and names.count(
        "EndIteration") == 6
    # each TestResult comes after its step's EndForwardBackward and before
    # its EndIteration; none follows the last EndIteration
    assert names[-2:] == ["EndIteration", "EndPass"]
    for i, name in enumerate(names):
        if name == "TestResult":
            assert names[i - 1] == "EndForwardBackward"
            assert names[i + 1] == "EndIteration"
    np.testing.assert_allclose(tests, jtests, rtol=0, atol=TOL)
    assert flags.get_flag("test_period") == 0


def test_log_period_logs_every_nth_batch():
    import logging

    from paddle_tpu_torch.utils.logger import logger

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger.addHandler(handler)
    level = logger.level
    paddle.init(use_tpu=False, log_period=2, log_level="INFO")
    try:
        reset_name_counters()
        _, cost = _mlp(paddle)
        trainer = paddle.trainer.SGD(
            cost, paddle.parameters.create(cost),
            paddle.optimizer.Momentum(learning_rate=0.1))
        trainer.train(paddle.batch(lambda: iter(_rows(6, 20)), 4),
                      num_passes=1)
    finally:
        paddle.init(use_tpu=False, log_period=100)
        logger.setLevel(level)
        logger.removeHandler(handler)
    logged = [r.getMessage().split(" cost=")[0] for r in records]
    assert logged == ["pass 0 batch 0", "pass 0 batch 2", "pass 0 batch 4"]


def _train_under_flags(pkg, samples, start, **flag_values):
    """The MLP trained over ``samples`` (batches of 4) from the parameters
    ``start`` (filled by the first call) under ``init(**flag_values)``;
    returns the messages its package logged. The flags go back to their
    defaults after."""
    import logging

    from paddle_tpu.utils.logger import logger as jlogger
    from paddle_tpu_torch.utils.logger import logger

    log = jlogger if pkg is jpaddle else logger
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log.addHandler(handler)
    level = log.level
    log.setLevel("INFO")
    registry = jflags if pkg is jpaddle else flags
    defaults = {k: registry.get_flag(k) for k in flag_values}
    (jax_reset_names if pkg is jpaddle else reset_name_counters)()
    pkg.init(use_tpu=False, **flag_values)
    try:
        y, cost = _mlp(pkg)
        params = pkg.parameters.create(cost)
        if start:
            topo = Topology(cost)
            params = Parameters(params_from_numpy(start, topo),
                                topo.param_specs())
        else:
            start.update({n: np.array(params.get(n))
                          for n in params.names()})
        trainer = pkg.trainer.SGD(cost, params, pkg.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9))
        trainer.train(pkg.batch(lambda: iter(samples), 4), num_passes=1)
    finally:
        pkg.init(use_tpu=False, **defaults)
        log.setLevel(level)
        log.removeHandler(handler)
    return [r.getMessage() for r in records]


def _stat_lines(messages, prefix):
    """{(occurrence, name): [numbers]} of the lines ``<prefix> name: k=v
    ...``; the occurrence counts the lines of the same name before."""
    out, seen = {}, {}
    for msg in messages:
        if not msg.startswith(prefix + " "):
            continue
        name, _, rest = msg[len(prefix) + 1:].partition(": ")
        n = seen[name] = seen.get(name, -1) + 1
        out[(n, name)] = [float(kv.split("=")[1]) for kv in rest.split()]
    return out


def _check_telemetry(tmp_path, got_messages, want_messages):
    from paddle_tpu.observe import steplog as jsteplog
    from paddle_tpu_torch.observe import steplog

    got = steplog.read_jsonl(str(tmp_path / "t" / "train.steps.jsonl"))
    want = jsteplog.read_jsonl(str(tmp_path / "j" / "train.steps.jsonl"))
    kinds = [r["type"] for r in got if r["type"] != "event"]
    assert kinds == [r["type"] for r in want if r["type"] != "event"]
    assert kinds.count("step") == 6
    np.testing.assert_allclose(
        [r["cost"] for r in got if r["type"] == "step"],
        [r["cost"] for r in want if r["type"] == "step"], atol=TOL)


def _check_stats(tmp_path, got, want):
    from paddle_tpu.utils.stat import global_stats as jstats
    from paddle_tpu_torch.utils.stat import global_stats

    for messages in got, want:
        assert "======= StatSet: [global] =======" in messages
    names = sorted(m.split("(")[1].split(":")[0] for m in got
                   if m.startswith("  Stat("))
    assert names == sorted(m.split("(")[1].split(":")[0] for m in want
                           if m.startswith("  Stat("))
    assert {"feed", "train_step", "eval_readback"} <= set(names)
    # the dump resets the StatSet at EndPass
    assert global_stats.as_dict() == {} and jstats.as_dict() == {}


def _check_layer_stat(tmp_path, got, want):
    got, want = _stat_lines(got, "layer"), _stat_lines(want, "layer")
    # the lines come in the same order, under the same layer names (the
    # cost layer's default name is __cost_N__ in both packages)
    assert len(got) == len(want) == 6 * 4
    for (gkey, gvalues), (wkey, wvalues) in zip(got.items(), want.items()):
        assert gkey == wkey
        np.testing.assert_allclose(gvalues, wvalues, rtol=1e-4, atol=1e-6,
                                   err_msg=str(wkey))


def _check_param_stats(tmp_path, got, want):
    got, want = _stat_lines(got, "param"), _stat_lines(want, "param")
    # step 10 of 10, four parameters
    assert sorted(got) == sorted(want) and len(got) == 4
    for key, values in want.items():
        np.testing.assert_allclose(got[key], values, rtol=1e-4, atol=1e-6,
                                   err_msg=str(key))


ACTED_ON = {
    "telemetry": (lambda tmp, side, v: {"telemetry": str(tmp / side)},
                  _check_telemetry),
    "stats": (lambda tmp, side, v: {"stats": v}, _check_stats),
    "show_layer_stat": (lambda tmp, side, v: {"show_layer_stat": v,
                                              "log_period": 1},
                        _check_layer_stat),
    "show_parameter_stats_period": (
        lambda tmp, side, v: {"show_parameter_stats_period": v},
        _check_param_stats),
}


def _check_refused(name, value):
    default = flags.get_flag(name)
    with pytest.raises(EnforceError, match="flag %s=.* is not ported yet"
                       % name):
        paddle.init(use_tpu=False, **{name: value})
    with pytest.raises(EnforceError, match="not ported yet"):
        flags.set_flag(name, value)
    assert flags.get_flag(name) == default
    paddle.init(use_tpu=False, **{name: default})  # the default is taken
    assert flags.get_flag(name) == default
    # the JAX package's defaults
    assert default == jflags.get_flag(name)


@pytest.mark.parametrize("name,value", [
    ("trap_fpe", True), ("show_layer_stat", True),
    ("show_parameter_stats_period", 10), ("matmul_precision", "default"),
    ("telemetry", "/tmp/telemetry"), ("stats", True)])
def test_unported_flags_are_refused_at_other_values(name, value, tmp_path,
                                                    monkeypatch):
    """The name is kept from when the port refused all six flags.
    ``matmul_precision`` still is refused. The other five, set through
    init(), now act in the port as in the JAX package on the same steps
    from the same parameters: ``telemetry`` (a directory under
    ``tmp_path`` rather than ``value``) writes the same step log,
    ``stats`` dumps and resets the StatSet at EndPass,
    ``show_layer_stat`` and ``show_parameter_stats_period`` log the JAX
    package's lines (names and values, 1e-4 of the printed 6 digits), and
    ``trap_fpe`` raises FloatingPointError at the step whose cost is NaN,
    naming the tensor."""
    from paddle_tpu.utils.stat import global_stats as jstats
    from paddle_tpu_torch.utils.stat import global_stats

    if name == "matmul_precision":
        _check_refused(name, value)
        return
    for env in ("PADDLE_TPU_TELEMETRY", "PADDLE_TPU_TORCH_TELEMETRY",
                "PADDLE_TPU_STATS", "PADDLE_TPU_TORCH_STATS"):
        monkeypatch.delenv(env, raising=False)
    # 10 steps for a period of 10, else 6
    samples = _rows(6, 40 if name == "show_parameter_stats_period" else 24)
    if name == "trap_fpe":
        samples[9] = (np.full(20, np.nan, np.float32), 1)  # batch 2
        # JAX's trap is jax_debug_nans, which a program compiled before
        # it was switched on (by an earlier test in this process) skips:
        # start from empty compile caches, as a fresh process does
        jax.clear_caches()
        start = {}
        for pkg in (jpaddle, paddle):
            with pytest.raises(FloatingPointError) as err:
                _train_under_flags(pkg, samples, start, trap_fpe=value)
        assert "step 3 (pass 0, batch 2): the cost holds a NaN" in str(
            err.value)
        assert flags.get_flag("trap_fpe") is False
        return
    flag_values, check = ACTED_ON[name]
    global_stats.reset()
    jstats.reset()
    start = {}
    want = _train_under_flags(jpaddle, samples, start,
                              **flag_values(tmp_path, "j", value))
    got = _train_under_flags(paddle, samples, start,
                             **flag_values(tmp_path, "t", value))
    check(tmp_path, got, want)
    for key in flag_values(tmp_path, "t", value):
        assert flags.get_flag(key) == jflags.get_flag(key)


def test_ported_flags_keep_the_jax_defaults():
    for name in ("log_period", "test_period", "seed", "compute_dtype",
                 "default_dtype"):
        assert flags.get_flag(name) == jflags.get_flag(name), name


# -- the v2 surface: lazy submodules, places, Parameters, from_sequences ------

SUBMODULE_PROBE = r"""
import json, sys
import paddle_tpu_torch as paddle
out = {}
for name in sys.argv[1:]:
    try:
        mod = getattr(paddle, name)
        out[name] = ["module", mod.__name__, hasattr(paddle, name)]
    except AttributeError as exc:
        out[name] = ["error", str(exc), hasattr(paddle, name)]
print(json.dumps(out))
"""


def test_every_jax_submodule_resolves_or_raises_on_a_fresh_import():
    """paddle_tpu/__init__.py:50-76's PEP 562 names on a fresh ``import
    paddle_tpu_torch`` (a subprocess): each is the port's module of that
    name, or an AttributeError saying it is not ported yet (``hasattr``
    false); ``dir()`` lists the ported ones."""
    import json
    import subprocess
    import sys

    names = list(jpaddle._SUBMODULES)
    proc = subprocess.run([sys.executable, "-c", SUBMODULE_PROBE] + names,
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    missing = sorted(n for n, (kind, _, _) in got.items() if kind == "error")
    assert missing == ["interop", "parallel"]
    for name, (kind, text, has) in got.items():
        if kind == "module":
            assert text == "paddle_tpu_torch." + name and has, name
        else:
            assert "not ported yet" in text and not has, name
    for name in ("models", "config", "reader", "dataset", "image"):
        assert got[name][0] == "module"
    assert paddle.dataset.mnist.IMAGE_DIM == 784
    assert {"reader", "dataset", "image", "infer", "batch"} <= set(
        dir(paddle))
    assert "parallel" not in dir(paddle)
    with pytest.raises(AttributeError, match="no attribute 'nonesuch'"):
        paddle.nonesuch


def test_places_and_device_count_match_jax():
    for pkg_place in (place, jplace):
        assert pkg_place.CPUPlace() == pkg_place.CPUPlace(0)
        assert pkg_place.TPUPlace(1) != pkg_place.TPUPlace(0)
        assert pkg_place.CPUPlace() != pkg_place.TPUPlace()
    for cls in ("Place", "CPUPlace", "TPUPlace"):
        assert getattr(paddle, cls) is getattr(place, cls)
        assert repr(getattr(place, cls)()) == repr(getattr(jplace, cls)())
    assert len({place.CPUPlace(), place.CPUPlace(0), place.TPUPlace()}) == 2
    paddle.init(use_tpu=False)
    jpaddle.init(use_tpu=False)
    assert paddle.is_initialized() and jpaddle.is_initialized()
    assert paddle.default_place() == place.CPUPlace()
    assert repr(paddle.default_place()) == repr(jpaddle.default_place())
    assert place.CPUPlace().torch_device() == torch.device("cpu")
    # device_count counts the CUDA devices (none here); the CPU is one
    # torch device (the JAX package counts its virtual CPU devices)
    assert paddle.device_count() == torch.cuda.device_count()
    assert paddle.device_count(place.CPUPlace) == 1
    paddle.set_default_place(place.TPUPlace())
    assert place.default_device() == "cuda"
    paddle.set_default_place(place.CPUPlace())
    assert place.resolve_device(None) == torch.device("cpu")
    with pytest.raises(TypeError, match="expected a Place"):
        paddle.set_default_place("cpu")


def test_tpu_place_names_the_card_and_raises_without_one(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        place.TPUPlace().torch_device()


def test_parameters_dict_api_matches_jax():
    """keys, has_key, __iter__, __getitem__, __setitem__ and get_shape
    (paddle_tpu/parameters.py:49-85) on the same parameters."""
    (_, jcost), (_, cost) = _both(_mlp)
    jparams = jpaddle.parameters.create(jcost)
    params = _carry(jparams, [cost])
    assert params.keys() == jparams.keys() == list(params)
    assert list(params) == list(jparams)
    name = params.keys()[0]
    assert params.has_key(name) and jparams.has_key(name)
    assert not params.has_key("nonesuch") and not jparams.has_key("nonesuch")
    for n in params:
        np.testing.assert_array_equal(params[n], jparams[n])
        assert params.get_shape(n) == jparams.get_shape(n)
    value = np.full(params.get_shape(name), 0.25, np.float32)
    params[name] = value
    jparams[name] = value
    np.testing.assert_array_equal(params[name], jparams[name])
    assert params.as_dict()[name].dtype == torch.float32
    with pytest.raises(EnforceError, match="shape mismatch"):
        params[name] = np.zeros((1, 1), np.float32)


def test_from_sequences_pads_to_the_positional_max_len():
    from paddle_tpu.core.sequence import SequenceBatch as JaxSeq

    from paddle_tpu_torch.core.sequence import SequenceBatch

    seqs = [np.arange(3, dtype=np.int32), np.arange(7, dtype=np.int32)]
    got, want = SequenceBatch.from_sequences(seqs, 16), \
        JaxSeq.from_sequences(seqs, 16)
    assert got.max_len == want.max_len == 16
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))


def test_topology_apply_signature_matches_jax():
    """``Topology.apply`` has the JAX package's parameters, in order and
    with its defaults (``mode="train"``; ``rng`` takes a torch.Generator
    here), and returns its pair ``(values, state_updates)``."""
    import inspect

    from paddle_tpu.topology import Topology as JaxTopology

    want = inspect.signature(JaxTopology.apply).parameters
    got = inspect.signature(Topology.apply).parameters
    assert list(got) == list(want) == ["self", "params", "feed", "mode",
                                       "rng", "outputs"]
    for name in want:
        assert got[name].default == want[name].default, name
        assert got[name].kind == want[name].kind, name


def test_topology_apply_takes_numpy_feeds_and_defaults_to_train():
    """numpy feeds (and sequence batches of numpy arrays) are moved onto
    the parameters' device; the default train mode records autograd and
    returns the running-state updates, as JAX's returns them."""
    from paddle_tpu.core.sequence import SequenceBatch as JaxSequenceBatch
    from paddle_tpu.topology import Topology as JaxTopology

    def build(pkg):
        L = pkg.layer
        x = L.data(name="x", type=pkg.data_type.dense_vector(4))
        s = L.data(name="s", type=pkg.data_type.dense_vector_sequence(4))
        h = L.batch_norm(input=L.fc(input=x, size=4, name="h"), name="bn")
        return L.addto(input=[h, L.pooling(input=s, name="p")], name="o")

    jax_reset_names()
    jout = build(jpaddle)
    reset_name_counters()
    out = build(paddle)
    topo, jtopo = Topology(out), JaxTopology(jout)
    params = topo.init_params(seed=0, device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(3, 4)  # float64: narrowed to float32, as JAX does
    seq = JaxSequenceBatch.from_sequences(
        [rng.randn(n, 4).astype(np.float32) for n in (2, 3, 1)])
    np_seq = paddle.core.sequence.SequenceBatch(np.asarray(seq.data),
                                                np.asarray(seq.lengths))
    values, updates = topo.apply(params, {"x": x, "s": np_seq})
    jvalues, jupdates = jtopo.apply(
        {k: np.asarray(v) for k, v in params.items()}, {"x": x, "s": seq})
    assert values["o"].dtype == torch.float32
    assert not torch.is_inference(values["o"])
    assert sorted(updates) == sorted(jupdates) and len(updates) == 2
    np.testing.assert_allclose(values["o"].detach().numpy(),
                               np.asarray(jvalues[jout.name]), atol=TOL)
    test_values, test_updates = topo.apply(params, {"x": x, "s": np_seq},
                                           mode="test")
    assert test_updates == {} and torch.is_inference(test_values["o"])
