"""The recommender slice of the port (paddle_tpu_torch/models/
recommender.py) against the JAX package, on the CPU, small:

- Wide&Deep CTR at sparse_dim 5000 (above ``sparse_feed_threshold``, so
  the wide slot feeds as SparseRows), fields (50, 40, 10), emb 8, hidden
  (16, 8): layer and parameter names, the forward, the gradient of every
  parameter, and a 3-step ``Momentum`` trajectory through both packages'
  ``trainer.SGD`` with the wide table and the field embeddings updating
  by rows (``ParamAttr(sparse_update=True)``), plain and with an L2
  regularizer and an ``l1_rate`` on the wide table (the catch-up decay of
  rows dormant at step 2 and touched again at step 3): costs, every
  parameter, ``row_step`` equal to the JAX package's, and the wide rows
  never touched bit-equal to their initial values;
- the int8 CTR: ``paddle.infer`` over ``quantize_parameters``'s output
  (the int8 gather of ``ctr_wide_w``, the int8 fc weights in K9's plain
  version) against the JAX package's, and within the int8 gate's drift
  of fp;
- the movielens recommender at emb 8, hidden 16: the forward and a
  3-step trajectory;
- movielens bundles, fp and int8: the payload equal to the JAX package's
  bit for bit, the answers within 1e-5 of the JAX bundle's, the engine
  and HTTP; a CTR bundle at 1M sparse dims refused in both packages, a
  sparse sequence slot refused; ``sharded_mesh`` and a trainer without a
  card refused.

Tolerance: forward 1e-5, gradients 5e-6, trajectories 1e-5 (absolute,
float32: the two packages sum the same products in different orders).
"""

import json
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpaddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.dataset import movielens
from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.models import recommender as jrec
from paddle_tpu.parameters import Parameters as JaxParameters
from paddle_tpu.serve import quantize as jq
from paddle_tpu.serve.bundle import Bundle as JaxBundle
from paddle_tpu.serve.export import export_bundle as jax_export
from paddle_tpu.topology import Topology as JaxTopology
from paddle_tpu.topology import convert_feed as jax_convert_feed

import paddle_tpu_torch as paddle
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.core import place
from paddle_tpu_torch.core.sparse import SparseRows
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.models import recommender as rec
from paddle_tpu_torch.ops import int8_kernels as ik
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.serve import (InferenceEngine, export_bundle,
                                    load_bundle, serve_in_thread)
from paddle_tpu_torch.serve import quantize as pq
from paddle_tpu_torch.topology import Topology, convert_feed
from paddle_tpu_torch.utils.error import EnforceError
from tests.torch_decode import port_model

TOL_FWD = 1e-5
TOL_GRAD = 5e-6
TOL_TRAJ = 1e-5
CTR = dict(sparse_dim=5000, field_dims=(50, 40, 10), emb=8, hidden=(16, 8))
CTR_WIDE_IDS = 300  # wide ids come from the first rows only
MOVIELENS = dict(emb=8, hidden=16)
MOVIELENS_FEEDING = {"user_id": 0, "gender_id": 1, "age_id": 2,
                     "job_id": 3, "movie_id": 4, "category_ids": 5,
                     "movie_title": 6, "rating": 7}
SCORE_BUILDER = "paddle_tpu_torch.models.recommender:movielens_score"
SEQ_LEN = 8
GATE_DRIFT = 0.05  # the JAX package's int8 gate (tests/test_quantize.py)


def _both(build, config):
    """(JAX outputs, port outputs) of one builder."""
    jax_reset_names()
    jout = getattr(jrec, build)(**config)
    reset_name_counters()
    return jout, getattr(rec, build)(**config)


def _numpy_params(specs, seed=0):
    rng = np.random.RandomState(seed)
    return {name: (rng.standard_normal(spec.shape) * 0.3).astype(np.float32)
            for name, spec in sorted(specs.items())}


def _port_params(topo, arrays):
    return Parameters({k: torch.from_numpy(v.copy())
                       for k, v in arrays.items()}, topo.param_specs())


def _jax_params(jcost, arrays):
    params = JaxParameters.create(jcost)
    for name, value in arrays.items():
        params.set(name, value)
    return params


def _ctr_batches(seed=0, n=3, rows=6):
    """``n`` batches of (wide ids, field0..2, click): the wide ids of
    step 2 are disjoint from a part of step 1's, which step 3 names
    again (rows dormant over step 2, caught up at step 3)."""
    rng = np.random.RandomState(seed)
    pools = [range(0, 200), range(100, CTR_WIDE_IDS), range(0, 200)]
    out = []
    for step in range(n):
        pool = np.asarray(pools[step % 3])
        out.append([(sorted(set(rng.choice(pool, rng.randint(1, 9))
                                .tolist())),
                     int(rng.randint(50)), int(rng.randint(40)),
                     int(rng.randint(10)),
                     np.array([float(rng.randint(2))], np.float32))
                    for _ in range(rows)])
    return out


def _wide_rows(batch):
    return {i for sample in batch for i in sample[0]}


def _costs_of(pkg):
    costs = []

    def handler(evt):
        if isinstance(evt, pkg.event.EndIteration):
            costs.append(evt.cost)

    return costs, handler


# -- Wide&Deep CTR -------------------------------------------------------------

def test_ctr_names_and_forward_match_jax():
    (jlogit, _, jcost), (logit, _, cost) = _both("wide_deep_ctr", CTR)
    topo, jtopo = Topology(cost), JaxTopology(jcost)
    assert [n.name for n in topo.nodes] == [n.name for n in jtopo.nodes]
    specs, jspecs = topo.param_specs(), jtopo.param_specs()
    assert sorted(specs) == sorted(jspecs)
    for name, spec in specs.items():
        assert spec.shape == jspecs[name].shape, name
        assert spec.attr.sparse_update == jspecs[name].attr.sparse_update
    assert specs["ctr_wide_w"].shape == (5000, 1)
    assert specs["ctr_wide_w"].attr.sparse_update
    arrays = _numpy_params(specs)
    samples = [s[:4] for s in _ctr_batches()[0]]
    got = paddle.infer(logit, _port_params(topo, arrays), samples,
                       device="cpu")
    want = np.asarray(jpaddle.infer(jlogit, _jax_params(jcost, arrays),
                                    samples))
    assert got.shape == (6, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_FWD)


def test_ctr_gradients_match_jax():
    (_, _, jcost), (_, _, cost) = _both("wide_deep_ctr", CTR)
    topo, jtopo = Topology(cost), JaxTopology(jcost)
    arrays = _numpy_params(topo.param_specs(), seed=1)
    batch = _ctr_batches(seed=2)[0]
    feed = convert_feed(topo, batch, device="cpu")
    assert isinstance(feed["wide_features"], SparseRows)
    params = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in arrays.items()}
    loss = topo.apply(params, feed, mode="train")[0][cost.name].mean()
    loss.backward()
    jfeed = jax_convert_feed(jtopo, batch)

    def jloss(p):
        values, _ = jtopo.apply(p, jfeed, mode="train")
        return jnp.mean(values[jcost.name])

    jl, jgrads = jax.value_and_grad(jloss)(
        {k: jnp.asarray(v) for k, v in arrays.items()})
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=0,
                               atol=TOL_FWD)
    for name, p in params.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[name]),
                                   rtol=0, atol=TOL_GRAD, err_msg=name)
    # the wide gradient is dense, nonzero only on the batch's ids
    wide = params["ctr_wide_w"].grad.numpy()[:, 0]
    assert set(np.flatnonzero(wide)) <= _wide_rows(batch)
    assert np.count_nonzero(wide) > 0


@pytest.mark.parametrize("reg", ["none", "l2_and_l1_rate"])
def test_ctr_momentum_trajectory_matches_jax(reg):
    (_, _, jcost), (_, _, cost) = _both("wide_deep_ctr", CTR)
    topo = Topology(cost)
    arrays = _numpy_params(topo.param_specs(), seed=3)
    batches = _ctr_batches(seed=4)
    kw = dict(learning_rate=0.1, momentum=0.9)
    jkw = dict(kw)
    params, jparams = _port_params(topo, arrays), _jax_params(jcost, arrays)
    if reg != "none":
        kw["regularization"] = opt.L2Regularization(rate=0.05)
        jkw["regularization"] = jopt.L2Regularization(rate=0.05)
        params.spec("ctr_wide_w").attr.l1_rate = 0.02
        jparams.spec("ctr_wide_w").attr.l1_rate = 0.02

    jtrainer = jpaddle.trainer.SGD(jcost, jparams, jopt.Momentum(**jkw))
    jcosts, jhandler = _costs_of(jpaddle)
    jtrainer.train(lambda: iter(batches), num_passes=1,
                   event_handler=jhandler)
    trainer = paddle.trainer.SGD(cost, params, opt.Momentum(**kw),
                                 device="cpu")
    costs, handler = _costs_of(paddle)
    trainer.train(lambda: iter(batches), num_passes=1, event_handler=handler)

    assert len(costs) == len(jcosts) == 3
    np.testing.assert_allclose(costs, jcosts, rtol=0, atol=TOL_TRAJ)
    for name in sorted(arrays):
        np.testing.assert_allclose(params.get(name), jparams.get(name),
                                   rtol=0, atol=TOL_TRAJ, err_msg=name)
    row_step, jrow_step = (trainer._opt_state["row_step"],
                           jtrainer._opt_state["row_step"])
    assert sorted(row_step) == sorted(jrow_step) == [
        "ctr_field0_emb.w0", "ctr_field1_emb.w0", "ctr_field2_emb.w0",
        "ctr_wide_w"]
    for name in row_step:
        assert row_step[name].dtype == torch.int32
        np.testing.assert_array_equal(row_step[name].numpy(),
                                      np.asarray(jrow_step[name]))
    wide_steps = row_step["ctr_wide_w"].numpy()
    touched = [_wide_rows(b) for b in batches]
    caught_up = (touched[0] & touched[2]) - touched[1]
    assert caught_up and all(wide_steps[i] == 3 for i in caught_up)
    never = sorted(set(range(5000)) - set.union(*touched))
    assert (wide_steps[never] == 0).all()
    np.testing.assert_array_equal(params.get("ctr_wide_w")[never],
                                  arrays["ctr_wide_w"][never])


def test_ctr_int8_infer_matches_jax():
    (jlogit, _, jcost), (logit, _, cost) = _both("wide_deep_ctr", CTR)
    topo, jtopo = Topology(logit), JaxTopology(jlogit)
    arrays = _numpy_params(Topology(cost).param_specs(), seed=5)
    fp = _port_params(Topology(cost), arrays)
    qparams, qmanifest = pq.quantize_parameters(fp, topo)
    jqparams, jqmanifest = jq.quantize_parameters(
        _jax_params(jcost, arrays), jtopo)
    assert qmanifest == jqmanifest
    assert sorted(qmanifest["params"]) == [
        "ctr_deep.w0", "ctr_h0.w0", "ctr_h0.w1", "ctr_h0.w2", "ctr_h1.w0",
        "ctr_wide_w"]
    for name in qparams.names():
        assert qparams.get(name).tobytes() == np.asarray(
            jqparams.get(name)).tobytes(), name
    assert qparams.get("ctr_wide_w").dtype == np.int8
    samples = [s[:4] for s in _ctr_batches(seed=6)[0]]
    before = ik.launches
    got = paddle.infer(logit, qparams, samples, device="cpu")
    assert ik.launches == before  # the CPU runs K9's plain version
    want = np.asarray(jpaddle.infer(jlogit, jqparams, samples))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_FWD)
    drift = np.abs(got - paddle.infer(logit, fp, samples, device="cpu"))
    assert float(drift.max()) <= GATE_DRIFT


# -- movielens -----------------------------------------------------------------

def _movielens_rows(n, seed):
    return list(movielens._synthetic(n, seed)())


def test_movielens_forward_matches_jax():
    (jscore, _, jcost), (score, _, cost) = _both("movielens_recommender",
                                                 MOVIELENS)
    topo = Topology(cost)
    assert sorted(topo.param_specs()) == sorted(
        JaxTopology(jcost).param_specs())
    arrays = _numpy_params(topo.param_specs(), seed=7)
    samples = [r[:7] for r in _movielens_rows(12, 8)]
    got = paddle.infer(score, _port_params(topo, arrays), samples,
                       device="cpu")
    want = np.asarray(jpaddle.infer(jscore, _jax_params(jcost, arrays),
                                    samples))
    assert got.shape == (12, 1) and np.abs(got).max() <= 5.0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_FWD)


def test_movielens_momentum_trajectory_matches_jax():
    (_, _, jcost), (_, _, cost) = _both("movielens_recommender", MOVIELENS)
    topo = Topology(cost)
    arrays = _numpy_params(topo.param_specs(), seed=9)
    rows = _movielens_rows(60, 10)
    batches = [rows[i:i + 20] for i in range(0, 60, 20)]
    params, jparams = _port_params(topo, arrays), _jax_params(jcost, arrays)
    jtrainer = jpaddle.trainer.SGD(jcost, jparams, jopt.Momentum(
        learning_rate=0.05, momentum=0.9))
    jcosts, jhandler = _costs_of(jpaddle)
    jtrainer.train(lambda: iter(batches), num_passes=1,
                   feeding=MOVIELENS_FEEDING, event_handler=jhandler)
    trainer = paddle.trainer.SGD(cost, params, opt.Momentum(
        learning_rate=0.05, momentum=0.9), device="cpu")
    costs, handler = _costs_of(paddle)
    trainer.train(lambda: iter(batches), num_passes=1,
                  feeding=MOVIELENS_FEEDING, event_handler=handler)
    assert len(costs) == 3 and costs[0] != costs[-1]
    # the costs are sums of squares of ratings up to 5: compare them
    # relative to their size
    np.testing.assert_allclose(costs, jcosts, rtol=TOL_TRAJ, atol=TOL_TRAJ)
    for name in sorted(arrays):
        np.testing.assert_allclose(params.get(name), jparams.get(name),
                                   rtol=0, atol=TOL_TRAJ, err_msg=name)


# -- the movielens layers alone ------------------------------------------------

def _both_values_and_grads(build, samples, outputs, seed=0):
    """``build(pkg)`` (the cost node) in both packages from the same
    numpy-seeded parameters and ``samples``: the values of the layers
    ``outputs`` (the cost's per-sample values last) and the gradient of
    the mean cost with respect to every parameter, port then JAX."""
    reset_name_counters()
    cost = build(paddle)
    jax_reset_names()
    jcost = build(jpaddle)
    topo, jtopo = Topology(cost), JaxTopology(jcost)
    arrays = _numpy_params(topo.param_specs(), seed)
    params = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in arrays.items()}
    values, _ = topo.apply(params, convert_feed(topo, samples, device="cpu"),
                        mode="train", outputs=outputs)
    values[outputs[-1]].mean().backward()
    jfeed = jax_convert_feed(jtopo, samples)

    def jloss(p):
        jvalues, _ = jtopo.apply(p, jfeed, mode="train", outputs=outputs)
        return jnp.mean(jvalues[outputs[-1]]), jvalues

    (_, jvalues), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in arrays.items()})
    port = ({k: v.detach().numpy() for k, v in values.items()},
            {k: p.grad.numpy() for k, p in params.items()})
    return port, ({k: np.asarray(v) for k, v in jvalues.items()},
                  {k: np.asarray(g) for k, g in jgrads.items()})


def _assert_values_and_grads_match(port, jax_side):
    (values, grads), (jvalues, jgrads) = port, jax_side
    assert sorted(values) == sorted(jvalues)
    for name in values:
        np.testing.assert_allclose(values[name], jvalues[name], rtol=0,
                                   atol=TOL_FWD, err_msg=name)
    assert sorted(grads) == sorted(jgrads)
    for name in grads:
        assert np.abs(grads[name]).max() > 0, name
        np.testing.assert_allclose(grads[name], jgrads[name], rtol=0,
                                   atol=TOL_GRAD, err_msg=name)


@pytest.mark.parametrize("size", [1, 3])
def test_cos_sim_forward_and_gradient_match_jax(size):
    """cos_sim(a, b, scale, size): with size > 1, b's row is read as
    ``size`` vectors of a's width, each compared against a."""
    def build(pkg):
        L, dt = pkg.layer, pkg.data_type
        x = L.data(name="x", type=dt.dense_vector(5))
        y = L.data(name="y", type=dt.dense_vector(6))
        target = L.data(name="t", type=dt.dense_vector(size))
        a = L.fc(input=x, size=4, name="cs_a")
        b = L.fc(input=y, size=4 * size, name="cs_b")
        sim = L.cos_sim(a=a, b=b, scale=2.5, size=size, name="cs_sim")
        return L.square_error_cost(input=sim, label=target, name="cs_cost")

    rng = np.random.RandomState(20 + size)
    samples = [(rng.randn(5).astype(np.float32),
                rng.randn(6).astype(np.float32),
                rng.uniform(-2.5, 2.5, size).astype(np.float32))
               for _ in range(7)]
    port, jax_side = _both_values_and_grads(build, samples,
                                            ["cs_sim", "cs_cost"], seed=3)
    _assert_values_and_grads_match(port, jax_side)
    sim = port[0]["cs_sim"]
    assert sim.shape == (7, size) and np.abs(sim).max() <= 2.5
    # each of the size columns compares a with its own slice of b
    a, b = (np.stack([s[0] for s in samples]), np.stack([s[1] for s in
                                                         samples]))
    reset_name_counters()
    cost = build(paddle)
    topo = Topology(cost)
    arrays = _numpy_params(topo.param_specs(), 3)
    fa = a @ arrays["cs_a.w0"] + arrays["cs_a.wbias"]
    fb = (b @ arrays["cs_b.w0"] + arrays["cs_b.wbias"]).reshape(7, size, 4)
    want = 2.5 * np.einsum("bd,bsd->bs", fa, fb) / (
        np.linalg.norm(fa, axis=-1)[:, None] * np.linalg.norm(fb, axis=-1))
    np.testing.assert_allclose(sim, want, rtol=0, atol=TOL_FWD)


@pytest.mark.parametrize("cost_name", ["square_error_cost", "mse_cost",
                                       "regression_cost"])
def test_square_error_cost_with_weight_matches_jax(cost_name):
    def build(pkg):
        L, dt = pkg.layer, pkg.data_type
        x = L.data(name="x", type=dt.dense_vector(5))
        target = L.data(name="t", type=dt.dense_vector(3))
        weight = L.data(name="w", type=dt.dense_vector(1))
        h = L.fc(input=x, size=3, act=pkg.activation.Tanh(), name="se_h")
        return getattr(L, cost_name)(input=h, label=target, weight=weight,
                                     name="se_cost")

    assert getattr(paddle.layer, cost_name) is paddle.layer.square_error_cost
    rng = np.random.RandomState(30)
    samples = [(rng.randn(5).astype(np.float32),
                rng.randn(3).astype(np.float32),
                np.array([rng.uniform(0.1, 3.0)], np.float32))
               for _ in range(6)]
    port, jax_side = _both_values_and_grads(build, samples,
                                            ["se_h", "se_cost"], seed=4)
    _assert_values_and_grads_match(port, jax_side)
    # each sample's cost is its weight times 0.5 * |h - t|^2
    h, cost = port[0]["se_h"], port[0]["se_cost"]
    t = np.stack([s[1] for s in samples])
    w = np.array([s[2][0] for s in samples])
    np.testing.assert_allclose(cost, w * 0.5 * ((h - t) ** 2).sum(-1),
                               rtol=0, atol=TOL_FWD)


# -- movielens bundles ---------------------------------------------------------

def _score_request(rng, rows):
    """Flat inputs of the score bundle: ids, the category slot densified
    (its manifest kind is ``dense``) and the padded title ids."""
    samples = _movielens_rows(rows, int(rng.randint(1000)))
    cats = np.zeros((rows, 19), np.float32)
    title = np.zeros((rows, SEQ_LEN), np.int32)
    lens = np.zeros((rows,), np.int32)
    for i, s in enumerate(samples):
        for c in s[5]:
            cats[i, c] += 1.0
        lens[i] = min(len(s[6]), SEQ_LEN)
        title[i, :lens[i]] = s[6][:lens[i]]
    req = {name: np.asarray([s[col] for s in samples], np.int32)
           for name, col in (("user_id", 0), ("gender_id", 1),
                             ("age_id", 2), ("job_id", 3),
                             ("movie_id", 4))}
    req.update({"category_ids": cats, "movie_title": title,
                "movie_title:lens": lens})
    return req


@pytest.fixture(scope="module", params=["fp", "int8"])
def score_bundles(request, tmp_path_factory):
    """The movielens score head exported by both packages from the same
    numpy parameters (fp or int8); returns (port dir, JAX dir)."""
    quantize = "int8" if request.param == "int8" else None
    (jscore, _, _), _ = _both("movielens_recommender", MOVIELENS)
    reset_name_counters()
    score = rec.movielens_score(**MOVIELENS)
    arrays = _numpy_params(Topology(score).param_specs(), seed=11)
    tmp = tmp_path_factory.mktemp("ml_" + request.param)
    port_dir, jax_dir = str(tmp / "port"), str(tmp / "jax")
    manifest = export_bundle(port_model(SCORE_BUILDER, **MOVIELENS),
                             _port_params(Topology(score), arrays), port_dir,
                             batch_sizes=(1, 4), seq_len=SEQ_LEN,
                             quantize=quantize)
    jparams = JaxParameters()
    jparams._specs = JaxTopology(jscore).param_specs()
    jparams._values = {k: jnp.asarray(v) for k, v in arrays.items()}
    jmanifest = jax_export(jscore, jparams, jax_dir, batch_sizes=(1, 4),
                           seq_len=SEQ_LEN, quantize=quantize)
    assert [(s["name"], s["kind"], s["dim"]) for s in manifest["inputs"]] \
        == [(s["name"], s["kind"], s["dim"]) for s in jmanifest["inputs"]]
    assert {s["name"]: s["kind"] for s in manifest["inputs"]}[
        "category_ids"] == "dense"
    assert manifest.get("quantization") == jmanifest.get("quantization")
    return port_dir, jax_dir


def test_movielens_bundle_payload_and_answers_match_jax(score_bundles):
    port_dir, jax_dir = score_bundles
    with np.load(port_dir + "/params.npz") as a, \
            np.load(jax_dir + "/params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            assert a[name].tobytes() == b[name].tobytes(), name
    port, ref = load_bundle(port_dir, device="cpu"), JaxBundle(jax_dir)
    if port.quantization:
        assert len(port.quantization["params"]) == 8
        assert port.params()["rec_cat_fc.w0"].dtype == torch.int8
    rng = np.random.RandomState(12)
    for rows in (1, 3, 4):
        req = _score_request(rng, rows)
        np.testing.assert_allclose(port.infer(req)["rec_score"],
                                   ref.infer(req)["rec_score"], rtol=0,
                                   atol=TOL_FWD)


def test_movielens_bundle_engine_and_http_match_the_bundle(score_bundles):
    bundle = load_bundle(score_bundles[0], device="cpu")
    rng = np.random.RandomState(13)
    reqs = [_score_request(rng, n) for n in (1, 3, 2, 4)]
    engine = InferenceEngine(bundle, max_latency_ms=20.0)
    server = thread = None
    try:
        for req, fut in zip(reqs, [engine.submit(r) for r in reqs]):
            np.testing.assert_allclose(fut.result(timeout=60)["rec_score"],
                                       bundle.infer(req)["rec_score"],
                                       rtol=0, atol=1e-6)
        server, thread = serve_in_thread(bundle, engine)
        body = json.dumps({"inputs": {k: v.tolist()
                                      for k, v in reqs[1].items()}}).encode()
        url = "http://127.0.0.1:%d/infer" % server.server_address[1]
        with urllib.request.urlopen(urllib.request.Request(
                url, data=body,
                headers={"Content-Type": "application/json"})) as fh:
            resp = json.loads(fh.read())
        np.testing.assert_allclose(
            np.asarray(resp["outputs"]["rec_score"], np.float32),
            bundle.infer(reqs[1])["rec_score"], rtol=0, atol=1e-6)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        engine.stop()


def test_ctr_bundle_at_1m_dims_is_refused_in_both_packages(tmp_path):
    config = dict(CTR, sparse_dim=1_000_000)
    (jlogit, _, _), (logit, _, _) = _both("wide_deep_ctr", config)
    arrays = _numpy_params(Topology(logit).param_specs())
    match = "sparse slots at/above sparse_feed_threshold"
    with pytest.raises(EnforceError, match=match):
        export_bundle(port_model(
            "paddle_tpu_torch.models.recommender:wide_deep_ctr", **config),
            _port_params(Topology(logit), arrays), str(tmp_path / "port"))
    jparams = JaxParameters()
    jparams._specs = JaxTopology(jlogit).param_specs()
    jparams._values = {k: jnp.asarray(v) for k, v in arrays.items()}
    with pytest.raises(Exception, match=match):
        jax_export(jlogit, jparams, str(tmp_path / "jax"))


def test_sparse_sequence_slot_export_is_refused():
    from paddle_tpu_torch import data_type, layer
    from paddle_tpu_torch.serve.export import _input_specs

    reset_name_counters()
    x = layer.data(name="bags",
                   type=data_type.sparse_binary_vector_sequence(10))
    with pytest.raises(EnforceError, match="sparse sequence slots are not "
                       "exportable"):
        _input_specs(Topology(layer.pooling(input=x)))


def test_sharded_ctr_and_a_trainer_without_a_card_are_refused(monkeypatch):
    """The name is kept from when the sharded CTR was refused: it now
    builds its field embeddings vocab-sharded over the mesh's ``model``
    axis (tests/test_torch_parallel.py trains it in a world of ranks); a
    trainer without a card is still refused."""
    from paddle_tpu_torch.parallel import build_mesh

    reset_name_counters()
    _, _, sharded = rec.wide_deep_ctr(
        sharded_mesh=build_mesh({"data": 1, "model": 1}), **CTR)
    topo = Topology(sharded)
    assert [topo.by_name["ctr_field%d_emb" % i].layer_type
            for i in range(3)] == ["sharded_embedding"] * 3
    assert topo.param_specs()["ctr_field0_emb.w0"].sharding.spec == \
        ("model", None)
    reset_name_counters()
    _, _, cost = rec.wide_deep_ctr(**CTR)
    params = Parameters.create(cost, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    default = place.default_device()
    place.set_default_device("cuda")
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            paddle.trainer.SGD(cost, params, opt.Momentum(
                learning_rate=1e-2, momentum=0.9))
    finally:
        place.set_default_device(default)
    paddle.trainer.SGD(cost, params, opt.Momentum(learning_rate=1e-2,
                                                  momentum=0.9),
                       device="cpu")
