"""ResNet (``models.vision.resnet``) in both packages, on the CPU, small:
names, forward, training, serving and the CLI.

- Names: layers, parameters (names and shapes, HWIO conv weights and the
  batch-norm state ``.moving_mean`` / ``.moving_var``) agree with the JAX
  builder at depths 18 and 50.
- Forward: ResNet-50 at ``im_size=32, num_classes=10`` on 2 rows, the same
  numpy parameters carried into the port by ``params_from_numpy``: test
  mode (moving statistics) within 1e-4 on the probabilities, train mode
  within 1e-4 with the moving-statistic updates within 1e-4.
- Training: the model plus an ``integer_value`` label and
  ``classification_cost``, both packages' ``trainer.SGD`` with
  ``Momentum(learning_rate=0.01, momentum=0.9)`` from the same numpy
  parameters (gammas 1, betas 0, as the initialisers give) on the same
  minibatches of 4 images. ResNet-18 runs 3 steps: the first cost within
  1e-5 relative of JAX's; then both packages' float32 trajectories are
  held to the JAX package's trajectory in float64 from the same start
  (``tests/jax_float64.py``: the same graph, cost and gradients in
  float64, the Momentum step written out, in a process of its own under
  ``jax_enable_x64``). The port's own float64 trajectory agrees with it
  within 1e-10 (costs relative, parameters and moving statistics
  relative to max(1, the largest |entry|)). The port's float32 costs and
  every parameter and moving statistic are within twice JAX's float32
  departure from it, never held tighter than 1e-5, and that bound stays
  under 1e-3 (costs) and 1e-2 (parameters), so it never waves the port
  through. Three steps at this size amplify the rounding of the CPU's
  BLAS and oneDNN kernels, so a fixed bound between the two float32
  runs passes on one machine and fails on another. ResNet-50 at this size
  has a train-mode gradient that is not stable under rounding: in the JAX
  package alone, a perturbation of 1e-6 of every parameter moves some
  gradients by 22 % (in the port, in float64, by 43 %, all of it in one
  output channel of one conv), so a longer trajectory compares noise that
  the following steps amplify, in either package. It runs 1 step: the
  cost (a forward) within 1e-4 relative, every parameter and moving
  statistic within 1e-2 of max(1, its largest |entry|): lr 0.01 times a
  gradient entry that rounding alone can move by about 0.1 (these inputs
  exceed 1e-4 by 1.2e-3 on a conv weight).
- Serving: export, ``load_bundle(device="cpu")``, the batching engine and
  one ``POST /infer`` against the port's ``inference.infer``; a trained
  model's bundle carries its moving statistics; ``cli export`` / ``serve
  --selfcheck`` with the ResNet builder.
Every engine and server is stopped inside its test.
"""

import json
import urllib.request

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as jpaddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.models.vision import resnet as jax_resnet
from paddle_tpu.parameters import Parameters as JaxParameters
from paddle_tpu.topology import Topology as JaxTopology

import paddle_tpu_torch as paddle
from paddle_tpu_torch import cli
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.inference import infer
from paddle_tpu_torch.models.vision import resnet
from paddle_tpu_torch.ops import conv_kernels as ck
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.serve import (InferenceEngine, export_bundle,
                                    load_bundle, serve_in_thread)
from paddle_tpu_torch.topology import Topology
from tests import jax_float64
from tests.torch_decode import port_model

BUILDER = "paddle_tpu_torch.models.vision:resnet"
SMALL = dict(depth=50, num_classes=10, im_size=32)
WIDTH = 3 * 32 * 32


def _both(**kw):
    kw = dict(SMALL, **kw)
    jax_reset_names()
    jout = jax_resnet(**kw)
    reset_name_counters()
    out = resnet(**kw)
    return (JaxTopology(jout), jout), (Topology(out), out)


def _numpy_params(specs, seed=0, random_bn=True):
    """Weights N(0, 1/fan_in); batch-norm gammas, betas and moving
    statistics random (``random_bn``) or as the initialisers set them."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, spec in sorted(specs.items()):
        shape = spec.shape
        if name.endswith(".moving_var"):
            value = 1 + 0.5 * rng.rand(*shape) if random_bn else np.ones(shape)
        elif name.endswith(".moving_mean") or "_bn.wbias" in name:
            value = 0.2 * rng.randn(*shape) if random_bn else np.zeros(shape)
        elif "_bn.w0" in name:
            value = 1 + 0.2 * rng.randn(*shape) if random_bn else np.ones(shape)
        else:
            value = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        out[name] = value.astype(np.float32)
    return out


@pytest.mark.parametrize("depth", [18, 50])
def test_resnet_names_and_shapes_match_the_jax_builder(depth):
    (jtopo, jout), (topo, out) = _both(depth=depth)
    assert [n.name for n in topo.nodes] == [n.name for n in jtopo.nodes]
    assert [n.layer_type for n in topo.nodes] == [
        n.layer_type for n in jtopo.nodes]
    assert out.name == jout.name == "res_out"
    jspecs, specs = jtopo.param_specs(), topo.param_specs()
    assert sorted(specs) == sorted(jspecs)
    for name, spec in specs.items():
        assert spec.shape == tuple(jspecs[name].shape), name
        assert spec.is_state == bool(jspecs[name].is_state), name
    assert specs["res_stem_conv.w0"].shape == (7, 7, 3, 64)
    assert specs["res_stem_bn.moving_mean"].is_state
    for node, jnode in zip(topo.nodes, jtopo.nodes):
        assert getattr(node, "out_img_shape", None) == getattr(
            jnode, "out_img_shape", None), node.name


def test_resnet50_geometry_at_224():
    """The ceil-mode stem pool gives 57x57 at 224; the stages run at 57,
    29, 15 and 8; 46 of the 53 convs are in the kernels' family."""
    reset_name_counters()
    topo = Topology(resnet(depth=50, num_classes=1000, im_size=224))
    assert topo.by_name["res_pool1"].out_img_shape == (64, 57, 57)
    assert topo.by_name["res3_0_add"].out_img_shape == (512, 29, 29)
    assert topo.by_name["res4_0_add"].out_img_shape == (1024, 15, 15)
    assert topo.by_name["res5_2_add"].out_img_shape == (2048, 8, 8)
    convs = [n for n in topo.nodes if n.layer_type == "img_conv"]
    assert len(convs) == 53
    in_family = 0
    for node in convs:
        w = topo.param_specs()[node.name + ".w0"].shape
        parent = node.inputs[0].out_img_shape
        stride = 2 if node.out_img_shape[1] < parent[1] else 1
        pad = w[0] // 2
        in_family += ck.kernel_supported(
            (64, parent[1], parent[2], parent[0]), w, (stride, stride),
            ((pad, pad), (pad, pad)), 1, (1, 1), torch.float32,
            torch.float32)
    assert in_family == 46


def test_resnet50_forward_matches_jax():
    (jtopo, jout), (topo, out) = _both()
    np_params = _numpy_params(topo.param_specs())
    x = np.random.RandomState(1).randn(2, WIDTH).astype(np.float32)
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    params = params_from_numpy(np_params, topo, device="cpu")
    for mode in ("test", "train"):
        want, jupdates = jtopo.apply(jparams, {"image": jnp.asarray(x)},
                                     mode=mode)
        got, updates = topo.apply(params, {"image": torch.from_numpy(x)},
                                  mode=mode)
        got = got[out.name]
        assert got.shape == (2, 10)
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(want[jout.name]), rtol=1e-4,
                                   atol=1e-4)
        assert sorted(updates) == sorted(jupdates)
        assert len(updates) == (2 * 53 if mode == "train" else 0)
        for name, value in updates.items():
            np.testing.assert_allclose(value.numpy(),
                                       np.asarray(jupdates[name]),
                                       rtol=1e-4, atol=1e-4, err_msg=name)


def _cost(pkg, model, depth):
    out = model(**dict(SMALL, depth=depth))
    label = pkg.layer.data(name="label", type=pkg.data_type.integer_value(10))
    return out, pkg.layer.classification_cost(input=out, label=label)


def _batches(n, seed=0, rows=4):
    rng = np.random.RandomState(seed)
    return [[(rng.randn(WIDTH).astype(np.float32), int(rng.randint(10)))
             for _ in range(rows)] for _ in range(n)]


def _costs_of(trainer, batches, event_mod):
    costs = []
    trainer.train(lambda: iter(batches), num_passes=1, event_handler=lambda e:
                  costs.append(e.cost)
                  if isinstance(e, event_mod.EndIteration) else None)
    return costs


@pytest.mark.parametrize("depth,steps,tol_cost,tol", [(18, 3, 1e-5, 1e-5),
                                                      (50, 1, 1e-4, 1e-2)])
def test_resnet_training_trajectory_matches_jax(depth, steps, tol_cost, tol,
                                                tmp_path):
    jax_reset_names()
    _, jcost = _cost(jpaddle, jax_resnet, depth)
    reset_name_counters()
    _, cost = _cost(paddle, resnet, depth)
    topo = Topology(cost)
    np_params = _numpy_params(topo.param_specs(), seed=1, random_bn=False)
    batches = _batches(steps)

    jparams = JaxParameters.create(jcost)
    for name, value in np_params.items():
        jparams.set(name, value)
    jcosts = _costs_of(jpaddle.trainer.SGD(
        jcost, jparams, jopt.Momentum(learning_rate=0.01, momentum=0.9)),
        batches, jpaddle.event)

    params = Parameters({k: torch.from_numpy(v.copy())
                         for k, v in np_params.items()}, topo.param_specs())
    costs = _costs_of(paddle.trainer.SGD(
        cost, params, opt.Momentum(learning_rate=0.01, momentum=0.9),
        device="cpu"), batches, paddle.event)

    assert len(costs) == len(jcosts) == steps
    np.testing.assert_allclose(costs[0], jcosts[0], rtol=tol_cost)
    if steps == 1:
        want_costs, want = jcosts, {n: jparams.get(n) for n in np_params}
        jcost_gap = jgap = 0.0
    else:
        want_costs, want = jax_float64.run(
            tmp_path, "resnet-%d" % depth, np_params, batches, 0.01, 0.9)
        port_costs, port = _float64_trajectory(topo, cost, np_params,
                                               batches)
        port_gap = max(_gap(port[n], want[n]) for n in np_params)
        jcost_gap = _cost_gap(jcosts, want_costs)
        jgap = max(_gap(jparams.get(n), want[n]) for n in np_params)
        print("ResNet-%d, %d steps: the port's float64 run departs from "
              "JAX's by %.3g (costs) and %.3g (parameters); float32 "
              "departs from float64 by %.3g and %.3g in the port, by %.3g "
              "and %.3g in JAX" % (
                  depth, steps, _cost_gap(port_costs, want_costs), port_gap,
                  _cost_gap(costs, want_costs),
                  max(_gap(params.get(n), want[n]) for n in np_params),
                  jcost_gap, jgap))
        assert _cost_gap(port_costs, want_costs) <= 1e-10
        assert port_gap <= 1e-10
    cost_bound, bound = max(tol_cost, 2.0 * jcost_gap), max(tol, 2.0 * jgap)
    assert cost_bound <= 1e-3 and bound <= 1e-2
    assert _cost_gap(costs, want_costs) <= cost_bound
    for name in sorted(np_params):
        got = params.get(name)
        err = _gap(got, want[name])
        assert err <= bound, (name, err)
        # every parameter and every moving statistic moved
        assert not np.array_equal(got, np_params[name]), name


def _gap(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


def _cost_gap(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def _float64_trajectory(topo, cost, np_params, batches, lr=0.01, mu=0.9):
    """The port's training trajectory in float64, as
    ``tests/jax_float64.py`` runs the JAX package's: per batch the mean cost
    of the train-mode graph, its gradients by autograd, the moving
    statistics from the step's state updates and the Momentum step
    (v = mu * v - lr * g; p += v) from zero velocity. -> (costs, {name:
    final value})."""
    from paddle_tpu_torch.topology import convert_feed

    values = {k: torch.from_numpy(v.astype(np.float64))
              for k, v in np_params.items()}
    trainable, _, _ = Parameters(
        {k: torch.from_numpy(v) for k, v in np_params.items()},
        topo.param_specs()).partition()
    velocity = {n: torch.zeros_like(values[n]) for n in trainable}
    costs = []
    for batch in batches:
        feed = convert_feed(topo, batch, device="cpu")
        feed["image"] = feed["image"].double()
        live = {k: v.clone().requires_grad_(k in trainable)
                for k, v in values.items()}
        out, updates = topo.apply(live, feed, mode="train",
                                  outputs=[cost.name])
        loss = out[cost.name].mean()
        grads = torch.autograd.grad(loss, [live[n] for n in trainable])
        costs.append(float(loss.detach()))
        with torch.no_grad():
            for n, g in zip(trainable, grads):
                velocity[n] = mu * velocity[n] - lr * g
                values[n] = values[n] + velocity[n]
            for n, v in updates.items():
                values[n] = v.detach().double()
    return costs, {k: v.numpy() for k, v in values.items()}


def test_trainer_test_pass_and_tar_use_the_moving_statistics(tmp_path):
    """``test()`` normalises with the moving statistics (not the batch's),
    and ``save_parameter_to_tar`` writes the trained ones as state."""
    reset_name_counters()
    out, cost = _cost(paddle, resnet, 18)
    topo = Topology(cost)
    params = Parameters({k: torch.from_numpy(v) for k, v in _numpy_params(
        topo.param_specs(), seed=2).items()}, topo.param_specs())
    trainer = paddle.trainer.SGD(
        cost, params, opt.Momentum(learning_rate=0.01, momentum=0.9),
        device="cpu")
    batches = _batches(2, seed=3)
    trainer.train(lambda: iter(batches), num_passes=1)
    state = {n: params.get(n) for n in params.names() if "moving" in n}
    assert len(state) == 2 * 20
    # the trainer's own running state is what went back to Parameters
    for name, value in state.items():
        np.testing.assert_array_equal(trainer._state[name].numpy(), value)
    x = torch.from_numpy(np.stack([r[0] for r in batches[0]]))
    y = torch.tensor([r[1] for r in batches[0]], dtype=torch.int32)
    want = topo.apply(params.as_dict(), {"image": x, "label": y},
                      mode="test")[0][cost.name].float().mean()
    got = trainer.test(lambda: iter(batches[:1])).cost
    assert got == pytest.approx(float(want), rel=1e-6)
    path = tmp_path / "params.tar"
    with open(path, "wb") as fh:
        trainer.save_parameter_to_tar(fh)
    with open(path, "rb") as fh:
        back = Parameters.from_tar(fh, device="cpu")
    for name, value in state.items():
        assert back.spec(name).is_state
        np.testing.assert_array_equal(back.get(name), value)


@pytest.fixture(scope="module")
def resnet_bundle(tmp_path_factory):
    """(bundle dir, output layer, Parameters) of the small ResNet-50."""
    reset_name_counters()
    out = resnet(**SMALL)
    topo = Topology(out)
    params = Parameters({k: torch.from_numpy(v) for k, v in
                         _numpy_params(topo.param_specs(), seed=4).items()},
                        topo.param_specs())
    out_dir = str(tmp_path_factory.mktemp("resnet"))
    export_bundle(port_model(BUILDER, **SMALL), params, out_dir,
                  batch_sizes=(1, 4))
    return out_dir, out, params


def _check_rows(got, rows, out, params):
    want = infer(out, params, [(r,) for r in rows], device="cpu")
    assert got.shape == (len(rows), 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_resnet_bundle_engine_and_http_match_infer(resnet_bundle):
    out_dir, out, params = resnet_bundle
    bundle = load_bundle(out_dir, device="cpu")
    assert bundle.inputs == [{"name": "image", "kind": "dense",
                              "dim": WIDTH, "dtype": "float32"}]
    assert bundle.outputs == [{"name": "res_out", "dtype": "float32",
                               "shape_suffix": [10]}]
    rng = np.random.RandomState(0)
    engine = InferenceEngine(bundle, max_latency_ms=20.0)
    server = thread = None
    try:
        reqs = [rng.randn(n, WIDTH).astype(np.float32) for n in (1, 3, 2)]
        futures = [engine.submit({"image": r}) for r in reqs]
        for req, fut in zip(reqs, futures):
            _check_rows(fut.result(timeout=60)["res_out"], list(req), out,
                        params)
        server, thread = serve_in_thread(bundle, engine)
        req = rng.randn(1, WIDTH).astype(np.float32)
        body = json.dumps({"inputs": {"image": req.tolist()}}).encode()
        url = "http://127.0.0.1:%d/infer" % server.server_address[1]
        with urllib.request.urlopen(urllib.request.Request(
                url, data=body,
                headers={"Content-Type": "application/json"})) as fh:
            resp = json.loads(fh.read())
        _check_rows(np.asarray(resp["outputs"]["res_out"], np.float32),
                    list(req), out, params)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        engine.stop()
    stats = engine.stats()
    assert stats["requests"] == 4 and stats["batches_failed"] == 0


def test_trained_resnet_bundle_carries_its_moving_statistics(tmp_path):
    reset_name_counters()
    out, cost = _cost(paddle, resnet, 50)
    topo = Topology(cost)
    params = Parameters({k: torch.from_numpy(v) for k, v in _numpy_params(
        topo.param_specs(), seed=5, random_bn=False).items()},
        topo.param_specs())
    trainer = paddle.trainer.SGD(
        cost, params, opt.Momentum(learning_rate=0.01, momentum=0.9),
        device="cpu")
    trainer.train(lambda: iter(_batches(1, seed=6)), num_passes=1)
    out_dir = str(tmp_path / "trained")
    trainer.export_inference_bundle(port_model(BUILDER, **SMALL), out_dir,
                                    batch_sizes=(2,))
    bundle = load_bundle(out_dir, device="cpu")
    stats = [n for n in bundle.params() if n.endswith(".moving_var")]
    assert len(stats) == 53
    for name in stats:
        np.testing.assert_array_equal(bundle.params()[name].numpy(),
                                      params.get(name))
        assert not np.array_equal(params.get(name), np.ones(
            params.get(name).shape, np.float32))
    rows = np.random.RandomState(7).randn(2, WIDTH).astype(np.float32)
    _check_rows(bundle.infer({"image": rows})["res_out"], list(rows), out,
                params)


def test_cli_export_and_serve_resnet(tmp_path, capsys):
    out_dir = str(tmp_path / "b")
    assert cli.main(["export", "--builder", BUILDER, "--builder-kwargs",
                     json.dumps(SMALL), "--seed", "3", "--device", "cpu",
                     "-o", out_dir, "--batch-sizes", "1,2"]) == 0
    exported = json.loads(capsys.readouterr().out)
    assert exported["inputs"] == ["image"]
    assert exported["outputs"] == [{"name": "res_out", "dtype": "float32",
                                    "shape_suffix": [10]}]
    assert cli.main(["serve", out_dir, "--selfcheck", "--device", "cpu"]) == 0
    check = json.loads(capsys.readouterr().out)
    assert check["ok"] and check["outputs"] == {"res_out": [1, 10]}


def test_bf16_policy_resnet_tracks_f32():
    """Under the bfloat16 compute policy the convs, batch norms and pools
    run in bfloat16 (sums in float32) while the moving statistics stay
    float32; probabilities stay within bfloat16 rounding of float32."""
    from paddle_tpu_torch.core import dtype as dtype_mod

    _, (topo, out) = _both()
    params = params_from_numpy(_numpy_params(topo.param_specs()), topo,
                               device="cpu")
    feed = {"image": torch.from_numpy(
        np.random.RandomState(8).randn(2, WIDTH).astype(np.float32))}
    f32 = topo.apply(params, feed, mode="test")[0][out.name]
    dtype_mod.set_mixed_precision("bfloat16")
    try:
        bf16 = topo.apply(params, feed, mode="test")[0][out.name]
        _, updates = topo.apply(params, feed, mode="train")
    finally:
        dtype_mod.set_mixed_precision(None)
    assert bf16.dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in updates.values())
    np.testing.assert_allclose(bf16.float().numpy(), f32.numpy(), atol=3e-2)
