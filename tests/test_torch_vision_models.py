"""GoogleNet, AlexNet, smallnet_cifar and LeNet (``models.vision``) and
the layers they bring (concat, dropout, img_cmrnorm) in both packages, on
the CPU, with parameters and inputs made by numpy from a seed.

- Names: layers (names, types, image shapes) and parameters (names,
  shapes) agree with the JAX builders; GoogleNet reaches 7x7x1024 before
  goog_pool5 and sends 47 of its 57 convs to the hand-written kernels,
  AlexNet reaches 6x6x256 before alex_fc6 and sends 3 of 5.
- Forward: GoogleNet (224x224) and AlexNet (227x227) in test mode on 2
  images within 1e-4 of max(1, max |JAX|); under the bfloat16 policy
  GoogleNet's probabilities stay within 3e-2 of float32.
- Training: one ``trainer.SGD`` + ``Momentum(0.01, 0.9)`` step of each
  against the JAX trainer, with the same dropout masks on both sides (the
  JAX trainer's ``jax.random.bernoulli`` and the port's
  ``ops.dropout.keep_mask`` replaced, in the test only, by numpy masks,
  one per dropout layer and the same at every step, since the JAX step
  takes its mask when it is traced): cost within 1e-5 relative, every
  parameter within 1e-4 of max(1, its largest |entry|); GoogleNet's
  float32 step at a saturated start (every weight at N(0, 2/fan_in))
  against the same step in float64, within 1e-4; and a 3-step
  smallnet_cifar trajectory within 1e-5.
- ``concat`` on images (NHWC channels), flat rows and sequences;
  ``cross_map_norm`` / ``cross_map_norm_auto`` values and gradients,
  C > 1024 included (1e-5); dropout's seed determinism, kept share,
  scaling and identity in test mode, and the trainer's generator.

Parameters come from numpy by spec name and shape (JAX's init of
GoogleNet takes about 25 s here) and are shared by module-scoped
fixtures.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpaddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.sequence import SequenceBatch as JaxSequenceBatch
from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.models import vision as jax_vision
from paddle_tpu.ops import conv as jax_conv
from paddle_tpu.parameters import Parameters as JaxParameters
from paddle_tpu.topology import Topology as JaxTopology

import paddle_tpu_torch as paddle
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.graph import Context, reset_name_counters
from paddle_tpu_torch.models import vision
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops import conv_kernels as ck
from paddle_tpu_torch.ops import dropout as dropout_ops
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.topology import Topology
from paddle_tpu_torch.utils import flags
from paddle_tpu_torch.utils.error import EnforceError
from tests import jax_float64

MODELS = {"googlenet": (3 * 224 * 224, 1000),
          "alexnet": (3 * 227 * 227, 1000), "smallnet_cifar": (3072, 10),
          "lenet": (784, 10)}


def _build(pkg_vision, name, with_cost=False):
    out = getattr(pkg_vision, name)()
    if not with_cost:
        return out, None
    pkg = jpaddle if pkg_vision is jax_vision else paddle
    label = pkg.layer.data(name="label", type=pkg.data_type.integer_value(
        MODELS[name][1]))
    return out, pkg.layer.classification_cost(input=out, label=label)


def _both(name, with_cost=False):
    jax_reset_names()
    jout, jcost = _build(jax_vision, name, with_cost)
    reset_name_counters()
    out, cost = _build(vision, name, with_cost)
    return (jout, jcost), (out, cost)


OUTPUT_WEIGHTS = ("goog_out.w0", "alex_fc8.w0", "small_out.w0", "lenet_out.w0")


def _numpy_params(specs, seed):
    """Weights N(0, 2/fan_in) (fan_in: all but the last axis), so the
    activations keep their scale through GoogleNet's 22 weight layers;
    the output layer's N(0, 0.01/fan_in), so the first cost is near
    ln(classes), as at a real start; biases N(0, 0.01^2)."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, spec in sorted(specs.items()):
        shape = spec.shape
        if name.endswith(".wbias"):
            value = 0.01 * rng.randn(*shape)
        else:
            gain = 0.01 if name in OUTPUT_WEIGHTS else 2.0
            value = rng.randn(*shape) * np.sqrt(gain / np.prod(shape[:-1]))
        out[name] = value.astype(np.float32)
    return out


def _jax_parameters(jtopo, np_params):
    """JAX Parameters holding ``np_params`` without running its init."""
    params = JaxParameters()
    params._specs = dict(jtopo.param_specs())
    params._values = {k: v.copy() for k, v in np_params.items()}
    return params


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(1.0,
                                                  float(np.abs(want).max()))


@pytest.fixture(scope="module")
def nets():
    """{name: (JAX topology, JAX cost, port topology, port cost, numpy
    parameters)} of the models with a label and classification_cost."""
    out = {}
    for i, name in enumerate(("googlenet", "alexnet", "smallnet_cifar")):
        (jout, jcost), (pout, cost) = _both(name, with_cost=True)
        jtopo, topo = JaxTopology(jcost), Topology(cost)
        out[name] = (jtopo, jcost, topo, cost, jout, pout,
                     _numpy_params(topo.param_specs(), seed=i))
    return out


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(7)
    return {name: rng.randn(2, width).astype(np.float32)
            for name, (width, _) in MODELS.items()}


# -- names and geometry ------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_names_and_shapes_match_the_jax_builder(name):
    (jout, _), (out, _) = _both(name)
    jtopo, topo = JaxTopology(jout), Topology(out)
    assert [n.name for n in topo.nodes] == [n.name for n in jtopo.nodes]
    assert [n.layer_type for n in topo.nodes] == [
        n.layer_type for n in jtopo.nodes]
    assert [n.size for n in topo.nodes] == [n.size for n in jtopo.nodes]
    for node, jnode in zip(topo.nodes, jtopo.nodes):
        assert getattr(node, "out_img_shape", None) == getattr(
            jnode, "out_img_shape", None), node.name
    jspecs, specs = jtopo.param_specs(), topo.param_specs()
    assert sorted(specs) == sorted(jspecs)
    for pname, spec in specs.items():
        assert spec.shape == tuple(jspecs[pname].shape), pname


def _kernel_convs(topo):
    """(kernel-family convs, all convs) of a topology, by the family's
    predicate at the layer's own geometry."""
    convs = [n for n in topo.nodes if n.layer_type == "img_conv"]
    n_kernel = 0
    for node in convs:
        w = topo.param_specs()[node.name + ".w0"].shape
        parent = node.inputs[0].out_img_shape
        stride = 1 if node.out_img_shape[1] == parent[1] else 2
        pad = w[0] // 2
        n_kernel += ck.kernel_supported(
            (2, parent[1], parent[2], parent[0]), w, (stride, stride),
            ((pad, pad), (pad, pad)), 1, (1, 1), torch.float32,
            torch.float32)
    return n_kernel, len(convs)


def test_googlenet_and_alexnet_geometry():
    reset_name_counters()
    goog = Topology(vision.googlenet())
    assert goog.by_name["goog_5b_concat"].out_img_shape == (1024, 7, 7)
    assert goog.by_name["goog_pool5"].out_img_shape == (1024, 1, 1)
    assert goog.by_name["goog_3a_concat"].out_img_shape == (256, 28, 28)
    assert _kernel_convs(goog) == (47, 57)
    reset_name_counters()
    alex = Topology(vision.alexnet())
    assert alex.by_name["alex_pool5"].out_img_shape == (256, 6, 6)
    assert alex.by_name["alex_norm1"].out_img_shape == (96, 55, 55)
    assert _kernel_convs(alex) == (3, 5)
    assert [n.name for n in alex.nodes if n.layer_type == "dropout"] == [
        "__dropout_0__", "__dropout_1__"]


# -- forward -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["googlenet", "alexnet"])
def test_forward_matches_jax(nets, images, name):
    jtopo, _, topo, _, jout, out, np_params = nets[name]
    x = images[name]
    labels = np.zeros(2, np.int32)
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    forward = jax.jit(lambda p, img: jtopo.apply(
        p, {"image": img, "label": jnp.asarray(labels)}, mode="test",
        outputs=[jout.name])[0][jout.name])
    want = np.asarray(forward(jparams, jnp.asarray(x)))
    params = {k: torch.from_numpy(v) for k, v in np_params.items()}
    got = topo.apply(params, {"image": torch.from_numpy(x),
                              "label": torch.from_numpy(labels)},
                     outputs=[out.name], mode="test")[0][out.name].numpy()
    assert got.shape == (2, 1000)
    assert _rel(got, want) <= 1e-4
    # the probabilities are not uniform: the signal reached the output
    assert float(want.max()) > 2.0 / 1000


def test_bf16_policy_googlenet_forward_tracks_f32(nets, images):
    _, _, topo, _, _, out, np_params = nets["googlenet"]
    params = {k: torch.from_numpy(v) for k, v in np_params.items()}
    feed = {"image": torch.from_numpy(images["googlenet"]),
            "label": torch.zeros(2, dtype=torch.int32)}
    f32 = topo.apply(params, feed, mode="test",
                     outputs=[out.name])[0][out.name]
    dtype_mod.set_mixed_precision("bfloat16")
    try:
        bf16 = topo.apply(params, feed, mode="test",
                          outputs=[out.name])[0][out.name]
    finally:
        dtype_mod.set_mixed_precision(None)
    assert bf16.dtype == torch.bfloat16
    assert _rel(bf16.float().numpy(), f32.numpy()) <= 3e-2


# -- training ----------------------------------------------------------------

class _Masks:
    """Numpy keep-masks handed out in call order, one per dropout layer,
    the same at every step."""

    def __init__(self, shapes, keep, seed):
        rng = np.random.RandomState(seed)
        self.masks = [rng.rand(*s) < keep for s in shapes]
        self.calls = 0

    def next(self, shape):
        mask = self.masks[self.calls % len(self.masks)]
        self.calls += 1
        assert tuple(mask.shape) == tuple(shape)
        return mask


def _same_masks(monkeypatch, shapes, keep, seed):
    jmasks, pmasks = _Masks(shapes, keep, seed), _Masks(shapes, keep, seed)

    def jax_bernoulli(key, p, shape):
        assert p == pytest.approx(keep)
        return jnp.asarray(jmasks.next(shape))

    def keep_mask(shape, p, generator, device):
        assert p == pytest.approx(keep)
        return torch.from_numpy(pmasks.next(shape)).to(device)

    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(dropout_ops, "keep_mask", keep_mask)
    return jmasks, pmasks


def _costs_of(trainer, batches, event_mod):
    costs = []
    trainer.train(lambda: iter(batches), num_passes=1, event_handler=lambda e:
                  costs.append(e.cost)
                  if isinstance(e, event_mod.EndIteration) else None)
    return costs


def _batches(name, n, rows, seed):
    width, classes = MODELS[name]
    rng = np.random.RandomState(seed)
    return [[(rng.randn(width).astype(np.float32), int(rng.randint(classes)))
             for _ in range(rows)] for _ in range(n)]


def _train_both(nets, name, batches, lr=0.01):
    jtopo, jcost, topo, cost, _, _, np_params = nets[name]
    jparams = _jax_parameters(jtopo, np_params)
    jcosts = _costs_of(jpaddle.trainer.SGD(
        jcost, jparams, jopt.Momentum(learning_rate=lr, momentum=0.9)),
        batches, jpaddle.event)
    params = Parameters({k: torch.from_numpy(v.copy())
                         for k, v in np_params.items()}, topo.param_specs())
    costs = _costs_of(paddle.trainer.SGD(
        cost, params, opt.Momentum(learning_rate=lr, momentum=0.9),
        device="cpu"), batches, paddle.event)
    return (jcosts, jparams), (costs, params), np_params


@pytest.mark.parametrize("name,mask_shapes,keep", [
    ("googlenet", [(2, 1, 1, 1024)], 0.6),
    ("alexnet", [(2, 4096), (2, 4096)], 0.5)])
def test_train_step_matches_jax_with_the_same_dropout_masks(
        monkeypatch, nets, name, mask_shapes, keep):
    jmasks, pmasks = _same_masks(monkeypatch, mask_shapes, keep, seed=3)
    (jcosts, jparams), (costs, params), np_params = _train_both(
        nets, name, _batches(name, 1, 2, seed=5))
    # each side drew each layer's mask (JAX once, when it traced the step)
    assert jmasks.calls >= len(mask_shapes)
    assert pmasks.calls == len(mask_shapes)
    assert len(costs) == len(jcosts) == 1
    np.testing.assert_allclose(costs, jcosts, rtol=1e-5)
    for pname in sorted(np_params):
        got, want = params.get(pname), jparams.get(pname)
        assert _rel(got, want) <= 1e-4, pname
        assert not np.array_equal(got, np_params[pname]), pname


def test_googlenet_step_at_a_saturated_start_matches_float64(
        monkeypatch, nets, tmp_path):
    """One float32 ``trainer.SGD`` + ``Momentum(0.01, 0.9)`` step of
    GoogleNet with every weight at N(0, 2/fan_in), the output layer
    included: a saturated start (first cost 15.9, far above ln 1000),
    where the gradient is ill-conditioned. Against the same step in
    float64: the JAX package's cost and gradient of the same graph in
    float64, then the first Momentum step from zero velocity, p - lr * g
    (``tests/jax_float64.py``, in a process of its own under
    ``jax_enable_x64``). The port's same step in float64 agrees with it
    within 1e-10 (relative to max(1, the largest |entry|)). The port's
    float32 cost is within 1e-6 relative of it, and every updated
    parameter as close to it as the JAX trainer's float32 step from the
    same start is. The float32 rounding of this step depends on the
    CPU's BLAS and oneDNN kernels, so the bound is measured on the
    machine that runs the test, from the JAX package alone: twice the
    JAX step's departure from float64, and never below 1e-4, the
    tolerance of the JAX parity test above; and that bound stays under
    1e-2, so it never waves the port through."""
    jtopo, jcost, topo, cost, _, _, _ = nets["googlenet"]
    specs = topo.param_specs()
    rng = np.random.RandomState(0)
    np_params = {name: (0.01 * rng.randn(*spec.shape) if
                        name.endswith(".wbias") else
                        rng.randn(*spec.shape)
                        * np.sqrt(2.0 / np.prod(spec.shape[:-1])))
                 for name, spec in sorted(specs.items())}
    mask = np.random.RandomState(3).rand(2, 1, 1, 1024) < 0.6
    monkeypatch.setattr(dropout_ops, "keep_mask",
                        lambda shape, p, generator, device:
                        torch.from_numpy(mask).to(device))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(mask))
    batches = _batches("googlenet", 1, 2, seed=5)
    lr = 0.01

    jparams = _jax_parameters(jtopo, {k: v.astype(np.float32)
                                      for k, v in np_params.items()})
    _costs_of(jpaddle.trainer.SGD(
        jcost, jparams, jopt.Momentum(learning_rate=lr, momentum=0.9)),
        batches, jpaddle.event)

    params = Parameters({k: torch.from_numpy(v.astype(np.float32))
                         for k, v in np_params.items()}, specs)
    (cost32,) = _costs_of(paddle.trainer.SGD(
        cost, params, opt.Momentum(learning_rate=lr, momentum=0.9),
        device="cpu"), batches, paddle.event)

    wide = {k: torch.from_numpy(v).requires_grad_()
            for k, v in np_params.items()}
    feed = {"image": torch.from_numpy(np.stack([r for r, _ in batches[0]])),
            "label": torch.tensor([label for _, label in batches[0]])}
    value = topo.apply(wide, {**feed, "image": feed["image"].double()},
                       mode="train", outputs=[cost.name],
                       rng=torch.Generator())[0][cost.name].mean()
    names = sorted(wide)
    grads = dict(zip(names, torch.autograd.grad(
        value, [wide[n] for n in names])))
    (cost64,), want = jax_float64.run(tmp_path, "googlenet", np_params,
                                      batches, lr, 0.9, dropout_mask=mask)
    assert cost64 > 2 * np.log(1000)
    assert float(value.detach()) == pytest.approx(cost64, rel=1e-10)
    assert cost32 == pytest.approx(cost64, rel=1e-6)
    worst = jworst = port64 = 0.0
    for name in names:
        port64 = max(port64, _rel((wide[name] - lr * grads[name]).detach()
                                  .numpy(), want[name]))
        got = params.get(name)
        assert not np.array_equal(got, np_params[name].astype(np.float32))
        worst = max(worst, _rel(got, want[name]))
        jworst = max(jworst, _rel(np.asarray(jparams.get(name)), want[name]))
    print("saturated start: cost %.4f; the port's float64 step departs "
          "from JAX's by %.3g; the float32 step departs from float64 by "
          "%.3g in the port, by %.3g in the JAX trainer"
          % (cost64, port64, worst, jworst))
    assert port64 <= 1e-10
    bound = max(1e-4, 2.0 * jworst)
    assert bound <= 1e-2
    assert worst <= bound


def test_smallnet_cifar_trajectory_matches_jax(nets):
    (jcosts, jparams), (costs, params), np_params = _train_both(
        nets, "smallnet_cifar", _batches("smallnet_cifar", 3, 4, seed=9))
    assert len(costs) == len(jcosts) == 3
    np.testing.assert_allclose(costs, jcosts, rtol=1e-5)
    for pname in sorted(np_params):
        assert _rel(params.get(pname), jparams.get(pname)) <= 1e-5, pname


# -- concat ------------------------------------------------------------------

def _concat_both(kind):
    """(JAX output, port output) of a concat over two inputs of ``kind``."""
    outs = []
    for pkg, reset in ((jpaddle, jax_reset_names),
                       (paddle, reset_name_counters)):
        reset()
        L, dt = pkg.layer, pkg.data_type
        if kind == "images":
            img = L.data(name="image", type=dt.dense_vector(3 * 6 * 5))
            img.out_img_shape = (3, 6, 5)
            a = L.img_conv(input=img, filter_size=3, num_filters=8,
                           padding=1, name="a")
            b = L.img_conv(input=img, filter_size=1, num_filters=16,
                           name="b")
            out = L.concat(input=[a, b], act=pkg.activation.Relu(),
                           name="cat")
            out = L.img_pool(input=out, pool_size=2, stride=2, name="pool")
        elif kind == "rows":
            x = L.data(name="x", type=dt.dense_vector(6))
            out = L.concat(input=[L.fc(input=x, size=4, name="a"),
                                  L.fc(input=x, size=5, name="b")],
                           name="cat")
        else:
            w = L.data(name="w", type=dt.integer_value_sequence(11))
            emb = L.embedding(input=w, size=6, name="e")
            out = L.concat(input=[L.fc(input=emb, size=4, name="a"), emb],
                           name="cat")
        outs.append(out)
    return outs


@pytest.mark.parametrize("kind", ["images", "rows", "sequences"])
def test_concat_matches_jax(kind):
    jout, out = _concat_both(kind)
    jtopo, topo = JaxTopology(jout), Topology(out)
    np_params = _numpy_params(topo.param_specs(), seed=11)
    rng = np.random.RandomState(12)
    if kind == "images":
        feeds = ({"image": jnp.asarray(rng.randn(3, 90).astype(np.float32))},)
        assert topo.by_name["cat"].out_img_shape == (24, 6, 5)
        assert topo.by_name["cat"].size == 24 * 6 * 5
    elif kind == "rows":
        feeds = ({"x": jnp.asarray(rng.randn(3, 6).astype(np.float32))},)
    else:
        ids = rng.randint(0, 11, (3, 7)).astype(np.int32)
        lens = np.array([7, 1, 4], np.int32)
        feeds = ({"w": JaxSequenceBatch(jnp.asarray(ids),
                                        jnp.asarray(lens))},)
        assert topo.by_name["cat"].size == 10
    jfeed = feeds[0]
    want, _ = jtopo.apply({k: jnp.asarray(v) for k, v in np_params.items()},
                          jfeed, mode="test")
    feed = {k: (SequenceBatch(torch.from_numpy(np.array(v.data)),
                              torch.from_numpy(np.array(v.lengths)))
                if isinstance(v, JaxSequenceBatch)
                else torch.from_numpy(np.array(v)))
            for k, v in jfeed.items()}
    got = topo.apply({k: torch.from_numpy(v) for k, v in np_params.items()},
                     feed, mode="test")[0][out.name]
    want = want[jout.name]
    if kind == "sequences":
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(want.lengths))
        got, want = got.data, want.data
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_concat_refuses_projections():
    """concat over projections is ported: each projection becomes a
    one-branch mixed layer, as in the JAX package (values and gradients:
    tests/test_torch_mixed.py); anything that is neither a layer nor a
    projection is refused."""
    built = []
    for pkg, reset in ((jpaddle, jax_reset_names),
                       (paddle, reset_name_counters)):
        reset()
        built.append(pkg.layer.concat(input=[
            pkg.layer.data(name="x", type=pkg.data_type.dense_vector(4)),
            pkg.layer.identity_projection(input=pkg.layer.data(
                name="y", type=pkg.data_type.dense_vector(3)))]))
    jout, out = built
    assert [i.name for i in out.inputs] == [i.name for i in jout.inputs]
    assert out.inputs[1].layer_type == "mixed" and out.size == 7
    reset_name_counters()
    x = paddle.layer.data(name="x", type=paddle.data_type.dense_vector(4))
    with pytest.raises(EnforceError, match="takes layers and projections"):
        paddle.layer.concat(input=[x, object()])


# -- cross-map normalisation --------------------------------------------------

@pytest.mark.parametrize("channels,auto", [(16, False), (16, True),
                                           (96, True), (1032, True)])
def test_cross_map_norm_values_and_gradients_match_jax(channels, auto):
    """``cross_map_norm`` (the analytic backward) and
    ``cross_map_norm_auto`` (the banded product; the window sums above
    1024 channels) against the JAX functions, values and gradients of
    sum(out * g), within 1e-5 of max(1, max |JAX|)."""
    rng = np.random.RandomState(channels)
    x = rng.randn(2, 3, 4, channels).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    size, scale, power = 5, 0.0128 * 5, 0.75
    jfn = jax_conv.cross_map_norm_auto if auto else jax_conv.cross_map_norm
    fn = conv_ops.cross_map_norm_auto if auto else conv_ops.cross_map_norm
    want, jvjp = jax.vjp(lambda v: jfn(v, size, scale, power),
                         jnp.asarray(x))
    (want_dx,) = jvjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = fn(xt, size, scale, power)
    (got_dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    assert _rel(got.detach().numpy(), np.asarray(want)) <= 1e-5
    assert _rel(got_dx.numpy(), np.asarray(want_dx)) <= 1e-5


def test_img_cmrnorm_layer_matches_jax_and_refuses_sequences():
    outs = []
    for pkg, reset in ((jpaddle, jax_reset_names),
                       (paddle, reset_name_counters)):
        reset()
        img = pkg.layer.data(name="image",
                             type=pkg.data_type.dense_vector(8 * 3 * 3))
        img.out_img_shape = (8, 3, 3)
        outs.append(pkg.layer.img_cmrnorm(input=img, size=5, scale=0.01,
                                          power=0.5))
    jout, out = outs
    assert out.name == jout.name == "__crmnorm_0__"
    x = np.random.RandomState(2).randn(2, 72).astype(np.float32)
    want = JaxTopology(jout).apply({}, {"image": jnp.asarray(x)})[0][
        jout.name]
    got = Topology(out).apply({}, {"image": torch.from_numpy(x)},
                              mode="test")[0][out.name]
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-6
    # over a sequence (no longer refused: the name is kept) every step is
    # an image, padding included, as the JAX package's as_nhwc reads it
    xs = np.random.RandomState(3).randn(2, 3, 72).astype(np.float32)
    from paddle_tpu.core.sequence import SequenceBatch as JaxSequenceBatch

    want = JaxTopology(jout).apply({}, {"image": JaxSequenceBatch(
        jnp.asarray(xs), jnp.asarray([3, 1]))})[0][jout.name]
    got = Topology(out).apply({}, {"image": SequenceBatch(
        torch.from_numpy(xs), torch.tensor([3, 1]))}, mode="test")[0][
        out.name]
    assert got.data.shape == want.data.shape == (6, 72)
    assert _rel(got.data.numpy(), np.asarray(want.data)) <= 1e-6


# -- dropout -----------------------------------------------------------------

def _drop_net(rate):
    reset_name_counters()
    x = paddle.layer.data(name="x", type=paddle.data_type.dense_vector(64))
    return paddle.layer.dropout(input=x, dropout_rate=rate)


def test_dropout_masks_seed_share_scaling_and_test_mode():
    out = _drop_net(0.3)
    topo = Topology(out)
    x = torch.ones(256, 64)

    def run(seed, mode="train"):
        gen = torch.Generator().manual_seed(seed)
        return topo.apply({}, {"x": x}, mode=mode, rng=gen)[0][out.name]

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    # the kept share within 4 sigma of 1 - rate; kept values scaled 1/keep
    n = kept.numel()
    assert abs(kept.float().mean().item() - 0.7) <= 4 * (0.21 / n) ** 0.5
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.7))
    # test mode is the identity and needs no generator
    assert torch.equal(topo.apply({}, {"x": x}, mode="test")[0][out.name], x)
    with pytest.raises(EnforceError, match="pass rng="):
        topo.apply({}, {"x": x}, mode="train")


def test_dropout_keeps_the_compute_dtype_and_an_image_value():
    out = _drop_net(0.5)
    gen = torch.Generator().manual_seed(0)
    dtype_mod.set_mixed_precision("bfloat16")
    try:
        y = Topology(out).apply({}, {"x": torch.ones(4, 64)}, mode="train",
                                rng=gen)[0][out.name]
    finally:
        dtype_mod.set_mixed_precision(None)
    assert y.dtype == torch.bfloat16
    assert set(y.unique().tolist()) <= {0.0, 2.0}


def test_generator_on_another_device_raises():
    class OnCard:
        device = torch.device("cuda", 0)

    ctx = Context(mode="train", generator=OnCard())
    with pytest.raises(EnforceError, match="generator is on cuda"):
        ctx.rng_for(torch.zeros(2))


def test_trainer_draws_its_masks_from_the_seed_flag():
    """Two trainers built under one seed train AlexNet-style dropout to
    the same parameters; another seed gives other masks."""
    def trained(seed):
        flags.set_flag("seed", seed)
        try:
            reset_name_counters()
            x = paddle.layer.data(name="x",
                                  type=paddle.data_type.dense_vector(8))
            h = paddle.layer.fc(input=x, size=16, name="h",
                                act=paddle.activation.Relu())
            h = paddle.layer.dropout(input=h, dropout_rate=0.5)
            y = paddle.layer.fc(input=h, size=3, name="y",
                                act=paddle.activation.Softmax())
            label = paddle.layer.data(name="label",
                                      type=paddle.data_type.integer_value(3))
            cost = paddle.layer.classification_cost(input=y, label=label)
            topo = Topology(cost)
            params = Parameters({k: torch.from_numpy(v) for k, v in
                                 _numpy_params(topo.param_specs(),
                                               seed=4).items()},
                                topo.param_specs())
            trainer = paddle.trainer.SGD(
                cost, params, opt.Momentum(learning_rate=0.1), device="cpu")
            rng = np.random.RandomState(0)
            batches = [[(rng.randn(8).astype(np.float32), int(rng.randint(3)))
                        for _ in range(4)] for _ in range(3)]
            trainer.train(lambda: iter(batches), num_passes=1)
            return params.get("h.w0")
        finally:
            flags.reset_flag("seed")

    a, b, c = trained(1), trained(1), trained(2)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
