"""Repairs of the port's v2 and serving surface, each through both
packages on the CPU:

1. ``topology.convert_feed`` / ``convert_column`` take the JAX package's
   arguments, ``(topology, data_batch, feeding=None, max_len=None)``, with
   ``device=`` keyword-only (None: the default device).
2. ``Topology.apply_all`` returns every layer's value and the state
   updates.
3. The shared packages re-export what the JAX package's do (``core``'s
   places and ``DDim``, ``utils``' timers, ``evaluator.EvalNode``,
   ``core.place.device_put``), ``distributed`` exports all of the JAX
   package's names, and ``parallel``'s names still to port answer
   ``hasattr`` with False.
4. ``Bundle.params(device=None)`` is a method, ``run``, ``infer``,
   ``warmup``, ``decode_step`` and ``warmup_decoder`` take ``device=``,
   and ``WorkerSet.submit_to`` takes ``timeout=``.
5. ``ops.conv.conv2d`` pads ``"SAME"`` by default and takes ``"SAME"`` and
   ``"VALID"``.
6. ``multibox_loss`` refuses a label whose rows are not the images' (a
   packed row of two images' boxes), as the JAX package's per-image map
   does, and agrees with it on packed rows of one image each.
7. The worker fleet counts a re-routed request before publishing it.
8. ``ops.conv.conv2d_transpose`` pads ``"SAME"`` by default and takes
   ``"VALID"`` and explicit pairs, asymmetric ones too, as
   ``lax.conv_transpose`` does.
9. ``graph.ParamSpec`` takes ``dtype`` fifth, as the JAX package's.
10. The CLI takes ``--use-tpu``, and ``init`` sets the ``use_tpu`` flag.
11. The JAX package's eleven remaining core flags are defined.
12. ``LayerNode(seq_level=)``, ``make_node(**kw)``, ``SparseRows.size``,
    ``core.dtype.set_default_dtype`` and ``matmul_precision()``.
13. ``Bundle.executable`` / ``decode_executable``, ``DataParallel``'s
    sharding helpers (the jit wrappers refused by name), and
    ``Context.next_rng`` / ``group_rng`` / ``observe``.

Values within 1e-6 of max(1, max |JAX|) (``tests/torch_parity.py``).
"""

import importlib
import inspect
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpaddle
from paddle_tpu.ops import conv as jax_conv_ops
from paddle_tpu.topology import Topology as JaxTopology
from paddle_tpu.topology import convert_column as jax_convert_column
from paddle_tpu.topology import convert_feed as jax_convert_feed

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import place
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.ops import conv_kernels as ck
from paddle_tpu_torch.topology import Topology, convert_column, convert_feed
from paddle_tpu_torch.utils.error import EnforceError

from torch_parity import TOL_FWD, both, numpy_params, rel


@pytest.fixture
def cpu_default():
    """The CPU as the port's default device for one test."""
    place.set_default_device("cpu")
    yield
    place.set_default_device("cuda")


def _net(pkg):
    x = pkg.layer.data(name="x", type=pkg.data_type.dense_vector(4))
    ids = pkg.layer.data(name="ids",
                         type=pkg.data_type.integer_value_sequence(9))
    h = pkg.layer.fc(input=x, size=3, name="h")
    bn = pkg.layer.batch_norm(input=h, name="bn")
    emb = pkg.layer.embedding(input=ids, size=3, name="emb")
    pooled = pkg.layer.pooling(input=emb, name="pooled")
    return pkg.layer.addto(input=[bn, pooled], name="out")


def _rows(seed=0, n=4):
    rng = np.random.RandomState(seed)
    return [(rng.randn(4).astype(np.float32),
             rng.randint(0, 9, rng.randint(1, 5)).tolist()) for _ in range(n)]


def _feed_values(feed):
    return {k: np.asarray(getattr(v, "data", v)) for k, v in feed.items()}


# -- 1. convert_feed / convert_column ----------------------------------------

@pytest.mark.parametrize("form", ["positional_batch", "positional_feeding",
                                  "keyword_max_len"])
def test_convert_feed_takes_jax_arguments(form, cpu_default):
    jout, out = both(_net)
    topo, jtopo = Topology(out), JaxTopology(jout)
    rows = _rows()
    swapped = [(ids, x) for x, ids in rows]
    args, kwargs = {
        "positional_batch": ((rows,), {}),
        "positional_feeding": ((swapped, {"x": 1, "ids": 0}), {}),
        "keyword_max_len": ((rows,), {"max_len": 6}),
    }[form]
    got = _feed_values(convert_feed(topo, *args, **kwargs))
    want = _feed_values(jax_convert_feed(jtopo, *args, **kwargs))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    # the default device is the one resolve_device gives; keyword-only
    assert all(torch.as_tensor(v).device.type == "cpu" for v in got.values())
    with pytest.raises(TypeError):
        convert_feed(topo, rows, None, None, "cpu")


def test_convert_feed_default_is_the_card_and_refuses_without_one():
    _, out = both(_net)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_feed(Topology(out), _rows())


def test_convert_feed_names_a_missing_column(cpu_default):
    _, out = both(_net)
    with pytest.raises(Exception, match="has no column 1"):
        convert_feed(Topology(out), [(np.zeros(4, np.float32),)])


def test_convert_column_takes_jax_arguments(cpu_default):
    itype = paddle.data_type.integer_value_sequence(9)
    jtype = jpaddle.data_type.integer_value_sequence(9)
    col = [[1, 2, 3], [4]]
    got = convert_column(col, itype, 5)
    want = jax_convert_column(col, jtype, 5)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))


# -- 2. Topology.apply_all ---------------------------------------------------

@pytest.mark.parametrize("mode", ["test", "train"])
def test_apply_all_returns_every_layer_and_state_updates(mode):
    jout, out = both(_net)
    topo, jtopo = Topology(out), JaxTopology(jout)
    arrays = numpy_params(topo.param_specs(), 3)
    for name in arrays:  # moving statistics: mean 0, variance 1
        if name.endswith(".moving_var"):
            arrays[name] = np.ones_like(arrays[name])
        elif name.endswith(".moving_mean"):
            arrays[name] = np.zeros_like(arrays[name])
    rows = _rows(1)
    feed = convert_feed(topo, rows, device="cpu")
    values, updates = topo.apply_all(
        {k: torch.from_numpy(v) for k, v in arrays.items()}, feed, mode=mode)
    jvalues, jupdates = jtopo.apply_all(
        {k: jnp.asarray(v) for k, v in arrays.items()},
        jax_convert_feed(jtopo, rows), mode=mode)
    assert sorted(values) == sorted(jvalues) == sorted(
        n.name for n in topo.nodes)
    for name in jvalues:
        got, want = values[name], jvalues[name]
        got = got.masked_data() if hasattr(got, "masked_data") else got
        want = want.masked_data() if hasattr(want, "masked_data") else want
        assert rel(got.detach().numpy(), np.asarray(want)) <= TOL_FWD, name
    assert sorted(updates) == sorted(jupdates)
    assert (mode == "train") == bool(updates)
    for name in jupdates:
        assert rel(updates[name].numpy(), np.asarray(jupdates[name])) \
            <= TOL_FWD, name


# -- 3. the shared packages' names -------------------------------------------

# public names of a shared package's __init__ (paddle_tpu.<pkg> and
# paddle_tpu_torch.<pkg>) that the JAX package has and the port does not
# yet; ROADMAP.md queues each (every set is empty now: analyze's fifteen
# names were the last)
NOT_YET = {
    "analyze": set(),
    "control": set(), "core": set(), "data": set(), "dataset": set(),
    "distributed": set(), "io": set(),
    "layer": set(), "models": set(), "observe": set(), "ops": set(),
    "parallel": set(), "plot": set(), "proto": set(),
    "reader": set(), "serve": set(), "utils": set(),
}
# the names of paddle_tpu.parallel that the port gained with tensor,
# sequence and pipeline parallelism (they were NOT_YET["parallel"])
PARALLEL_PORTED = ["SequenceParallel", "TensorParallel", "full_attention",
                   "megatron_dense_pair", "pipe_sharding", "pipeline_apply",
                   "ring_attention", "stack_stage_params",
                   "ulysses_attention"]


def _names(module):
    """Public names bound to something other than a module."""
    return {name for name in dir(module) if not name.startswith("_")
            and not isinstance(getattr(module, name), types.ModuleType)}


@pytest.mark.parametrize("package", sorted(NOT_YET))
def test_shared_package_exports_are_jax_minus_what_roadmap_queues(package):
    jmod = importlib.import_module("paddle_tpu." + package)
    pmod = importlib.import_module("paddle_tpu_torch." + package)
    assert _names(jmod) - _names(pmod) == NOT_YET[package]


def test_core_places_and_ddim_match_jax():
    from paddle_tpu.core import DDim as JaxDDim
    from paddle_tpu.core import make_ddim as jax_make_ddim
    from paddle_tpu.core.ddim import flatten_to_2d as jax_flatten
    from paddle_tpu_torch.core import (CPUPlace, DDim, Place, TPUPlace,
                                       default_place, make_ddim,
                                       set_default_place)
    from paddle_tpu_torch.core.ddim import flatten_to_2d

    for dims in ((2, 3, 4), [5], (7,)):
        got, want = make_ddim(dims), jax_make_ddim(dims)
        assert tuple(got) == tuple(want) and got.rank == want.rank
        assert got.product() == want.product()
        assert tuple(got.slice(0, 1)) == tuple(want.slice(0, 1))
        assert tuple(got.with_dim(0, 9)) == tuple(want.with_dim(0, 9))
        assert repr(got) == repr(want)
    assert make_ddim(2, 3) == DDim((2, 3)) == JaxDDim((2, 3))
    assert tuple(flatten_to_2d((2, 3, 4), 2)) == tuple(
        jax_flatten((2, 3, 4), 2))
    with pytest.raises(Exception, match="bad dims"):
        make_ddim(-2, 3)
    assert isinstance(CPUPlace(), Place) and TPUPlace(0) == TPUPlace()
    before = place.default_device()
    try:
        set_default_place(CPUPlace())
        assert default_place() == CPUPlace()
    finally:
        place.set_default_device(before)


def test_utils_timers_evaluator_marker_and_device_put():
    from paddle_tpu.utils import timer as jax_timer
    from paddle_tpu_torch.core.place import CPUPlace, device_put
    from paddle_tpu_torch.evaluator import EvalNode
    from paddle_tpu_torch.utils import StatSet, global_stats, timer

    assert isinstance(global_stats, StatSet)
    assert timer == global_stats.timer and callable(jax_timer)
    with timer("repairs_probe"):
        pass
    assert global_stats.as_dict()["repairs_probe"]["count"] >= 1
    assert isinstance(EvalNode, type)
    tree = {"a": np.ones(3, np.float32), "b": [np.zeros(2), (1.0,)]}
    put = device_put(tree, CPUPlace())
    assert put["a"].device.type == "cpu"
    np.testing.assert_array_equal(put["a"].numpy(), tree["a"])
    assert isinstance(put["b"], list) and isinstance(put["b"][1], tuple)


@pytest.mark.parametrize("name", ["CoordinatorClient", "spawn_coordinator",
                                  "initialize_multihost"])
def test_unported_distributed_names_answer_hasattr_false(name):
    """The name is kept from when these three were still to port: each is
    now the port's own, beside the JAX package's."""
    jmod = importlib.import_module("paddle_tpu.distributed")
    pmod = importlib.import_module("paddle_tpu_torch.distributed")
    assert hasattr(jmod, name) and hasattr(pmod, name)
    got, want = getattr(pmod, name), getattr(jmod, name)
    assert got.__module__.startswith("paddle_tpu_torch.distributed.")
    assert got.__name__ == want.__name__
    assert inspect.signature(got).parameters.keys() == \
        inspect.signature(want).parameters.keys()


@pytest.mark.parametrize("name", PARALLEL_PORTED)
def test_unported_parallel_names_answer_hasattr_false(name):
    """The name is kept from when these nine were still to port: each is
    now the port's own, beside the JAX package's, with its parameter
    names."""
    jmod = importlib.import_module("paddle_tpu.parallel")
    pmod = importlib.import_module("paddle_tpu_torch.parallel")
    assert hasattr(jmod, name) and hasattr(pmod, name)
    got, want = getattr(pmod, name), getattr(jmod, name)
    assert got.__module__.startswith("paddle_tpu_torch.parallel.")
    assert got.__name__ == want.__name__
    assert inspect.signature(got).parameters.keys() == \
        inspect.signature(want).parameters.keys()


# -- 4. the bundle and worker API --------------------------------------------

BUNDLE_METHODS = ["params", "run", "infer", "warmup", "decode_step",
                  "warmup_decoder", "zero_carry"]


@pytest.mark.parametrize("method", BUNDLE_METHODS)
def test_bundle_methods_take_jax_arguments(method):
    from paddle_tpu.serve.bundle import Bundle as JaxBundle
    from paddle_tpu_torch.serve.bundle import Bundle

    got = list(inspect.signature(getattr(Bundle, method)).parameters)
    want = list(inspect.signature(getattr(JaxBundle, method)).parameters)
    assert got == want


def test_worker_submit_to_takes_jax_arguments():
    from paddle_tpu.serve.workers import WorkerSet as JaxWorkerSet
    from paddle_tpu_torch.serve.workers import WorkerSet

    got = inspect.signature(WorkerSet.submit_to).parameters
    want = inspect.signature(JaxWorkerSet.submit_to).parameters
    assert list(got) == list(want)
    assert got["timeout"].default is want["timeout"].default is None


def test_bundle_params_and_device_calls_through_both_packages(tmp_path):
    from paddle_tpu.serve import load_bundle as jax_load
    from paddle_tpu_torch.serve import load_bundle
    from torch_fleet import (MLP, MLP_BUILDER, assert_close, export_both,
                             mlp_request)

    port_dir, jax_dir = export_both(tmp_path, MLP_BUILDER, MLP)
    port, ref = load_bundle(port_dir, device="cpu"), jax_load(jax_dir)
    params, jparams = port.params(), ref.params()
    assert sorted(params) == sorted(jparams)
    assert port.params(device="cpu") is params is port.payload
    for name in jparams:
        np.testing.assert_array_equal(params[name].numpy(),
                                      np.asarray(jparams[name]))
    assert port.warmup(device="cpu") == ref.warmup(device=None)
    req = mlp_request(3, seed=4)
    assert_close(port.infer(req, device="cpu"), ref.infer(req, device=None))
    padded = {k: np.concatenate([v, v[-1:]]) for k, v in req.items()}
    assert_close(port.run(padded, 4, device="cpu"), ref.run(padded, 4))


def test_decode_step_and_warmup_decoder_take_device(tmp_path):
    from torch_decode import load_pair

    port, ref = load_pair(tmp_path, "gru")
    assert port.warmup_decoder(device="cpu") == ref.warmup_decoder()
    flat = port.dummy_decode_flat()
    flat["lens"][:] = 2
    carry, outs = port.decode_step(port.zero_carry(device="cpu"), flat,
                                   device="cpu")
    jcarry, jouts = ref.decode_step(ref.zero_carry(), flat)
    for name in jouts:
        assert rel(outs[name].numpy(), np.asarray(jouts[name])) <= 1e-5
    for layer in jcarry:
        for leaf, jleaf in zip(carry[layer], jcarry[layer]):
            assert rel(leaf.numpy(), np.asarray(jleaf)) <= 1e-5


# -- 5. conv2d's padding -----------------------------------------------------

@pytest.mark.parametrize("k,stride,padding", [
    (3, 1, None), (1, 1, None), (2, 1, None), (4, 2, None), (5, 2, None),
    (3, 2, "SAME"), (3, 1, "VALID"), (2, 2, "valid"),
    (3, 1, ((0, 2), (1, 0)))])
def test_conv2d_padding_matches_jax(k, stride, padding):
    rng = np.random.RandomState(k * 10 + stride)
    x = rng.randn(2, 7, 6, 8).astype(np.float32)
    w = rng.randn(k, k, 8, 8).astype(np.float32) / k
    kwargs = {"stride": (stride, stride)}
    if padding is not None:
        kwargs["padding"] = padding
    jpad = kwargs.get("padding")
    jkwargs = dict(kwargs, padding=jpad.upper() if isinstance(jpad, str)
                   else jpad) if padding is not None else kwargs
    got = conv_ops.conv2d(torch.from_numpy(x), torch.from_numpy(w), **kwargs)
    want = jax_conv_ops.conv2d(jnp.asarray(x), jnp.asarray(w), **jkwargs)
    assert got.shape == want.shape
    assert rel(got.numpy(), np.asarray(want)) <= 1e-5


def test_conv2d_same_default_reaches_the_kernel_family(monkeypatch):
    """Stride-1 odd-kernel SAME is K7's family (its plain version on the
    CPU); an even kernel's SAME is F.pad + F.conv2d."""
    seen = []
    real = conv_ops.conv_same
    monkeypatch.setattr(conv_ops, "conv_same",
                        lambda x, w: seen.append(tuple(w.shape)) or real(x, w))
    x = torch.randn(1, 6, 6, 8)
    conv_ops.conv2d(x, torch.randn(3, 3, 8, 8))
    conv_ops.conv2d(x, torch.randn(2, 2, 8, 8))
    assert seen == [(3, 3, 8, 8)]
    assert ck.kernel_supported((1, 6, 6, 8), (3, 3, 8, 8), (1, 1),
                               ((1, 1), (1, 1)), 1, (1, 1), torch.float32,
                               torch.float32)
    with pytest.raises(Exception, match="padding must be"):
        conv_ops.conv2d(x, torch.randn(3, 3, 8, 8), padding="FULL")


def test_register_layer_records_the_jax_packages_build_spec():
    """Every node a registered constructor builds carries
    ``build_spec = (registry key, bound arguments)``, as in the JAX
    package, so the proto interchange serialises the graph: without it
    every layer of ``to_proto`` was opaque. The encoded specs (config
    objects under their ``paddle_tpu.*`` wire names) are the JAX
    package's, layer for layer."""
    from paddle_tpu.proto.interchange import encode_value as jax_encode
    from paddle_tpu_torch.proto.interchange import encode_value

    def build(pkg):
        L = pkg.layer
        w = L.data(name="w", type=pkg.data_type.integer_value_sequence(9))
        emb = L.embedding(input=w, size=4,
                          param_attr=pkg.attr.ParamAttr(initial_std=0.1))
        pooled = L.pooling(input=emb,
                           pooling_type=pkg.pooling.MaxPooling())
        return L.fc(input=pooled, size=2, act=pkg.activation.Softmax())

    jout, out = both(build)
    jnodes = JaxTopology(jout).nodes
    nodes = Topology(out).nodes
    assert [n.name for n in nodes] == [n.name for n in jnodes]
    for node, jnode in zip(nodes, jnodes):
        assert node.build_spec[0] == jnode.build_spec[0]
        assert {k: encode_value(v) for k, v in node.build_spec[1].items()} \
            == {k: jax_encode(v) for k, v in jnode.build_spec[1].items()}


# -- 6. multibox_loss refuses a label whose rows are not the images' ----------

def _packed_label(pkg, gts, rows, segments):
    """A PackedSequenceBatch of ground-truth boxes: ``rows`` lists, per
    row, the indices of the images whose boxes it concatenates, and
    ``segments`` gives each row's per-box segment ids."""
    data = [np.concatenate([gts[i] for i in row]) for row in rows]
    width = max(len(d) for d in data)
    out = np.zeros((len(rows), width, 6), np.float32)
    seg = -np.ones((len(rows), width), np.int32)
    for r, d in enumerate(data):
        out[r, :len(d)] = d
        seg[r, :len(d)] = segments[r]
    lens = np.asarray([len(d) for d in data], np.int32)
    if pkg is paddle:
        from paddle_tpu_torch.core.sequence import PackedSequenceBatch

        return PackedSequenceBatch(torch.from_numpy(out),
                                   torch.from_numpy(lens),
                                   torch.from_numpy(seg))
    from paddle_tpu.core.sequence import PackedSequenceBatch

    return PackedSequenceBatch(jnp.asarray(out), jnp.asarray(lens),
                               jnp.asarray(seg))


def _multibox_both(label_rows, segments):
    from test_torch_detection import _ssd, _ssd_rows

    def build(pkg):
        locs, confs, priors = _ssd(pkg, two_maps=True)
        gt = pkg.layer.data(name="gt",
                            type=pkg.data_type.dense_vector_sequence(6))
        return pkg.layer.multibox_loss(
            input_loc=locs, input_conf=confs, priorbox=priors, label=gt,
            num_classes=3, name="out")

    jout, out = both(build)
    topo, jtopo = Topology(out), JaxTopology(jout)
    arrays = numpy_params(topo.param_specs(), 0)
    rows = _ssd_rows(5, n=2)
    names = [n for n, _ in topo.data_types()]
    tuples = [tuple(r[n] for n in names) for r in rows]
    gts = [r["gt"] for r in rows]
    feed = convert_feed(topo, tuples, device="cpu")
    jfeed = jax_convert_feed(jtopo, tuples)
    feed["gt"] = _packed_label(paddle, gts, label_rows, segments)
    jfeed["gt"] = _packed_label(jpaddle, gts, label_rows, segments)
    results = []
    for run in (
            lambda: topo.apply_all({k: torch.from_numpy(v)
                                    for k, v in arrays.items()}, feed,
                                   mode="train")[0]["out"].detach().numpy(),
            lambda: np.asarray(jtopo.apply_all(
                {k: jnp.asarray(v) for k, v in arrays.items()}, jfeed,
                mode="train")[0]["out"])):
        try:
            results.append(run())
        except Exception as exc:  # noqa: BLE001 — compared below
            results.append(exc)
    return results


def test_multibox_loss_refuses_two_images_in_one_label_row():
    """A packed label row holding two images' boxes against two images'
    predictions: the JAX package's per-image map refuses it; the port
    broadcast the one row over both images and matched each image
    against both images' boxes. It now refuses too."""
    from test_torch_detection import _ssd_rows

    from paddle_tpu_torch.utils.error import EnforceError

    gts = [r["gt"] for r in _ssd_rows(5, n=2)]
    segments = [[0] * len(gts[0]) + [1] * len(gts[1])]
    got, want = _multibox_both([[0, 1]], segments)
    assert isinstance(want, ValueError), want
    assert isinstance(got, EnforceError), got
    assert "each label row holds one image's ground truth" in str(got)


def test_multibox_loss_packed_rows_of_one_image_agree_with_jax():
    """Each label row is one image's boxes, in two packed segments: both
    packages read the row as that image's instance set and agree (so the
    segment split mixes no images; the scanner does not derive
    multibox_loss as a time-position mixer)."""
    from test_torch_detection import _ssd_rows

    gts = [r["gt"] for r in _ssd_rows(5, n=2)]
    segments = [[0] * (len(g) // 2) + [1] * (len(g) - len(g) // 2)
                for g in gts]
    got, want = _multibox_both([[0], [1]], segments)
    assert not isinstance(got, Exception) and not isinstance(
        want, Exception), (got, want)
    assert got.shape == want.shape == (2,)
    assert rel(got, want) <= TOL_FWD


# -- 7. a re-route is counted before its answer can come back ----------------

def test_reroute_is_counted_before_it_is_published():
    """The worker fleet counted a re-routed request after handing it to a
    surviving worker, so its answer (and a caller reading the stats) could
    come back before the count: tests/test_torch_workers.py's burst test
    read seven of eight under load. The count now precedes the publish,
    and a publish that fails takes it back."""
    import itertools
    import threading
    from concurrent.futures import Future

    from paddle_tpu_torch.serve.workers import WorkerSet

    seen = []

    class Target:
        index = 0

        def queue_depth(self):
            return 0

        def submit_encoded(self, req_id, header, arrays, future, entry):
            # the answer comes back before submit returns
            seen.append(fleet._stats["reroutes"])
            future.set_result({"ok": True})
            return future

    class Failing(Target):
        def submit_encoded(self, req_id, header, arrays, future, entry):
            raise OSError("ring closed")

    fleet = types.SimpleNamespace(
        _lock=threading.Lock(), _stats={"reroutes": 0},
        _req_ids=itertools.count(100), model="m",
        _eligible=lambda: [Target()])
    entry = {"future": Future(), "header": {"id": 1}, "arrays": (),
             "session": None, "retries": 0}
    WorkerSet._reroute(fleet, entry)
    assert seen == [1] and fleet._stats["reroutes"] == 1
    assert entry["future"].result(timeout=1) == {"ok": True}
    fleet._eligible = lambda: [Failing()]
    entry = dict(entry, future=Future(), retries=0)
    WorkerSet._reroute(fleet, entry)
    assert fleet._stats["reroutes"] == 1
    with pytest.raises(OSError, match="ring closed"):
        entry["future"].result(timeout=1)


# -- 8. conv2d_transpose's padding -------------------------------------------

@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", [None, "SAME", "VALID", ((1, 1), (1, 1)),
                                     ((0, 2), (1, 0)), ((3, 1), (2, 4))],
                         ids=["default", "SAME", "VALID", "pairs",
                              "asymmetric", "beyond_f"])
def test_conv2d_transpose_padding_matches_jax(stride, padding):
    """5 x 5 input, 3 x 3 kernel: JAX gives 5 x 5 (stride 1) and 10 x 10
    (stride 2) at its "SAME" default."""
    rng = np.random.RandomState(stride)
    x = rng.randn(2, 5, 5, 3).astype(np.float32)
    w = rng.randn(3, 3, 3, 4).astype(np.float32) / 3
    kwargs = {"stride": (stride, stride)}
    if padding is not None:
        kwargs["padding"] = padding
    got = conv_ops.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                                    **kwargs)
    want = jax_conv_ops.conv2d_transpose(jnp.asarray(x), jnp.asarray(w),
                                         **kwargs)
    assert got.shape == want.shape
    if padding is None:
        assert got.shape[1:3] == ((5, 5) if stride == 1 else (10, 10))
    assert rel(got.numpy(), np.asarray(want)) <= 1e-5


# -- 9. ParamSpec's dtype ----------------------------------------------------

def test_param_spec_takes_dtype_fifth_as_jax():
    import jax

    from paddle_tpu.graph import ParamSpec as JaxParamSpec
    from paddle_tpu.initializer import Constant as JaxConstant
    from paddle_tpu_torch.graph import ParamSpec
    from paddle_tpu_torch.initializer import Constant

    assert list(inspect.signature(ParamSpec).parameters) == \
        list(inspect.signature(JaxParamSpec).parameters)
    got = ParamSpec("w", (2, 3), Constant(0.5), None, "bfloat16")
    want = JaxParamSpec("w", (2, 3), JaxConstant(0.5), None, "bfloat16")
    assert got.dtype == want.dtype == "bfloat16"
    assert got.is_state is want.is_state is False
    assert repr(got) == repr(want)
    value = got.materialize(torch.Generator(), torch.float32, "cpu")
    jvalue = want.materialize(jax.random.PRNGKey(0), jnp.float32)
    assert str(value.dtype).replace("torch.", "") == jvalue.dtype.name
    np.testing.assert_array_equal(value.float().numpy(),
                                  np.asarray(jvalue, np.float32))
    # without a dtype the caller's; is_state is the sixth
    plain = ParamSpec("m", (2,), Constant(0.0), is_state=True)
    assert plain.dtype is None and plain.is_state is True
    assert plain.materialize(torch.Generator(), torch.float32,
                             "cpu").dtype == torch.float32
    assert repr(plain) == repr(JaxParamSpec("m", (2,), JaxConstant(0.0),
                                            is_state=True))


# -- 10. --use-tpu -----------------------------------------------------------

def test_cli_takes_use_tpu_as_jax(tmp_path, monkeypatch, capsys, cpu_default):
    """``--use-tpu`` parses in both CLIs and reaches ``init(use_tpu=True)``
    (recorded here: the CPU has no card); with ``--device cpu`` the port
    refuses it, naming both."""
    from paddle_tpu import cli as jcli
    from paddle_tpu.utils import flags as jflags
    from paddle_tpu_torch import cli
    from paddle_tpu_torch.utils import flags
    from test_torch_cli import _write_config

    calls = []
    monkeypatch.setattr(jpaddle, "init", lambda **kw: calls.append(
        ("jax", kw.get("use_tpu"))))
    monkeypatch.setattr(paddle, "init", lambda **kw: calls.append(
        ("port", kw.get("use_tpu"))))
    for pkg_cli, name in ((jcli, "jax_use_tpu"), (cli, "port_use_tpu")):
        conf, _ = _write_config(tmp_path, name)
        assert pkg_cli.main(["time", "--config", conf, "--use-tpu",
                             "--iters", "1"]) == 0
    assert calls == [("jax", True), ("port", True)]
    with pytest.raises(SystemExit) as info:
        cli.main(["time", "--config", conf, "--use-tpu", "--device", "cpu"])
    assert info.value.code == 2
    err = capsys.readouterr().err
    assert "--use-tpu" in err and "--device cpu" in err
    monkeypatch.undo()
    jpaddle.init(use_tpu=False)
    paddle.init(use_tpu=False)
    assert flags.get_flag("use_tpu") is jflags.get_flag("use_tpu") is False
    jflags.set_flag("use_tpu", True)
    flags.set_flag("use_tpu", True)


# -- 11. the eleven core flags -----------------------------------------------

ELEVEN_FLAGS = {  # name: a value other than the default (None: refused)
    "use_tpu": False, "enable_x64": None, "checkgrad_eps": 1e-3,
    "prefetch_batches": 2, "save_dir": "/ckpt", "init_model_path": "/m.tar",
    "start_pass": 2, "num_passes": 5, "coordinator_endpoint": "h:1",
    "task_timeout_sec": 30.0, "task_failure_max": 7}


def _redefined_from_env(mod, prefix, name, raw, monkeypatch):
    """The value ``define_flag`` gives ``name`` with its environment
    variable set to ``raw`` (the registry entry put back after)."""
    ftype, default, help_str = mod._defs.pop(name)
    value = mod._values.pop(name)
    monkeypatch.setenv(prefix + name.upper(), raw)
    try:
        mod.define_flag(name, default, help_str)
        return mod.get_flag(name)
    finally:
        mod._defs[name] = (ftype, default, help_str)
        mod._values[name] = value


@pytest.mark.parametrize("name", sorted(ELEVEN_FLAGS))
def test_core_flag_is_defined_as_in_jax(name, monkeypatch):
    from paddle_tpu.utils import flags as jflags
    from paddle_tpu_torch.utils import flags

    default = jflags.get_flag(name)
    assert flags.get_flag(name) == default
    assert type(flags.get_flag(name)) is type(default)
    assert flags._defs[name][1] == jflags._defs[name][1]
    other = ELEVEN_FLAGS[name]
    try:
        if other is None:  # not acted on by the port: refused but default
            flags.set_flag(name, default)
            with pytest.raises(EnforceError, match="not ported yet"):
                flags.set_flag(name, not default)
        else:
            for mod in (jflags, flags):
                mod.set_flag(name, other)
            assert flags.get_flag(name) == jflags.get_flag(name) == other
        raw = str(default if other is None else other)
        assert _redefined_from_env(flags, "PADDLE_TPU_TORCH_", name, raw,
                                   monkeypatch) == \
            _redefined_from_env(jflags, "PADDLE_TPU_", name, raw,
                                monkeypatch)
    finally:
        jflags.reset_flag(name)
        flags.reset_flag(name)


# -- 12. the graph-building surface ------------------------------------------

def test_seq_level_make_node_sparse_size_and_dtype_helpers():
    from paddle_tpu import data_type as jdt
    from paddle_tpu import layer as jlayer
    from paddle_tpu.core import dtype as jdtype
    from paddle_tpu.core.sparse import SparseRows as JaxSparseRows
    from paddle_tpu.layer.base import make_node as jmake_node
    from paddle_tpu.utils import flags as jflags
    from paddle_tpu_torch import data_type as dt
    from paddle_tpu_torch import layer
    from paddle_tpu_torch.core import dtype as dtype_mod
    from paddle_tpu_torch.core.sparse import SparseRows
    from paddle_tpu_torch.layer.base import make_node
    from paddle_tpu_torch.utils import flags

    for kind in ("dense_vector", "integer_value_sequence",
                 "sparse_binary_vector_sub_sequence"):
        jnode = jlayer.data(name="x_" + kind, type=getattr(jdt, kind)(7))
        node = layer.data(name="x_" + kind, type=getattr(dt, kind)(7))
        assert node.seq_level == jnode.seq_level
    jnode = jmake_node("probe", lambda p, v, c: v[0], [], name="jp",
                       seq_level=2)
    node = make_node("probe", lambda p, v, c: v[0], [], name="pp",
                     seq_level=2)
    assert node.seq_level == jnode.seq_level == 2
    assert make_node("probe", None, [], name="pq").seq_level is None
    ids = np.array([[1, 4, -1]], np.int32)
    assert SparseRows(torch.from_numpy(ids), None, 9).size == \
        JaxSparseRows(jnp.asarray(ids), None, 9).size == 9
    try:
        for mod in (jdtype, dtype_mod):
            mod.set_default_dtype("bfloat16")
        assert flags.get_flag("default_dtype") == \
            jflags.get_flag("default_dtype") == "bfloat16"
        dtype_mod.set_default_dtype(torch.float64)
        jdtype.set_default_dtype(np.float64)
        assert flags.get_flag("default_dtype") == \
            jflags.get_flag("default_dtype") == "float64"
    finally:
        for mod in (jflags, flags):
            mod.reset_flag("default_dtype")
    assert dtype_mod.matmul_precision() == jdtype.matmul_precision() == \
        flags.get_flag("matmul_precision")


# -- 13. the missing public names --------------------------------------------

def test_bundle_executable_names_the_loaded_programs(tmp_path):
    from paddle_tpu.serve.bundle import Bundle as JaxBundle
    from torch_decode import load_pair

    port, ref = load_pair(tmp_path, "gru")
    for name in ("executable", "decode_executable"):
        assert callable(getattr(JaxBundle, name))
    batch = port.batch_sizes()[0]
    assert port.executable(batch) is port.program(batch)
    assert ref.executable(batch) is not None
    flat = port.dummy_decode_flat()
    flat["lens"][:] = 2
    carry = port.zero_carry(device="cpu")
    step = port.decode_executable()
    assert step is port.decode_executable(port.decode_slot_sizes()[-1])
    with torch.inference_mode():
        _, outs = step(port.params("cpu"), dict(sorted(carry.items())),
                       port.device_inputs(flat, "cpu"))
    _, jouts = ref.decode_step(ref.zero_carry(), flat)
    for name in jouts:
        assert rel(outs[name].numpy(), np.asarray(jouts[name])) <= 1e-5


def test_data_parallel_sharding_helpers_as_jax():
    from paddle_tpu.parallel import DataParallel as JaxDataParallel
    from paddle_tpu.parallel import build_mesh as jax_build_mesh
    from paddle_tpu_torch.parallel import DataParallel, build_mesh

    dp, jdp = DataParallel(build_mesh()), JaxDataParallel(jax_build_mesh())
    assert tuple(dp.batch_sharding().spec) == \
        tuple(jdp.batch_sharding().spec) == ("data",)
    assert tuple(dp.replicated().spec) == tuple(jdp.replicated().spec) == ()
    slots = dp.slot_sharding({"w": [torch.zeros(4)], "b": torch.zeros(2)})
    assert tuple(slots["w"][0].spec) == tuple(slots["b"].spec) == ()
    for name in ("shard_train_step", "shard_train_chunk", "shard_eval_step"):
        assert list(inspect.signature(getattr(DataParallel, name))
                    .parameters)[0] == "self"
        with pytest.raises(NotImplementedError, match=name):
            getattr(dp, name)(None, None)


def test_context_next_rng_group_rng_and_observe():
    import jax

    from paddle_tpu.graph import Context as JaxContext
    from paddle_tpu_torch.graph import Context

    jctx = JaxContext(rng=jax.random.PRNGKey(0))
    ctx = Context(generator=torch.Generator().manual_seed(0))
    for c in (jctx, ctx):
        c.observe("loss_scale", 2.0)
    assert ctx.aux == jctx.aux == {"loss_scale": 2.0}

    def draws(gen):
        return torch.rand(4, generator=gen).numpy()

    first, second = ctx.next_rng(), ctx.next_rng()
    assert not np.array_equal(draws(first), draws(second))
    again = Context(generator=torch.Generator().manual_seed(0))
    assert np.array_equal(draws(again.next_rng()),
                          draws(Context(generator=torch.Generator()
                                        .manual_seed(0)).next_rng()))
    assert np.array_equal(draws(ctx.group_rng("g")), draws(ctx.group_rng("g")))
    assert not np.array_equal(draws(ctx.group_rng("g")),
                              draws(ctx.group_rng("h")))
    assert Context().group_rng("g") is None is \
        JaxContext().group_rng("g")
    with pytest.raises(EnforceError, match="rng="):
        Context().next_rng()
