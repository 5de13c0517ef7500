"""Five repairs of the port's v2 and serving surface, each through both
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
# yet; ROADMAP.md queues each (queue 1: analyze; tensor, sequence and
# pipeline parallelism)
NOT_YET = {
    "analyze": {
        "CHECKERS", "Finding", "RetraceBudgetExceeded", "check_topology",
        "estimate_hbm_bytes", "format_finding", "format_report",
        "hbm_budget_bytes", "lint_paths", "lint_source", "lint_tree",
        "max_retraces", "predict_jit_entries", "scan_layer_modules",
        "verify_reject_packed_coverage"},
    "control": set(), "core": set(), "data": set(), "dataset": set(),
    "distributed": set(),
    "layer": set(), "models": set(), "observe": set(), "ops": set(),
    "parallel": set(),
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
