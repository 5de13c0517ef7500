"""Tensor, sequence, pipeline and sharded-embedding parallelism of the port
(paddle_tpu_torch/parallel, models/transformer.py) on the CPU, against
the JAX package on its 8-device CPU mesh (tests/conftest.py).

A world of 2, 4 and 8 gloo ranks is spawned once each (the rig is
tests/torch_parallel.py, ``OMP_NUM_THREADS=1``); every rank runs the
cases of its world from the same numpy inputs as the JAX side here and
saves its block of each result and the gradients of the global inputs.
Tolerances, each of the largest entry of the reference (at least 1):
values and gradients within 1e-5 (``TOL``); the layer-sharded fc stack's
values within 2e-5 (tests/test_layer_sharding.py's); the
ParallelTransformer within 2e-4 (tests/test_tensor_pipeline.py's).
Ranks that hold the same value hold it bit for bit.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as JP

from paddle_tpu.parallel.mesh import build_mesh as jax_mesh
from tests import torch_parallel as rig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
TOL_STACK = 2e-5
TOL_TRANSFORMER = 2e-4
SPAWN_TIMEOUT = 240


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: directory of its ranks' npz files}; the three worlds
    run at the same time."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out, procs = {}, []
    for world in sorted(rig.CASES):
        out[world] = str(tmp_path_factory.mktemp("world%d" % world))
        port = str(_free_port())
        procs += [(world, r, subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel", str(r),
             str(world), port, out[world]], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for r in range(world)]
    errs = []
    try:
        for _, _, p in procs:
            errs.append(p.communicate(timeout=SPAWN_TIMEOUT)[1])
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (world, r, p), err in zip(procs, errs):
        assert p.returncode == 0, (world, r, err[-3000:])
    return out


def _ranks(worlds, world, case):
    return [dict(np.load(os.path.join(worlds[world], "%s-%d.npz"
                                      % (case, r))))
            for r in range(world)]


def _close(got, want, tol=TOL):
    """Within ``tol`` of the scale of ``want`` (its largest entry, at
    least 1): float32 sums taken in another order across the ranks."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (err, tol * scale)


def _same(ranks, key):
    for r in ranks[1:]:
        assert np.array_equal(r[key], ranks[0][key]), key


def _j(a):
    return jnp.asarray(a)


# -- tensor parallelism ----------------------------------------------------------

def _jax_pair(case, mesh, batch_axis=None):
    from paddle_tpu.parallel.tensor_parallel import megatron_dense_pair

    data = {k: _j(v) for k, v in rig.inputs(case).items()}

    def loss(x, w1, b1, w2, b2):
        return jnp.sum(megatron_dense_pair(x, w1, b1, w2, b2, mesh,
                                           batch_axis=batch_axis) ** 2)

    args = [data[k] for k in ("x", "w1", "b1", "w2", "b2")]
    out, grads = jax.jit(lambda *a: (
        megatron_dense_pair(*a, mesh, batch_axis=batch_axis),
        jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*a)))(*args)
    return np.asarray(out), dict(zip(("x", "w1", "b1", "w2", "b2"), grads))


@pytest.mark.parametrize("case", ["pair", "pair_dp"])
def test_megatron_pair_matches_jax(worlds, case):
    """{"model": 4}, and {"data": 2, "model": 4} with batch_axis="data":
    each rank's rows of the result and the whole gradients."""
    world = 4 if case == "pair" else 8
    ranks = _ranks(worlds, world, case)
    if case == "pair":
        out, grads = _jax_pair(case, jax_mesh({"model": 4}))
    else:
        out, grads = _jax_pair(case, jax_mesh({"data": 2, "model": 4}),
                               batch_axis="data")
    for r, got in enumerate(ranks):
        rows = out if case == "pair" else np.split(out, 2)[r // 4]
        _close(got["out"], rows)
        for name, g in grads.items():
            _close(got["g" + name], g)
    for key in ("gx", "gw1", "gb1", "gw2", "gb2"):
        _same(ranks, key)


def test_tensor_parallel_rules(worlds):
    ranks = _ranks(worlds, 4, "tp_rules")
    full = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    for r, got in enumerate(ranks):
        assert str(got["w_spec"]) == "PartitionSpec(None, 'model')"
        assert str(got["b_spec"]) == "PartitionSpec()"
        np.testing.assert_array_equal(got["w"], full[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["b"], np.arange(8.0))
        np.testing.assert_array_equal(got["w_gathered"], full)


# -- the pipeline ----------------------------------------------------------------

def test_pipeline_matches_jax(worlds):
    from paddle_tpu.parallel.pipeline import pipeline_apply

    data = {k: _j(v) for k, v in rig.inputs("pipeline").items()}
    mesh = jax_mesh({"pipe": 4})

    def stage(p, x):
        return x + jnp.tanh(x @ p["w"] + p["b"])

    def loss(w, b, xs):
        return jnp.sum(pipeline_apply(stage, {"w": w, "b": b}, xs,
                                      mesh) ** 2)

    out, (gw, gb, gxs) = jax.jit(lambda w, b, xs: (
        pipeline_apply(stage, {"w": w, "b": b}, xs, mesh),
        jax.grad(loss, argnums=(0, 1, 2))(w, b, xs)))(
            data["w"], data["b"], data["xs"])
    ranks = _ranks(worlds, 4, "pipeline")
    for got in ranks:
        _close(got["out"], out)
        _close(got["gw"], gw)
        _close(got["gb"], gb)
        _close(got["gxs"], gxs)
    for key in ("out", "gw", "gb", "gxs"):
        _same(ranks, key)


# -- sequence parallelism --------------------------------------------------------

@pytest.fixture(scope="module")
def jax_attention():
    """{(world, strategy, causal): (out, (gq, gk, gv))} of the JAX
    package's ring / Ulysses attention over {"seq": world}."""
    from paddle_tpu.parallel.context_parallel import (ring_attention,
                                                      ulysses_attention)

    data = rig.inputs("attn")
    q, k, v = (_j(data[n]) for n in "qkv")
    out = {}
    for world in (2, 8):
        mesh = jax_mesh({"seq": world})
        for name, fn in (("ring", ring_attention),
                         ("ulysses", ulysses_attention)):
            for causal in (False, True):
                def fwd(q, k, v, fn=fn, causal=causal, mesh=mesh):
                    return fn(q, k, v, mesh, seq_axis="seq", causal=causal)

                def loss(q, k, v, fwd=fwd):
                    return jnp.sum(fwd(q, k, v) ** 2)

                out[(world, name, causal)] = jax.jit(
                    lambda q, k, v, fwd=fwd, loss=loss: (
                        fwd(q, k, v),
                        jax.grad(loss, argnums=(0, 1, 2))(q, k, v)))(q, k, v)
    return out


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
@pytest.mark.parametrize("world", [2, 8])
def test_sequence_parallel_attention_matches_jax(worlds, jax_attention,
                                                 world, strategy, causal):
    """Each rank's sequence block of the output, and the whole gradients
    of q, k and v, against the JAX package's over the same mesh."""
    want, grads = jax_attention[(world, strategy, causal)]
    ranks = _ranks(worlds, world, "attn")
    key = "%s_%d_" % (strategy, causal)
    for r, got in enumerate(ranks):
        _close(got[key + "out"], np.split(want, world, axis=1)[r])
        for n, g in zip("qkv", grads):
            _close(got[key + "g" + n], g)
    for n in "qkv":
        _same(ranks, key + "g" + n)


# -- the sharded embedding -------------------------------------------------------

def test_sharded_lookup_matches_jax(worlds):
    from paddle_tpu.parallel.sharded_embedding import sharded_lookup

    data = rig.inputs("lookup")
    mesh = jax_mesh({"model": 4})
    want = jax.jit(lambda t, i: sharded_lookup(t, i, mesh, "model"))(
        _j(data["table"]), _j(data["ids"]))

    def loss(t):
        return jnp.sum((sharded_lookup(t, _j(data["gids"]), mesh, "model")
                        - _j(data["tgt"])) ** 2)

    gtable = jax.jit(jax.grad(loss))(_j(data["gtable"]))
    ranks = _ranks(worlds, 4, "lookup")
    for got in ranks:
        _close(got["out"], want)
        _close(got["gtable"], gtable)
        # the dense gradient, not N times it
        dense = jax.grad(lambda t: jnp.sum(
            (jnp.take(t, _j(data["gids"]), axis=0) - _j(data["tgt"])) ** 2))(
                _j(data["gtable"]))
        _close(got["gtable"], dense)
    _same(ranks, "out")


def test_sharded_embedding_layer_matches_jax(worlds):
    import paddle_tpu as jpaddle
    from paddle_tpu.topology import Topology as JaxTopology

    mesh = jax_mesh({"model": 4})
    out = rig.emb_layer(jpaddle, mesh)
    topo = JaxTopology(out)
    params = {k: _j(v) for k, v in rig.numpy_params(
        topo.param_specs()).items()}
    feed = {"ids": _j(rig.inputs("emb_layer")["ids"])}

    def loss(p):
        vals, _ = topo.apply(p, feed, mode="train")
        return jnp.sum(vals[out.name] ** 2)

    want = jax.jit(lambda p: topo.apply(p, feed, mode="train")[0][
        out.name])(params)
    grads = jax.jit(jax.grad(loss))(params)
    ranks = _ranks(worlds, 4, "emb_layer")
    for got in ranks:
        # a rank holds 64 / 4 rows of the table; Parameters.get gathers it
        assert got["table_rows"].tolist() == [16, 5]
        np.testing.assert_array_equal(got["table_get"],
                                      rig.numpy_params(topo.param_specs())[
                                          "semb.w0"])
        _close(got["out"], want)
        for name, g in grads.items():
            _close(got["g_" + name], g)


# -- ExtraAttr(sharding=) under use_mesh ----------------------------------------

def test_layer_sharding_fc_stack_matches_jax(worlds):
    """tests/test_layer_sharding.py's stack over {"model": 8}: the
    sharded fcs compute their column blocks; the values within 2e-5 of
    the JAX package's under its mesh, the gradients within 1e-5 of its
    unsharded ones."""
    import paddle_tpu as jpaddle
    from paddle_tpu.parallel.mesh import use_mesh as jax_use_mesh
    from paddle_tpu.topology import Topology as JaxTopology

    out = rig.fc_stack(jpaddle)
    topo = JaxTopology(out)
    params = {k: _j(v) for k, v in rig.numpy_params(
        topo.param_specs()).items()}
    feed = {"x": _j(rig.inputs("fc_stack")["x"])}
    with jax_use_mesh(jax_mesh({"model": 8})):
        want, _ = jax.jit(lambda p, f: topo.apply(p, f, mode="test"))(
            params, feed)

    def loss(p):
        return jnp.sum(topo.apply(p, feed, mode="train")[0][out.name] ** 2)

    grads = jax.jit(jax.grad(loss))(params)
    ranks = _ranks(worlds, 8, "fc_stack")
    for got in ranks:
        _close(got["out"], want[out.name], TOL_STACK)
        for name, g in grads.items():
            _close(got["g_" + name], g)
    _same(ranks, "out")


# -- the parallel transformer ----------------------------------------------------

def _jax_transformer(attention):
    from paddle_tpu.models.transformer import ParallelTransformer

    mesh = jax_mesh({"data": 2, "model": 2, "pipe": 2})
    model = ParallelTransformer(mesh, attention=attention, **rig.TRANSFORMER)
    data = rig.inputs("transformer")
    params = {k: _j(v) for k, v in data.items()
              if k not in ("tokens", "labels") and not k.startswith("pipe")}
    params["pipe"] = {"w": _j(data["pipe.w"]), "b": _j(data["pipe.b"])}
    tokens = jax.device_put(_j(data["tokens"]),
                            NamedSharding(mesh, JP("data", None)))
    labels = jax.device_put(_j(data["labels"]),
                            NamedSharding(mesh, JP("data")))
    return model, params, tokens, labels


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_parallel_transformer_forward_matches_jax(worlds, attention):
    """{"data": 2, "model": 2, "pipe": 2}: each rank's rows of the logits
    within 2e-4 of the JAX package's sharded forward and of
    apply_reference on one rank."""
    model, params, tokens, _ = _jax_transformer(attention)
    want = np.asarray(jax.jit(model.apply)(model.place(params), tokens))
    ref = np.asarray(model.apply_reference(params, tokens))
    ranks = _ranks(worlds, 8, "transformer")
    for r, got in enumerate(ranks):
        rows = np.split(want, 2)[r // 4]   # rank r's data index
        _close(got[attention + "_out"], rows, TOL_TRANSFORMER)
        _close(got[attention + "_out"], np.split(ref, 2)[r // 4],
               TOL_TRANSFORMER)
        _close(got[attention + "_ref"], ref, TOL_TRANSFORMER)


def test_parallel_transformer_train_step_matches_jax(worlds):
    """Two SGD steps (lr 0.1) of the global loss: the losses and the
    gathered parameters within 2e-4 of the JAX package's train step; the
    loss falls and every rank holds the same values bit for bit."""
    model, params, tokens, labels = _jax_transformer("ring")
    placed = model.place(params)

    @jax.jit
    def step(p):
        loss, g = jax.value_and_grad(model.loss)(p, tokens, labels)
        return loss, jax.tree_util.tree_map(lambda a, b: a - rig.LR * b,
                                            p, g)

    losses = []
    for _ in range(2):
        loss, placed = step(placed)
        losses.append(float(loss))
    ranks = _ranks(worlds, 8, "transformer")
    for got in ranks:
        _close(got["losses"], losses, TOL_TRANSFORMER)
        assert got["losses"][1] < got["losses"][0]
        for name in ("embed", "qkv_w", "proj_w", "head_w1", "head_b1",
                     "head_w2", "head_b2"):
            _close(got["p_" + name], placed[name], TOL_TRANSFORMER)
        for name in ("w", "b"):
            _close(got["p_pipe." + name], placed["pipe"][name],
                   TOL_TRANSFORMER)
    for key in ranks[0]:
        if key.startswith("p_") or key == "losses":
            _same(ranks, key)


# -- the sharded models ----------------------------------------------------------

def _jax_trajectory(case):
    """The JAX package's trainer over the same numpy parameters and
    batches, its embedding sharded over its own mesh: (costs, params)."""
    import paddle_tpu as jpaddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.graph import reset_name_counters
    from paddle_tpu.models import recommender
    from paddle_tpu.parameters import Parameters as JaxParameters
    from paddle_tpu.topology import Topology as JaxTopology

    if case == "flagship":
        from __graft_entry__ import _flagship

        cfg = rig.FLAGSHIP
        cost = _flagship(cfg["dict_size"], cfg["emb"], cfg["hidden"],
                         cfg["classes"],
                         sharded_emb_mesh=jax_mesh({"data": 2,
                                                    "model": 2}))[3]
        feeding = None
    else:
        reset_name_counters()
        cost = recommender.wide_deep_ctr(sharded_mesh=jax_mesh({"model": 2}),
                                         **rig.CTR)[2]
        feeding = {"wide_features": 0, "field0": 1, "field1": 2,
                   "field2": 3, "click": 4}
    topo = JaxTopology(cost)
    params = JaxParameters()
    params._specs = topo.param_specs()
    params._values = {k: _j(v) for k, v in
                      rig.numpy_params(topo.param_specs()).items()}
    trainer = jpaddle.trainer.SGD(cost, params, jopt.Momentum(
        learning_rate=rig.LR, momentum=0.9))
    costs = []

    def handler(evt):
        if isinstance(evt, jpaddle.event.EndIteration):
            costs.append(evt.cost)

    data = rig.inputs(case)["batches"]
    trainer.train(lambda: iter(data), num_passes=1, event_handler=handler,
                  feeding=feeding)
    return np.asarray(costs), {n: np.asarray(params.get(n))
                               for n in params.names()}, trainer


@pytest.mark.parametrize("case,world,table,rows", [
    ("flagship", 4, "flag_emb.w0", (32, 8)),
    ("ctr", 2, "ctr_field0_emb.w0", (25, 8))])
def test_sharded_model_trajectory_matches_jax(worlds, case, world, table,
                                              rows):
    """Two Momentum steps of the sharded flagship ({"data": 2, "model":
    2}) and of the sharded CTR ({"data": 1, "model": 2}) under
    DataParallel against the JAX trainer: costs and (gathered) parameters
    within 1e-5; a rank holds V/N rows of the table and of its slot; the
    ranks agree bit for bit."""
    costs, params, _ = _jax_trajectory(case)
    ranks = _ranks(worlds, world, case)
    for got in ranks:
        assert len(got["costs"]) == len(costs) == 2
        _close(got["costs"], costs)
        assert sorted(k[2:] for k in got if k.startswith("p_")) == \
            sorted(params)
        for name, value in params.items():
            _close(got["p_" + name], value)
        assert tuple(got["table_local"]) == rows
        assert [tuple(s) for s in got["slot_local"]] == [rows]
    for key in ranks[0]:
        if key.startswith("p_") or key == "costs":
            _same(ranks, key)


def test_sharded_checkpoint_resumes_and_loads_in_jax(worlds, tmp_path):
    """The sharded flagship ({"data": 2, "model": 2}) checkpointed after 2
    steps, by the overlapped writer and by a blocking save: rank 0 alone
    writes, each checkpoint holds the global table and global optimizer
    slots (the JAX trainer's own checkpoint after the same steps, within
    1e-5, and the JAX trainer restores it), ``save_checkpoint(
    coordinator=)`` is refused, and a trainer that resumes from it trains
    the second pass bit for bit as one that never stopped, its rank
    holding V/N rows of the table and its slot."""
    from paddle_tpu.distributed import checkpoint as jckpt

    _, params, jtrainer = _jax_trajectory("flagship")
    ranks = _ranks(worlds, 4, "checkpoint")
    assert [bool(r["wrote"]) for r in ranks] == [True, False, False, False]
    assert all(bool(r["refused"]) for r in ranks)
    for got in ranks:
        assert len(got["c_costs"]) == 4
        assert np.array_equal(got["b_costs"], got["c_costs"][2:])
        for name in params:
            assert np.array_equal(got["b_" + name], got["c_" + name]), name
        assert tuple(got["b_table_local"]) == (32, 8)
        assert [tuple(s) for s in got["b_slot_local"]] == [(32, 8)]
    jtrainer.save_checkpoint(str(tmp_path), pass_id=0)
    want, want_opt, _ = jckpt.load_checkpoint(
        jckpt.latest_checkpoint(str(tmp_path)))
    for sub in ("ckpt-async", "ckpt-sync"):
        path = jckpt.latest_checkpoint(os.path.join(worlds[4], sub))
        got, got_opt, meta = jckpt.load_checkpoint(path)
        assert meta["step"] == 2
        assert sorted(got.names()) == sorted(want.names())
        for name in want.names():
            _close(got.get(name), want.get(name))
        assert sorted(got_opt) == sorted(want_opt)
        for key, value in want_opt.items():
            _close(got_opt[key], value)
        assert jtrainer.restore_checkpoint(path)["step"] == 2
