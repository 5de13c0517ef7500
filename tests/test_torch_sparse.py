"""Sparse input rows in the port (paddle_tpu_torch/core/sparse.py and the
sparse feed of topology.convert_column) against the JAX package, on the
CPU, small:

- ``SparseRows.from_rows``: ids, values, padding and K equal to the JAX
  package's, binary and valued, for empty rows, duplicates and K past 8;
- the feed: at or above ``sparse_feed_threshold`` a SparseRows, below it
  dense rows, a sparse sequence slot densified per step, equal to the JAX
  package's; duplicate ids sum on both paths;
- sparse ``fc`` against the JAX package's (outputs and the gradient of
  every parameter) and against the densified path, on both sides of the
  threshold (``force_sparse`` as tests/test_sparse_input.py); a layer
  without a sparse path reads the dense rows; ``to_dense`` refuses above
  262144 dims;
- int8 sparse ``fc`` (gather of int8 rows, scale after the K-sum) against
  the JAX package's and against the densified dequantized product;
- the sparse-row update of ``Momentum`` (``ParamAttr(sparse_update=
  True)`` and ``Momentum(sparse=True)``) against the JAX package's
  ``Optimizer.step`` over 3 steps, with rows dormant between steps, a
  touched row whose gradient is exactly 0, and the L1/L2 catch-up.

Tolerance: forward 1e-5, gradients and updates 5e-6 (absolute, float32;
the two packages sum the same products in different orders).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu import data_type as jdt
from paddle_tpu import layer as JL
from paddle_tpu import optimizer as jopt
from paddle_tpu.attr import ParamAttr as JParamAttr
from paddle_tpu.core.sparse import SparseRows as JSparseRows
from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.serve import quantize as jq
from paddle_tpu.topology import Topology as JTopology
from paddle_tpu.topology import _densify as jax_densify
from paddle_tpu.topology import convert_feed as jax_convert_feed
from paddle_tpu.utils import flags as jflags

from paddle_tpu_torch import data_type as dt
from paddle_tpu_torch import layer as L
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.attr import ParamAttr
from paddle_tpu_torch.core.sparse import MAX_DENSE_DIM, SparseRows
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.serve import quantize as pq
from paddle_tpu_torch.topology import Topology, _densify, convert_feed
from paddle_tpu_torch.utils import flags
from paddle_tpu_torch.utils.error import EnforceError

TOL_FWD = 1e-5
TOL_GRAD = 5e-6

ROW_SETS = {
    "plain": [[3, 17, 42], [0], [5, 63, 7, 12, 31]],
    "empty_row": [[], [1, 2], [9]],
    "duplicates": [[5, 5, 9], [2, 2, 2, 2]],
    "k_past_8": [list(range(0, 60, 6)), [1], list(range(3, 40, 4))],
}


def _valued(rows, seed=0):
    rng = np.random.RandomState(seed)
    return [[(i, float(rng.randn())) for i in r] for r in rows]


@pytest.fixture
def force_sparse():
    """Both packages feed every sparse slot as SparseRows."""
    old, jold = (flags.get_flag("sparse_feed_threshold"),
                 jflags.get_flag("sparse_feed_threshold"))
    flags.set_flag("sparse_feed_threshold", 1)
    jflags.set_flag("sparse_feed_threshold", 1)
    yield
    flags.set_flag("sparse_feed_threshold", old)
    jflags.set_flag("sparse_feed_threshold", jold)


# -- SparseRows and the feed ---------------------------------------------------

@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("rows", sorted(ROW_SETS))
def test_from_rows_matches_jax(rows, with_values):
    rows = ROW_SETS[rows]
    if with_values:
        rows = _valued(rows)
    got = SparseRows.from_rows(rows, 64, with_values)
    want = JSparseRows.from_rows(rows, 64, with_values)
    assert got.dim == want.dim == 64 and got.ids.dtype == torch.int32
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert got.ids.shape[1] >= 8 and got.ids.shape[1] & (
        got.ids.shape[1] - 1) == 0
    if with_values:
        assert got.vals.dtype == torch.float32
        np.testing.assert_array_equal(got.vals.numpy(),
                                      np.asarray(want.vals))
    else:
        assert got.vals is None and want.vals is None
    np.testing.assert_array_equal(got.weights().numpy(),
                                  np.asarray(want.weights()))
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(want.to_dense()))


@pytest.mark.parametrize("dim,sparse", [(64, False), (5000, True)])
@pytest.mark.parametrize("kind", ["binary", "valued"])
def test_feed_is_sparse_at_the_threshold_and_dense_below(dim, sparse, kind):
    make = {"binary": (dt.sparse_binary_vector, jdt.sparse_binary_vector),
            "valued": (dt.sparse_vector, jdt.sparse_vector)}[kind]
    rows = ROW_SETS["duplicates"]
    if kind == "valued":
        rows = _valued(rows, seed=1)
    reset_name_counters()
    x = L.data(name="x", type=make[0](dim))
    jax_reset_names()
    jx = JL.data(name="x", type=make[1](dim))
    feed = convert_feed(Topology(x), [(r,) for r in rows], device="cpu")["x"]
    jfeed = jax_convert_feed(JTopology(jx), [(r,) for r in rows])["x"]
    assert isinstance(feed, SparseRows) == sparse
    assert isinstance(jfeed, JSparseRows) == sparse
    if sparse:
        np.testing.assert_array_equal(feed.ids.numpy(),
                                      np.asarray(jfeed.ids))
        feed, jfeed = feed.to_dense(), jfeed.to_dense()
    assert feed.dtype == torch.float32 and feed.shape == (2, dim)
    np.testing.assert_array_equal(feed.numpy(), np.asarray(jfeed))


def test_duplicate_ids_sum_on_both_paths():
    rows = [[5, 5, 9], [1, 1, 1]]
    itype = dt.sparse_binary_vector(16)
    dense = _densify(rows, itype)
    np.testing.assert_array_equal(
        dense, jax_densify(rows, jdt.sparse_binary_vector(16)))
    np.testing.assert_array_equal(
        dense, SparseRows.from_rows(rows, 16, False).to_dense().numpy())
    assert dense[0, 5] == 2.0 and dense[1, 1] == 3.0
    w = torch.randn(16, 3, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(
        SparseRows.from_rows(rows, 16, False).matmul(w).numpy(),
        dense @ w.numpy(), rtol=0, atol=TOL_FWD)


@pytest.mark.parametrize("kind", ["binary", "valued"])
def test_sparse_sequence_slot_densifies_per_step(kind):
    make = {"binary": (dt.sparse_binary_vector_sequence,
                       jdt.sparse_binary_vector_sequence),
            "valued": (dt.sparse_vector_sequence,
                       jdt.sparse_vector_sequence)}[kind]
    seqs = [[[1, 3], [3, 3, 7]], [[0]], [[2], [], [9, 1]]]
    if kind == "valued":
        seqs = [_valued(s, seed=i) for i, s in enumerate(seqs)]
    reset_name_counters()
    x = L.data(name="x", type=make[0](10))
    jax_reset_names()
    jx = JL.data(name="x", type=make[1](10))
    got = convert_feed(Topology(x), [(s,) for s in seqs], device="cpu")["x"]
    want = jax_convert_feed(JTopology(jx), [(s,) for s in seqs])["x"]
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    assert got.data.shape == (3, 16, 10)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))


@pytest.mark.parametrize("dim,ok", [(MAX_DENSE_DIM, True),
                                    (MAX_DENSE_DIM + 1, False),
                                    (1 << 20, False)])
def test_to_dense_refuses_above_262144_dims(dim, ok):
    rows = SparseRows(torch.zeros((2, 8), dtype=torch.int32), None, dim)
    jrows = JSparseRows(jnp.zeros((2, 8), jnp.int32), None, dim)
    if ok:
        assert rows.to_dense().shape == (2, dim)
        assert jrows.to_dense().shape == (2, dim)
        return
    with pytest.raises(EnforceError, match="refusing to densify"):
        rows.to_dense()
    with pytest.raises(Exception, match="refusing to densify"):
        jrows.to_dense()


def test_matmul_refuses_a_weight_of_another_height():
    rows = SparseRows.from_rows([[1]], 8, False)
    with pytest.raises(EnforceError, match="weight rows 9 != sparse dim 8"):
        rows.matmul(torch.zeros(9, 2))


# -- sparse fc against the JAX package and the dense path ---------------------

def _sparse_net(pkg_layer, pkg_dt, kind, dim):
    """A sparse slot through fc (two inputs: the sparse slot and a dense
    one), a layer without a sparse path (addto over the slot itself) and
    a square error cost."""
    make = (pkg_dt.sparse_binary_vector if kind == "binary"
            else pkg_dt.sparse_vector)
    x = pkg_layer.data(name="x", type=make(dim))
    d = pkg_layer.data(name="d", type=pkg_dt.dense_vector(3))
    y = pkg_layer.data(name="y", type=pkg_dt.dense_vector(1))
    h = pkg_layer.fc(input=[x, d], size=4, name="sfc")
    head = pkg_layer.fc(input=h, size=1, bias_attr=False, name="shead")
    cost = pkg_layer.square_error_cost(input=head, label=y, name="scost")
    return h, cost


def _numpy_params(specs, seed=0):
    rng = np.random.RandomState(seed)
    return {name: (rng.standard_normal(spec.shape) * 0.3).astype(np.float32)
            for name, spec in sorted(specs.items())}


def _samples(kind, dim, seed=0, rows=5):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(rows):
        ids = rng.randint(0, dim, rng.randint(1, 12)).tolist()
        if i == 1:
            ids = [ids[0], ids[0]] + ids  # a duplicate id
        feat = (ids if kind == "binary"
                else [(j, float(rng.randn())) for j in ids])
        out.append((feat, rng.randn(3).astype(np.float32),
                    np.array([rng.randn()], np.float32)))
    return out


def _port_value_and_grads(topo, cost, arrays, feed):
    params = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in arrays.items()}
    out, _ = topo.apply(params, feed, mode="train", outputs=[cost.name])
    loss = out[cost.name].mean()
    loss.backward()
    return (float(loss.detach()),
            {k: p.grad.numpy() for k, p in params.items()})


@pytest.mark.parametrize("threshold_side", ["sparse", "dense"])
@pytest.mark.parametrize("kind", ["binary", "valued"])
def test_sparse_fc_matches_jax_and_the_dense_path(request, threshold_side,
                                                  kind):
    dim = 64
    if threshold_side == "sparse":
        request.getfixturevalue("force_sparse")
    reset_name_counters()
    _, cost = _sparse_net(L, dt, kind, dim)
    jax_reset_names()
    _, jcost = _sparse_net(JL, jdt, kind, dim)
    topo, jtopo = Topology(cost), JTopology(jcost)
    arrays = _numpy_params(topo.param_specs())
    samples = _samples(kind, dim)
    feed = convert_feed(topo, samples, device="cpu")
    jfeed = jax_convert_feed(jtopo, samples)
    assert isinstance(feed["x"], SparseRows) == (threshold_side == "sparse")
    loss, grads = _port_value_and_grads(topo, cost, arrays, feed)

    def jloss(params):
        values, _ = jtopo.apply(params, jfeed, mode="test")
        return jnp.mean(values[jcost.name])

    jl, jgrads = jax.value_and_grad(jloss)(
        {k: jnp.asarray(v) for k, v in arrays.items()})
    np.testing.assert_allclose(loss, float(jl), rtol=0, atol=TOL_FWD)
    assert sorted(grads) == sorted(jgrads)
    for name in grads:
        np.testing.assert_allclose(grads[name], np.asarray(jgrads[name]),
                                   rtol=0, atol=TOL_GRAD, err_msg=name)
    # the densified feed gives the same loss and gradients in the port
    dense = dict(feed, x=feed["x"].to_dense()
                 if isinstance(feed["x"], SparseRows) else feed["x"])
    dloss, dgrads = _port_value_and_grads(topo, cost, arrays, dense)
    np.testing.assert_allclose(loss, dloss, rtol=0, atol=TOL_FWD)
    for name in grads:
        np.testing.assert_allclose(grads[name], dgrads[name], rtol=0,
                                   atol=TOL_GRAD, err_msg=name)
    # the gradient of the sparse table lives on the rows the batch names
    picked = {j if kind == "binary" else j[0] for s in samples for j in s[0]}
    rows_with_grad = set(np.flatnonzero(np.abs(grads["sfc.w0"]).sum(1)))
    assert rows_with_grad <= picked and rows_with_grad


def test_a_layer_without_a_sparse_path_reads_the_dense_rows(force_sparse):
    def build(pkg_layer, pkg_dt):
        x = pkg_layer.data(name="x", type=pkg_dt.sparse_vector(12))
        return pkg_layer.addto(input=[x, x], name="twice")

    reset_name_counters()
    out = build(L, dt)
    jax_reset_names()
    jout = build(JL, jdt)
    samples = [(r,) for r in _valued([[1, 4, 4], [11]], seed=2)]
    got = Topology(out).apply({}, convert_feed(Topology(out), samples,
                                               device="cpu"),
                                  mode="test")[0][out.name]
    jtopo = JTopology(jout)
    want, _ = jtopo.apply({}, jax_convert_feed(jtopo, samples), mode="test")
    np.testing.assert_allclose(got.numpy(), np.asarray(want[jout.name]),
                               rtol=0, atol=TOL_FWD)


def test_int8_sparse_fc_matches_jax_and_the_dequantized_product(
        force_sparse):
    """fc over SparseRows with an int8 weight: the port gathers int8 rows,
    converts only those and applies the scale after the K-sum, as the JAX
    package does (tests/test_quantize.py:175); both agree with the dense
    rows times the dequantized weight."""
    dim, size = 40, 6

    def build(pkg_layer, pkg_dt):
        x = pkg_layer.data(name="x", type=pkg_dt.sparse_vector(dim))
        return pkg_layer.fc(input=x, size=size, bias_attr=False, name="qfc")

    reset_name_counters()
    out = build(L, dt)
    jax_reset_names()
    jout = build(JL, jdt)
    w = np.random.RandomState(4).randn(dim, size).astype(np.float32)
    q, scale = pq.quantize_int8(w)
    jqw, jscale = jq.quantize_int8(w)
    assert q.tobytes() == jqw.tobytes() and scale.tobytes() == \
        jscale.tobytes()
    samples = [(r,) for r in _valued([[1, 5, 7], [0], [2, 2, 30, 39]],
                                     seed=3)]
    topo, jtopo = Topology(out), JTopology(jout)
    feed = convert_feed(topo, samples, device="cpu")
    got = topo.apply({"qfc.w0": torch.from_numpy(q),
                      "qfc.w0::scale": torch.from_numpy(scale)},
                     feed, mode="test")[0][out.name].numpy()
    want, _ = jtopo.apply({"qfc.w0": jnp.asarray(q),
                           "qfc.w0::scale": jnp.asarray(scale)},
                          jax_convert_feed(jtopo, samples), mode="test")
    np.testing.assert_allclose(got, np.asarray(want[jout.name]), rtol=0,
                               atol=TOL_FWD)
    dense = feed["x"].to_dense().numpy()
    np.testing.assert_allclose(got, dense @ pq.dequantize(q, scale), rtol=0,
                               atol=TOL_FWD)


def test_bfloat16_policy_casts_the_values_and_gathers_the_cast_table(
        force_sparse):
    """Under the bfloat16 compute policy the values cross the boundary as
    bfloat16 (ids unchanged) and the gather runs on the cast table: the
    result is bfloat16 and close to the float32 one."""
    from paddle_tpu_torch.core import dtype as dtype_mod

    reset_name_counters()
    x = L.data(name="x", type=dt.sparse_vector(30))
    out = L.fc(input=x, size=4, bias_attr=False, name="bfc")
    topo = Topology(out)
    params = {"bfc.w0": torch.from_numpy(
        _numpy_params(topo.param_specs())["bfc.w0"])}
    feed = convert_feed(topo, [(r,) for r in _valued([[1, 2], [29, 3, 3]])],
                        device="cpu")
    want = topo.apply(params, feed, mode="test")[0][out.name]
    dtype_mod.set_mixed_precision("bfloat16")
    try:
        got = topo.apply(params, feed, mode="test")[0][out.name]
    finally:
        dtype_mod.set_mixed_precision(None)
    assert want.dtype == torch.float32 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=0,
                               atol=3e-2)


# -- the sparse-row update ---------------------------------------------------

def _grad_steps(shape, seed=0):
    """Three gradients of a [rows, cols] table: each touches a few rows
    (the rest exactly 0), row 2 is touched at step 1 and step 3 only (two
    missed steps to catch up), row 5 is touched at step 2 with a gradient
    that is exactly 0 (so it stays dormant), and rows >= 7 never."""
    rng = np.random.RandomState(seed)
    touched = [[0, 1, 2], [0, 3, 5], [1, 2, 4]]
    out = []
    for step, rows in enumerate(touched):
        g = np.zeros(shape, np.float32)
        for r in rows:
            if (r, step) != (5, 1):
                g[r] = rng.randn(shape[1]) * 0.5
        out.append(g)
    return out


@pytest.mark.parametrize("reg", ["none", "l2", "l1", "l1_l2"])
@pytest.mark.parametrize("mode", ["param_attr", "global_sparse"])
def test_sparse_row_momentum_matches_jax(reg, mode):
    l1 = {"l1": 0.05, "l1_l2": 0.02}.get(reg)
    l2 = {"l2": 0.1, "l1_l2": 0.05}.get(reg)
    rng = np.random.RandomState(1)
    table = rng.randn(9, 3).astype(np.float32)
    bias = rng.randn(3).astype(np.float32)
    grads = _grad_steps(table.shape)
    bias_grads = [np.array([0.0, 0.3, 0.0], np.float32)] * 3
    sparse = mode == "global_sparse"
    kw = dict(learning_rate=0.1, momentum=0.9, sparse=sparse)
    if l2 and reg == "l2":
        kw["regularization"] = opt.L2Regularization(rate=l2)
    meta = {"t": ParamAttr(sparse_update=not sparse,
                           l1_rate=l1 if reg != "l2" else None,
                           l2_rate=l2 if reg == "l1_l2" else None)}
    jmeta = {"t": JParamAttr(sparse_update=not sparse,
                             l1_rate=meta["t"].l1_rate,
                             l2_rate=meta["t"].l2_rate)}
    jkw = dict(kw)
    if "regularization" in kw:
        jkw["regularization"] = jopt.L2Regularization(rate=l2)
    port, jax_opt = opt.Momentum(**kw), jopt.Momentum(**jkw)
    params = {"t": torch.from_numpy(table.copy()),
              "b": torch.from_numpy(bias.copy())}
    jparams = {"t": jnp.asarray(table), "b": jnp.asarray(bias)}
    state = port.init_state(params, meta)
    jstate = jax_opt.init_state(jparams, jmeta)
    assert sorted(state["row_step"]) == sorted(jstate["row_step"]) == ["t"]
    for g, gb in zip(grads, bias_grads):
        port.step(params, {"t": torch.from_numpy(g),
                           "b": torch.from_numpy(gb)}, state, meta)
        jparams, jstate = jax_opt.step(
            jparams, {"t": jnp.asarray(g), "b": jnp.asarray(gb)}, jstate,
            jmeta)
        for name in ("t", "b"):
            np.testing.assert_allclose(params[name].numpy(),
                                       np.asarray(jparams[name]), rtol=0,
                                       atol=TOL_GRAD, err_msg=name)
        np.testing.assert_array_equal(state["row_step"]["t"].numpy(),
                                      np.asarray(jstate["row_step"]["t"]))
        np.testing.assert_allclose(state["slots"]["t"][0].numpy(),
                                   np.asarray(jstate["slots"]["t"][0]),
                                   rtol=0, atol=TOL_GRAD)
    assert state["row_step"]["t"].dtype == torch.int32
    assert state["row_step"]["t"].tolist() == [2, 3, 3, 2, 3, 0, 0, 0, 0]
    # rows never touched, and the row whose only gradient was exactly 0,
    # keep their initial values bit for bit
    np.testing.assert_array_equal(params["t"].numpy()[5:], table[5:])
    # the dense bias moves in every mode (its zero entries too, when a
    # regularizer applies), as the JAX package's does
    assert not np.array_equal(params["b"].numpy(), bias)


def test_sparse_row_update_is_in_place():
    port = opt.Momentum(learning_rate=0.1, momentum=0.9)
    table = torch.randn(6, 2, generator=torch.Generator().manual_seed(0))
    params = {"t": table}
    meta = {"t": ParamAttr(sparse_update=True)}
    state = port.init_state(params, meta)
    slot, rows = state["slots"]["t"][0], state["row_step"]["t"]
    grad = torch.zeros(6, 2)
    grad[1] = 1.0
    port.step(params, {"t": grad}, state, meta)
    assert params["t"] is table and state["slots"]["t"][0] is slot
    assert state["row_step"]["t"] is rows and rows.tolist() == [
        0, 1, 0, 0, 0, 0]
