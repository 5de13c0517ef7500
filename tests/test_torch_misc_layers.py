"""The port's assorted layers against the JAX package on the CPU:
paddle_tpu/layer/misc.py (tensor, selective_fc, out_prod, multiplex,
prelu, gated_unit), data_norm and featmap_expand, row_conv, block_expand
and mdlstmemory, mirroring the cases of tests/test_misc_layers.py and
tests/test_layer_grad.py.

Same seeded numpy inputs and parameters in both packages
(``tests/torch_parity.py``): values within 1e-6 of max(1, max |JAX|),
gradients of the mean of the last output with respect to every parameter
and floating feed within 1e-5 of max(1, max |JAX gradient|).
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.layer.base import layer_registry

from torch_parity import assert_match, both, run_both


def _dense(pkg, name, dim, height=None, width=None):
    return pkg.layer.data(name=name, type=pkg.data_type.dense_vector(dim),
                          height=height, width=width)


def _seq(pkg, name, dim):
    return pkg.layer.data(name=name,
                          type=pkg.data_type.dense_vector_sequence(dim))


def _rows(seed, n=3, **dims):
    """n rows {name: a vector of dims[name]}."""
    rng = np.random.RandomState(seed)
    return [{k: rng.randn(d).astype(np.float32) for k, d in dims.items()}
            for _ in range(n)]


def _seq_rows(seed, dim, lens=(5, 0, 3, 1)):
    rng = np.random.RandomState(seed)
    return [{"xs": rng.randn(k, dim).astype(np.float32)} for k in lens]


def _check(build, rows, out="out", **kw):
    return assert_match(*run_both(build, rows, [out], **kw))


# -- layer/misc.py -----------------------------------------------------------

@pytest.mark.parametrize("act,bias", [("Tanh", None), ("Linear", False)])
def test_tensor_matches_jax(act, bias):
    def build(pkg):
        return pkg.layer.tensor(_dense(pkg, "a", 4), _dense(pkg, "b", 5),
                                size=3, act=getattr(pkg.activation, act)(),
                                bias_attr=bias, name="out")

    _check(build, _rows(1, a=4, b=5))


@pytest.mark.parametrize("select,pass_generation", [
    (True, False), (True, True), (False, False)])
def test_selective_fc_matches_jax(select, pass_generation):
    def build(pkg):
        sel = _dense(pkg, "sel", 4) if select else None
        return pkg.layer.selective_fc(
            input=_dense(pkg, "x", 5), select=sel, size=4,
            act=pkg.activation.Sigmoid(), pass_generation=pass_generation,
            name="out")

    rows = _rows(2, x=5, sel=4)
    for row in rows:  # a 0/1 selection mask
        row["sel"] = (row["sel"] > 0).astype(np.float32)
    (values, _), _ = run_both(build, rows, ["out"])
    _check(build, rows)
    if select:
        mask = np.stack([r["sel"] for r in rows])
        assert np.all(values["out"][mask == 0] == 0.0)


def test_out_prod_matches_jax():
    def build(pkg):
        out = pkg.layer.out_prod(_dense(pkg, "a", 3), _dense(pkg, "b", 4),
                                 name="out")
        assert out.size == 12
        return out

    _check(build, _rows(3, a=3, b=4))


def test_multiplex_matches_jax():
    def build(pkg):
        idx = pkg.layer.data(name="idx",
                             type=pkg.data_type.integer_value(3))
        ins = [_dense(pkg, "i%d" % k, 4) for k in range(3)]
        return pkg.layer.multiplex(input=[idx] + ins, name="out")

    rows = _rows(4, i0=4, i1=4, i2=4)
    for row, k in zip(rows, (2, 0, 1)):
        row["idx"] = k
    (values, _), _ = run_both(build, rows, ["out"])
    for b, k in enumerate((2, 0, 1)):
        np.testing.assert_array_equal(values["out"][b], rows[b]["i%d" % k])
    _check(build, rows)


@pytest.mark.parametrize("partial_sum", [1, 2, 6])
def test_prelu_matches_jax(partial_sum):
    def build(pkg):
        return pkg.layer.prelu(input=_dense(pkg, "x", 6),
                               partial_sum=partial_sum, name="out")

    _check(build, _rows(5, x=6))


@pytest.mark.parametrize("act,biases", [("Tanh", True), (None, False)])
def test_gated_unit_matches_jax(act, biases):
    def build(pkg):
        return pkg.layer.gated_unit(
            input=_dense(pkg, "x", 5), size=4,
            act=getattr(pkg.activation, act)() if act else None,
            gate_bias_attr=biases, inproj_bias_attr=biases, name="out")

    _check(build, _rows(6, x=5))


def test_gated_unit_over_a_sequence_matches_jax():
    def build(pkg):
        return pkg.layer.gated_unit(input=_seq(pkg, "xs", 5), size=4,
                                    act=pkg.activation.Relu(), name="out")

    _check(build, _seq_rows(7, 5))


# -- layer/extra.py: data_norm, featmap_expand --------------------------------

@pytest.mark.parametrize("strategy", ["z-score", "min-max",
                                      "decimal-scaling"])
def test_data_norm_matches_jax(strategy):
    def build(pkg):
        return pkg.layer.data_norm(input=_dense(pkg, "x", 3),
                                   data_norm_strategy=strategy, name="out")

    stats = np.asarray([[1.0, 2.0, 3.0], [2.0, 0.5, 4.0], [-1.0, 0.0, 1.0],
                        [3.0, 2.0, 5.0], [10.0, 100.0, 1.0]], np.float32)
    _check(build, _rows(8, x=3), params={"out.w0": stats})
    _, out = both(build)
    static = paddle.parameters.Parameters.create(
        out, device="cpu").partition()[1]
    assert static == ["out.w0"]


def test_data_norm_refuses_an_unknown_strategy():
    with pytest.raises(Exception, match="unknown data_norm_strategy"):
        paddle.layer.data_norm(input=_dense(paddle, "x", 3),
                               data_norm_strategy="l2")


@pytest.mark.parametrize("as_row_vector", [True, False])
def test_featmap_expand_matches_jax(as_row_vector):
    def build(pkg):
        return pkg.layer.featmap_expand(input=_dense(pkg, "x", 2),
                                        num_filters=3,
                                        as_row_vector=as_row_vector,
                                        name="out")

    (values, _), _ = run_both(build, [{"x": np.asarray([1.0, 2.0],
                                                       np.float32)}],
                              ["out"])
    want = [1, 2, 1, 2, 1, 2] if as_row_vector else [1, 1, 1, 2, 2, 2]
    np.testing.assert_array_equal(values["out"][0], want)
    _check(build, _rows(9, x=2))


# -- row_conv, block_expand --------------------------------------------------

@pytest.mark.parametrize("context_len,act", [(1, None), (3, None),
                                             (3, "Relu")])
def test_row_conv_matches_jax(context_len, act):
    def build(pkg):
        return pkg.layer.row_conv(
            input=_seq(pkg, "xs", 4), context_len=context_len,
            act=getattr(pkg.activation, act)() if act else None, name="out")

    _check(build, _seq_rows(10, 4))


@pytest.mark.parametrize("bx,by,sx,sy,px,py", [
    (2, 2, None, None, 0, 0), (1, 1, None, None, 0, 0),
    (3, 2, 1, 2, 1, 0), (2, 3, 2, 1, 0, 1)])
def test_block_expand_matches_jax(bx, by, sx, sy, px, py):
    def build(pkg):
        img = _dense(pkg, "img", 2 * 4 * 5, height=4, width=5)
        return pkg.layer.block_expand(input=img, block_x=bx, block_y=by,
                                      stride_x=sx, stride_y=sy, padding_x=px,
                                      padding_y=py, name="out")

    _check(build, _rows(11, img=40))


def test_block_expand_feeds_a_recurrent_layer_like_jax():
    """block_expand(1, 1) after a conv, the OCR bridge: a full-length
    sequence into lstmemory (its plain version here, the JAX package's
    Pallas kernel in interpret mode)."""
    def build(pkg):
        img = _dense(pkg, "img", 2 * 4 * 6, height=4, width=6)
        conv = pkg.layer.img_conv(input=img, filter_size=3, num_filters=8,
                                  padding=1, act=pkg.activation.Relu())
        pool = pkg.layer.img_pool(input=conv, pool_size=1, pool_size_y=4,
                                  stride=1, stride_y=4)
        seq = pkg.layer.block_expand(input=pool, block_x=1, block_y=1)
        proj = pkg.layer.fc(input=seq, size=16)
        return pkg.layer.lstmemory(input=proj, name="out")

    _check(build, _rows(12, img=48))


# -- mdlstmemory -------------------------------------------------------------

@pytest.mark.parametrize("directions", [(True, True), (False, True),
                                        (True, False), (False, False)])
def test_mdlstmemory_matches_jax(directions):
    def build(pkg):
        img = _dense(pkg, "img", 2 * 3 * 4, height=3, width=4)
        return pkg.layer.mdlstmemory(input=img, size=3,
                                     directions=directions, name="out")

    _check(build, _rows(13, img=24))


def test_mdlstmemory_without_bias_and_after_a_conv_matches_jax():
    def build(pkg):
        img = _dense(pkg, "img", 2 * 5 * 4, height=5, width=4)
        conv = pkg.layer.img_conv(input=img, filter_size=3, num_filters=8,
                                  padding=1)
        return pkg.layer.mdlstmemory(input=conv, size=2, bias_attr=False,
                                     name="out")

    _check(build, _rows(14, img=40))


def test_mdlstm_op_matches_a_cell_by_cell_loop():
    """The anti-diagonal sweep against the JAX package's order (rows,
    then columns), written out cell by cell in float64."""
    from paddle_tpu_torch.ops.rnn import mdlstm_2d

    rng = np.random.RandomState(15)
    b, h, w, c, s = 2, 4, 3, 3, 2
    x = rng.randn(b, h, w, c)
    wx, wu, wl = (rng.randn(c, 5 * s), rng.randn(s, 5 * s),
                  rng.randn(s, 5 * s))
    bias = rng.randn(5 * s)
    got = mdlstm_2d(*(torch.from_numpy(a) for a in (x, wx, wu, wl, bias)),
                    s).numpy()

    def sig(a):
        return 1.0 / (1.0 + np.exp(-a))

    hbuf, cbuf = np.zeros((b, h, w, s)), np.zeros((b, h, w, s))
    zero = np.zeros((b, s))
    for i in range(h):
        for j in range(w):
            h_up, c_up = (hbuf[:, i - 1, j], cbuf[:, i - 1, j]) if i else (
                zero, zero)
            h_l, c_l = (hbuf[:, i, j - 1], cbuf[:, i, j - 1]) if j else (
                zero, zero)
            g = x[:, i, j] @ wx + bias + h_up @ wu + h_l @ wl
            gi, fu, fl, o, cand = np.split(g, 5, axis=-1)
            cbuf[:, i, j] = (sig(fu) * c_up + sig(fl) * c_l
                             + sig(gi) * np.tanh(cand))
            hbuf[:, i, j] = sig(o) * np.tanh(cbuf[:, i, j])
    np.testing.assert_allclose(got, hbuf, rtol=1e-12, atol=1e-12)


# -- the registry ------------------------------------------------------------

@pytest.mark.parametrize("ref_name", [
    "exconv", "exconvt", "cudnn_convt", "seqlastins", "maxid", "cos",
    "huber", "blockexpand", "gated_recurrent", "warp_ctc", "mdlstmemory",
    "mdlstm", "average", "max"])
def test_reference_layer_names_resolve_as_in_jax(ref_name):
    from paddle_tpu.layer.base import layer_registry as jax_registry

    assert ref_name in jax_registry._entries
    assert ref_name in layer_registry


def test_exconvt_builds_a_transposed_conv():
    img = _dense(paddle, "img", 2 * 4 * 4, height=4, width=4)
    node = layer_registry.get("exconvt")(input=img, filter_size=3,
                                         num_filters=3, stride=2, padding=1)
    assert node.out_img_shape == (3, 7, 7)


def test_misc_layer_names_match_jax():
    """Auto names of the misc layers, one per package."""
    def build(pkg):
        x = _dense(pkg, "x", 4)
        return [pkg.layer.tensor(x, x, size=2), pkg.layer.prelu(input=x),
                pkg.layer.gated_unit(input=x, size=2),
                pkg.layer.selective_fc(input=x, select=None, size=2),
                pkg.layer.data_norm(input=x), pkg.layer.featmap_expand(
                    input=x, num_filters=2),
                pkg.layer.row_conv(input=_seq(pkg, "s", 4), context_len=2)]

    jouts, outs = both(build)
    assert [o.name for o in outs] == [o.name for o in jouts]
    assert [sorted(s.name for s in o.param_specs) for o in outs] == [
        sorted(s.name for s in o.param_specs) for o in jouts]
